"""Carry weights, train states and models across from the JAX package as
plain arrays.

The functions take numpy arrays only, so this package imports nothing of
the JAX one; the caller turns JAX arrays into numpy first.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .model.spec import Model


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def actor_critic_from_flax(params: Mapping) -> dict:
    """A flax network's params tree -> the state_dict of the port's module
    of the same layout: `ActorCritic`, `CriticNet`, `LSTMActorCritic`,
    SAC's `SquashedGaussianActor` and `TwinQ`, AMP's `Discriminator` and
    HRL's `AMPLatentActor`.

    Accepts the nested tree (with or without the top-level "policy" and
    "params" keys) or its flattened form with "/"-joined keys. A flax Dense
    kernel is (in, out), a torch Linear weight (out, in), so kernels are
    transposed; that also carries the wider d2rl inputs and the separate
    critic trunk (`critic_mlp.*`) across. A LayerNorm's scale becomes its
    weight. The eight kernels of an `OptimizedLSTMCell` (`lstm/ii`, `if`,
    `ig`, `io` without bias, `lstm/hi`, `hf`, `hg`, `ho` with bias) become
    the port cell's `lstm.ih` and `lstm.hh`, the gates side by side in the
    order i, f, g, o. With `learn_sigma=False` the flax tree has no
    log_sigma, and neither has the port's state_dict.
    """
    flat = _flatten(params)
    sd, lstm = {}, {}
    for key, arr in flat.items():
        parts = key.split("/")
        while parts[0] in ("policy", "params"):
            parts = parts[1:]
        if parts == ["log_sigma"]:
            sd["log_sigma"] = torch.tensor(arr, dtype=torch.float32)
            continue
        *mods, leaf = parts
        if mods[:1] == ["lstm"]:
            lstm[(mods[1], leaf)] = arr
            continue
        name = ".".join(mods)
        if leaf == "kernel":
            sd[f"{name}.weight"] = torch.tensor(arr.T, dtype=torch.float32)
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.tensor(arr, dtype=torch.float32)
        elif leaf == "scale":
            sd[f"{name}.weight"] = torch.tensor(arr, dtype=torch.float32)
        else:
            raise KeyError(f"unexpected flax parameter {key}")
    if lstm:
        cat = lambda side, leaf: np.concatenate([lstm[(side + g, leaf)] for g in "ifgo"], axis=-1)
        sd["lstm.ih.weight"] = torch.tensor(cat("i", "kernel").T, dtype=torch.float32)
        sd["lstm.hh.weight"] = torch.tensor(cat("h", "kernel").T, dtype=torch.float32)
        sd["lstm.hh.bias"] = torch.tensor(cat("h", "bias"), dtype=torch.float32)
    return sd


def _rms(d) -> dict:
    return {k: torch.tensor(np.asarray(d[k], np.float32)) for k in ("mean", "var", "count")}


def _policy_and_central(tree: Mapping) -> dict:
    """A PPO params tree ({"policy": ..., "central": ..., "disc": ...} or
    the policy's alone) as one state_dict, the central value net's under
    `central.`, AMP's discriminator under `disc.` (its `amp_rms` is data,
    not weights, and is left out)."""
    sd = actor_critic_from_flax(tree["policy"] if "policy" in tree else tree)
    for sub in ("central", "disc"):
        if sub in tree:
            sd.update({f"{sub}.{k}": v for k, v in actor_critic_from_flax(tree[sub]).items()})
    return sd


def train_state_from_jax(fields: Mapping, param_names) -> dict:
    """The learnable part of a JAX `PPOTrainState` in the layout of the
    port's checkpoints, for `PPO.load_state` (and `PPORecurrent`'s).

    `fields` holds numpy arrays: `params` (the flax tree, with a "central"
    subtree for the central value net, and AMP's "disc" and "amp_rms"),
    `obs_rms` and `value_rms` (mean,
    var, count), `state_rms` with the central value, `lr`, and optax's Adam
    state `mu`, `nu` (trees shaped like `params`) and `count`.
    `param_names` is `[n for n, _ in agent.named_trainables()]`, the
    optimizer's order. Adam's moments become `exp_avg` / `exp_avg_sq`,
    transposed as the weights are, and `count` becomes every parameter's
    `step`.
    """
    params = _policy_and_central(fields["params"])
    mu, nu = _policy_and_central(fields["mu"]), _policy_and_central(fields["nu"])
    step = torch.tensor(float(np.asarray(fields["count"])))
    out = {
        "params": {k: v for k, v in params.items() if not k.startswith(("central.", "disc."))},
        "obs_rms": _rms(fields["obs_rms"]),
        "value_rms": _rms(fields["value_rms"]),
        "lr": float(np.asarray(fields["lr"])),
        "opt_state": {"state": {
            i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
            for i, n in enumerate(param_names)
        }},
    }
    if any(k.startswith("central.") for k in params):
        out["central"] = {k[len("central."):]: v for k, v in params.items() if k.startswith("central.")}
        out["state_rms"] = _rms(fields["state_rms"])
    if any(k.startswith("disc.") for k in params):
        out["disc"] = {k[len("disc."):]: v for k, v in params.items() if k.startswith("disc.")}
        out["amp_rms"] = _rms(fields["params"]["amp_rms"])
    return out


def motion_lib_from_arrays(fields: Mapping, device):
    """A port `MotionLib` holding a JAX one's arrays (numpy, by attribute
    name: root_pos, root_rot, dof_pos, dof_vel, key_pos, root_vel,
    root_ang_vel, _fps, _lengths, _weights, _starts), without reading a
    clip, on `device`."""
    from .amp.motion_lib import MotionLib

    lib = MotionLib.__new__(MotionLib)
    dev = lib.device = torch.device(device)
    f32 = lambda k: torch.tensor(np.asarray(fields[k], np.float32), device=dev)
    for k in ("root_pos", "root_rot", "dof_pos", "dof_vel", "key_pos", "root_vel", "root_ang_vel", "_weights"):
        setattr(lib, k, f32(k))
    lib._fps = np.asarray(fields["_fps"], np.float64)
    lib._lengths = np.asarray(fields["_lengths"], np.int64)
    lib._durations = (lib._lengths - 1) / lib._fps
    lib.num_motions = len(lib._lengths)
    lib.num_dofs = lib.dof_pos.shape[-1]
    lib._starts = torch.tensor(np.asarray(fields["_starts"], np.int64), device=dev)
    lib._fps_t = torch.tensor(lib._fps, dtype=torch.float32, device=dev)
    lib._dur_t = torch.tensor(lib._durations, dtype=torch.float32, device=dev)
    lib._len_t = torch.tensor(lib._lengths, device=dev)
    return lib


def sac_state_from_jax(fields: Mapping) -> dict:
    """A JAX `SACTrainState`'s learnable part in the layout of the port's
    SAC checkpoints, for `SAC.load_state`: `fields` holds the flax trees
    `actor_params`, `critic_params`, `target_params`, and `log_alpha` and
    `obs_rms` (mean, var, count) as numpy arrays."""
    return {
        "actor_params": actor_critic_from_flax(fields["actor_params"]),
        "critic_params": actor_critic_from_flax(fields["critic_params"]),
        "target_params": actor_critic_from_flax(fields["target_params"]),
        "log_alpha": torch.tensor(np.asarray(fields["log_alpha"], np.float32)),
        "obs_rms": _rms(fields["obs_rms"]),
    }


def model_from_arrays(fields: Mapping) -> Model:
    """A port Model from a JAX Model's fields (numpy arrays, tuples, scalars).

    Float parameters become float32 numpy arrays; static fields (ints,
    tuples, names) keep their values. Unknown field names raise.
    """
    names = {f.name: f for f in dataclasses.fields(Model)}
    kw = {}
    for k, v in fields.items():
        if k not in names:
            raise KeyError(f"Model has no field {k}")
        if v is None or isinstance(v, (bool, int, str)):
            kw[k] = v
        elif isinstance(v, tuple):
            # array entries (the SDF grids and origins) as float32 numpy
            kw[k] = tuple(np.asarray(x, np.float32) if hasattr(x, "shape") else x for x in v)
        else:
            arr = np.asarray(v)
            kw[k] = arr.astype(np.float32) if arr.dtype.kind == "f" else arr
    return Model(**kw)


def dr_sample_from_jax(sample: Mapping, device="cpu") -> dict:
    """A JAX-package DR sample {name: array (num_envs, ...)} as the port's:
    the same names, float32 tensors on `device`. A test draws a sample with
    the JAX randomizer and puts it on the port's env state (then re-packs
    the per-env leaves with `VecTask.pack_dyn`)."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in sample.items()}


def env_state_from_arrays(state, fields: Mapping, device="cuda"):
    """The port's env `state` (an `envcore.vec_task.EnvState`) holding a
    JAX env state's arrays (numpy, by field name): `q`, `qd`, `progress`,
    `reset_buf`, `actions`, and `task`, a dict of per-env arrays (FrankaCubeStack's
    cube poses live in `q`, its `stack` flag in `task`; FrankaCabinet's
    `targets`; NutBoltPick's `t`; IndustReal's `max_disp`, `obs_noise` (N, 3),
    `prev_rew`, `success` and `engaged`; Trifinger's goal and last fingertips;
    ShadowHand's and AllegroHand's goal, counters, targets, force and the
    nested dict `rew_terms`) or a tuple of them (the empty task state of
    NutBoltPlace and NutBoltScrew). Nested dicts come across as dicts. A
    task entry `key` (the JAX ShadowHand's PRNG key, which the port's task
    state does not hold: it draws from the state's generator) is left out.
    Bool and integer task arrays keep their kind. A test draws the initial
    states with the JAX env and steps both packages from them."""
    from .engine.dynamics import SimState

    dev = torch.device(device)
    t = lambda a, dtype=None: torch.tensor(np.asarray(a), dtype=dtype, device=dev)
    state.sim = SimState(q=t(fields["q"], torch.float32), qd=t(fields["qd"], torch.float32))
    state.progress = t(fields["progress"], torch.int32)
    state.reset_buf = t(fields["reset_buf"], torch.bool)
    state.actions = t(fields["actions"], torch.float32)
    state.task = task_from_arrays(fields["task"], device)
    return state


def task_from_arrays(task, device="cuda"):
    """A JAX task state's arrays (numpy: a dict, possibly nested, or a
    tuple) as the port's task state (see `env_state_from_arrays`)."""
    dev = torch.device(device)
    kind = lambda a: torch.bool if a.dtype == np.bool_ else torch.int64 if a.dtype.kind in "iu" else torch.float32

    def tree(v):
        if isinstance(v, Mapping):
            return {k: tree(x) for k, x in v.items() if k != "key"}
        a = np.asarray(v)
        return torch.tensor(a, dtype=kind(a), device=dev)

    return tuple(tree(v) for v in task) if isinstance(task, tuple) else tree(task)
