"""The PBT training loop: PPO, restarted in-process when the population
says so (port of isaacgymenvs_tpu/utils/pbt_loop.py).

After each epoch the policy saves its weights to
<workspace>/policy_<idx:02d>/weights.pth and asks its `PbtManager` whether
to evolve. On a restart the trainer is rebuilt with the mutated config,
and its state is restored from the weights the manager names (a donor's),
or from its own when the manager keeps them. The file a restart restores
from is copied first to restart_<iteration:06d>.pth in the policy's
directory, and the state it restored to is written beside it as
restart_<iteration:06d>_restored.pth, so that a restart can be checked
after the fact: the donor may overwrite its weights file at any time.
`max_iterations` counts the epochs of every session together.
"""
from __future__ import annotations

import os
import random
import shutil
from typing import Any, Dict

import yaml


def _has(cfg: Dict[str, Any], dotted: str) -> bool:
    node = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    return True


def _get_path(cfg: Dict[str, Any], dotted: str):
    node = cfg
    for k in dotted.split("."):
        node = node[k]
    return node


def _set_path(cfg: Dict[str, Any], dotted: str, value):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node[k]
    node[keys[-1]] = value


def _copy_atomic(src: str, dst: str) -> None:
    tmp = dst + ".tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def run_pbt_training(cfg, env, train_params, seed, run_name, logger, pbt_cfg, train_dir: str = "runs"):
    """Train `env` with PPO as member `pbt.policy_idx` of a population
    whose workspace is <train_dir>/<run_name>_<pbt.workspace>. Returns the
    last session's final train state and metrics."""
    from ..learn import PPO
    from ..parallel import distributed

    if distributed.process_count() > 1:  # a member is one process, as in the JAX package
        raise NotImplementedError("PBT trains each member in one process: multi_gpu with more than one rank "
                                  "is not ported")
    from ..pbt import PbtManager
    from .config import cfg_dir

    mutation_name = str(pbt_cfg.get("mutation_file", "default_mutation"))
    mpath = os.path.join(cfg_dir(), "pbt", "mutation", f"{mutation_name}.yaml")
    mutations = yaml.safe_load(open(mpath)) if os.path.exists(mpath) else {}

    policy_idx = int(pbt_cfg.get("policy_idx", 0))
    workspace = os.path.join(train_dir, f"{run_name}_{pbt_cfg.get('workspace', 'pbt_workspace')}")
    change = pbt_cfg.get("change_range", [1.1, 1.5])
    manager = PbtManager(
        workspace=workspace,
        policy_idx=policy_idx,
        num_policies=int(pbt_cfg.get("num_policies", 8)),
        params_to_mutate=mutations,
        mutation_rate=float(pbt_cfg.get("mutation_rate", 0.15)),
        change_min=float(change[0]),
        change_max=float(change[1]),
        interval_steps=int(pbt_cfg.get("interval_steps", 10_000_000)),
        start_after=int(pbt_cfg.get("start_after", 10_000_000)),
        initial_delay=int(pbt_cfg.get("initial_delay", 20_000_000)),
        replace_fraction_worst=float(pbt_cfg.get("replace_fraction_worst", 0.125)),
        replace_fraction_best=float(pbt_cfg.get("replace_fraction_best", 0.3)),
        threshold_frac_std=float(pbt_cfg.get("replace_threshold_frac_std", 0.5)),
        threshold_frac_abs=float(pbt_cfg.get("replace_threshold_frac_absolute", 0.05)),
        dbg_mode=bool(pbt_cfg.get("dbg_mode", False)),
        # one stream per member: members of one seed draw differently
        rng=random.Random(seed * 1000 + policy_idx),
    )

    # the mutable view of the config paths the mutation scheme names
    full_cfg = {"train": {"params": train_params}, "task": env.cfg}

    name = f"{run_name}_p{policy_idx:02d}"
    policy_dir = manager._dir(policy_idx)
    ckpt_path = os.path.join(policy_dir, "weights.pth")
    frames_offset = 0
    epochs_done = 0
    restart = None  # (new params, weights to load or None) once the manager asks for a restart
    max_iters = cfg.get("max_iterations")
    ts, metrics = None, {}

    while True:
        remaining = int(max_iters) - epochs_done if max_iters else None
        if remaining is not None and remaining <= 0:
            break
        agent = PPO(env, train_params, seed=seed)
        steps_per_epoch = agent.cfg.horizon_length * env.num_envs
        if restart is not None:
            # a restart goes on from the donor's weights, or from this policy's own
            src = restart[1] or ckpt_path
            base = os.path.join(policy_dir, f"restart_{manager.last_iteration:06d}")
            _copy_atomic(src, base + ".pth")
            restored, epoch = agent.restore(base + ".pth", agent.init())
            agent.save(base + "_restored.pth", restored, epoch, frames_offset)
            print(f"[pbt] policy {policy_idx}: restarted at {frames_offset} frames from {src}")
            agent.init = lambda _ts=restored: _ts
        restart = None

        def on_epoch(ts, metrics, _agent=agent, _spe=steps_per_epoch):
            nonlocal restart
            frames = frames_offset + int(metrics["epoch"]) * _spe
            obj = metrics.get("mean_episode_return", float("nan"))
            if obj != obj:
                return False
            mutable = {k: _get_path(full_cfg, k) for k in mutations if _has(full_cfg, k)}
            _agent.save(ckpt_path, ts, int(metrics["epoch"]), frames)
            if logger is not None:
                logger.log({"pbt/00_best_objective": obj}, frames)
            result = manager.maybe_evolve(frames, obj, mutable, ckpt_path)
            if result is None:
                return False
            for k, v in result[0].items():
                if _has(full_cfg, k):
                    _set_path(full_cfg, k, v)
            restart = result
            return True  # stop: the loop rebuilds the trainer

        ts, metrics = agent.train(max_epochs=remaining, train_dir=train_dir, name=name, on_epoch=on_epoch)
        done_now = int(metrics.get("epoch", 0))
        epochs_done += done_now
        frames_offset += done_now * steps_per_epoch
        if restart is None:
            break  # the session ended without a restart
    return ts, metrics
