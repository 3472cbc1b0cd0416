"""The DeXtreme tasks through the port's `train.main` on the CPU (the four
task names, one epoch at 4 envs each), and the port's counterpart of
tests/test_ppo.py::test_checkpoint_roundtrips_env_task_and_adr_state on
AllegroHandDextremeADR: a checkpoint carries the task state and ADR's
state, and ADR's comes back, bit for bit, only where the env's
`adr_load_from_checkpoint` gate is set."""
import dataclasses

import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import train as ttrain
from isaacgymenvs_tpu_torch.learn import PPO
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint
from isaacgymenvs_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

ADR_FIELDS = ("lo", "hi", "queues", "counts", "worker_boundary", "nats")


@pytest.mark.parametrize("name", ["AllegroHandDextremeADR", "AllegroHandDextremeManualDR", "AllegroHandADR",
                                  "AllegroHandManualDR"])
def test_train_main_one_epoch(name, tmp_path):
    """One epoch of 16 steps at 4 envs: finite losses, the ADR entropy among
    the env metrics, and a checkpoint that holds ADR's state."""
    ts, metrics = ttrain.main([f"task={name}", "pipeline=cpu", "num_envs=4", "max_iterations=1",
                               "train.params.config.minibatch_size=32", f"+train_dir={tmp_path}"])
    assert metrics["epoch"] == 1 and metrics["frames"] == 64
    assert all(np.isfinite(metrics[k]) for k in ("a_loss", "c_loss", "kl", "env/adr_nats"))
    (ckpt,) = tmp_path.glob("*/nn/last_*.pth")
    adr = load_checkpoint(str(ckpt))["env_adr_state"]
    assert set(adr) == set(ADR_FIELDS)
    for f in ADR_FIELDS:
        assert torch.equal(adr[f], getattr(ts.env_state.adr, f)), f


def test_checkpoint_roundtrips_env_task_and_adr_state(tmp_path):
    """A resume must not reset the curricula: save() writes the task state
    and ADR's state, restore() puts the task state back always and ADR's
    (ranges, queues, counts, workers) only with the gate on, bit for bit."""
    cfg = load_config(["task=AllegroHandDextremeADR", "num_envs=4"])["task"]
    env = task_map["AllegroHandDextremeADR"](cfg, device="cpu")
    tp = {"network": {"mlp": {"units": [16]}}, "config": {"horizon_length": 4, "minibatch_size": 16,
                                                          "mini_epochs": 1}}
    ppo = PPO(env, tp, seed=0)
    ts = ppo.init()
    bump = lambda v: v + 1 if v.is_floating_point() else v
    task = {k: ({kk: bump(vv) for kk, vv in v.items()} if isinstance(v, dict) else bump(v))
            for k, v in ts.env_state.task.items()}
    a = ts.env_state.adr
    evolved = dataclasses.replace(a, lo=a.lo - 0.01, hi=a.hi + 0.02, queues=a.queues + 3.0, counts=a.counts + 1,
                                  worker_boundary=(a.worker_boundary + 3) % (2 * env.adr.P), nats=a.nats + 0.5)
    ts = dataclasses.replace(ts, env_state=dataclasses.replace(ts.env_state, task=task, adr=evolved))
    path = str(tmp_path / "ck.pth")
    ppo.save(path, ts, epoch=7, frames=123)

    fresh = PPO(env, tp, seed=1).init()
    env.adr_load_from_checkpoint = False
    off, epoch = ppo.restore(path, fresh)
    assert epoch == 7
    for k, v in task.items():
        got = off.env_state.task[k]
        for kk in (v if isinstance(v, dict) else [None]):
            assert torch.equal(got[kk] if kk else got, v[kk] if kk else v), (k, kk)
    for f in ADR_FIELDS:
        assert torch.equal(getattr(off.env_state.adr, f), getattr(fresh.env_state.adr, f)), f
    assert not torch.equal(off.env_state.adr.lo, evolved.lo)

    env.adr_load_from_checkpoint = True
    on, _ = ppo.restore(path, fresh)
    for f in ADR_FIELDS:
        assert torch.equal(getattr(on.env_state.adr, f), getattr(evolved, f)), f
    # the restored state steps on (its ranges clamped to the limits)
    state, obs, rew, done, ex = env.step(on.env_state, torch.zeros(4, 16))
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(ex["adr_nats"]).all())
    assert float(ex["adr_nats"][0]) == pytest.approx(float(env.adr._nats(state.adr.lo, state.adr.hi)))


def test_adr_gate_from_the_yaml(tmp_path):
    """`adr_load_from_checkpoint` in the yaml's adr block sets the gate."""
    cfg = load_config(["task=AllegroHandDextremeManualDR", "num_envs=2",
                       "+task.env.adr.adr_load_from_checkpoint=True"])["task"]
    env = task_map["AllegroHandDextremeManualDR"](cfg, device="cpu")
    assert env.adr_load_from_checkpoint and not env.adr.update_ranges
