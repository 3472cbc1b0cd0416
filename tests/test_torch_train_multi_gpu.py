"""`train.main multi_gpu=True` on two gloo ranks on the CPU, as
`python -m torch.distributed.run --nproc_per_node=2 -m
isaacgymenvs_tpu_torch.train ... multi_gpu=True` runs it (torchrun's
variables, `torch_ranks.run_ranks`): both ranks train and end with the same
parameters, only rank 0 writes the run directory and prints, and a resume
from rank 0's checkpoint restores it bit for bit on both ranks; HRL's epoch
on two ranks; the process-group spec of both families of variables against
the JAX package's reader (isaacgymenvs_tpu/parallel/distributed.py).

The `cuda`-marked cases run two ranks on one card (gloo, and NCCL's
refusal) and skip without a card; on the card:

    python -m pytest tests/test_torch_train_multi_gpu.py -m cuda --noconftest -p no:cacheprovider
"""
import os

import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.parallel import distributed
from isaacgymenvs_tpu_torch.utils.checkpoint import load_checkpoint
from torch_ranks import free_port, run_ranks

torch.set_num_threads(1)

TRAIN_WORKER = """
import contextlib, io
from isaacgymenvs_tpu_torch import train


def work(inp):
    run = [*inp["run"], f"+train_dir={inp['dirs'][RANK]}"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ts, metrics = train.main([*run, f"max_iterations={inp['epochs']}", "train.params.config.save_frequency=1"])
    trained = [p.detach().clone() for p in ts.optimizer.param_groups[0]["params"]]
    os.environ["MASTER_PORT"] = str(inp["resume_port"])  # a group of its own for the resume
    rts, _ = train.main([*run, f"max_iterations={inp['epochs']}", f"checkpoint={inp['ckpt']}"])
    restored = [p.detach().clone() for p in rts.optimizer.param_groups[0]["params"]]
    return {"metrics": metrics, "trained": trained, "restored": restored, "printed": out.getvalue(),
            "lr": rts.lr, "obs_rms": [rts.obs_rms.mean, rts.obs_rms.var, rts.obs_rms.count]}
"""


def _train_two_ranks(tmp_path, run, epochs=2, timeout=150, env=None):
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    ckpt = str(tmp_path / "rank0" / "Cartpole" / "nn" / "last_Cartpole.pth")
    inputs = {"run": run, "dirs": dirs, "epochs": epochs, "ckpt": ckpt, "resume_port": free_port()}
    return run_ranks(tmp_path, TRAIN_WORKER, inputs, timeout=timeout, join=False, env=env), dirs, ckpt


def _check_two_ranks(results, dirs, ckpt, epochs, num_envs, backend):
    r0, r1 = results
    for a, b in zip(r0["trained"], r1["trained"]):
        assert torch.equal(a, b)
    clocks = ("fps", "time")  # each rank's own host clock
    assert {k: v for k, v in r0["metrics"].items() if k not in clocks} == \
        {k: v for k, v in r1["metrics"].items() if k not in clocks}
    assert r0["metrics"]["epoch"] == epochs and r0["metrics"]["frames"] == epochs * 16 * num_envs
    assert all(np.isfinite(r0["metrics"][k]) for k in ("a_loss", "c_loss", "kl", "lr"))
    # rank 0 alone writes the run directory and prints
    run_dir = os.path.join(dirs[0], "Cartpole")
    assert os.path.exists(os.path.join(run_dir, "config.yaml")) and os.path.isdir(os.path.join(run_dir, "summaries"))
    names = sorted(os.listdir(os.path.join(run_dir, "nn")))
    assert names == ["last_Cartpole.pth"] + [f"last_Cartpole_ep_{e}.pth" for e in range(1, epochs + 1)]
    assert not os.path.exists(dirs[1])
    assert f"ranks=2 backend={backend}" in r0["printed"] and "epoch" in r0["printed"]
    assert r1["printed"] == ""
    # the resume restores rank 0's checkpoint bit for bit on both ranks
    ck = load_checkpoint(ckpt)
    for r in (r0, r1):
        assert len(r["restored"]) == len(ck["params"])
        for a, b in zip(r["restored"], ck["params"].values()):
            assert torch.equal(a.cpu(), b)
        assert r["lr"] == ck["lr"]
        for a, f in zip(r["obs_rms"], ("mean", "var", "count")):
            assert torch.equal(a.cpu(), ck["obs_rms"][f])
    for a, b in zip(r0["restored"], r0["trained"]):
        assert torch.equal(a, b)


def test_train_main_two_ranks_on_the_cpu(tmp_path):
    """`train.main task=Cartpole pipeline=cpu multi_gpu=True` on two gloo
    ranks at 16 envs (8 each): two epochs with a checkpoint each; the
    ranks' parameters and metrics equal, the frames global; rank 0's files
    and prints only; the resume bit-equal on both ranks."""
    run = ["task=Cartpole", "pipeline=cpu", "num_envs=16", "multi_gpu=True"]
    results, dirs, ckpt = _train_two_ranks(tmp_path, run)
    _check_two_ranks(results, dirs, ckpt, 2, 16, "gloo")


HRL_WORKER = """
from isaacgymenvs_tpu_torch.learn import HRL
from isaacgymenvs_tpu_torch.tasks import task_map


def work(inp):
    env = task_map["Cartpole"](inp["cfg"], device="cpu")
    agent = HRL(env, inp["train"], seed=0)
    ts, metrics = agent.train_epoch(agent.init())
    return {"metrics": metrics, "params": [p.detach().clone() for _, p in agent.named_trainables()],
            "llc": [p.clone() for p in agent.llc_network.parameters()], "num_envs": env.num_envs}
"""


def test_hrl_epoch_on_two_ranks(tmp_path):
    """HRL goes through PPO's path: an epoch on two ranks (Cartpole, the
    LLC made from the seed) leaves the ranks' parameters bit-equal, with
    the same frozen LLC and metrics."""
    import test_torch_hrl as hrl_t

    cfg = {"env": {"numEnvs": 16, "clipObservations": 5.0, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    r0, r1 = run_ranks(tmp_path, HRL_WORKER, {"cfg": cfg, "train": hrl_t.TP}, timeout=120)
    assert r0["num_envs"] == r1["num_envs"] == 8
    assert r0["metrics"] == r1["metrics"] and np.isfinite(r0["metrics"]["kl"])
    for a, b in zip(r0["params"] + r0["llc"], r1["params"] + r1["llc"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["torchrun", "jax"])
def test_distributed_spec_reads_both_families(family, monkeypatch):
    """The spec of torchrun's variables and of the JAX names is the JAX
    package's (address, process count, process id), with the port's card
    index (LOCAL_RANK, else the rank)."""
    from isaacgymenvs_tpu.parallel import distributed as jdist

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    if family == "torchrun":
        env = {"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "29400", "RANK": "3", "WORLD_SIZE": "4",
               "LOCAL_RANK": "1"}
    else:
        env = {"JAX_COORDINATOR_ADDRESS": "10.0.0.2:1234", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec, want = distributed.distributed_spec(), jdist.distributed_spec()
    assert {k: spec[k] for k in want} == want
    assert spec["local_rank"] == 1  # LOCAL_RANK, or else the process id
    assert spec["local_world_size"] == want["num_processes"]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_two_ranks_share_the_card_with_gloo(tmp_path):
    """Two ranks on one card under gloo (`dist_backend=gloo`): the CUDA
    tensors go through gloo's all-reduce and broadcast, its gathers through
    the host; the same checks as on the CPU, at 256 envs."""
    _needs_card()
    run = ["task=Cartpole", "num_envs=256", "multi_gpu=True", "dist_backend=gloo"]
    results, dirs, ckpt = _train_two_ranks(tmp_path, run, timeout=300, env={"CUDA_VISIBLE_DEVICES": "0"})
    _check_two_ranks(results, dirs, ckpt, 2, 256, "gloo")


NCCL_WORKER = """
from isaacgymenvs_tpu_torch.parallel import distributed


def work(inp):
    try:
        distributed.maybe_initialize(require=True, device="cuda")
    except RuntimeError as exc:
        return str(exc)
    return None
"""


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card(tmp_path):
    """NCCL (the default on the card) with two ranks on one card raises by
    name on both ranks, before either joins."""
    _needs_card()
    msgs = run_ranks(tmp_path, NCCL_WORKER, None, timeout=120, join=False, env={"CUDA_VISIBLE_DEVICES": "0"})
    assert all(m and "NCCL cannot put two ranks on one device" in m for m in msgs)
