"""The process group of data-parallel training (port of
isaacgymenvs_tpu/parallel/distributed.py).

The JAX package runs one SPMD program over a global device mesh. The port
runs one process per card, as the reference's `torchrun ... multi_gpu=True`
does: every rank steps its own block of the env axis, the policy's
parameters are replicated, and gradients, moments and metrics are reduced
across the ranks (`parallel/sharding.py`).

The group is read from the environment, as in the JAX package:
torchrun's MASTER_ADDR/MASTER_PORT, RANK and WORLD_SIZE (LOCAL_RANK picks
the card), or the JAX names JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
JAX_PROCESS_ID. The backend is named, never switched behind the caller's
back: NCCL by default on the card, where each rank holds a card of its
own, gloo on the CPU. Ranks that share a card need a backend that allows it
(`backend="gloo"`): NCCL refuses two ranks on one device, and
`maybe_initialize` raises before it would.

Host effects (checkpoints, the logger, the config snapshot, prints) are
rank 0's (`is_main_process`), as in the JAX package and the reference.

`start_ranks` and `wait_ranks` run a command as the ranks of a group on
this host, with torchrun's variables, for the multi-rank tests and checks.
"""
from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _env(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return v
    return None


def distributed_spec() -> Optional[dict]:
    """The process-group spec of the environment; None if absent."""
    addr = _env("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    if addr is None:
        host = _env("MASTER_ADDR")
        port = _env("MASTER_PORT")
        if host is not None:
            addr = f"{host}:{port or 12355}"
    nproc = _env("JAX_NUM_PROCESSES", "WORLD_SIZE")
    pid = _env("JAX_PROCESS_ID", "RANK")
    if addr is None or nproc is None or pid is None:
        return None
    return {
        "coordinator_address": addr,
        "num_processes": int(nproc),
        "process_id": int(pid),
        "local_rank": int(_env("LOCAL_RANK") or pid),
        "local_world_size": int(_env("LOCAL_WORLD_SIZE") or nproc),
    }


def maybe_initialize(require: bool = False, backend: str | None = None, device="cuda") -> bool:
    """Join the process group of the environment, if there is one.

    Returns True when the run has more than one rank. `require=True` (the
    `multi_gpu=True` flag) raises where the variables are missing. At a
    world size of 1 no group is formed and False is returned. `backend`
    defaults to NCCL for a CUDA `device` and gloo for the CPU; NCCL with
    more ranks on a host than cards raises by name. On the card each rank
    takes `cuda:<LOCAL_RANK % device_count>` as its current device.
    """
    if is_initialized():
        return True
    spec = distributed_spec()
    if spec is None:
        if require:
            raise RuntimeError(
                "multi_gpu=True but no process-group env vars found: set "
                "MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE (torchrun style) "
                "or JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID"
            )
        return False
    if spec["num_processes"] <= 1:
        return False
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("a CUDA device was requested but torch.cuda.device_count() is 0")
        if backend == "nccl" and spec["local_world_size"] > count:
            raise RuntimeError(
                f"NCCL cannot put two ranks on one device: {spec['local_world_size']} ranks on this host, "
                f"{count} card(s); ranks that share a card need dist_backend=gloo")
        torch.cuda.set_device(spec["local_rank"] % count)
    elif backend == "nccl":
        raise RuntimeError("the NCCL backend needs device=cuda; the CPU runs with gloo")
    dist.init_process_group(backend, init_method=f"tcp://{spec['coordinator_address']}",
                            world_size=spec["num_processes"], rank=spec["process_id"])
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """True on the rank that owns host effects (logs, checkpoints)."""
    return rank() == 0


def backend() -> str | None:
    return dist.get_backend() if is_initialized() else None


def rank_device(device) -> torch.device:
    """The rank's device: under a process group a CUDA device is the rank's
    card, `cuda:<LOCAL_RANK % device_count>` (the current device
    `maybe_initialize` set), as the reference maps `sim_device` by rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def rank_seed(seed: int) -> int:
    """`seed` folded with the rank, for the streams each rank draws on its
    own (action noise, resets, demo windows); rank 0 keeps `seed`."""
    return (int(seed) ^ (rank() * 0x9E3779B97F4A7C15)) & 0x7FFF_FFFF_FFFF_FFFF


def shutdown() -> None:
    """Leave the process group, where one was formed."""
    if is_initialized():
        dist.destroy_process_group()


# ---- ranks on this host ---------------------------------------------------------

_GROUP_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
               "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def free_port() -> int:
    """A TCP port of localhost that is free now (for MASTER_PORT)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(argv: Sequence[str], logs: Sequence[str], env: Optional[dict] = None, cwd=None) -> list:
    """`argv` as len(logs) processes, the ranks of one group on localhost
    (torchrun's variables on a free port, the caller's group variables
    dropped, `env` added), rank r's output to the file logs[r]. Returns the
    processes; `wait_ranks` waits for them."""
    port, world = free_port(), len(logs)
    base = {k: v for k, v in os.environ.items() if k not in _GROUP_VARS}
    procs = []
    for r, log in enumerate(logs):
        rank_env = {**base, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": str(r),
                    "WORLD_SIZE": str(world), "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world), **(env or {})}
        with open(log, "w") as out:
            procs.append(subprocess.Popen(list(argv), env=rank_env, stdout=out, stderr=subprocess.STDOUT, cwd=cwd))
    return procs


def wait_ranks(procs: Sequence[subprocess.Popen], timeout: float) -> list:
    """Wait up to `timeout` seconds in all for the processes of
    `start_ranks`; a rank that fails ends the wait (the others would hang
    in a collective), and every rank still running then is killed. Returns
    the exit codes, in rank order."""
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]
