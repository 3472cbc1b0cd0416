"""env.step env-steps/s of the port: the counterpart of the root bench.py's
`measure("Ant", 4096, horizon=16)`.

Steps a task's VecTask (its own yaml at `--num-envs`) under uniform random
actions in [-1, 1] for `reps` windows of `horizon` steps after one warm-up
window, and prints one JSON line. Runs on the card unless `--device cpu` is
given:

    python -m isaacgymenvs_tpu_torch.bench [--task Ant] [--num-envs 4096] [--horizon 16] [--randomize]

`--randomize` turns on the task yaml's domain randomization
(`task.randomize=True`): per-env model leaves through the kernel, action and
observation noise, re-randomization at resets.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .device import resolve_device
from .tasks import task_map
from .utils.config import load_config


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(num_envs: int = 4096, horizon: int = 16, reps: int = 8, device="cuda",
            task: str = "Ant", randomize: bool = False) -> dict:
    """Env-steps/s of `task` at `num_envs`, timed on the host clock around
    work that ends in a device synchronize."""
    dev = resolve_device(device)
    cfg = load_config([f"task={task}", f"num_envs={num_envs}", f"task.randomize={bool(randomize)}"])["task"]
    env = task_map[task](cfg, device=dev)
    state, _ = env.reset(0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def window(state):
        for _ in range(horizon):
            actions = torch.rand(num_envs, env.num_acts, generator=gen, device=dev) * 2.0 - 1.0
            state, _, _, _, _ = env.step(state, actions)
        return state

    state = window(state)  # warm-up: builds and loads the kernel
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        state = window(state)
    _sync(dev)
    sec = time.perf_counter() - t0
    return {
        "env_steps_per_s": reps * horizon * num_envs / sec,
        "seconds": sec,
        "task": task,
        "randomize": bool(randomize),
        "num_envs": num_envs,
        "horizon": horizon,
        "reps": reps,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "finite": bool(torch.isfinite(state.sim.q).all()),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="Ant", choices=sorted(task_map))
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=16)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--randomize", action="store_true", help="the task yaml's domain randomization on")
    a = ap.parse_args(argv)
    r = measure(a.num_envs, a.horizon, a.reps, a.device, a.task, a.randomize)
    print(json.dumps({
        "metric": f"{a.task} env-steps/s ({a.num_envs} envs, {r['device']})",
        "value": r["env_steps_per_s"],
        "unit": "env-steps/s",
        **r,
    }))


if __name__ == "__main__":
    main()
