#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the fused-step kernel from engine/csrc/fused_step.cu with nvcc
   (sm_90a) and prints the build seconds;
3. holds the kernel against its plain PyTorch version on the card: Ant at
   N=RAGGED_ENVS=1003 for 3 steps (not a multiple of the kernel's envs per
   block, so the last block is part-full and its masked loads, stores and
   idle warps run) and at the main path's N=4096 for
   one step, random qfrc and xfrc, tolerances q 2e-4, qd 2e-3, forces 2e-2;
4. drives the main path: the Ant VecTask at 4096 envs, a 16-step PPO
   rollout under an ActorCritic made from a seed, with the launch count
   reset just before and read just after (one launch per env step);
   checks the outputs are finite, then settles 60 zero-action steps and
   checks the summed foot contact force against the Ant's weight;
5. measures env.step throughput, profiles a few env steps (device busy
   share, top device ops), times the kernel (CUDA events, median ms per
   launch) and its plain version at the main path's shapes, and prints one
   `kernels` JSON line;
6. ends with {"ok": true, "device": {...}}.

It needs a CUDA device and the repository around it; without either it
exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NUM_ENVS = 4096
HORIZON = 16
RAGGED_ENVS = 1003
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
# data-sheet peaks of the H100 parts: (fp32 FLOP/s outside the tensor
# cores, memory bytes/s); the SXM part unless the name says otherwise
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60e12, 3.9e12), "SXM": (67e12, 3.35e12)}


def peaks(name: str):
    return next((PEAKS[k] for k in ("PCIe", "NVL") if k in name), PEAKS["SXM"])


def ant_env(n: int):
    from isaacgymenvs_tpu_torch.tasks import task_map

    cfg = {"env": {"numEnvs": n, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    return task_map["Ant"](cfg, device="cuda")


def rows(t):
    return t.T.contiguous()


def xfrc_rows(x):
    n, nb, _ = x.shape
    return x.permute(2, 1, 0).reshape(6 * nb, n).contiguous()


def compare(env, steps: int, seed: int) -> dict:
    """Kernel vs plain version from the same inputs, each step; the plain
    output carries the trajectory. Returns the max abs error per output."""
    from isaacgymenvs_tpu_torch.engine import fused

    m, p = env.model, env.sim_params
    n = env.num_envs
    state, _ = env.reset(seed)
    rng = np.random.RandomState(seed)
    cuda = lambda a: torch.tensor(a.astype(np.float32), device="cuda")
    qfrc = cuda(rng.uniform(-3, 3, (n, m.nv)))
    xfrc = cuda(rng.uniform(-1, 1, (n, m.nbody, 6)))
    plain = fused._step_math_torch(fused._extract(m), p, torch.device("cuda"))
    q, qd = state.sim.q, state.sim.qd
    err = {k: 0.0 for k in TOL}
    for _ in range(steps):
        ko = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc)
        po = plain(rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc))
        nb = m.nbody
        ref = {
            "q": po[0].T, "qd": po[1].T,
            "body_force": po[2].reshape(3, nb, n).permute(2, 1, 0),
            "body_torque": po[3].reshape(3, nb, n).permute(2, 1, 0),
            "dof_force": po[4].T,
        }
        for k in TOL:
            got = getattr(ko, k)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"kernel output {k} is not finite")
            err[k] = max(err[k], float((got - ref[k]).abs().max()))
        q, qd = ref["q"].contiguous(), ref["qd"].contiguous()
    torch.cuda.synchronize()
    bad = {k: (e, TOL[k]) for k, e in err.items() if not e < TOL[k]}
    if bad:
        raise AssertionError(f"kernel disagrees with the plain version at N={n}: {bad}")
    return err


def event_ms(fn, reps: int) -> float:
    """Median ms of fn() over `reps` calls, each between two CUDA events."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profile_env_step(env, steps: int = 8) -> None:
    """Device busy share and the largest device-time entries of env.step
    under random actions, from torch.profiler (CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = env.reset(4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    act = lambda: torch.rand(env.num_envs, env.num_acts, generator=gen, device="cuda") * 2 - 1
    for _ in range(2):
        state, _, _, _, _ = env.step(state, act())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _, _, _, _ = env.step(state, act())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    n_kernels = sum(e.count for e in ev if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profile env.step x{steps}: wall {wall_ms / steps:.4f} ms/step (profiler on), "
          f"device busy {busy_ms / steps:.4f} ms/step ({100 * busy_ms / wall_ms:.1f} %), "
          f"{n_kernels / steps:.1f} device ops/step")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / steps:.4f} ms/step  x{e.count / steps:.1f}  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from isaacgymenvs_tpu_torch.engine import _cuda, fused
    from isaacgymenvs_tpu_torch.learn import PPO

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    env = ant_env(NUM_ENVS)
    s = fused._extract(env.model)
    sizes = (s.nbody, s.nq, s.nv, s.nc)
    t0 = time.perf_counter()
    _cuda.build(sizes, verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for sizes {sizes}")

    # 3. kernel vs plain version
    if RAGGED_ENVS % _cuda.ENVS_PER_BLOCK == 0:
        raise AssertionError(f"N={RAGGED_ENVS} fills every block of {_cuda.ENVS_PER_BLOCK} envs")
    err_ragged = compare(ant_env(RAGGED_ENVS), steps=3, seed=1)
    print(f"kernel vs plain, N={RAGGED_ENVS}, 3 steps:", json.dumps(err_ragged))
    err_main = compare(env, steps=1, seed=2)
    print(f"kernel vs plain, N={NUM_ENVS}, 1 step:", json.dumps(err_main))
    max_err = max(max(err_ragged.values()), max(err_main.values()))

    # 4. the main path: a PPO rollout on the Ant VecTask
    train = {"network": {"mlp": {"units": [256, 128, 64], "activation": "elu"}},
             "config": {"horizon_length": HORIZON, "value_bootstrap": True}}
    agent = PPO(env, train, seed=0)
    ts = agent.init()
    ts, _, _ = agent.rollout(ts)  # warm-up
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    t0 = time.perf_counter()
    ts, traj, last_value = agent.rollout(ts)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = _cuda.FusedStepCall.launches
    if launches != HORIZON * env.control_freq_inv:
        raise AssertionError(f"{launches} kernel launches for {HORIZON} env steps")
    for k in ("obs", "action", "logp", "value", "reward"):
        if not bool(torch.isfinite(getattr(traj, k)).all()):
            raise AssertionError(f"rollout {k} is not finite")
    if not bool(torch.isfinite(last_value).all()) or not bool(torch.isfinite(ts.env_state.sim.q).all()):
        raise AssertionError("rollout state is not finite")
    if tuple(traj.obs.shape) != (HORIZON, NUM_ENVS, env.num_obs):
        raise AssertionError(f"rollout obs shape {tuple(traj.obs.shape)}")
    rollout_sps = HORIZON * NUM_ENVS / sec
    print(f"rollout: {HORIZON} steps x {NUM_ENVS} envs in {sec:.4f} s = {rollout_sps:.1f} env-steps/s "
          f"(policy + env), {launches} launches, mean reward {float(traj.reward.mean()):.4f}")

    # settle under zero actions: the feet carry about the Ant's weight
    state, obs = env.reset(3)
    zero = torch.zeros(NUM_ENVS, env.num_acts, device="cuda")
    for _ in range(60):
        state, obs, _, _, _ = env.step(state, zero)
    weight = float(np.sum(env.model.body_mass)) * 9.81
    feet_fz = obs[:, 28:52].reshape(NUM_ENVS, 4, 6)[:, :, 2].sum(1) / env.contact_force_scale
    ratio = float(feet_fz.mean()) / weight
    print(f"settled feet fz / weight: {ratio:.4f} (mean over {NUM_ENVS} envs)")
    if not 0.5 < ratio < 2.0:
        raise AssertionError(f"settled foot force {ratio:.3f} x weight")

    # 5. kernel time at the main path's shapes (the rollout's last state)
    from isaacgymenvs_tpu_torch.bench import measure

    bench = measure(NUM_ENVS, HORIZON, reps=8, device="cuda")
    print(f"env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s")
    profile_env_step(env)
    p = env.sim_params
    _, step = fused._prepared(env.model, p, torch.device("cuda"))
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    q, qd = rows(ts.env_state.sim.q), rows(ts.env_state.sim.qd)
    qfrc = rows(env.qfrc_from_actuators(torch.clamp(traj.action[-1], -1, 1)))
    xfrc = torch.zeros(6 * s.nbody, NUM_ENVS, device="cuda")
    for _ in range(3):
        step(q, qd, qfrc, xfrc)
    ms = event_ms(lambda: step(q, qd, qfrc, xfrc), 50)
    plain(q, qd, qfrc, xfrc)
    plain_ms = event_ms(lambda: plain(q, qd, qfrc, xfrc), 5)
    flop_s, byte_s = peaks(name)
    flops = _cuda.kernel_flops(s, p) * NUM_ENVS
    nbytes = _cuda.kernel_bytes(s, NUM_ENVS, True)
    t_ops, t_bytes = 1e3 * flops / flop_s, 1e3 * nbytes / byte_s
    print(f"fused_step: {ms:.4f} ms/launch, plain {plain_ms:.2f} ms, bound {max(t_ops, t_bytes):.4f} ms "
          f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB), {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
          f"{100 * max(t_ops, t_bytes) / ms:.1f} % of the bound")

    print(json.dumps({"kernels": [{
        "name": "fused_step",
        "route": "cuda",
        "source": "isaacgymenvs_tpu_torch/engine/csrc/fused_step.cu",
        "replaces": "isaacgymenvs_tpu/engine/fused.py:1834",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
