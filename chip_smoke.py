#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every instantiation of the fused-step kernel from
   engine/csrc/fused_step.cu with nvcc (sm_90a), one nvcc each, started
   together (those of steps 14, 17 and 22 too): Ant's (25 plane contacts), Cartpole's contact-free one
   (-DFS_NC=0), Ingenuity's (24 plane contacts), Quadcopter's (44 plane
   contacts, two per lane, q_target input), BallBalance's (21 plane contacts,
   one point-vs-cylinder pair row, three bilateral anchors, q_target input)
   and the example model's (10 plane contacts, point-vs-box and
   point-vs-sphere pair rows); prints ptxas's register, spill and stack
   figures, the shared memory and envs per block (the choice that keeps
   the most envs resident per SM, `_cuda.envs_per_block`), the blocks and
   warps per SM the device grants each build (`fused_step_occupancy`) and
   the build seconds;
3. holds each against its plain PyTorch version on the card. Ant at
   N=RAGGED_ENVS=1003 for 3 steps (not a multiple of the kernel's envs per
   block, so the last block is part-full and its masked loads, stores and
   idle warps run) and at the main path's N=4096 for one step, random qfrc
   and xfrc. Cartpole at N=1003 for 3 steps, at N=4096 and at its training
   path's N=512 for one step, random qfrc, no xfrc; its three force outputs
   must be exactly zero. Tolerances q 2e-4, qd 2e-3, forces 2e-2;
4. drives the rollout path: the Ant VecTask at 4096 envs, a 16-step PPO
   rollout under an ActorCritic made from a seed, with the launch count
   reset just before and read just after (one launch per env step);
   checks the outputs are finite, then settles 60 zero-action steps and
   checks the summed foot contact force against the Ant's weight;
5. measures env.step throughput, profiles a few env steps (device busy
   share, top device ops), times the Ant kernel (CUDA events, median ms per
   launch) and its plain version at the main path's shapes;
6. drives the training path on Ant at full width: `load_config(["task=Ant"])`
   (4096 envs, AntPPO.yaml as it stands: horizon 16, batch 65,536,
   minibatch 32,768, 4 mini-epochs, MLP [256, 128, 64]), one warm-up epoch
   and three timed ones through `PPO.train_epoch`; per epoch the launch
   count must equal the env steps, every metric be finite, the lr stay in
   [min_lr, max_lr], kl >= 0; the parameters must have moved;
7. trains Cartpole to a result through `train.main` in-process (the yaml's
   512 envs, CartpolePPO.yaml, 100 epochs, into a temporary run directory):
   the mean episode return must pass RETURN_BAR, every env step must be one
   launch of the contact-free kernel, a fresh agent must restore the last
   checkpoint bit for bit (parameters, lr, running stats, Adam moments) and
   `test=True checkpoint=...` must play past the same bar;
8. times the contact-free kernel and its plain version at N=512 and N=4096;
9. holds each new instantiation against its plain version at N=1003 for 3
   steps and at its full width for one step, with xfrc and q_target where
   the task has them, gentle inputs, in states where the rows act: a third
   of the Ingenuity and Quadcopter envs rest on the ground, BallBalance's
   ball lies on the tray (pair row active: the tray's body force must be
   non-zero), the example model's spheres press on the box and on each
   other. Tolerances as in 3 (BallBalance q 5e-4);
10. settles BallBalance at full width under zero actions with the ball on
   the tray: the three anchor points must sit within ANCHOR_TOL of their
   targets and the tray must carry about the ball's weight; settles the
   example model through `physics_step_fused` and checks that the box
   carries both spheres;
11. for Ingenuity, Quadcopter and BallBalance: one warm-up and three timed
   full-width `PPO.train_epoch`s from `load_config(["task=<name>"])`, launch
   count = horizon x control_freq_inv per epoch, finite metrics, parameters
   moved; env-steps/s and the rollout/update split printed;
12. trains BallBalance through `train.main` for BALL_EPOCHS epochs past
   BALL_RETURN_BAR (mean over the run) and BALL_LAST_EPOCH_BAR, one launch
   per env step, and plays the checkpoint;
13. times every new instantiation and its plain version at full width;
14. per-env model leaves (domain randomization) and tendons. Built in step 2
   beside the others: Ant + the five leaves its yaml randomizes, Ant + every
   leaf that has rows on it + gravity, the tendon example model alone and
   with all fifteen leaves + gravity, BallBalance + the leaves a pair row
   reads (cpoint_friction, cpoint_pos, geom_size, body_mass), and Cartpole,
   Ingenuity, Quadcopter and BallBalance + the leaves of the randomization
   block DR_BLOCK. Each is held against its plain version at N=1003 for 3
   steps and at full width for 1, the leaves drawn with numpy from a seed
   (`model.examples.random_leaves`), and must differ from the same step
   without leaves; each is driven through `physics_step_fused` or a
   randomized VecTask with the launches counted; each is timed;
15. physical checks: an Ant in free fall under per-env gravity gains
   qd = g_i t on all three axes; Ant with `task.randomize=True` (per-body
   mass factors in [0.5, 1.5]) settles with its summed foot force near each
   env's OWN weight (the spread over envs of fz / own weight must be well
   under that of fz / nominal weight);
16. the DR main path at full width: device ops per Ant env step with and
   without `task.randomize=True`, `bench --randomize`, one warm-up and three
   timed `train_epoch`s of `task=Ant task.randomize=True` (16 launches each),
   then `train.main` with `task=Ant task.randomize=True` for ANT_DR_EPOCHS
   epochs, a restore that is bit-equal (the DR sample is drawn anew, as in
   the JAX package) and `play`; Cartpole, Ingenuity, Quadcopter and
   BallBalance step with `task.randomize=True` and DR_BLOCK passed in;
17. Anymal (44 plane contacts, `q_target`), AnymalTerrain (top-K cap of 20,
   terrain rows, the friction leaf, 4 decimation slices merged into one
   launch) and AnymalTerrain on its plane (top-K alone), built in step 2
   beside the others, each against its plain version for one env step's
   physics call at N=1003 and 4096, robots standing and (one env in 16)
   tumbled with more than 20 candidates active; the inputs are drawn twice
   over and kept where float32 rounding is small (`conditioned`), the
   terrain grid moved next to the world origin;
18. one merged window against four separate launches: equal on the plane
   (bar 1e-6), printed on terrain;
19. physical checks: Anymal standing at its default pose (feet fz 0.9-1.3 x
   weight, knees and base free, base height steady over 10 steps);
   AnymalTerrain on every terrain type and level (finite, base above the
   local ground after 100 steps); a 30-step episode whose levels move both
   ways;
20. 1 + 3 full-width epochs of Anymal and AnymalTerrain (batch 98,304, 24
   launches each), device ops per AnymalTerrain env step,
   `train.main task=AnymalTerrain` for 4 epochs with a bit-equal restore and
   play, the plane variant driven for 16 env steps;
21. the three kernels timed at full width;
22. FactoryTaskInsertion (64 plane rows and 64 SDF rows against the
   socket's voxel grid, the cap of 32, `q_target`, gravity compensation
   through `xfrc`; eight envs per block, from its shared memory) against its
   plain version for one env step at N=1003, 128 (its yaml) and 4096, in
   contact states with SDF rows active in most envs and the cap binding in
   some (kept where the keys at the cap differ by more than KEY_GAP); the
   ball on an SDF box (one SDF row, no cap) at N=1003 for 3 steps;
23. the ball dropped onto the SDF box rests at 0.45 +- 0.015 m with
   |qd_z| < 0.05 after 150 steps through `physics_step_fused`;
24. 1 + 3 Insertion epochs at the yaml's width (128 envs, batch 4,096, 32
   launches each), device ops per Insertion env step, `train.main
   task=FactoryTaskInsertion` for 4 epochs with a bit-equal restore and
   play;
25. both timed (Insertion at 128 and 4096 envs, the ball at 4096) with
   envs per block and shared memory per block;
26. prints one `kernels` JSON line with all instantiations (each with its
   envs per block, shared memory per block, resident blocks and warps per
   SM, ptxas's registers and spill bytes) and ends with
   {"ok": true, "device": {...}}.

It needs a CUDA device and the repository around it; without either it
exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

NUM_ENVS = 4096
HORIZON = 16
RAGGED_ENVS = 1003
CARTPOLE_ENVS = 512  # numEnvs of cfg/task/Cartpole.yaml
CARTPOLE_EPOCHS = 100
# Mean episode return Cartpole must pass after 100 epochs, in training and
# in play. An untrained policy returns 1-3 and an episode ends at 500 steps
# of reward <= 1. The first run of this script on an NVIDIA H100 80GB HBM3
# (700 W) trained to 359.88 and played to 498.62; the bar leaves a margin
# of 3.6x.
RETURN_BAR = 100.0
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
BALL_TOL = {**TOL, "q": 5e-4}
# the procedural-model tasks at the width of their yaml: (envs, horizon)
NEW_TASKS = {"Ingenuity": (4096, 16), "Quadcopter": (8192, 8), "BallBalance": (4096, 16)}
BALL_EPOCHS = 40
# Mean episode return BallBalance must pass after BALL_EPOCHS epochs of 65,536
# env steps: the mean over the run's epochs, as `train` reports it, and the
# mean of the episodes that ended in the last epoch. The first ten epochs
# average 11 (a policy that has learnt nothing yet); the first run of this
# phase on an NVIDIA H100 80GB HBM3 (700 W) gave 30.56 over the run and 65.39
# in the last epoch, so the bars leave margins of 1.5x and 2.2x.
BALL_RETURN_BAR = 20.0
BALL_LAST_EPOCH_BAR = 30.0
ANCHOR_TOL = 0.005  # metres between a settled anchor point and its target
ANT_DR_EPOCHS = 5
ANT_YAML_LEAVES = ("dof_damping", "dof_stiffness", "dof_limit_lower", "dof_limit_upper", "body_mass")
PAIR_ROW_LEAVES = ("body_mass", "cpoint_friction", "cpoint_pos", "geom_size")
# a randomization block for the tasks whose yaml has none; its leaves in the step's order
DR_BLOCK = {
    "frequency": 2,
    "observations": {"range": [0, 0.002], "operation": "additive", "distribution": "gaussian"},
    "actions": {"range": [0.0, 0.02], "operation": "additive", "distribution": "gaussian"},
    "sim_params": {"gravity": {"range": [0, 0.4], "operation": "additive", "distribution": "gaussian"}},
    "actor_params": {"robot": {
        "rigid_body_properties": {"mass": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"}},
        "rigid_shape_properties": {"friction": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "uniform"}},
        "dof_properties": {"damping": {"range": [0.5, 1.5], "operation": "scaling", "distribution": "loguniform"}},
    }},
}
DR_BLOCK_LEAVES = ("dof_damping", "body_mass", "cpoint_friction", "gravity")
DR_TASKS = {"Cartpole": CARTPOLE_ENVS, "Ingenuity": 4096, "Quadcopter": 8192, "BallBalance": 4096}
# data-sheet peaks of the H100 parts: (fp32 FLOP/s outside the tensor
# cores, memory bytes/s); the SXM part unless the name says otherwise
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60e12, 3.9e12), "SXM": (67e12, 3.35e12)}


def peaks(name: str):
    return next((PEAKS[k] for k in ("PCIe", "NVL") if k in name), PEAKS["SXM"])


def ant_env(n: int):
    from isaacgymenvs_tpu_torch.tasks import task_map

    cfg = {"env": {"numEnvs": n, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}
    return task_map["Ant"](cfg, device="cuda")


def cartpole_env(n: int):
    from isaacgymenvs_tpu_torch.tasks import task_map

    cfg = {"env": {"numEnvs": n, "clipObservations": 5.0, "clipActions": 1.0},
           "sim": {"dt": 0.0166, "substeps": 2}}
    return task_map["Cartpole"](cfg, device="cuda")


def task_env(name: str, n: int, randomize: bool = False):
    """A task of the port from its own yaml at `n` envs; with `randomize`,
    domain randomization on (Ant: the block of its yaml, else DR_BLOCK)."""
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={name}", f"num_envs={n}", f"task.randomize={randomize}"])["task"]
    if randomize and name != "Ant":
        cfg["task"]["randomization_params"] = DR_BLOCK
    return task_map[name](cfg, device="cuda")


def example_model(tendons: bool = False):
    """The example model with BOX and SPHERE pair rows (or, with `tendons`,
    the arm with a fixed tendon pressing on a box) and its parameters, as an
    object with `.model` and `.sim_params` like a task."""
    from types import SimpleNamespace

    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import pair_row_example, tendon_chain_example

    model = tendon_chain_example() if tendons else pair_row_example()
    return SimpleNamespace(model=model, use_pd_targets=False, sim_params=SimParams(
        dt=1 / 60, substeps=2, solver_apgd_iterations=16, contact_margin=0.02))


# chassis heights at which the lowest contact candidates rest up to 1 mm in
# the ground: a deeper start is pushed out in the first slice and the last
# slice, whose forces the step returns, sees no contact
GROUND_HEIGHT = {"Ingenuity": (0.059, 0.06), "Quadcopter": (0.014, 0.015)}


def contact_inputs(name: str, env, n: int, seed: int, light: bool = False):
    """Gentle inputs (q, qd, qfrc, xfrc, q_target), env-leading, in a state
    where the contact rows of `name` act. `light`: the step will run with
    per-env masses down to half the model's. Quadcopter's q_target offsets
    drive its rotor arms against a 47 g chassis, whose angular velocity
    carries the comparison's largest error: 1.4e-3 of the 2e-3 allowed
    without per-env leaves, 2.0-2.3e-3 with halved masses or per-env
    gravity, 0.9e-3 with the offsets halved as well (all measured on an
    NVIDIA H100 80GB HBM3). So a light step gets half the offsets."""
    from isaacgymenvs_tpu_torch.model.examples import pair_row_example_state, tendon_chain_example_state

    m = env.model
    rng = np.random.RandomState(seed)
    cuda = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    u = lambda lim, *shape: cuda(rng.uniform(-lim, lim, shape))
    if name == "Example":
        q, qd = (cuda(a) for a in pair_row_example_state(m, n, seed))
        return q, qd, u(0.3, n, m.nv), u(0.2, n, m.nbody, 6), None
    if name == "Tendon":
        q, qd = tendon_chain_example_state(m, n, seed)
        qd[::2, 2] = -0.6  # half the boxes come down faster than the bounce threshold
        return cuda(q), cuda(qd), u(0.3, n, m.nv), u(0.2, n, m.nbody, 6), None
    if name in ("Ant", "Cartpole"):
        state, _ = env.reset(seed)
        xfrc = u(1.0, n, m.nbody, 6) if name == "Ant" else None
        return state.sim.q, state.sim.qd, u(3.0 if name == "Ant" else 100.0, n, m.nv), xfrc, None
    if name == "BallBalance":
        q = env.qpos0.repeat(n, 1)
        q[:, env.ball_q:env.ball_q + 2] = u(0.2, n, 2)
        q[:, env.ball_q + 2] = env.tray_height + 0.01 + env.ball_radius - 0.002  # 2 mm into the tray
        return q, torch.zeros(n, m.nv, device="cuda"), u(0.5, n, m.nv), None, q + u(0.02, n, m.nq)
    state, _ = env.reset(seed)
    q = state.sim.q.clone()
    lo, hi = GROUND_HEIGHT[name]
    q[::3, 2] = cuda(rng.uniform(lo, hi, len(q[::3])))
    qt = q + u(0.05 if light else 0.1, n, m.nq) if env.use_pd_targets else None
    qd = u(0.1, n, m.nv)
    qd[::3] = 0.0  # the grounded envs start at rest
    # gentle: a Quadcopter rotor arm weighs under a gram, so a wrench of 1 N
    # would spin it to velocities whose float32 rounding alone passes 2e-3
    return q, qd, u(0.02, n, m.nv), u(0.02, n, m.nbody, 6), qt


def settle_ball_balance(n: int) -> None:
    """Zero actions with the ball on the tray: the anchors hold the feet at
    their targets and the tray carries the ball's weight."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine import dynamics

    env = task_env("BallBalance", n)
    state, _ = env.reset(5)
    q, qd, _, _, _ = contact_inputs("BallBalance", env, n, seed=12)
    q[:, env.ball_q:env.ball_q + 2] *= 0.5  # within 0.1 m of the centre
    state.sim = dynamics.SimState(q=q, qd=qd)
    zero = torch.zeros(n, env.num_acts, device="cuda")
    for _ in range(150):
        state, obs, _, _, _ = env.step(state, zero)
    m = env.model
    kin = dynamics.forward_kinematics(m, state.sim.q, state.sim.qd)
    feet = list(m.att_body)
    offset = torch.tensor(np.asarray(m.att_offset, np.float32), device="cuda")
    target = torch.tensor(np.asarray(m.att_target, np.float32), device="cuda")
    points = kin.x[:, feet] + maths.quat_rotate(kin.quat[:, feet], offset)
    dist = float(torch.linalg.vector_norm(points - target, dim=-1).max())
    weight = float(m.body_mass[env.ball_body]) * 9.81
    on_tray = state.sim.q[:, env.ball_q + 2] > env.tray_height  # not dropped and reset
    ratio = float((-obs[:, 14] * 20.0)[on_tray].mean()) / weight
    print(f"settled BallBalance: anchor points within {dist:.5f} m of their targets (max over {n} envs), "
          f"tray fz / ball weight {ratio:.4f}, ball on the tray in {100 * float(on_tray.float().mean()):.1f} % of envs")
    if not dist < ANCHOR_TOL or not 0.8 < ratio < 1.25 or not float(on_tray.float().mean()) > 0.9:
        raise AssertionError(f"BallBalance did not settle: anchors {dist:.4f} m, tray force {ratio:.3f} x weight")


def settle_example(n: int) -> int:
    """The example model through `physics_step_fused` for 60 steps with no
    applied force: each sphere's contact force is about its weight. Returns
    the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    ex = example_model()
    m = ex.model
    q, _, _, _, _ = contact_inputs("Example", ex, n, seed=13)
    qd = torch.zeros(n, m.nv, device="cuda")
    zero = torch.zeros(n, m.nv, device="cuda")
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(60):
        out = fused.physics_step_fused(m, ex.sim_params, q, qd, zero)
        q, qd = out.q, out.qd
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    ratios = [float(out.body_force[:, b, 2].mean()) / (float(m.body_mass[b]) * 9.81) for b in (1, 2)]
    print(f"settled example model: sphere contact fz / weight {ratios[0]:.4f}, {ratios[1]:.4f} "
          f"(mean over {n} envs), {launches} launches")
    if launches != 60 or not all(0.8 < r < 1.25 for r in ratios) or not bool(torch.isfinite(q).all()):
        raise AssertionError(f"the example model did not settle: {ratios}, {launches} launches")
    return launches


def train_ball_balance() -> int:
    """BallBalance through `train.main` at the yaml's 4096 envs for
    BALL_EPOCHS epochs, then play from the checkpoint. Returns the kernel
    launches of the training run."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    envs, horizon = NEW_TASKS["BallBalance"]
    with tempfile.TemporaryDirectory() as runs:
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(["task=BallBalance", f"max_iterations={BALL_EPOCHS}", f"+train_dir={runs}"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = BALL_EPOCHS * horizon
        if launches != steps or metrics["frames"] != steps * envs:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps")
        ret = metrics["mean_episode_return"]
        last = metrics["ep_return_sum"] / max(metrics["n_episodes"], 1)
        print(f"BallBalance train: {BALL_EPOCHS} epochs x {envs} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches, mean episode "
              f"return {ret:.2f} over the run (bar {BALL_RETURN_BAR}), {last:.2f} in the last epoch "
              f"(bar {BALL_LAST_EPOCH_BAR})")
        if not ret > BALL_RETURN_BAR or not last > BALL_LAST_EPOCH_BAR:
            raise AssertionError(f"BallBalance trained to {ret:.2f} / {last:.2f}, not past "
                                 f"{BALL_RETURN_BAR} / {BALL_LAST_EPOCH_BAR}")
        ckpt = os.path.join(runs, "BallBalance", "nn", "last_BallBalance.pth")
        played = train.main(["task=BallBalance", "test=True", f"checkpoint={ckpt}"])
        print(f"BallBalance play: mean return of the first episodes to end {played:.2f}")
        if not np.isfinite(played):
            raise AssertionError("BallBalance play returned a non-finite mean return")
    return launches


# ---- per-env leaves (domain randomization) and tendons -----------------------

# instantiations beyond Ant's and Cartpole's: key -> (what `contact_inputs`
# calls the model, the per-env leaves ("all": every leaf with rows on the
# model, and gravity), the full width). First those without per-env leaves.
NEW_CASES = {**{t: (t, (), w[0]) for t, w in NEW_TASKS.items()}, "Example": ("Example", (), NUM_ENVS)}
DYN_CASES = {
    "Ant+yaml": ("Ant", ANT_YAML_LEAVES, NUM_ENVS),
    "Ant+all": ("Ant", "all", NUM_ENVS),
    "Tendon": ("Tendon", (), NUM_ENVS),
    "Tendon+all": ("Tendon", "all", NUM_ENVS),
    "BallBalance+pair": ("BallBalance", PAIR_ROW_LEAVES, 4096),
    **{f"{t}+dr": (t, DR_BLOCK_LEAVES, w) for t, w in DR_TASKS.items()},
}
CASES = {**NEW_CASES, **DYN_CASES}


def case(key: str, n: int):
    """(model holder, leaf names in the step's order) of a CASES entry at `n` envs."""
    from isaacgymenvs_tpu_torch.engine import fused

    base, names, _ = CASES[key]
    holder = example_model(tendons=base == "Tendon") if base in ("Tendon", "Example") else task_env(base, n)
    s = fused._extract(holder.model)
    return holder, fused.dyn_names(s, fused.DYN_ORDER if names == "all" else names)


def packed_leaves(holder, names, n: int, seed: int, only=None):
    """Per-env leaves `names` drawn with numpy from `seed`, on the card and
    packed as the step takes them (None without names). With `only`, every
    other leaf holds the model's own values in every env."""
    from isaacgymenvs_tpu_torch.engine import fused
    from isaacgymenvs_tpu_torch.model.examples import random_leaves

    if not names:
        return None
    m = holder.model
    leaves = random_leaves(m, names, n, seed, holder.sim_params.gravity)
    for k in names if only is not None else ():
        if k not in only:
            own = getattr(m, k)
            leaves[k] = np.broadcast_to(0.0 if own is None else np.asarray(own, np.float32), leaves[k].shape).copy()
    return fused.pack_dyn(fused._extract(m), {k: torch.tensor(v, device="cuda") for k, v in leaves.items()})


def compare_case(key: str) -> float:
    """A CASES instantiation against its plain version at the ragged N for 3
    steps and at full width for 1, and, with per-env leaves, against its own
    step without them; returns the largest error."""
    base, _, full = CASES[key]
    worst = 0.0
    for n, steps in ((RAGGED_ENVS, 3), (full, 1)):
        holder, names = case(key, n)
        q, qd, qfrc, xfrc, qt = contact_inputs(base, holder, n, seed=11, light="body_mass" in names)
        dyn = packed_leaves(holder, names, n, seed=22)
        # the body whose contact force shows that the rows act: the tray under
        # the ball, sphere A on the box, the arm's tip on the box, the copters'
        # chassis on the ground (a third of them rest on it)
        body = {"BallBalance": getattr(holder, "tray_body", 0), "Example": 1, "Tendon": 2,
                **dict.fromkeys(GROUND_HEIGHT, 0)}.get(base)
        err = compare_model(holder.model, holder.sim_params, q, qd, qfrc, xfrc, qt, steps,
                            tol=BALL_TOL if base == "BallBalance" else TOL, force_of=body, dyn=dyn)
        seen = err.pop("seen_force", None)
        print(f"{key} kernel vs plain, N={n}, {steps} step(s), {len(names)} per-env leaves"
              + (f" ({dyn.rows.shape[0]} rows)" if dyn is not None else "")
              + (f", body {body} pressed in {100 * seen:.1f} % of envs" if seen is not None else "") + ":",
              json.dumps(err))
        if seen is not None and not seen > (0.25 if base in GROUND_HEIGHT else 0.5):
            raise AssertionError(f"{key}: the contact rows were active in only {100 * seen:.1f} % of envs")
        worst = max(worst, *err.values())
    return worst


def drive_case(key: str, steps: int = 20) -> int:
    """`steps` steps of a CASES entry through `physics_step_fused` at full
    width, the leaves passed as a dict the way a user would; returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused
    from isaacgymenvs_tpu_torch.model.examples import random_leaves

    base, _, n = CASES[key]
    holder, names = case(key, n)
    q, qd, qfrc, xfrc, qt = contact_inputs(base, holder, n, seed=23)
    leaves = {k: torch.tensor(v, device="cuda")
              for k, v in random_leaves(holder.model, names, n, 24, holder.sim_params.gravity).items()}
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        out = fused.physics_step_fused(holder.model, holder.sim_params, q, qd, qfrc, xfrc=xfrc, q_target=qt,
                                       dyn=leaves or None)
        q, qd = out.q, out.qd
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    print(f"{key}: {steps} steps through physics_step_fused at N={n}, {launches} launches, "
          f"max |qd| {float(qd.abs().max()):.3f}")
    if launches != steps or not bool(torch.isfinite(q).all()) or not bool(torch.isfinite(qd).all()):
        raise AssertionError(f"{key}: {launches} launches for {steps} steps, or a state that is not finite")
    return launches


def free_fall_under_per_env_gravity(n: int, steps: int = 10) -> int:
    """An Ant dropped from 3 m with every leaf at the model's own value and
    its own gravity vector per env: after t its base moves at g_i t on all
    three axes. Runs the Ant + all leaves instantiation; returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    holder, names = case("Ant+all", n)
    m, p = holder.model, holder.sim_params
    dyn = packed_leaves(holder, names, n, seed=25, only=("gravity",))
    g = dyn.rows[-3:].T  # (n, 3): gravity is the last leaf of the packed rows
    q = torch.tensor(np.asarray(m.qpos0, np.float32), device="cuda").repeat(n, 1)
    q[:, 2] = 3.0
    qd = torch.zeros(n, m.nv, device="cuda")
    zero = torch.zeros(n, m.nv, device="cuda")
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        out = fused.physics_step_fused(m, p, q, qd, zero, dyn=dyn)
        q, qd = out.q, out.qd
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    t = steps * p.dt
    rel = float(((qd[:, :3] - g * t).abs().max(dim=1).values / (torch.linalg.vector_norm(g, dim=1) * t)).max())
    spread = float(g[:, 2].std())
    print(f"free fall under per-env gravity: {steps} steps, g_z {float(g[:, 2].min()):.3f} to {float(g[:, 2].max()):.3f} "
          f"m/s^2 over {n} envs, max |qd - g_i t| / |g_i t| = {rel:.2e}, {launches} launches")
    if not rel < 1e-3 or not spread > 0.1 or launches != steps:
        raise AssertionError(f"per-env gravity: relative error {rel:.2e}, spread of g_z {spread:.3f}")
    return launches


def settle_ant_with_randomized_mass(n: int, steps: int = 150) -> None:
    """Ant with `task.randomize=True` under zero actions: the feet carry each
    env's OWN weight (its bodies' masses times that env's factors), so the
    spread over envs of fz / own weight is small beside that of fz / nominal."""
    env = task_env("Ant", n, randomize=True)
    state, obs = env.reset(8)
    zero = torch.zeros(n, env.num_acts, device="cuda")
    for _ in range(steps):
        state, obs, _, _, _ = env.step(state, zero)
    own = env.randomizer.batched_model(state.dr)["body_mass"].sum(1) * 9.81
    nominal = float(np.sum(env.model.body_mass)) * 9.81
    fz = obs[:, 28:52].reshape(n, 4, 6)[:, :, 2].sum(1) / env.contact_force_scale
    up = state.sim.q[:, 2] > env.termination_height  # not fallen and reset
    r_own, r_nom = (fz / own)[up], (fz / nominal)[up]
    print(f"settled randomized Ant ({steps} steps, {100 * float(up.float().mean()):.1f} % of {n} envs up): "
          f"own weight {float(own.min()):.2f} to {float(own.max()):.2f} N (nominal {nominal:.2f}), "
          f"feet fz / own weight mean {float(r_own.mean()):.4f} std {float(r_own.std()):.4f}; "
          f"fz / nominal weight std {float(r_nom.std()):.4f}")
    if not 0.9 < float(r_own.mean()) < 1.3 or not float(r_own.std()) < 0.5 * float(r_nom.std()) \
            or not float(up.float().mean()) > 0.9:
        raise AssertionError("the randomized Ant's feet do not carry each env's own weight")


def step_randomized_tasks() -> dict:
    """Cartpole, Ingenuity, Quadcopter and BallBalance with `task.randomize=True`
    and DR_BLOCK passed in, 8 env steps at the yaml's width under random
    actions; returns the launches per task."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    out = {}
    for t, n in DR_TASKS.items():
        env = task_env(t, n, randomize=True)
        state, _ = env.reset(9)
        if state.dyn.names != DR_BLOCK_LEAVES:
            raise AssertionError(f"{t}: per-env leaves {state.dyn.names}")
        gen = torch.Generator(device="cuda").manual_seed(10)
        act = lambda: torch.rand(n, env.num_acts, generator=gen, device="cuda") * 2 - 1
        state, obs, _, _, _ = env.step(state, act())  # warm-up: loads the kernel
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        for _ in range(8):
            state, obs, _, _, _ = env.step(state, act())
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out[t] = _cuda.FusedStepCall.launches
        print(f"{t} task.randomize=True: 8 env steps x {n} envs, {out[t]} launches, {8 * n / sec:.1f} env-steps/s, "
              f"{state.dyn.rows.shape[0]} per-env rows, frames {int(state.frames)}")
        if out[t] != 8 * env.control_freq_inv or not bool(torch.isfinite(obs).all()) or int(state.frames) != 9:
            raise AssertionError(f"{t} with domain randomization: {out[t]} launches, or observations not finite")
    return out


def train_ant_randomized() -> int:
    """`train.main task=Ant task.randomize=True` for ANT_DR_EPOCHS epochs at the
    yaml's width, a bit-equal restore into a fresh agent (whose DR sample is
    its own draw) and play. Returns the kernel launches of the training run."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    with tempfile.TemporaryDirectory() as runs:
        args = ["task=Ant", "task.randomize=True", f"max_iterations={ANT_DR_EPOCHS}", f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = ANT_DR_EPOCHS * HORIZON
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v) and k != "mean_episode_return"}
        if launches != steps or metrics["frames"] != steps * NUM_ENVS or bad:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps; {bad}")
        st = ts.env_state
        if st.dyn.names != ANT_YAML_LEAVES or int(st.frames) != steps:
            raise AssertionError(f"the trained env state carries {st.dyn.names}, frames {int(st.frames)}")
        print(f"Ant task.randomize=True train: {ANT_DR_EPOCHS} epochs x {NUM_ENVS} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches, "
              f"mean episode return {metrics['mean_episode_return']:.2f}")
        ckpt = os.path.join(runs, "Ant", "nn", "last_Ant.pth")
        fts, epoch = restored_bit_equal("Ant", args, ckpt, ts, ANT_DR_EPOCHS)
        mass = "ant.rigid_body_properties.mass"
        if torch.equal(fts.env_state.dr[mass], st.dr[mass]):
            raise AssertionError("the restored run did not draw its own DR sample")
        played = train.main(["task=Ant", "task.randomize=True", "test=True", f"checkpoint={ckpt}"])
        print(f"Ant task.randomize=True restore: bit-equal (epoch {epoch}), DR sample drawn anew; "
              f"play: mean return {played:.2f}")
        if not np.isfinite(played):
            raise AssertionError("Ant play returned a non-finite mean return")
    return launches


def rows(t):
    return t.T.contiguous()


def xfrc_rows(x):
    n, nb, _ = x.shape
    return x.permute(2, 1, 0).reshape(6 * nb, n).contiguous()


def compare(env, steps: int, seed: int, qfrc_max: float = 3.0, with_xfrc: bool = True) -> dict:
    """Kernel vs plain version from the env's reset state under random qfrc
    (and xfrc); see `compare_model`."""
    m, n = env.model, env.num_envs
    state, _ = env.reset(seed)
    rng = np.random.RandomState(seed)
    cuda = lambda a: torch.tensor(a.astype(np.float32), device="cuda")
    qfrc = cuda(rng.uniform(-qfrc_max, qfrc_max, (n, m.nv)))
    xfrc = cuda(rng.uniform(-1, 1, (n, m.nbody, 6))) if with_xfrc else None
    return compare_model(m, env.sim_params, state.sim.q, state.sim.qd, qfrc, xfrc, None, steps)


def compare_model(m, p, q, qd, qfrc, xfrc, q_target, steps: int, tol=TOL, force_of=None, dyn=None) -> dict:
    """Kernel vs plain version from the same inputs, each step; the plain
    output carries the trajectory. Returns the max abs error per output;
    without contacts the force outputs must be exactly zero. With
    `force_of` (a body index) also returns, under "seen_force", the share of
    envs whose kernel body force on that body exceeded 1 mN at some step.
    With `dyn` (a `fused.PackedDyn` of per-env leaves) the kernel's first
    step must also differ from the kernel's step without them."""
    from isaacgymenvs_tpu_torch.engine import fused

    n = q.shape[0]
    s = fused._extract(m)
    names, dyn_rows = (dyn.names, dyn.rows) if dyn is not None else ((), None)
    plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
    err = {k: 0.0 for k in tol}
    pressed = torch.zeros(n, dtype=torch.bool, device="cuda")
    if dyn is not None:
        with_leaves = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=q_target, dyn=dyn)
        without = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=q_target)
        gap = float((with_leaves.qd - without.qd).abs().max())
        if not gap > 1e-3:
            raise AssertionError(f"the kernel's step ignores its per-env leaves {names}: qd differs by {gap:.2e}")
    for _ in range(steps):
        ko = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=q_target, dyn=dyn)
        po = plain(rows(q), rows(qd), rows(qfrc), None if xfrc is None else xfrc_rows(xfrc),
                   None if q_target is None else rows(q_target), dyn_rows)
        nb = m.nbody
        ref = {
            "q": po[0].T, "qd": po[1].T,
            "body_force": po[2].reshape(3, nb, n).permute(2, 1, 0),
            "body_torque": po[3].reshape(3, nb, n).permute(2, 1, 0),
            "dof_force": po[4].T,
        }
        for k in tol:
            got = getattr(ko, k)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"kernel output {k} is not finite")
            err[k] = max(err[k], float((got - ref[k]).abs().max()))
            if s.nct == 0 and "force" in k and float(got.abs().max()) != 0.0:
                raise AssertionError(f"contact-free kernel wrote a non-zero {k}")
        if not float((ko.q - q).abs().max()) > 0.0:
            raise AssertionError("the step left q where it was")
        if force_of is not None:
            pressed |= torch.linalg.vector_norm(ko.body_force[:, force_of], dim=-1) > 1e-3
        q, qd = ref["q"].contiguous(), ref["qd"].contiguous()
    torch.cuda.synchronize()
    bad = {k: (e, tol[k]) for k, e in err.items() if not e < tol[k]}
    if bad:
        raise AssertionError(f"kernel disagrees with the plain version at N={n}: {bad}")
    if force_of is not None:
        err["seen_force"] = float(pressed.float().mean())
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


def kernel_device_ms(fn, reps: int = 20) -> float:
    """ms per launch of fn() with the launches queued back to back: large
    matrix products hold the device while the host enqueues all `reps`
    launches, so the two events bracket device time only (the kernel and
    the gap to the next one), not the wrapper's host side."""
    blocker = torch.randn(4096, 4096, device="cuda")
    n_block = 4
    while n_block <= 64:
        torch.cuda.synchronize()
        for _ in range(n_block):
            blocker @ blocker
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_ahead = not a.query()  # the device had not reached the first launch yet
        b.synchronize()
        if queued_ahead:
            return a.elapsed_time(b) / reps
        n_block *= 2
    raise AssertionError("the host could not queue the launches ahead of the device")


def kernel_times(env, q, qd, qfrc, xfrc, name: str, reps: int = 50, qt=None, dyn=None, terr=None, wre=0,
                 sdf=None) -> dict:
    """ms per launch of the kernel (CUDA events around the wrapper, and
    queued back to back behind other device work), of its plain version,
    and its bound, at (rows, N) inputs on the card. `env` gives the model and
    the parameters (anything with `.model` and `.sim_params`); `dyn` is a
    `fused.PackedDyn` of per-env leaves, `terr` the packed terrain planes and
    `sdf` the packed SDF planes, whose rows count in the bytes bound; `wre`
    the warm-start reset period."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    s, p, n = fused._extract(env.model), env.sim_params, q.shape[-1]
    names, dr = (dyn.names, dyn.rows) if dyn is not None else ((), None)
    has_t = terr is not None
    _, step = fused._prepared(env.model, p, torch.device("cuda"), qt is not None, names, has_t)
    plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
    call = lambda f: f(q, qd, qfrc, xfrc, qt, dr, terr, wre, sdf)
    for _ in range(3):
        call(step)
    ms = event_ms(lambda: call(step), reps)
    device_ms = kernel_device_ms(lambda: call(step))
    call(plain)
    plain_ms = event_ms(lambda: call(plain), 5)
    flop_s, byte_s = peaks(name)
    flops = _cuda.kernel_flops(s, p, has_t) * n
    nbytes = _cuda.kernel_bytes(s, n, xfrc is not None, qt is not None, names, has_t)
    t_ops, t_bytes = 1e3 * flops / flop_s, 1e3 * nbytes / byte_s
    bound = max(t_ops, t_bytes)
    sizes = step.sizes
    print(f"fused step {'_'.join(map(str, sizes))} N={n}: {ms:.4f} ms/launch ({device_ms:.4f} ms on the device), "
          f"plain {plain_ms:.2f} ms, bound {bound:.6f} ms by operations ({flops / 1e9:.4f} GFLOP), {t_bytes:.6f} ms by bytes "
          f"({nbytes / 1e6:.4f} MB), {flops / (ms * 1e-3) / 1e12:.3f} TFLOP/s, {100 * bound / ms:.2f} % of the bound")
    occ = step.occupancy()
    figs = _cuda.ptxas_figures(_cuda.PTXAS_LOG.get(tuple(sizes), ""))
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "envs_per_block": step.epb,
            "smem_bytes": step.smem_bytes, "blocks_per_sm": occ["blocks_per_sm"],
            "warps_per_sm": occ["blocks_per_sm"] * step.epb, "registers": figs["registers"],
            "spill_bytes": None if figs["spill_stores"] is None else figs["spill_stores"] + figs["spill_loads"]}


def time_case(key: str, card: str) -> dict:
    """`kernel_times` of a CASES entry at its full width, in a state where its rows act."""
    base, _, n = CASES[key]
    holder, names = case(key, n)
    q, qd, qfrc, xfrc, qt = contact_inputs(base, holder, n, seed=14, light="body_mass" in names)
    return kernel_times(holder, rows(q), rows(qd), rows(qfrc), None if xfrc is None else xfrc_rows(xfrc), card,
                        reps=30, qt=None if qt is None else rows(qt), dyn=packed_leaves(holder, names, n, seed=27))


def train_epochs(task: str = "Ant", width=(NUM_ENVS, HORIZON, 65536, 32768, 4), profile: bool = True,
                 overrides=()) -> int:
    """Three timed PPO epochs on `task` at its yaml's full width (`width` =
    envs, horizon, batch, minibatch, mini-epochs), with further config
    `overrides` (e.g. task.randomize=True); returns the kernel launches of
    the timed epochs."""
    from isaacgymenvs_tpu_torch.engine import _cuda
    from isaacgymenvs_tpu_torch.learn import PPO
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config([f"task={task}", *overrides])
    env = task_map[task](cfg["task"], device="cuda")
    label = task + (" " + " ".join(overrides) if overrides else "")
    agent = PPO(env, cfg["train"]["params"], seed=int(cfg["seed"]))
    c = agent.cfg
    horizon = width[1]
    if (env.num_envs, c.horizon_length, agent.batch_size, agent.minibatch_size, c.mini_epochs) != tuple(width):
        raise AssertionError(f"{task}PPO.yaml is not at its full width")
    split = {}
    rollout = agent.rollout

    def timed_rollout(ts, noise=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rollout(ts, noise)
        torch.cuda.synchronize()
        split["rollout"] = time.perf_counter() - t0
        return out

    agent.rollout = timed_rollout
    ts = agent.init()
    before = [p.detach().clone() for p in agent.network.parameters()]
    ts, _ = agent.train_epoch(ts)  # warm-up
    total = 0
    for epoch in range(3):
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = agent.train_epoch(ts)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        total += launches
        if launches != horizon * (1 if env.merge_slices else env.control_freq_inv):
            raise AssertionError(f"{launches} kernel launches in an epoch of {horizon} env steps")
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        if bad or not c.min_lr <= metrics["lr"] <= c.max_lr or not metrics["kl"] >= 0.0:
            raise AssertionError(f"epoch metrics out of range: {metrics}")
        print(f"{label} train epoch {epoch}: {sec:.4f} s = rollout {split['rollout']:.4f} s + update "
              f"{sec - split['rollout']:.4f} s, {agent.batch_size / sec:.1f} env-steps/s, {launches} launches, "
              f"a_loss {metrics['a_loss']:.5f} c_loss {metrics['c_loss']:.5f} kl {metrics['kl']:.5f} "
              f"lr {metrics['lr']:.2e}")
    if profile:
        profile_window(lambda: agent.train_epoch(ts), f"{label} train epoch", 1, "epoch")
    moved = max(float((p.detach() - b).abs().max()) for p, b in zip(agent.network.parameters(), before))
    if not moved > 0.0 or not all(bool(torch.isfinite(p).all()) for p in agent.network.parameters()):
        raise AssertionError("the update did not move the parameters, or left them not finite")
    return total


def restored_bit_equal(task: str, args, ckpt: str, ts, epochs: int) -> list:
    """Restore `ckpt` into a fresh agent of another seed: parameters, lr,
    running stats and Adam moments must equal the trained state `ts` bit for
    bit. Returns [the fresh agent's train state, the checkpoint's epoch]."""
    from isaacgymenvs_tpu_torch.learn import PPO
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config(args)
    fresh = PPO(task_map[task](cfg["task"], device="cuda"), cfg["train"]["params"], seed=1)
    fts, epoch = fresh.restore(ckpt, fresh.init())
    trained = ts.optimizer.param_groups[0]["params"]  # the trained network's parameters
    same = epoch == epochs and fts.lr == ts.lr
    same &= all(torch.equal(a, b) for a, b in zip(fresh.network.parameters(), trained, strict=True))
    for a, b in ((fts.obs_rms, ts.obs_rms), (fts.value_rms, ts.value_rms)):
        same &= all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("mean", "var", "count"))
    fst, tst = fts.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"]
    same &= set(fst) == set(tst) and all(
        torch.equal(fst[i][k].cpu(), tst[i][k].cpu()) for i in tst for k in ("step", "exp_avg", "exp_avg_sq"))
    if not same:
        raise AssertionError(f"{task}: restore did not give back the trained state bit for bit")
    return [fts, epoch]


def train_cartpole() -> int:
    """Cartpole through `train.main`: train, restore, play. Returns the
    kernel launches of the training run."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    with tempfile.TemporaryDirectory() as runs:
        args = ["task=Cartpole", f"max_iterations={CARTPOLE_EPOCHS}", f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = CARTPOLE_EPOCHS * HORIZON
        if launches != steps or metrics["frames"] != steps * CARTPOLE_ENVS:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps")
        ret = metrics["mean_episode_return"]
        print(f"Cartpole train: {CARTPOLE_EPOCHS} epochs x {CARTPOLE_ENVS} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches, "
              f"mean episode return {ret:.2f} (bar {RETURN_BAR})")
        if not ret > RETURN_BAR:
            raise AssertionError(f"Cartpole trained to {ret:.2f}, not past {RETURN_BAR}")
        ckpt = os.path.join(runs, "Cartpole", "nn", "last_Cartpole.pth")
        if not os.path.exists(os.path.join(runs, "Cartpole", "config.yaml")):
            raise AssertionError("train wrote no config.yaml")

        epoch = restored_bit_equal("Cartpole", args, ckpt, ts, CARTPOLE_EPOCHS).pop()

        played = train.main(["task=Cartpole", "test=True", f"checkpoint={ckpt}"])
        print(f"Cartpole restore: bit-equal (epoch {epoch}); play: mean return {played:.2f} (bar {RETURN_BAR})")
        if not played > RETURN_BAR:
            raise AssertionError(f"the restored policy played to {played:.2f}, not past {RETURN_BAR}")
    return launches


def profile_window(fn, label: str, units: int, unit: str) -> float:
    """Device busy share and the largest device-time entries of fn(), which
    covers `units` steps or epochs, from torch.profiler (CUDA activity).
    Returns the device ops per unit."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    n_kernels = sum(e.count for e in ev if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profile {label} x{units}: wall {wall_ms / units:.4f} ms/{unit} (profiler on), "
          f"device busy {busy_ms / units:.4f} ms/{unit} ({100 * busy_ms / wall_ms:.1f} %), "
          f"{n_kernels / units:.1f} device ops/{unit}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / units:.4f} ms/{unit}  x{e.count / units:.1f}  {e.key[:90]}")
    return n_kernels / units


def profile_env_step(env, steps: int = 8, label: str = "env.step") -> float:
    """env.step under random actions, profiled; returns device ops per step."""
    state, _ = env.reset(4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    act = lambda: torch.rand(env.num_envs, env.num_acts, generator=gen, device="cuda") * 2 - 1
    for _ in range(2):
        state, _, _, _, _ = env.step(state, act())

    def window():
        st = state
        for _ in range(steps):
            st, _, _, _, _ = env.step(st, act())

    return profile_window(window, label, steps, "step")


# ---- Anymal and AnymalTerrain: top-K (K5), terrain rows (K6), merged windows ----

ANYMAL_ENVS = 4096  # numEnvs of both yamls
# instantiation key -> (task, config overrides)
ANYMAL_CASES = {
    "Anymal": ("Anymal", ()),
    "AnymalTerrain": ("AnymalTerrain", ()),
    "AnymalTerrain-plane": ("AnymalTerrain", ("task.env.terrain.terrainType=plane",)),
}
KEY_GAP = 1e-4  # the keys either side of the top-K cap differ by more, in every env and slice
MARGIN_GAP = 1e-5  # no candidate lies within this of the contact margin (its row would flip on rounding)
LIMIT_GAP = 1e-3  # nor a limited joint within this (radians) of a limit at the step's start or end
# A comparison env must be well conditioned: float32 rounding alone may move
# its step by a quarter of the tolerance at most. Measured as the plain
# version in float32, from the inputs and from the inputs with the base's
# position one ulp up and one ulp down, against the same in float64: the
# largest gap of the three stands for the rounding noise, as one float32
# result is only one draw of it (the same env moves by 0.01 N between a
# batch of 4096 envs and one of 8192, whose reductions sum otherwise).
# Not all are: a robot pushed in with 21 candidates active on flat ground
# carries 0.01-0.03 N of float32 noise in its forces, and far from the
# world origin the step's origin-referenced spatial algebra loses more (on
# the terrain grid, one ulp of a base's x at 150 m moves a step's qd by up
# to 0.1 m/s).
COND_TOL = {"q": 5e-5, "qd": 5e-4, "force": 5e-3}
# For the comparisons the terrain grid is moved so that the corner where
# four cells meet (rough slopes and stairs up, levels 4 and 5) lies at the
# world origin; the robots stand within CORNER_REACH of it.
TERRAIN_CORNER = (3, 4)  # (level, type) of the cell whose low corner it is
CORNER_REACH = 3.5
TUMBLED_SHARE = 16  # one comparison env in this many lies tumbled, more than 20 candidates active


def anymal_env(key: str, n: int, overrides=()):
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    task, extra = ANYMAL_CASES[key]
    return task_map[task](load_config([f"task={task}", f"num_envs={n}", *extra, *overrides])["task"], device="cuda")


def physics_args(env):
    """(params, warm_reset_every) of one env step's physics call."""
    return (env._merged_params, env._warm_reset_every) if env.merge_slices else (env.sim_params, 0)


def candidates_of(env, q):
    """World positions (N, ncp, 3) of the model's candidate points at q."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine import dynamics

    m = env.model
    cb = torch.tensor(m.cpoint_body, device="cuda")
    kin = dynamics.forward_kinematics(m, q, torch.zeros(q.shape[0], m.nv, device="cuda"))
    return kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], torch.tensor(np.asarray(m.cpoint_pos), device="cuda"))


def moved_terrain(env):
    """The env's terrain grid with TERRAIN_CORNER at the world origin."""
    from isaacgymenvs_tpu_torch.engine.dynamics import Terrain

    g = env.grid
    cells = round(g.env_length / g.hs)
    corner = [(g.border + TERRAIN_CORNER[k] * cells) * g.hs for k in range(2)]
    return Terrain(env.terrain.height, g.hs, origin=(-corner[0], -corner[1]))


def anymal_pool(env, n: int, seed: int, terrain):
    """2n comparison candidates (q, qd, q_target), env-leading on the card:
    robots standing (the lowest candidate 1 mm in the ground, default joint
    angles within 0.1 rad, random heading, gentle velocities), and one in
    four (four times the share taken) lying in a random orientation with
    random joints, pushed in until 21 candidates are within the margin (the
    poses whose 21 lowest candidates lie closest, from a pool of random ones)
    and moving up at a random share of the push-out speed of the deepest
    points (so that some of them end up with moderate contact forces)."""
    from isaacgymenvs_tpu_torch import maths

    m, dev = env.model, "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    k = 2 * n
    nt = k // 4
    reach = CORNER_REACH
    q = env.qpos0.repeat(k, 1)
    q[:, :2] = (2 * u(k, 2) - 1) * reach
    yaw = 2 * np.pi * u(k)
    q[:, 3:7] = torch.stack([torch.zeros_like(yaw)] * 2 + [torch.sin(yaw / 2), torch.cos(yaw / 2)], -1)
    q[:, env.dof_q_idx] = env.default_dof_pos + 0.2 * (u(k, 12) - 0.5)
    # the tumbled ones: the best of 8 random poses per slot
    wide = 8 * nt
    qt_ = q[:nt].repeat(8, 1)
    quat = torch.randn(wide, 4, generator=g, device=dev)
    qt_[:, 3:7] = quat / torch.linalg.vector_norm(quat, dim=1, keepdim=True)
    # random joints, the hips kept 0.09 rad inside their limits (+-0.49 on the inner side)
    qt_[:, env.dof_q_idx] = (2 * u(wide, 12) - 1) * torch.tensor([0.4, 3.0, 3.0] * 4, device=dev)
    x = candidates_of(env, qt_)
    ground = terrain.sample(x[..., :2]) if terrain is not None else 0.0
    gap = torch.sort(x[..., 2] - torch.tensor(np.asarray(m.cpoint_radius), device=dev) - ground, 1).values
    best = torch.argsort((gap[:, 20] - gap[:, 0]).reshape(8, nt), 0)[0] * nt + torch.arange(nt, device=dev)
    q[:nt] = qt_[best]
    x = candidates_of(env, q)
    ground = terrain.sample(x[..., :2]) if terrain is not None else 0.0
    gap = torch.sort(x[..., 2] - torch.tensor(np.asarray(m.cpoint_radius), device=dev) - ground, 1).values
    q[:nt, 2] -= gap[:nt, 20] - 0.015
    q[nt:, 2] -= gap[nt:, 0] + 0.001
    qd = 0.05 * (2 * u(k, m.nv) - 1)
    qd[:nt] = 0.0
    p, _ = physics_args(env)
    h = p.dt / (p.substeps * p.solver_iterations)
    deep = gap[:nt, 20] - gap[:nt, 0] - 0.015
    qd[:nt, 2] = u(nt) * torch.clamp(p.baumgarte_erp * deep / h, max=p.max_depenetration_velocity)
    qt = q + 0.1 * (u(k, m.nq) - 0.5)
    return q, qd, qt, nt


def conditioned(env, s, names, q, qd, qt, dyn_rows, terrain, p, wre):
    """Per env: the cap-boundary keys of every slice differ by more than
    KEY_GAP, no candidate lies within MARGIN_GAP of the margin, no joint
    crosses a limit during the step or lies within LIMIT_GAP of one at its
    start or end (a limit switches on a stiff spring, a jump the two
    roundings could take at different slices), and the plain step in
    float32, from q and from q's base position one ulp up and down, is
    within COND_TOL of the same in float64, as is the kernel's step from q
    of its step from q one ulp up (launches that count for no main path).
    Also returns the active candidates per env in the first slice."""
    from isaacgymenvs_tpu_torch.engine import fused

    keys = []
    terr = None if terrain is None else fused.pack_terrain(fused.terrain_dyn(env.model, terrain, q, qd))
    zero = torch.zeros(s.nv, q.shape[0], device="cuda")
    ins = (rows(q), rows(qd), zero, None, rows(qt), dyn_rows, terr)
    a = fused._step_math_torch(s, p, torch.device("cuda"), names, keys)(*ins, wre)
    wide = fused._step_math_torch(s, p, torch.device("cuda"), names, dtype=torch.float64)
    b = wide(*(None if x is None else x.double() for x in ins), wre)
    plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
    ok = torch.ones(q.shape[0], dtype=torch.bool, device="cuda")
    for sign in (0.0, 1e9, -1e9):
        if sign:
            shifted = q.clone()
            shifted[:, :3] = torch.nextafter(shifted[:, :3], torch.full_like(shifted[:, :3], sign))
            out = plain(rows(shifted), *ins[1:], wre)
        else:
            out = a
        gap = lambda i: (out[i] - b[i]).abs().amax(0)
        ok &= (gap(0) < COND_TOL["q"]) & (gap(1) < COND_TOL["qd"])
        ok &= (gap(2) < COND_TOL["force"]) & (gap(3) < COND_TOL["force"]) & (gap(4) < COND_TOL["force"])
    # and the kernel's own noise: its step from q and from q one ulp up
    dyn = None if dyn_rows is None else fused.PackedDyn(names, dyn_rows)
    run = lambda x: fused.physics_step_fused(env.model, p, x, qd, zero.T, q_target=qt, dyn=dyn, terrain=terr,
                                             warm_reset_every=wre)
    shifted = q.clone()
    shifted[:, :3] = torch.nextafter(shifted[:, :3], torch.full_like(shifted[:, :3], 1e9))
    k0, k1 = run(q), run(shifted)
    ok &= ((k0.q - k1.q).abs().amax(1) < COND_TOL["q"]) & ((k0.qd - k1.qd).abs().amax(1) < COND_TOL["qd"])
    for f in ("body_force", "body_torque", "dof_force"):
        d = (getattr(k0, f) - getattr(k1, f)).abs()
        ok &= d.reshape(d.shape[0], -1).amax(1) < COND_TOL["force"]
    m, dofs = env.model, env.dof_q_idx
    lim = torch.tensor(np.asarray(m.dof_limited)[env.dof_idx.cpu().numpy()], device="cuda") > 0
    lo = torch.tensor(np.asarray(m.dof_limit_lower)[env.dof_idx.cpu().numpy()], device="cuda")
    hi = torch.tensor(np.asarray(m.dof_limit_upper)[env.dof_idx.cpu().numpy()], device="cuda")
    start, end = q[:, dofs], a[0].T[:, dofs]
    near = lambda x: torch.minimum((x - lo).abs(), (x - hi).abs())
    crossed = ((start > hi) != (end > hi)) | ((start < lo) != (end < lo))
    ok &= ~torch.any(lim & (crossed | (near(start) < LIMIT_GAP) | (near(end) < LIMIT_GAP)), dim=1)
    cap = fused.topk_cap(s, p)
    for phi, key in keys:
        ok &= (phi + p.contact_margin).abs().amin(0) > MARGIN_GAP
        if cap:
            srt = torch.sort(key, 0, descending=True).values
            ok &= (srt[cap - 1] - srt[cap] > KEY_GAP) | (srt[cap - 1] < -1e29)
    active = (keys[0][0] > -p.contact_margin).sum(0)
    return ok, active, terr


def anymal_inputs(key: str, env, n: int, seed: int):
    """Comparison inputs at n envs that pass `conditioned`: (q, qd, q_target,
    packed per-env leaves or None, terrain planes or None, the moved terrain
    or None), with the count of redrawn candidates and of envs past the cap."""
    from isaacgymenvs_tpu_torch.engine import fused

    s = fused._extract(env.model)
    p, wre = physics_args(env)
    terrain = moved_terrain(env) if env.terrain is not None else None
    q, qd, qt, nt = anymal_pool(env, n, seed, terrain)
    k = q.shape[0]
    names = env.randomizer.batched_leaf_names() if env.randomizer is not None else set()
    dyn = None
    if names:
        # per-env contact friction, as the setup-only draw gives it (factor 0.5-1.25)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        fr = torch.tensor(np.asarray(env.model.cpoint_friction), device="cuda")
        dyn = fused.pack_dyn(s, {"cpoint_friction": fr * (0.5 + 0.75 * torch.rand(k, s.ncp_model, generator=g, device="cuda"))})
    ok, active, _ = conditioned(env, s, dyn.names if dyn is not None else (), q, qd, qt,
                                None if dyn is None else dyn.rows, terrain, p, wre)
    idx = torch.arange(k, device="cuda")
    tumbled = idx[ok & (idx < nt)][: n // TUMBLED_SHARE]
    standing = idx[ok & (idx >= nt)][: n - len(tumbled)]
    pick = torch.cat([tumbled, standing])
    if len(pick) != n or len(tumbled) == 0:
        raise AssertionError(f"{key}: only {len(pick)} of {k} candidates are well conditioned ({len(tumbled)} tumbled)")
    past_cap = int((active[pick] > 20).sum())
    sel = lambda t: t[pick].contiguous()
    dyn_n = None if dyn is None else fused.PackedDyn(dyn.names, dyn.rows[:, pick].contiguous())
    terr = None if terrain is None else fused.pack_terrain(fused.terrain_dyn(env.model, terrain, sel(q), sel(qd)))
    return (sel(q), sel(qd), sel(qt), dyn_n, terr, terrain), k - int(ok.sum()), past_cap


def compare_anymal(key: str) -> float:
    """The instantiation of `key` against its plain version for one env
    step's physics call (merged where the task merges) at N=1003 and at
    full width, in states where the rows act; returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    worst = 0.0
    for n in (RAGGED_ENVS, ANYMAL_ENVS):
        env = anymal_env(key, n)
        (q, qd, qt, dyn, terr, _), redrawn, past_cap = anymal_inputs(key, env, n, seed=31)
        p, wre = physics_args(env)
        s = fused._extract(env.model)
        names = dyn.names if dyn is not None else ()
        zero = torch.zeros(n, s.nv, device="cuda")
        ko = fused.physics_step_fused(env.model, p, q, qd, zero, q_target=qt, dyn=dyn, warm_reset_every=wre,
                                      terrain=terr)
        plain = fused._step_math_torch(s, p, torch.device("cuda"), names)
        po = plain(rows(q), rows(qd), rows(zero), None, rows(qt), None if dyn is None else dyn.rows, terr, wre)
        nb = s.nbody
        ref = {"q": po[0].T, "qd": po[1].T, "body_force": po[2].reshape(3, nb, n).permute(2, 1, 0),
               "body_torque": po[3].reshape(3, nb, n).permute(2, 1, 0), "dof_force": po[4].T}
        err = {}
        for k_, ref_k in ref.items():
            got = getattr(ko, k_)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{key}: kernel output {k_} is not finite")
            err[k_] = float((got - ref_k).abs().max())
        torch.cuda.synchronize()
        pressed = float((torch.linalg.vector_norm(ko.body_force, dim=-1).amax(1) > 1.0).float().mean())
        print(f"{key} kernel vs plain, N={n}, one env step ({p.substeps * p.solver_iterations} slices, "
              f"warm reset every {wre}), {redrawn} candidates redrawn, {past_cap} envs with more than 20 "
              f"candidates active, contact force in {100 * pressed:.1f} % of envs:", json.dumps(err))
        bad = {k_: (e, TOL[k_]) for k_, e in err.items() if not e < TOL[k_]}
        if bad or past_cap == 0 or pressed < 0.75:
            raise AssertionError(f"{key} kernel disagrees with the plain version at N={n}: {bad}, "
                                 f"{past_cap} envs past the cap, contact in {pressed:.3f}")
        worst = max(worst, *err.values())
    return worst


def merged_vs_separate() -> dict:
    """One merged call (4 slices, warm start reset at each slice) against four
    separate launches, from the same state: equal on flat ground (bar
    1e-6, expected 0); on terrain only printed (the planes are sampled once
    for the merged window, at each launch for the separate ones)."""
    from isaacgymenvs_tpu_torch.engine import fused

    out = {}
    for key in ("AnymalTerrain-plane", "AnymalTerrain"):
        env = anymal_env(key, ANYMAL_ENVS)
        (q, qd, qt, dyn, terr, terrain), _, _ = anymal_inputs(key, env, ANYMAL_ENVS, seed=32)
        zero = torch.zeros_like(qd)
        merged = fused.physics_step_fused(env.model, env._merged_params, q, qd, zero, q_target=qt, dyn=dyn,
                                          warm_reset_every=env._warm_reset_every, terrain=terr)
        qq, qv = q, qd
        for _ in range(env.control_freq_inv):
            planes = None if terrain is None else fused.pack_terrain(fused.terrain_dyn(env.model, terrain, qq, qv))
            sep = fused.physics_step_fused(env.model, env.sim_params, qq, qv, zero, q_target=qt, dyn=dyn,
                                           terrain=planes)
            qq, qv = sep.q, sep.qd
        d = {k: float((getattr(merged, k) - getattr(sep, k)).abs().max()) for k in ("q", "qd", "body_force")}
        print(f"{key}: merged window vs {env.control_freq_inv} separate launches, max |difference|:", json.dumps(d))
        if terrain is None and not max(d.values()) < 1e-6:
            raise AssertionError(f"the merged window differs from separate launches on flat ground: {d}")
        out[key] = d
    return out


def settle_anymal(steps: int = 30) -> None:
    """Anymal on flat ground from the default pose under zero actions (PD
    targets at the default joint angles): over the last 10 of `steps` steps
    the feet carry 0.9-1.3 x the weight on average, knees and base carry
    nothing, and the base's height changes by less than 3 cm. The base sinks
    slowly all the same: with the yaml's 16 APGD iterations the feet creep
    (PERF.md, section 6)."""
    from isaacgymenvs_tpu_torch.engine import fused

    env = anymal_env("Anymal", ANYMAL_ENVS)
    m, n = env.model, ANYMAL_ENVS
    state, _ = env.reset(11)
    state.sim.q[:, env.dof_q_idx] = env.default_dof_pos
    state.sim.qd.zero_()
    zero = torch.zeros(n, env.num_acts, device="cuda")
    shanks = [i for i, nm in enumerate(m.body_names) if "SHANK" in nm]
    z, fz, knees, base = [], [], 0.0, 0.0
    for i in range(steps):
        if i >= steps - 10:
            # the sensors of the step the env takes next, from the same state
            _, _, qt = env.compute_force(zero, state.sim.q, state.sim.qd, state.task)
            out = fused.physics_step_fused(m, env.sim_params, state.sim.q, state.sim.qd,
                                           torch.zeros(n, m.nv, device="cuda"), q_target=qt)
            fz.append(out.body_force[:, shanks, 2].sum(1).mean())
            knees = max(knees, float(torch.linalg.vector_norm(out.body_force[:, env.knee_bodies], dim=-1).max()))
            base = max(base, float(torch.linalg.vector_norm(out.body_force[:, 0], dim=-1).max()))
        state, obs, _, done, _ = env.step(state, zero)
        z.append(state.sim.q[:, 2].clone())
    ratio = float(torch.stack(fz).mean()) / (float(np.sum(m.body_mass)) * 9.81)
    zs = torch.stack(z[-10:])
    drift = float((zs.amax(0) - zs.amin(0)).max())
    print(f"settled Anymal ({steps} steps x {n} envs): feet fz / weight {ratio:.4f} (mean of the last 10 steps), "
          f"max knee force {knees:.3f} N, max base force {base:.3f} N, base z {float(z[-1].mean()):.4f} m "
          f"(from 0.62), largest change over the last 10 steps {drift:.4f} m, {int(done.sum())} envs done")
    if not 0.9 < ratio < 1.3 or knees > 1.0 or base > 1.0 or not drift < 0.03 or bool(done.any()):
        raise AssertionError("Anymal did not stand on flat ground")


def terrain_types_and_curriculum(steps: int = 100) -> None:
    """AnymalTerrain spawned on every terrain type at every level under random
    actions: finite, the base above the local ground after `steps` steps;
    then a run of 30-step episodes in which half the robots are moved a full
    cell away from their spawn: levels go up and down."""
    env = anymal_env("AnymalTerrain", ANYMAL_ENVS)
    state, _ = env.reset(12)
    n, dev = ANYMAL_ENVS, "cuda"
    level = torch.arange(n, device=dev) % env.num_levels
    ttype = (torch.arange(n, device=dev) // env.num_levels) % env.num_types
    q, qd, task = env.sample_init(state.rng, n, level=level, ttype=ttype)
    state.sim.q, state.sim.qd, state.task = q, qd, task
    gen = torch.Generator(device=dev).manual_seed(13)
    for _ in range(steps):
        state, obs, _, _, _ = env.step(state, torch.rand(n, env.num_acts, generator=gen, device=dev) * 2 - 1)
    q = state.sim.q
    above = q[:, 2] - env.terrain.sample(q[:, :2])
    types = len(torch.unique(state.task["type"]))
    print(f"AnymalTerrain on every terrain type ({types} types x {env.num_levels} levels, {steps} steps): finite "
          f"{bool(torch.isfinite(q).all() and torch.isfinite(obs).all())}, base above the local ground by "
          f"{float(above.min()):.4f} to {float(above.max()):.4f} m")
    if not bool(torch.isfinite(q).all()) or not float(above.min()) > 0.0 or types != env.num_types:
        raise AssertionError("AnymalTerrain left the terrain or went non-finite")
    cfg_env = anymal_env("AnymalTerrain", n, overrides=("task.env.episodeLength=30",))
    state, _ = cfg_env.reset(14)
    start = state.task["level"].clone()
    far = state.task["origin"][:, :2] + torch.tensor([cfg_env.grid.env_length, 0.0], device=dev)
    half = torch.arange(n, device=dev) < n // 2
    state.sim.q[:, :2] = torch.where(half[:, None], far, state.sim.q[:, :2])
    first = torch.full((n,), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros(n, cfg_env.num_acts, device=dev)
    for _ in range(31):
        state, _, _, done, _ = cfg_env.step(state, zero)
        first = torch.where(done & (first < 0), state.task["level"], first)
    up = int((first > start).sum())
    down = int(((first >= 0) & (first < start)).sum())
    print(f"curriculum after one 30-step episode: {up} envs up a level, {down} down, "
          f"{int((first < 0).sum())} not finished")
    if not up > 0 or not down > 0:
        raise AssertionError("the terrain curriculum did not move both ways")


def train_anymal_terrain(epochs: int = 4) -> int:
    """`train.main task=AnymalTerrain` for `epochs` epochs at the yaml's width,
    a bit-equal restore into a fresh agent, and play. Returns the launches of
    the training run (one per env step: the merged window)."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    with tempfile.TemporaryDirectory() as runs:
        args = ["task=AnymalTerrain", f"max_iterations={epochs}", f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = epochs * 24
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v) and k != "mean_episode_return"}
        if launches != steps or metrics["frames"] != steps * ANYMAL_ENVS or bad:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps; {bad}")
        print(f"AnymalTerrain train: {epochs} epochs x {ANYMAL_ENVS} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches, "
              f"mean terrain level {metrics['env/terrain_level']:.3f}")
        ckpt = os.path.join(runs, "AnymalTerrain", "nn", "last_AnymalTerrain.pth")
        epoch = restored_bit_equal("AnymalTerrain", args, ckpt, ts, epochs).pop()
        played = train.main(["task=AnymalTerrain", "test=True", f"checkpoint={ckpt}"])
        print(f"AnymalTerrain restore: bit-equal (epoch {epoch}); play: mean return {played:.2f}")
        if not np.isfinite(played):
            raise AssertionError("AnymalTerrain play returned a non-finite mean return")
    return launches


def drive_plane(steps: int = 16) -> int:
    """The top-K instantiation without terrain on its own path: AnymalTerrain
    with `terrainType: plane` stepped at full width under random actions."""
    from isaacgymenvs_tpu_torch.engine import _cuda

    env = anymal_env("AnymalTerrain-plane", ANYMAL_ENVS)
    state, _ = env.reset(15)
    gen = torch.Generator(device="cuda").manual_seed(16)
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        state, obs, _, _, _ = env.step(state, torch.rand(ANYMAL_ENVS, 12, generator=gen, device="cuda") * 2 - 1)
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    print(f"AnymalTerrain terrainType=plane: {steps} env steps x {ANYMAL_ENVS} envs, {launches} launches")
    if launches != steps or not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"plane variant: {launches} launches for {steps} steps, or observations not finite")
    return launches


def time_anymal(key: str, card: str) -> dict:
    """`kernel_times` of the instantiation of `key` at full width for one env
    step's physics call, in comparison states."""
    env = anymal_env(key, ANYMAL_ENVS)
    (q, qd, qt, dyn, terr, _), _, _ = anymal_inputs(key, env, ANYMAL_ENVS, seed=33)
    p, wre = physics_args(env)
    holder = type("Holder", (), {"model": env.model, "sim_params": p})()
    return kernel_times(holder, rows(q), rows(qd), rows(torch.zeros_like(qd)), None, card, reps=30,
                        qt=rows(qt), dyn=dyn, terr=terr, wre=wre)


# ---- FactoryTaskInsertion: K6 SDF rows, envs per block from shared memory ----

INSERTION_ENVS = 128  # numEnvs of FactoryTaskInsertion.yaml
INSERTION_WIDE = 4096
INSERTION_EPOCHS = 4
INSERTION_WIDTH = (INSERTION_ENVS, 32, 4096, 512, 8)  # envs, horizon, batch, minibatch, mini-epochs of its yaml
BALL_ENVS = 64  # balls settled on the SDF box side by side, each in its own env
BALL_REST = (0.45, 0.015)  # height of the ball's centre on the box top and the band it must rest in


def insertion_env(n: int):
    return task_env("FactoryTaskInsertion", n)


def ball_holder():
    """The ball on an SDF box (`model.examples.ball_on_sdf_box`) with the
    parameters of tests/test_sdf.py, as an object with `.model` and `.sim_params`."""
    from types import SimpleNamespace

    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import ball_on_sdf_box

    return SimpleNamespace(model=ball_on_sdf_box(), use_pd_targets=False, sim_params=SimParams(dt=1 / 60, substeps=2))


def sdf_planes(m, q, qd):
    from isaacgymenvs_tpu_torch.engine import fused

    return fused.pack_sdf(fused.sdf_dyn(m, q, qd))


def insertion_inputs(env, n: int, seed: int):
    """n comparison inputs of Insertion's physics step on the card: contact
    states (`FactoryTaskInsertion.contact_states`: the plug in the bore, on
    the socket's top face, lying against its side), 2n drawn and the first n
    kept whose rows are well placed for the comparison: no candidate within
    MARGIN_GAP of the contact margin and, in every slice, the keys either
    side of the top-K cap more than KEY_GAP apart (or no active row past the
    cap). Returns ((q, qd, qfrc, xfrc, q_target, SDF planes), redrawn, envs
    past the cap, share of envs with an SDF row active)."""
    from isaacgymenvs_tpu_torch.engine import fused

    m, p = env.model, env.sim_params
    s = fused._extract(m)
    cap = fused.topk_cap(s, p)
    q, qd = env.contact_states(2 * n, seed)
    qfrc, xfrc, qt = env.compute_force(None, q, qd, {"q_ref": q[:, env.q_idx]})
    sdf = sdf_planes(m, q, qd)
    keys = []
    fused._step_math_torch(s, p, torch.device("cuda"), (), keys)(
        rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), rows(qt), None, None, 0, sdf)
    ok = torch.ones(2 * n, dtype=torch.bool, device="cuda")
    for phi, key in keys:
        ok &= (phi + p.contact_margin).abs().amin(0) > MARGIN_GAP
        srt = torch.sort(key, 0, descending=True).values
        ok &= (srt[cap - 1] - srt[cap] > KEY_GAP) | (srt[cap] < -1e29)
    active = keys[0][0] > -p.contact_margin
    pick = torch.arange(2 * n, device="cuda")[ok][:n]
    if len(pick) != n:
        raise AssertionError(f"Insertion: only {len(pick)} of {2 * n} contact states are well placed")
    past_cap = int((active.sum(0)[pick] > cap).sum())
    sdf_share = float(active[s.nc + s.pp_nc:s.nc + s.pp_nc + s.sp_n].any(0)[pick].float().mean())
    sel = lambda t: t[pick].contiguous()
    return ((sel(q), sel(qd), sel(qfrc), sel(xfrc), sel(qt), sdf[:, pick].contiguous()),
            2 * n - int(ok.sum()), past_cap, sdf_share)


def compare_outputs(label: str, ko, po, nb: int, n: int) -> dict:
    """Max abs error per output of the kernel's FusedOut against the plain
    version's (rows, N) outputs; raises past TOL."""
    ref = {"q": po[0].T, "qd": po[1].T, "body_force": po[2].reshape(3, nb, n).permute(2, 1, 0),
           "body_torque": po[3].reshape(3, nb, n).permute(2, 1, 0), "dof_force": po[4].T}
    err = {}
    for k, r in ref.items():
        got = getattr(ko, k)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: kernel output {k} is not finite")
        err[k] = float((got - r).abs().max())
    bad = {k: (e, TOL[k]) for k, e in err.items() if not e < TOL[k]}
    if bad:
        raise AssertionError(f"{label}: kernel disagrees with the plain version: {bad}")
    return err


def compare_insertion() -> float:
    """Insertion's instantiation (64 plane rows, 64 SDF rows, cap 32,
    q_target, xfrc; envs per block from shared memory) against its plain
    version for one env step at N=RAGGED_ENVS, at the yaml's 128 and at
    4096, in contact states with SDF rows active in most envs and the cap
    binding in some; returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    worst = 0.0
    for n in (RAGGED_ENVS, INSERTION_ENVS, INSERTION_WIDE):
        env = insertion_env(n)
        (q, qd, qfrc, xfrc, qt, sdf), redrawn, past_cap, sdf_share = insertion_inputs(env, n, seed=41)
        m, p = env.model, env.sim_params
        s = fused._extract(m)
        ko = fused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=qt, sdf=sdf)
        po = fused._step_math_torch(s, p, torch.device("cuda"))(
            rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), rows(qt), None, None, 0, sdf)
        err = compare_outputs(f"Insertion N={n}", ko, po, s.nbody, n)
        torch.cuda.synchronize()
        plug = env.plug_ref.body0
        pressed = float((torch.linalg.vector_norm(ko.body_force[:, plug], dim=-1) > 0.1).float().mean())
        _, step = fused._prepared(m, p, q.device, True)
        print(f"Insertion kernel vs plain, N={n}, one env step ({p.substeps} slices), {step.epb} envs per block "
              f"({step.smem_bytes} bytes of shared memory, limit {step.smem_limit}), {redrawn} states redrawn, "
              f"SDF rows active in {100 * sdf_share:.1f} % of envs, {past_cap} envs past the cap of "
              f"{fused.topk_cap(s, p)}, plug force in {100 * pressed:.1f} % of envs:", json.dumps(err))
        if not sdf_share > 0.5 or past_cap == 0 or not pressed > 0.5:
            raise AssertionError(f"Insertion N={n}: SDF rows active in {sdf_share:.3f} of envs, {past_cap} past "
                                 f"the cap, plug force in {pressed:.3f}")
        worst = max(worst, *err.values())
    return worst


def ball_states(n: int, seed: int):
    """Balls over the SDF box: resting on its top (0-1 mm in), pressed in
    1 mm, or 10 cm above it, x and y within the top face, gentle spin."""
    m = ball_holder().model
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(m.qpos0, np.float32), (n, 1))
    q[:, 0:2] = rng.uniform(-0.15, 0.15, (n, 2))
    q[:, 2] = np.where(np.arange(n) % 4 == 3, 0.55, 0.449 + rng.uniform(0.0, 1e-3, n))
    qd = np.zeros((n, m.nv), np.float32)
    qd[:, 3:] = rng.uniform(-0.2, 0.2, (n, 3))
    cuda = lambda a: torch.tensor(a, device="cuda")
    return cuda(q), cuda(qd)


def compare_ball() -> float:
    """The ball-on-box instantiation (one plane row, one SDF row, no cap)
    against its plain version at N=RAGGED_ENVS for 3 steps, the planes
    sampled at each step's entry pose; the box takes force in the envs whose
    ball rests on it. Returns the largest error."""
    from isaacgymenvs_tpu_torch.engine import fused

    h = ball_holder()
    m, p, n = h.model, h.sim_params, RAGGED_ENVS
    s = fused._extract(m)
    plain = fused._step_math_torch(s, p, torch.device("cuda"))
    q, qd = ball_states(n, seed=42)
    zero = torch.zeros(n, m.nv, device="cuda")
    worst, pressed = 0.0, None
    for _ in range(3):
        sdf = sdf_planes(m, q, qd)
        ko = fused.physics_step_fused(m, p, q, qd, zero, sdf=sdf)
        po = plain(rows(q), rows(qd), rows(zero), None, None, None, None, 0, sdf)
        err = compare_outputs(f"ball on SDF box N={n}", ko, po, s.nbody, n)
        worst = max(worst, *err.values())
        if pressed is None:
            pressed = float((ko.body_force[:, 1, 2].abs() > 1.0).float().mean())
        q, qd = po[0].T.contiguous(), po[1].T.contiguous()
    print(f"ball on SDF box kernel vs plain, N={n}, 3 steps: max error {worst:.3e}, box force in "
          f"{100 * pressed:.1f} % of envs")
    if not pressed > 0.5:
        raise AssertionError(f"the SDF row acted in {pressed:.3f} of the ball envs")
    return worst


def settle_ball(steps: int = 150) -> int:
    """BALL_ENVS balls dropped from 0.5 m at x, y within the box top, through
    `physics_step_fused` with the planes sampled at each step's entry pose:
    each rests at BALL_REST (tests/test_sdf.py test_ball_rests_on_sdf_box)
    with |qd_z| < 0.05. Returns the launches."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    h = ball_holder()
    m, p, n = h.model, h.sim_params, BALL_ENVS
    q = torch.tensor(np.asarray(m.qpos0, np.float32), device="cuda").repeat(n, 1)
    q[:, 0:2] = torch.tensor(np.random.RandomState(43).uniform(-0.15, 0.15, (n, 2)).astype(np.float32), device="cuda")
    qd = torch.zeros(n, m.nv, device="cuda")
    zero = torch.zeros_like(qd)
    torch.cuda.synchronize()
    _cuda.FusedStepCall.launches = 0
    for _ in range(steps):
        out = fused.physics_step_fused(m, p, q, qd, zero, sdf=sdf_planes(m, q, qd))
        q, qd = out.q, out.qd
    torch.cuda.synchronize()
    launches = _cuda.FusedStepCall.launches
    z, vz = q[:, 2], qd[:, 2]
    print(f"ball on SDF box: {steps} steps x {n} balls, {launches} launches, rest height "
          f"{float(z.min()):.5f}-{float(z.max()):.5f} m (bar {BALL_REST[0]} +- {BALL_REST[1]}), "
          f"max |qd_z| {float(vz.abs().max()):.5f}")
    if launches != steps or not bool(torch.isfinite(q).all()) or not float((z - BALL_REST[0]).abs().max()) < BALL_REST[1] \
            or not float(vz.abs().max()) < 0.05:
        raise AssertionError("the ball did not come to rest on the SDF box")
    return launches


def train_insertion(epochs: int = INSERTION_EPOCHS) -> int:
    """`train.main task=FactoryTaskInsertion` at the yaml's 128 envs for
    `epochs` epochs, a bit-equal restore into a fresh agent, and play (32
    episodes, cut to 64 steps: the yaml's 1024 take some 40 s at 30-40 ms per
    host-bound env step). Returns the training run's launches."""
    from isaacgymenvs_tpu_torch import train
    from isaacgymenvs_tpu_torch.engine import _cuda

    with tempfile.TemporaryDirectory() as runs:
        args = ["task=FactoryTaskInsertion", f"max_iterations={epochs}", f"+train_dir={runs}"]
        torch.cuda.synchronize()
        _cuda.FusedStepCall.launches = 0
        t0 = time.perf_counter()
        ts, metrics = train.main(args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _cuda.FusedStepCall.launches
        steps = epochs * INSERTION_WIDTH[1]
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v) and k != "mean_episode_return"}
        if launches != steps or metrics["frames"] != steps * INSERTION_ENVS or bad:
            raise AssertionError(f"{launches} launches, {metrics['frames']} frames for {steps} env steps; {bad}")
        print(f"FactoryTaskInsertion train: {epochs} epochs x {INSERTION_ENVS} envs in {sec:.2f} s "
              f"({metrics['frames'] / sec:.1f} env-steps/s with set-up), {launches} launches")
        ckpt = os.path.join(runs, "FactoryTaskInsertion", "nn", "last_FactoryTaskInsertion.pth")
        epoch = restored_bit_equal("FactoryTaskInsertion", args, ckpt, ts, epochs).pop()
        t0 = time.perf_counter()
        played = train.main(["task=FactoryTaskInsertion", "test=True", f"checkpoint={ckpt}",
                             "task.env.episodeLength=64"])
        print(f"FactoryTaskInsertion restore: bit-equal (epoch {epoch}); play: mean return {played:.2f} in "
              f"{time.perf_counter() - t0:.2f} s")
        if played != 0.0:
            raise AssertionError(f"the template's return is zero, play gave {played}")
    return launches


def time_insertion(card: str) -> dict:
    """`kernel_times` of Insertion's instantiation at the yaml's 128 envs and
    at 4096, in comparison states; the 4096 figures under `<key>_4096`."""
    out = {}
    for n in (INSERTION_ENVS, INSERTION_WIDE):
        env = insertion_env(n)
        (q, qd, qfrc, xfrc, qt, sdf), _, _, _ = insertion_inputs(env, n, seed=44)
        t = kernel_times(env, rows(q), rows(qd), rows(qfrc), xfrc_rows(xfrc), card, reps=30, qt=rows(qt), sdf=sdf)
        out.update(t if n == INSERTION_ENVS else {f"{k}_{n}": v for k, v in t.items() if k != "bound_by"})
    return out


def time_ball(card: str) -> dict:
    """`kernel_times` of the ball-on-box instantiation at 4096 envs, balls on the box."""
    h = ball_holder()
    q, qd = ball_states(NUM_ENVS, seed=45)
    zero = torch.zeros_like(qd)
    return kernel_times(h, rows(q), rows(qd), rows(zero), None, card, reps=30, sdf=sdf_planes(h.model, q, qd))


def build_all():
    """Step 2: every instantiation's size tuple on this card, built with one
    nvcc each, started together; prints ptxas's figures, the shared memory
    per block and the residency the device grants each build. Returns (the
    Ant env at the main path's width, its spec, key -> (env, per-env leaf
    names), key -> size tuple)."""
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    env = ant_env(NUM_ENVS)
    cart = cartpole_env(CARTPOLE_ENVS)
    s, s0 = fused._extract(env.model), fused._extract(cart.model)
    if s0.nct != 0 or s.nc == 0:
        raise AssertionError("Cartpole should be contact-free and the Ant not")
    built = {"Ant": (env, ()), "Cartpole": (cart, ()),
             **{k: case(k, 8) for k in CASES}}
    for k in ANYMAL_CASES:  # the per-env leaves of their own DR, the cap and terrain of their yaml
        e = anymal_env(k, 8)
        se = fused._extract(e.model)
        built[k] = (e, fused.dyn_names(se, e.randomizer.batched_leaf_names()) if e.randomizer is not None else ())
    built["Ball"] = (ball_holder(), ())  # the SDF rows (K6) without a cap
    built["Insertion"] = (insertion_env(8), ())  # SDF rows under the cap of 32, envs per block from its shared memory

    def params_of(t, e):
        return physics_args(e)[0] if t in ANYMAL_CASES else e.sim_params

    # the size tuples the steps will take on this card (envs per block from its shared memory)
    sizes = {t: _cuda.instantiation(fused._extract(e.model), params_of(t, e), torch.device("cuda", 0),
                                    e.use_pd_targets, names, getattr(e, "terrain", None) is not None)[0]
             for t, (e, names) in built.items()}
    if sizes["Quadcopter"][3] <= 32 or sizes["BallBalance"][4:7] != (1, 3, 1) or sizes["Example"][4] != 3 \
            or sizes["Ant+yaml"][7:] != (0, 115, 0, 0, 0, 0, 0, 4) \
            or sizes["Tendon+all"][7:] != (1, 65535, 10, 3, 0, 0, 0, 8) \
            or sizes["Anymal"] != (13, 19, 18, 44, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 4) \
            or sizes["AnymalTerrain"] != (13, 19, 18, 44, 0, 0, 1, 0, 128, 44, 0, 20, 1, 0, 4) \
            or sizes["AnymalTerrain-plane"] != (13, 19, 18, 44, 0, 0, 1, 0, 128, 44, 0, 20, 0, 0, 4) \
            or sizes["Ball"] != (2, 7, 6, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 8) \
            or sizes["Insertion"] != (14, 16, 15, 64, 0, 0, 1, 0, 0, 0, 0, 32, 0, 64, 8) \
            or len(set(sizes.values())) != len(sizes):
        raise AssertionError(f"unexpected size tuples {sizes}")

    def timed_build(size):
        t0 = time.perf_counter()
        _cuda.build(size, verbose=True)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sizes)) as pool:
        secs = list(pool.map(timed_build, sizes.values()))
    print(f"build: {time.perf_counter() - t0:.1f} s in all; " + ", ".join(
        f"{t} {'_'.join(map(str, sz))} {sec:.1f} s" for (t, sz), sec in zip(sizes.items(), secs)))
    for t, (e, names) in built.items():
        has_t = getattr(e, "terrain", None) is not None
        _, step = fused._prepared(e.model, params_of(t, e), torch.device("cuda"), e.use_pd_targets, names, has_t)
        if step.sizes != sizes[t]:
            raise AssertionError(f"{t}: the step took {step.sizes}, not the built {sizes[t]}")
        occ = step.occupancy()
        figs = _cuda.ptxas_figures(_cuda.PTXAS_LOG.get(sizes[t], ""))
        print(f"shared memory per block, {t}: {step.smem_bytes} bytes ({step.epb} envs; the limit of one block "
              f"is {step.smem_limit}), {step.dyn_rows} per-env rows; ptxas {figs['registers']} registers, "
              f"{figs['spill_stores']} bytes spill stores, {figs['spill_loads']} bytes spill loads; the device "
              f"keeps {occ['blocks_per_sm']} blocks ({occ['blocks_per_sm'] * step.epb} warps) resident per SM at "
              f"{occ['registers']} registers per thread, {occ['local_bytes']} local bytes (host plan: "
              f"{_cuda.resident_blocks(step.smem_bytes, step.epb, _cuda.plan_regs(step.s.nv))} blocks at "
              f"{_cuda.plan_regs(step.s.nv)} registers)")
        if occ["blocks_per_sm"] < 1 or occ["smem_bytes"] != step.smem_bytes:
            raise AssertionError(f"{t}: occupancy {occ} for a block of {step.smem_bytes} bytes")
    return env, s, built, sizes


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

    # 2. build every instantiation, one nvcc each, started together
    env, s, built, sizes = build_all()

    # 3. kernel vs plain version
    if any(RAGGED_ENVS % e == 0 for e in _cuda.ENVS_PER_BLOCK_CHOICES if e > 1):
        raise AssertionError(f"N={RAGGED_ENVS} fills every block of some envs-per-block choice")
    err_ragged = compare(ant_env(RAGGED_ENVS), steps=3, seed=1)
    print(f"kernel vs plain, N={RAGGED_ENVS}, 3 steps:", json.dumps(err_ragged))
    err_main = compare(env, steps=1, seed=2)
    print(f"kernel vs plain, N={NUM_ENVS}, 1 step:", json.dumps(err_main))
    max_err = max(max(err_ragged.values()), max(err_main.values()))
    max_err0 = 0.0
    for n, steps in ((RAGGED_ENVS, 3), (NUM_ENVS, 1), (CARTPOLE_ENVS, 1)):
        e = compare(cartpole_env(n), steps=steps, seed=1, qfrc_max=100.0, with_xfrc=False)
        print(f"contact-free kernel vs plain, N={n}, {steps} step(s):", json.dumps(e))
        max_err0 = max(max_err0, *e.values())

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
    ops_plain = profile_env_step(env)
    q, qd = rows(ts.env_state.sim.q), rows(ts.env_state.sim.qd)
    qfrc = rows(env.qfrc_from_actuators(torch.clamp(traj.action[-1], -1, 1)))
    xfrc = torch.zeros(6 * s.nbody, NUM_ENVS, device="cuda")
    ant_t = kernel_times(env, q, qd, qfrc, xfrc, name)

    # 6. the training path on Ant, 7. on Cartpole
    train_launches = train_epochs()
    cart_launches = train_cartpole()

    # 8. the contact-free kernel at its training path's width and at 4096 envs
    cart_t = {}
    for n in (CARTPOLE_ENVS, NUM_ENVS):
        cenv = cartpole_env(n)
        state, _ = cenv.reset(6)
        gen = torch.Generator(device="cuda").manual_seed(7)
        act = torch.rand(n, 1, generator=gen, device="cuda") * 2 - 1
        cart_t[n] = kernel_times(cenv, rows(state.sim.q), rows(state.sim.qd),
                                 rows(cenv.compute_force(act, None, None, ())[0]), None, name)

    # 9. the new instantiations against their plain versions
    new_err = {t: compare_case(t) for t in NEW_CASES}

    # 10. physical checks: BallBalance's anchors and tray force, the example model's spheres
    settle_ball_balance(NEW_TASKS["BallBalance"][0])
    new_launches = {"Example": settle_example(NUM_ENVS)}

    # 11. three timed full-width epochs per new task, 12. BallBalance through train.main
    conf = {"Ingenuity": (16384, 8), "Quadcopter": (16384, 8), "BallBalance": (8192, 8)}
    for t, (envs, horizon) in NEW_TASKS.items():
        new_launches[t] = train_epochs(t, (envs, horizon, envs * horizon, *conf[t]), profile=t == "BallBalance")
        bench = measure(envs, horizon, reps=4, device="cuda", task=t)
        print(f"{t} env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s")
    new_launches["BallBalance"] += train_ball_balance()

    # 13. kernel times of the new instantiations at full width
    new_t = {t: time_case(t, name) for t in NEW_CASES}

    # 14. per-env leaves and tendons: against the plain version and the step without leaves, then timed
    dyn_err = {k: compare_case(k) for k in DYN_CASES}
    dyn_t = {k: time_case(k, name) for k in DYN_CASES}

    # 15. physical checks, and the instantiations no task drives yet through physics_step_fused
    dyn_launches = {"Ant+all": free_fall_under_per_env_gravity(NUM_ENVS)}
    settle_ant_with_randomized_mass(NUM_ENVS)
    for k in ("Tendon", "Tendon+all", "BallBalance+pair"):
        dyn_launches[k] = drive_case(k)

    # 16. the DR main path: Ant with task.randomize=True at full width
    ops_dr = profile_env_step(task_env("Ant", NUM_ENVS, randomize=True), label="env.step task.randomize=True")
    print(f"device ops per Ant env step: {ops_plain:.1f} without domain randomization, {ops_dr:.1f} with")
    bench = measure(NUM_ENVS, HORIZON, reps=8, device="cuda", randomize=True)
    print(f"Ant task.randomize=True env.step under random actions: {bench['env_steps_per_s']:.1f} env-steps/s")
    dyn_launches["Ant+yaml"] = train_epochs("Ant", overrides=("task.randomize=True",)) + train_ant_randomized()
    dyn_launches.update({f"{t}+dr": n for t, n in step_randomized_tasks().items()})

    # 17. Anymal and AnymalTerrain: the three instantiations against their plain versions
    anymal_err = {k: compare_anymal(k) for k in ANYMAL_CASES}
    # 18. one merged window against four separate launches
    merged_vs_separate()
    # 19. physical checks: standing on flat ground, every terrain type, the curriculum
    settle_anymal()
    terrain_types_and_curriculum()
    # 20. the training path at full width: 1 + 3 epochs each, AnymalTerrain through train.main, the plane variant
    anymal_launches = {
        "Anymal": train_epochs("Anymal", (ANYMAL_ENVS, 24, 98304, 32768, 5), profile=False),
        "AnymalTerrain": train_epochs("AnymalTerrain", (ANYMAL_ENVS, 24, 98304, 16384, 5)),
    }
    ops_terrain = profile_env_step(anymal_env("AnymalTerrain", ANYMAL_ENVS), label="AnymalTerrain env.step")
    print(f"device ops per AnymalTerrain env step: {ops_terrain:.1f}")
    anymal_launches["AnymalTerrain"] += train_anymal_terrain()
    anymal_launches["AnymalTerrain-plane"] = drive_plane()
    # 21. kernel times at full width
    anymal_t = {k: time_anymal(k, name) for k in ANYMAL_CASES}

    # 22. FactoryTaskInsertion and the ball on an SDF box against their plain versions
    sdf_err = {"Insertion": compare_insertion(), "Ball": compare_ball()}
    # 23. the ball rests on the SDF box
    sdf_launches = {"Ball": settle_ball()}
    # 24. the training path at the yaml's width: 1 + 3 epochs, device ops per env step, train.main
    sdf_launches["Insertion"] = train_epochs("FactoryTaskInsertion", INSERTION_WIDTH, profile=False)
    ops_ins = profile_env_step(insertion_env(INSERTION_ENVS), label="FactoryTaskInsertion env.step")
    print(f"device ops per FactoryTaskInsertion env step: {ops_ins:.1f}")
    sdf_launches["Insertion"] += train_insertion()
    # 25. kernel times
    sdf_t = {"Insertion": time_insertion(name), "Ball": time_ball(name)}

    if any(n <= 0 for n in (train_launches, cart_launches, *new_launches.values(), *dyn_launches.values(),
                            *anymal_launches.values(), *sdf_launches.values())) \
            or set(dyn_launches) != set(DYN_CASES) or set(anymal_launches) != set(ANYMAL_CASES):
        raise AssertionError("a kernel of the main path was never launched")
    source = "isaacgymenvs_tpu_torch/engine/csrc/fused_step.cu"
    replaces = "isaacgymenvs_tpu/engine/fused.py:1834"
    names = {"Ingenuity": "fused_step_ingenuity", "Quadcopter": "fused_step_quadcopter_qt",
             "BallBalance": "fused_step_ballbalance_k4_qt", "Example": "fused_step_example_k4"}
    anymal_names = {"Anymal": "fused_step_anymal_qt", "AnymalTerrain": "fused_step_anymal_terrain_k5_k6_qt_dyn",
                    "AnymalTerrain-plane": "fused_step_anymal_plane_k5_qt_dyn"}
    sdf_names = {"Insertion": "fused_step_insertion_k5_k6sdf_qt", "Ball": "fused_step_ball_k6sdf"}
    print(json.dumps({"kernels": [
        {"name": "fused_step", "route": "cuda", "source": source, "replaces": replaces,
         "launches": train_launches, "launches_rollout": launches, "max_abs_err": max_err,
         **ant_t, "library_ms": None, "num_envs": NUM_ENVS},
        {"name": "fused_step_nc0", "route": "cuda", "source": source, "replaces": replaces,
         "launches": cart_launches, "max_abs_err": max_err0,
         **cart_t[CARTPOLE_ENVS], "library_ms": None, "num_envs": CARTPOLE_ENVS,
         **{f"{k}_{NUM_ENVS}": v for k, v in cart_t[NUM_ENVS].items() if k != "bound_by"}},
        *({"name": names[t], "route": "cuda", "source": source, "replaces": replaces,
           "launches": new_launches[t], "max_abs_err": new_err[t], **new_t[t], "library_ms": None,
           "num_envs": NEW_CASES[t][2], "sizes": list(sizes[t])} for t in NEW_CASES),
        *({"name": "fused_step_" + k.lower().replace("+", "_"), "route": "cuda", "source": source,
           "replaces": replaces, "launches": dyn_launches[k], "max_abs_err": dyn_err[k], **dyn_t[k],
           "library_ms": None, "num_envs": DYN_CASES[k][2], "sizes": list(sizes[k]),
           "per_env_leaves": list(built[k][1])} for k in DYN_CASES),
        *({"name": anymal_names[k], "route": "cuda", "source": source, "replaces": replaces,
           "launches": anymal_launches[k], "max_abs_err": anymal_err[k], **anymal_t[k], "library_ms": None,
           "num_envs": ANYMAL_ENVS, "sizes": list(sizes[k]), "per_env_leaves": list(built[k][1])}
          for k in ANYMAL_CASES),
        *({"name": sdf_names[k], "route": "cuda", "source": source, "replaces": replaces,
           "launches": sdf_launches[k], "max_abs_err": sdf_err[k], **sdf_t[k], "library_ms": None,
           "num_envs": INSERTION_ENVS if k == "Insertion" else NUM_ENVS, "sizes": list(sizes[k])}
          for k in sdf_names),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
