"""The port's Anymal and AnymalTerrain against the JAX package.

The robot is the hand-written ANYmal C stand-in
(isaacgymenvs_tpu_torch/assets/urdf/anymal_c/urdf/anymal.urdf), loaded
with its fixed joints collapsed; the JAX package reads it through
$ISAACGYMENVS_TPU_ASSETS. Env steps are held against the JAX envs run op by
op with their fused physics math, from the JAX state put on the port's
state (its domain-randomization sample too): obs and reward atol 2e-3 (as
the procedural tasks in tests/test_torch_env.py), q 2e-4, qd 2e-3. The
pushes and the respawn points are each package's own draws (declared), so
an env that resets is left out from then on. The terrain grid is cut to 3
levels x 4 types on both sides.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.engine.dynamics import SimState
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
import torch_conditioning as cond
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

N = 4
URDF = os.path.join(package_asset_root(), "urdf", "anymal_c", "urdf", "anymal.urdf")
GRID = ["task.env.terrain.numLevels=3", "task.env.terrain.numTerrains=4"]
# the xy by which the comparison moves the grid: the middle of the spawn area of the envs it compares
GRID_SHIFT = (12.0, 20.0)


def _jax_fields(m):
    return {f.name: (np.asarray(getattr(m, f.name)) if hasattr(getattr(m, f.name), "shape")
                     else getattr(m, f.name)) for f in dataclasses.fields(m)}


def _assert_models_equal(a, b):
    """Field by field, floats to 1e-6."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif isinstance(x, np.ndarray):
            y = np.asarray(y)
            assert x.shape == y.shape, f.name
            np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64), atol=1e-6, err_msg=f.name)
        else:
            assert (tuple(x) == tuple(y)) if isinstance(x, tuple) else x == y, f.name


def test_collapse_fixed_matches_jax():
    """The stand-in through both parsers with collapse_fixed: nbody, nq, nv,
    names, masses, com, inertia (the battery is mounted turned by 90 degrees,
    so its inertia is rotated on the way) and candidate points, to 1e-6."""
    from isaacgymenvs_tpu.model import load_urdf as jload_urdf
    from isaacgymenvs_tpu_torch.model import load_urdf

    jm = jload_urdf(URDF, collapse_fixed=True, default_density=0.001)
    tm = load_urdf(URDF, collapse_fixed=True, default_density=0.001)
    _assert_models_equal(tm, jm)
    assert (tm.nbody, tm.nq, tm.nv, tm.ncp) == (13, 19, 18, 44)
    # without the collapse the fixed links stay bodies of their own
    whole = load_urdf(URDF, default_density=0.001)
    assert whole.nbody == 18 and "LF_FOOT" in whole.body_names and "battery" in whole.body_names
    assert float(tm.body_mass[0]) == pytest.approx(float(whole.body_mass[0] + whole.body_mass[1]), rel=1e-6)
    assert tm.body_inertia[0, 0, 0] != whole.body_inertia[0, 0, 0]


def test_merge_body_parallel_axis():
    """Two unit point masses 1 m apart fold into 2 kg at their middle with
    0.5 kg m^2 about the axes across them."""
    from isaacgymenvs_tpu_torch.model.spec import FREE, ModelBuilder

    b = ModelBuilder()
    i = b.add_body(parent=-1, name="a", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FREE, mass=1.0,
                   ipos=(-0.5, 0, 0), inertia=np.zeros((3, 3)))
    b.merge_body(i, 1.0, (0.5, 0, 0), np.zeros((3, 3)))
    assert b.body_mass[i] == 2.0 and np.allclose(b.body_ipos[i], 0.0)
    np.testing.assert_allclose(b.body_inertia[i], np.diag([0.0, 0.5, 0.5]), atol=1e-7)


def test_stand_in_meets_what_the_tasks_need():
    """Body and joint names the tasks look up, the 44 ground candidates that
    `_prune_contact_points` keeps (8 base corners, 8 rim points per THIGH,
    the foot sphere per SHANK), and the pose: at the default joint angles and
    a base height of 0.62 m the feet touch the ground, knees and base clear."""
    from isaacgymenvs_tpu_torch import maths
    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    env = task_map["Anymal"](load_config(["task=Anymal", "num_envs=2"])["task"], device="cpu")
    m = env.model
    legs = ("LF", "LH", "RF", "RH")
    assert m.body_names == ("base",) + tuple(f"{l}_{p}" for l in legs for p in ("HIP", "THIGH", "SHANK"))
    assert [m.joint_names[m.dof_body[d]] for d in env.scalar_dof_indices] == [
        f"{l}_{j}" for l in legs for j in ("HAA", "HFE", "KFE")]
    per_body = np.bincount(np.asarray(m.cpoint_body), minlength=m.nbody)
    assert per_body[0] == 8 and m.ncp == 44
    assert all(per_body[i] == (8 if "THIGH" in n else 1 if "SHANK" in n else 0)
               for i, n in enumerate(m.body_names) if i)
    feet = [c for c in range(m.ncp) if "SHANK" in m.body_names[m.cpoint_body[c]]]
    assert all(m.cpoint_radius[c] > 0 for c in feet) and np.all(np.delete(m.cpoint_radius, feet) == 0)
    q = env.qpos0.repeat(1, 1)
    q[:, 2] = 0.62
    q[:, env.dof_q_idx] = env.default_dof_pos
    kin = forward_kinematics(m, q, torch.zeros(1, m.nv))
    cb = torch.tensor(m.cpoint_body)
    x = kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], torch.tensor(m.cpoint_pos))
    z = (x[0, :, 2] - torch.tensor(m.cpoint_radius)).numpy()
    assert np.abs(z[feet]).max() < 1e-4
    assert np.delete(z, feet).min() > 0.3


def test_heading_maths_match_jax():
    from isaacgymenvs_tpu import maths as jmaths
    from isaacgymenvs_tpu_torch import maths

    rng = np.random.RandomState(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(maths.calc_heading(torch.tensor(q)).numpy(),
                               np.asarray(jmaths.calc_heading(jnp.asarray(q))), atol=1e-5)
    np.testing.assert_allclose(maths.calc_heading_quat(torch.tensor(q)).numpy(),
                               np.asarray(jmaths.calc_heading_quat(jnp.asarray(q))), atol=1e-5)
    ang, axis = rng.uniform(-3, 3, 64).astype(np.float32), rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(maths.quat_from_angle_axis(torch.tensor(ang), torch.tensor(axis)).numpy(),
                               np.asarray(jmaths.quat_from_angle_axis(jnp.asarray(ang), jnp.asarray(axis))), atol=1e-6)


# ---- env steps against the JAX envs --------------------------------------------


def _both(task, extra=()):
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    args = [f"task={task}", f"num_envs={N}", *extra]
    jcfg = jload(args)["task"]
    jcfg["sim"]["use_fused"] = True
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks[task](jcfg)
        tenv = ttasks[task](tload(args)["task"], device="cpu")
    return jenv, tenv


def _port_state(tenv, jstate):
    """The port's EnvState with the JAX state's contents and DR sample."""
    from isaacgymenvs_tpu_torch.convert import dr_sample_from_jax

    st, _ = tenv.reset(0)
    t = lambda a: torch.tensor(np.asarray(a))
    st.sim = SimState(q=t(jstate.sim.q), qd=t(jstate.sim.qd))
    st.progress = t(jstate.progress).to(torch.int32)
    st.reset_buf = t(jstate.reset_buf)
    st.actions = t(jstate.actions)
    if isinstance(jstate.task, dict):
        st.task = {k: t(v) for k, v in jstate.task.items()}
        st.task["level"], st.task["type"] = st.task["level"].long(), st.task["type"].long()
    else:
        st.task = t(jstate.task)
    if tenv.randomizer is not None:
        st.dr = dr_sample_from_jax({k: np.asarray(v) for k, v in jstate.dr.items()})
        st.dyn = tenv.pack_dyn(st.dr)
        st.randomize_buf = t(jstate.randomize_buf).to(torch.int32)
    if st.frames is not None:
        st.frames = t(jstate.frames).to(torch.int32)
    return st


def _with_port_state(jstate, tstate):
    """The JAX state holding the port's sim state (a settled start)."""
    sim = jstate.sim.replace(q=jnp.asarray(tstate.sim.q.numpy()), qd=jnp.asarray(tstate.sim.qd.numpy()))
    return jstate.replace(sim=sim)


def _move_grid(jenv, tenv, shift):
    """Both envs' terrain grid and env origins moved by -shift in xy."""
    from isaacgymenvs_tpu_torch.engine.dynamics import Terrain

    shift = np.asarray(shift, np.float32)
    jenv.terrain = jenv.terrain.replace(origin=jnp.asarray(np.asarray(jenv.terrain.origin) - shift))
    jenv.terrain_origins = jenv.terrain_origins.at[..., :2].add(-jnp.asarray(shift))
    t = tenv.terrain
    tenv.terrain = Terrain(t.height, t.horizontal_scale, origin=t.origin - torch.tensor(shift))
    tenv.terrain_origins = tenv.terrain_origins.clone()
    tenv.terrain_origins[..., :2] -= torch.tensor(shift)


def _settle(tenv, tstate, steps):
    zero = torch.zeros(N, 12)
    for _ in range(steps):
        tstate, _, _, _, _ = tenv.step(tstate, zero)
    return tstate


def _physics_gaps(jenv, tenv, tstate, a):
    """The float64 gaps (`torch_conditioning`) of the physics call the step
    from `tstate` under actions `a` makes, in the port and in JAX: the
    merged window of AnymalTerrain with its terrain planes and friction leaf."""
    from isaacgymenvs_tpu.engine import fused as jfused
    from isaacgymenvs_tpu_torch.engine import fused as tfused

    q, qd = tstate.sim.q, tstate.sim.qd
    qfrc, xfrc, qt = tenv.compute_force(torch.clamp(torch.tensor(a), -tenv.clip_actions, tenv.clip_actions), q, qd,
                                        tstate.task)
    s, dyn = tfused.spec_of(tenv.model), tstate.dyn
    port = cond.port_gaps(s, tenv._merged_params, q, qd, qfrc, xfrc, qt, names=dyn.names, dyn=dyn.rows,
                          terr=tenv._terrain_planes(q, qd), wre=tenv._warm_reset_every)
    jp = jenv.sim_params
    jdyn = {"cpoint_friction": tenv.randomizer.batched_model(tstate.dr)["cpoint_friction"].numpy(),
            **jfused.terrain_dyn(jenv.model, jenv.terrain, jnp.asarray(q.numpy()), jnp.asarray(qd.numpy()))}
    merged = jp.replace(dt=jp.dt * jenv.control_freq_inv, substeps=jp.substeps * jenv.control_freq_inv)
    return port, cond.jax_gaps(jenv.model, merged, q, qd, qfrc, xfrc, qt, dyn=jdyn,
                               wre=jp.substeps * jp.solver_iterations)


def _check_steps(jenv, tenv, jstate, tstate, steps, seed, flagged=None, conditioned=False):
    """`steps` steps of both under the same actions; the env flagged done
    resets on the first step and is left out from there. With
    `conditioned`, an env whose physics call in some step is ill-conditioned
    for both packages (`torch_conditioning.kept`) is left out from that
    step on. Returns the two states, the extras and the envs compared."""
    rng = np.random.RandomState(seed)
    keep = [e for e in range(N) if e != flagged]
    for k in range(steps):
        a = rng.uniform(-0.5, 0.5, (N, 12)).astype(np.float32)
        if conditioned:
            kept = cond.kept(*_physics_gaps(jenv, tenv, tstate, a))
            keep = [e for e in keep if kept[e]]
        jstate, jobs, jrew, jdone, jex = jenv.step(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        assert tobs.shape == (N, tenv.num_obs)
        np.testing.assert_allclose(tobs.numpy()[keep], np.asarray(jobs)[keep], atol=2e-3)
        np.testing.assert_allclose(trew.numpy()[keep], np.asarray(jrew)[keep], atol=2e-3)
        np.testing.assert_allclose(tstate.sim.q.numpy()[keep], np.asarray(jstate.sim.q)[keep], atol=2e-4)
        np.testing.assert_allclose(tstate.sim.qd.numpy()[keep], np.asarray(jstate.sim.qd)[keep], atol=2e-3)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tex["time_outs"].numpy(), np.asarray(jex["time_outs"]))
        np.testing.assert_array_equal(tstate.progress.numpy(), np.asarray(jstate.progress))
    return jstate, tstate, tex, jex, keep


def test_anymal_step_matches_jax():
    """Anymal on flat ground (44 plane rows, q_target drives, 2 slices per
    step): 2 steps from a settled start, env 2 flagged done so it resets."""
    jenv, tenv = _both("Anymal")
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    tstate = _settle(tenv, _port_state(tenv, jstate), 5)
    jstate = _with_port_state(jstate, tstate).replace(reset_buf=jnp.asarray([False, False, True, False]))
    tstate = _port_state(tenv, jstate)
    _, tstate, _, _, _ = _check_steps(jenv, tenv, jstate, tstate, 2, seed=1, flagged=2)
    assert int(tstate.progress[2]) == 1 and float(tstate.sim.q[2, 2]) > 0.3


def _terrain_steps(shift):
    """AnymalTerrain's 2 conditioned steps of `test_anymal_terrain_step_matches_jax`,
    the grid moved by `shift` (None: the layout it trains in). Returns the
    port's env and state, both extras, the envs compared and the start's
    levels."""
    jenv, tenv = _both("AnymalTerrain", [*GRID, "task.env.learn.addNoise=False"])
    assert jenv.fused_merge_slices and tenv.merge_slices and tenv._warm_reset_every == 1
    assert jenv.randomizer.batched_leaf_names() == tenv.randomizer.batched_leaf_names() == {"cpoint_friction"}
    if shift is not None:
        _move_grid(jenv, tenv, shift)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    tstate = _settle(tenv, _port_state(tenv, jstate), 5)
    jstate = _with_port_state(jstate, tstate).replace(
        reset_buf=jnp.asarray([False, True, False, False]), frames=jnp.asarray(5, jnp.int32))
    tstate = _port_state(tenv, jstate)
    level = tstate.task["level"].clone()
    _, tstate, tex, jex, keep = _check_steps(jenv, tenv, jstate, tstate, 2, seed=2, flagged=1, conditioned=True)
    return tenv, tstate, tex, jex, keep, level


def test_anymal_terrain_step_matches_jax():
    """AnymalTerrain on the grid with the merged window (one call of 4
    slices per step, warm start reset between them), the top-K cap of 20,
    terrain rows and the setup-only friction leaf: 2 steps from a settled
    start (the JAX state's DR sample and task on the port's state; its
    observation noise off, the streams differ), env 1 flagged done so it
    respawns on its level. Per-term episode sums to 2e-3, terrain levels equal.
    The grid is moved by GRID_SHIFT in both envs, so that the robots stand
    within a few metres of the world origin: 12-36 m out, float32 does not
    determine a standing robot's step to the tolerance (the spatial algebra
    is referenced to the origin), in either package. An env whose physics
    call is still ill-conditioned for both (`torch_conditioning.kept`) is
    left out of the comparison from that step on; two envs stay compared."""
    tenv, tstate, tex, jex, keep, level = _terrain_steps(GRID_SHIFT)
    assert len(keep) >= 2, keep
    np.testing.assert_allclose(tex["episode_sums"].numpy()[keep], np.asarray(jex["episode_sums"])[keep], atol=2e-3)
    np.testing.assert_array_equal(tex["terrain_level"].numpy(), np.asarray(jex["terrain_level"]))
    assert torch.equal(tstate.task["level"], level) and tex["episode_sums"].shape == (N, 13)
    # the env that reset stands on its level's cell, above the local ground
    origin = tenv.terrain_origins[level[1], tstate.task["type"][1]]
    assert float((tstate.sim.q[1, :2] - origin[:2]).abs().max()) <= 0.5 + 0.1
    assert float(tstate.sim.q[1, 2] - tenv.terrain.sample(tstate.sim.q[1:2, :2])[0]) > 0.4


def test_anymal_terrain_float64_step_matches_jax_at_deployed_layout():
    """The steps of `test_anymal_terrain_step_matches_jax` at the layout
    AnymalTerrain trains in, the grid unmoved (the robots 12-36 m from the
    world origin): each step's physics call in float64 against JAX's on
    every env (`torch_conditioning.kept`, F64_TOL), the float32 steps and
    episode sums on the envs it keeps, terrain levels equal."""
    tenv, tstate, tex, jex, keep, level = _terrain_steps(None)
    np.testing.assert_allclose(tex["episode_sums"].numpy()[keep], np.asarray(jex["episode_sums"])[keep], atol=2e-3)
    np.testing.assert_array_equal(tex["terrain_level"].numpy(), np.asarray(jex["terrain_level"]))
    assert torch.equal(tstate.task["level"], level)


# ---- the task's own behaviour --------------------------------------------------


def _terrain_env(n, **learn):
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    args = ["task=AnymalTerrain", f"num_envs={n}", *GRID] + [f"task.env.learn.{k}={v}" for k, v in learn.items()]
    return task_map["AnymalTerrain"](load_config(args)["task"], device="cpu")


def test_level_promotion_and_demotion_across_episodes():
    """The port's version of tests/test_anymal_terrain.py's curriculum test:
    robots moved a full terrain cell from their spawn move up a level at the
    end of the episode; robots that stand still move down (where the level
    and the command allow), and the new level carries through the respawn."""
    env = _terrain_env(8)
    env.max_episode_length = 6
    state, _ = env.reset(0)
    lvl0 = state.task["level"].clone()
    far = state.task["origin"][:, :2] + torch.tensor([env.grid.env_length, 0.0])
    state.sim.q[:, :2] = far
    first, zero = torch.full((8,), -1), torch.zeros(8, 12)
    for _ in range(env.max_episode_length + 1):
        state, _, _, done, ex = env.step(state, zero)
        first = torch.where(done & (first < 0), state.task["level"], first)
    assert bool((first >= 0).all())
    assert torch.equal(first, torch.clamp(lvl0 + 1, 0, env.num_levels - 1))
    assert "terrain_level" in ex and ex["terrain_level"].dtype == torch.float32
    state2, _ = env.reset(1)
    state2.task["level"] = torch.tensor([1, 2, 1, 2, 0, 1, 2, 1])  # the grid's 3 levels; a new run starts at 0
    lvl0 = state2.task["level"].clone()
    first = torch.full((8,), -1)
    for _ in range(env.max_episode_length + 1):
        state2, _, _, done, _ = env.step(state2, zero)
        first = torch.where(done & (first < 0), state2.task["level"], first)
    assert bool((first >= 0).all()) and bool((first <= lvl0).all()) and bool((first < lvl0).any())
    # the respawn keeps the level the episode ended with
    assert bool((state2.task["level"][first >= 0] == first[first >= 0]).all())


def test_push_robots_overwrites_base_velocity():
    """The port's version of tests/test_anymal_terrain.py's push test: with a
    push every 3rd env step the base's xy velocity is a fresh U[-1, 1] draw
    at those steps and only then."""
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    args = ["task=AnymalTerrain", "num_envs=4", *GRID, f"task.env.learn.pushInterval_s={3 * 0.005 * 4}"]
    env = task_map["AnymalTerrain"](load_config(args)["task"], device="cpu")
    assert env.push_interval == 3
    state, _ = env.reset(0)
    pushed = []
    for _ in range(7):
        frames = int(state.frames)
        q, qd = env.perturb_state(state.rng, state.sim.q, state.sim.qd, state.frames, state.task)
        moved = not torch.equal(qd[:, :2], state.sim.qd[:, :2])
        assert moved == (frames > 0 and frames % 3 == 0)
        if moved:
            assert float(qd[:, :2].abs().max()) <= 1.0 and torch.equal(qd[:, 2:], state.sim.qd[:, 2:])
            pushed.append(frames)
        state, _, _, _, _ = env.step(state, torch.zeros(4, 12))
    assert pushed == [3, 6] and int(state.frames) == 7


def test_learn_block_becomes_randomization_specs():
    """Observation noise per key over the 188-dim layout, and the surface
    friction as a setup-only per-env factor in [0.5, 1.25]."""
    env = _terrain_env(4)
    spec = env.obs_spec()
    assert sum(size for _, size in spec.values()) == env.num_obs == 188
    rz = env.randomizer
    assert set(rz.obs_key_specs) == {"base_lin_vel", "base_ang_vel", "gravity", "dof_pos", "dof_vel", "heights"}
    assert rz.obs_key_specs["heights"].hi == pytest.approx(0.06 * 5.0)
    (fr,) = [s for s in rz.model_specs if s.leaf == "cpoint_friction"]
    assert fr.setup_only and (fr.lo, fr.hi) == (0.5, 1.25)
    quiet = _terrain_env(4, addNoise=False, randomizeFriction=False)
    assert quiet.randomizer is None


def test_train_entry_runs_on_the_cpu(tmp_path):
    """`python -m isaacgymenvs_tpu_torch.train task=... pipeline=cpu` with a
    few envs trains an epoch of each task and checkpoints it."""
    from isaacgymenvs_tpu_torch import train

    for task, extra in (("Anymal", []), ("AnymalTerrain", GRID)):
        ts, metrics = train.main([f"task={task}", "pipeline=cpu", "num_envs=4", "max_iterations=1",
                                  "train.params.config.minibatch_size=48", f"+train_dir={tmp_path}", *extra])
        assert metrics["frames"] == 4 * 24 and np.isfinite(metrics["a_loss"])
        assert os.path.exists(os.path.join(tmp_path, task, "nn", f"last_{task}.pth"))
        if task == "AnymalTerrain":
            assert "env/terrain_level" in metrics
