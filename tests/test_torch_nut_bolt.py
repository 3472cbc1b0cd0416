"""The port's Factory nut-bolt family (Pick, Place, Screw) against the JAX
package, on the CPU: the generated meshes, the three models with their two
SDF grids, `sdf_dyn`, the plain step, `compute_force` in both control
modes, and reset with three env steps.

The meshes are written by
isaacgymenvs_tpu_torch/assets/factory/make_nut_bolt_meshes.py and the Franka
is the Panda stand-in; the JAX package reads them through
$ISAACGYMENVS_TPU_ASSETS. Its env steps run op by op with its fused physics
math (`use_fused`), as in tests/test_torch_franka.py. Each task is built
once per module, at N = 4. Tolerances: models equal within 1e-6;
`sdf_dyn` within 1e-5; the plain step as tests/test_fused.py:79-82 (q 2e-4,
qd 2e-3, forces 2e-2); `compute_force` rtol 1e-4; env steps q 2e-4,
qd 2e-3, observations 1e-4 (their velocities 2e-3, as qd), rewards 1e-4,
done flags, the task state and the extras equal (`descent` within 2e-4,
as q).
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.convert import env_state_from_arrays
from isaacgymenvs_tpu_torch.engine import _cuda
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 4
TASKS = ["FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace", "FactoryTaskNutBoltScrew"]
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
MESHES = os.path.join(package_asset_root(), "factory")


@pytest.fixture(autouse=True)
def _jax_assets(monkeypatch):
    """The JAX side reads the port's bundled stand-ins."""
    monkeypatch.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())


def _assert_models_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        elif isinstance(x, np.ndarray):
            y = np.asarray(y)
            assert x.shape == y.shape, f.name
            np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64), atol=1e-6, err_msg=f.name)
        elif isinstance(x, tuple) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y), f.name
            for u, w in zip(x, y):
                np.testing.assert_allclose(u, np.asarray(w), atol=1e-6, err_msg=f.name)
        else:
            assert (tuple(x) == tuple(y)) if isinstance(x, tuple) else x == y, f.name


_ENVS = {}


def _both(task):
    """The JAX env and the port's env of `task` at N envs (built once per worker)."""
    if task not in _ENVS:
        from isaacgymenvs_tpu.tasks import task_map as jtasks
        from isaacgymenvs_tpu.utils.config import load_config as jload
        from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
        from isaacgymenvs_tpu_torch.utils.config import load_config as tload

        args = [f"task={task}", f"num_envs={N}"]
        jcfg = jload(args)["task"]
        jcfg["sim"]["use_fused"] = True
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
            _ENVS[task] = (jtasks[task](jcfg), ttasks[task](tload(args)["task"], device="cpu"))
    return _ENVS[task]


# ---- the generated meshes --------------------------------------------------------

def test_meshes_are_the_scripts_output_and_give_jaxs_points(tmp_path, monkeypatch):
    """The committed OBJ files are what make_nut_bolt_meshes.py writes; the
    nut's candidate points of both packages on them are equal: 12 rims (a
    hex corner 13.856 mm out in each 60-degree bin, at both faces) and 48
    thread points (6 x 8 bins filled, 7.0-8.1 mm from the axis, the lowest
    8 at 0.25 mm); both meshes are closed."""
    from isaacgymenvs_tpu.tasks import factory_nut_bolt as jnb
    from isaacgymenvs_tpu_torch.tasks import factory_nut_bolt as tnb

    spec = importlib.util.spec_from_file_location("make_nut_bolt_meshes",
                                                  os.path.join(MESHES, "make_nut_bolt_meshes.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    committed = {n: open(os.path.join(gen.OUT, n)).read() for n in sorted(os.listdir(gen.OUT))}
    monkeypatch.setattr(gen, "OUT", str(tmp_path))
    gen.main()
    assert {n: open(tmp_path / n).read() for n in sorted(os.listdir(tmp_path))} == committed
    assert sorted(committed) == ["factory_bolt_m16_tight.obj", "factory_nut_m16_tight_subdiv_3x.obj"]

    rims, thread = tnb.nut_contact_points()
    jr, jt = jnb.nut_contact_points()
    np.testing.assert_array_equal(rims, jr)
    np.testing.assert_array_equal(thread, jt)
    assert rims.shape == (12, 3) and thread.shape == (48, 3)
    np.testing.assert_allclose(np.linalg.norm(rims[:, :2], axis=1), tnb.NUT_WIDTH_MAX / 2, atol=1e-6)
    np.testing.assert_allclose(rims[:, 2], [0.0] * 6 + [tnb.NUT_HEIGHT] * 6, atol=1e-7)
    r = np.linalg.norm(thread[:, :2], axis=1)
    assert r.min() > 0.0070 and r.max() < 0.0082
    np.testing.assert_allclose(thread[:8, 2], 2.5e-4, atol=1e-7)
    for name in committed:  # every edge in exactly two faces, the two ways round
        v, t = tnb.load_obj(os.path.join(gen.OUT, name))
        edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        fwd = {tuple(e) for e in edges.tolist()}
        assert len(fwd) == len(edges) and all((b, a) in fwd for a, b in fwd), name


def test_bolt_grid_is_helical_and_the_nut_meshes_at_the_screw_reset():
    """The bolt's grid (192 along its longest axis) equals the JAX
    package's; its thread is one right-handed helix of 2 mm pitch:
    sdf(r, theta, z) = sdf(r, theta + 2 pi dz / p, z + dz) within one voxel
    on the threaded shank; the nut's grid equals JAX's; at the Screw task's
    reset pose (base at 40.5 mm, 30 degrees) and five turns further down,
    every thread point of the nut below the bolt's top lies in the bolt's
    groove (0 to 0.25 mm off its surface, none inside): the lowest 8 at the
    reset, 40 five turns down."""
    from isaacgymenvs_tpu.tasks import factory_nut_bolt as jnb
    from isaacgymenvs_tpu_torch.sdf.builder import sdf_query
    from isaacgymenvs_tpu_torch.tasks import factory_nut_bolt as tnb

    g = tnb.bolt_sdf_grid()
    for tg, jg in ((g, jnb.bolt_sdf_grid()), (tnb.nut_sdf_grid(), jnb.nut_sdf_grid())):
        np.testing.assert_array_equal(tg.values.numpy(), np.asarray(jg.values))
        np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
        assert tg.spacing == jg.spacing
    rng = np.random.RandomState(0)
    r, th = rng.uniform(0.006, 0.0095, 4000), rng.uniform(-np.pi, np.pi, 4000)
    z, dz = rng.uniform(0.020, 0.035, 4000), rng.uniform(-0.003, 0.003, 4000)
    th2 = th + 2 * np.pi * dz / tnb.THREAD_PITCH
    pts = lambda r, t, z: torch.tensor(np.stack([r * np.cos(t), r * np.sin(t), z], -1), dtype=torch.float32)
    dev = (sdf_query(g, pts(r, th, z)) - sdf_query(g, pts(r, th2, z + dz))).abs()
    assert float(dev.max()) < g.spacing
    # a left-handed shift breaks it
    bad = (sdf_query(g, pts(r, th, z)) - sdf_query(g, pts(r, th - (th2 - th), z + dz))).abs()
    assert float(bad.max()) > 2 * g.spacing

    _, thread = tnb.nut_contact_points()
    yaw = np.pi / 6
    c, s = np.cos(yaw), np.sin(yaw)
    for z0, inside in ((0.0405, 8), (0.0405 - 5 * tnb.THREAD_PITCH, 40)):  # the reset, five turns down
        world = thread @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]) + np.array([0.0, 0.0, z0])
        d = sdf_query(g, torch.tensor(world[world[:, 2] < tnb.BOLT_TOP - 2e-4], dtype=torch.float32))
        assert len(d) == inside and float(d.min()) > 0.0 and float(d.max()) < 2.5e-4


# ---- the models ------------------------------------------------------------------

PADS = {"FactoryTaskNutBoltPick": 42, "FactoryTaskNutBoltPlace": 20, "FactoryTaskNutBoltScrew": 6}


@pytest.mark.parametrize("task", TASKS)
def test_models_match_jax(task):
    """`compose` of the Franka, the nut and the bolt, every automatic point
    stripped, then 12 rims and 48 thread points on the nut and each task's
    pad points on both fingers, the nut's grid (96) for the pads and the
    bolt's (192) for the nut's points: every leaf of the two models equal,
    the grids included; 15 bodies, nq 18, nv 17; every point also a plane
    row; the cap of 16; the pad rows (nut grid) first among the SDF rows,
    then the nut's (bolt grid); the actor refs and index sets equal; the
    block fits 8 envs at most (Pick: 5,208 floats per env)."""
    jenv, tenv = _both(task)
    _assert_models_equal(tenv.model, jenv.model)
    m, p = tenv.model, tenv.sim_params
    s = tfused.spec_of(m)
    pads = 2 * PADS[task]
    assert (m.nbody, m.nq, m.nv, m.ncp, s.nc, s.sp_n) == (15, 18, 17, 60 + pads, 60 + pads, 60 + pads)
    assert tfused.topk_cap(s, p) == 16 and p.solver_apgd_iterations == 64 and tfused.unsupported_features(m, p) == []
    nut, bolt = tenv.nut_ref.body0, tenv.bolt_body
    assert m.sdf_body == (nut, bolt) and bolt == jenv.bolt_body
    assert s.sp_b.tolist() == [nut] * pads + [bolt] * 60
    assert set(s.sp_a[:pads].tolist()) == {m.body_names.index("panda_leftfinger"),
                                           m.body_names.index("panda_rightfinger")}
    assert set(s.sp_a[pads:].tolist()) == {nut}
    assert [tuple(r) for r in (tenv.franka_ref, tenv.nut_ref, tenv.bolt_ref)] == \
        [tuple(r) for r in (jenv.franka_ref, jenv.nut_ref, jenv.bolt_ref)]
    assert (tenv.nq, tenv.nvd, tenv.bolt_q) == (jenv.nq, jenv.nvd, jenv.bolt_q)
    np.testing.assert_array_equal(tenv.q_idx.numpy(), np.asarray(jenv.q_idx))
    np.testing.assert_array_equal(tenv.v_idx.numpy(), np.asarray(jenv.v_idx))
    np.testing.assert_allclose(tenv.keypoint_offsets.numpy(), np.asarray(jenv.keypoint_offsets), atol=1e-7)
    np.testing.assert_allclose(tenv.effort_limit.numpy(), np.asarray(jenv.effort_limit), atol=1e-6)
    smem = {e: _cuda.smem_bytes(s, p, e, has_qt=True) for e in (8, 4, 2, 1)}
    assert smem[8] <= _cuda.SMEM_OPTIN_BYTES
    assert _cuda.envs_per_block(lambda e: smem[e], _cuda.SMEM_OPTIN_BYTES, _cuda.plan_regs(s.nv)) == 8
    if task == "FactoryTaskNutBoltPick":
        assert _cuda.env_floats(s, True, (), 16) == 5208 and tenv.max_episode_length == jenv.max_episode_length == 150


# ---- the physics step ----------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_sdf_dyn_compute_force_and_plain_step_match_jax(task):
    """At the task's `contact_states` (the nut held between the pads, on the
    thread, screwed down onto the head, on the table): the two grids'
    lookups (depth 1e-7, normal 1e-5) at the same points; `sdf_dyn` of both
    (two grids, the nut's on the free body), each on its own forward
    kinematics, the points and depths within 1e-5, the frames within 1e-6
    in the median row and 3e-4 in all;
    `compute_force`
    under random actions (Pick, acting and in its scripted closing phase,
    and Place: damped least-squares IK and the joint PD through the 7 x 7
    mass matrix; Screw: the operational-space motion with the one-sided z
    rotation) within rtol 1e-4, the gravity
    compensation and the gripper setpoints; the plain step on the port's
    forces (Pick's closing phase: its pads squeeze the nut) and the JAX
    package's planes against JAX
    `physics_step_fused(use_pallas=False)` on the same inputs: q 2e-4, qd 2e-3, forces 2e-2. The rows act: more than 16
    candidates active in some env (the cap binds), and the grids' bodies
    (the nut, and the bolt on its slides) take contact force: the wrench on
    the grid's body of an SDF row."""
    from isaacgymenvs_tpu.engine import fused as jfused

    from isaacgymenvs_tpu.sdf import builder as jsdf
    from isaacgymenvs_tpu_torch.sdf import builder as tsdf
    from isaacgymenvs_tpu_torch.tasks import factory_nut_bolt as tnb

    jenv, tenv = _both(task)
    jm, tm = jenv.model, tenv.model
    # the lookups at the same points in the grids' frames: near the nut's
    # and the bolt's surfaces, depth and normal
    rng = np.random.RandomState(7)
    for g, (verts, _) in enumerate((tnb._nut_mesh(), tnb._bolt_mesh())):
        d = (verts[rng.choice(len(verts), 256)] + rng.uniform(-3e-4, 3e-4, (256, 3))).astype(np.float32)
        tg = tsdf.SdfGrid(torch.tensor(tm.sdf_values[g]), torch.tensor(tm.sdf_origin[g]), tm.sdf_spacing[g])
        jg = jsdf.SdfGrid(jnp.asarray(jm.sdf_values[g]), jnp.asarray(jm.sdf_origin[g]), jm.sdf_spacing[g])
        np.testing.assert_allclose(tsdf.sdf_query(tg, torch.tensor(d)).numpy(),
                                   np.asarray(jsdf.sdf_query(jg, jnp.asarray(d))), atol=1e-7)
        np.testing.assert_allclose(tsdf.sdf_gradient(tg, torch.tensor(d)).numpy(),
                                   np.asarray(jsdf.sdf_gradient(jg, jnp.asarray(d))), atol=1e-5)
    # sdf_dyn, each on its own forward kinematics: points and depths within
    # 1e-5; the frames agree exactly or to 1e-6 in most rows and within 3e-4
    # in all: where a voxel holds an edge of the mesh, float32 rounding of a
    # point 0.3-0.5 m from the origin (an ulp, 3-6e-8 m) turns the
    # central-difference normal by up to 1.5e-4 (the same turn as a one-ulp
    # change of q on one side)
    q, qd = tenv.contact_states(N, seed=5)
    jq, jqd = jnp.asarray(q.numpy()), jnp.asarray(qd.numpy())
    jdyn = jfused.sdf_dyn(jm, jq, jqd)
    tdyn = tfused.sdf_dyn(tm, q, qd)
    frame_err = []
    for k in tfused.SP_KEYS:
        err = np.abs(tdyn[k].numpy() - np.asarray(jdyn[k]))
        if k[:5] in ("_sp_p", "_sp_x"):
            assert err.max() < 1e-5, (k, err.max())
        else:
            frame_err.append(err)
    frame_err = np.max(frame_err, 0)
    assert np.median(frame_err) < 1e-6 and frame_err.max() < 3e-4, (np.median(frame_err), frame_err.max())

    a = np.random.RandomState(6).uniform(-1, 1, (N, 12)).astype(np.float32)
    # Pick while it acts (t = 0) and in its scripted closing phase (t = rl_len), the step on the latter
    for t in ([0, tenv.rl_len] if "Pick" in task else [None]):
        task_t = () if t is None else {"t": torch.full((N,), t, dtype=torch.int32)}
        jtask = () if t is None else {"t": jnp.full(N, t, jnp.int32)}
        qfrc, xfrc, qt = tenv.compute_force(torch.tensor(a), q, qd, task_t)
        jqfrc, jxfrc, jqt = jax.vmap(jenv.compute_force)(jnp.asarray(a), jq, jqd, jtask)
        scale = float(np.abs(np.asarray(jqfrc)).max())
        np.testing.assert_allclose(qfrc.numpy(), np.asarray(jqfrc), rtol=1e-4, atol=1e-4 * scale, err_msg="qfrc")
        assert scale > 0.05
        np.testing.assert_allclose(xfrc.numpy(), np.asarray(jxfrc), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(jqt))

    p = tenv.sim_params
    s = tfused.spec_of(tm)
    keys = []
    run = tfused._step_math_torch(s, p, "cpu", (), keys)
    rows = lambda t: t.T.contiguous()
    planes = {k: torch.tensor(np.asarray(v)) for k, v in jdyn.items()}  # both steps on the same planes
    run(rows(q), rows(qd), rows(qfrc), xfrc.permute(2, 1, 0).reshape(6 * s.nbody, N), rows(qt), None, None, 0,
        tfused.pack_sdf(planes))
    active = keys[0][0] > -p.contact_margin
    assert int((active.sum(0) > 16).sum()) >= 1
    tout = tfused.physics_step_fused(tm, p, q, qd, qfrc, xfrc=xfrc, q_target=qt, dyn=planes)
    jout = jfused.physics_step_fused(jm, jenv.sim_params, jq, jqd, jnp.asarray(qfrc.numpy()),
                                     xfrc=jnp.asarray(xfrc.numpy()), q_target=jnp.asarray(qt.numpy()),
                                     use_pallas=False, dyn=jdyn)
    for k, tol in TOL.items():
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)), atol=tol, err_msg=k)
    bf = np.linalg.norm(np.asarray(jout.body_force), axis=-1)
    nut, bolt = tenv.nut_ref.body0, tenv.bolt_body
    assert (bf[:, nut] > 0.05).all()
    assert (bf[1::4, bolt] > 0.05).all() and (bf[2::4, bolt] > 0.05).all()  # on the thread, on the head


# ---- env steps ------------------------------------------------------------------------

def _fields(js):
    task = js.task
    task = tuple(np.asarray(v) for v in task) if isinstance(task, tuple) else {k: np.asarray(v) for k, v in
                                                                               task.items()}
    return {"q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf,
            "actions": js.actions, "task": task}


@pytest.mark.parametrize("task", TASKS)
def test_reset_and_env_steps_match_jax(task):
    """The port's observation of the JAX reset state equals the JAX reset's;
    then, from that state put on both, three env steps under random actions
    (the JAX reset and step under `jax.jit`):
    q, qd, observations, rewards, done flags, the task state and the
    extras (`successes`; Screw's `descent`). Pick starts its four envs at
    the progress that crosses its phase boundaries: env 0 from rl_len - 2
    (its last acting step, then the first closing one at rl_len), env 1
    from rl_len + close_steps - 2 (into the lift), env 2 from the episode's
    last two steps (done, with the lift success scored, then a reset), env
    3 at the start. Each step starts both from the JAX package's state of
    the step before: the nut spinning in the grip of Place and Screw grows a
    difference of 1e-4 rad/s (as large as float32 against float64 in one
    step) six-fold per step, past qd's 2e-3 in the third. An env that
    resets starts its next episode from each package's own draws: it is
    compared up to the reset."""
    jenv, tenv = _both(task)
    jstate, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tstate = env_state_from_arrays(tenv.reset(0)[0], _fields(jstate), "cpu")
    obs = tenv.observe(tstate.sim.q, tstate.sim.qd, tenv._kin(tstate.sim.q, tstate.sim.qd), tenv._no_sensors(N),
                       tstate.task, tstate.actions, tstate.progress)
    np.testing.assert_allclose(torch.clamp(obs, -tenv.clip_obs, tenv.clip_obs).numpy(), np.asarray(jobs), atol=1e-5)
    if "Pick" in task:
        rl, close, last = tenv.rl_len, tenv.close_steps, tenv.max_episode_length - 1
        assert (rl, close, last) == (jenv.rl_len, jenv.close_steps, 149)
        prog = jnp.asarray([rl - 2, rl + close - 2, last - 1, 0], jnp.int32)
        jstate = jstate.replace(progress=prog, task={"t": prog})
        tstate = env_state_from_arrays(tstate, _fields(jstate), "cpu")
    # the observations' velocities (the fingertip's, Screw's nut's) to qd's tolerance, the rest to 1e-4
    obs_tol = np.full(tenv.num_obs, 1e-4)
    obs_tol[7:13] = TOL["qd"]
    if "Screw" in task:
        obs_tol[20:26] = TOL["qd"]
    rng = np.random.RandomState(4)
    reset = np.zeros(N, bool)
    jstep = jax.jit(jenv.step)
    for k in range(3):
        a = rng.uniform(-0.3, 0.3, (N, 12)).astype(np.float32)
        jstate, jobs, jrew, jdone, jex = jstep(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        kept = ~reset
        np.testing.assert_allclose(tstate.sim.q.numpy()[kept], np.asarray(jstate.sim.q)[kept], atol=TOL["q"])
        np.testing.assert_allclose(tstate.sim.qd.numpy()[kept], np.asarray(jstate.sim.qd)[kept], atol=TOL["qd"])
        gap = np.abs(tobs.numpy()[kept] - np.asarray(jobs)[kept])
        assert (gap <= obs_tol).all(), (k, np.argwhere(gap > obs_tol), gap.max(0))
        np.testing.assert_allclose(trew.numpy()[kept], np.asarray(jrew)[kept], atol=1e-4, err_msg=f"step {k} reward")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tstate.progress.numpy(), np.asarray(jstate.progress))
        assert set(tex) == set(jex)
        for name in jex:
            tol = TOL["q"] if name == "descent" else 0.0
            np.testing.assert_allclose(tex[name].numpy()[kept].astype(np.float32),
                                       np.asarray(jex[name], np.float32)[kept], atol=tol, err_msg=name)
        if isinstance(jstate.task, dict):
            for name, v in jstate.task.items():
                np.testing.assert_array_equal(tstate.task[name].numpy()[kept], np.asarray(v)[kept], err_msg=name)
        # the next step starts from the JAX package's state on both sides
        tstate = env_state_from_arrays(tstate, _fields(jstate), "cpu")
        reset = np.asarray(jdone).copy()
        if "Pick" in task:
            # the scripted tail: zero reward while closing and lifting
            in_tail = (tstate.progress.numpy() >= tenv.rl_len) & ~np.asarray(jdone)
            assert (trew.numpy()[in_tail] == 0.0).all()
    if "Pick" in task:
        assert int(np.asarray(jstate.progress)[2]) == 1  # env 2 ended its episode and began the next
