"""The port's Franka tasks against the JAX package, on the CPU: the URDF
mesh path, the cabinet stand-in, both tasks' models, reset and env steps,
and one FrankaCabinet PPO epoch.

The Franka and the cabinet are the hand-written stand-ins under
isaacgymenvs_tpu_torch/assets (the handle bar's OBJ is written by
assets/urdf/sektion_cabinet_model/make_cabinet_meshes.py); the JAX package
reads them through $ISAACGYMENVS_TPU_ASSETS. Its env steps run op by op with
its fused physics math (`use_fused`), as in tests/test_torch_humanoid.py.
Tolerances: models equal within 1e-6; env steps q 2e-4, qd 2e-3, the
forces of the first physics call 2e-2 (tests/test_fused.py:79-82),
observations and rewards 1e-4, done flags, `successes` and the task state
equal; the epoch's metrics rtol 2e-4, as tests/test_torch_ppo.py.
Actions are gentle (a twentieth of their range): under violent torques
FrankaCubeStack's stiff contacts amplify float32 rounding to 0.25 m/s
(tests/test_fused.py:145-154).
"""
import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch.convert import env_state_from_arrays
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.model import GEOM_BOX, GEOM_MESH, HINGE, SLIDE, load_urdf
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 4
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
CABINET_DIR = os.path.join(package_asset_root(), "urdf", "sektion_cabinet_model")
CABINET = os.path.join(CABINET_DIR, "urdf", "sektion_cabinet_2.urdf")
CONFIGS = {"osc": ("FrankaCubeStack", ()), "joint_tor": ("FrankaCubeStack", ("task.env.controlType=joint_tor",)),
           "cabinet": ("FrankaCabinet", ())}


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache_writes():
    """The JAX package caches compiled programs on disk. Two test workers
    that compile the same Franka program at once (the cabinet's env step in
    the step test and in the epoch test) race on its cache entry, and a
    worker once aborted reading one. These tests write no entries."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _assert_models_equal(a, b):
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


# ---- the URDF mesh path ---------------------------------------------------------

def _write_stl(path, tris, binary):
    if binary:
        with open(path, "wb") as f:
            f.write(b"solid but binary".ljust(80, b" ") + struct.pack("<I", len(tris)))
            for t in tris:
                f.write(struct.pack("<12fH", 0, 0, 0, *np.asarray(t, np.float32).reshape(-1), 0))
    else:
        with open(path, "w") as f:
            f.write("solid box\n")
            for t in tris:
                f.write(" facet normal 0 0 0\n  outer loop\n")
                f.writelines(f"   vertex {v[0]} {v[1]} {v[2]}\n" for v in t)
                f.write("  endloop\n endfacet\n")
            f.write("endsolid box\n")


def test_urdf_mesh_geometry_matches_jax(tmp_path):
    """OBJ (the handle bar, through a `package://` name and a scale), binary
    and ASCII STL (an off-centre box) collision meshes through both URDF
    parsers: equal models; a MESH geom of the bounding box's half-extents,
    its frame moved to the box's centre, 4 farthest-point vertices as its
    contact candidates; a link without <inertial> weighs its bounding box
    at the default density; a missing mesh drops its geom."""
    from isaacgymenvs_tpu.model import load_urdf as jload_urdf
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_cabinet_meshes",
                                                  os.path.join(CABINET_DIR, "make_cabinet_meshes.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    pkg = tmp_path / "pkg"
    (pkg / "meshes").mkdir(parents=True)
    gen.write_obj(str(pkg / "meshes" / "bar.obj"), *gen.handle_bar())
    lo, hi = np.array([0.1, -0.02, 0.0]), np.array([0.16, 0.02, 0.03])
    c = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6),
             (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    tris = [c[list(f)] for f in faces]
    _write_stl(pkg / "meshes" / "box_bin.stl", tris, binary=True)
    _write_stl(pkg / "meshes" / "box_ascii.stl", tris, binary=False)
    urdf = tmp_path / "pkg" / "robot.urdf"
    link = lambda name, geo, origin='xyz="0 0 0" rpy="0 0 0"', inertial=True: (
        f'<link name="{name}">'
        + ('<inertial><mass value="0.5"/><inertia ixx="1e-3" iyy="1e-3" izz="1e-3" ixy="0" ixz="0" iyz="0"/>'
           '</inertial>' if inertial else "")
        + f'<collision><origin {origin}/><geometry>{geo}</geometry></collision></link>')
    urdf.write_text(
        '<robot name="meshes">'
        + link("base", '<box size="0.2 0.2 0.2"/>')
        + link("bar", '<mesh filename="package://meshes/bar.obj" scale="2 1 1"/>', 'xyz="0 0 0.1" rpy="1.5707963 0 0"')
        + link("stl_bin", '<mesh filename="meshes/box_bin.stl"/>', 'xyz="0.0 0.1 0" rpy="0 0 0.5"', inertial=False)
        + link("stl_ascii", '<mesh filename="meshes/box_ascii.stl" scale="0.5"/>')
        + link("lost", '<mesh filename="meshes/missing.obj"/>')
        + "".join(f'<joint name="j{i}" type="revolute"><parent link="base"/><child link="{n}"/>'
                  f'<origin xyz="0 0 {0.3 * (i + 1)}"/><axis xyz="0 1 0"/><limit lower="-1" upper="1"/></joint>'
                  for i, n in enumerate(("bar", "stl_bin", "stl_ascii", "lost")))
        + "</robot>")
    tm, jm = load_urdf(str(urdf)), jload_urdf(str(urdf))
    _assert_models_equal(tm, jm)
    assert tm.geom_type == (GEOM_BOX, GEOM_MESH, GEOM_MESH, GEOM_MESH) and tm.geom_body == (0, 1, 2, 3)
    np.testing.assert_allclose(tm.geom_size[1:], [[0.02, 0.1, 0.01], [0.03, 0.02, 0.015], [0.015, 0.01, 0.0075]],
                               atol=1e-6)
    # the binary STL's frame: at its box centre, turned by the collision's yaw
    yaw, centre = 0.5, (lo + hi) / 2
    shift = [np.cos(yaw) * centre[0] - np.sin(yaw) * centre[1], np.sin(yaw) * centre[0] + np.cos(yaw) * centre[1],
             centre[2]]
    np.testing.assert_allclose(tm.geom_pos[2], np.array([0.0, 0.1, 0.0]) + shift, atol=1e-6)
    np.testing.assert_allclose(tm.geom_pos[3], 0.5 * centre, atol=1e-6)
    assert [tm.cpoint_body.count(b) for b in range(5)] == [8, 4, 4, 4, 0]
    # the STL box's candidates are 4 of its corners, about its centre
    pts = np.asarray(tm.cpoint_pos)[[i for i, b in enumerate(tm.cpoint_body) if b == 3]] - 0.5 * centre
    np.testing.assert_allclose(np.abs(pts), np.broadcast_to((hi - lo) / 4, (4, 3)), atol=1e-6)
    assert float(tm.body_mass[2]) == pytest.approx(1000.0 * float(np.prod(hi - lo)), rel=1e-5)


def test_cabinet_stand_in_facts():
    """The cabinet stand-in through both parsers (fix_base): equal models;
    7 bodies with the public asset's link names; the four joints in the
    order FrankaCabinet indexes them (door_right, door_left, drawer_top,
    drawer_bottom); the drawers' travel 0.4 m; the handle bar the first
    geom of `drawer_handle_top`, a MESH of half-extents (0.01, 0.1, 0.01)
    whose cylinder axis lies along the drawer front; the committed OBJ is
    what make_cabinet_meshes.py writes."""
    from isaacgymenvs_tpu.model import load_urdf as jload_urdf
    import importlib.util

    tm, jm = load_urdf(CABINET, fix_base=True), jload_urdf(CABINET, fix_base=True)
    _assert_models_equal(tm, jm)
    assert tm.body_names == ("sektion", "door_right_link", "door_left_link", "drawer_top", "drawer_handle_top",
                             "drawer_bottom", "drawer_handle_bottom")
    assert (tm.nbody, tm.nq, tm.nv) == (7, 4, 4)
    assert tm.dof_joint_names() == ("door_right_joint", "door_left_joint", "drawer_top_joint", "drawer_bottom_joint")
    assert tm.jnt_type[1:4] == (HINGE, HINGE, SLIDE) and tm.jnt_type[5] == SLIDE
    np.testing.assert_allclose(tm.dof_limit_upper[2:] - tm.dof_limit_lower[2:], [0.4, 0.4], atol=1e-6)
    handle = tm.body_names.index("drawer_handle_top")
    geoms = [g for g in range(tm.ngeom) if tm.geom_body[g] == handle]
    assert [tm.geom_type[g] for g in geoms] == [GEOM_MESH, GEOM_BOX, GEOM_BOX]
    np.testing.assert_allclose(tm.geom_size[geoms[0]], [0.01, 0.1, 0.01], atol=1e-6)
    from isaacgymenvs_tpu_torch.maths import quat_rotate

    axis = quat_rotate(torch.tensor(tm.geom_quat[geoms[0]]), torch.tensor([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(axis.abs().numpy(), [0.0, 1.0, 0.0], atol=1e-6)
    spec = importlib.util.spec_from_file_location("make_cabinet_meshes",
                                                  os.path.join(CABINET_DIR, "make_cabinet_meshes.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    verts, tris = gen.handle_bar()
    with open(gen.OUT) as f:
        lines = f.read().splitlines()[1:]
    assert lines == ["v {:.6f} {:.6f} {:.6f}".format(*v) for v in verts] + \
        ["f {} {} {}".format(*(t + 1)) for t in tris]


# ---- the tasks ------------------------------------------------------------------

def _both(key):
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    task, extra = CONFIGS[key]
    args = [f"task={task}", f"num_envs={N}", *extra]
    jcfg = jload(args)["task"]
    jcfg["sim"]["use_fused"] = True
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks[task](jcfg)
        tenv = ttasks[task](tload(args)["task"], device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("key", ["osc", "cabinet"])
def test_models_match_jax(key):
    """`compose`d scenes equal leaf by leaf: FrankaCubeStack 15 bodies, nq
    23, nv 21, 40 pair rows (cube A's 8 corners against the table and cube
    B, cube B's against the table, the 16 finger corners against cube A)
    under the cap of 20; FrankaCabinet 19 bodies, nv 13, the hand's and
    fingers' 24 corners against the handle bar (a MESH on the cylinder
    branch) under the cap of 16. No plane rows; the kernel covers both."""
    jenv, tenv = _both(key)
    _assert_models_equal(tenv.model, jenv.model)
    m, p = tenv.model, tenv.sim_params
    s = tfused.spec_of(m)
    assert s.nc == 0 and tfused.fused_supported(m, p)
    if key == "osc":
        assert (m.nbody, m.nq, m.nv, s.pp_nc, tfused.topk_cap(s, p), p.solver_apgd_iterations) == (15, 23, 21, 40, 20, 32)
        a, b = tenv.cubeA_ref.body0, tenv.cubeB_ref.body0
        assert sorted(set(s.pp_a.tolist())) == [10, 11, a, b] and set(s.pp_b.tolist()) == {12, a, b}
        assert (tenv.aq, tenv.bq) == (jenv.aq, jenv.bq) and s.pp_gtype.tolist() == [2] * 40
    else:
        assert (m.nbody, m.nq, m.nv, s.pp_nc, tfused.topk_cap(s, p), p.solver_apgd_iterations) == (19, 13, 13, 24, 16, 48)
        assert s.pp_gtype.tolist() == [3] * 24 and m.geom_type[m.ppair_geom[0]] == GEOM_MESH
        assert set(s.pp_b.tolist()) == {m.body_names.index("cab:drawer_handle_top")}
        assert m.dof_joint_names()[9:] == ("cab:door_right_joint", "cab:door_left_joint", "cab:drawer_top_joint",
                                           "cab:drawer_bottom_joint")
        for name in ("franka_local_grasp_pos", "franka_local_grasp_rot", "drawer_local_grasp_pos"):
            np.testing.assert_allclose(getattr(tenv, name).numpy(), np.asarray(getattr(jenv, name)), atol=1e-6)


def _recorder(mp, sink):
    orig = tfused.physics_step_fused

    def record(*a, **k):
        out = orig(*a, **k)
        sink.append((a, k, out))
        return out

    mp.setattr(tfused, "physics_step_fused", record)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_reset_and_steps_match_jax(key):
    """The port's observation of the JAX reset state equals the JAX reset's;
    then from the port's `contact_states` (FrankaCubeStack: both cubes on
    the table, cube A on cube B, cube A between the fingers, on the table
    again; FrankaCabinet: the hand or a finger on the handle bar), put on
    both, three env steps of gentle random actions (the JAX reset and step
    under `jax.jit`): q, qd, observation,
    reward, done, `successes` and the task state; the first physics call's
    forces against the JAX package's fused step on the inputs of its own
    `compute_force` (the OSC runs in both), with contact force on the cubes
    or the handle. Cube A on cube B is a stack: its episode ends and the
    next starts from each package's own draws, so those envs are compared
    up to the end and then carry the JAX package's new episode."""
    from isaacgymenvs_tpu.engine import fused as jfused

    jenv, tenv = _both(key)
    jstate, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    fields = lambda js: {"q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf,
                         "actions": js.actions, "task": {k: np.asarray(v) for k, v in js.task.items()}}
    tstate = env_state_from_arrays(tenv.reset(0)[0], fields(jstate), "cpu")
    obs = tenv.observe(tstate.sim.q, tstate.sim.qd, None, tenv._no_sensors(N), tstate.task, tstate.actions,
                       tstate.progress)
    np.testing.assert_allclose(torch.clamp(obs, -tenv.clip_obs, tenv.clip_obs).numpy(), np.asarray(jobs), atol=1e-5)

    q, qd = tenv.contact_states(N, seed=3)
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q.numpy()), qd=jnp.asarray(qd.numpy())))
    if key == "cabinet":  # the position targets hold the arm where the contact state put it
        jstate = jstate.replace(task={"targets": jnp.asarray(q[:, tenv.all_q_idx[:9]].numpy())})
    tstate = env_state_from_arrays(tstate, fields(jstate), "cpu")
    rng = np.random.RandomState(4)
    calls, reset, successes = [], np.zeros(N, bool), 0
    jstep = jax.jit(jenv.step)
    with pytest.MonkeyPatch.context() as mp:
        _recorder(mp, calls)
        for k in range(3):
            a = rng.uniform(-0.05, 0.05, (N, tenv.num_acts)).astype(np.float32)
            if k == 0:
                jqfrc, jxfrc, jqt = jax.vmap(jenv.compute_force)(jnp.asarray(a), jstate.sim.q, jstate.sim.qd,
                                                                 jstate.task)
                jphys = jfused.physics_step_fused(jenv.model, jenv.sim_params, jstate.sim.q, jstate.sim.qd, jqfrc,
                                                  xfrc=jxfrc, q_target=jqt, use_pallas=False)
            jstate, jobs, jrew, jdone, jex = jstep(jstate, jnp.asarray(a))
            tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
            if k == 0:
                targs, tkw, tphys = calls[0]
                np.testing.assert_allclose(targs[4].numpy(), np.asarray(jqfrc), rtol=1e-4, atol=1e-3, err_msg="qfrc")
                np.testing.assert_array_equal(tkw["q_target"].numpy(), np.asarray(jqt))
                for f, tol in TOL.items():
                    np.testing.assert_allclose(getattr(tphys, f).numpy(), np.asarray(getattr(jphys, f)), atol=tol,
                                               err_msg=f)
                bodies = ([tenv.cubeA_ref.body0, tenv.cubeB_ref.body0] if key != "cabinet"
                          else [tenv.model.body_names.index("cab:drawer_handle_top")])
                pressed = torch.linalg.vector_norm(tphys.body_force[:, bodies], dim=-1).amax(1)
                # (a finger under the bar may sag off it under gravity within the step)
                assert bool((pressed > 0.05).sum() >= N // 2), pressed
            # envs done in the last step start a new episode from each package's own draws:
            # compare the others, then put the JAX package's new episode on the port's state
            kept = ~reset
            np.testing.assert_allclose(tstate.sim.q.numpy()[kept], np.asarray(jstate.sim.q)[kept], atol=TOL["q"])
            np.testing.assert_allclose(tstate.sim.qd.numpy()[kept], np.asarray(jstate.sim.qd)[kept], atol=TOL["qd"])
            np.testing.assert_allclose(tobs.numpy()[kept], np.asarray(jobs)[kept], atol=1e-4, err_msg=f"step {k} obs")
            np.testing.assert_allclose(trew.numpy()[kept], np.asarray(jrew)[kept], atol=1e-4,
                                       err_msg=f"step {k} reward")
            np.testing.assert_array_equal(tdone.numpy()[kept], np.asarray(jdone)[kept])
            for name, v in jstate.task.items():
                np.testing.assert_allclose(tstate.task[name].numpy()[kept].astype(np.float32),
                                           np.asarray(v, np.float32)[kept], atol=1e-6, err_msg=name)
                tstate.task[name][reset] = torch.tensor(np.asarray(v)[reset])
            if reset.any():
                tstate.sim.q[reset] = torch.tensor(np.asarray(jstate.sim.q)[reset])
                tstate.sim.qd[reset] = torch.tensor(np.asarray(jstate.sim.qd)[reset])
                tstate.reset_buf[reset] = torch.tensor(np.asarray(jdone)[reset])
            assert set(tex) == set(jex)
            for name in jex:
                np.testing.assert_array_equal(tex[name].numpy()[kept], np.asarray(jex[name])[kept], err_msg=name)
            reset = np.asarray(jdone).copy()
            successes += int(np.asarray(jex.get("successes", np.zeros(N))).sum())
    assert len(calls) == 3 * tenv.control_freq_inv and tobs.shape == (N, tenv.num_obs)
    if key != "cabinet":  # cube A placed on cube B is a stack: it counts, and its episode ends
        assert successes >= 1


# ---- one FrankaCabinet PPO epoch --------------------------------------------------

HORIZON, MINI_EPOCHS, NUM_MB = 3, 2, 2


def test_cabinet_epoch_matches_jax():
    """One FrankaCabinet PPO epoch from the JAX reset state (the recipe's
    reward scale 0.01, its network cut to [32, 16]), both sides with the
    same action noise and minibatch permutations, the JAX side assembled
    from the JAX package's env, network and update as in
    tests/test_torch_ppo.py (its env step and gradient under `jax.jit`): metrics rtol 2e-4 (atol 2e-6), parameters atol
    1e-4, the running stats 1e-4."""
    from isaacgymenvs_tpu.learn import ppo as jppo
    from isaacgymenvs_tpu_torch.learn import ppo as tppo
    from test_torch_ppo import _adam_state, _jax_epoch, _jax_params, _np_tree, _port_params
    from isaacgymenvs_tpu_torch.convert import train_state_from_jax

    jenv, tenv = _both("cabinet")
    train = {"network": {"mlp": {"units": [32, 16], "activation": "elu"},
                         "space": {"continuous": {"fixed_sigma": True, "sigma_init": {"val": 0.0}}}},
             "config": {"horizon_length": HORIZON, "mini_epochs": MINI_EPOCHS, "minibatch_size": HORIZON * N // NUM_MB,
                        "truncate_grads": True, "critic_coef": 4, "value_bootstrap": True, "e_clip": 0.2,
                        "entropy_coef": 0.0, "reward_shaper": {"scale_value": 0.01}}}
    jagent, tagent = jppo.PPO(jenv, train, seed=0), tppo.PPO(tenv, train, seed=0)
    jts = jagent.init()
    adam = _adam_state(jts.opt_state)
    flds = _np_tree({"params": jts.params, "obs_rms": vars(jts.obs_rms), "value_rms": vars(jts.value_rms),
                     "lr": jts.lr, "mu": adam.mu, "nu": adam.nu, "count": adam.count})
    tts = tagent.load_state(tagent.init(), train_state_from_jax(flds, [n for n, _ in tagent.network.named_parameters()]))
    js = jts.env_state
    tts.env_state = env_state_from_arrays(tts.env_state, {
        "q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf, "actions": js.actions,
        "task": {k: np.asarray(v) for k, v in js.task.items()}}, "cpu")
    tts.obs = torch.tensor(np.asarray(jts.obs))
    rng = np.random.RandomState(7)
    B = HORIZON * N
    noise = (0.3 * rng.normal(size=(HORIZON, N, 9))).astype(np.float32)
    perms = np.stack([rng.permutation(B) for _ in range(MINI_EPOCHS)])
    jts, want = _jax_epoch(jagent, jts, jnp.asarray(noise), perms, jit=True)
    tts, got = tagent.train_epoch(tts, noise=torch.tensor(noise), perms=torch.tensor(perms))
    for k in ("a_loss", "c_loss", "entropy", "b_loss", "kl", "lr", "reward_mean_step"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-6, err_msg=k)
    jp, tp = _jax_params(jts.params), _port_params(tagent)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], atol=1e-4, err_msg=name)
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(tts.value_rms, f).numpy(), np.asarray(getattr(jts.value_rms, f)),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(getattr(tts.obs_rms, f).numpy(), np.asarray(getattr(jts.obs_rms, f)),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tts.env_state.task["targets"].numpy(), np.asarray(jts.env_state.task["targets"]),
                               atol=1e-5)
