"""The port's ShadowHand and AllegroHand against the JAX package, on the
CPU: MJCF mesh geoms, the hand and object stand-ins, the tasks' models, the
hooks at drawn states for every observation scheme, the plain step on the
tasks' contact states, reset and env steps, the variant yamls and recipes,
per-key observation noise and the dict-observation API; and the port's
counterparts of tests/test_shadow_hand.py.

The stand-ins live under isaacgymenvs_tpu_torch/assets (the hand's STL
meshes are written by assets/mjcf/open_ai_assets/hand/make_shadow_hand_meshes.py);
the JAX package reads them through $ISAACGYMENVS_TPU_ASSETS. The JAX task
draws its goals and force kicks from a PRNG key in its task state, the port
from its generator (`draws_of_step`): the tests hand the port JAX's draws.
Tolerances: models within 1e-6; hooks 1e-5 (the observation's
force-scaled terms 1e-4); the plain step q 2e-4, qd 2e-3, forces 2e-2
(tests/test_fused.py:79-82) on the envs `torch_conditioning.kept` keeps;
env steps as the plain step, observations and rewards 1e-3.
"""
import importlib.util
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_conditioning as cond
from isaacgymenvs_tpu_torch import maths
from isaacgymenvs_tpu_torch.convert import env_state_from_arrays, task_from_arrays
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.model import GEOM_BOX, GEOM_MESH, load_mjcf, load_urdf
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)
from test_torch_anymal import _assert_models_equal

torch.set_num_threads(1)

N = 4
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
HAND_DIR = os.path.join(package_asset_root(), "mjcf", "open_ai_assets", "hand")
STAND_INS = ["mjcf/open_ai_assets/hand/shadow_hand.xml", "mjcf/open_ai_assets/hand/egg.xml",
             "mjcf/open_ai_assets/hand/pen.xml", "urdf/objects/cube_multicolor.urdf",
             "urdf/objects/cube_multicolor_allegro.urdf", "urdf/kuka_allegro_description/allegro_touch_sensor.urdf"]
_ENVS = {}


@pytest.fixture(autouse=True)
def _jax_assets(monkeypatch):
    monkeypatch.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())




def _both(task, extra=()):
    """The JAX env and the port's env of `task` (a yaml name) at N envs,
    built once per worker."""
    key = (task, tuple(extra))
    if key not in _ENVS:
        from isaacgymenvs_tpu.tasks import task_map as jtasks
        from isaacgymenvs_tpu.utils.config import load_config as jload
        from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
        from isaacgymenvs_tpu_torch.utils.config import load_config as tload

        args = [f"task={task}", f"num_envs={N}", *extra]
        jcfg = jload(args)["task"]
        jcfg["sim"]["use_fused"] = True
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
            jenv = jtasks[jcfg["name"]](jcfg)
            tcfg = tload(args)["task"]
            _ENVS[key] = (jenv, ttasks[tcfg["name"]](tcfg, device="cpu"))
    return _ENVS[key]


# ---- MJCF mesh geoms and the stand-ins ------------------------------------------

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


def test_mjcf_mesh_geoms_match_jax(tmp_path):
    """Binary and ASCII STL meshes of an off-centre box (one with a scale)
    through both MJCF parsers, in a meshdir, on bodies with a turned geom:
    equal models; a MESH geom of the vertices' bounding box, its frame moved
    to the box's centre along the geom's orientation, 6 farthest-point
    vertices as candidates about that centre, the box's inertia at the
    geom's density; a missing mesh and a mesh of another format drop their
    geoms."""
    from isaacgymenvs_tpu.model import load_mjcf as jload_mjcf

    lo, hi = np.array([0.1, -0.02, 0.0]), np.array([0.16, 0.02, 0.03])
    c = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6),
             (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    tris = [c[list(f)] for f in faces]
    (tmp_path / "meshes").mkdir()
    _write_stl(tmp_path / "meshes" / "box_bin.stl", tris, binary=True)
    _write_stl(tmp_path / "meshes" / "box_ascii.stl", tris, binary=False)
    (tmp_path / "meshes" / "other.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    xml = tmp_path / "model.xml"
    xml.write_text(f"""<mujoco><compiler angle="radian" meshdir="meshes"/>
      <asset><mesh name="bin" file="box_bin.stl"/><mesh name="ascii" file="box_ascii.stl" scale="0.5 2 1"/>
        <mesh name="lost" file="missing.stl"/><mesh name="other" file="other.obj"/></asset>
      <worldbody><body name="base"><geom type="box" size="0.1 0.1 0.1"/>
        <body name="a" pos="0 0 0.3"><joint name="ja" type="hinge" axis="0 1 0" range="-1 1"/>
          <geom type="mesh" mesh="bin" pos="0 0.1 0" quat="{np.cos(0.25)} 0 0 {np.sin(0.25)}" density="500"/></body>
        <body name="b" pos="0 0 0.6"><joint name="jb" type="hinge" axis="0 1 0" range="-1 1"/>
          <geom type="mesh" mesh="ascii"/><geom type="mesh" mesh="lost"/><geom type="mesh" mesh="other"/></body>
      </body></worldbody></mujoco>""")
    tm, jm = load_mjcf(str(xml)), jload_mjcf(str(xml))
    _assert_models_equal(tm, jm)
    assert tm.geom_type == (GEOM_BOX, GEOM_MESH, GEOM_MESH) and tm.geom_body == (0, 1, 2)
    np.testing.assert_allclose(tm.geom_size[1:], [[0.03, 0.02, 0.015], [0.015, 0.04, 0.015]], atol=1e-6)
    yaw, centre = 0.5, (lo + hi) / 2
    shift = [np.cos(yaw) * centre[0] - np.sin(yaw) * centre[1], np.sin(yaw) * centre[0] + np.cos(yaw) * centre[1],
             centre[2]]
    np.testing.assert_allclose(tm.geom_pos[1], np.array([0.0, 0.1, 0.0]) + shift, atol=1e-6)
    np.testing.assert_allclose(tm.geom_pos[2], centre * [0.5, 2.0, 1.0], atol=1e-6)
    assert [tm.cpoint_body.count(b) for b in range(3)] == [8, 6, 6]
    pts = np.asarray(tm.cpoint_pos)[[i for i, b in enumerate(tm.cpoint_body) if b == 2]] - tm.geom_pos[2]
    np.testing.assert_allclose(np.abs(pts), np.broadcast_to([0.015, 0.04, 0.015], (6, 3)), atol=1e-6)
    assert float(tm.body_mass[1]) == pytest.approx(500.0 * float(np.prod(hi - lo)), rel=1e-5)


@pytest.mark.parametrize("rel", STAND_INS)
def test_stand_ins_match_jax(rel, tmp_path):
    """Each stand-in through both parsers: equal models, and what the tasks
    look up. ShadowHand: 24 hinge dofs, 20 position actuators, the four
    fixed tendons *J1c, the five robot0:*distal tips, three MESH geoms (the
    committed STLs are what make_shadow_hand_meshes.py writes); Allegro: 16
    dofs and the four *_biotac_tip bodies; the objects free bodies."""
    from isaacgymenvs_tpu.model import load_mjcf as jload_mjcf, load_urdf as jload_urdf

    path = os.path.join(package_asset_root(), rel)
    if rel.endswith(".xml"):
        tm, jm = load_mjcf(path), jload_mjcf(path)
    else:
        fix = "allegro_touch" in rel
        tm, jm = load_urdf(path, fix_base=fix), jload_urdf(path, fix_base=fix)
    _assert_models_equal(tm, jm)
    if rel.endswith("shadow_hand.xml"):
        assert (tm.nq, tm.nv, len(tm.actuator_dof), tm.geom_type.count(GEOM_MESH)) == (24, 24, 20, 3)
        assert all(n.endswith("J1c") for n in tm.tendon_names) and len(tm.tendon_names) == 4
        assert all(f"robot0:{f}distal" in tm.body_names for f in ("ff", "mf", "rf", "lf", "th"))
        spec = importlib.util.spec_from_file_location("make_shadow_hand_meshes",
                                                      os.path.join(HAND_DIR, "make_shadow_hand_meshes.py"))
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        for name, (bottom, top) in gen.MESHES.items():
            gen.write_stl(str(tmp_path / f"{name}.stl"), *gen.hexahedron(bottom, top))
            with open(os.path.join(gen.OUT, f"{name}.stl"), "rb") as f:
                assert f.read() == (tmp_path / f"{name}.stl").read_bytes(), name
    elif "allegro_touch" in rel:
        assert (tm.nq, tm.nv) == (16, 16)
        assert all(f"{f}_biotac_tip" in tm.body_names for f in ("index", "middle", "ring", "thumb"))
    else:
        assert (tm.nq, tm.nv) == (7, 6)


@pytest.mark.parametrize("task,extra", [("ShadowHand", ()), ("ShadowHand", ("task.env.objectType=egg",)),
                                        ("ShadowHand", ("task.env.objectType=pen",)), ("AllegroHand", ())])
def test_models_match_jax(task, extra):
    """The composed scenes equal leaf by leaf: the hand's base at z = 0.5
    (AllegroHand turned by its three quaternions), every hand candidate a
    pair row against the object's geom, no plane rows, the cap of 24; the
    coupling tendons' springs and the drives' damping (ShadowHand), the
    drives of stiffness 3 (AllegroHand)."""
    jenv, tenv = _both(task, extra)
    _assert_models_equal(tenv.model, jenv.model)
    m, p = tenv.model, tenv.sim_params
    s = tfused.spec_of(m)
    assert s.nc == 0 and tfused.fused_supported(m, p) and tfused.topk_cap(s, p) == 24
    assert s.pp_nc == len(m.ppair_point) == sum(1 for b in m.cpoint_body if b < tenv.obj_body)
    assert (tenv.obj_q, tenv.obj_v, tenv.num_hand_dofs) == (jenv.obj_q, jenv.obj_v, jenv.num_hand_dofs)
    np.testing.assert_array_equal(tenv.actuated_idx.numpy(), np.asarray(jenv.actuated_idx))
    np.testing.assert_array_equal(tenv.fingertip_bodies.numpy(), np.asarray(jenv.fingertip_bodies))
    np.testing.assert_allclose(tenv.object_start_pos.numpy(), np.asarray(jenv.object_start_pos), atol=1e-7)
    if task == "ShadowHand":
        assert (m.nv, s.pp_nc) == (30, 114) and np.asarray(m.tendon_stiffness).tolist() == [30.0] * 4
    else:
        assert (m.nv, s.pp_nc) == (22, 144) and np.asarray(m.dof_stiffness)[:16].tolist() == [3.0] * 16


# ---- the hooks at drawn states --------------------------------------------------

def _jax_fk(jm, q, qd):
    """JAX's forward kinematics of the batch, jitted (op by op it compiles
    hundreds of small programs; the two agree within 1e-6 here)."""
    from isaacgymenvs_tpu.engine import dynamics as jdyn

    return jax.jit(jax.vmap(lambda a, b: jdyn.forward_kinematics(jm, a, b)))(jnp.asarray(q), jnp.asarray(qd))


def _port_task(jtask):
    return task_from_arrays(jax.tree.map(np.asarray, jtask), "cpu")


def _jax_step_draws(jtask):
    """The draws the JAX reward_done takes from each env's task key: the
    new goal's (N, 2), the kick's (N,) and the kick force's (N, 3)."""
    def one(key):
        _, kg, kf, kfd = jax.random.split(key, 4)
        return (jax.random.uniform(kg, (2,), minval=-1.0, maxval=1.0), jax.random.uniform(kf, ()),
                jax.random.normal(kfd, (3,)))

    return tuple(torch.tensor(np.asarray(a)) for a in jax.vmap(one)(jtask["key"]))


def _drawn(jenv, tenv, seed):
    """N states from the JAX reset draws (q, qd jittered), the JAX task with
    its keys, random sensors, actions and progress."""
    from isaacgymenvs_tpu.envcore.vec_task import Sensors as JSensors
    from isaacgymenvs_tpu_torch.envcore.vec_task import Sensors

    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    jq, jqd, jtask = jax.vmap(jenv.sample_init)(keys)
    rng = np.random.RandomState(seed)
    q = np.asarray(jq) + np.where(np.arange(tenv.model.nq) < tenv.obj_q, rng.uniform(-0.05, 0.05, (N, tenv.model.nq)), 0)
    qd = rng.uniform(-0.5, 0.5, (N, tenv.model.nv)).astype(np.float32)
    nb, nv = tenv.model.nbody, tenv.model.nv
    sens = [rng.normal(size=s).astype(np.float32) for s in ((N, nb, 3), (N, nb, 3), (N, nv))]
    acts = rng.uniform(-1, 1, (N, tenv.num_acts)).astype(np.float32)
    progress = np.asarray([0, 5, tenv.max_episode_length - 1, 3], np.int32)
    return (q.astype(np.float32), qd, jtask, JSensors(*map(jnp.asarray, sens)), Sensors(*map(torch.tensor, sens)),
            acts, progress)


HOOK_CASES = [("ShadowHand", o, ()) for o in ("openai", "full_no_vel", "full", "full_state")] + [
    ("ShadowHand", "full_state", ("task.env.forceScale=1.0", "task.env.maxConsecutiveSuccesses=2",
                                  "task.env.actionsMovingAverage=0.3")),
    ("ShadowHand", "full", ("task.env.useRelativeControl=True",)),
    ("ShadowHand", "full", ("+task.env.use_capped_dof_control=True",)),
    ("ShadowHand", "openai", ("task.env.objectType=pen",)),
] + [("AllegroHand", o, ()) for o in ("full_no_vel", "full", "full_state")]


@pytest.mark.parametrize("task,obs_type,extra", HOOK_CASES)
def test_hooks_match_jax(task, obs_type, extra):
    """At states drawn from the JAX reset (joints jittered, random
    velocities, sensors, actions, progress): the reset's draws make the same
    init (`init_from_draws`); `compute_force` (the moving average, relative
    and capped targets, the random force's xfrc), `observe` in the scheme,
    `observe_state` (the asymmetric critic's full_state) and `reward_done`
    with JAX's goal and kick draws: reward, done, and the task state (goal,
    consecutive successes, hold, targets, force, the reward terms)."""
    jenv, tenv = _both(task, (f"task.env.observationType={obs_type}", *extra))
    q, qd, jtask, jsens, tsens, acts, progress = _drawn(jenv, tenv, seed=3)
    # the reset draws
    keys = jax.random.split(jax.random.PRNGKey(3), N)

    def draws(k):
        kd, kv, kp, kr, kg, kfp, _ = jax.random.split(k, 7)
        u = lambda kk, n: jax.random.uniform(kk, (n,), minval=-1.0, maxval=1.0)
        nh = jenv.num_hand_dofs
        return u(kd, nh), u(kv, nh), u(kp, 3), u(kr, 2), u(kg, 2), jax.random.uniform(kfp, ())

    iq, iqd, itask = tenv.init_from_draws(*(torch.tensor(np.asarray(a)) for a in jax.vmap(draws)(keys)))
    jq0, jqd0, _ = jax.vmap(jenv.sample_init)(keys)
    np.testing.assert_allclose(iq.numpy(), np.asarray(jq0), atol=1e-6)
    np.testing.assert_allclose(iqd.numpy(), np.asarray(jqd0), atol=1e-6)
    for k, v in _port_task(jtask).items():
        if k != "rew_terms":
            np.testing.assert_allclose(itask[k].numpy().astype(np.float64), v.numpy().astype(np.float64), atol=1e-6,
                                       err_msg=k)
    ttask = _port_task(jtask)
    ttask["rb_force"] = torch.tensor(np.random.RandomState(4).normal(size=(N, 3)).astype(np.float32))
    jtask = {**jtask, "rb_force": jnp.asarray(ttask["rb_force"].numpy())}
    tq, tqd, ta = torch.tensor(q), torch.tensor(qd), torch.tensor(acts)
    jq, jqd, ja = jnp.asarray(q), jnp.asarray(qd), jnp.asarray(acts)

    qfrc, xfrc, qt = tenv.compute_force(ta, tq, tqd, ttask)
    jqfrc, jxfrc, jqt = jax.vmap(jenv.compute_force)(ja, jq, jqd, jtask)
    for got, want, name in ((qfrc, jqfrc, "qfrc"), (xfrc, jxfrc, "xfrc"), (qt, jqt, "q_target")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=name)
    if "task.env.forceScale=1.0" in extra:
        assert float(xfrc.abs().max()) > 0.01

    from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics

    tkin, jkin = forward_kinematics(tenv.model, tq, tqd), _jax_fk(jenv.model, q, qd)
    tp, jp = torch.tensor(progress), jnp.asarray(progress)
    args_t = (tq, tqd, tkin, tsens, ttask, ta, tp)
    args_j = (jq, jqd, jkin, jsens, jtask, ja, jp)
    obs = tenv.observe(*args_t)
    jobs = jax.vmap(jenv.observe)(*args_j)
    assert obs.shape == (N, tenv.num_obs) == tuple(jobs.shape)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-4, rtol=1e-5, err_msg="observe")
    if tenv.num_states:
        st = tenv.observe_state(*args_t)
        np.testing.assert_allclose(st.numpy(), np.asarray(jax.vmap(jenv.observe_state)(*args_j)), atol=1e-4,
                                   rtol=1e-5, err_msg="observe_state")
    # a goal within tolerance in two envs: successes, a new goal from the draws
    oq = tenv.obj_q
    tq[:2, oq + 3:oq + 7] = ttask["goal_rot"][:2]
    jq = jnp.asarray(tq.numpy())
    tkin, jkin = forward_kinematics(tenv.model, tq, tqd), _jax_fk(jenv.model, tq.numpy(), qd)
    tenv.draws_of_step = lambda n: _jax_step_draws(jtask)
    rew, done, new = tenv.reward_done(obs, tq, tqd, tkin, tsens, ttask, ta, tp)
    jrew, jdone, jnew = jax.vmap(jenv.reward_done)(jobs, jq, jqd, jkin, jsens, jtask, ja, jp)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=1e-3, rtol=1e-5, err_msg="reward")
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    for k, v in _port_task(jnew).items():
        got = new[k]
        if k == "rew_terms":
            for kk in v:
                np.testing.assert_allclose(got[kk].numpy().astype(np.float32), v[kk].numpy().astype(np.float32),
                                           atol=1e-4, rtol=1e-5, err_msg=kk)
        else:
            np.testing.assert_allclose(got.numpy().astype(np.float64), v.numpy().astype(np.float64), atol=1e-5,
                                       err_msg=k)
    assert float(new["successes"][:2].min()) >= 1.0
    ex = tenv.extra_outputs(tq, tqd, tkin, tsens, new, ta, tp)
    jex = jax.vmap(jenv.extra_outputs)(jq, jqd, jkin, jsens, jnew, ja, jp)
    np.testing.assert_allclose(ex["consecutive_successes"].numpy(), np.asarray(jex["consecutive_successes"]))
    assert set(ex["episode_cumulative"]) == set(jex["episode_cumulative"])
    del tenv.draws_of_step


# ---- the physics step -----------------------------------------------------------

def _held(tenv, q, qd):
    """compute_force with the actuated setpoints held at the joints' positions."""
    idx, held = tenv.actuated_idx, q[:, tenv.hand_q_idx]
    hold = torch.clamp(maths.unscale(held[:, idx], tenv.dof_lower[idx], tenv.dof_upper[idx]), -1.0, 1.0)
    return tenv.compute_force(hold, q, qd, {"targets": held, "rb_force": torch.zeros(q.shape[0], 3)})


@pytest.mark.parametrize("task", ["ShadowHand", "AllegroHand"])
def test_plain_step_matches_jax(task):
    """At the task's `contact_states` (the object on the palm at random
    orientations; one in three flat and pushed 2-4 mm in), under setpoints
    held at the joints: the plain step against JAX
    `physics_step_fused(use_pallas=False)` on the envs
    `torch_conditioning.kept` keeps (q 2e-4, qd 2e-3, forces 2e-2). The
    rows act in the kept envs: contact force on the object; ShadowHand:
    more rows in the margin than the cap of 24 in some env."""
    from isaacgymenvs_tpu.engine import fused as jfused

    jenv, tenv = _both(task)
    n = 12
    q, qd = tenv.contact_states(n, seed=5)
    qfrc, xfrc, qt = _held(tenv, q, qd)
    m, p = tenv.model, tenv.sim_params
    s = tfused.spec_of(m)
    keys = []
    tfused._step_math_torch(s, p, "cpu", (), keys)(q.T.contiguous(), qd.T.contiguous(), qfrc.T.contiguous(),
                                                   xfrc.permute(2, 1, 0).reshape(6 * s.nbody, n), qt.T.contiguous())
    in_margin = (keys[0][0] > -p.contact_margin).sum(0)
    keep = cond.kept(cond.port_gaps(s, p, q, qd, qfrc, xfrc, qt), cond.jax_gaps(jenv.model, jenv.sim_params, q, qd,
                                                                               qfrc, xfrc, qt))
    assert int(keep.sum()) >= n // 2, keep
    tout = tfused.physics_step_fused(m, p, q, qd, qfrc, xfrc=xfrc, q_target=qt)
    jout = jfused.physics_step_fused(jenv.model, jenv.sim_params, jnp.asarray(q.numpy()), jnp.asarray(qd.numpy()),
                                     jnp.asarray(qfrc.numpy()), xfrc=jnp.asarray(xfrc.numpy()),
                                     q_target=jnp.asarray(qt.numpy()), use_pallas=False)
    k_ = keep.numpy()
    for k, tol in TOL.items():
        np.testing.assert_allclose(getattr(tout, k).numpy()[k_], np.asarray(getattr(jout, k))[k_], atol=tol,
                                   err_msg=k)
    force = np.linalg.norm(np.asarray(jout.body_force)[:, tenv.obj_body], axis=-1)[k_]
    assert (force > 0.01).mean() >= 0.5, force
    if task == "ShadowHand":
        assert int((in_margin[keep] > 24).sum()) >= 1, (in_margin, keep)


# ---- reset and env steps --------------------------------------------------------

def _fields(js):
    return {"q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf,
            "actions": js.actions, "task": jax.tree.map(np.asarray, js.task)}


@pytest.mark.parametrize("task", ["ShadowHand", "AllegroHand"])
def test_reset_and_env_steps_match_jax(task):
    """The port's observation of the JAX reset state equals the JAX reset's;
    then from the port's `contact_states`, put on both, three env steps
    (AllegroHand: two physics calls each) of gentle random actions against
    the JAX step, the port taking JAX's goal and kick draws: q, qd,
    observation, reward, done, the task state and the extras. AllegroHand's
    JAX reset and step run under `jax.jit` (op by op its step traces the
    body of its two-call control loop again on every call); ShadowHand's
    run op by op (one physics call a step, which runs in less time than it
    compiles)."""
    jenv, tenv = _both(task)
    jit = jax.jit if task == "AllegroHand" else (lambda f: f)
    jstate, jobs = jit(jenv.reset)(jax.random.PRNGKey(0))
    tstate = env_state_from_arrays(tenv.reset(0)[0], _fields(jstate), "cpu")
    obs = tenv.observe(tstate.sim.q, tstate.sim.qd, tenv._kin(tstate.sim.q, tstate.sim.qd), tenv._no_sensors(N),
                       tstate.task, tstate.actions, tstate.progress)
    np.testing.assert_allclose(torch.clamp(obs, -tenv.clip_obs, tenv.clip_obs).numpy(), np.asarray(jobs), atol=1e-5)
    q, qd = tenv.contact_states(N, seed=7)
    jstate = jstate.replace(sim=jstate.sim.replace(q=jnp.asarray(q.numpy()), qd=jnp.asarray(qd.numpy())))
    tstate = env_state_from_arrays(tstate, _fields(jstate), "cpu")
    step = jit(jenv.step)
    rng = np.random.RandomState(8)
    for k in range(3):
        a = rng.uniform(-0.1, 0.1, (N, tenv.num_acts)).astype(np.float32)
        tenv.draws_of_step = lambda n, t=jstate.task: _jax_step_draws(t)
        jstate, jobs, jrew, jdone, jex = step(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        np.testing.assert_allclose(tstate.sim.q.numpy(), np.asarray(jstate.sim.q), atol=TOL["q"], err_msg=f"q {k}")
        np.testing.assert_allclose(tstate.sim.qd.numpy(), np.asarray(jstate.sim.qd), atol=TOL["qd"],
                                   err_msg=f"qd {k}")
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-3, err_msg=f"obs {k}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-3, err_msg=f"reward {k}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        for name in ("goal_rot", "successes", "hold", "targets", "rb_force"):
            np.testing.assert_allclose(tstate.task[name].numpy().astype(np.float32),
                                       np.asarray(jstate.task[name], np.float32), atol=1e-4, err_msg=name)
        np.testing.assert_array_equal(tex["consecutive_successes"].numpy(), np.asarray(jex["consecutive_successes"]))
        np.testing.assert_array_equal(tex["time_outs"].numpy(), np.asarray(jex["time_outs"]))
    del tenv.draws_of_step
    assert bool(torch.isfinite(tstate.sim.q).all()) and tobs.shape == (N, tenv.num_obs)


# ---- configs, noise and the dict observations -----------------------------------

VARIANTS = {"ShadowHand": ("ShadowHand", 16384, 211, 0, 600, 1),
            "ShadowHandOpenAI_FF": ("ShadowHand", 16384, 42, 211, 160, 3),
            "ShadowHandOpenAI_LSTM": ("ShadowHand", 8192, 42, 211, 160, 3),
            "ShadowHandTest": ("ShadowHand", 256, 42, 211, 1600, 3),
            "AllegroHand": ("AllegroHand", 16384, 88, 0, 600, 2),
            "AllegroHandFF": ("AllegroHand", 16384, 50, 88, 482, 2),
            "AllegroHandLSTM": ("AllegroHand", 16384, 50, 88, 482, 2),
            "AllegroHandLSTM_Big": ("AllegroHand", 16384, 50, 88, 482, 2)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_configs_match_jax(variant, monkeypatch):
    """Each variant yaml: the port's `load_config` equals the JAX package's
    dict (but for the device flags); the class it names, its width, the
    observation and state dims, the episode length (`resetTime` overrides
    it) and controlFrequencyInv, the same on both envs."""
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg, jcfg = load_config([f"task={variant}"]), jload([f"task={variant}"])
    for c in (cfg, jcfg):
        for k in ("sim_device", "rl_device", "device"):
            c.pop(k, None)
    assert cfg == jcfg
    name, width, nobs, nstates, length, cfi = VARIANTS[variant]
    assert cfg["task"]["name"] == name and cfg["task"]["env"]["numEnvs"] == width
    jenv, tenv = _both(variant)
    assert (tenv.num_obs, tenv.num_states, tenv.max_episode_length, tenv.control_freq_inv) == \
        (jenv.num_obs, jenv.num_states, jenv.max_episode_length, jenv.control_freq_inv) == (nobs, nstates, length, cfi)
    assert (tenv.randomizer is None) == (jenv.randomizer is None) == (not cfg["task"]["task"]["randomize"])


def test_recipe_chains_match_jax():
    """The seven ShadowHand recipes and the four AllegroHand ones load as
    in the JAX package (tests/test_config.py:59-80): the OpenAI feed-forward
    recipe inherits ShadowHandPPO and the asymmetric critic with a [400,
    400, 200, 100] MLP; the LSTM recipes carry `network.rnn`."""
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.utils.config import load_config

    recipes = {"ShadowHand": ["ShadowHandPPO", "ShadowHandPPOAsymm", "ShadowHandPPOLSTM", "ShadowHandPPOAsymmLSTM",
                              "ShadowHandOpenAIPPO", "ShadowHandOpenAI_FFPPO", "ShadowHandOpenAI_LSTMPPO"],
               "AllegroHand": ["AllegroHandPPO", "AllegroHandFFPPO", "AllegroHandLSTMPPO", "AllegroHandLSTM_BigPPO"]}
    for task, names in recipes.items():
        for r in names:
            got = load_config([f"task={task}", f"train={r}"])["train"]
            assert got == jload([f"task={task}", f"train={r}"])["train"], r
            assert bool(got["params"]["network"].get("rnn")) == ("LSTM" in r), r
    p = load_config(["task=ShadowHand", "train=ShadowHandOpenAI_FFPPO"])["train"]["params"]
    assert p["network"]["mlp"]["units"] == [400, 400, 200, 100] and "central_value_config" in p["config"]


def test_per_key_observation_noise():
    """The port's counterpart of tests/test_dr.py:171: AllegroHandLSTM's
    per-key noise dicts noise only their slice of the flat observation
    (`obs_spec`), the other keys come through untouched."""
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = load_config(["task=AllegroHandLSTM", "num_envs=4"])["task"]
    cfg["task"]["randomization_params"]["observations"] = {
        "dof_pos": {"range": [0, 0.01], "operation": "additive", "distribution": "gaussian"},
        "goal_pose": {"range": [0, 0.01], "operation": "additive", "distribution": "gaussian"},
    }
    env = task_map["AllegroHand"](cfg, device="cpu")
    rz = env.randomizer
    assert set(rz.obs_key_specs) == {"dof_pos", "goal_pose"}
    out = rz.observation_noise(torch.Generator().manual_seed(0), torch.zeros(4, env.num_obs), 0).numpy()
    spec = env.obs_spec()
    for k in ("dof_pos", "goal_pose"):
        off, size = spec[k]
        assert np.abs(out[:, off:off + size]).max() > 0, k
    for k in ("object_pose_cam", "goal_relative_rot_cam", "last_actions"):
        off, size = spec[k]
        assert np.abs(out[:, off:off + size]).max() == 0, k


def test_dict_observation_api():
    """`observation_dict_space`, `obs_dict`, `reset_dict` and `step_dict`:
    AllegroHandLSTM's no-velocity observation as the reference's five keys,
    the same as JAX's view of the same flat batch; a task without an
    obs_spec (ShadowHand) as {"obs": obs}."""
    jenv, tenv = _both("AllegroHandLSTM")
    assert tenv.observation_dict_space == jenv.observation_dict_space == {
        "dof_pos": 16, "object_pose_cam": 7, "goal_pose": 7, "goal_relative_rot_cam": 4, "last_actions": 16}
    state, d = tenv.reset_dict(0)
    assert {k: tuple(v.shape) for k, v in d.items()} == {k: (N, n) for k, n in tenv.observation_dict_space.items()}
    state, d2, rew, done, ex = tenv.step_dict(state, torch.zeros(N, 16))
    flat = torch.cat([d2[k] for k in tenv.observation_dict_space], -1)
    assert flat.shape == (N, tenv.num_obs) and rew.shape == (N,) and "time_outs" in ex
    jd = jenv.obs_dict(jnp.asarray(flat.numpy()))
    assert all(np.array_equal(np.asarray(jd[k]), d2[k].numpy()) for k in d2)
    _, sh = _both("ShadowHand")
    assert sh.observation_dict_space is None and set(sh.reset_dict(0)[1]) == {"obs"}


# ---- tests/test_shadow_hand.py, the port's counterparts -------------------------

def _make(obs_type="full_state", n=2, **env_kw):
    from isaacgymenvs_tpu_torch.tasks import task_map

    cfg = {"env": {"numEnvs": n, "clipActions": 1.0, "clipObservations": 5.0, "observationType": obs_type, **env_kw},
           "sim": {"dt": 1 / 60, "substeps": 2}}
    return task_map["ShadowHand"](cfg, device="cpu")


@pytest.mark.parametrize("obs_type,dim", [("openai", 42), ("full_no_vel", 77), ("full", 157), ("full_state", 211)])
def test_obs_schemes(obs_type, dim):
    env = _make(obs_type)
    assert env.num_obs == dim
    state, obs = env.reset(0)
    assert obs.shape == (2, dim) and bool(torch.isfinite(obs).all())


def test_object_rests_on_palm():
    """From a reset, 60 zero-action steps under ShadowHand.yaml: the object
    falls from 0.6 onto the palm (0.51-0.55) and stays, in 14 of 16 envs or
    more (the share chip_smoke.py holds the kernel to at 16,384 envs is
    0.88). The JAX test's minimal config (4 position iterations, no cap, a
    contact offset of 0.02) drops the object in more of the stand-in's envs."""
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    env = task_map["ShadowHand"](load_config(["task=ShadowHand", "num_envs=16"])["task"], device="cpu")
    state, obs = env.reset(1)
    ended = torch.zeros(16, dtype=torch.bool)
    for _ in range(60):
        state, obs, rew, done, ex = env.step(state, torch.zeros(16, 20))
        ended |= done
    z = state.sim.q[:, env.obj_q + 2]
    assert int(((z > 0.45) & (z < 0.58) & ~ended).sum()) >= 14, z


def test_goal_resampled_on_success():
    env = _make()
    state, obs = env.reset(2)
    goal = state.task["goal_rot"].clone()
    state.sim.q[:, env.obj_q + 3:env.obj_q + 7] = goal
    state, obs, rew, done, ex = env.step(state, torch.zeros(2, 20))
    assert bool((rew > 100).all()) and float(state.task["successes"].min()) >= 1
    assert bool(((state.task["goal_rot"] * goal).sum(-1).abs() < 0.999).all())


def test_fall_triggers_reset():
    env = _make()
    state, obs = env.reset(3)
    state.sim.q[:, env.obj_q + 2] = 0.2
    state, obs, rew, done, ex = env.step(state, torch.zeros(2, 20))
    assert bool(done.all())


def test_consecutive_success_counting_and_max_reset():
    """Successes accumulate across goal-only resets, the episode ends at
    maxConsecutiveSuccesses, and the counter starts over after the reset."""
    env = _make(maxConsecutiveSuccesses=2)
    state, obs = env.reset(5)

    def force_goal(state):
        state.sim.q[:, env.obj_q + 3:env.obj_q + 7] = state.task["goal_rot"]
        return state

    state, obs, rew, done, ex = env.step(force_goal(state), torch.zeros(2, 20))
    assert float(state.task["successes"].min()) >= 1 and not bool(done.any())
    state, obs, rew, done, ex = env.step(force_goal(state), torch.zeros(2, 20))
    assert bool(done.all()) and "consecutive_successes" in ex
    state, obs, rew, done, ex = env.step(state, torch.zeros(2, 20))
    assert float(state.task["successes"].max()) == 0
