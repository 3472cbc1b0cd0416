"""The port's IndustReal family (PegsInsert, GearsInsert) against the JAX
package, on the CPU: the algorithm layer (SAPU, the SDF reward, SBC, the
engagement and insertion checks), the generated meshes, both models with
their SDF grids, `sdf_dyn`, `compute_force`, the plain step, reset from the
JAX package's draws and three env steps, and the runtime's
`population_update` hook.

The meshes are written by
isaacgymenvs_tpu_torch/assets/industreal/make_industreal_meshes.py; the JAX
package reads them through $ISAACGYMENVS_TPU_ASSETS. The JAX package steps
GearsInsert on its eager engine: its fused path refuses the model
(`fused_supported`: the top-K residents of 228 rows under a cap of 64 pass
its VMEM budget). The port steps it through its kernel, so the Gears env
steps are held against the JAX env with `_fused_cap_cache = True` set on the
instance (its fused math, run by XLA), and the plain step against JAX
`physics_step_fused(use_pallas=False)` on the same planes.

Tolerances: models equal within 1e-6; the algorithm layer's transforms
within 1e-7, interpenetration depths within 1e-6; the SDF reward through
its mean outside distance, exp(-reward), within 1e-6 m absolutely, and the
reward itself within 1e-4 relatively where that mean is at least 1e-5 m
(below, -log magnifies float32 rounding: the reward is compared only
through the mean); `sdf_dyn` within 1e-5 (frames 3e-6 in the median row,
3e-4 in all); the plain step as tests/test_fused.py:79-82
(q 2e-4, qd 2e-3, forces 2e-2); `compute_force` rtol 1e-4; the reset's
IK (24 damped least-squares iterations, batched here where JAX scans per
env) within 1e-5 on q (2.0e-6 measured); env steps q 2e-4, qd 2e-3,
observations 1e-4 (the privileged state's velocities 2e-3), rewards 1e-3
relative (SAPU's scale, 1 - tanh(depth / 1 mm), moves by 1e-3 per
micrometre of depth, and the packages' states lie up to a micrometre apart
after a step), done flags, the task state (its last reward as the
rewards) and the extras equal.
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
from isaacgymenvs_tpu_torch.tasks import industreal_algo as talgo
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
import torch_conditioning as cond
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

N = 4
N_STATES = 8  # contact states of the physics-step comparison
TASKS = ["IndustRealTaskPegsInsert", "IndustRealTaskGearsInsert"]
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
MESHES = os.path.join(package_asset_root(), "industreal")
# the env steps' configuration: a short episode, so that the last step's
# bonus, the SBC scale and the population update act within three env
# steps; the plug (the gear) spawned 5-10 mm into the hole (onto the shaft),
# as the JAX package's slow tests spawn it: a plug falling free onto the
# socket's top tumbles, and one step then turns 1e-6 of float32 rounding
# into 2e-2 of its angular velocity (the pads do not reach the 8 mm peg:
# their points lie 6 mm to either side of the finger's midline); the
# curriculum's thresholds set so that every success rate takes the easier
# branch, from 0.01 to its easy bound 0.012 (the branches are held against
# JAX's in test_population_update_sbc_matches_jax);
# one substep of 4 APGD iterations (the yaml's 2 x 64 halve the JAX step's
# compile time; the plain-step test holds the yaml's)
SHORT = ["task.env.episodeLength=6", "task.rl.max_episode_length=6", "task.rl.initial_max_disp=0.01",
         "task.rl.curriculum_height_bound=[0.005,0.012]", "task.rl.curriculum_success_thresh=1.0",
         "task.rl.curriculum_failure_thresh=1.01", "task.sim.substeps=1",
         "task.sim.physx.num_position_iterations=1"]


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


def _both(task, short=False):
    """The JAX env and the port's env of `task` at N envs (built once per
    worker); `short` with the SHORT episode. The JAX GearsInsert env takes
    its fused path (see the module docstring)."""
    key = (task, short)
    if key not in _ENVS:
        from isaacgymenvs_tpu.tasks import task_map as jtasks
        from isaacgymenvs_tpu.utils.config import load_config as jload
        from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
        from isaacgymenvs_tpu_torch.utils.config import load_config as tload

        args = [f"task={task}", f"num_envs={N}", *(SHORT if short else ())]
        jcfg = jload(args)["task"]
        jcfg["sim"]["use_fused"] = True
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
            jenv = jtasks[task](jcfg)
            jenv._fused_cap_cache = True
            _ENVS[key] = (jenv, ttasks[task](tload(args)["task"], device="cpu"))
    return _ENVS[key]


def _box_grids(half=0.1, res=64):
    from isaacgymenvs_tpu.sdf.builder import mesh_to_sdf as jmesh_to_sdf
    from isaacgymenvs_tpu_torch.sdf.builder import mesh_to_sdf
    from test_sdf import _cube_mesh

    v, f = _cube_mesh(half)
    return mesh_to_sdf(v, f, resolution=res), jmesh_to_sdf(v, f, resolution=res)


# ---- the algorithm layer: the counterparts of tests/test_industreal.py:21-100 ----

IDENT = torch.tensor([[0.0, 0, 0, 1.0]])
ZERO = torch.zeros(1, 3)


def test_max_interpen_hand_computed():
    """A point 3 cm inside a box of half-width 10 cm reads about 3 cm of
    interpenetration; points outside read 0, also when the socket moves
    away (get_max_interpen_dists :98-155); as the JAX package's values."""
    from isaacgymenvs_tpu.tasks import industreal_algo as jalgo

    grid, jgrid = _box_grids()
    inside = torch.tensor([[0.0, 0.0, 0.07]])
    d = talgo.max_interpen_dist(inside, ZERO, IDENT, ZERO, IDENT, grid)
    assert d.shape == (1,) and abs(float(d[0]) - 0.03) < 0.006
    jd = jalgo.max_interpen_dist(jnp.asarray(inside.numpy()), jnp.zeros(3), jnp.array([0.0, 0, 0, 1]), jnp.zeros(3),
                                 jnp.array([0.0, 0, 0, 1]), jgrid)
    assert abs(float(d[0]) - float(jd)) < 1e-6
    assert float(talgo.max_interpen_dist(torch.tensor([[0.0, 0.0, 0.2]]), ZERO, IDENT, ZERO, IDENT, grid)[0]) == 0.0
    away = torch.tensor([[0.5, 0.0, 0.0]])
    assert float(talgo.max_interpen_dist(inside, ZERO, IDENT, away, IDENT, grid)[0]) == 0.0


def test_sapu_scale_hand_computed():
    low, s = talgo.sapu_reward_scale(torch.tensor([0.0005, 0.002]), 0.001)
    assert low.tolist() == [True, False] and abs(float(s[0]) - (1 - np.tanh(0.5))) < 1e-6


def test_sdf_reward_increases_toward_goal():
    """-log(mean outside distance) grows as the points near their goal pose;
    at dz = 0.05 the mean is 0.1 / 3 (get_sdf_reward :237-275); each value
    as the JAX package's."""
    from isaacgymenvs_tpu.tasks import industreal_algo as jalgo

    grid, jgrid = _box_grids()
    pts = torch.tensor([[0.1, 0.1, 0.1], [-0.1, -0.1, -0.1], [0.1, -0.1, 0.1]])
    dz = torch.tensor([0.1, 0.05, 0.02, 0.0])
    pos = torch.stack([torch.zeros(4), torch.zeros(4), dz], -1)
    rews = talgo.sdf_reward(pts, pos, IDENT.expand(4, 4), ZERO.expand(4, 3), IDENT.expand(4, 4), grid)
    assert rews.tolist() == sorted(rews.tolist())
    assert abs(float(rews[1]) - (-np.log(0.1 / 3))) < 0.35
    for i in range(4):
        jr = jalgo.sdf_reward(jnp.asarray(pts.numpy()), jnp.array([0.0, 0.0, float(dz[i])]), jnp.array([0.0, 0, 0, 1]),
                              jnp.zeros(3), jnp.array([0.0, 0, 0, 1]), jgrid)
        assert abs(float(np.exp(-float(rews[i]))) - float(np.exp(-float(jr)))) < 1e-6


def test_sbc_new_max_disp_hand_computed():
    """The three branches and both clamps, batched: harder, clamped at the
    hard bound, easier clamped at the easy bound, unchanged."""
    bound, step = torch.tensor([-0.01, 0.01]), torch.tensor([-0.005, 0.003])
    succ = torch.tensor([0.8, 0.9, 0.1, 0.6])
    disp = torch.tensor([0.01, -0.008, 0.009, 0.002])
    got = talgo.new_max_disp(succ, disp, bound, step, 0.75, 0.5)
    np.testing.assert_allclose(got.numpy(), [0.005, -0.01, 0.01, 0.002], atol=1e-7)


def _stand_in_grids(which):
    """(port grid, JAX grid, sample points) of a stand-in's SAPU or reward grid."""
    if which == "pegs":
        from isaacgymenvs_tpu.tasks import industreal_pegs_insert as jm
        from isaacgymenvs_tpu_torch.tasks import industreal_pegs_insert as tm

        return ((tm.socket_sdf_grid(), tm.plug_sdf_grid()), (jm.socket_sdf_grid(), jm.plug_sdf_grid()),
                tm.plug_sample_points())
    from isaacgymenvs_tpu.tasks import industreal_gears_insert as jm
    from isaacgymenvs_tpu_torch.tasks import industreal_gears_insert as tm

    return ((tm.shaft_sdf_grid(), tm.gear_sdf_grid()), (jm.shaft_sdf_grid(), jm.gear_sdf_grid()),
            tm.gear_sample_points())


@pytest.mark.parametrize("which", ["box", "pegs", "gears"])
def test_algo_layer_matches_jax(which):
    """Every function of the algorithm layer, batched over 64 envs, against
    the JAX package's vmapped over the same inputs: plug poses from assembled
    to 30 mm above and 2 mm aside, tilted by up to 2 degrees, sockets
    yawed; on a box grid (points on its surface) and on each stand-in's SAPU
    and reward grids (its sample points). The grids of both packages are
    equal; the SAPU flags and the checks equal."""
    from isaacgymenvs_tpu.tasks import industreal_algo as jalgo

    if which == "box":
        grid, jgrid = _box_grids()
        grids, jgrids = (grid, grid), (jgrid, jgrid)
        pts = np.random.RandomState(1).uniform(-0.1, 0.1, (40, 3)).astype(np.float32)
        pts[np.arange(40), np.arange(40) % 3] = np.sign(pts[np.arange(40), np.arange(40) % 3]) * 0.1
    else:
        grids, jgrids, pts = _stand_in_grids(which)
        for tg, jg in zip(grids, jgrids):
            np.testing.assert_array_equal(tg.values.numpy(), np.asarray(jg.values))
            np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    rng, n = np.random.RandomState(2), 64
    socket_pos = np.stack([rng.uniform(0.4, 0.6, n), rng.uniform(-0.1, 0.1, n), rng.uniform(0.0, 0.05, n)], -1)
    yaw = rng.uniform(-0.1, 0.1, n)
    socket_quat = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    lift = np.where(np.arange(n) % 4 == 0, 0.0, rng.uniform(0.0, 0.03, n))
    aside = np.where(np.arange(n) % 4 == 0, 0.0, rng.uniform(-0.002, 0.002, n))
    plug_pos = socket_pos + np.stack([aside, -aside, lift], -1)
    axis = rng.normal(size=(n, 3)) * [1, 1, 0.2]
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    tilt = np.deg2rad(rng.uniform(0, 2, n)) * (np.arange(n) % 4 != 0)
    plug_quat = np.concatenate([axis * np.sin(tilt / 2)[:, None], np.cos(tilt / 2)[:, None]], -1)
    f32 = lambda a: np.asarray(a, np.float32)
    t = [torch.tensor(f32(a)) for a in (plug_pos, plug_quat, socket_pos, socket_quat)]
    j = [jnp.asarray(f32(a)) for a in (plug_pos, plug_quat, socket_pos, socket_quat)]
    tp, jp = torch.tensor(pts), jnp.asarray(pts)

    world = talgo.transform_points(t[0], t[1], tp)
    jworld = jax.vmap(lambda p, q: jalgo.transform_points(p, q, jp))(j[0], j[1])
    np.testing.assert_allclose(world.numpy(), np.asarray(jworld), atol=1e-7)
    local = talgo.points_into_frame(t[2], t[3], world)
    np.testing.assert_allclose(local.numpy(), np.asarray(jax.vmap(jalgo.points_into_frame)(j[2], j[3], jworld)),
                               atol=1e-7)

    interp = talgo.max_interpen_dist(tp, *t, grids[0])
    jinterp = jax.vmap(lambda *a: jalgo.max_interpen_dist(jp, *a, jgrids[0]))(*j)
    np.testing.assert_allclose(interp.numpy(), np.asarray(jinterp), atol=1e-6)
    low, scale = talgo.sapu_reward_scale(interp, 0.001)
    jlow, jscale = jalgo.sapu_reward_scale(jinterp, 0.001)
    np.testing.assert_array_equal(low.numpy(), np.asarray(jlow))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), atol=1e-6)

    rew = talgo.sdf_reward(tp, *t, grids[1])
    jrew = np.asarray(jax.vmap(lambda *a: jalgo.sdf_reward(jp, *a, jgrids[1]))(*j))
    mean, jmean = np.exp(-rew.numpy().astype(np.float64)), np.exp(-jrew.astype(np.float64))
    np.testing.assert_allclose(mean, jmean, atol=1e-6)
    far = jmean >= 1e-5
    assert far.sum() >= n // 2
    np.testing.assert_allclose(rew.numpy()[far], jrew[far], rtol=1e-4)

    kp_off = talgo.keypoint_offsets(4, 0.5)
    np.testing.assert_allclose(kp_off.numpy(), np.asarray(jalgo.keypoint_offsets(4, 0.5)), atol=1e-7)
    kp_a = talgo.transform_points(t[0], t[1], kp_off)
    kp_b = talgo.transform_points(t[2], t[3], kp_off)
    jkp_a = jax.vmap(lambda p, q: jalgo.transform_points(p, q, jalgo.keypoint_offsets(4, 0.5)))(j[0], j[1])
    jkp_b = jax.vmap(lambda p, q: jalgo.transform_points(p, q, jalgo.keypoint_offsets(4, 0.5)))(j[2], j[3])
    top = t[2] + torch.tensor([0.0, 0.0, 0.028])
    for thresh in (0.01, 0.05):
        close = talgo.check_close(kp_a, kp_b, thresh)
        np.testing.assert_array_equal(close.numpy(), np.asarray(jax.vmap(
            lambda a, b: jalgo.check_close(a, b, thresh))(jkp_a, jkp_b)))
        eng = talgo.check_plug_engaged(t[0], top, kp_a, kp_b, 0.003, thresh)
        jeng = jax.vmap(lambda p, s, a, b: jalgo.check_plug_engaged(p, s, a, b, 0.003, thresh))(
            j[0], jnp.asarray(top.numpy()), jkp_a, jkp_b)
        np.testing.assert_array_equal(eng.numpy(), np.asarray(jeng))
        ins = talgo.check_plug_inserted(t[0], t[2], kp_a, kp_b, 0.003, thresh)
        np.testing.assert_array_equal(ins.numpy(), np.asarray(jax.vmap(
            lambda p, s, a, b: jalgo.check_plug_inserted(p, s, a, b, 0.003, thresh))(j[0], j[2], jkp_a, jkp_b)))
        assert 0 < int(eng.sum()) < n
        es = talgo.engagement_reward_scale(t[0], t[2], eng, 0.003)
        jes = jax.vmap(lambda p, s, e: jalgo.engagement_reward_scale(p, s, e, 0.003))(j[0], j[2], jeng)
        np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-6)
    disp = torch.tensor(rng.uniform(-0.01, 0.01, n).astype(np.float32))
    bound = torch.tensor([-0.01, 0.01])
    np.testing.assert_allclose(talgo.curriculum_reward_scale(disp, bound).numpy(), np.asarray(
        jalgo.curriculum_reward_scale(jnp.asarray(disp.numpy()), jnp.asarray(bound.numpy()))), atol=1e-6)


def test_population_update_sbc_matches_jax():
    """PegsInsert's `population_update` against the JAX package's on the same
    full-batch task states: the success rate over the envs at their last
    step moves every env's max displacement harder (a rate above 0.75),
    easier (below 0.5, clamped at the easy bound) or not at all (between),
    and a step where no env ends leaves it unchanged."""
    jenv, tenv = _both("IndustRealTaskPegsInsert")
    last = tenv.max_episode_length - 1
    disp = np.array([0.004, -0.008, 0.009, 0.0], np.float32)
    cases = [  # (progress, success): the rate over the envs at their last step
        ([last, last, last, last], [1, 1, 1, 0]),  # 0.75: unchanged (not above 0.75)
        ([last, last, 3, last], [1, 1, 0, 1]),  # 1.0: harder
        ([last, 2, last, 5], [0, 1, 0, 1]),  # 0.33: easier
        ([last, last, 7, 7], [1, 0, 1, 1]),  # 0.5: unchanged
        ([1, 2, 3, 4], [1, 1, 1, 1]),  # none ends: unchanged
    ]
    moved = set()
    for prog, succ in cases:
        task = {"max_disp": disp, "obs_noise": np.zeros((N, 3), np.float32), "prev_rew": np.zeros(N, np.float32),
                "success": np.asarray(succ, np.float32), "engaged": np.zeros(N, np.float32)}
        tout = tenv.population_update({k: torch.tensor(v) for k, v in task.items()}, None,
                                      torch.tensor(prog, dtype=torch.int32))
        jout = jenv.population_update({k: jnp.asarray(v) for k, v in task.items()}, None,
                                      jnp.asarray(prog, jnp.int32))
        for k in task:
            np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
        moved.add(tuple(np.sign(np.round((tout["max_disp"].numpy() - disp) * 1e6)).astype(int).tolist()))
    assert (0, 0, 0, 0) in moved and (-1, -1, -1, -1) in moved and (1, 1, 1, 1) in moved


# ---- the generated meshes ---------------------------------------------------------

def test_meshes_are_the_scripts_output_and_give_jaxs_points(tmp_path, monkeypatch):
    """The committed OBJ files are what make_industreal_meshes.py writes, and
    every mesh is closed (each edge in two faces, the two ways round). The
    points of both packages on them are equal: the plug's 76 contact points
    (36 in the tip rings, 40 up the shaft) and 112 sample points; the gear's
    50 bore points (5 x 10 bins, within 1.5 mm of the bore), 24 bottom
    points (12 on the hub ring 10 mm out, 12 on the teeth's bottom edge) and
    100 sample points."""
    from isaacgymenvs_tpu.tasks import industreal_gears_insert as jg
    from isaacgymenvs_tpu.tasks import industreal_pegs_insert as jp
    from isaacgymenvs_tpu_torch.sdf.builder import load_obj
    from isaacgymenvs_tpu_torch.tasks import industreal_gears_insert as tg
    from isaacgymenvs_tpu_torch.tasks import industreal_pegs_insert as tp

    spec = importlib.util.spec_from_file_location("make_industreal_meshes",
                                                  os.path.join(MESHES, "make_industreal_meshes.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    names = ["industreal_pegs/industreal_round_peg_8mm.obj",
             "industreal_pegs/industreal_tray_insert_round_peg_8mm.obj",
             "industreal_gears/industreal_gear_base.obj", "industreal_gears/industreal_gear_medium.obj"]
    committed = {n: open(os.path.join(gen.OUT, n)).read() for n in names}
    monkeypatch.setattr(gen, "OUT", str(tmp_path))
    gen.main()
    assert {n: open(tmp_path / n).read() for n in names} == committed
    for name in names:
        v, t = load_obj(os.path.join(gen.OUT, name))
        edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        fwd = {tuple(e) for e in edges.tolist()}
        assert len(fwd) == len(edges) and all((b, a) in fwd for a, b in fwd), name

    cp = tp.plug_contact_points()
    np.testing.assert_array_equal(cp, jp.plug_contact_points())
    np.testing.assert_array_equal(tp.plug_sample_points(), jp.plug_sample_points())
    assert cp.shape == (76, 3) and int((cp[:, 2] < tp.PLUG_BASE_Z + 0.006).sum()) == 36
    assert tp.plug_sample_points().shape == (112, 3)
    np.testing.assert_allclose(np.linalg.norm(cp[:, :2], axis=1), tp.PLUG_DIAMETER / 2, atol=1e-6)
    bore, bottom = tg.gear_contact_points()
    jbore, jbottom = jg.gear_contact_points()
    np.testing.assert_array_equal(bore, jbore)
    np.testing.assert_array_equal(bottom, jbottom)
    np.testing.assert_array_equal(tg.gear_sample_points(), jg.gear_sample_points())
    assert bore.shape == (50, 3) and bottom.shape == (24, 3) and tg.gear_sample_points().shape == (100, 3)
    r = lambda p: np.hypot(p[:, 0] - tg.GEAR_CENTER[0], p[:, 1])
    np.testing.assert_allclose(r(bore), 0.005, atol=1e-6)
    np.testing.assert_allclose(r(bottom[:12]), 0.010, atol=1e-6)
    assert (r(bottom[12:]) > 0.019).all() and np.allclose(bottom[:, 2], tg.GEAR_BOTTOM_Z)
    np.testing.assert_array_equal(tg.PAD_POINTS_DENSE, jg.PAD_POINTS_DENSE)
    from isaacgymenvs_tpu_torch.tasks.factory_nut_bolt import PAD_POINTS_DENSE as NUT_BOLT_PADS

    assert tg.PAD_POINTS_DENSE.shape == (20, 3) and NUT_BOLT_PADS.shape == (42, 3)


# ---- the models ----------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_models_match_jax(task):
    """`compose` of the Franka, the plug (gear) and the socket (base) on its
    slides and yaw hinge, every automatic point stripped, then the task's
    points and grids: every leaf of the two models equal, the grids
    included. PegsInsert: 88 points (76 on the plug, 6 on each pad), the
    socket's grid (192) for the plug's, the plug's (128) for the pads', cap
    32 of 176 rows, 8 envs per block (4,940 floats per env). GearsInsert: 114
    points (50 bore, 24 bottom, 20 per pad), three grids, the shaft's crop
    (192) and the whole base (256) on the base's yaw body and the gear's
    (160), cap 64 of 228 rows, 4 envs per block (7,660 floats per env).
    17 bodies, nq 20, nv 19; every point also a plane row; the SDF row
    order as the pairs were declared. The JAX fused path admits PegsInsert
    and refuses GearsInsert."""
    jenv, tenv = _both(task)
    _assert_models_equal(tenv.model, jenv.model)
    m, p = tenv.model, tenv.sim_params
    s = tfused.spec_of(m)
    gears = "Gears" in task
    ncp, cap, floats, epb = (114, 64, 7660, 4) if gears else (88, 32, 4940, 8)
    assert (m.nbody, m.nq, m.nv, m.ncp, s.nc, s.sp_n) == (17, 20, 19, ncp, ncp, ncp)
    assert tfused.topk_cap(s, p) == cap and tfused.unsupported_features(m, p) == []
    plug, socket = tenv.plug_body, tenv.socket_body
    assert (plug, socket) == (jenv.plug_body, jenv.socket_body)
    lf, rf = m.body_names.index("panda_leftfinger"), m.body_names.index("panda_rightfinger")
    if gears:
        assert m.sdf_body == (socket, socket, plug)
        assert s.sp_b.tolist() == [socket] * 74 + [plug] * 40
        assert list(m.spair_sdf) == [0] * 50 + [1] * 24 + [2] * 40
    else:
        assert m.sdf_body == (socket, plug)
        assert s.sp_b.tolist() == [socket] * 76 + [plug] * 12
    assert set(s.sp_a[-(ncp - (74 if gears else 76)):].tolist()) == {lf, rf}
    assert [tuple(r) for r in (tenv.franka_ref, tenv.plug_ref, tenv.socket_ref)] == \
        [tuple(r) for r in (jenv.franka_ref, jenv.plug_ref, jenv.socket_ref)]
    assert (tenv.pq, tenv.pv, tenv.sq) == (jenv.pq, jenv.pv, jenv.sq)
    np.testing.assert_array_equal(tenv.q_idx.numpy(), np.asarray(jenv.q_idx))
    np.testing.assert_array_equal(tenv.v_idx.numpy(), np.asarray(jenv.v_idx))
    np.testing.assert_allclose(tenv.sample_pts.numpy(), np.asarray(jenv.sample_pts), atol=0)
    np.testing.assert_allclose(tenv.keypoint_offsets.numpy(), np.asarray(jenv.keypoint_offsets), atol=1e-7)
    np.testing.assert_allclose(tenv.effort_limit.numpy(), np.asarray(jenv.effort_limit), atol=1e-6)
    np.testing.assert_allclose(tenv.task_kp.numpy(), np.asarray(jenv.task_kp))
    np.testing.assert_allclose(tenv.engage_top.numpy()[2], jenv.engage_top_offset, rtol=1e-7)
    assert tenv.engage_base_height == jenv.engage_base_height
    assert _cuda.env_floats(s, True, (), cap) == floats
    smem = {e: _cuda.smem_bytes(s, p, e, has_qt=True) for e in (8, 4, 2, 1)}
    assert _cuda.envs_per_block(lambda e: smem[e], _cuda.SMEM_OPTIN_BYTES, _cuda.plan_regs(s.nv)) == epb
    assert jenv._fused_capable and jenv.use_fused is True
    from isaacgymenvs_tpu.engine import fused as jfused

    assert jfused.fused_supported(jenv.model, jenv.sim_params, None) == (not gears)


# ---- the physics step ----------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_sdf_dyn_compute_force_and_plain_step_match_jax(task):
    """At the task's `contact_states` (the plug in the hole against its wall
    or on its floor; the gear's bore against the shaft, resting on the plate
    or up the shaft; the pads on the plug or the teeth): `sdf_dyn` of both
    packages (two or three grids, the socket's on the yaw body of three
    slides), each on its own forward kinematics (JAX's jitted), points and
    depths within 1e-5, frames within 3e-6 in the median row and 3e-4 in
    all (the central-difference normal turns by up to 1.5e-4 where a voxel
    holds a mesh edge, tests/test_torch_nut_bolt.py);
    `compute_force` under random actions (task-space impedance, the effort
    clip, the gravity compensation, the closed gripper's setpoints) within
    rtol 1e-4; the plain step on the JAX package's planes against JAX
    `physics_step_fused(use_pallas=False)`: q 2e-4, qd 2e-3, forces 2e-2,
    on the envs `torch_conditioning.kept` keeps (an env is dropped only
    where both packages' float32 steps lie more than COND_TOL from
    float64: float32 does not determine its step to the tolerance). The
    rows act in the kept envs: more than the cap's slots are in the margin
    in some env (GearsInsert: more than 32 where the gear rests on the
    plate, and in two envs or more), and the grids' bodies take contact
    force in the step's last slice, the one it reports, in some env (a plug
    pushed into a wall is pushed out of it within the first slice)."""
    from isaacgymenvs_tpu.engine import fused as jfused

    jenv, tenv = _both(task)
    jm, tm = jenv.model, tenv.model
    n = N_STATES
    q, qd = tenv.contact_states(n, seed=5)
    jq, jqd = jnp.asarray(q.numpy()), jnp.asarray(qd.numpy())
    jdyn = jax.jit(lambda q_, qd_: jfused.sdf_dyn(jm, q_, qd_))(jq, jqd)
    tdyn = tfused.sdf_dyn(tm, q, qd)
    frame_err = []
    for k in tfused.SP_KEYS:
        err = np.abs(tdyn[k].numpy() - np.asarray(jdyn[k]))
        if k[:5] in ("_sp_p", "_sp_x"):
            assert err.max() < 1e-5, (k, err.max())
        else:
            frame_err.append(err)
    frame_err = np.max(frame_err, 0)
    assert np.median(frame_err) < 3e-6 and frame_err.max() < 3e-4, (np.median(frame_err), frame_err.max())

    a = np.random.RandomState(6).uniform(-1, 1, (n, 6)).astype(np.float32)
    qfrc, xfrc, qt = tenv.compute_force(torch.tensor(a), q, qd, None)
    jqfrc, jxfrc, jqt = jax.vmap(jenv.compute_force)(jnp.asarray(a), jq, jqd, jnp.zeros(n))
    scale = float(np.abs(np.asarray(jqfrc)).max())
    assert scale > 0.05
    np.testing.assert_allclose(qfrc.numpy(), np.asarray(jqfrc), rtol=1e-4, atol=1e-4 * scale, err_msg="qfrc")
    np.testing.assert_allclose(xfrc.numpy(), np.asarray(jxfrc), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(jqt))

    p = tenv.sim_params
    s = tfused.spec_of(tm)
    keys = []
    run = tfused._step_math_torch(s, p, "cpu", (), keys)
    rows = lambda t: t.T.contiguous()
    planes = {k: torch.tensor(np.asarray(v)) for k, v in jdyn.items()}  # both steps on the same planes
    run(rows(q), rows(qd), rows(qfrc), xfrc.permute(2, 1, 0).reshape(6 * s.nbody, n), rows(qt), None, None, 0,
        tfused.pack_sdf(planes))
    in_margin = (keys[0][0] > -p.contact_margin).sum(0)
    keep = cond.kept(cond.port_gaps(s, p, q, qd, qfrc, xfrc, qt, sdf=tfused.pack_sdf(planes)),
                     cond.jax_gaps(jm, jenv.sim_params, q, qd, qfrc, xfrc, qt, dyn=jdyn))
    assert int(keep.sum()) >= n // 2, keep
    cap = tfused.topk_cap(s, p)
    assert int((in_margin[keep] > cap).sum()) >= 1, (in_margin, keep)
    if "Gears" in task:  # more rows in the margin than a warp has lanes: two slots per lane
        on_plate = in_margin[::2][keep[::2]]
        assert len(on_plate) and bool((on_plate > 32).all()) and int((in_margin[keep] > 32).sum()) >= 2, \
            (in_margin, keep)
    tout = tfused.physics_step_fused(tm, p, q, qd, qfrc, xfrc=xfrc, q_target=qt, dyn=planes)
    jout = jfused.physics_step_fused(jm, jenv.sim_params, jq, jqd, jnp.asarray(qfrc.numpy()),
                                     xfrc=jnp.asarray(xfrc.numpy()), q_target=jnp.asarray(qt.numpy()),
                                     use_pallas=False, dyn=jdyn)
    k_ = keep.numpy()
    for k, tol in TOL.items():
        np.testing.assert_allclose(getattr(tout, k).numpy()[k_], np.asarray(getattr(jout, k))[k_], atol=tol,
                                   err_msg=k)
    bf = np.linalg.norm(np.asarray(jout.body_force), axis=-1)[k_]
    assert (bf[:, tenv.plug_body] > 0.01).any() and (bf[:, tenv.socket_body] > 0.01).any()


# ---- reset and env steps -----------------------------------------------------------

def _fields(js):
    return {"q": js.sim.q, "qd": js.sim.qd, "progress": js.progress, "reset_buf": js.reset_buf,
            "actions": js.actions, "task": {k: np.asarray(v) for k, v in js.task.items()}}


def _jax_draws(tenv, key):
    """The uniform draws of the JAX reset `VecTask.reset(key)` per env, by
    the task's DRAWS (the keys its `_sample` splits, in order)."""
    _, sub = jax.random.split(key)
    u = {name: [] for name, _ in tenv.DRAWS}
    for k in jax.random.split(sub, N):
        for (name, w), kk in zip(tenv.DRAWS, jax.random.split(k, len(tenv.DRAWS))):
            u[name].append(np.asarray(jax.random.uniform(kk, (w,)) if w > 1 else jax.random.uniform(kk)))
    return {name: torch.tensor(np.stack(v)) for name, v in u.items()}


@pytest.mark.parametrize("task", TASKS)
def test_reset_and_env_steps_match_jax(task):
    """Reset: the port's `init_from_draws` on the JAX reset's own uniform
    draws gives its q within 1e-5 (the arm after 24 damped least-squares IK
    iterations) and its task state (the curriculum's 0.01, the observation
    noise, zero rewards and flags); the port's observation of that state
    equals the JAX reset's. Then, from the JAX state put on both, three env
    steps under random actions with SHORT's configuration: envs 0 and 2
    start at progress 4 (their last step in the first env step, done, with
    the engagement bonus and the curriculum's scale; the population update
    moves every env's max displacement from 0.01 to 0.012, the easier
    branch, with `curr_max_disp` still 0.01 in that step's extras), env 1
    at 3, env 3 at 0. q, qd, observations, the privileged states, rewards, done flags,
    the task state and the extras as the JAX env's (the JAX step jitted).
    Each step starts both from the JAX state of the step before; an env that
    reset starts its next episode from each package's own draws and is
    compared up to the reset, its max displacement always."""
    jenv, tenv = _both(task, short=True)
    assert tenv.max_episode_length == jenv.max_episode_length == 6
    assert (tenv.sim_params.substeps, tenv.sim_params.solver_apgd_iterations) == (1, 4)
    key = jax.random.PRNGKey(0)
    jstate, jobs = jax.jit(jenv.reset)(key)
    u = _jax_draws(tenv, key)
    q, qd, task0 = tenv.init_from_draws(u, torch.full((N,), 0.01))
    np.testing.assert_allclose(q.numpy(), np.asarray(jstate.sim.q), atol=1e-5)
    assert float(qd.abs().max()) == 0.0
    for name, v in jstate.task.items():
        np.testing.assert_allclose(task0[name].numpy(), np.asarray(v), atol=1e-9, err_msg=name)
    # the JAX state as plain arrays: the jitted step then sees one signature
    jstate = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), jstate)
    tstate = env_state_from_arrays(tenv.reset(0)[0], _fields(jstate), "cpu")
    obs = tenv.observe(tstate.sim.q, tstate.sim.qd, tenv._kin(tstate.sim.q, tstate.sim.qd), tenv._no_sensors(N),
                       tstate.task, tstate.actions, tstate.progress)
    np.testing.assert_allclose(torch.clamp(obs, -tenv.clip_obs, tenv.clip_obs).numpy(), np.asarray(jobs), atol=1e-5)
    jstate = jstate.replace(progress=jnp.asarray([4, 3, 4, 0], jnp.int32))
    tstate = env_state_from_arrays(tstate, _fields(jstate), "cpu")
    state_tol = np.full(tenv.num_states, 1e-4)
    state_tol[7:14] = state_tol[21:27] = TOL["qd"]
    jstep = jax.jit(jenv.step)
    rng = np.random.RandomState(4)
    reset = np.zeros(N, bool)
    disps = []
    for k in range(3):
        a = rng.uniform(-0.5, 0.5, (N, 6)).astype(np.float32)
        jstate, jobs, jrew, jdone, jex = jstep(jstate, jnp.asarray(a))
        tstate, tobs, trew, tdone, tex = tenv.step(tstate, torch.tensor(a))
        kept = ~reset
        np.testing.assert_allclose(tstate.sim.q.numpy()[kept], np.asarray(jstate.sim.q)[kept], atol=TOL["q"])
        np.testing.assert_allclose(tstate.sim.qd.numpy()[kept], np.asarray(jstate.sim.qd)[kept], atol=TOL["qd"])
        np.testing.assert_allclose(tobs.numpy()[kept], np.asarray(jobs)[kept], atol=1e-4)
        gap = np.abs(tex["states"].numpy()[kept] - np.asarray(jex["states"])[kept])
        assert (gap <= state_tol).all(), (k, np.argwhere(gap > state_tol))
        np.testing.assert_allclose(trew.numpy()[kept], np.asarray(jrew)[kept], rtol=1e-3, err_msg=f"step {k}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tstate.progress.numpy(), np.asarray(jstate.progress))
        assert set(tex) == set(jex)
        for name in jex:
            if name != "states":
                np.testing.assert_array_equal(tex[name].numpy()[kept], np.asarray(jex[name])[kept], err_msg=name)
        for name, v in jstate.task.items():
            rows_ = slice(None) if name == "max_disp" else kept
            np.testing.assert_allclose(tstate.task[name].numpy()[rows_], np.asarray(v)[rows_],
                                       rtol=1e-3 if name == "prev_rew" else 0.0, atol=1e-9, err_msg=name)
        disps.append((tex["curr_max_disp"].numpy().copy(), tstate.task["max_disp"].numpy().copy()))
        tstate = env_state_from_arrays(tstate, _fields(jstate), "cpu")
        reset = np.asarray(jdone).copy()
    assert np.asarray(jdone).tolist() == [False] * 4
    np.testing.assert_allclose(disps[0][0], 0.01)  # the extras carry the value from before the update
    np.testing.assert_allclose(disps[0][1], 0.012, atol=1e-9)  # easier, clamped at the easy bound
    np.testing.assert_allclose(disps[1][0], 0.012, atol=1e-9)


# ---- the runtime hook --------------------------------------------------------------

def test_population_update_runs_after_extras_and_only_when_overridden(monkeypatch):
    """`VecTask.step` calls `population_update(task, done, progress)` after
    `extra_outputs` and before the timeout flag, with the step's own done
    flags and progress and the task state after the reward, and keeps what
    it returns; a task that does not override it never has it called
    (Cartpole steps with the base hook made to raise)."""
    from isaacgymenvs_tpu_torch.envcore.vec_task import VecTask
    from isaacgymenvs_tpu_torch.tasks.cartpole import Cartpole
    from isaacgymenvs_tpu_torch.utils.config import load_config

    cfg = lambda: load_config(["task=Cartpole", "num_envs=4", "task.env.episodeLength=100"])["task"]
    calls = []

    class Counted(Cartpole):
        def sample_init(self, generator, n):
            q, qd, _ = super().sample_init(generator, n)
            return q, qd, {"count": torch.zeros(n)}

        def reward_done(self, obs, q, qd, kin, sensors, task, actions, progress):
            calls.append("reward_done")
            rew, done, _ = super().reward_done(obs, q, qd, kin, sensors, task, actions, progress)
            return rew, done, task

        def extra_outputs(self, q, qd, kin, sensors, task, actions, progress):
            calls.append("extra_outputs")
            return {"count": task["count"].clone()}

        def population_update(self, task, done, progress):
            calls.append("population_update")
            assert done.dtype == torch.bool and progress.dtype == torch.int32
            return {"count": task["count"] + 1 + (progress >= 2).float()}

    env = Counted(cfg(), device="cpu")
    state, _ = env.reset(0)
    for k in range(3):
        state, _, _, done, ex = env.step(state, torch.zeros(4, 1))
        assert calls[-3:] == ["reward_done", "extra_outputs", "population_update"]
        assert set(ex) == {"count", "time_outs"}
    assert not bool(done.any())
    assert state.task["count"].tolist() == [5.0] * 4  # 1 + 2 + 2 from the hook, the extras a step behind
    assert ex["count"].tolist() == [3.0] * 4

    monkeypatch.setattr(VecTask, "population_update",
                        lambda self, task, done, progress: (_ for _ in ()).throw(AssertionError("called")))
    plain = Cartpole(cfg(), device="cpu")
    state, _ = plain.reset(0)
    for _ in range(4):
        state, _, _, _, _ = plain.step(state, torch.zeros(4, 1))
    assert type(plain).population_update is VecTask.population_update


def test_costly_reset_draws_only_when_an_env_resets():
    """A task with `costly_reset` (IndustReal's) has `resample_init` called
    only in the steps where some env resets, and those envs get its states;
    a task without it has it called every step; both runs reset the same
    envs at the same steps and start them from init states."""
    from isaacgymenvs_tpu_torch.tasks.cartpole import Cartpole
    from isaacgymenvs_tpu_torch.tasks.industreal_pegs_insert import IndustRealTaskPegsInsert
    from isaacgymenvs_tpu_torch.utils.config import load_config

    assert IndustRealTaskPegsInsert.costly_reset and not Cartpole.costly_reset

    def counted(costly):
        class Counted(Cartpole):
            costly_reset = costly
            calls = 0

            def resample_init(self, generator, old_task):
                type(self).calls += 1
                q, qd, task = self.sample_init(generator, self.num_envs)
                return q + 10.0, qd, task  # marked: a reset env starts 10 out

        return Counted(load_config(["task=Cartpole", "num_envs=4", "task.env.episodeLength=3"])["task"],
                       device="cpu")

    runs = {}
    for costly in (False, True):
        env = counted(costly)
        state, _ = env.reset(0)
        dones, reset_q = [], []
        for _ in range(6):
            before = state.reset_buf.clone()
            state, _, _, done, _ = env.step(state, torch.zeros(4, 1))
            dones.append(done.clone())
            reset_q.append(bool((state.sim.q[before, 0] > 5.0).all()) if bool(before.any()) else None)
        runs[costly] = (type(env).calls, torch.stack(dones), reset_q)
    steps_with_reset = int(runs[True][1][:-1].any(1).sum())
    assert runs[False][0] == 6 and runs[True][0] == steps_with_reset >= 1
    assert torch.equal(runs[False][1], runs[True][1])
    assert [r for r in runs[True][2] if r is not None] == [True] * steps_with_reset
