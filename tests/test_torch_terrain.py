"""The port's heightfield terrain and the step's terrain rows, top-K active
set and merged-window warm resets against the JAX package.

The grid generators and `TerrainGrid` must give bit-identical grids from
the same seed. Lookups (`Terrain.sample`, `sample_grad` and the patch
variants with their clamp rule) and the entry sampler `terrain_dyn` agree
to 1e-5. The plain step (`_step_math_torch`) is held against the JAX
`physics_step_fused(..., use_pallas=False)` within q 2e-4, qd 2e-3 and
forces 2e-2, the tolerances of tests/test_fused.py. The grid is cut to 3
levels x 4 types on both sides (the yaml's 10 x 20 takes the same code).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.engine import fused as jfused
from isaacgymenvs_tpu.engine.dynamics import Terrain as JTerrain
from isaacgymenvs_tpu.utils import terrain_utils as jterrain
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.engine.dynamics import Terrain as TTerrain
from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics
from isaacgymenvs_tpu_torch import maths
from isaacgymenvs_tpu_torch.utils import terrain_utils as tterrain
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
GRID = ["task.env.terrain.numLevels=3", "task.env.terrain.numTerrains=4"]
N = 4


@pytest.mark.parametrize("curriculum", [True, False])
def test_terrain_grid_is_bit_identical(curriculum):
    """Same seed, same grid: heights and env origins equal bit for bit; each
    generator alone too, from the same numpy generator. (Stepping stones, which
    the grid does not use, raises on a broadcast in both packages; it is left
    out here.)"""
    kw = dict(num_levels=3, num_terrains=5, curriculum=curriculum, seed=3)
    jg, tg = jterrain.TerrainGrid(**kw), tterrain.TerrainGrid(**kw)
    assert np.array_equal(jg.height, tg.height) and np.array_equal(jg.env_origins, tg.env_origins)
    assert jg.height.dtype == tg.height.dtype == np.float32 and float(np.ptp(tg.height)) > 0.1
    calls = {
        "random_uniform_terrain": lambda m, rng: m.random_uniform_terrain(np.zeros((40, 30)), 0.1, 0.1, rng),
        "sloped_terrain": lambda m, rng: m.sloped_terrain(np.zeros((40, 30)), 0.3, 0.1),
        "pyramid_sloped_terrain": lambda m, rng: m.pyramid_sloped_terrain(np.zeros((40, 30)), -0.3, 0.1),
        "stairs_terrain": lambda m, rng: m.stairs_terrain(np.zeros((40, 30)), 0.31, 0.1, 0.1),
        "pyramid_stairs_terrain": lambda m, rng: m.pyramid_stairs_terrain(np.zeros((40, 30)), 0.31, -0.1, 0.1),
        "discrete_obstacles_terrain": lambda m, rng: m.discrete_obstacles_terrain(
            np.zeros((40, 30)), 0.2, 1.0, 2.0, 5, 0.1, rng),
    }
    for name, call in calls.items():
        a = call(jterrain, np.random.default_rng(1))
        b = call(tterrain, np.random.default_rng(1))
        assert np.array_equal(a, b) and float(np.ptp(b)) > 0.0, name


@pytest.fixture(scope="module")
def terrains():
    g = tterrain.TerrainGrid(num_levels=3, num_terrains=4)
    jt = JTerrain(height=jnp.asarray(g.height), horizontal_scale=g.hs, origin=jnp.zeros(2))
    return g, jt, TTerrain(torch.tensor(g.height), g.hs)


def test_sampling_matches_jax(terrains):
    """Bilinear height and the gradient's normal at points on the grid and
    off it (clamped to the border), to 1e-5."""
    g, jt, tt = terrains
    rng = np.random.RandomState(0)
    ext = np.array(g.height.shape) * g.hs
    pts = rng.uniform(-2.0, 1.0, (300, 2)) * 0 + rng.uniform(0, 1, (300, 2)) * (ext + 4.0) - 2.0
    pts = pts.astype(np.float32)
    jh, jn = jt.sample_grad(jnp.asarray(pts))
    th, tn = tt.sample_grad(torch.tensor(pts))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(tt.sample(torch.tensor(pts)).numpy(), np.asarray(jt.sample(jnp.asarray(pts))), atol=1e-5)
    assert float(np.abs(np.asarray(jn)[:, :2]).max()) > 0.1  # slopes and steps, not a flat field


@pytest.mark.parametrize("P", [24, 32])
def test_patch_lookup_and_its_clamp_match_jax(terrains, P):
    """`sample_patch` / `sample_grad_patch`: points within the (P, P) window
    around each centre and points beyond it, which take the window's edge
    value (the clamp rule), against the JAX package's dense-window version."""
    g, jt, tt = terrains
    rng = np.random.RandomState(1)
    centers = rng.uniform(5.0, 30.0, (6, 2)).astype(np.float32)
    centers[0] = (0.3, 0.2)  # the window clamped at the grid's corner
    offs = rng.uniform(-0.45, 0.45, (6, 40, 2)) * P * g.hs  # inside
    far = rng.uniform(0.6, 1.0, (6, 20, 2)) * P * g.hs * np.sign(rng.uniform(-1, 1, (6, 20, 2)))  # beyond
    pts = (centers[:, None] + np.concatenate([offs, far], 1)).astype(np.float32)
    jh, jn = jax.vmap(lambda c, p: jt.sample_grad_patch(c, p, P=P))(jnp.asarray(centers), jnp.asarray(pts))
    th, tn = tt.sample_grad_patch(torch.tensor(centers), torch.tensor(pts), P)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    jh2 = jax.vmap(lambda c, p: jt.sample_patch(c, p, P=P))(jnp.asarray(centers), jnp.asarray(pts))
    np.testing.assert_allclose(tt.sample_patch(torch.tensor(centers), torch.tensor(pts), P).numpy(),
                               np.asarray(jh2), atol=1e-5)
    # inside the window the patch is the grid; beyond it the clamp acts
    full = tt.sample(torch.tensor(pts)).numpy()
    np.testing.assert_allclose(th.numpy()[:, :40], full[:, :40], atol=1e-5)
    assert float(np.abs(th.numpy()[:, 40:] - full[:, 40:]).max()) > 1e-2


# ---- the step against the JAX fused math ------------------------------------


@pytest.fixture(scope="module")
def envs():
    """The JAX AnymalTerrain (small grid) and the port's, on the stand-in."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu.utils.config import load_config as jload
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks
    from isaacgymenvs_tpu_torch.utils.config import load_config as tload

    args = ["task=AnymalTerrain", f"num_envs={N}", *GRID]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["AnymalTerrain"](jload(args)["task"])
        tenv = ttasks["AnymalTerrain"](tload(args)["task"], device="cpu")
    assert np.array_equal(np.asarray(jenv.terrain.height), tenv.terrain.height.numpy())
    return jenv, tenv


def _lowest(tenv, q, terrain=True):
    """Height of each env's lowest candidate above the ground under it."""
    m = tenv.model
    cb = torch.tensor(m.cpoint_body)
    kin = forward_kinematics(m, q, torch.zeros(q.shape[0], m.nv))
    x = kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], torch.tensor(m.cpoint_pos))
    ground = tenv.terrain.sample(x[..., :2]) if terrain else 0.0
    return x[..., 2] - torch.tensor(m.cpoint_radius) - ground


def _standing(tenv, seed, terrain=True, depth=0.002):
    """Robots standing at their spawn points (level and type from the
    curriculum), the lowest candidate `depth` in the ground; on flat ground
    with `terrain` False."""
    st, _ = tenv.reset(seed)
    q = st.sim.q.clone()
    if not terrain:
        q[:, :2] = torch.tensor(np.random.RandomState(seed).uniform(-2, 2, (q.shape[0], 2)), dtype=torch.float32)
    q[:, 2] -= _lowest(tenv, q, terrain).amin(1) + depth
    return q


def _tumbled(tenv, n, seed, k_active=22, terrain=False):
    """Robots lying in random orientations with random joints, pushed in until
    `k_active` candidates are within the margin (the best of a pool)."""
    rng = np.random.RandomState(seed)
    pool = 2000
    q = torch.tensor(np.tile(np.asarray(tenv.model.qpos0), (pool, 1)))
    q[:, :2] = torch.tensor(rng.uniform(-1, 1, (pool, 2)), dtype=torch.float32)
    quat = rng.normal(size=(pool, 4))
    q[:, 3:7] = torch.tensor(quat / np.linalg.norm(quat, axis=1, keepdims=True), dtype=torch.float32)
    q[:, tenv.dof_q_idx] = torch.tensor(rng.uniform(-1, 1, (pool, 12)) * np.tile([0.5, 3.0, 3.0], 4), dtype=torch.float32)
    gap = torch.sort(_lowest(tenv, q, terrain), 1).values
    best = torch.argsort(gap[:, k_active - 1] - gap[:, 0])[:n]
    q = q[best]
    q[:, 2] -= gap[best, k_active - 1] - 0.015
    return q


def _compare(jm, jp, tm, tp, q, qd, qt, dyn=None, terrain=None, jterr=None, wre=0):
    """One call of both from the same inputs; every output within TOL.
    Returns the port's outputs."""
    jdyn = {k: jnp.asarray(v.numpy()) for k, v in (dyn or {}).items()}
    tdyn = dict(dyn or {})
    if terrain is not None:
        jdyn.update(jfused.terrain_dyn(jm, jterr, jnp.asarray(q.numpy()), jnp.asarray(qd.numpy())))
        tdyn.update(tfused.terrain_dyn(tm, terrain, q, qd))
    zero = np.zeros(qd.shape, np.float32)
    jo = jfused.physics_step_fused(jm, jp, jnp.asarray(q.numpy()), jnp.asarray(qd.numpy()), jnp.asarray(zero),
                                   q_target=jnp.asarray(qt.numpy()), use_pallas=False, dyn=jdyn or None,
                                   warm_reset_every=wre)
    to = tfused.physics_step_fused(tm, tp, q, qd, torch.tensor(zero), q_target=qt, dyn=tdyn or None,
                                   warm_reset_every=wre)
    for k, t in TOL.items():
        err = float(np.abs(np.asarray(getattr(jo, k)) - getattr(to, k).numpy()).max())
        assert err < t, (k, err)
    return to


def _params(jenv, tenv, **kw):
    return jenv.sim_params.replace(**kw), dataclasses.replace(tenv.sim_params, **kw)


def test_terrain_dyn_matches_jax(envs):
    """The entry-sampled planes (height, normal, tangents per candidate) of
    robots standing on the grid and lying on it, to 1e-5."""
    jenv, tenv = envs
    q = torch.cat([_standing(tenv, 1), _tumbled(tenv, N, 2, terrain=True) + torch.tensor([20.0, 20.0] + [0.0] * 17)])
    qd = torch.zeros(q.shape[0], tenv.model.nv)
    jd = jfused.terrain_dyn(jenv.model, jenv.terrain, jnp.asarray(q.numpy()), jnp.asarray(qd.numpy()))
    td = tfused.terrain_dyn(tenv.model, tenv.terrain, q, qd)
    assert set(td) == set(jd) == set(tfused.TERRAIN_KEYS)
    for k in tfused.TERRAIN_KEYS:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), atol=1e-5, err_msg=k)
    assert float(td["_terr_n0"].abs().max()) > 0.1  # sloped planes under some points


def test_step_with_terrain_rows_matches_jax(envs):
    """Terrain rows alone (no cap): robots standing on slopes and stairs,
    one slice, q_target drives."""
    jenv, tenv = envs
    jp, tp = _params(jenv, tenv, max_active_contacts=0)
    q = _standing(tenv, 3)
    qd = torch.zeros(N, tenv.model.nv)
    qt = q + torch.tensor(np.random.RandomState(3).uniform(-0.05, 0.05, q.shape), dtype=torch.float32)
    out = _compare(jenv.model, jp, tenv.model, tp, q, qd, qt, terrain=tenv.terrain, jterr=jenv.terrain)
    assert float(out.body_force[:, :, 2].sum(1).min()) > 1.0  # every robot stands on its feet
    flat = tfused.physics_step_fused(tenv.model, tp, q, qd, torch.zeros_like(qd), q_target=qt)
    assert float((flat.qd - out.qd).abs().max()) > 1e-2  # the terrain rows act


@pytest.mark.parametrize("case", ["past_the_cap", "fillers", "exact_tie"])
def test_step_with_top_k_matches_jax(envs, case):
    """Top-K at the yaml's cap of 20 of 44 candidates on flat ground:
    robots lying with more than 20 candidates active; robots standing (4
    active, 16 inactive fillers take the remaining slots by index and count
    in the step size); and a cap of 2 that falls between keys that tie
    exactly: an upright base, legs folded up, its four bottom corners 2 mm
    in the ground and rising at 5 cm/s (slower than Baumgarte's push-out,
    so the rows act, and with a positive free normal velocity, so each key
    is its phi alone); lax.top_k's order, the lower index, decides."""
    jenv, tenv = envs
    cap = 2 if case == "exact_tie" else 20
    jp, tp = _params(jenv, tenv, max_active_contacts=cap)
    rng = np.random.RandomState(4)
    if case == "past_the_cap":
        q = _tumbled(tenv, N, 5)
    else:
        q = _standing(tenv, 6, terrain=False)
    qd = torch.zeros(N, tenv.model.nv)
    qt = q + torch.tensor(rng.uniform(-0.05, 0.05, q.shape), dtype=torch.float32)
    if case == "exact_tie":
        q[:, 3:7] = torch.tensor([0.0, 0.0, 0.0, 1.0])
        q[:, tenv.dof_q_idx] = torch.tensor([0.0, np.pi, 0.0] * 4)
        q[:, 2] = 0.12 - 0.002
        qd[:, 2] = 0.05
        qt = q.clone()
    keys = []
    s = tfused._extract(tenv.model)
    tfused._step_math_torch(s, tp, torch.device("cpu"), (), keys)(
        q.T.contiguous(), qd.T.contiguous(), qd.T.contiguous(), None, qt.T.contiguous())
    phi, key = keys[0]
    active = (key > -1e29).sum(0)
    if case == "past_the_cap":
        assert bool((active > 20).all())
    elif case == "fillers":
        assert bool((active < 20).all()) and bool((active > 0).all())
    else:
        corners = [i for i in range(s.nc) if s.cp_body[i] == 0 and s.cp_pos[i, 2] < 0]
        assert bool((active == 4).all()) and all(len(set(key[corners, e].tolist())) == 1 for e in range(N))
    out = _compare(jenv.model, jp, tenv.model, tp, q, qd, qt)
    assert float(out.body_force.abs().max()) > 1.0  # the selected rows carry force


def test_merged_window_warm_resets_match_jax(envs):
    """Two slices in one call with the warm start reset between them (a
    merged window of two one-slice calls), top-K and terrain rows, against
    the JAX package; and the same call without the reset differs."""
    jenv, tenv = envs
    p = tenv.sim_params
    jp, tp = _params(jenv, tenv, dt=p.dt * 2, substeps=p.substeps * 2)
    q = _standing(tenv, 7)
    qd = torch.zeros(N, tenv.model.nv)
    qt = q + torch.tensor(np.random.RandomState(7).uniform(-0.05, 0.05, q.shape), dtype=torch.float32)
    out = _compare(jenv.model, jp, tenv.model, tp, q, qd, qt, terrain=tenv.terrain, jterr=jenv.terrain, wre=1)
    planes = tfused.terrain_dyn(tenv.model, tenv.terrain, q, qd)
    carried = tfused.physics_step_fused(tenv.model, tp, q, qd, torch.zeros_like(qd), q_target=qt, dyn=planes)
    assert float((carried.qd - out.qd).abs().max()) > 1e-6
