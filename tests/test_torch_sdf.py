"""The port's SDF engine against the JAX package, on the CPU.

Grids of the port's voxelizer (its own copy of the C++ source, built with
g++ into isaacgymenvs_tpu_torch/_build/) against the JAX package's on the
icosphere and cube of tests/test_sdf.py and on the two Insertion mesh
stand-ins: equal within 1e-6. Trilinear queries within 1e-6, gradients
within 1e-5. The ball on an SDF box (tests/test_sdf.py
test_ball_rests_on_sdf_box): the port's plain step with entry-sampled SDF
planes against the JAX `physics_step_fused(use_pallas=False)` fed by its
`sdf_dyn`, at the tolerances of tests/test_fused.py:79-82 (q 2e-4, qd 2e-3,
forces 2e-2), and the ball resting at 0.45 +- 0.015 m. The envs-per-block
choice of the kernel is a pure function of its byte count.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.sdf import builder as jsdf
from isaacgymenvs_tpu_torch.engine import _cuda
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.sdf import builder as tsdf
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
MESHES = os.path.join(package_asset_root(), "factory", "mesh", "factory_insertion")

# A test run with six pytest workers (`-n 6`) shares the cores; torch's
# intra-op thread pool on top of that oversubscribes them, and the plain
# step's larger tensors then wait on busy threads (20 Insertion env steps:
# 83 s under load with the default pool, 17 s with one thread). Every
# worker imports this module while it collects, so its torch ops run on one
# thread; the results do not depend on it.
torch.set_num_threads(1)


def icosphere(r=0.5, sub=3):
    """The icosphere of tests/test_sdf.py (analytic SDF |p| - r)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = [np.array(v, np.float64) for v in (
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1])]
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
             [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
             [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(sub):
        cache, new = {}, []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                cache[key] = len(verts)
                verts.append((verts[i] + verts[j]) / 2.0)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = new
    v = np.asarray(verts)
    return v / np.linalg.norm(v, axis=1, keepdims=True) * r, np.asarray(faces, np.int32)


def _mesh(name):
    from isaacgymenvs_tpu_torch.model.examples import cube_mesh

    if name == "icosphere":
        return icosphere(), {"resolution": 48}
    if name == "cube":
        return cube_mesh(0.5), {"resolution": 40}
    if name == "cube_0.2":
        return cube_mesh(0.2), {"resolution": 48}
    if name == "peg":
        return tsdf.load_obj(os.path.join(MESHES, "factory_round_peg_16mm_tight.obj")), {"resolution": 64}
    return tsdf.load_obj(os.path.join(MESHES, "factory_round_hole_16mm_subdiv_3x.obj")), \
        {"resolution": 128, "padding": 0.1}


@pytest.mark.parametrize("name", ["icosphere", "cube", "cube_0.2", "peg", "hole"])
def test_mesh_to_sdf_matches_jax(name):
    """The same grid (values within 1e-6, origin, spacing, shape) from both
    voxelizers; then trilinear values (1e-6) and gradients (1e-5) at seeded
    points inside, at and beyond the grid's box."""
    (v, t), kw = _mesh(name)
    tg = tsdf.mesh_to_sdf(v, t, **kw)
    jg = jsdf.mesh_to_sdf(v, t, **kw)
    assert tuple(tg.values.shape) == tuple(jg.values.shape) and tg.spacing == jg.spacing
    np.testing.assert_allclose(tg.values.numpy(), np.asarray(jg.values), atol=1e-6)
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    lo, hi = v.min(0), v.max(0)
    span = hi - lo
    pts = np.random.RandomState(7).uniform(lo - 0.3 * span, hi + 0.3 * span, (400, 3)).astype(np.float32)
    np.testing.assert_allclose(tsdf.sdf_query(tg, torch.tensor(pts)).numpy(),
                               np.asarray(jsdf.sdf_query(jg, jnp.asarray(pts))), atol=1e-6)
    np.testing.assert_allclose(tsdf.sdf_gradient(tg, torch.tensor(pts)).numpy(),
                               np.asarray(jsdf.sdf_gradient(jg, jnp.asarray(pts))), atol=1e-5)


def test_voxelizer_is_the_ports_own_build():
    """The port builds its voxelizer from its own source into its build
    directory and loads that library, not the JAX package's native/sdf one."""
    tsdf.mesh_to_sdf(*icosphere(sub=1), resolution=8)
    path = tsdf._lib._name
    assert os.path.dirname(path) == tsdf.BUILD_DIR and os.path.basename(path).startswith("libsdf_")
    assert tsdf.BUILD_DIR.endswith(os.path.join("isaacgymenvs_tpu_torch", "_build"))
    assert tsdf.SOURCE.endswith(os.path.join("isaacgymenvs_tpu_torch", "sdf", "csrc", "sdf.cpp"))
    assert "native" not in path


def _jax_ball():
    """The JAX package's ball on an SDF box, built as tests/test_sdf.py builds it."""
    from isaacgymenvs_tpu.model.spec import FIXED, FREE, GEOM_SPHERE, ModelBuilder, sphere_inertia
    from isaacgymenvs_tpu_torch.model.examples import cube_mesh

    b = ModelBuilder()
    mass, inertia = sphere_inertia(1000.0, 0.05)
    ball = b.add_body(parent=-1, name="ball", pos=(0, 0, 0), quat=(0, 0, 0, 1), jnt_type=FREE, mass=mass,
                      inertia=inertia)
    b.qpos0_free[ball] = (np.array([0.03, 0.0, 0.5], np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(ball, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (0.05, 0, 0), 0.8)
    box = b.add_body(parent=-1, name="box", pos=(0, 0, 0.2), quat=(0, 0, 0, 1), jnt_type=FIXED)
    model = b.finalize()
    model, g = jsdf.attach_sdf(model, box, jsdf.mesh_to_sdf(*cube_mesh(0.2), resolution=48))
    return jsdf.pair_points_with_sdf(model, [0], g)


def _jax_step(jm, jp, q, qd, qfrc, xfrc=None, qt=None):
    from isaacgymenvs_tpu.engine import fused as jfused

    jq, jqd = jnp.asarray(q), jnp.asarray(qd)
    dyn = jfused.sdf_dyn(jm, jq, jqd)
    return jfused.physics_step_fused(jm, jp, jq, jqd, jnp.asarray(qfrc),
                                     xfrc=None if xfrc is None else jnp.asarray(xfrc),
                                     q_target=None if qt is None else jnp.asarray(qt), use_pallas=False, dyn=dyn)


def _assert_step(tout, jout):
    for k, tol in TOL.items():
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)), atol=tol, err_msg=k)


def test_ball_on_sdf_box_plain_step_matches_jax():
    """Both models equal; `sdf_dyn` of both within 1e-5 at balls on, in and
    above the box; the plain step with the entry planes against JAX's for 3
    steps, with the SDF row active (the box's body force non-zero)."""
    from isaacgymenvs_tpu.engine.dynamics import SimParams as JParams
    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import ball_on_sdf_box

    tm, jm = ball_on_sdf_box(), _jax_ball()
    assert (tm.spair_point, tm.spair_sdf, tm.sdf_body) == (jm.spair_point, jm.spair_sdf, jm.sdf_body)
    np.testing.assert_array_equal(tm.sdf_values[0], np.asarray(jm.sdf_values[0]))
    tp, jp = SimParams(dt=1 / 60, substeps=2), JParams(dt=1 / 60, substeps=2, gravity=jnp.array([0.0, 0.0, -9.81]))
    rng = np.random.RandomState(3)
    n = 6
    q = np.tile(np.asarray(tm.qpos0, np.float32), (n, 1))
    q[:, 0:2] = rng.uniform(-0.15, 0.15, (n, 2))
    q[:, 2] = [0.4505, 0.449, 0.4495, 0.452, 0.60, 0.4498]  # resting, pressed in, above (inactive)
    qd = np.zeros((n, 6), np.float32)
    qd[:, 3:] = rng.uniform(-0.2, 0.2, (n, 3))
    qd[:, 0:3] = rng.uniform(-0.05, 0.05, (n, 3))
    tdyn = tfused.sdf_dyn(tm, torch.tensor(q), torch.tensor(qd))
    from isaacgymenvs_tpu.engine import fused as jfused

    jdyn = jfused.sdf_dyn(jm, jnp.asarray(q), jnp.asarray(qd))
    assert set(tdyn) == set(jdyn) == set(tfused.SP_KEYS)
    for k in tfused.SP_KEYS:
        np.testing.assert_allclose(tdyn[k].numpy(), np.asarray(jdyn[k]), atol=1e-5, err_msg=k)
    qfrc = np.zeros((n, 6), np.float32)
    for _ in range(3):
        tout = tfused.physics_step_fused(tm, tp, torch.tensor(q), torch.tensor(qd), torch.tensor(qfrc),
                                         dyn=tfused.sdf_dyn(tm, torch.tensor(q), torch.tensor(qd)))
        jout = _jax_step(jm, jp, q, qd, qfrc)
        _assert_step(tout, jout)
        q, qd = np.asarray(jout.q), np.asarray(jout.qd)
    box_force = np.abs(np.asarray(jout.body_force)[:, 1]).max(1)
    assert (box_force[[0, 1, 2, 5]] > 1.0).all() and box_force[4] == 0.0


def test_ball_rests_on_sdf_box_through_the_plain_step():
    """150 steps from 0.5 m through `physics_step_fused` with the planes
    sampled at each step's entry pose: the ball rests on the box top."""
    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import ball_on_sdf_box

    m, p = ball_on_sdf_box(), SimParams(dt=1 / 60, substeps=2)
    q, qd = torch.tensor(m.qpos0)[None], torch.zeros(1, m.nv)
    for _ in range(150):
        out = tfused.physics_step_fused(m, p, q, qd, torch.zeros(1, m.nv), sdf=tfused.pack_sdf(tfused.sdf_dyn(m, q, qd)))
        q, qd = out.q, out.qd
    assert bool(torch.isfinite(q).all())
    assert abs(float(q[0, 2]) - 0.45) < 0.015 and abs(float(qd[0, 2])) < 0.05


def test_sdf_planes_are_required_and_checked():
    """A model with SDF pair rows needs its planes, a model without takes
    none, and the planes come once."""
    from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
    from isaacgymenvs_tpu_torch.model.examples import ball_on_sdf_box

    m, p = ball_on_sdf_box(), SimParams(dt=1 / 60, substeps=2)
    q, qd, f = torch.tensor(m.qpos0)[None], torch.zeros(1, m.nv), torch.zeros(1, m.nv)
    planes = tfused.sdf_dyn(m, q, qd)
    with pytest.raises(ValueError, match="SDF pair rows"):
        tfused.physics_step_fused(m, p, q, qd, f)
    with pytest.raises(ValueError, match="given twice"):
        tfused.physics_step_fused(m, p, q, qd, f, dyn=planes, sdf=tfused.pack_sdf(planes))
    plain = m.replace(spair_point=(), spair_sdf=())
    with pytest.raises(ValueError, match="only such a model"):
        tfused.physics_step_fused(plain, p, q, qd, f, sdf=tfused.pack_sdf(planes))
    assert tfused.pack_sdf(planes).shape == (13, 1)


@pytest.mark.parametrize("case", ["fits4", "fits2", "fits1", "none"])
def test_envs_per_block_from_the_byte_count(case):
    """Of 8, 4, 2 and 1 envs whose block fits the limit, the one that keeps
    the most envs resident per SM (at 168 registers per thread), ties to
    the larger block; 0 when none fits: a pure function of the bytes per
    block. At half of 15,590 floats per env an SM holds three blocks of 2
    (6 envs) against one block of 4 or five of 1; at the full count one
    block of 2 ties with two blocks of 1 and takes the tie; at twice it
    one env per block is all that fits."""
    spec, per_env, limit = 4000, 15590, _cuda.SMEM_OPTIN_BYTES
    smem_of = lambda e: 4 * (spec + e * per_env)
    scale = {"fits4": 0.5, "fits2": 1.0, "fits1": 2.0, "none": 4.0}[case]
    got = _cuda.envs_per_block(lambda e: int(smem_of(e) * scale), limit, 168)
    assert got == {"fits4": 2, "fits2": 2, "fits1": 1, "none": 0}[case]
    assert _cuda.envs_per_block(lambda e: limit, limit, 168) == 8
    assert _cuda.envs_per_block(lambda e: limit + 1, limit, 168) == 0
