"""The port's fused physics step against the JAX fused math.

On the CPU `physics_step_fused` runs the plain PyTorch version
(`_step_math_torch`); the reference is the JAX
`physics_step_fused(..., use_pallas=False)`. Tolerances are those of
tests/test_fused.py (q 2e-4, qd 2e-3, forces 2e-2). The kernel itself is
held against the plain version on the card by tests/test_torch_kernel.py
and chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu.engine import SimParams as JSimParams
from isaacgymenvs_tpu.engine import fused as jfused
from isaacgymenvs_tpu.model.spec import FREE, GEOM_SPHERE, ModelBuilder
from isaacgymenvs_tpu.sdf.builder import add_contact_points
from isaacgymenvs_tpu_torch.convert import model_from_arrays
from isaacgymenvs_tpu_torch.engine import _cuda
from isaacgymenvs_tpu_torch.engine import fused as tfused
from isaacgymenvs_tpu_torch.engine.dynamics import SimParams
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root

TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}
CFG = {"env": {"numEnvs": 4, "clipActions": 1.0}, "sim": {"dt": 1 / 60, "substeps": 2}}


def _jax_fields(m):
    return {f.name: (np.asarray(getattr(m, f.name)) if hasattr(getattr(m, f.name), "shape")
                     else getattr(m, f.name)) for f in dataclasses.fields(m)}


@pytest.fixture(scope="module")
def ant():
    """JAX Ant env and the port's Ant, both reading the bundled MJCF."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Ant"]({k: dict(v) for k, v in CFG.items()})
        tenv = ttasks["Ant"]({k: dict(v) for k, v in CFG.items()}, device="cpu")
    state, _ = jenv.reset(jax.random.PRNGKey(0))
    return jenv, tenv, np.asarray(state.sim.q), np.asarray(state.sim.qd)


def _compare(jm, jp, tm, tp, q, qd, qfrc, xfrc, steps):
    """Step both from the JAX trajectory; every output within TOL."""
    for _ in range(steps):
        jo = jfused.physics_step_fused(
            jm, jp, jnp.asarray(q), jnp.asarray(qd), jnp.asarray(qfrc),
            xfrc=None if xfrc is None else jnp.asarray(xfrc), use_pallas=False,
        )
        to = tfused.physics_step_fused(
            tm, tp, torch.tensor(q), torch.tensor(qd), torch.tensor(qfrc),
            xfrc=None if xfrc is None else torch.tensor(xfrc),
        )
        for k, tol in TOL.items():
            err = float(np.max(np.abs(np.asarray(getattr(jo, k)) - getattr(to, k).numpy())))
            assert err < tol, (k, err)
        q, qd = np.asarray(jo.q), np.asarray(jo.qd)
    return q, qd


@pytest.mark.parametrize("with_xfrc", [False, True])
def test_twin_matches_jax_ant(ant, with_xfrc):
    jenv, tenv, q, qd = ant
    rng = np.random.RandomState(1)
    qfrc = (rng.uniform(-1, 1, (4, tenv.model.nv)) * 3.0).astype(np.float32)
    xfrc = rng.uniform(-1, 1, (4, tenv.model.nbody, 6)).astype(np.float32) if with_xfrc else None
    _compare(jenv.model, jenv.sim_params, tenv.model, tenv.sim_params, q, qd, qfrc, xfrc, 3)


@pytest.fixture(scope="module")
def cartpole():
    """JAX Cartpole env and the port's, both reading the bundled URDF."""
    from isaacgymenvs_tpu.tasks import task_map as jtasks
    from isaacgymenvs_tpu_torch.tasks import task_map as ttasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ISAACGYMENVS_TPU_ASSETS", package_asset_root())
        jenv = jtasks["Cartpole"]({k: dict(v) for k, v in CFG.items()})
        tenv = ttasks["Cartpole"]({k: dict(v) for k, v in CFG.items()}, device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("jax_rows", ["nc0", "nc24"])
def test_twin_matches_jax_cartpole(cartpole, jax_rows):
    """The contact-free step (nc == 0) against the JAX fused math: against
    its own nc == 0 branch (the model with plane_contacts off), and against
    the JAX Cartpole as it is, whose 24 candidate rows hang a metre above
    the ground and never act."""
    jenv, tenv = cartpole
    jm = jenv.model.replace(plane_contacts=False) if jax_rows == "nc0" else jenv.model
    assert tfused._extract(tenv.model).nc == 0 and jenv.model.ncp == 24
    rng = np.random.RandomState(3)
    q = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
    qd = rng.uniform(-2, 2, (4, 2)).astype(np.float32)
    qfrc = rng.uniform(-100, 100, (4, 2)).astype(np.float32)
    q2, _ = _compare(jm, jenv.sim_params, tenv.model, tenv.sim_params, q, qd, qfrc, None, 3)
    assert float(np.abs(q2 - q).max()) > 0.05  # the step moved the state
    out = tfused.physics_step_fused(tenv.model, tenv.sim_params, torch.tensor(q), torch.tensor(qd),
                                    torch.tensor(qfrc))
    for k in ("body_force", "body_torque", "dof_force"):
        assert float(getattr(out, k).abs().max()) == 0.0


def test_contact_free_counts_and_layout(ant, cartpole):
    """kernel_flops without contacts is positive and below the count with
    one; the spec buffer's contact regions have zero width."""
    _, tenv = cartpole
    m, p = tenv.model, tenv.sim_params
    s = tfused._extract(m)
    with_contacts = tfused._extract(m.replace(plane_contacts=True))
    assert (s.nbody, s.nq, s.nv, s.nc) == (3, 2, 2, 0) and with_contacts.nc == 24
    assert 0 < _cuda.kernel_flops(s, p) < _cuda.kernel_flops(with_contacts, p)
    one = with_contacts._replace(nc=1)
    assert _cuda.kernel_flops(s, p) < _cuda.kernel_flops(one, p)
    assert _cuda.kernel_bytes(s, 512, False) == 4 * 512 * (2 + 2 * 2 + 2 + 2 + 6 * 3 + 2)
    spec = _cuda.pack_spec(s, p, tfused.apgd_betas(p.solver_apgd_iterations))
    nb, nv = s.nbody, s.nv
    base = 16 + 5 * nb + 3 * nb + 4 * nb + 3 * nb + 9 * nb + nb + 6 * nb + 10 * nv + nv * nv + nb * nb
    assert spec.shape == (base + p.solver_apgd_iterations,) and spec.dtype == np.float32
    # Ant's count is what it was before the contact-free gate
    _, aenv, _, _ = ant
    assert _cuda.kernel_flops(tfused._extract(aenv.model), aenv.sim_params) == 471095


def test_port_sim_params_match_jax(ant):
    jenv, tenv, _, _ = ant
    jp, tp = jenv.sim_params, tenv.sim_params
    for f in ("dt", "substeps", "solver_iterations", "solver_apgd_iterations",
              "contact_margin", "baumgarte_erp", "max_depenetration_velocity",
              "bounce_threshold_velocity", "max_dof_velocity"):
        assert getattr(jp, f) == pytest.approx(getattr(tp, f)), f
    np.testing.assert_allclose(np.asarray(jp.gravity), tp.gravity)


def _ball():
    """The restitution fixture of tests/test_fused.py: a sphere (e=0.8)."""
    b = ModelBuilder()
    body = b.add_body(parent=-1, name="ball", pos=(0, 0, 0), quat=(0, 0, 0, 1),
                      jnt_type=FREE, mass=1.0, inertia=np.eye(3) * 1e-3)
    b.qpos0_free[body] = (np.array([0, 0, 1.0], np.float32), np.array([0, 0, 0, 1], np.float32))
    b.add_geom(body, GEOM_SPHERE, (0, 0, 0), (0, 0, 0, 1), (0.1, 0, 0), 0.5)
    m = b.finalize()
    m, idx = add_contact_points(m, body, np.array([[0.0, 0.0, -0.1]], np.float32), friction=0.5)
    return m.replace(cpoint_restitution=jnp.zeros(m.ncp).at[idx[0]].set(0.8))


def test_twin_matches_jax_restitution_ball():
    jm = _ball()
    jp = JSimParams(dt=1 / 120, substeps=2, baumgarte_erp=0.1)
    tm = model_from_arrays(_jax_fields(jm))
    tp = SimParams(dt=1 / 120, substeps=2, baumgarte_erp=0.1)
    assert tfused.fused_supported(tm, tp)
    n = 4
    q = np.tile(np.asarray(jm.qpos0), (n, 1)).astype(np.float32)
    qd = np.zeros((n, jm.nv), np.float32)
    qd[:, 2] = -3.0
    zero = np.zeros((n, jm.nv), np.float32)
    bounced = False
    for _ in range(30):
        q, qd = _compare(jm, jp, tm, tp, q, qd, zero, None, 1)
        bounced = bounced or float(qd[0, 2]) > 1.8
    assert bounced


def _pair_row_model(tm):
    return tm.replace(ppair_point=(0,), ppair_geom=(0,))


def test_unsupported_models_raise(ant):
    _, tenv, q, qd = ant
    m, p = tenv.model, tenv.sim_params
    assert tfused.fused_supported(m, p)
    topk = SimParams(**{**p.__dict__, "max_active_contacts": 8})
    assert not tfused.fused_supported(_pair_row_model(m), p)
    assert not tfused.fused_supported(m, topk)
    args = (torch.tensor(q), torch.tensor(qd), torch.zeros(4, m.nv))
    # the feature check precedes any device dispatch, so the CUDA path
    # raises the same way for these models
    with pytest.raises(NotImplementedError):
        tfused.physics_step_fused(_pair_row_model(m), p, *args)
    with pytest.raises(NotImplementedError):
        tfused.physics_step_fused(m, topk, *args)
    with pytest.raises(NotImplementedError):
        tfused.physics_step_fused(m, p, *args, q_target=torch.tensor(q))


def test_spec_buffer_layout(ant):
    """The packed constants have the length the kernel's layout expects."""
    _, tenv, _, _ = ant
    m, p = tenv.model, tenv.sim_params
    s = tfused._extract(m)
    spec = _cuda.pack_spec(s, p, tfused.apgd_betas(p.solver_apgd_iterations))
    nb, nv, nc = s.nbody, s.nv, s.nc
    base = 16 + 5 * nb + 3 * nb + 4 * nb + 3 * nb + 9 * nb + nb + 6 * nb + 10 * nv + nv * nv \
        + nb * nb + 7 * nc + nc * nv
    assert spec.shape == (base + p.solver_apgd_iterations,)
    assert spec.dtype == np.float32
    assert _cuda.kernel_flops(s, p) > 0 and _cuda.kernel_bytes(s, 4096, True) > 0


def test_forward_kinematics_matches_jax(ant):
    from isaacgymenvs_tpu.engine import dynamics as jdyn
    from isaacgymenvs_tpu_torch.engine import dynamics as tdyn

    jenv, tenv, q, qd = ant
    qd = qd + np.random.RandomState(4).uniform(-1, 1, qd.shape).astype(np.float32)
    jk = jax.vmap(lambda a, b: jdyn.forward_kinematics(jenv.model, a, b))(jnp.asarray(q), jnp.asarray(qd))
    tk = tdyn.forward_kinematics(tenv.model, torch.tensor(q), torch.tensor(qd))
    for f in ("x", "quat", "com", "inertia_w", "S", "Sdot", "v"):
        np.testing.assert_allclose(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)), atol=1e-5, err_msg=f)
