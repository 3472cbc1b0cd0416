"""The port's controller library, the maths it adds and the CRBA mass
matrix against the JAX package, on the CPU, on the bundled Franka Panda
stand-in (assets/urdf/franka_description/robots/franka_panda.urdf; the JAX
side reads it through $ISAACGYMENVS_TPU_ASSETS).

Tolerances: the maths additions 1e-6; `mass_matrix` and `spd_inverse`
rtol 1e-5 (atol 1e-6 of the largest entry); each controller function
against the JAX one, vmapped over the same forward-kinematics states,
rtol 1e-5 (the OSC and IK outputs go through 6 x 6 inverses and
decompositions, whose condition numbers of about 2e3 at these poses
amplify float32 rounding: rtol 1e-4 with an atol of 1e-5 of the largest
entry; they came within 2e-5 and 7e-5 relative). The OSC's float32
comparison leaves out only the poses where both packages' float32 OSC lie
more than a quarter of that tolerance from their float64 OSC (float32
does not determine the answer there, in either package), and the port's
float64 OSC equals JAX's at 1e-9 on every pose. Then the
port's counterparts of tests/test_controllers.py: the Jacobian against
finite differences, IK convergence with dls, pinv and svd, and the OSC's
direction.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import controllers, maths
from isaacgymenvs_tpu_torch.engine import dynamics as dyn
from isaacgymenvs_tpu_torch.model import load_urdf
from isaacgymenvs_tpu_torch.utils.assets import package_asset_root
from jax_memory_guard import free_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(1)

FRANKA = os.path.join(package_asset_root(), "urdf", "franka_description", "robots", "franka_panda.urdf")
N = 16


def _unit(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def close(port, ref, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_maths_additions_match_jax():
    """quat_to_angle_axis (random rotations, near the identity, at angle pi,
    the identity itself), tf_inverse, tf_apply, tf_combine, tf_vector and
    spatial_inertia_at_origin against the JAX package at 1e-6."""
    from isaacgymenvs_tpu import maths as jm

    rng = np.random.RandomState(0)
    q = _unit(rng, 64)
    tiny = np.concatenate([1e-4 * rng.normal(size=(8, 3)), np.ones((8, 1))], 1)
    q[8:16] = tiny / np.linalg.norm(tiny, axis=-1, keepdims=True)  # near the identity
    axis = rng.normal(size=(8, 3))
    q[16:24] = np.concatenate([axis / np.linalg.norm(axis, axis=-1, keepdims=True), np.zeros((8, 1))], 1)  # pi
    q[24] = [0.0, 0.0, 0.0, 1.0]
    ja, jx = jm.quat_to_angle_axis(jnp.asarray(q))
    ta, tx = maths.quat_to_angle_axis(torch.tensor(q))
    close(ta, ja)
    close(tx, jx)
    np.testing.assert_allclose(ta[16:24].numpy(), np.pi, atol=1e-6)
    assert float(ta[24]) == 0.0 and tx[24].tolist() == [1.0, 0.0, 0.0]
    t, v = rng.normal(size=(64, 3)).astype(np.float32), rng.normal(size=(64, 3)).astype(np.float32)
    q2, t2 = _unit(rng, 64), rng.normal(size=(64, 3)).astype(np.float32)
    J, T = jnp.asarray, torch.tensor
    for a, b in zip(jm.tf_inverse(J(q), J(t)), maths.tf_inverse(T(q), T(t))):
        close(b, a)
    close(maths.tf_apply(T(q), T(t), T(v)), jm.tf_apply(J(q), J(t), J(v)))
    close(maths.tf_vector(T(q), T(v)), jm.tf_vector(J(q), J(v)))
    for a, b in zip(jm.tf_combine(J(q), J(t), J(q2), J(t2)), maths.tf_combine(T(q), T(t), T(q2), T(t2))):
        close(b, a)
    mass = rng.uniform(0.1, 5.0, 64).astype(np.float32)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    inertia = (A @ A.transpose(0, 2, 1) * 0.01).astype(np.float32)
    close(maths.spatial_inertia_at_origin(T(mass), T(t), T(inertia)),
          jm.spatial_inertia_at_origin(J(mass), J(t), J(inertia)), rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def franka():
    """Both packages' Franka and N forward-kinematics states of arm poses
    within 0.5 rad of FrankaCubeStack's default (away from the arm's
    singular poses, where the 6 x 6 inverses of the controllers amplify
    float32 rounding without bound) and random velocities; the same numbers
    on both sides."""
    from isaacgymenvs_tpu.engine import dynamics as jdyn
    from isaacgymenvs_tpu.model import load_urdf as jload_urdf

    tm, jm = load_urdf(FRANKA, fix_base=True), jload_urdf(FRANKA, fix_base=True)
    rng = np.random.RandomState(1)
    q = np.tile(np.asarray(tm.qpos0, np.float32), (N, 1))
    default = np.array([0.0, 0.1963, 0.0, -2.6180, 0.0, 2.9416, 0.7854, 0.035, 0.035])
    q[:, :9] = (default + np.r_[[0.5] * 7, [0.005] * 2] * rng.uniform(-1, 1, (N, 9))).astype(np.float32)
    qd = rng.uniform(-1, 1, (N, tm.nv)).astype(np.float32)
    meta = jdyn.kin_meta(jm)
    jfk = jax.jit(jax.vmap(lambda a, b: jdyn.forward_kinematics(jm, a, b, meta)))
    jkin = jfk(jnp.asarray(q), jnp.asarray(qd))
    tkin = dyn.forward_kinematics(tm, torch.tensor(q), torch.tensor(qd))
    return tm, jm, tkin, jkin, q, qd


def test_mass_matrix_and_spd_inverse_match_jax(franka):
    """`mass_matrix` (N, 9, 9) and `spd_inverse` of its arm block + 1e-6 I
    (FrankaCubeStack's M77) against the JAX functions vmapped: rtol 1e-5;
    M symmetric, positive definite, and M^-1 M = I within 1e-4."""
    from isaacgymenvs_tpu.engine import dynamics as jdyn

    tm, jm, tkin, jkin, _, _ = franka
    janc, jmask = jnp.asarray(jdyn.ancestor_matrix(jm)), jnp.asarray(jdyn.dof_ancestor_mask(jm))
    jM = jax.vmap(lambda k: jdyn.mass_matrix(jm, k, (janc, jmask)))(jkin)
    masks = (torch.tensor(dyn.ancestor_matrix(tm)), torch.tensor(dyn.dof_ancestor_mask(tm)))
    tM = dyn.mass_matrix(tm, tkin, masks)
    scale = float(np.abs(np.asarray(jM)).max())
    close(tM, jM, rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(tM, tM.transpose(1, 2)) and bool((torch.linalg.eigvalsh(tM) > 0).all())
    M77 = tM[:, :7, :7] + 1e-6 * torch.eye(7)
    jinv = jax.vmap(jdyn.spd_inverse)(jnp.asarray(M77.numpy()))
    tinv = dyn.spd_inverse(M77)
    close(tinv, jinv, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(jinv)).max()))
    np.testing.assert_allclose((tinv @ M77).numpy(), np.broadcast_to(np.eye(7), (N, 7, 7)), atol=1e-4)


def test_controller_functions_match_jax(franka):
    """body_jacobian of the hand's grip site, pose_error, get_delta_dof_pos
    (pinv, trans, dls, svd), joint_space_pd (with and without the mass
    matrix), task_space_impedance and operational_space_control (with and
    without the null-space term) against the JAX functions vmapped over
    the same states."""
    from isaacgymenvs_tpu import controllers as jc
    from isaacgymenvs_tpu.engine import dynamics as jdyn

    tm, jm, tkin, jkin, q, qd = franka
    hand = tm.body_names.index("panda_hand")
    anc, dof_body = dyn.ancestor_matrix(tm), np.asarray(tm.dof_body)
    off = torch.tensor([0.0, 0.0, 0.1])
    site = tkin.x[:, hand] + maths.quat_rotate(tkin.quat[:, hand], off.expand(N, 3))
    tJ = controllers.body_jacobian(tkin, anc, dof_body, hand, site)
    jJ = jax.vmap(lambda k, p: jc.body_jacobian(k, jnp.asarray(anc), dof_body, hand, p))(jkin, jnp.asarray(site.numpy()))
    close(tJ, jJ, rtol=1e-5, atol=1e-6)
    # the same Jacobian from device tensors of the topology
    assert torch.equal(controllers.body_jacobian(tkin, torch.tensor(anc), torch.tensor(dof_body), hand, site), tJ)

    rng = np.random.RandomState(2)
    tgt_p = site.numpy() + rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32)
    tgt_q = _unit(rng, N)
    terr = controllers.pose_error(site, tkin.quat[:, hand], torch.tensor(tgt_p), torch.tensor(tgt_q))
    jerr = jax.vmap(jc.pose_error)(jnp.asarray(site.numpy()), jkin.quat[:, hand], jnp.asarray(tgt_p),
                                   jnp.asarray(tgt_q))
    close(terr, jerr, rtol=1e-5, atol=1e-6)
    J7, jJ7 = tJ[:, :, :7], jnp.asarray(tJ[:, :, :7].numpy())
    dp = jnp.asarray(terr.numpy())
    for method in ("pinv", "trans", "dls", "svd"):
        t = controllers.get_delta_dof_pos(terr, J7, method)
        j = jax.vmap(lambda e, a: jc.get_delta_dof_pos(e, a, method))(dp, jJ7)
        close(t, j, rtol=1e-4, atol=1e-5 * float(np.abs(np.asarray(j)).max()))
    with pytest.raises(ValueError):
        controllers.get_delta_dof_pos(terr, J7, "newton")

    janc, jmask = jnp.asarray(jdyn.ancestor_matrix(jm)), jnp.asarray(jdyn.dof_ancestor_mask(jm))
    masks = (torch.tensor(anc), torch.tensor(dyn.dof_ancestor_mask(tm)))
    tM = dyn.mass_matrix(tm, tkin, masks)[:, :7, :7]
    jM = jnp.asarray(tM.numpy())
    q_err = rng.uniform(-0.2, 0.2, (N, 7)).astype(np.float32)
    qd7 = qd[:, :7]
    for M, jMM in ((None, None), (tM, jM)):
        t = controllers.joint_space_pd(torch.tensor(q_err), torch.tensor(qd7), 40.0, 8.0, M)
        if M is None:
            j = jax.vmap(lambda e, v: jc.joint_space_pd(e, v, 40.0, 8.0))(jnp.asarray(q_err), jnp.asarray(qd7))
        else:
            j = jax.vmap(lambda e, v, mm: jc.joint_space_pd(e, v, 40.0, 8.0, mm))(jnp.asarray(q_err),
                                                                                 jnp.asarray(qd7), jMM)
        close(t, j, rtol=1e-5, atol=1e-5)
    vel = rng.uniform(-0.5, 0.5, (N, 6)).astype(np.float32)
    close(controllers.task_space_impedance(J7, terr, torch.tensor(vel), 150.0, 24.0),
          jax.vmap(lambda a, e, v: jc.task_space_impedance(a, e, v, 150.0, 24.0))(jJ7, dp, jnp.asarray(vel)),
          rtol=1e-5, atol=1e-4)
    for with_null in (False, True):
        t, j, t64, j64 = _osc_both(J7, tM, terr, vel, qd7, q_err, with_null)
        keep = osc_conditioned_close(t, j, t64, j64)
        assert int(keep.sum()) >= N // 2, keep


# an env leaves the float32 OSC comparison only where both packages' float32
# OSC lie more than this share of the comparison's tolerance from their
# float64 OSC (a quarter, as torch_conditioning.COND_TOL is of the physics
# step's tolerances)
OSC_COND_SHARE = 0.25


def _osc_both(J7, tM, terr, vel, qd7, q_err, with_null):
    """operational_space_control of both packages at the same inputs (the
    JAX one vmapped), in float32 and in float64: (port, JAX, port float64,
    JAX float64), numpy (N, 7)."""
    from isaacgymenvs_tpu import controllers as jc

    tinv = dyn.spd_inverse(tM + 1e-6 * torch.eye(7))
    jkw = (lambda e: {"q_err": e}) if with_null else (lambda e: {})
    jfn = jax.vmap(lambda a, mi, e, v, w, qe: jc.operational_space_control(a, mi, e, v, w, 150.0, 24.0, 10.0, 6.3,
                                                                           **jkw(qe)))
    narrow = [x.numpy() for x in (J7, tinv, terr)] + [vel, qd7]
    out = []
    for dtype in (np.float32, np.float64):
        ins = [x.astype(dtype) for x in narrow]
        qe = q_err.astype(dtype)
        t = controllers.operational_space_control(*map(torch.tensor, ins), 150.0, 24.0, 10.0, 6.3,
                                                  **({"q_err": torch.tensor(qe)} if with_null else {}))
        with jax.enable_x64(dtype == np.float64):
            j = np.asarray(jfn(*map(jnp.asarray, ins), jnp.asarray(qe)))
        out.append((t.numpy(), j))
    (t, j), (t64, j64) = out
    return t, j, t64, j64


def osc_conditioned_close(t, j, t64, j64, rtol=1e-4, atol_share=1e-5):
    """The port's float64 OSC equals JAX's in every env (1e-9); the float32
    ones agree (rtol 1e-4, atol 1e-5 of the largest entry) on every env but
    those where both lie more than OSC_COND_SHARE of that tolerance from
    their float64 OSC. Returns the (N,) mask of the envs compared."""
    np.testing.assert_allclose(t64, j64, rtol=1e-9, atol=1e-9)
    tol = atol_share * float(np.abs(j).max()) + rtol * np.abs(j64)
    share = lambda a, ref: (np.abs(a - ref) / tol).max(-1)
    keep = (share(t, t64) <= OSC_COND_SHARE) | (share(j, j64) <= OSC_COND_SHARE)
    close(torch.tensor(t[keep]), j[keep], rtol=rtol, atol=atol_share * float(np.abs(j).max()))
    return keep


def test_osc_conditioning_keeps_port_faults(franka):
    """The conditioned OSC comparison fails where the port's float32 OSC
    alone is off: the port's output moved by ten tolerances in an env where
    JAX's float32 OSC lies within OSC_COND_SHARE of its float64 one stays
    compared, and the assertion fails."""
    tm, jm, tkin, jkin, q, qd = franka
    hand = tm.body_names.index("panda_hand")
    anc, dof_body = dyn.ancestor_matrix(tm), np.asarray(tm.dof_body)
    site = tkin.x[:, hand] + maths.quat_rotate(tkin.quat[:, hand], torch.tensor([0.0, 0.0, 0.1]).expand(N, 3))
    J7 = controllers.body_jacobian(tkin, anc, dof_body, hand, site)[:, :, :7]
    rng = np.random.RandomState(2)
    terr = controllers.pose_error(site, tkin.quat[:, hand], site + torch.tensor(rng.uniform(-0.1, 0.1, (N, 3)),
                                                                              dtype=torch.float32),
                                  torch.tensor(_unit(rng, N)))
    masks = (torch.tensor(anc), torch.tensor(dyn.dof_ancestor_mask(tm)))
    tM = dyn.mass_matrix(tm, tkin, masks)[:, :7, :7]
    q_err = rng.uniform(-0.2, 0.2, (N, 7)).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, (N, 6)).astype(np.float32)
    t, j, t64, j64 = _osc_both(J7, tM, terr, vel, qd[:, :7], q_err, True)
    osc_conditioned_close(t, j, t64, j64)
    tol = 1e-5 * float(np.abs(j).max()) + 1e-4 * np.abs(j64)
    jax_near = (np.abs(j - j64) / tol).max(-1) <= OSC_COND_SHARE
    e = int(np.flatnonzero(jax_near)[0])
    bad = t.copy()
    bad[e] += 10 * tol[e]  # the port's float32 now ten tolerances off float64, JAX's within a quarter
    with pytest.raises(AssertionError, match="Mismatched elements"):
        osc_conditioned_close(bad, j, t64, j64)


def _arm_q(tm, values):
    q = torch.tensor(np.asarray(tm.qpos0, np.float32))[None].clone()
    q[0, :7] = torch.tensor(values)
    return q


def test_jacobian_matches_finite_difference():
    """tests/test_controllers.py::test_jacobian_matches_finite_difference on
    the port: the hand's linear Jacobian columns against forward differences
    of its position, atol 5e-3."""
    tm = load_urdf(FRANKA, fix_base=True)
    anc, hand = dyn.ancestor_matrix(tm), tm.body_names.index("panda_hand")
    q0 = _arm_q(tm, [0.5, -0.8, 0.3, -2.0, 0.1, 1.5, 0.2])
    zero = torch.zeros(1, tm.nv)
    kin = dyn.forward_kinematics(tm, q0, zero)
    J = controllers.body_jacobian(kin, anc, tm.dof_body, hand, kin.x[:, hand])
    eps = 1e-3
    for d in range(7):
        qp = q0.clone()
        qp[0, tm.q_adr[tm.dof_body[d]]] += eps
        dlin = (dyn.forward_kinematics(tm, qp, zero).x[:, hand] - kin.x[:, hand]) / eps
        np.testing.assert_allclose(J[0, 3:, d].numpy(), dlin[0].numpy(), atol=5e-3)


@pytest.mark.parametrize("method", ["dls", "pinv", "svd"])
def test_diff_ik_converges(method):
    """tests/test_controllers.py::test_diff_ik_converges on the port: 30
    half steps of differential IK bring the hand within 5 mm of a target
    5-7 cm away, its rotation held."""
    tm = load_urdf(FRANKA, fix_base=True)
    anc, hand = dyn.ancestor_matrix(tm), tm.body_names.index("panda_hand")
    q = _arm_q(tm, [0.0, -0.5, 0.0, -1.8, 0.0, 1.4, 0.0])
    zero = torch.zeros(1, tm.nv)
    kin = dyn.forward_kinematics(tm, q, zero)
    target_pos, target_rot = kin.x[:, hand] + torch.tensor([0.05, -0.03, 0.04]), kin.quat[:, hand]
    for _ in range(30):
        k = dyn.forward_kinematics(tm, q, zero)
        err = controllers.pose_error(k.x[:, hand], k.quat[:, hand], target_pos, target_rot)
        J = controllers.body_jacobian(k, anc, tm.dof_body, hand, k.x[:, hand])
        q[:, :7] += 0.5 * controllers.get_delta_dof_pos(err, J, method=method)[:, :7]
    final = float(torch.linalg.vector_norm(dyn.forward_kinematics(tm, q, zero).x[0, hand] - target_pos[0]))
    assert final < 0.005, (method, final)


def test_osc_torque_direction():
    """tests/test_controllers.py::test_osc_torque_direction on the port: at
    the model's default pose, a +x task-space error gives +x hand
    acceleration."""
    tm = load_urdf(FRANKA, fix_base=True)
    anc, hand = dyn.ancestor_matrix(tm), tm.body_names.index("panda_hand")
    q = torch.tensor(np.asarray(tm.qpos0, np.float32))[None]
    kin = dyn.forward_kinematics(tm, q, torch.zeros(1, tm.nv))
    M = dyn.mass_matrix(tm, kin, (torch.tensor(anc), torch.tensor(dyn.dof_ancestor_mask(tm))))
    Minv = dyn.spd_inverse(M + 1e-4 * torch.eye(tm.nv))
    J = controllers.body_jacobian(kin, anc, tm.dof_body, hand, kin.x[:, hand])
    err = torch.tensor([[0.0, 0.0, 0.0, 0.1, 0.0, 0.0]])
    tau = controllers.operational_space_control(J, Minv, err, torch.zeros(1, 6), torch.zeros(1, tm.nv), kp=100.0,
                                                kd=10.0)
    xdd = (J @ (Minv @ tau[..., None]))[0, 3:, 0]
    assert float(xdd[0]) > 0
