"""Task-space controller library (port of isaacgymenvs_tpu/controllers.py),
batched over a leading env axis.

Differential IK (`get_delta_dof_pos`: pinv / trans / dls / svd), joint-space
PD with optional inertial compensation, task-space impedance, and
operational-space control with the task-space mass matrix and a
dynamically consistent null-space posture term, after the reference's
Factory controllers (factory_control.py) and FrankaCubeStack's OSC. The
body Jacobian is assembled from the engine's world-frame joint subspace.

Task-space vectors are ordered (angular, linear) throughout, as the JAX
package orders them. Every function takes (N, ...) tensors; the matrix
inverses do not read back their status, so a call on the card does not
wait for the device.
"""
from __future__ import annotations

import torch

from . import maths
from .engine.dynamics import Kin


def body_jacobian(kin: Kin, anc, dof_body, body: int, point: torch.Tensor) -> torch.Tensor:
    """(N, 6, nv) Jacobian of a world point (N, 3) attached to `body`: rows
    (angular, linear). `anc` is `dynamics.ancestor_matrix` and `dof_body`
    the model's dof-to-body map (arrays, or tensors on kin's device, which
    a caller on the card passes to save the copies); only the dofs on the
    path from the root to `body` contribute."""
    dev = kin.S.device
    anc = torch.as_tensor(anc, dtype=kin.S.dtype, device=dev)
    path = anc[body][torch.as_tensor(dof_body, dtype=torch.int64, device=dev)]
    S_ang = kin.S[..., :3] * path[:, None]  # (N, nv, 3)
    # linear velocity of the point from dof d: S_lin_d + S_ang_d x point
    lin = (kin.S[..., 3:] + torch.linalg.cross(kin.S[..., :3], point[:, None, :].expand_as(S_ang), dim=-1)) \
        * path[:, None]
    return torch.cat([S_ang.transpose(-1, -2), lin.transpose(-1, -2)], dim=-2)


def pose_error(pos, quat, target_pos, target_quat) -> torch.Tensor:
    """(N, 6) task-space error: (angular axis * angle, linear)."""
    dq = maths.quat_mul(target_quat, maths.quat_conjugate(quat))
    angle, axis = maths.quat_to_angle_axis(dq)
    angle = maths.normalize_angle(angle)
    return torch.cat([axis * angle[..., None], target_pos - pos], dim=-1)


def get_delta_dof_pos(delta_pose: torch.Tensor, jacobian: torch.Tensor, method: str = "dls",
                      lam: float = 0.1) -> torch.Tensor:
    """Differential IK: delta_pose (N, 6) (angular, linear), jacobian (N, 6,
    nv) -> (N, nv)."""
    J, dp = jacobian, delta_pose[..., None]
    if method == "pinv":
        return (torch.linalg.pinv(J) @ dp)[..., 0]
    if method == "trans":
        return (J.transpose(-1, -2) @ dp)[..., 0]
    if method == "dls":  # damped least squares (Levenberg-Marquardt)
        A = J @ J.transpose(-1, -2) + (lam ** 2) * torch.eye(6, dtype=J.dtype, device=J.device)
        return (J.transpose(-1, -2) @ torch.linalg.solve_ex(A, dp)[0])[..., 0]
    if method == "svd":
        u, s, vt = torch.linalg.svd(J, full_matrices=False)
        s_inv = torch.where(s > 1e-5, 1.0 / s, torch.zeros_like(s))
        return (vt.transpose(-1, -2) @ (s_inv[..., None] * (u.transpose(-1, -2) @ dp)))[..., 0]
    raise ValueError(method)


def joint_space_pd(q_err, qd, kp, kd, mass_matrix=None) -> torch.Tensor:
    """Joint-space PD, with inertial compensation when `mass_matrix` (N,
    nv, nv) is given."""
    tau = kp * q_err - kd * qd
    if mass_matrix is not None:
        tau = (mass_matrix @ tau[..., None])[..., 0]
    return tau


def task_space_impedance(jacobian, pose_err, body_vel, kp, kd) -> torch.Tensor:
    """tau = J^T (kp err - kd xdot)."""
    wrench = kp * pose_err - kd * body_vel
    return (jacobian.transpose(-1, -2) @ wrench[..., None])[..., 0]


def operational_space_control(jacobian, mass_matrix_inv, pose_err, body_vel, qd, kp, kd,
                              null_kp: float = 10.0, null_kd: float = 1.0, q_err=None) -> torch.Tensor:
    """OSC with the task-space mass matrix Lambda = (J M^-1 J^T)^-1:
    tau = J^T Lambda (kp err - kd xdot), plus, with `q_err`, the posture
    task kp_null q_err - kd_null qd projected into the null space by
    (I - J^T Jbar^T), Jbar = M^-1 J^T Lambda."""
    J, Jt = jacobian, jacobian.transpose(-1, -2)
    eye6 = torch.eye(6, dtype=J.dtype, device=J.device)
    lam = torch.linalg.inv_ex(J @ mass_matrix_inv @ Jt + 1e-6 * eye6)[0]
    wrench = lam @ (kp * pose_err - kd * body_vel)[..., None]
    tau = (Jt @ wrench)[..., 0]
    if q_err is not None:
        Jbar = mass_matrix_inv @ Jt @ lam
        null_tau = (null_kp * q_err - null_kd * qd)[..., None]
        eye = torch.eye(J.shape[-1], dtype=J.dtype, device=J.device)
        tau = tau + ((eye - Jt @ Jbar.transpose(-1, -2)) @ null_tau)[..., 0]
    return tau
