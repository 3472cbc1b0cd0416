"""Quaternion helpers on batched tensors (port of isaacgymenvs_tpu/maths.py).

Only what the ported tasks and the two physics engines use. Conventions as
in the JAX package: quaternions are (x, y, z, w) with the scalar last,
rotations are active, angles are radians, and every function broadcasts
over leading batch dimensions.
"""
from __future__ import annotations

import math

import torch


def normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Unit-normalize along the last axis."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, xyzw layout."""
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return normalize(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q over broadcastable batch dims."""
    xyz, w = q[..., :3], q[..., 3:4]
    xyz, v = torch.broadcast_tensors(xyz, v)
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v + w * t + torch.linalg.cross(xyz, t, dim=-1)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_axis(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The basis vector `axis` rotated by q."""
    basis = q.new_zeros(q.shape[:-1] + (3,))
    basis[..., axis] = 1.0
    return quat_rotate(q, basis)


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> quaternion (..., 4), Taylor-safe at 0."""
    angle_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle_sq, min=1e-24))
    small = angle_sq < 1e-12
    s = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(0.5 * angle) / angle)
    w = torch.where(small, 1.0 - angle_sq / 8.0, torch.cos(0.5 * angle))
    return torch.cat([phi * s, w], dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation q by world-frame angular velocity omega over dt."""
    return quat_unit(quat_mul(quat_exp(omega * dt), q))


def get_euler_xyz(q: torch.Tensor):
    """Quaternion -> (roll, pitch, yaw), each wrapped to [0, 2pi)."""
    qx, qy, qz, qw = q.unbind(-1)
    roll = torch.atan2(2.0 * (qw * qx + qy * qz), qw * qw - qx * qx - qy * qy + qz * qz)
    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.sign(sinp) * (math.pi / 2.0),
        torch.asin(torch.clamp(sinp, -1.0, 1.0)),
    )
    yaw = torch.atan2(2.0 * (qw * qz + qx * qy), qw * qw + qx * qx - qy * qy - qz * qz)
    two_pi = 2.0 * math.pi
    return roll % two_pi, pitch % two_pi, yaw % two_pi


def normalize_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def scale(x, lower, upper):
    return 0.5 * (x + 1.0) * (upper - lower) + lower


def unscale(x, lower, upper):
    return (2.0 * x - upper - lower) / (upper - lower)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Rotation of `angle` about `axis` (normalized here) as a unit quaternion."""
    theta = (angle / 2)[..., None]
    xyz = normalize(axis) * torch.sin(theta)
    return quat_unit(torch.cat([xyz, torch.cos(theta)], dim=-1))


def calc_heading(q: torch.Tensor) -> torch.Tensor:
    """Heading about z of q's x-axis: atan2 of its rotated y over x."""
    ref = q.new_zeros(q.shape[:-1] + (3,))
    ref[..., 0] = 1.0
    rot = quat_rotate(q, ref)
    return torch.atan2(rot[..., 1], rot[..., 0])


def calc_heading_quat(q: torch.Tensor) -> torch.Tensor:
    """The yaw-only part of q: a rotation about z by its heading."""
    axis = q.new_zeros(q.shape[:-1] + (3,))
    axis[..., 2] = 1.0
    return quat_from_angle_axis(calc_heading(q), axis)


def calc_heading_quat_inv(q: torch.Tensor) -> torch.Tensor:
    """The inverse of `calc_heading_quat`: a rotation about z by minus q's heading."""
    axis = q.new_zeros(q.shape[:-1] + (3,))
    axis[..., 2] = 1.0
    return quat_from_angle_axis(-calc_heading(q), axis)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation from q0 (t = 0) to q1 (t = 1) along the
    shorter arc; a linear blend where the arc is below 1e-4."""
    cos_half = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(cos_half < 0, -q1, q1)
    cos_half = torch.abs(cos_half)
    half = torch.arccos(torch.clamp(cos_half, -1.0, 1.0))
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=0.0))
    small = sin_half < 1e-4
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() < q0.dim():
        t = t[..., None]
    ratio_a = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * half) / torch.clamp(sin_half, min=1e-9))
    ratio_b = torch.where(small, t, torch.sin(t * half) / torch.clamp(sin_half, min=1e-9))
    return quat_unit(ratio_a * q0 + ratio_b * q1)


def quat_to_tan_norm(q: torch.Tensor) -> torch.Tensor:
    """6-D rotation representation: q's x axis (tangent) and z axis (normal)."""
    return torch.cat([quat_axis(q, 0), quat_axis(q, 2)], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix: skew(v) @ u == cross(v, u); (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    vx, vy, vz = v.unbind(-1)
    return torch.stack([
        torch.stack([z, -vz, vy], dim=-1),
        torch.stack([vz, z, -vx], dim=-1),
        torch.stack([-vy, vx, z], dim=-1),
    ], dim=-2)


def quat_to_angle_axis(q: torch.Tensor):
    """(angle in [0, 2pi), unit axis) of q; the x axis where the rotation
    is below the float resolution."""
    sin_theta_sq = torch.sum(q[..., :3] ** 2, dim=-1)
    sin_theta = torch.sqrt(sin_theta_sq)
    angle = 2.0 * torch.atan2(sin_theta, q[..., 3])
    unit_x = q.new_tensor([1.0, 0.0, 0.0]).expand(q[..., :3].shape)
    axis = torch.where((sin_theta_sq > 1e-12)[..., None],
                       q[..., :3] / torch.clamp(sin_theta, min=1e-12)[..., None], unit_x)
    return angle, axis


# rigid transforms (q, t): the point v maps to quat_rotate(q, v) + t
def tf_apply(q: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(q, v) + t


def tf_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(q, v)


def tf_inverse(q: torch.Tensor, t: torch.Tensor):
    q_inv = quat_conjugate(q)
    return q_inv, -quat_rotate(q_inv, t)


def tf_combine(q1, t1, q2, t2):
    """The transform (q1, t1) after (q2, t2)."""
    return quat_mul(q1, q2), quat_rotate(q1, t2) + t1


def spatial_inertia_at_origin(mass, com_world, inertia_world):
    """6x6 spatial inertia about the world origin: mass (...,), com_world
    (..., 3), inertia_world (..., 3, 3) about the CoM. With v = (omega, v_o)
    and h = (L_o, p): p = m v_o - m [c]x omega, L_o = (I_c - m [c]x [c]x)
    omega + m [c]x v_o."""
    cx = skew(com_world)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    top = torch.cat([inertia_world - m * (cx @ cx), m * cx], dim=-1)
    bottom = torch.cat([-m * cx, m * eye], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def spatial_cross_motion(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v x m for motion vectors m; v, m (..., 6)."""
    w, vo = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    return torch.cat([cross(w, mw), cross(w, mv) + cross(vo, mw)], dim=-1)


def spatial_cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """v x* f for force vectors f; v, f (..., 6)."""
    w, vo = v[..., :3], v[..., 3:]
    n, p = f[..., :3], f[..., 3:]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    return torch.cat([cross(w, n) + cross(vo, p), cross(w, p)], dim=-1)
