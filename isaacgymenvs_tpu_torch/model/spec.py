"""Model: the static description of an articulated rigid-body system.

Port of isaacgymenvs_tpu/model/spec.py. The fields and their meaning are
the JAX package's; here every parameter is a numpy array on the host, and
`Model.to(device)` gives a view of the float parameters as torch tensors.

Joint model: every body is connected to its parent by exactly ONE joint
(FREE / HINGE / SLIDE / FIXED); MJCF bodies with several joints are
expanded at parse time into chains of massless links.

Coordinate layout:
  q  : per body, FREE -> 7 (pos xyz, quat xyzw), HINGE/SLIDE -> 1, FIXED -> 0
  qd : per body, FREE -> 6 (linear vel world, angular vel world), else 1
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# joint types
FREE = 0
HINGE = 1
SLIDE = 2
FIXED = 3

# geom types
GEOM_SPHERE = 0
GEOM_CAPSULE = 1
GEOM_BOX = 2
GEOM_CYLINDER = 3
GEOM_PLANE = 4
GEOM_MESH = 5

_QDIM = {FREE: 7, HINGE: 1, SLIDE: 1, FIXED: 0}
_VDIM = {FREE: 6, HINGE: 1, SLIDE: 1, FIXED: 0}


def qdim(jnt_type: int) -> int:
    return _QDIM[jnt_type]


def vdim(jnt_type: int) -> int:
    return _VDIM[jnt_type]


@dataclasses.dataclass
class Model:
    """Articulated system description. See module docstring."""

    # ---- static topology ----
    nbody: int
    nq: int
    nv: int
    nu: int
    body_parent: Tuple[int, ...]  # -1 = world
    jnt_type: Tuple[int, ...]  # per body
    q_adr: Tuple[int, ...]
    v_adr: Tuple[int, ...]
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    dof_body: Tuple[int, ...]
    actuator_dof: Tuple[int, ...]
    actuator_names: Tuple[str, ...]
    cpoint_body: Tuple[int, ...]
    geom_body: Tuple[int, ...]
    geom_type: Tuple[int, ...]
    # ---- parameters (float32 numpy arrays) ----
    body_pos: np.ndarray  # (nbody, 3) frame offset in parent frame
    body_quat: np.ndarray  # (nbody, 4) xyzw
    body_ipos: np.ndarray  # (nbody, 3) CoM in body frame
    body_inertia: np.ndarray  # (nbody, 3, 3) about CoM, body frame
    body_mass: np.ndarray  # (nbody,)
    jnt_axis: np.ndarray  # (nbody, 3)
    jnt_pos: np.ndarray  # (nbody, 3)
    armature: np.ndarray  # (nv,)
    dof_damping: np.ndarray
    dof_stiffness: np.ndarray
    dof_limit_lower: np.ndarray
    dof_limit_upper: np.ndarray
    dof_limited: np.ndarray
    dof_max_effort: np.ndarray
    dof_max_velocity: np.ndarray
    gear: np.ndarray  # (nu,)
    ctrl_range: np.ndarray  # (nu, 2)
    geom_pos: np.ndarray  # (ngeom, 3)
    geom_quat: np.ndarray
    geom_size: np.ndarray
    geom_friction: np.ndarray
    cpoint_pos: np.ndarray  # (ncp, 3) body frame
    cpoint_radius: np.ndarray
    cpoint_friction: np.ndarray
    qpos0: np.ndarray  # (nq,)
    # ---- optional interaction declarations ----
    pair_geom_a: Tuple[int, ...] = ()
    pair_geom_b: Tuple[int, ...] = ()
    ppair_point: Tuple[int, ...] = ()
    ppair_geom: Tuple[int, ...] = ()
    plane_contacts: bool = True
    att_body: Tuple[int, ...] = ()
    att_offset: np.ndarray | None = None
    att_target: np.ndarray | None = None
    tendon_names: Tuple[str, ...] = ()
    tendon_coef: np.ndarray | None = None
    tendon_range: np.ndarray | None = None
    tendon_stiffness: np.ndarray | None = None
    tendon_damping: np.ndarray | None = None
    dof_friction: np.ndarray | None = None
    cpoint_restitution: np.ndarray | None = None
    sdf_body: Tuple[int, ...] = ()
    sdf_spacing: Tuple[float, ...] = ()
    sdf_values: Tuple[np.ndarray, ...] = ()
    sdf_origin: Tuple[np.ndarray, ...] = ()
    spair_point: Tuple[int, ...] = ()
    spair_sdf: Tuple[int, ...] = ()

    @property
    def ngeom(self) -> int:
        return len(self.geom_type)

    @property
    def ncp(self) -> int:
        return len(self.cpoint_body)

    def dof_joint_names(self) -> Tuple[str, ...]:
        """Name of the joint owning each dof (a free joint gives 6)."""
        return tuple(self.joint_names[self.dof_body[d]] for d in range(self.nv))

    def replace(self, **changes) -> "Model":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "ModelTensors":
        """The float parameters as float32 tensors on `device`."""
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return ModelTensors(
            body_pos=t(self.body_pos),
            body_quat=t(self.body_quat),
            body_ipos=t(self.body_ipos),
            body_inertia=t(self.body_inertia),
            body_mass=t(self.body_mass),
            jnt_axis=t(self.jnt_axis),
            jnt_pos=t(self.jnt_pos),
            dof_limit_lower=t(self.dof_limit_lower),
            dof_limit_upper=t(self.dof_limit_upper),
            gear=t(self.gear),
            qpos0=t(self.qpos0),
        )


@dataclasses.dataclass
class ModelTensors:
    """Tensor view of a Model's float parameters (see Model.to)."""

    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_ipos: torch.Tensor
    body_inertia: torch.Tensor
    body_mass: torch.Tensor
    jnt_axis: torch.Tensor
    jnt_pos: torch.Tensor
    dof_limit_lower: torch.Tensor
    dof_limit_upper: torch.Tensor
    gear: torch.Tensor
    qpos0: torch.Tensor


def _np(x, dtype=np.float32):
    return np.asarray(x, dtype=dtype)


def _quat_rotate_np(q, v):
    q = np.asarray(q, np.float32)
    v = np.asarray(v, np.float32)
    xyz, w = q[:3], q[3]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


@dataclasses.dataclass
class ModelBuilder:
    """Mutable host-side builder used by the MJCF parser and by tests."""

    body_parent: list = dataclasses.field(default_factory=list)
    jnt_type: list = dataclasses.field(default_factory=list)
    body_names: list = dataclasses.field(default_factory=list)
    joint_names: list = dataclasses.field(default_factory=list)
    body_pos: list = dataclasses.field(default_factory=list)
    body_quat: list = dataclasses.field(default_factory=list)
    body_ipos: list = dataclasses.field(default_factory=list)
    body_inertia: list = dataclasses.field(default_factory=list)
    body_mass: list = dataclasses.field(default_factory=list)
    jnt_axis: list = dataclasses.field(default_factory=list)
    jnt_pos: list = dataclasses.field(default_factory=list)
    armature: list = dataclasses.field(default_factory=list)
    dof_damping: list = dataclasses.field(default_factory=list)
    dof_stiffness: list = dataclasses.field(default_factory=list)
    dof_limit_lower: list = dataclasses.field(default_factory=list)
    dof_limit_upper: list = dataclasses.field(default_factory=list)
    dof_limited: list = dataclasses.field(default_factory=list)
    dof_max_effort: list = dataclasses.field(default_factory=list)
    dof_max_velocity: list = dataclasses.field(default_factory=list)
    actuator_joint: list = dataclasses.field(default_factory=list)
    actuator_names: list = dataclasses.field(default_factory=list)
    gear: list = dataclasses.field(default_factory=list)
    ctrl_range: list = dataclasses.field(default_factory=list)
    geom_body: list = dataclasses.field(default_factory=list)
    geom_type: list = dataclasses.field(default_factory=list)
    geom_pos: list = dataclasses.field(default_factory=list)
    geom_quat: list = dataclasses.field(default_factory=list)
    geom_size: list = dataclasses.field(default_factory=list)
    geom_friction: list = dataclasses.field(default_factory=list)
    geom_mesh_points: list = dataclasses.field(default_factory=list)  # None or (k, 3) per geom
    dof_friction_l: list = dataclasses.field(default_factory=list)
    qpos0_free: dict = dataclasses.field(default_factory=dict)  # body -> (pos, quat)
    qpos0_scalar: dict = dataclasses.field(default_factory=dict)  # body -> float
    # tendons: (name, [(joint_name, coef), ...], (lo, hi))
    tendons: list = dataclasses.field(default_factory=list)

    def add_body(
        self,
        parent: int,
        name: str,
        pos,
        quat,
        jnt_type: int,
        jnt_axis=(0.0, 0.0, 1.0),
        jnt_pos=(0.0, 0.0, 0.0),
        joint_name: str = "",
        mass: float = 0.0,
        ipos=(0.0, 0.0, 0.0),
        inertia=None,
        armature: float = 0.0,
        damping: float = 0.0,
        stiffness: float = 0.0,
        friction_loss: float = 0.0,
        limit=(None, None),
        max_effort: float = np.inf,
        max_velocity: float = np.inf,
    ) -> int:
        i = len(self.body_parent)
        if parent >= i:
            raise ValueError("bodies must be added in topological order")
        self.body_parent.append(parent)
        self.body_names.append(name)
        self.joint_names.append(joint_name)
        self.body_pos.append(_np(pos))
        self.body_quat.append(_np(quat))
        self.jnt_type.append(jnt_type)
        self.jnt_axis.append(_np(jnt_axis))
        self.jnt_pos.append(_np(jnt_pos))
        self.body_mass.append(float(mass))
        self.body_ipos.append(_np(ipos))
        self.body_inertia.append(
            _np(inertia) if inertia is not None else np.zeros((3, 3), np.float32)
        )
        lo = -1e10 if limit[0] is None else float(limit[0])
        hi = 1e10 if limit[1] is None else float(limit[1])
        limited = 0.0 if (limit[0] is None and limit[1] is None) else 1.0
        for _ in range(vdim(jnt_type)):
            self.armature.append(float(armature))
            self.dof_damping.append(float(damping))
            self.dof_friction_l.append(float(friction_loss))
            self.dof_stiffness.append(float(stiffness))
            if jnt_type == FREE:  # free-joint dofs are never limited
                self.dof_limit_lower.append(-1e10)
                self.dof_limit_upper.append(1e10)
                self.dof_limited.append(0.0)
            else:
                self.dof_limit_lower.append(lo)
                self.dof_limit_upper.append(hi)
                self.dof_limited.append(limited)
            self.dof_max_effort.append(float(max_effort))
            self.dof_max_velocity.append(float(max_velocity))
        return i

    def merge_body(self, idx: int, mass: float, ipos, inertia) -> None:
        """Fold another rigid mass (com and inertia about it, in body idx's
        frame) into body idx: masses add, the com is their weighted mean,
        and both inertias move to it by the parallel-axis shift. This is how
        a link on a fixed joint is collapsed into its parent."""
        m0 = self.body_mass[idx]
        c0 = np.asarray(self.body_ipos[idx], np.float64)
        I0 = np.asarray(self.body_inertia[idx], np.float64)
        m1 = float(mass)
        c1 = np.asarray(ipos, np.float64)
        I1 = np.asarray(inertia, np.float64)
        m = m0 + m1
        c = (m0 * c0 + m1 * c1) / m if m > 0 else c0

        def shift(I, mm, d):
            return I + mm * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

        self.body_mass[idx] = m
        self.body_ipos[idx] = _np(c)
        self.body_inertia[idx] = _np(shift(I0, m0, c0 - c) + shift(I1, m1, c1 - c))

    def add_geom(self, body: int, gtype: int, pos, quat, size, friction: float, mesh_points=None):
        """A collision geom on `body`; a MESH geom's `mesh_points` (k, 3), in
        the geom's frame, become its contact candidates."""
        self.geom_body.append(body)
        self.geom_type.append(gtype)
        self.geom_pos.append(_np(pos))
        self.geom_quat.append(_np(quat))
        self.geom_size.append(_np(size))
        self.geom_friction.append(float(friction))
        self.geom_mesh_points.append(_np(mesh_points) if mesh_points is not None else None)

    def add_tendon(self, name: str, joints, rng):
        self.tendons.append((name, list(joints), tuple(rng)))

    def add_actuator(self, joint_name: str, gear: float, ctrl_range, name: str = ""):
        self.actuator_joint.append(joint_name)
        self.gear.append(float(gear))
        self.ctrl_range.append(
            _np(ctrl_range) if ctrl_range is not None else _np([-1e10, 1e10])
        )
        self.actuator_names.append(name or joint_name)

    def finalize(self) -> Model:
        nbody = len(self.body_parent)
        q_adr, v_adr, dof_body = [], [], []
        nq = nv = 0
        for i in range(nbody):
            q_adr.append(nq)
            v_adr.append(nv)
            nq += qdim(self.jnt_type[i])
            nvd = vdim(self.jnt_type[i])
            dof_body.extend([i] * nvd)
            nv += nvd

        qpos0 = np.zeros(nq, np.float32)
        for i in range(nbody):
            if self.jnt_type[i] == FREE:
                pos, quat = self.qpos0_free.get(
                    i, (np.zeros(3, np.float32), np.array([0, 0, 0, 1], np.float32))
                )
                qpos0[q_adr[i]:q_adr[i] + 3] = pos
                qpos0[q_adr[i] + 3:q_adr[i] + 7] = quat
            elif self.jnt_type[i] in (HINGE, SLIDE):
                qpos0[q_adr[i]] = self.qpos0_scalar.get(i, 0.0)

        # actuator -> dof resolution (joint name -> first dof of that body)
        joint_to_dof = {}
        for d in range(nv):
            jn = self.joint_names[dof_body[d]]
            if jn and jn not in joint_to_dof:
                joint_to_dof[jn] = d
        actuator_dof = tuple(joint_to_dof[j] for j in self.actuator_joint)

        # contact candidate points, folded into the body frame
        cp_body, cp_pos, cp_rad, cp_fric = [], [], [], []
        for g in range(len(self.geom_type)):
            gt, size = self.geom_type[g], self.geom_size[g]
            if gt == GEOM_MESH:
                mp = self.geom_mesh_points[g]
                pts_local = [] if mp is None else list(mp)
                rads = [0.0] * len(pts_local)
            elif gt == GEOM_SPHERE:
                pts_local, rads = [np.zeros(3)], [size[0]]
            elif gt == GEOM_CAPSULE:
                # axis along local z, half-length size[1], radius size[0]
                pts_local = [np.array([0, 0, -size[1]]), np.array([0, 0, size[1]])]
                rads = [size[0], size[0]]
            elif gt == GEOM_BOX:
                pts_local = [
                    np.array([sx * size[0], sy * size[1], sz * size[2]])
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
                ]
                rads = [0.0] * 8
            elif gt == GEOM_CYLINDER:
                # 4 rim points per cap
                pts_local = [
                    np.array([
                        size[0] * np.cos(np.pi / 2 * k),
                        size[0] * np.sin(np.pi / 2 * k),
                        sz * size[1],
                    ])
                    for sz in (-1, 1) for k in range(4)
                ]
                rads = [0.0] * 8
            else:
                pts_local, rads = [], []
            for p, r in zip(pts_local, rads):
                p_body = _quat_rotate_np(self.geom_quat[g], p) + self.geom_pos[g]
                cp_body.append(self.geom_body[g])
                cp_pos.append(p_body.astype(np.float32))
                cp_rad.append(float(r))
                cp_fric.append(self.geom_friction[g])
        if not cp_body:  # keep shapes non-empty, as the JAX package does
            cp_body, cp_pos, cp_rad, cp_fric = [0], [np.zeros(3, np.float32)], [0.0], [1.0]

        nt = len(self.tendons)
        tendon_coef = np.zeros((nt, nv), np.float32)
        tendon_range = np.zeros((nt, 2), np.float32)
        for t, (tname, tjoints, trng) in enumerate(self.tendons):
            tendon_range[t] = trng
            for jn, coef in tjoints:
                if jn not in joint_to_dof:
                    raise ValueError(f"tendon {tname} references unknown joint {jn}")
                tendon_coef[t, joint_to_dof[jn]] = coef

        def stack(lst, shape):
            return _np(np.stack(lst)) if lst else np.zeros(shape, np.float32)

        return Model(
            nbody=nbody,
            nq=nq,
            nv=nv,
            nu=len(self.actuator_joint),
            body_parent=tuple(self.body_parent),
            jnt_type=tuple(self.jnt_type),
            q_adr=tuple(q_adr),
            v_adr=tuple(v_adr),
            body_names=tuple(self.body_names),
            joint_names=tuple(self.joint_names),
            dof_body=tuple(dof_body),
            actuator_dof=actuator_dof,
            actuator_names=tuple(self.actuator_names),
            cpoint_body=tuple(cp_body),
            geom_body=tuple(self.geom_body),
            geom_type=tuple(self.geom_type),
            body_pos=stack(self.body_pos, (0, 3)),
            body_quat=stack(self.body_quat, (0, 4)),
            body_ipos=stack(self.body_ipos, (0, 3)),
            body_inertia=stack(self.body_inertia, (0, 3, 3)),
            body_mass=_np(self.body_mass),
            jnt_axis=stack(self.jnt_axis, (0, 3)),
            jnt_pos=stack(self.jnt_pos, (0, 3)),
            armature=_np(self.armature),
            dof_damping=_np(self.dof_damping),
            dof_stiffness=_np(self.dof_stiffness),
            dof_limit_lower=_np(self.dof_limit_lower),
            dof_limit_upper=_np(self.dof_limit_upper),
            dof_limited=_np(self.dof_limited),
            dof_max_effort=_np(self.dof_max_effort),
            dof_max_velocity=_np(self.dof_max_velocity),
            gear=_np(self.gear),
            ctrl_range=stack(self.ctrl_range, (0, 2)),
            geom_pos=stack(self.geom_pos, (0, 3)),
            geom_quat=stack(self.geom_quat, (0, 4)),
            geom_size=stack(self.geom_size, (0, 3)),
            geom_friction=_np(self.geom_friction),
            cpoint_pos=stack(cp_pos, (0, 3)),
            cpoint_radius=_np(cp_rad),
            cpoint_friction=_np(cp_fric),
            qpos0=qpos0,
            att_offset=np.zeros((0, 3), np.float32),
            att_target=np.zeros((0, 3), np.float32),
            tendon_names=tuple(t[0] for t in self.tendons),
            tendon_coef=tendon_coef,
            tendon_range=tendon_range,
            tendon_stiffness=np.zeros(nt, np.float32),
            tendon_damping=np.zeros(nt, np.float32),
            dof_friction=_np(self.dof_friction_l),
            # cpoint_restitution stays None (= all zero), as in the JAX package
        )


# ---------------------------------------------------------------------------
# geometric inertia helpers (MJCF inertiafromgeom)
# ---------------------------------------------------------------------------


def sphere_inertia(density: float, r: float):
    m = density * 4.0 / 3.0 * np.pi * r**3
    i = 2.0 / 5.0 * m * r * r
    return m, np.diag([i, i, i]).astype(np.float32)


def capsule_inertia(density: float, r: float, half_len: float):
    """Capsule along local z: cylinder (length 2*half_len) + two hemispheres."""
    h = 2.0 * half_len
    m_cyl = density * np.pi * r * r * h
    m_hs = density * 2.0 / 3.0 * np.pi * r**3  # one hemisphere
    ixx_cyl = m_cyl * (3 * r * r + h * h) / 12.0
    izz_cyl = m_cyl * r * r / 2.0
    # hemisphere about its own com (3r/8 from the flat face)
    izz_hs = 2.0 / 5.0 * m_hs * r * r
    ixx_hs_com = izz_hs - m_hs * (3.0 * r / 8.0) ** 2
    d = half_len + 3.0 * r / 8.0
    ixx_hs = ixx_hs_com + m_hs * d * d
    m = m_cyl + 2 * m_hs
    ixx = ixx_cyl + 2 * ixx_hs
    izz = izz_cyl + 2 * izz_hs
    return m, np.diag([ixx, ixx, izz]).astype(np.float32)


def box_inertia(density: float, half_sizes):
    sx, sy, sz = half_sizes
    m = density * 8.0 * sx * sy * sz
    return m, np.diag([
        m / 3.0 * (sy * sy + sz * sz),
        m / 3.0 * (sx * sx + sz * sz),
        m / 3.0 * (sx * sx + sy * sy),
    ]).astype(np.float32)


def cylinder_inertia(density: float, r: float, half_len: float):
    h = 2.0 * half_len
    m = density * np.pi * r * r * h
    return m, np.diag([
        m * (3 * r * r + h * h) / 12.0,
        m * (3 * r * r + h * h) / 12.0,
        m * r * r / 2.0,
    ]).astype(np.float32)
