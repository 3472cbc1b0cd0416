"""Simulation parameters, state, kinematics and articulated dynamics (port
of isaacgymenvs_tpu/engine/dynamics.py).

Formulation as in the JAX package: Featherstone spatial algebra in world
coordinates about the world origin. Every function is batched over envs:
tensors are env-leading (N, ...), where the JAX package writes one env and
vmaps. The eager engine (`engine/step.py`) takes per-env model leaves as a
dict `leaves` {name: (N, *leaf.shape)} (a domain-randomization sample) beside
the static Model; a leaf it does not hold is the Model's own (`model_leaves`).

  motion vector v = (omega, v_o)  -- angular velocity, linear velocity of the
                                     body-fixed point at the world origin
  force  vector f = (n_o, f)      -- torque about the origin, linear force
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import maths
from ..model.spec import FREE, HINGE, SLIDE, Model


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Simulation operating point (cfg/task/*.yaml `sim:` block)."""

    dt: float = 1.0 / 60.0
    substeps: int = 2
    solver_iterations: int = 1  # extra internal slices per substep
    solver: str = "apgd"
    solver_pgs_iterations: int = 8
    solver_apgd_iterations: int = 32
    max_active_contacts: int = 0  # 0 = no cap
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    baumgarte_erp: float = 0.2
    baumgarte_erp_attractor: float = 0.7
    max_depenetration_velocity: float = 10.0
    bounce_threshold_velocity: float = 0.2
    contact_margin: float = 0.0
    limit_stiffness: float = 400.0
    limit_damping: float = 20.0
    max_dof_velocity: float = 1000.0


class Terrain:
    """Static heightfield the ground plane generalizes to: a dense (rows,
    cols) float32 height grid on the device and bilinear lookups of it.
    Grid index (i, j) sits at world xy = origin + horizontal_scale * (i, j);
    a point off the grid takes the value at its border.

    `sample` / `sample_grad` read the whole grid. `sample_patch` /
    `sample_grad_patch` give the JAX package's patch lookups the same
    values: each env's points are read from a (P, P) window around its
    centre, and a point more than about P/2 cells away is clamped to the
    window's edge. The JAX package contracts the window with dense tent
    weights (no gathers on the TPU); here four corner gathers per point
    compute the same function of the same inputs.
    """

    def __init__(self, height, horizontal_scale: float = 0.1, origin=(0.0, 0.0)):
        self.height = torch.as_tensor(height, dtype=torch.float32)
        self.horizontal_scale = float(horizontal_scale)
        self.origin = torch.as_tensor(origin, dtype=torch.float32, device=self.height.device)

    def to(self, device) -> "Terrain":
        return Terrain(self.height.to(device), self.horizontal_scale, self.origin.to(device))

    def _grid(self, xy):
        """Grid coordinates of world xy (..., 2), clamped onto the grid."""
        rows, cols = self.height.shape
        g = (xy - self.origin) / self.horizontal_scale
        return torch.clamp(g[..., 0], 0.0, rows - 1.001), torch.clamp(g[..., 1], 0.0, cols - 1.001)

    def _corners(self, x0, y0):
        """Heights at the four corners of the cells whose low corner is (x0, y0)."""
        cols = self.height.shape[1]
        flat = self.height.reshape(-1)
        base = x0 * cols + y0
        return flat[base], flat[base + cols], flat[base + 1], flat[base + cols + 1]

    def _bilinear(self, x0, y0, fx, fy, grad: bool):
        h00, h10, h01, h11 = self._corners(x0, y0)
        h = h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy) + h01 * (1 - fx) * fy + h11 * fx * fy
        if not grad:
            return h
        # the normal is the exact gradient of the bilinear interpolant
        inv = 1.0 / self.horizontal_scale
        dhdx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) * inv
        dhdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) * inv
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
        return h, n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)

    def _full(self, xy, grad: bool):
        gx, gy = self._grid(xy)
        x0, y0 = torch.floor(gx), torch.floor(gy)
        return self._bilinear(x0.long(), y0.long(), gx - x0, gy - y0, grad)

    def _patch(self, center_xy, pts_xy, P: int, grad: bool):
        rows, cols = self.height.shape
        g = (center_xy - self.origin) / self.horizontal_scale  # (N, 2)
        sx = torch.clamp(torch.round(g[..., 0]).long() - P // 2, 0, max(rows - P, 0))[..., None]
        sy = torch.clamp(torch.round(g[..., 1]).long() - P // 2, 0, max(cols - P, 0))[..., None]
        gx, gy = self._grid(pts_xy)  # (N, K)
        # window coordinates; a point outside the window takes its edge value
        lx = torch.clamp(gx - sx, 0.0, P - 1.001)
        ly = torch.clamp(gy - sy, 0.0, P - 1.001)
        x0, y0 = torch.floor(lx), torch.floor(ly)
        return self._bilinear(x0.long() + sx, y0.long() + sy, lx - x0, ly - y0, grad)

    def sample(self, xy):
        """Bilinear height at world xy (..., 2)."""
        return self._full(xy, False)

    def sample_grad(self, xy):
        """Height and unit surface normal (..., 3) at world xy (..., 2)."""
        return self._full(xy, True)

    def sample_patch(self, center_xy, pts_xy, P: int = 32):
        """Heights of points (N, K, 2) read from a (P, P) window around each
        env's centre (N, 2)."""
        return self._patch(center_xy, pts_xy, P, False)

    def sample_grad_patch(self, center_xy, pts_xy, P: int = 32):
        """Heights and normals, patch variant of `sample_grad`."""
        return self._patch(center_xy, pts_xy, P, True)


@dataclasses.dataclass
class SimState:
    """Generalized state, env-leading: q (N, nq), qd (N, nv)."""

    q: torch.Tensor
    qd: torch.Tensor


class Kin(NamedTuple):
    """Forward-kinematics products (world frame), env-leading."""

    x: torch.Tensor  # (N, nbody, 3) body frame origins
    quat: torch.Tensor  # (N, nbody, 4)
    com: torch.Tensor  # (N, nbody, 3)
    inertia_w: torch.Tensor  # (N, nbody, 3, 3) rotational inertia about CoM
    S: torch.Tensor  # (N, nv, 6) joint motion subspace
    Sdot: torch.Tensor  # (N, nv, 6)
    v: torch.Tensor  # (N, nbody, 6) spatial velocity (origin-referenced)


# ---------------------------------------------------------------------------
# static topology helpers (host, numpy)
# ---------------------------------------------------------------------------


def ancestor_matrix(model: Model) -> np.ndarray:
    """A[i, j] = 1 iff body j is an ancestor of (or equal to) body i."""
    n = model.nbody
    A = np.zeros((n, n), np.float32)
    for i in range(n):
        j = i
        while j != -1:
            A[i, j] = 1.0
            j = model.body_parent[j]
    return A


def dof_ancestor_mask(model: Model) -> np.ndarray:
    """L[i, j] = 1 iff dof j is on an ancestor-or-self body of dof i's body
    AND j <= i (the lower-triangular inclusion that assembles M)."""
    A = ancestor_matrix(model)
    L = np.zeros((model.nv, model.nv), np.float32)
    for i in range(model.nv):
        for j in range(i + 1):
            if A[model.dof_body[i], model.dof_body[j]]:
                L[i, j] = 1.0
    return L


def scalar_dof_q_adr(model: Model) -> np.ndarray:
    """q index per dof for scalar (hinge/slide) dofs, -1 for free dofs."""
    out = np.full(model.nv, -1, np.int64)
    for i in range(model.nbody):
        if model.jnt_type[i] in (HINGE, SLIDE):
            out[model.v_adr[i]] = model.q_adr[i]
    return out


class KinMeta(NamedTuple):
    """Host-precomputed static index sets (the fields the fused path reads)."""

    free_bodies: tuple  # body indices with FREE joints
    # (nq, nv) 0/1 matrix mapping dofs to the q rows they integrate linearly
    int_mat: np.ndarray


def kin_meta(model: Model) -> KinMeta:
    sq = scalar_dof_q_adr(model)
    sv = np.where(sq >= 0)[0]
    free_bodies = tuple(i for i in range(model.nbody) if model.jnt_type[i] == FREE)
    int_mat = np.zeros((model.nq, model.nv), np.float32)
    int_mat[sq[sv], sv] = 1.0
    for i in free_bodies:
        qa, va = int(model.q_adr[i]), int(model.v_adr[i])
        int_mat[qa:qa + 3, va:va + 3] = np.eye(3, dtype=np.float32)
    return KinMeta(free_bodies=free_bodies, int_mat=int_mat)


# ---------------------------------------------------------------------------
# kinematics
# ---------------------------------------------------------------------------


_TENSOR_CACHE: dict = {}


def _model_tensors(model: Model, device, dtype=torch.float32):
    """`model.to(device)` in `dtype`, made once per model, device and dtype."""
    key = (id(model), str(device), dtype)
    hit = _TENSOR_CACHE.get(key)
    if hit is None or hit[0] is not model:
        mt = model.to(device)
        hit = (model, mt if dtype == torch.float32 else
               type(mt)(**{f.name: getattr(mt, f.name).to(dtype) for f in dataclasses.fields(mt)}))
        _TENSOR_CACHE[key] = hit
    return hit[1]


def forward_kinematics(model: Model, q: torch.Tensor, qd: torch.Tensor, leaves: dict | None = None) -> Kin:
    """Batched tree sweep over bodies in topological order.

    q (N, nq), qd (N, nv) -> Kin, env-leading. Same products as the JAX
    package's level-batched forward_kinematics under vmap. `leaves` may hold
    per-env `body_ipos` (N, nbody, 3) and `body_inertia` (N, nbody, 3, 3),
    which `com` and `inertia_w` then read.
    """
    N, dev = q.shape[0], q.device
    mt = _model_tensors(model, dev, q.dtype)
    e3 = torch.eye(3, dtype=q.dtype, device=dev).expand(N, 3, 3)
    zero3 = q.new_zeros(N, 3)
    X, Q, V = [], [], []
    S = [None] * model.nv
    Sd = [None] * model.nv
    for i in range(model.nbody):
        p = model.body_parent[i]
        if p == -1:
            xp, qp, vp = zero3, q.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(N, 4), q.new_zeros(N, 6)
        else:
            xp, qp, vp = X[p], Q[p], V[p]
        w_p, vo_p = vp[:, :3], vp[:, 3:]
        X_x = xp + maths.quat_rotate(qp, mt.body_pos[i])
        X_q = maths.quat_mul(qp, mt.body_quat[i].expand(N, 4))
        jt, qa, va = model.jnt_type[i], model.q_adr[i], model.v_adr[i]
        if jt == FREE:
            xi = q[:, qa:qa + 3]
            qi = maths.quat_unit(q[:, qa + 3:qa + 7])
            vel_lin, omega = qd[:, va:va + 3], qd[:, va + 3:va + 6]
            vi = torch.cat([omega, vel_lin - torch.linalg.cross(omega, xi, dim=-1)], -1)
            for k in range(3):
                S[va + k] = torch.cat([zero3, e3[:, k]], -1)
                Sd[va + k] = q.new_zeros(N, 6)
                S[va + 3 + k] = torch.cat([e3[:, k], torch.linalg.cross(xi, e3[:, k], dim=-1)], -1)
                Sd[va + 3 + k] = torch.cat(
                    [zero3, torch.linalg.cross(vel_lin, e3[:, k], dim=-1)], -1
                )
        elif jt in (HINGE, SLIDE):
            s, sd = q[:, qa:qa + 1], qd[:, va:va + 1]
            ax_w = maths.quat_rotate(X_q, mt.jnt_axis[i])
            if jt == HINGE:
                axis = maths.normalize(mt.jnt_axis[i])
                jq = maths.quat_unit(
                    torch.cat([axis * torch.sin(s / 2), torch.cos(s / 2)], -1)
                )
                qi = maths.quat_mul(X_q, jq)
                anchor = X_x + maths.quat_rotate(X_q, mt.jnt_pos[i])
                xi = anchor - maths.quat_rotate(qi, mt.jnt_pos[i])
                Srow = torch.cat([ax_w, torch.linalg.cross(anchor, ax_w, dim=-1)], -1)
                ax_dot = torch.linalg.cross(w_p, ax_w, dim=-1)
                v_anchor = vo_p + torch.linalg.cross(w_p, anchor, dim=-1)
                Sdrow = torch.cat([
                    ax_dot,
                    torch.linalg.cross(v_anchor, ax_w, dim=-1)
                    + torch.linalg.cross(anchor, ax_dot, dim=-1),
                ], -1)
            else:
                qi = X_q
                xi = X_x + ax_w * s
                Srow = torch.cat([zero3, ax_w], -1)
                Sdrow = torch.cat([zero3, torch.linalg.cross(w_p, ax_w, dim=-1)], -1)
            vi = vp + Srow * sd
            S[va], Sd[va] = Srow, Sdrow
        else:  # FIXED
            xi, qi, vi = X_x, X_q, vp
        X.append(xi)
        Q.append(qi)
        V.append(vi)
    x, quat, v = torch.stack(X, 1), torch.stack(Q, 1), torch.stack(V, 1)
    x0, y0, z0, w0 = quat.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (y0 * y0 + z0 * z0), 2 * (x0 * y0 - w0 * z0), 2 * (x0 * z0 + w0 * y0)], -1),
        torch.stack([2 * (x0 * y0 + w0 * z0), 1 - 2 * (x0 * x0 + z0 * z0), 2 * (y0 * z0 - w0 * x0)], -1),
        torch.stack([2 * (x0 * z0 - w0 * y0), 2 * (y0 * z0 + w0 * x0), 1 - 2 * (x0 * x0 + y0 * y0)], -1),
    ], -2)
    ipos = None if leaves is None else leaves.get("body_ipos")
    inertia = None if leaves is None else leaves.get("body_inertia")
    if ipos is None:
        com = x + torch.einsum("nbij,bj->nbi", R, mt.body_ipos)
    else:
        com = x + torch.einsum("nbij,nbj->nbi", R, ipos.to(R.dtype).expand(N, -1, -1))
    if inertia is None:
        inertia_w = torch.einsum("nbij,bjk,nblk->nbil", R, mt.body_inertia, R)
    else:
        inertia_w = torch.einsum("nbij,nbjk,nblk->nbil", R, inertia.to(R.dtype).expand(N, -1, -1, -1), R)
    if model.nv:
        S_t, Sd_t = torch.stack(S, 1), torch.stack(Sd, 1)
    else:
        S_t = Sd_t = q.new_zeros(N, 0, 6)
    return Kin(x=x, quat=quat, com=com, inertia_w=inertia_w, S=S_t, Sdot=Sd_t, v=v)


class BodyPoses:
    """World positions and rotations of every body at q: the `x` and `quat`
    of `forward_kinematics`, from the same products, without velocities,
    motion subspaces or inertias, and a tree level at a time (the bodies of
    one depth and joint kind in one batch). A fixed body takes the hinge
    products at angle 0 about a joint at its origin, which leave its pose
    as the fixed branch does. The model's constants go to `device` once.

    Calling it with q (N, nq) gives (x (N, nbody, 3), quat (N, nbody, 4)).
    """

    def __init__(self, model: Model, device):
        dev = torch.device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        parent = np.asarray(model.body_parent)
        depth = np.zeros(model.nbody, np.int64)
        for i, p in enumerate(parent):
            depth[i] = 0 if p < 0 else depth[p] + 1
        jt = np.asarray(model.jnt_type)
        jpos = np.asarray(model.jnt_pos, np.float32).copy()
        jpos[(jt != HINGE) & (jt != SLIDE)] = 0.0
        self.nq, self.nbody = model.nq, model.nbody
        # a fixed body reads the zero that is appended to q
        qadr = np.where((jt == HINGE) | (jt == SLIDE), np.asarray(model.q_adr), model.nq)
        self.levels = []
        for d in range(int(depth.max()) + 1):
            for kind in ("free", "hinge", "slide"):
                sel = {"free": jt == FREE, "slide": jt == SLIDE, "hinge": (jt != FREE) & (jt != SLIDE)}[kind]
                idx = np.where((depth == d) & sel)[0]
                if not len(idx):
                    continue
                if kind == "free" and np.any(parent[idx] >= 0):
                    raise NotImplementedError("BodyPoses: a free joint below the root")
                self.levels.append((kind, long(idx), long(np.maximum(parent[idx], 0)), bool(d == 0),
                                    f32(np.asarray(model.body_pos)[idx]), f32(np.asarray(model.body_quat)[idx]),
                                    maths.normalize(f32(np.asarray(model.jnt_axis)[idx])),
                                    f32(np.asarray(model.jnt_axis)[idx]), f32(jpos[idx]),
                                    long(qadr[idx]), [int(model.q_adr[i]) for i in idx]))

    def __call__(self, q: torch.Tensor):
        N = q.shape[0]
        x = q.new_zeros(N, self.nbody, 3)
        quat = q.new_zeros(N, self.nbody, 4)
        qz = torch.cat([q, q.new_zeros(N, 1)], -1)
        for kind, idx, par, root, bpos, bquat, axis, raw_axis, jpos, qadr, fadr in self.levels:
            if root:
                xp = q.new_zeros(N, len(idx), 3)
                qp = q.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(N, len(idx), 4)
            else:
                xp, qp = x[:, par], quat[:, par]
            X_x = xp + maths.quat_rotate(qp, bpos)
            X_q = maths.quat_mul(qp, bquat.expand(N, -1, 4))
            if kind == "free":
                xi = torch.stack([q[:, a:a + 3] for a in fadr], 1)
                qi = maths.quat_unit(torch.stack([q[:, a + 3:a + 7] for a in fadr], 1))
            elif kind == "slide":
                qi = X_q
                xi = X_x + maths.quat_rotate(X_q, raw_axis) * qz[:, qadr, None]
            else:
                s = qz[:, qadr, None]
                jq = maths.quat_unit(torch.cat([axis * torch.sin(s / 2), torch.cos(s / 2)], -1))
                qi = maths.quat_mul(X_q, jq)
                anchor = X_x + maths.quat_rotate(X_q, jpos)
                xi = anchor - maths.quat_rotate(qi, jpos)
            x[:, idx] = xi
            quat[:, idx] = qi
        return x, quat


# ---------------------------------------------------------------------------
# dynamics (host-side math outside the kernel: the task-space controllers)
# ---------------------------------------------------------------------------


def spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverses of small SPD matrices (..., n, n) by Cholesky. The
    factorization's status is not read back (`cholesky_ex`), so a call on
    the card does not wait for the device."""
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_inverse(L)


_CRBA_CACHE: dict = {}


def _crba_consts(model: Model, device):
    """The model's body masses, armature and dof-body map as tensors on
    `device`, made once per model and device."""
    key = (id(model), str(device))
    hit = _CRBA_CACHE.get(key)
    if hit is None or hit[0] is not model:
        hit = (model, torch.as_tensor(np.asarray(model.body_mass, np.float32), device=device),
               torch.as_tensor(np.asarray(model.armature, np.float32), device=device),
               torch.as_tensor(np.asarray(model.dof_body, np.int64), device=device))
        _CRBA_CACHE[key] = hit
    return hit[1:]


def mass_matrix(model: Model, kin: Kin, masks, leaves: dict | None = None) -> torch.Tensor:
    """Joint-space mass matrices (N, nv, nv) by the CRBA in world/origin
    coordinates: M[i, j] = S_i^T I^C_{body(i)} S_j for dof j on an ancestor
    of dof i's body, j <= i, then mirrored, plus the armature. `masks` is
    (`ancestor_matrix`, `dof_ancestor_mask`) as tensors on kin's device;
    `leaves` may hold per-env `body_mass` (N, nbody) and `armature` (N, nv)."""
    anc, dof_mask = masks
    mass, armature, dof_body = _crba_consts(model, kin.S.device)
    if leaves is not None:
        mass, armature = leaves.get("body_mass", mass), leaves.get("armature", armature)
    I_o = _spatial_inertia(mass, kin)
    # composite inertia: IC[b] = sum of I_o[k] over the subtree of b (anc[k, b] = 1)
    IC = torch.einsum("kb,nkij->nbij", anc.to(I_o.dtype), I_o)
    F = torch.einsum("ndij,ndj->ndi", IC[:, dof_body], kin.S)
    Ml = (F @ kin.S.transpose(-1, -2)) * dof_mask
    M = Ml + Ml.transpose(-1, -2) - torch.diag_embed(torch.diagonal(Ml, dim1=-2, dim2=-1))
    return M + torch.diag_embed(armature.to(M.dtype))


def _spatial_inertia(mass, kin: Kin) -> torch.Tensor:
    """(N, nbody, 6, 6) spatial inertias about the origin, from the body
    masses (nbody,) or per env (N, nbody)."""
    return maths.spatial_inertia_at_origin(mass.to(kin.com.dtype).expand(kin.com.shape[:-1]), kin.com,
                                           kin.inertia_w)


# ---------------------------------------------------------------------------
# the eager engine's dynamics: model leaves, bias and passive forces, the
# forward dynamics and the position update
# ---------------------------------------------------------------------------

# the float leaves the eager engine reads; a per-env leaf replaces one of them
ENGINE_LEAVES = (
    "body_mass", "body_ipos", "body_inertia", "armature", "dof_damping", "dof_stiffness", "dof_limit_lower",
    "dof_limit_upper", "dof_limited", "dof_friction", "qpos0", "tendon_coef", "tendon_range", "tendon_stiffness",
    "tendon_damping", "cpoint_pos", "cpoint_radius", "cpoint_friction", "cpoint_restitution", "geom_pos",
    "geom_quat", "geom_size", "geom_friction", "att_offset", "att_target",
)
_LEAF_CACHE: dict = {}


class EngineMeta(NamedTuple):
    """The model's index sets and 0/1 matrices as tensors on one device."""

    anc: torch.Tensor  # (nbody, nbody) ancestor_matrix
    dof_mask: torch.Tensor  # (nv, nv) dof_ancestor_mask
    sq_adr: torch.Tensor  # (nv,) long, scalar_dof_q_adr
    int_mat: torch.Tensor  # (nq, nv) kin_meta(model).int_mat
    free_bodies: tuple  # body indices with FREE joints
    dof_body: torch.Tensor  # (nv,) long


def _static(model: Model, device, dtype):
    """The model's leaves (None where the Model has none) and its EngineMeta
    as tensors on `device`, made once per model, device and dtype."""
    key = (id(model), str(device), dtype)
    hit = _LEAF_CACHE.get(key)
    if hit is None or hit[0] is not model:
        t = lambda a: None if a is None else torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
        leaves = {k: t(getattr(model, k)) for k in ENGINE_LEAVES}
        meta = kin_meta(model)
        em = EngineMeta(
            anc=t(ancestor_matrix(model)), dof_mask=t(dof_ancestor_mask(model)),
            sq_adr=torch.as_tensor(scalar_dof_q_adr(model), device=device), int_mat=t(meta.int_mat),
            free_bodies=meta.free_bodies,
            dof_body=torch.as_tensor(np.asarray(model.dof_body, np.int64), device=device),
        )
        hit = (model, leaves, em)
        _LEAF_CACHE[key] = hit
    return hit[1], hit[2]


def model_leaves(model: Model, device, dtype=torch.float32, leaves: dict | None = None) -> dict:
    """{name: tensor} of `ENGINE_LEAVES` on `device` in `dtype`: the
    Model's own, shaped as in the Model, with the per-env ones of `leaves`
    (N, *leaf.shape) in their place, and `leaves["gravity"]` (N, 3) where
    given."""
    out = dict(_static(model, device, dtype)[0])
    for k, v in (leaves or {}).items():
        if k in out or k == "gravity":
            out[k] = v.to(device=device, dtype=dtype)
    return out


def engine_meta(model: Model, device, dtype=torch.float32) -> EngineMeta:
    return _static(model, device, dtype)[1]


def bias_force(model: Model, kin: Kin, qd: torch.Tensor, gravity, f_ext: torch.Tensor, masks,
               leaves: dict | None = None) -> torch.Tensor:
    """C(q, qd) - S^T f_ext, the generalized bias with M qdd = tau - C:
    qd (N, nv), gravity (3,) or (N, 3), f_ext (N, nbody, 6) external
    spatial forces (origin-referenced), -> (N, nv). Gravity enters as a
    uniform spatial acceleration field."""
    anc, _ = masks
    lv = model_leaves(model, qd.device, qd.dtype, leaves)
    dof_body = engine_meta(model, qd.device, qd.dtype).dof_body
    anc = anc.to(qd.dtype)
    I_o = _spatial_inertia(lv["body_mass"], kin)
    # velocity-product acceleration: zeta_b = sum over the dofs d on b's path of Sdot_d qd_d
    P = anc[:, dof_body]  # (nbody, nv)
    zeta = P @ (kin.Sdot * qd[..., None])  # (N, nbody, 6)
    g = torch.as_tensor(gravity, dtype=qd.dtype, device=qd.device).expand(qd.shape[0], 3)
    a_grav = torch.cat([torch.zeros_like(g), g], -1)[:, None]
    net = (torch.einsum("nbij,nbj->nbi", I_o, zeta - a_grav)
           + maths.spatial_cross_force(kin.v, torch.einsum("nbij,nbj->nbi", I_o, kin.v)) - f_ext)
    F_sub = anc.T @ net  # F_sub[b] = sum over the subtree of b
    return torch.sum(kin.S * F_sub[:, dof_body], dim=-1)


def passive_force(model: Model, q: torch.Tensor, qd: torch.Tensor, params: SimParams, sq_adr,
                  q_spring: torch.Tensor | None = None, leaves: dict | None = None):
    """Joint springs, limit penalties, Coulomb joint friction and tendon
    limits as (tau, D, K), each (N, nv): D is the velocity coefficient and
    K the stiffness coefficient the forward dynamics applies implicitly
    (h D + h^2 K added to M). `q_spring` (N, nq) replaces `qpos0` as the
    spring setpoint (the PD drive of `q_target`)."""
    lv = model_leaves(model, q.device, q.dtype, leaves)
    setpoint = lv["qpos0"] if q_spring is None else q_spring
    has = sq_adr >= 0
    idx = torch.clamp(sq_adr, min=0)
    q_scalar = torch.where(has, q[..., idx], 0.0)
    q0_scalar = torch.where(has, setpoint[..., idx], 0.0)
    limited = lv["dof_limited"]
    tau = -lv["dof_stiffness"] * (q_scalar - q0_scalar)
    over = torch.clamp(q_scalar - lv["dof_limit_upper"], min=0.0)
    under = torch.clamp(lv["dof_limit_lower"] - q_scalar, min=0.0)
    violating = (over > 0) | (under > 0)
    tau = tau + limited * (-params.limit_stiffness * (over - under))
    D = lv["dof_damping"] + limited * torch.where(violating, params.limit_damping, 0.0)
    if lv["dof_friction"] is not None:
        # Coulomb joint friction as the regularized damping mu / (|qd| + eps), implicit
        D = D + lv["dof_friction"] / (torch.abs(qd) + 2e-3)
    K = lv["dof_stiffness"] + limited * torch.where(violating, params.limit_stiffness, 0.0)
    coef = lv["tendon_coef"]
    if coef is not None and coef.shape[0]:
        # fixed tendons: t = coef . q, its range violation resisted, its velocity damped
        t_val = q_scalar @ coef.T  # (N, nt)
        t_vel = qd @ coef.T
        rng = lv["tendon_range"]
        viol = torch.clamp(t_val - rng[..., 1], min=0.0) + torch.clamp(t_val - rng[..., 0], max=0.0)
        f_t = -lv["tendon_stiffness"] * viol - lv["tendon_damping"] * t_vel
        tau = tau + f_t @ coef
    return tau, D, K


def forward_dynamics(model: Model, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor, f_ext: torch.Tensor,
                     params: SimParams, masks, sq_adr, kin: Kin | None = None, h: float = 0.0,
                     q_spring: torch.Tensor | None = None, leaves: dict | None = None):
    """qdd = (M + diag(h D + h^2 K))^-1 (tau + tau_passive - D qd - C), with
    h > 0 making joint damping and stiffness implicit. Returns (qdd (N, nv),
    minv_mul: rhs (N, nv, k) -> (M + ...)^-1 rhs, kin)."""
    if kin is None:
        kin = forward_kinematics(model, q, qd, leaves)
    lv = model_leaves(model, q.device, q.dtype, leaves)
    gravity = lv.get("gravity", params.gravity)
    M = mass_matrix(model, kin, masks, leaves)
    C = bias_force(model, kin, qd, gravity, f_ext, masks, leaves)
    tau_p, D, K = passive_force(model, q, qd, params, sq_adr, q_spring, leaves)
    Mh = M + torch.diag_embed((h * D + h * h * K).expand(q.shape[0], -1))
    Minv = spd_inverse(Mh)
    qdd = (Minv @ (tau + tau_p - D * qd - C)[..., None])[..., 0]

    def minv_mul(rhs):
        return Minv @ rhs

    return qdd, minv_mul, kin


def integrate_positions(model: Model, q: torch.Tensor, qd_new: torch.Tensor, dt,
                        meta: EngineMeta | None = None) -> torch.Tensor:
    """Position update of semi-implicit Euler: the linear rows (scalar dofs
    and free-joint translations) through the static 0/1 matrix `int_mat`,
    each free joint's quaternion by the exponential map of its angular
    velocity. q (N, nq), qd_new (N, nv) -> (N, nq)."""
    if meta is None:
        meta = engine_meta(model, q.device, q.dtype)
    q_new = q + dt * (qd_new @ meta.int_mat.T)
    if not meta.free_bodies:
        return q_new
    parts, at = [], 0
    for i in meta.free_bodies:
        qa, va = model.q_adr[i], model.v_adr[i]
        quat = maths.quat_integrate(maths.quat_unit(q[:, qa + 3:qa + 7]), qd_new[:, va + 3:va + 6], dt)
        parts += [q_new[:, at:qa + 3], quat]
        at = qa + 7
    parts.append(q_new[:, at:])
    return torch.cat(parts, -1)
