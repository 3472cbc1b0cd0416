"""Fused whole physics step: host side and plain PyTorch version.

Port of isaacgymenvs_tpu/engine/fused.py. One call advances every env by
one physics step (all `substeps x solver_iterations` slices):

  FK -> spatial inertia -> CRBA mass matrix -> bias force (+ xfrc) ->
  implicit passive forces -> Gauss-Jordan inverse -> plane contact rows
  (Baumgarte, restitution) -> Delassus J^T M^-1 J -> Jacobi scaling ->
  APGD cone solve (warm start carried across the call's slices) ->
  impulse to qd, velocity clip, semi-implicit Euler -> sensors.

At the boundary arrays are laid out (rows, N), envs last, as the TPU
kernel has them. On a CUDA tensor `physics_step_fused` launches the
hand-written kernel `csrc/fused_step.cu` (through `_cuda.py`) or raises;
on a CPU tensor it runs `_step_math_torch`, the plain twin of the JAX
`_step_math`, which the CPU tests hold against the JAX package and
`chip_smoke.py` holds the kernel against on the card.

Feature set (`fused_supported`): free/hinge/slide/fixed joints, plane
contacts from candidate points, external body wrenches, joint limits,
implicit damping/stiffness, joint friction, Newton restitution. Pair
rows, anchors, top-K, tendons, q_target drives, per-env model leaves,
terrain and SDF rows are later tiers and raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..model.spec import FREE, HINGE, SLIDE, Model
from . import dynamics as _dyn
from .dynamics import SimParams


class FusedOut(NamedTuple):
    """Batched step outputs, env-leading (N, ...)."""

    q: torch.Tensor  # (N, nq)
    qd: torch.Tensor  # (N, nv)
    body_force: torch.Tensor  # (N, nbody, 3)
    body_torque: torch.Tensor  # (N, nbody, 3)
    dof_force: torch.Tensor  # (N, nv)


def fused_supported(model: Model, params: SimParams, terrain=None) -> bool:
    """True when the port's kernel (and its twin) covers this model."""
    n_plane = model.ncp if model.plane_contacts else 0
    cap = params.max_active_contacts
    has_tendons = model.tendon_coef is not None and model.tendon_coef.shape[0] > 0
    return (
        terrain is None
        and params.solver == "apgd"
        and not model.pair_geom_a
        and not model.ppair_point
        and not model.spair_point
        and not model.att_body
        and not has_tendons
        and not (cap and cap < n_plane)
    )


# ---------------------------------------------------------------------------
# component-first helpers: vectors are python lists of (rows, N) tensors
# ---------------------------------------------------------------------------


def _cross(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def _qmul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return [
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ]


def _qrot(q, v):
    """Rotate vector v (3 comps) by quaternion q (4 comps, xyzw)."""
    xyz, w = q[:3], q[3]
    t = [2.0 * c for c in _cross(xyz, v)]
    u = _cross(xyz, t)
    return [v[k] + w * t[k] + u[k] for k in range(3)]


def _qnormalize(q):
    n = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    inv = 1.0 / torch.clamp(n, min=1e-9)
    return [c * inv for c in q]


def _qexp(phi):
    """Rotation vector -> quaternion, Taylor-safe at 0."""
    a2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2]
    angle = torch.sqrt(torch.clamp(a2, min=1e-24))
    half = 0.5 * angle
    small = a2 < 1e-12
    s = torch.where(small, 0.5 - a2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - a2 / 8.0, torch.cos(half))
    return [phi[0] * s, phi[1] * s, phi[2] * s, w]


# ---------------------------------------------------------------------------
# static model extraction (host, numpy)
# ---------------------------------------------------------------------------


class _Spec(NamedTuple):
    nbody: int
    nq: int
    nv: int
    nc: int  # plane contact rows
    parent: np.ndarray
    jnt_type: np.ndarray
    q_adr: np.ndarray
    v_adr: np.ndarray
    dof_body: np.ndarray
    body_pos: np.ndarray  # (nbody, 3)
    body_quat: np.ndarray
    body_ipos: np.ndarray
    body_inertia: np.ndarray  # (nbody, 3, 3)
    body_mass: np.ndarray
    jnt_axis: np.ndarray
    jnt_pos: np.ndarray
    armature: np.ndarray
    dof_damping: np.ndarray
    dof_friction: np.ndarray
    dof_stiffness: np.ndarray
    dof_limit_lower: np.ndarray
    dof_limit_upper: np.ndarray
    dof_limited: np.ndarray
    qpos0: np.ndarray
    sq_adr: np.ndarray  # per-dof q index (-1 = free dof)
    dof_mask: np.ndarray  # (nv, nv) lower ancestor mask
    anc: np.ndarray  # (nbody, nbody) ancestor-or-self
    int_mat: np.ndarray  # (nq, nv)
    cp_body: np.ndarray
    cp_pos: np.ndarray  # (nc, 3)
    cp_radius: np.ndarray
    cp_mu: np.ndarray
    path_mask: np.ndarray  # (nc, nv) contact-path dof mask
    body_of_contact: np.ndarray  # (nbody, nc) 0/1 accumulation matrix
    rest: np.ndarray  # (nc,) per-row Newton restitution
    free_bodies: tuple


def _extract(model: Model) -> _Spec:
    f32 = lambda x: np.asarray(x, np.float32)
    anc = _dyn.ancestor_matrix(model)
    meta = _dyn.kin_meta(model)
    nc = model.ncp if (model.ncp and model.plane_contacts) else 0
    cp_body = np.asarray(model.cpoint_body, np.int64)[:nc]
    path_mask = anc[cp_body][:, np.asarray(model.dof_body, np.int64)].astype(np.float32)
    boc = np.zeros((model.nbody, nc), np.float32)
    boc[cp_body, np.arange(nc)] = 1.0
    rest = (
        f32(model.cpoint_restitution)[:nc]
        if model.cpoint_restitution is not None
        else np.zeros(nc, np.float32)
    )
    return _Spec(
        nbody=model.nbody,
        nq=model.nq,
        nv=model.nv,
        nc=nc,
        parent=np.asarray(model.body_parent, np.int64),
        jnt_type=np.asarray(model.jnt_type, np.int64),
        q_adr=np.asarray(model.q_adr, np.int64),
        v_adr=np.asarray(model.v_adr, np.int64),
        dof_body=np.asarray(model.dof_body, np.int64),
        body_pos=f32(model.body_pos),
        body_quat=f32(model.body_quat),
        body_ipos=f32(model.body_ipos),
        body_inertia=f32(model.body_inertia),
        body_mass=f32(model.body_mass),
        jnt_axis=f32(model.jnt_axis),
        jnt_pos=f32(model.jnt_pos),
        armature=f32(model.armature),
        dof_damping=f32(model.dof_damping),
        dof_friction=(
            f32(model.dof_friction)
            if model.dof_friction is not None
            else np.zeros(model.nv, np.float32)
        ),
        dof_stiffness=f32(model.dof_stiffness),
        dof_limit_lower=f32(model.dof_limit_lower),
        dof_limit_upper=f32(model.dof_limit_upper),
        dof_limited=f32(model.dof_limited),
        qpos0=f32(model.qpos0),
        sq_adr=_dyn.scalar_dof_q_adr(model),
        dof_mask=_dyn.dof_ancestor_mask(model),
        anc=anc,
        int_mat=meta.int_mat,
        cp_body=cp_body,
        cp_pos=f32(model.cpoint_pos)[:nc],
        cp_radius=f32(model.cpoint_radius)[:nc],
        cp_mu=f32(model.cpoint_friction)[:nc],
        path_mask=path_mask,
        body_of_contact=boc,
        rest=rest,
        free_bodies=meta.free_bodies,
    )


def apgd_betas(iters: int) -> list:
    """Nesterov momentum schedule of the APGD solve (Python floats)."""
    t_seq = [1.0]
    for _ in range(iters):
        t_seq.append(0.5 * (1.0 + float(np.sqrt(1.0 + 4.0 * t_seq[-1] ** 2))))
    return [(t_seq[k] - 1.0) / t_seq[k + 1] for k in range(iters)]


# ---------------------------------------------------------------------------
# the plain version: substep math on (rows, N) tensors
# ---------------------------------------------------------------------------


def _fk(s: _Spec, q, qd):
    """Per-body unrolled FK. q (nq, N), qd (nv, N).

    Returns X, Q, V (per-body component lists) and S/Sdot (6 x (nv, N)).
    """
    one = torch.ones((1, q.shape[-1]), dtype=q.dtype, device=q.device)
    zero = torch.zeros_like(one)
    X, Qt, V = [], [], []
    S_rows = [None] * s.nv
    Sd_rows = [None] * s.nv
    for i in range(s.nbody):
        p = s.parent[i]
        if p == -1:
            xp, qp, vp = [zero] * 3, [zero, zero, zero, one], [zero] * 6
        else:
            xp, qp, vp = X[p], Qt[p], V[p]
        w_p, vo_p = vp[:3], vp[3:]
        bp = [float(s.body_pos[i, k]) * one for k in range(3)]
        bq = [float(s.body_quat[i, k]) * one for k in range(4)]
        X_x = [xp[k] + r for k, r in enumerate(_qrot(qp, bp))]
        X_q = _qmul(qp, bq)
        jt = s.jnt_type[i]
        qa, va = int(s.q_adr[i]), int(s.v_adr[i])
        if jt == FREE:
            xi = [q[qa + k][None] for k in range(3)]
            qi = _qnormalize([q[qa + 3 + k][None] for k in range(4)])
            vel_lin = [qd[va + k][None] for k in range(3)]
            omega = [qd[va + 3 + k][None] for k in range(3)]
            cwx = _cross(omega, xi)
            vi = omega + [vel_lin[k] - cwx[k] for k in range(3)]
            # rows 0-2: translations (0, e_k); rows 3-5: rotations (e_k, x cross e_k)
            ex = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
            for k in range(3):
                row = [zero] * 6
                row[3 + k] = one
                S_rows[va + k] = row
                Sd_rows[va + k] = [zero] * 6
                S_rows[va + 3 + k] = ex[k] + _cross(xi, ex[k])
                Sd_rows[va + 3 + k] = [zero] * 3 + _cross(vel_lin, ex[k])
        elif jt in (HINGE, SLIDE):
            ax = [float(s.jnt_axis[i, k]) * one for k in range(3)]
            jp = [float(s.jnt_pos[i, k]) * one for k in range(3)]
            sq_i = q[qa][None]
            sqd = qd[va][None]
            ax_w = _qrot(X_q, ax)
            if jt == HINGE:
                half = 0.5 * sq_i
                jq = [ax[k] * torch.sin(half) for k in range(3)] + [torch.cos(half)]
                qi = _qmul(X_q, jq)
                anchor = [X_x[k] + r for k, r in enumerate(_qrot(X_q, jp))]
                xi = [anchor[k] - r for k, r in enumerate(_qrot(qi, jp))]
                Srow = ax_w + _cross(anchor, ax_w)
                ax_dot = _cross(w_p, ax_w)
                v_anchor = [vo_p[k] + c for k, c in enumerate(_cross(w_p, anchor))]
                cva = _cross(v_anchor, ax_w)
                cad = _cross(anchor, ax_dot)
                Sdrow = ax_dot + [cva[k] + cad[k] for k in range(3)]
            else:  # SLIDE
                qi = X_q
                xi = [X_x[k] + ax_w[k] * sq_i for k in range(3)]
                Srow = [zero] * 3 + ax_w
                Sdrow = [zero] * 3 + _cross(w_p, ax_w)
            vi = [vp[k] + Srow[k] * sqd for k in range(6)]
            S_rows[va] = Srow
            Sd_rows[va] = Sdrow
        else:  # FIXED
            xi, qi, vi = X_x, X_q, vp
        X.append(xi)
        Qt.append(qi)
        V.append(vi)
    S = [torch.cat([S_rows[d][k] for d in range(s.nv)], 0) for k in range(6)]
    Sdot = [torch.cat([Sd_rows[d][k] for d in range(s.nv)], 0) for k in range(6)]
    return X, Qt, V, S, Sdot


def _stackb(lst_of_comp, k):
    """Stack component k of a per-body list -> (nbody, N)."""
    return torch.cat([b[k] for b in lst_of_comp], 0)


def _substep_fn(s: _Spec, p: SimParams, h: float, device):
    """Build the single-slice function (the twin of the JAX `_substep_fn`)."""
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    rev_topo = list(range(s.nbody))[::-1]
    dof_of_body = [[d for d in range(s.nv) if s.dof_body[d] == b] for b in range(s.nbody)]
    nc = s.nc
    erp = p.baumgarte_erp
    gravity = [float(g) for g in p.gravity]
    sel_q = np.zeros((s.nv, s.nq), np.float32)
    for d in range(s.nv):
        if s.sq_adr[d] >= 0:
            sel_q[d, s.sq_adr[d]] = 1.0
    betas = apgd_betas(p.solver_apgd_iterations)
    dof_pick = np.zeros((s.nv, s.nbody), np.float32)
    dof_pick[np.arange(s.nv), s.dof_body] = 1.0
    cp_pick = np.zeros((nc, s.nbody), np.float32)
    cp_pick[np.arange(nc), s.cp_body] = 1.0
    c = dict(
        sel_q=T(sel_q),
        setpoint=T((sel_q @ s.qpos0)[:, None]),
        kstiff=T(s.dof_stiffness[:, None]),
        kdamp=T(s.dof_damping[:, None]),
        kfric=T(s.dof_friction[:, None]),
        limited=T(s.dof_limited[:, None]),
        lo=T(s.dof_limit_lower[:, None]),
        hi=T(s.dof_limit_upper[:, None]),
        armature=T(s.armature[:, None]),
        mask=T(s.dof_mask[:, :, None]),
        eye=T(np.eye(s.nv, dtype=np.float32)[:, :, None]),
        ipos=[T(s.body_ipos[:, k:k + 1]) for k in range(3)],
        Ib=[[T(s.body_inertia[:, a:a + 1, b]) for b in range(3)] for a in range(3)],
        mass=T(s.body_mass[:, None]),
        sub=T(dof_pick @ s.anc.T),
        int_mat=T(s.int_mat),
        cp_pick=T(cp_pick),
        cp_pos=[T(s.cp_pos[:, k:k + 1]) for k in range(3)],
        cp_radius=T(s.cp_radius[:, None]),
        mu=T(s.cp_mu[:, None]),
        rest=T(s.rest[:, None]),
        Pm=T(s.path_mask.T[:, :, None]),
        boc=T(s.body_of_contact),
    )
    has_fric = bool(np.any(s.dof_friction))
    has_rest = bool(np.any(s.rest))

    def spatial_inertia(Xb, Qb):
        """World-origin 6x6 spatial inertia entries Io[r][k]: (nbody, N)."""
        x, y, z, w = (Qb[k] for k in range(4))
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        wx, wy, wz = w * x, w * y, w * z
        R = [
            [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
        ]
        ipos, Ib, m = c["ipos"], c["Ib"], c["mass"]
        com = [Xb[k] + sum(R[k][j] * ipos[j] for j in range(3)) for k in range(3)]
        RI = [[sum(R[a][cc] * Ib[cc][b] for cc in range(3)) for b in range(3)] for a in range(3)]
        Iw = [[sum(RI[a][cc] * R[b][cc] for cc in range(3)) for b in range(3)] for a in range(3)]
        cx, cy, cz = com
        c2 = cx * cx + cy * cy + cz * cz
        Io = [[None] * 6 for _ in range(6)]
        for a in range(3):
            for b in range(3):
                Io[a][b] = Iw[a][b] + m * ((c2 if a == b else 0.0) - com[a] * com[b])
        sk = [[0.0, -cz, cy], [cz, 0.0, -cx], [-cy, cx, 0.0]]
        zero = torch.zeros_like(cx)
        for a in range(3):
            for b in range(3):
                v = sk[a][b]
                val = zero if isinstance(v, float) else m * v
                Io[a][3 + b] = val
                Io[3 + a][b] = -val
                Io[3 + a][3 + b] = m * (1.0 if a == b else 0.0) * torch.ones_like(cx)
        return Io

    def integrate(q, qd_new):
        q_new = q + h * (c["int_mat"] @ qd_new)
        for i in s.free_bodies:
            qa, va = int(s.q_adr[i]), int(s.v_adr[i])
            dq = _qexp([qd_new[va + 3 + k][None] * h for k in range(3)])
            quat = _qnormalize([q[qa + 3 + k][None] for k in range(4)])
            qn = _qnormalize(_qmul(dq, quat))
            q_new = torch.cat([q_new[:qa + 3], torch.cat(qn, 0), q_new[qa + 7:]], 0)
        return q_new

    def substep(q, qd, qfrc, xfrc, warm):
        N = q.shape[-1]
        Xl, Ql, Vl, S, Sdot = _fk(s, q, qd)
        Xb = [_stackb(Xl, k) for k in range(3)]
        Qb = [_stackb(Ql, k) for k in range(4)]
        Vb = [_stackb(Vl, k) for k in range(6)]
        Io = spatial_inertia(Xb, Qb)

        # composite inertia, reverse-topological accumulation
        ICb = [[[Io[r][k][b:b + 1] for k in range(6)] for r in range(6)] for b in range(s.nbody)]
        for b in rev_topo:
            pb = s.parent[b]
            if pb != -1:
                for r in range(6):
                    for k in range(6):
                        ICb[pb][r][k] = ICb[pb][r][k] + ICb[b][r][k]
        ICd = [
            [torch.cat([ICb[s.dof_body[d]][r][k] for d in range(s.nv)], 0) for k in range(6)]
            for r in range(6)
        ]
        F = [sum(ICd[r][k] * S[k] for k in range(6)) for r in range(6)]
        Ml = sum(F[r][:, None, :] * S[r][None, :, :] for r in range(6)) * c["mask"]
        eye3 = c["eye"]
        M = Ml + Ml.transpose(0, 1) - Ml * eye3

        # bias force: velocity-product acceleration by path accumulation
        zeta_b = []
        for i in range(s.nbody):
            pb = s.parent[i]
            zet = [q.new_zeros(1, N)] * 6 if pb == -1 else list(zeta_b[pb])
            for d in dof_of_body[i]:
                zet = [zet[k] + Sdot[k][d][None] * qd[d][None] for k in range(6)]
            zeta_b.append(zet)
        zeta = [torch.cat([z[k] for z in zeta_b], 0) for k in range(6)]
        a_grav = [0.0, 0.0, 0.0] + gravity
        x_in = [zeta[k] - a_grav[k] for k in range(6)]
        net = [sum(Io[r][k] * x_in[k] for k in range(6)) for r in range(6)]
        Iov = [sum(Io[r][k] * Vb[k] for k in range(6)) for r in range(6)]
        wv, vo = Vb[:3], Vb[3:]
        c1 = _cross(wv, Iov[:3])
        c2 = _cross(vo, Iov[3:])
        c3 = _cross(wv, Iov[3:])
        for k in range(3):
            net[k] = net[k] + c1[k] + c2[k]
            net[3 + k] = net[3 + k] + c3[k]
        if xfrc is not None:
            for k in range(6):
                net[k] = net[k] - xfrc[k * s.nbody:(k + 1) * s.nbody]
        C = sum(S[k] * (c["sub"] @ net[k]) for k in range(6))

        # passive forces (implicit spring/damping, limits, joint friction)
        q_scalar = c["sel_q"] @ q
        tau_p = -c["kstiff"] * (q_scalar - c["setpoint"])
        over = torch.clamp(q_scalar - c["hi"], min=0.0)
        under = torch.clamp(c["lo"] - q_scalar, min=0.0)
        violating = ((over > 0) | (under > 0)).to(q.dtype)
        limited = c["limited"]
        tau_p = tau_p + limited * (-p.limit_stiffness * (over - under))
        D = c["kdamp"] + limited * violating * p.limit_damping
        if has_fric:
            D = D + c["kfric"] / (torch.abs(qd) + 2e-3)
        K = c["kstiff"] + limited * violating * p.limit_stiffness

        # Mh = M + diag(armature + hD + h^2 K); Gauss-Jordan without pivoting
        diag_add = c["armature"] + h * D + h * h * K
        A_gj = M + eye3 * diag_add[:, None, :]
        Minv = eye3 + torch.zeros_like(A_gj)
        for j in range(s.nv):
            row_j = A_gj[j]
            d = 1.0 / row_j[j:j + 1]
            pivA = row_j * d
            pivI = Minv[j] * d
            cc = A_gj[:, j:j + 1, :] - eye3[:, j:j + 1, :]
            A_gj = A_gj - cc * pivA[None]
            Minv = Minv - cc * pivI[None]

        rhs = qfrc + tau_p - D * qd - C
        qd_free = qd + h * torch.sum(Minv * rhs[None], dim=1)

        zs = q.new_zeros(s.nbody * 3, N)
        if nc == 0:
            qd_new = torch.clamp(qd_free, -p.max_dof_velocity, p.max_dof_velocity)
            return integrate(q, qd_new), qd_new, warm, zs, zs, q.new_zeros(s.nv, N)

        # plane rows: candidate points vs the ground (frame = world axes)
        bQ = [c["cp_pick"] @ Qb[k] for k in range(4)]
        bX = [c["cp_pick"] @ Xb[k] for k in range(3)]
        rot = _qrot(bQ, c["cp_pos"])
        xc = [bX[k] + rot[k] for k in range(3)]
        Jp = []
        for k in range(3):
            a, b = (k + 1) % 3, (k + 2) % 3
            crossk = S[a][:, None, :] * xc[b][None] - S[b][:, None, :] * xc[a][None]
            Jp.append((S[3 + k][:, None, :] + crossk) * c["Pm"])
        phi = c["cp_radius"] - xc[2]
        active = (phi > -p.contact_margin).to(q.dtype)
        J = torch.cat(Jp, dim=1)  # (nv, 3nc, N), comp-major rows
        vn_t = torch.where(
            phi > 0,
            torch.clamp(erp * phi / h, max=p.max_depenetration_velocity),
            phi / h,
        )
        if has_rest:
            rest = c["rest"]
            vn_pre = torch.sum(J[:, 2 * nc:] * qd_free[:, None], dim=0)
            bounce = (
                (rest > 0.0)
                & (phi > -p.contact_margin)
                & (vn_pre < -p.bounce_threshold_velocity)
            )
            vn_t = torch.where(bounce, torch.maximum(vn_t, -rest * vn_pre), vn_t)
        warm = q.new_zeros(3 * nc, N) if warm is None else warm

        # Delassus A = J^T Minv J
        W = sum(Minv[:, j:j + 1, :] * J[j][None] for j in range(s.nv))
        A = sum(J[v][:, None, :] * W[v][None] for v in range(s.nv))
        b_vec = torch.sum(J * qd_free[:, None], dim=0)
        b_vec = torch.cat([b_vec[:2 * nc], b_vec[2 * nc:] - vn_t], 0)

        # per-contact Jacobi scaling by the mean block diagonal
        diagA = torch.sum(J * W, dim=0)
        d_c = (diagA[:nc] + diagA[nc:2 * nc] + diagA[2 * nc:]) / 3.0 + 1e-6
        s_c = torch.rsqrt(torch.clamp(d_c, min=1e-12))
        s3 = torch.cat([s_c, s_c, s_c], 0)
        s3sq = s3 * s3
        A = A * s3[:, None] * s3[None]
        b_vec = b_vec * s3
        # Lipschitz bound incl. the scaled 1e-6 regularization of the matvec
        Lip = torch.amax(torch.sum(torch.abs(A), dim=1) + 1e-6 * s3sq, dim=0, keepdim=True)
        step = 1.0 / torch.clamp(Lip, min=1e-8)
        mu = c["mu"]

        def project(y):
            ln = torch.clamp(y[2 * nc:], min=0.0)
            t1, t2 = y[:nc], y[nc:2 * nc]
            tn = torch.sqrt(t1 * t1 + t2 * t2 + 1e-12)
            sc = torch.clamp(mu * ln / tn, max=1.0) * active
            return torch.cat([t1 * sc, t2 * sc, ln * active], 0)

        lam = project(warm / s3)
        y = lam
        for beta in betas:
            g_vec = torch.sum(A * y[None], dim=1) + 1e-6 * s3sq * y + b_vec
            lam_new = project(y - step * g_vec)
            y = lam_new + beta * (lam_new - lam)
            lam = lam_new
        lam = lam * s3  # back to physical impulses

        qfrc_con = torch.sum(J * lam[None], dim=1)
        dqd = torch.sum(Minv * qfrc_con[None], dim=1)
        qd_new = torch.clamp(qd_free + dqd, -p.max_dof_velocity, p.max_dof_velocity)
        q_new = integrate(q, qd_new)

        # sensors: per-body contact force/torque (world), dof force
        inv_h = 1.0 / h
        Fp = [lam[:nc] * inv_h, lam[nc:2 * nc] * inv_h, lam[2 * nc:] * inv_h]
        rel = [xc[k] - bX[k] for k in range(3)]
        tq = _cross(rel, Fp)
        boc = c["boc"]
        body_force = torch.cat([boc @ Fp[k] for k in range(3)], 0)
        body_torque = torch.cat([boc @ tq[k] for k in range(3)], 0)
        return q_new, qd_new, lam, body_force, body_torque, qfrc_con * inv_h

    return substep


def _step_math_torch(s: _Spec, p: SimParams, device):
    """Plain PyTorch version of the whole step on (rows, N) tensors.

    Returns run(q, qd, qfrc, xfrc) -> (q, qd, body_force, body_torque,
    dof_force), all (rows, N); xfrc is (6*nbody, N) comp-major or None.
    """
    n_slices = p.substeps * p.solver_iterations
    substep = _substep_fn(s, p, p.dt / n_slices, device)

    def run(q, qd, qfrc, xfrc):
        warm = None  # zeros at each call, carried across its slices
        for _ in range(n_slices):
            q, qd, warm, bf, bt, doff = substep(q, qd, qfrc, xfrc, warm)
        return q, qd, bf, bt, doff

    return run


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

# (model, params, device) -> prepared step; the model and params objects
# are held so that their ids stay unique while the entry lives
_CACHE: dict = {}


def _prepared(model: Model, params: SimParams, device: torch.device):
    key = (id(model), id(params), str(device))
    hit = _CACHE.get(key)
    if hit is None or hit[0] is not model or hit[1] is not params:
        s = _extract(model)
        if device.type == "cuda":
            from . import _cuda

            step = _cuda.FusedStepCall(
                s, params, apgd_betas(params.solver_apgd_iterations), device
            )
        else:
            step = _step_math_torch(s, params, device)
        hit = (model, params, s, step)
        _CACHE[key] = hit
    return hit[2], hit[3]


def physics_step_fused(
    model: Model,
    params: SimParams,
    q: torch.Tensor,  # (N, nq)
    qd: torch.Tensor,  # (N, nv)
    qfrc: torch.Tensor,  # (N, nv)
    xfrc: torch.Tensor | None = None,  # (N, nbody, 6): torque, force
    q_target: torch.Tensor | None = None,
    dyn: dict | None = None,
    warm_reset_every: int = 0,
) -> FusedOut:
    """Batched full physics step through the fused kernel.

    Env-leading inputs and outputs; internally (rows, N). A CUDA tensor
    launches the CUDA kernel; a CPU tensor runs the plain version.
    """
    if not fused_supported(model, params):
        raise NotImplementedError(
            "model features beyond the ported kernel tiers (pair rows, "
            "anchors, top-K, tendons or terrain)"
        )
    if q_target is not None or dyn or warm_reset_every:
        raise NotImplementedError(
            "q_target drives, per-env model leaves and merged decimation "
            "windows are not ported yet"
        )
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    N = q.shape[0]
    s, step = _prepared(model, params, q.device)
    f32 = lambda a: a.to(torch.float32).T.contiguous()
    xf = None
    if xfrc is not None:
        # (N, nbody, 6) -> comp-major rows (6*nbody, N)
        xf = xfrc.to(torch.float32).permute(2, 1, 0).reshape(6 * s.nbody, N).contiguous()
    q2, qd2, bf, bt, doff = step(f32(q), f32(qd), f32(qfrc), xf)
    return FusedOut(
        q=q2.T,
        qd=qd2.T,
        body_force=bf.reshape(3, s.nbody, N).permute(2, 1, 0),
        body_torque=bt.reshape(3, s.nbody, N).permute(2, 1, 0),
        dof_force=doff.T,
    )
