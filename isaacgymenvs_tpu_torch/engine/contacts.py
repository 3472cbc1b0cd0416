"""Constraint rows and the contact-impulse solve of the eager engine (port
of isaacgymenvs_tpu/engine/contacts.py), batched over envs.

Five sources of rows, assembled into one Delassus system per env:

  1. candidate points against the ground plane, or a heightfield
     (`Terrain`, sampled per slice under each point);
  2. geom-geom pairs (a sphere against another geom, analytic narrowphase);
  3. candidate points against geoms (`ppair_*`);
  4. candidate points against voxel SDF grids (`spair_*`), the grid looked
     up at every slice (the kernel freezes the plane at the step's entry);
  5. bilateral point anchors (`att_*`).

Each constraint has three rows in its frame (t1, t2, n); unilateral rows
take the Coulomb cone, bilateral rows none. The solve is APGD (FISTA with
per-contact Jacobi scaling) or PGS (a sequential sweep), on the top-K most
penetrating rows when `max_active_contacts` caps them.

Tensors are env-leading (N, ...). The products are plain PyTorch
(`torch.matmul`): on the card they rely on torch's default of full float32
matmuls (`torch.backends.cuda.matmul.allow_tf32` False). The sums over the
rows of one body are products with static 0/1 matrices, not `index_add_`,
so that two runs from one state agree to the bit on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import maths
from ..model.spec import GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, Model
from . import dynamics as _dyn
from .dynamics import Kin, SimParams
from .fused import _sdf_grids, _tangent_basis, apgd_betas


def num_constraints(model: Model) -> int:
    """Static number of constraints (three rows each) of the model."""
    n = model.ncp if (model.ncp and model.plane_contacts) else 0
    return n + len(model.pair_geom_a) + len(model.ppair_point) + len(model.spair_point) + len(model.att_body)


class ConstraintData(NamedTuple):
    J: torch.Tensor  # (N, nc, 3, nv) rows (t1, t2, n) of the relative-velocity Jacobian
    phi: torch.Tensor  # (N, nc) penetration depth (> 0 penetrating); 0 for bilateral rows
    err: torch.Tensor  # (N, nc, 3) anchor error (bilateral rows), world frame
    mu: torch.Tensor  # (N, nc)
    bilateral: torch.Tensor  # (N, nc) 1.0: no cone projection
    active: torch.Tensor  # (N, nc) bool
    x: torch.Tensor  # (N, nc, 3) world application points
    frame: torch.Tensor  # (N, nc, 3, 3) rows t1, t2, n (world)
    rest: torch.Tensor  # (N, nc) restitution coefficient
    body_a: np.ndarray  # (nc,) static: the body receiving +impulse
    body_b: np.ndarray  # (nc,) static: the body receiving -impulse (-1 = world)


def _point_jacobian(kin: Kin, anc: torch.Tensor, dof_body: np.ndarray, bodies, x: torch.Tensor) -> torch.Tensor:
    """J with J qd = the world velocity of the point x (N, k, 3) fixed to
    `bodies` (k static ints) -> (N, k, 3, nv)."""
    P = anc[np.asarray(bodies)][:, np.asarray(dof_body)]  # (k, nv) path mask
    S_ang, S_lin = kin.S[..., :3], kin.S[..., 3:]  # (N, nv, 3)
    contrib = S_lin[:, None] + torch.linalg.cross(S_ang[:, None], x[:, :, None], dim=-1)  # (N, k, nv, 3)
    return (contrib * P[None, :, :, None]).transpose(-1, -2)


def _sphere_vs_geom(center, radius, gtype: int, gpos, gquat, gsize):
    """Closest-point query of spheres (center (N, k, 3), radius (k,) or (N,
    k)) against one geom per env (gpos (N, 1, 3), gquat (N, 1, 4), gsize
    (3,) or (N, 1, 3)), in the world. Returns (phi (N, k), normal from the
    geom into the sphere (N, k, 3), contact point (N, k, 3)). A geom that is
    neither sphere, capsule nor box (a cylinder; a mesh on its bounding
    half-extents) takes the cylinder branch."""
    d = maths.quat_rotate_inverse(gquat, center - gpos)  # sphere centre in the geom frame
    g0, g1, g2 = gsize[..., 0], gsize[..., 1], gsize[..., 2]
    norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
    zeros = torch.zeros_like(d[..., 0])
    if gtype == GEOM_SPHERE:
        dist = norm(d)
        n_l = d / torch.clamp(dist, min=1e-9)[..., None]
        phi = g0 + radius - dist
        surf = n_l * g0[..., None]
    elif gtype == GEOM_CAPSULE:
        z = torch.minimum(torch.maximum(d[..., 2], -g1), g1)
        seg = torch.stack([zeros, zeros, z], -1)
        rel = d - seg
        dist = norm(rel)
        n_l = rel / torch.clamp(dist, min=1e-9)[..., None]
        phi = g0 + radius - dist
        surf = seg + n_l * g0[..., None]
    else:  # box, or cylinder: clamp into the volume, with a push out through the nearest face inside
        if gtype == GEOM_BOX:
            half = torch.stack(torch.broadcast_tensors(g0, g1, g2), -1).expand(d.shape)
            c = torch.minimum(torch.maximum(d, -half), half)
            inside = torch.all(torch.abs(d) < half, dim=-1)
            gaps = half - torch.abs(d)
            k = torch.argmin(gaps, dim=-1, keepdim=True)  # the first of equal gaps, as jnp.argmin
            onehot = torch.zeros_like(d).scatter_(-1, k, 1.0)
            sign = torch.sign(torch.gather(d, -1, k))
            c_in = torch.where(onehot > 0, sign * half, d)
            n_in = onehot * sign
            pen_in = torch.gather(gaps, -1, k)[..., 0]
        else:  # CYLINDER: radius g0, half-height g1
            r_xy = norm(d[..., :2])
            scale = torch.clamp(g0 / torch.clamp(r_xy, min=1e-9), max=1.0)
            c = torch.cat([d[..., :2] * scale[..., None],
                           torch.minimum(torch.maximum(d[..., 2:3], -g1[..., None]), g1[..., None])], -1)
            inside = (r_xy < g0) & (torch.abs(d[..., 2]) < g1)
            gap_r = g0 - r_xy
            gap_z = g1 - torch.abs(d[..., 2])
            ex = torch.stack([torch.ones_like(zeros), zeros, zeros], -1)
            radial_dir = torch.where((r_xy > 1e-6)[..., None],
                                     torch.cat([d[..., :2] / torch.clamp(r_xy, min=1e-9)[..., None],
                                                zeros[..., None]], -1), ex)
            use_r = (gap_r < gap_z)[..., None]
            c_in = torch.where(use_r, torch.cat([radial_dir[..., :2] * g0[..., None], d[..., 2:3]], -1),
                               torch.cat([d[..., :2], torch.sign(d[..., 2:3]) * g1[..., None]], -1))
            ez = torch.stack([zeros, zeros, torch.ones_like(zeros)], -1)
            n_in = torch.where(use_r, radial_dir, ez * torch.sign(d[..., 2:3]))
            pen_in = torch.minimum(gap_r, gap_z)
        rel = d - c
        dist = norm(rel)
        n_out = rel / torch.clamp(dist, min=1e-9)[..., None]
        phi = torch.where(inside, radius + pen_in, radius - dist)
        n_l = torch.where(inside[..., None], n_in, n_out)
        surf = torch.where(inside[..., None], c_in, c)
    n_w = maths.quat_rotate(gquat, n_l)
    x_w = gpos + maths.quat_rotate(gquat, surf)
    return phi, n_w, x_w


def _world_points(kin: Kin, bodies, pos):
    """Body-frame points pos ((k, 3) or (N, k, 3)) of `bodies` in the world, (N, k, 3)."""
    b = np.asarray(bodies)
    return kin.x[:, b] + maths.quat_rotate(kin.quat[:, b], pos)


def constraint_data(model: Model, kin: Kin, anc: torch.Tensor, plane_friction=1.0, terrain=None,
                    leaves: dict | None = None) -> ConstraintData:
    """Every constraint row of the model at the kinematics `kin` (N envs):
    plane or heightfield contacts, geom-geom pairs, point-geom pairs,
    point-SDF pairs, anchors, in that order. `leaves` holds per-env model
    leaves (`dynamics.model_leaves`)."""
    N, dev, dt = kin.x.shape[0], kin.x.device, kin.x.dtype
    lv = _dyn.model_leaves(model, dev, dt, leaves)
    anc = anc.to(dt)
    dof_body = np.asarray(model.dof_body)
    nv = model.nv
    eye = torch.eye(3, dtype=dt, device=dev)
    parts = []  # (J, phi, err, mu, bilateral, x, frame, rest, body_a, body_b)

    def add(J, phi, mu, x, frame, rest, ba, bb, err=None, bilateral=0.0):
        k = phi.shape[1]
        parts.append((J, phi, torch.zeros(N, k, 3, dtype=dt, device=dev) if err is None else err,
                      mu.expand(N, k), torch.full((N, k), bilateral, dtype=dt, device=dev), x, frame,
                      rest.expand(N, k), np.asarray(ba, np.int64), np.asarray(bb, np.int64)))

    def rest_of(sel):
        r = lv["cpoint_restitution"]
        return torch.zeros(len(sel), dtype=dt, device=dev) if r is None else r[..., np.asarray(sel)]

    def geom_pose(g):
        b = model.geom_body[g]
        pos = kin.x[:, b:b + 1] + maths.quat_rotate(kin.quat[:, b:b + 1], lv["geom_pos"][..., g:g + 1, :])
        quat = maths.quat_mul(kin.quat[:, b:b + 1], lv["geom_quat"][..., g:g + 1, :].expand(N, 1, 4))
        return b, pos, quat, lv["geom_size"][..., g:g + 1, :]

    def two_body(bodies, bb, x, n, phi, mu, rest):
        t1, t2 = _tangent_basis(n)
        C = torch.stack([t1, t2, n], dim=-2)  # (N, k, 3, 3)
        Ja = _point_jacobian(kin, anc, dof_body, bodies, x)
        Jb = _point_jacobian(kin, anc, dof_body, np.full(len(bodies), bb), x)
        add(C @ (Ja - Jb), phi, mu, x, C, rest, bodies, np.full(len(bodies), bb))

    # 1. candidate points against the ground (plane or heightfield)
    if model.ncp and model.plane_contacts:
        bodies = np.asarray(model.cpoint_body)
        x = _world_points(kin, bodies, lv["cpoint_pos"])
        Jp = _point_jacobian(kin, anc, dof_body, bodies, x)  # world rows x, y, z
        if terrain is None:
            phi = lv["cpoint_radius"] - x[..., 2]
            frame = eye.expand(N, len(bodies), 3, 3)
            J = Jp
        else:
            h, n = terrain.sample_grad_patch(torch.mean(x[..., :2], dim=1), x[..., :2], P=32)
            phi = lv["cpoint_radius"] - (x[..., 2] - h) * n[..., 2]  # depth along the normal
            t1, t2 = _tangent_basis(n)
            frame = torch.stack([t1, t2, n], dim=-2)
            J = frame @ Jp
        add(J, phi, lv["cpoint_friction"] * plane_friction, x, frame, rest_of(range(model.ncp)), bodies,
            np.full(len(bodies), -1))

    # 2. geom-geom pairs (a sphere against another geom)
    for ga, gb in zip(model.pair_geom_a, model.pair_geom_b):
        ba, pa, _, sa = geom_pose(ga)
        bb, pb, qb, sb = geom_pose(gb)
        phi, n, x = _sphere_vs_geom(pa, sa[..., 0], model.geom_type[gb], pb, qb, sb)
        mu = 0.5 * (lv["geom_friction"][..., ga] + lv["geom_friction"][..., gb])
        two_body([ba], bb, x, n, phi, mu.reshape(-1, 1), torch.zeros(1, dtype=dt, device=dev))

    # 3. candidate points against geoms, grouped by geom
    if len(model.ppair_point):
        pts, geoms = np.asarray(model.ppair_point), np.asarray(model.ppair_geom)
        for gb in np.unique(geoms):
            sel = pts[geoms == gb]
            bodies = np.asarray(model.cpoint_body)[sel]
            bb, pb, qb, sb = geom_pose(int(gb))
            centers = _world_points(kin, bodies, lv["cpoint_pos"][..., sel, :])
            phi, n, x = _sphere_vs_geom(centers, lv["cpoint_radius"][..., sel], model.geom_type[int(gb)], pb, qb,
                                        sb)
            mu = 0.5 * (lv["cpoint_friction"][..., sel] + lv["geom_friction"][..., int(gb), None])
            two_body(bodies, bb, x, n, phi, mu, rest_of(sel))

    # 4. candidate points against SDF grids (mesh vertices against a voxelized mesh), grouped by grid
    if len(model.spair_point):
        from ..sdf.builder import sdf_gradient, sdf_query

        pts, grids = np.asarray(model.spair_point), np.asarray(model.spair_sdf)
        for g in np.unique(grids):
            sel = pts[grids == g]
            bodies = np.asarray(model.cpoint_body)[sel]
            bb = model.sdf_body[int(g)]
            grid = _sdf_grids(model, dev)[int(g)]
            x = _world_points(kin, bodies, lv["cpoint_pos"][..., sel, :])
            qb = kin.quat[:, bb:bb + 1].expand(N, len(sel), 4)
            d = maths.quat_rotate_inverse(qb, x - kin.x[:, bb:bb + 1])  # the grid body's frame
            dist = sdf_query(grid, d)
            grad = sdf_gradient(grid, d)
            n_l = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-9)
            n = maths.quat_rotate(qb, n_l)  # world, out of the grid's body
            two_body(bodies, bb, x, n, lv["cpoint_radius"][..., sel] - dist, lv["cpoint_friction"][..., sel],
                     rest_of(sel))

    # 5. bilateral point anchors
    if len(model.att_body):
        bodies = np.asarray(model.att_body)
        x = _world_points(kin, bodies, lv["att_offset"])
        k = len(bodies)
        add(_point_jacobian(kin, anc, dof_body, bodies, x), torch.zeros(N, k, dtype=dt, device=dev),
            torch.zeros(k, dtype=dt, device=dev), x, eye.expand(N, k, 3, 3), torch.zeros(k, dtype=dt, device=dev),
            bodies, np.full(k, -1), err=lv["att_target"] - x, bilateral=1.0)

    if not parts:  # a constraint-free model
        z = lambda *s: torch.zeros(N, *s, dtype=dt, device=dev)
        return ConstraintData(J=z(0, 3, nv), phi=z(0), err=z(0, 3), mu=z(0), bilateral=z(0),
                              active=torch.zeros(N, 0, dtype=torch.bool, device=dev), x=z(0, 3), frame=z(0, 3, 3),
                              rest=z(0), body_a=np.zeros(0, np.int64), body_b=np.zeros(0, np.int64))
    cols = list(zip(*parts))
    cat = lambda i: torch.cat(cols[i], 1)
    return ConstraintData(
        J=cat(0), phi=cat(1), err=cat(2), mu=cat(3), bilateral=cat(4),
        active=torch.ones(N, sum(p[1].shape[1] for p in parts), dtype=torch.bool, device=dev),
        x=cat(5), frame=cat(6), rest=cat(7), body_a=np.concatenate(cols[8]), body_b=np.concatenate(cols[9]),
    )


# the JAX package's alias of the plane-only call sites
contact_data = constraint_data


class SolveOut(NamedTuple):
    qd: torch.Tensor  # (N, nv) corrected velocity
    impulse: torch.Tensor  # (N, nc, 3) impulses in the constraint frames
    x: torch.Tensor  # (N, nc, 3) application points
    qfrc: torch.Tensor  # (N, nv) generalized constraint impulse J^T lam


def _topk_rows(key: torch.Tensor, cap: int) -> torch.Tensor:
    """(N, cap) indices of the cap largest keys per env, largest first,
    equal keys in index order (the order of `lax.top_k`)."""
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :cap]


def solve_contacts(model: Model, con: ConstraintData, minv_mul, qd_free: torch.Tensor, h, params: SimParams,
                   warm: torch.Tensor | None = None) -> SolveOut:
    """Impulse solve over the constraint rows: the velocity-level QP
    min 1/2 lam^T A lam + lam^T b over the friction cones (R^3 for
    bilateral rows), A = J M^-1 J^T. Under `max_active_contacts` below the
    row count only the top-K rows by predicted depth phi - min(v_n, 0) h
    enter the system (bilateral rows always). `warm` (N, nc, 3) warm-starts
    APGD with the previous slice's impulses."""
    N, nc_full = con.phi.shape
    nv = con.J.shape[-1]
    if nc_full == 0:
        return SolveOut(qd=qd_free, impulse=qd_free.new_zeros(N, 0, 3), x=con.x, qfrc=qd_free.new_zeros(N, nv))
    cap = params.max_active_contacts
    bil_full = con.bilateral > 0
    active_full = con.active & ((con.phi > -params.contact_margin) | bil_full)
    J, phi, err, mu, bil, active, frame, rest = (con.J, con.phi, con.err, con.mu, con.bilateral, active_full,
                                                 con.frame, con.rest)
    warm_sel, sel = warm, None
    if cap and cap < nc_full:
        # bilateral rows always win, then the predicted depth at the slice's end
        vn = torch.einsum("ncv,nv->nc", J[:, :, 2, :], qd_free)
        key = phi - torch.clamp(vn, max=0.0) * h
        key = torch.where(bil_full, torch.inf, key)
        key = torch.where(active_full, key, -torch.inf)
        sel = _topk_rows(key, cap)
        take = lambda t: torch.gather(t, 1, sel.reshape(N, cap, *([1] * (t.dim() - 2))).expand(N, cap, *t.shape[2:]))
        J, phi, err, mu, bil, active, frame, rest = map(take, (J, phi, err, mu, bil, active, frame, rest))
        warm_sel = None if warm is None else take(warm)
    nc = phi.shape[1]
    Jf = J.reshape(N, nc * 3, nv)
    MinvJT = minv_mul(Jf.transpose(1, 2))  # (N, nv, 3 nc)
    A = Jf @ MinvJT + 1e-6 * torch.eye(nc * 3, dtype=Jf.dtype, device=Jf.device)
    b = (Jf @ qd_free[..., None])[..., 0].reshape(N, nc, 3)

    # Baumgarte: push out at erp phi / h, capped; a separated row in the
    # margin allows approach at up to its gap / h
    vn_target = torch.where(phi > 0, torch.clamp(params.baumgarte_erp * phi / h,
                                                 max=params.max_depenetration_velocity), phi / h)
    # Newton restitution above the bounce threshold, the larger outward target wins
    vn_pre = b[..., 2]
    bounce = (rest > 0.0) & (phi > -params.contact_margin) & (vn_pre < -params.bounce_threshold_velocity)
    vn_target = torch.where(bounce, torch.maximum(vn_target, -rest * vn_pre), vn_target)
    b = torch.cat([b[..., :2], (b[..., 2] - vn_target)[..., None]], -1)
    # bilateral anchors: drive the whole 3D error to zero
    v_err = torch.einsum("ncij,ncj->nci", frame, err) * (params.baumgarte_erp_attractor / h)
    b = b - v_err * bil[..., None]

    if params.solver == "apgd":
        lam = _solve_apgd(A, b, mu, active, bil, params, warm_sel)
    else:
        lam = _solve_pgs(A, b, mu, active, bil, params)
    lam_flat = lam.reshape(N, nc * 3, 1)
    qd = qd_free + (MinvJT @ lam_flat)[..., 0]
    qfrc = (Jf.transpose(1, 2) @ lam_flat)[..., 0]
    impulse = lam if sel is None else lam.new_zeros(N, nc_full, 3).scatter(1, sel[..., None].expand(N, nc, 3), lam)
    return SolveOut(qd=qd, impulse=impulse, x=con.x, qfrc=qfrc)


_GROUP_CACHE: dict = {}


def _group_mats(nc: int, device=None, dtype=torch.float32):
    """Static 0/1 matrices between flat rows (nc*3, contact-major t1, t2, n)
    and per-contact scalars (nc,): Gn (nc, 3 nc) picks the normal rows, Gt
    sums the two tangent rows; tmask (3 nc,) marks the tangent rows. The
    per-contact sums of the solve are products with them,
    which sum in a fixed order on the card (made once per size, device and
    dtype)."""
    key = (nc, str(device), dtype)
    if key not in _GROUP_CACHE:
        Gn = np.zeros((nc, 3 * nc), np.float32)
        Gn[np.arange(nc), 2 + 3 * np.arange(nc)] = 1.0
        Gt = np.zeros((nc, 3 * nc), np.float32)
        Gt[np.arange(nc), 3 * np.arange(nc)] = 1.0
        Gt[np.arange(nc), 1 + 3 * np.arange(nc)] = 1.0
        t = lambda a: torch.as_tensor(a, device=device).to(dtype)
        _GROUP_CACHE[key] = (t(Gn), t(Gt), t(Gt.sum(0)))
    return _GROUP_CACHE[key]


def _project_flat(y, mu, active_f, bilateral, Gn, Gt, tmask):
    """Friction-cone projection of flat rows (N, nc*3) for unilateral
    contacts (identity for bilateral ones) through the group matrices, times
    the flat activity mask."""
    lnc = y @ Gn.T  # (N, nc) normal components
    bil = bilateral > 0
    ln = torch.where(bil, lnc, torch.clamp(lnc, min=0.0))
    lt_norm = torch.sqrt((y * y * tmask) @ Gt.T + 1e-12)
    scale = torch.where(bil, 1.0, torch.clamp(mu * ln / lt_norm, max=1.0))
    return (y * (scale @ Gt) * tmask + ln @ Gn) * active_f


def _solve_apgd(A, b, mu, active, bilateral, params: SimParams, warm=None) -> torch.Tensor:
    """FISTA on the scaled system: each contact's three rows scaled by
    1/sqrt(the mean of its diagonal block), the step 1 / (the largest
    absolute row sum), the momentum schedule of `apgd_betas`; starts from
    proj(warm / s). Returns (N, nc, 3) impulses."""
    N, nc = b.shape[:2]
    n = nc * 3
    bf = b.reshape(N, n)
    Gn, Gt, tmask = _group_mats(nc, b.device, b.dtype)
    Gc = Gn + Gt  # (nc, n) each contact's three rows
    active_f = active.to(b.dtype) @ Gc  # (N, n)
    # per-contact Jacobi scaling: a light body against a heavy arm would
    # otherwise set the step for every contact; the cone is invariant under it
    d_c = (torch.diagonal(A, dim1=-2, dim2=-1) @ Gc.T) / 3.0
    s = (1.0 / torch.sqrt(torch.clamp(d_c, min=1e-12))) @ Gc  # (N, n) row scales
    A = A * s[:, :, None] * s[:, None, :]
    bf = bf * s
    L = torch.clamp(torch.amax(torch.sum(torch.abs(A), dim=2), dim=1), min=1e-8)
    step = (1.0 / L)[:, None]
    # the momentum schedule rounded to float32, as the JAX package holds it
    betas = torch.tensor(apgd_betas(params.solver_apgd_iterations), dtype=torch.float32).tolist()
    proj = lambda y: _project_flat(y, mu, active_f, bilateral, Gn, Gt, tmask)
    lam = bf.new_zeros(N, n) if warm is None else proj(warm.reshape(N, n) / s)
    y = lam
    for beta in betas:
        g = (A @ y[..., None])[..., 0] + bf
        lam_new = proj(y - step * g)
        y = lam_new + beta * (lam_new - lam)
        lam = lam_new
    return (lam * s).reshape(N, nc, 3)


def _solve_pgs(A, b, mu, active, bilateral, params: SimParams) -> torch.Tensor:
    """Block Gauss-Seidel: `solver_pgs_iterations` sweeps over the contacts
    in order, each solving its normal row, then its two tangent rows under
    the cone. Returns (N, nc, 3) impulses."""
    N, nc = b.shape[:2]
    A4 = A.reshape(N, nc, 3, nc, 3)
    idx = torch.arange(nc, device=A.device)
    blocks = A4[:, idx, :, idx, :].transpose(0, 1)  # (N, nc, 3, 3) diagonal blocks
    inv_dnn = 1.0 / blocks[..., 2, 2]
    Dt = blocks[..., :2, :2]
    det = Dt[..., 0, 0] * Dt[..., 1, 1] - Dt[..., 0, 1] * Dt[..., 1, 0]
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    Dt_inv = torch.stack([torch.stack([Dt[..., 1, 1], -Dt[..., 0, 1]], -1),
                          torch.stack([-Dt[..., 1, 0], Dt[..., 0, 0]], -1)], -2) / det[..., None, None]
    bil = bilateral > 0
    lam = b.new_zeros(N, nc, 3)
    for _ in range(params.solver_pgs_iterations):
        for c in range(nc):
            r = torch.einsum("nikl,nkl->ni", A4[:, c], lam) + b[:, c]
            ln_raw = lam[:, c, 2] - r[:, 2] * inv_dnn[:, c]
            ln = torch.where(bil[:, c], ln_raw, torch.clamp(ln_raw, min=0.0))
            dn = ln - lam[:, c, 2]
            r_t = r[:, :2] + A4[:, c, :2, c, 2] * dn[:, None]
            lt = lam[:, c, :2] - (Dt_inv[:, c] @ r_t[..., None])[..., 0]
            lt_norm = torch.sqrt(torch.sum(lt * lt, dim=-1) + 1e-12)
            cap = torch.where(bil[:, c], 1e30, mu[:, c] * ln)
            lt = lt * torch.clamp(cap / lt_norm, max=1.0)[:, None]
            new_c = torch.where(active[:, c, None], torch.cat([lt, ln[:, None]], -1), 0.0)
            lam = torch.cat([lam[:, :c], new_c[:, None], lam[:, c + 1:]], 1)
    return lam


def accumulate_body_wrench(model: Model, con: ConstraintData, out: SolveOut, kin: Kin, h):
    """Per-body contact force and torque about the body's origin (N, nbody,
    3) each, from the impulses: +F on body_a, -F on body_b. The sums over a
    body's rows are products with static one-hot matrices."""
    F = torch.einsum("ncji,ncj->nci", con.frame, out.impulse / h)  # world forces
    nb, dev, dt = model.nbody, F.device, F.dtype
    onehot = lambda bodies: torch.as_tensor(np.eye(nb, dtype=np.float32)[bodies].T, device=dev).to(dt)
    ba = con.body_a
    force = onehot(ba) @ F
    torque = onehot(ba) @ torch.linalg.cross(out.x - kin.x[:, ba], F, dim=-1)
    idx = np.where(con.body_b >= 0)[0]
    if len(idx):
        bb = con.body_b[idx]
        force = force - onehot(bb) @ F[:, idx]
        torque = torque - onehot(bb) @ torch.linalg.cross(out.x[:, idx] - kin.x[:, bb], F[:, idx], dim=-1)
    return force, torque
