"""Fused whole physics step: host side and plain PyTorch version.

Port of isaacgymenvs_tpu/engine/fused.py. One call advances every env by
one physics step (all `substeps x solver_iterations` slices):

  FK -> spatial inertia -> CRBA mass matrix -> bias force (+ xfrc) ->
  implicit passive forces -> Gauss-Jordan inverse -> plane contact rows
  (Baumgarte, restitution) -> top-K active set -> Delassus J^T M^-1 J ->
  Jacobi scaling -> APGD cone solve (warm start carried across the call's
  slices) -> impulse to qd, velocity clip, semi-implicit Euler -> sensors.

At the boundary arrays are laid out (rows, N), envs last, as the TPU
kernel has them. On a CUDA tensor `physics_step_fused` launches the
hand-written kernel `csrc/fused_step.cu` (through `_cuda.py`) or raises;
on a CPU tensor it runs `_step_math_torch`, the plain twin of the JAX
`_step_math`, which the CPU tests hold against the JAX package and
`chip_smoke.py` holds the kernel against on the card.

Feature set (`fused_supported`): free/hinge/slide/fixed joints, plane
contacts from candidate points, point-vs-geom pair rows (sphere, box and
cylinder geoms; a mesh geom rides the cylinder branch), bilateral point
anchors, external body wrenches, PD-drive setpoints (`q_target`), joint
limits, implicit damping/stiffness, joint friction, fixed tendons, Newton
restitution, per-env model leaves (`dyn`: the domain-randomization
surface `DYN_LEAVES` plus per-env gravity), which reach the step as one
packed (rows, N) input (`pack_dyn`), heightfield terrain through planes
sampled per candidate point at the call's entry pose (`terrain_dyn`, ten
(nc, N) rows), candidate points against voxel SDF grids through planes
sampled per SDF pair row at the call's entry pose (`sdf_dyn`, thirteen
(nsp, N) rows), the top-K active set (`max_active_contacts`: only the cap
most-penetrating candidates enter the solve) and merged decimation windows
(`warm_reset_every`: the warm start resets where separate calls would
start). Geom-geom pairs raise NotImplementedError by name, and so does a
model whose kernel instantiation would not fit the card's shared memory at
one env per block (`_cuda.smem_bytes`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import maths as _maths
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


# geom types a pair row's narrowphase covers: SPHERE, BOX, CYLINDER, and
# MESH, which takes the cylinder branch on its bounding half-extents
_PAIR_GEOM_TYPES = (0, 2, 3, 5)


def unsupported_features(model: Model, params: SimParams, terrain=None) -> list:
    """Names of what this model or operating point asks for beyond the
    ported kernel tiers (empty when the kernel and its twin cover it)."""
    n_plane = model.ncp if model.plane_contacts else 0
    natt = len(model.att_body)
    nct = n_plane + len(model.ppair_point) + len(model.spair_point) + natt
    cap = params.max_active_contacts
    asked = {
        "terrain without plane candidates": terrain is not None and not n_plane,
        f"solver={params.solver}": params.solver != "apgd",
        "geom-geom pairs (pair_geom_a)": bool(len(model.pair_geom_a)),
        "pair rows against capsule or plane geoms": any(
            model.geom_type[g] not in _PAIR_GEOM_TYPES for g in model.ppair_geom
        ),
        # bilateral rows always take a slot: the cap must leave room for others
        f"top-K active set with max_active_contacts={cap} <= {natt} anchors": bool(cap and cap < nct and cap <= natt),
    }
    out = [k for k, v in asked.items() if v]
    if not out:
        # the kernel keeps each env's state, J and W = M^-1 J in shared memory:
        # a model that does not fit at one env per block cannot launch
        from ._cuda import SMEM_OPTIN_BYTES

        need = _smem_at_one_env(model, params, terrain is not None)
        if need > SMEM_OPTIN_BYTES:
            out.append(f"shared memory: {need} bytes per block at one env per block, over the "
                       f"{SMEM_OPTIN_BYTES}-byte limit of one block on the H100")
    return out


def _smem_at_one_env(model: Model, params: SimParams, has_terr: bool) -> int:
    """Shared memory of the model's kernel block at one env (cached)."""
    from . import _cuda

    key = (id(model), id(params), "smem", has_terr)
    hit = _CACHE.get(key)
    if hit is None or hit[0] is not model or hit[1] is not params:
        hit = (model, params, _cuda.smem_bytes(spec_of(model), params, 1, has_terr=has_terr))
        _CACHE[key] = hit
    return hit[2]


def fused_supported(model: Model, params: SimParams, terrain=None) -> bool:
    """True when the port's kernel (and its twin) covers this model."""
    return not unsupported_features(model, params, terrain)


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
    # point-vs-geom pair rows: candidate point on body A against an
    # analytic geom on body B, static per row
    pp_nc: int
    pp_a: np.ndarray  # (npp,) point body
    pp_b: np.ndarray  # (npp,) geom body
    pp_pos: np.ndarray  # (npp, 3) point in body-A frame
    pp_radius: np.ndarray  # (npp,)
    pp_mu: np.ndarray  # (npp,) mean of point and geom friction
    pp_gtype: np.ndarray  # (npp,) 0 sphere, 2 box, 3 cylinder (mesh folded in)
    pp_gpos: np.ndarray  # (npp, 3) geom offset in body-B frame
    pp_gquat: np.ndarray  # (npp, 4)
    pp_gsize: np.ndarray  # (npp, 3)
    pp_path: np.ndarray  # (nv, npp) SIGNED dof path mask (A - B)
    # what a per-env leaf needs to find a pair row's entries: the row's
    # candidate point and geom in the model's arrays, the geom-side friction
    ncp_model: int  # candidate points of the model (plane rows are [0..nc))
    ngeom: int
    pp_pt: np.ndarray  # (npp,) index into the model's cpoint arrays
    pp_geom: np.ndarray  # (npp,) index into the model's geom arrays
    pp_geom_fric: np.ndarray  # (npp,)
    # candidate points against voxel SDF grids: the point on body A, the grid
    # on body B; rows grouped by grid (stable), after the pair rows
    sp_n: int
    sp_a: np.ndarray  # (nsp,) point body
    sp_b: np.ndarray  # (nsp,) the grid's body
    sp_pos: np.ndarray  # (nsp, 3) point in body-A frame
    sp_mu: np.ndarray  # (nsp,) the point's friction
    sp_pt: np.ndarray  # (nsp,) index into the model's cpoint arrays
    sp_path: np.ndarray  # (nv, nsp) SIGNED dof path mask (A - B)
    # bilateral point anchors
    att_n: int
    att_body: np.ndarray  # (natt,)
    att_offset: np.ndarray  # (natt, 3) anchor point in body frame
    att_target: np.ndarray  # (natt, 3) world target
    att_path: np.ndarray  # (nv, natt) dof path mask
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
    rest: np.ndarray  # (nc + npp + nsp,) per-row Newton restitution
    free_bodies: tuple
    # fixed tendons (None without any, as in the JAX package)
    tendon_coef: np.ndarray | None = None  # (nt, nv)
    tendon_range: np.ndarray | None = None  # (nt, 2)
    tendon_stiffness: np.ndarray | None = None  # (nt,)
    tendon_damping: np.ndarray | None = None  # (nt,)

    @property
    def nct(self) -> int:
        """Contacts in the solve: plane, pair, SDF and anchor rows, in that order."""
        return self.nc + self.pp_nc + self.sp_n + self.att_n

    @property
    def nt(self) -> int:
        return 0 if self.tendon_coef is None else self.tendon_coef.shape[0]


def _extract(model: Model) -> _Spec:
    f32 = lambda x: np.asarray(x, np.float32)
    anc = _dyn.ancestor_matrix(model)
    meta = _dyn.kin_meta(model)
    nc = model.ncp if (model.ncp and model.plane_contacts) else 0
    cp_body = np.asarray(model.cpoint_body, np.int64)[:nc]
    path_mask = anc[cp_body][:, np.asarray(model.dof_body, np.int64)].astype(np.float32)
    boc = np.zeros((model.nbody, nc), np.float32)
    boc[cp_body, np.arange(nc)] = 1.0
    dof_body = np.asarray(model.dof_body, np.int64)
    # pair rows in the order of the JAX package: grouped by geom, stable
    geoms = np.asarray(model.ppair_geom, np.int64)
    order = np.argsort(geoms, kind="stable")
    pts, geoms = np.asarray(model.ppair_point, np.int64)[order], geoms[order]
    npp = len(pts)
    pp_a = np.asarray(model.cpoint_body, np.int64)[pts]
    pp_b = np.asarray(model.geom_body, np.int64)[geoms]
    pp_gtype = np.asarray(model.geom_type, np.int64)[geoms]
    pp_gtype = np.where(pp_gtype == 5, 3, pp_gtype)  # MESH takes the cylinder branch
    pp_path = (anc[pp_a][:, dof_body] - anc[pp_b][:, dof_body]).astype(np.float32).T
    # SDF pair rows in the order of the JAX package: grouped by grid, stable
    sp_grid = np.asarray(model.spair_sdf, np.int64)
    sp_pt = np.asarray(model.spair_point, np.int64)[np.argsort(sp_grid, kind="stable")]
    sp_a = np.asarray(model.cpoint_body, np.int64)[sp_pt]
    sp_b = np.asarray(model.sdf_body, np.int64)[np.sort(sp_grid, kind="stable")]
    att_b = np.asarray(model.att_body, np.int64)
    natt = len(att_b)
    rst = (
        f32(model.cpoint_restitution)
        if model.cpoint_restitution is not None
        else np.zeros(model.ncp, np.float32)
    )
    rest = np.concatenate([rst[:nc], rst[pts], rst[sp_pt]])
    has_t = model.tendon_coef is not None and model.tendon_coef.shape[0] > 0
    return _Spec(
        nbody=model.nbody,
        nq=model.nq,
        nv=model.nv,
        nc=nc,
        pp_nc=npp,
        pp_a=pp_a,
        pp_b=pp_b,
        pp_pos=f32(model.cpoint_pos)[pts],
        pp_radius=f32(model.cpoint_radius)[pts],
        pp_mu=0.5 * (f32(model.cpoint_friction)[pts] + f32(model.geom_friction)[geoms]),
        pp_gtype=pp_gtype,
        pp_gpos=f32(model.geom_pos).reshape(-1, 3)[geoms],
        pp_gquat=f32(model.geom_quat).reshape(-1, 4)[geoms],
        pp_gsize=f32(model.geom_size).reshape(-1, 3)[geoms],
        pp_path=pp_path,
        ncp_model=model.ncp,
        ngeom=len(model.geom_type),
        pp_pt=pts,
        pp_geom=geoms,
        pp_geom_fric=f32(model.geom_friction)[geoms],
        sp_n=len(sp_pt),
        sp_a=sp_a,
        sp_b=sp_b,
        sp_pos=f32(model.cpoint_pos).reshape(-1, 3)[sp_pt],
        sp_mu=f32(model.cpoint_friction)[sp_pt],
        sp_pt=sp_pt,
        sp_path=(anc[sp_a][:, dof_body] - anc[sp_b][:, dof_body]).astype(np.float32).T,
        att_n=natt,
        att_body=att_b,
        att_offset=f32(model.att_offset).reshape(-1, 3)[:natt] if natt else np.zeros((0, 3), np.float32),
        att_target=f32(model.att_target).reshape(-1, 3)[:natt] if natt else np.zeros((0, 3), np.float32),
        att_path=anc[att_b][:, dof_body].astype(np.float32).T,
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
        tendon_coef=f32(model.tendon_coef) if has_t else None,
        tendon_range=f32(model.tendon_range) if has_t else None,
        tendon_stiffness=f32(model.tendon_stiffness) if has_t else None,
        tendon_damping=f32(model.tendon_damping) if has_t else None,
    )


def topk_cap(s: _Spec, p: SimParams) -> int:
    """The top-K cap of this model at this operating point: 0 when every
    candidate enters the solve."""
    cap = p.max_active_contacts
    return cap if cap and cap < s.nct else 0


def apgd_betas(iters: int) -> list:
    """Nesterov momentum schedule of the APGD solve (Python floats)."""
    t_seq = [1.0]
    for _ in range(iters):
        t_seq.append(0.5 * (1.0 + float(np.sqrt(1.0 + 4.0 * t_seq[-1] ** 2))))
    return [(t_seq[k] - 1.0) / t_seq[k + 1] for k in range(iters)]


# ---------------------------------------------------------------------------
# per-env model leaves (domain randomization)
# ---------------------------------------------------------------------------

# Model leaves the step accepts per env: what domain randomization batches
# and the physics reads. Order matters: it is the bit order of the kernel's
# leaf set and the row order of the packed input.
DYN_LEAVES = (
    "dof_damping", "dof_stiffness", "dof_friction", "armature",
    "dof_limit_lower", "dof_limit_upper", "body_mass",
    "cpoint_friction", "cpoint_restitution",
    "tendon_stiffness", "tendon_damping",
    # geometry and inertia leaves (actor scale, full-inertia DR), packed
    # comp-major: row = component * entities + entity
    "body_ipos", "body_inertia", "cpoint_pos", "geom_size",
)
_DYN_COMP = ("body_ipos", "body_inertia", "cpoint_pos", "geom_size")
# leaves DR batches that the engine never reads: dropped
DYN_INERT = ("dof_max_effort",)
DYN_ORDER = DYN_LEAVES + ("gravity",)
# reserved keys of the entry-sampled terrain planes (`terrain_dyn`), nc rows
# each, and of the entry-sampled SDF planes (`sdf_dyn`), nsp rows each
TERRAIN_KEYS = (
    ("_terr_h",)
    + tuple(f"_terr_n{k}" for k in range(3))
    + tuple(f"_terr_t1{k}" for k in range(3))
    + tuple(f"_terr_t2{k}" for k in range(3))
)
SP_KEYS = (
    ("_sp_phi0",)
    + tuple(f"_sp_x0{k}" for k in range(3))
    + tuple(f"_sp_n{k}" for k in range(3))
    + tuple(f"_sp_t1{k}" for k in range(3))
    + tuple(f"_sp_t2{k}" for k in range(3))
)


class PackedDyn(NamedTuple):
    """Per-env leaves as the step takes them: `rows` is (sum of the leaves'
    rows, N) float32, the leaves of `names` one after another."""

    names: tuple  # in DYN_ORDER order
    rows: torch.Tensor


def dyn_rows(s: _Spec) -> dict:
    """Rows of each per-env leaf in the packed input."""
    return {
        **{k: s.nv for k in DYN_LEAVES[:6]},
        "body_mass": s.nbody,
        "cpoint_friction": s.ncp_model,
        "cpoint_restitution": s.ncp_model,
        "tendon_stiffness": s.nt,
        "tendon_damping": s.nt,
        "body_ipos": 3 * s.nbody,
        "body_inertia": 9 * s.nbody,
        "cpoint_pos": 3 * s.ncp_model,
        "geom_size": 3 * s.ngeom,
        "gravity": 3,
    }


def dyn_mask(names) -> int:
    """The leaf set as a bitmask, bit i = DYN_ORDER[i]."""
    return sum(1 << DYN_ORDER.index(k) for k in names)


def dyn_names(s: _Spec, keys) -> tuple:
    """The leaves of `keys` that reach the step, in DYN_ORDER order: inert
    leaves, leaves of zero rows (tendon leaves of a model without tendons)
    and the plane keys (`TERRAIN_KEYS`, `SP_KEYS`: separate inputs) are
    dropped; any other key is a ValueError."""
    keys = {k for k in keys if k not in TERRAIN_KEYS and k not in SP_KEYS}
    unknown = sorted(keys - set(DYN_ORDER) - set(DYN_INERT))
    if unknown:
        raise ValueError(f"dyn keys {unknown} are not per-env leaves of the fused step ({DYN_ORDER})")
    rows = dyn_rows(s)
    return tuple(k for k in DYN_ORDER if k in keys and rows[k] > 0)


def pack_dyn(s: _Spec, dyn: dict) -> PackedDyn | None:
    """Env-leading per-env leaves {name: (N, *leaf.shape)} -> the packed
    (rows, N) input. Component leaves go comp-major, as the step reads them."""
    names = dyn_names(s, dyn)
    if not names:
        return None
    rows, parts = dyn_rows(s), []
    for k in names:
        a = dyn[k].to(torch.float32)
        n = a.shape[0]
        if k in _DYN_COMP:
            # (N, n, 3[, 3]) -> (N, 3[*3] * n): row = comp * n + entity
            a = (a.permute(0, 2, 1) if a.dim() == 3 else a.permute(0, 2, 3, 1)).reshape(n, -1)
        if tuple(a.shape) != (n, rows[k]):
            raise ValueError(f"dyn[{k!r}] has shape {tuple(dyn[k].shape)}, expected {rows[k]} values per env")
        parts.append(a)
    return PackedDyn(names, torch.cat(parts, 1).T.contiguous())


# ---------------------------------------------------------------------------
# heightfield terrain: planes sampled at the call's entry pose
# ---------------------------------------------------------------------------


def _tangent_basis(n: torch.Tensor):
    """Branchless orthonormal tangents (t1, t2) of unit normals n (..., 3):
    t1 = ref x n normalized, ref = z unless n is within 0.9 of z, then x."""
    use_z = (torch.abs(n[..., 2:3]) < 0.9).to(n.dtype)
    ref = torch.cat([1.0 - use_z, torch.zeros_like(use_z), use_z], dim=-1)
    t1 = torch.linalg.cross(ref, n, dim=-1)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-9)
    return t1, torch.linalg.cross(n, t1, dim=-1)


def terrain_dyn(model: Model, terrain, q: torch.Tensor, qd: torch.Tensor) -> dict:
    """The ground plane under each candidate point at the pose (q, qd):
    height h, normal n and tangents t1, t2 of the terrain, sampled in a
    32 x 32-cell window around the env's points (`Terrain.sample_grad_patch`).
    The step holds these planes for all its slices (the JAX package's
    documented freeze: the eager engine resamples per slice).

    q (N, nq), qd (N, nv) -> {TERRAIN_KEYS: (N, ncp)}.
    """
    kin = _dyn.forward_kinematics(model, q, qd)
    bodies = torch.as_tensor(np.asarray(model.cpoint_body, np.int64), device=q.device)
    cpos = torch.as_tensor(np.asarray(model.cpoint_pos, np.float32), device=q.device)
    x = kin.x[:, bodies] + _maths.quat_rotate(kin.quat[:, bodies], cpos)  # (N, ncp, 3)
    center = torch.mean(x[..., :2], dim=1)
    h, n = terrain.sample_grad_patch(center, x[..., :2], P=32)
    t1, t2 = _tangent_basis(n)
    out = {"_terr_h": h}
    for k in range(3):
        out[f"_terr_n{k}"] = n[..., k]
        out[f"_terr_t1{k}"] = t1[..., k]
        out[f"_terr_t2{k}"] = t2[..., k]
    return out


def pack_terrain(planes: dict) -> torch.Tensor:
    """`terrain_dyn`'s planes {TERRAIN_KEYS: (N, nc)} as the step takes them:
    one (10 nc, N) float32 tensor, the keys' rows one after another."""
    return torch.cat([planes[k].to(torch.float32).T for k in TERRAIN_KEYS], 0).contiguous()


# ---------------------------------------------------------------------------
# SDF pair rows: planes sampled at the call's entry pose
# ---------------------------------------------------------------------------


def _sdf_grids(model: Model, device) -> list:
    """The model's SDF grids as `SdfGrid`s of tensors on `device` (cached)."""
    from ..sdf.builder import SdfGrid

    key = (id(model), "sdf", str(device))
    hit = _CACHE.get(key)
    if hit is None or hit[0] is not model:
        grids = [
            SdfGrid(torch.as_tensor(np.asarray(v, np.float32), device=device),
                    torch.as_tensor(np.asarray(o, np.float32), device=device), float(h))
            for v, o, h in zip(model.sdf_values, model.sdf_origin, model.sdf_spacing)
        ]
        hit = (model, grids)
        _CACHE[key] = hit
    return hit[1]


def sdf_dyn(model: Model, q: torch.Tensor, qd: torch.Tensor) -> dict:
    """The contact plane of each SDF pair row at the pose (q, qd): the
    candidate point x0 in the world, the signed depth phi0 = radius - sdf(x0)
    by trilinear lookup in the grid's body frame, the grid's normal n there
    (central difference, turned to the world) and the tangents t1, t2 of n.
    The step holds these planes for all its slices and moves the point
    against the frozen first-order field, phi = phi0 - n . (x - x0) (the JAX
    package's documented freeze). Rows are grouped by grid, stable within a
    grid, as the step orders them.

    q (N, nq), qd (N, nv) -> {SP_KEYS: (N, nsp)}.
    """
    from ..sdf.builder import sdf_gradient, sdf_query

    kin = _dyn.forward_kinematics(model, q, qd)
    dev, n_env = q.device, q.shape[0]
    pts = np.asarray(model.spair_point, np.int64)
    gids = np.asarray(model.spair_sdf, np.int64)
    order = np.argsort(gids, kind="stable")
    pts_o, gids_o = pts[order], gids[order]
    cbody = np.asarray(model.cpoint_body, np.int64)
    cpos = np.asarray(model.cpoint_pos, np.float32)
    crad = np.asarray(model.cpoint_radius, np.float32)
    grids = _sdf_grids(model, dev)
    phis, x0s, ns = [], [], []
    for gid in np.unique(gids_o):
        sel = pts_o[gids_o == gid]
        bodies = torch.as_tensor(cbody[sel], device=dev)
        bb = model.sdf_body[int(gid)]
        x = kin.x[:, bodies] + _maths.quat_rotate(kin.quat[:, bodies], torch.as_tensor(cpos[sel], device=dev))
        qb = kin.quat[:, bb:bb + 1].expand(n_env, len(sel), 4)
        d = _maths.quat_rotate_inverse(qb, x - kin.x[:, bb:bb + 1])
        grid = grids[int(gid)]
        dist = sdf_query(grid, d)
        grad = sdf_gradient(grid, d)
        n_l = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-9)
        phis.append(torch.as_tensor(crad[sel], device=dev) - dist)
        x0s.append(x)
        ns.append(_maths.quat_rotate(qb, n_l))
    phi0, x0, n = torch.cat(phis, 1), torch.cat(x0s, 1), torch.cat(ns, 1)
    t1, t2 = _tangent_basis(n)
    out = {"_sp_phi0": phi0}
    for k in range(3):
        out[f"_sp_x0{k}"] = x0[..., k]
        out[f"_sp_n{k}"] = n[..., k]
        out[f"_sp_t1{k}"] = t1[..., k]
        out[f"_sp_t2{k}"] = t2[..., k]
    return out


def pack_sdf(planes: dict) -> torch.Tensor:
    """`sdf_dyn`'s planes {SP_KEYS: (N, nsp)} as the step takes them: one
    (13 nsp, N) float32 tensor, the keys' rows one after another."""
    return torch.cat([planes[k].to(torch.float32).T for k in SP_KEYS], 0).contiguous()


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


def _substep_fn(s: _Spec, p: SimParams, h: float, device, names: tuple = (), keys=None,
                dtype=torch.float32, delassus=None):
    """Build the single-slice function (the twin of the JAX `_substep_fn`).

    `names` are the per-env leaves the slice will be given in its `dyn`
    dict of (rows, N) tensors; each replaces the model's constant. With a
    list `keys`, each slice with contact rows appends its (phi, selection
    key) rows, (nct, N) each, the key None without a top-K cap: a caller
    that holds the kernel against this version checks from them that no row
    sits at the margin and no two keys tie at the cap. With a list
    `delassus`, each such slice appends (J, M^-1) of its solve: J (nv, 3
    nce, N) over the rows in the solve (gathered under a cap), M^-1 (nv, nv,
    N), from which the kernel's Jacobi scale and Lipschitz bound are formed.
    `dtype`: the
    floating type of the model constants, which the inputs must share
    (float64 gives a reference for how far float32 rounding alone moves a
    step)."""
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    rev_topo = list(range(s.nbody))[::-1]
    dof_of_body = [[d for d in range(s.nv) if s.dof_body[d] == b] for b in range(s.nbody)]
    nc, npp, nsp, natt, nct = s.nc, s.pp_nc, s.sp_n, s.att_n, s.nct
    nuni = nc + npp + nsp  # unilateral rows come first, anchors last
    cap = topk_cap(s, p)
    erp, erp_att = p.baumgarte_erp, p.baumgarte_erp_attractor
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
        mu=T(np.concatenate([s.cp_mu, s.pp_mu, s.sp_mu, np.zeros(natt)])[:, None]),
        rest=T(np.concatenate([s.rest, np.zeros(natt)])[:, None]),
        bil=T(np.concatenate([np.zeros(nuni), np.ones(natt)])[:, None]) > 0,
        Pm=T(s.path_mask.T[:, :, None]),
        boc=T(s.body_of_contact),
        pp_pos=[T(s.pp_pos[:, k:k + 1]) for k in range(3)],
        pp_radius=T(s.pp_radius[:, None]),
        pp_gpos=[T(s.pp_gpos[:, k:k + 1]) for k in range(3)],
        pp_gquat=[T(s.pp_gquat[:, k:k + 1]) for k in range(4)],
        pp_half=[T(s.pp_gsize[:, k:k + 1]) for k in range(3)],
        is_box=T(s.pp_gtype[:, None] == 2) > 0,
        is_cyl=T(s.pp_gtype[:, None] == 3) > 0,
        Pm_pp=T(s.pp_path[:, :, None]),
        sp_pos=[T(s.sp_pos[:, k:k + 1]) for k in range(3)],
        Pm_sp=T(s.sp_path[:, :, None]),
        att_offset=[T(s.att_offset[:, k:k + 1]) for k in range(3)],
        att_target=[T(s.att_target[:, k:k + 1]) for k in range(3)],
        Pm_att=T(s.att_path[:, :, None]),
    )
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    pp_a, pp_b, att_b = idx(s.pp_a), idx(s.pp_b), idx(s.att_body)
    sp_a, sp_b, sp_pt = idx(s.sp_a), idx(s.sp_b), idx(s.sp_pt)
    # a per-env leaf turns its term on even where the model's leaf is all zero
    has_fric = bool(np.any(s.dof_friction)) or "dof_friction" in names
    has_rest = bool(np.any(s.rest)) or "cpoint_restitution" in names
    if s.nt:
        c.update(
            t_coef=T(s.tendon_coef), t_lo=T(s.tendon_range[:, 0:1]), t_hi=T(s.tendon_range[:, 1:2]),
            t_stiff=T(s.tendon_stiffness[:, None]), t_damp=T(s.tendon_damping[:, None]),
        )
    pp_pt, pp_geom = idx(s.pp_pt), idx(s.pp_geom)
    geom_fric = T(s.pp_geom_fric[:, None])
    blocks = lambda arr, n, k: [arr[i * n:(i + 1) * n] for i in range(k)]  # comp-major rows

    def spatial_inertia(Xb, Qb, dyn):
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
        ipos = blocks(dyn["body_ipos"], s.nbody, 3) if "body_ipos" in dyn else c["ipos"]
        Ib = c["Ib"]
        if "body_inertia" in dyn:
            ib = blocks(dyn["body_inertia"], s.nbody, 9)
            Ib = [[ib[a * 3 + b] for b in range(3)] for a in range(3)]
        m = dyn.get("body_mass", c["mass"])
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

    def pair_narrowphase(dvec, half, radius):
        """Point (in the geom's frame) against its box, sphere or cylinder:
        phi, the geom-frame normal (geom -> point) and the surface point."""
        norm = lambda v: torch.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2 + 1e-18)
        # BOX: clamp to the volume; inside, leave through the nearest face
        cb = [torch.minimum(torch.maximum(dvec[k], -half[k]), half[k]) for k in range(3)]
        rel = [dvec[k] - cb[k] for k in range(3)]
        dist_box = norm(rel)
        gaps = [half[k] - torch.abs(dvec[k]) for k in range(3)]
        inside = (gaps[0] > 0) & (gaps[1] > 0) & (gaps[2] > 0)
        g_min = torch.minimum(gaps[0], torch.minimum(gaps[1], gaps[2]))
        k0 = ((gaps[0] <= gaps[1]) & (gaps[0] <= gaps[2])).to(dvec[0].dtype)
        k1 = ((gaps[1] < gaps[0]) & (gaps[1] <= gaps[2])).to(dvec[0].dtype) * (1.0 - k0)
        ks = [k0, k1, 1.0 - k0 - k1]
        sgn = [torch.where(dvec[k] >= 0.0, 1.0, -1.0) for k in range(3)]
        inv_dist = 1.0 / torch.clamp(dist_box, min=1e-9)
        phi_box = torch.where(inside, radius + g_min, radius - dist_box)
        nl_box = [torch.where(inside, ks[k] * sgn[k], rel[k] * inv_dist) for k in range(3)]
        surf_box = [
            torch.where(inside, ks[k] * sgn[k] * half[k] + (1.0 - ks[k]) * dvec[k], cb[k])
            for k in range(3)
        ]
        # SPHERE: radial closest point
        dist_sph = norm(dvec)
        inv_sph = 1.0 / torch.clamp(dist_sph, min=1e-9)
        nl_sph = [dvec[k] * inv_sph for k in range(3)]
        phi_sph = half[0] + radius - dist_sph
        surf_sph = [nl_sph[k] * half[0] for k in range(3)]
        # CYLINDER along local z: radius half[0], half-height half[1]
        dxy = torch.sqrt(dvec[0] ** 2 + dvec[1] ** 2 + 1e-18)
        sc_c = torch.clamp(half[0] / torch.clamp(dxy, min=1e-9), max=1.0)
        c_cyl = [dvec[0] * sc_c, dvec[1] * sc_c,
                 torch.minimum(torch.maximum(dvec[2], -half[1]), half[1])]
        inside_c = (dxy < half[0]) & (torch.abs(dvec[2]) < half[1])
        gap_r = half[0] - dxy
        gap_z = half[1] - torch.abs(dvec[2])
        big = (dxy > 1e-6).to(dxy.dtype)
        inv_dxy = 1.0 / torch.clamp(dxy, min=1e-9)
        rd = [big * dvec[0] * inv_dxy + (1.0 - big), big * dvec[1] * inv_dxy]
        use_r = (gap_r < gap_z).to(dxy.dtype)
        sgn_z = torch.sign(dvec[2])
        c_in_c = [
            use_r * rd[0] * half[0] + (1.0 - use_r) * dvec[0],
            use_r * rd[1] * half[0] + (1.0 - use_r) * dvec[1],
            use_r * dvec[2] + (1.0 - use_r) * sgn_z * half[1],
        ]
        n_in_c = [use_r * rd[0], use_r * rd[1], (1.0 - use_r) * sgn_z]
        rel_c = [dvec[k] - c_cyl[k] for k in range(3)]
        dist_c = norm(rel_c)
        inv_dc = 1.0 / torch.clamp(dist_c, min=1e-9)
        phi_cyl = torch.where(inside_c, radius + torch.minimum(gap_r, gap_z), radius - dist_c)
        nl_cyl = [torch.where(inside_c, n_in_c[k], rel_c[k] * inv_dc) for k in range(3)]
        surf_cyl = [torch.where(inside_c, c_in_c[k], c_cyl[k]) for k in range(3)]
        # the row's geom type picks its branch
        is_box, is_cyl = c["is_box"], c["is_cyl"]
        pick = lambda b, cy, sp: torch.where(is_box, b, torch.where(is_cyl, cy, sp))
        return (
            pick(phi_box, phi_cyl, phi_sph),
            [pick(nl_box[k], nl_cyl[k], nl_sph[k]) for k in range(3)],
            [pick(surf_box[k], surf_cyl[k], surf_sph[k]) for k in range(3)],
        )

    def substep(q, qd, qfrc, xfrc, q_target, warm, dyn=None, terr=None, sdf=None):
        """One slice. `terr`: the (10 nc, N) entry-sampled terrain planes
        (`pack_terrain`) or None for the flat ground z = 0; `sdf`: the
        (13 nsp, N) entry-sampled SDF planes (`pack_sdf`) of the SDF pair
        rows."""
        dyn = dyn or {}
        N = q.shape[-1]
        Xl, Ql, Vl, S, Sdot = _fk(s, q, qd)
        Xb = [_stackb(Xl, k) for k in range(3)]
        Qb = [_stackb(Ql, k) for k in range(4)]
        Vb = [_stackb(Vl, k) for k in range(6)]
        Io = spatial_inertia(Xb, Qb, dyn)
        # candidate-point positions per env: components over the model's
        # whole cpoint array (plane rows take [0..nc), pair rows their point)
        cpp = blocks(dyn["cpoint_pos"], s.ncp_model, 3) if "cpoint_pos" in dyn else None

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
        if "gravity" in dyn:
            x_in = zeta[:3] + [zeta[3 + k] - dyn["gravity"][k:k + 1] for k in range(3)]
        else:
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
        setpoint = c["setpoint"] if q_target is None else c["sel_q"] @ q_target
        kstiff = dyn.get("dof_stiffness", c["kstiff"])
        tau_p = -kstiff * (q_scalar - setpoint)
        over = torch.clamp(q_scalar - dyn.get("dof_limit_upper", c["hi"]), min=0.0)
        under = torch.clamp(dyn.get("dof_limit_lower", c["lo"]) - q_scalar, min=0.0)
        violating = ((over > 0) | (under > 0)).to(q.dtype)
        limited = c["limited"]
        tau_p = tau_p + limited * (-p.limit_stiffness * (over - under))
        D = dyn.get("dof_damping", c["kdamp"]) + limited * violating * p.limit_damping
        if has_fric:
            D = D + dyn.get("dof_friction", c["kfric"]) / (torch.abs(qd) + 2e-3)
        K = kstiff + limited * violating * p.limit_stiffness
        if s.nt:
            # fixed tendons: a spring outside the range and a damper on the
            # tendon's length, a linear combination of the scalar dofs
            t_val = c["t_coef"] @ q_scalar
            t_vel = c["t_coef"] @ qd
            viol = torch.clamp(t_val - c["t_hi"], min=0.0) + torch.clamp(t_val - c["t_lo"], max=0.0)
            f_t = (-dyn.get("tendon_stiffness", c["t_stiff"]) * viol
                   - dyn.get("tendon_damping", c["t_damp"]) * t_vel)
            tau_p = tau_p + c["t_coef"].T @ f_t

        # Mh = M + diag(armature + hD + h^2 K); Gauss-Jordan without pivoting
        diag_add = dyn.get("armature", c["armature"]) + h * D + h * h * K
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
        if nct == 0:
            qd_new = torch.clamp(qd_free, -p.max_dof_velocity, p.max_dof_velocity)
            return integrate(q, qd_new), qd_new, warm, zs, zs, q.new_zeros(s.nv, N)

        def point_jac_world(xw, Pm):
            """World-component point-Jacobian rows, 3 x (nv, k, N), masked
            (for pair rows signed) by the dof path Pm."""
            out = []
            for k in range(3):
                a, b = (k + 1) % 3, (k + 2) % 3
                crossk = S[a][:, None, :] * xw[b][None] - S[b][:, None, :] * xw[a][None]
                out.append((S[3 + k][:, None, :] + crossk) * Pm)
            return out

        Jt1, Jt2, Jn, phis = [], [], [], []

        def add_rows(rows3, phi_block):
            for blocks, rows in zip((Jt1, Jt2, Jn), rows3):
                blocks.append(rows)
            phis.append(phi_block)

        if nc:
            # plane rows: candidate points vs the ground (frame = world axes)
            bQ = [c["cp_pick"] @ Qb[k] for k in range(4)]
            bX = [c["cp_pick"] @ Xb[k] for k in range(3)]
            rot = _qrot(bQ, [cpp[k][:nc] for k in range(3)] if cpp is not None else c["cp_pos"])
            xc = [bX[k] + rot[k] for k in range(3)]
            Jp = point_jac_world(xc, c["Pm"])
            if terr is None:
                add_rows(Jp, c["cp_radius"] - xc[2])
            else:
                # heightfield: each point's own plane (height th, frame [t1, t2, n]);
                # phi = radius - (x_z - h) n_z, rows rotated into the frame
                th, tn, tt1, tt2 = terr[:nc], blocks(terr[nc:4 * nc], nc, 3), \
                    blocks(terr[4 * nc:7 * nc], nc, 3), blocks(terr[7 * nc:], nc, 3)
                add_rows([sum(f[k][None] * Jp[k] for k in range(3)) for f in (tt1, tt2, tn)],
                         c["cp_radius"] - (xc[2] - th) * tn[2])
        if npp:
            # pair rows: a candidate point of body A against a geom of body B
            aX = [Xb[k][pp_a] for k in range(3)]
            ppt = [cpp[k][pp_pt] for k in range(3)] if cpp is not None else c["pp_pos"]
            xw = [aX[k] + r for k, r in enumerate(_qrot([Qb[k][pp_a] for k in range(4)], ppt))]
            bQg = [Qb[k][pp_b] for k in range(4)]
            bXg = [Xb[k][pp_b] for k in range(3)]
            Xg = [bXg[k] + o for k, o in enumerate(_qrot(bQg, c["pp_gpos"]))]
            Qg = _qmul(bQg, c["pp_gquat"])
            Qg_c = [-Qg[0], -Qg[1], -Qg[2], Qg[3]]
            dvec = _qrot(Qg_c, [xw[k] - Xg[k] for k in range(3)])
            half = c["pp_half"]
            if "geom_size" in dyn:
                half = [g[pp_geom] for g in blocks(dyn["geom_size"], s.ngeom, 3)]
            phi_pp, n_l, surf = pair_narrowphase(dvec, half, c["pp_radius"])
            n_w = _qrot(Qg, n_l)  # world normal, geom -> point
            xs_w = [Xg[k] + o for k, o in enumerate(_qrot(Qg, surf))]
            # branchless tangent basis
            use_z = (torch.abs(n_w[2]) < 0.9).to(q.dtype)
            t1r = _cross([1.0 - use_z, torch.zeros_like(use_z), use_z], n_w)
            t1n = 1.0 / torch.clamp(torch.sqrt(t1r[0] ** 2 + t1r[1] ** 2 + t1r[2] ** 2), min=1e-9)
            t1 = [t1r[k] * t1n for k in range(3)]
            t2 = _cross(n_w, t1)
            Jpp = point_jac_world(xs_w, c["Pm_pp"])  # at the surface point, signed A - B
            add_rows([sum(f[k][None] * Jpp[k] for k in range(3)) for f in (t1, t2, n_w)], phi_pp)
        if nsp:
            # SDF rows: a candidate point of body A against the grid of body B,
            # through the row's entry plane (depth phi0 at x0, frame [t1, t2, n]):
            # phi = phi0 - n . (x - x0), Jacobian at the point, signed A - B
            sX = [Xb[k][sp_a] for k in range(3)]
            spt = [cpp[k][sp_pt] for k in range(3)] if cpp is not None else c["sp_pos"]
            xs_sp = [sX[k] + r for k, r in enumerate(_qrot([Qb[k][sp_a] for k in range(4)], spt))]
            sp_phi0, sp_x0, sp_n, sp_t1, sp_t2 = (sdf[:nsp],) + tuple(
                blocks(sdf[(1 + 3 * i) * nsp:(4 + 3 * i) * nsp], nsp, 3) for i in range(4))
            phi_sp = sp_phi0 - sum(sp_n[k] * (xs_sp[k] - sp_x0[k]) for k in range(3))
            Jsp = point_jac_world(xs_sp, c["Pm_sp"])
            add_rows([sum(f[k][None] * Jsp[k] for k in range(3)) for f in (sp_t1, sp_t2, sp_n)], phi_sp)
        if natt:
            # bilateral anchors: three world-axis rows per anchor, always on
            aXat = [Xb[k][att_b] for k in range(3)]
            rot_a = _qrot([Qb[k][att_b] for k in range(4)], c["att_offset"])
            xa = [aXat[k] + rot_a[k] for k in range(3)]
            err_att = [c["att_target"][k] - xa[k] for k in range(3)]
            add_rows(point_jac_world(xa, c["Pm_att"]), q.new_zeros(natt, N))

        phi = torch.cat(phis, 0)  # (nct, N): plane, pair, anchor
        active = (phi > -p.contact_margin).to(q.dtype)
        J = torch.cat([torch.cat(Jt1, 1), torch.cat(Jt2, 1), torch.cat(Jn, 1)], dim=1)  # (nv, 3nct, N), comp-major
        # velocity targets: Baumgarte / approach on unilateral normal rows
        vn_t = torch.where(
            phi > 0,
            torch.clamp(erp * phi / h, max=p.max_depenetration_velocity),
            phi / h,
        )
        # friction and restitution per row: plane rows are the model's
        # candidate points in order, a pair row picks its point (its friction
        # averaged with the geom's static one), an SDF row picks its point,
        # anchors have neither
        za = q.new_zeros(natt, N)
        mu = c["mu"]
        if "cpoint_friction" in dyn:
            cpf = dyn["cpoint_friction"]
            mu = torch.cat([cpf[:nc], 0.5 * (cpf[pp_pt] + geom_fric), cpf[sp_pt], za], 0)
        if has_rest:
            rest = c["rest"]
            if "cpoint_restitution" in dyn:
                cr = dyn["cpoint_restitution"]
                rest = torch.cat([cr[:nc], cr[pp_pt], cr[sp_pt], za], 0)
            vn_pre = torch.sum(J[:, 2 * nct:] * qd_free[:, None], dim=0)
            bounce = (
                (rest > 0.0)
                & (phi > -p.contact_margin)
                & (vn_pre < -p.bounce_threshold_velocity)
            )
            vn_t = torch.where(bounce, torch.maximum(vn_t, -rest * vn_pre), vn_t)
        # velocity-target adjustments of each row, subtracted from J qd_free:
        # the unilateral normal rows' target, the anchors' error drive
        if natt:
            ke = erp_att / h
            zu = q.new_zeros(nuni, N)
            adj = [torch.cat([zu, err_att[0] * ke], 0), torch.cat([zu, err_att[1] * ke], 0),
                   torch.cat([vn_t[:nuni], err_att[2] * ke], 0)]
        else:
            adj = [None, None, vn_t]
        bil = c["bil"]
        warm = q.new_zeros(3 * nct, N) if warm is None else warm
        nce = nct
        key = None
        if cap:
            # top-K active set: only the cap most-penetrating candidates by
            # predicted depth phi - min(v_n, 0) h enter the solve, ties to the
            # lower index (lax.top_k's order); anchors always, inactive rows
            # fill what is left by index. Slot k holds the row of rank k.
            vn_free = torch.sum(J[:, 2 * nct:] * qd_free[:, None], dim=0)
            key = phi - torch.clamp(vn_free, max=0.0) * h
            key = torch.where(bil, 1e30, key)
            key = torch.where((active > 0) | bil, key, -1e30)
            ii = torch.arange(nct, device=q.device)
            beats = (key[None] > key[:, None]) | ((key[None] == key[:, None]) & (ii[None, :, None] < ii[:, None, None]))
            rank = torch.sum(beats, dim=1)  # (nct, N), a permutation of 0..nct-1 per env
            sel = torch.argsort(rank, dim=0)[:cap]  # (cap, N)
            gat = lambda x: torch.gather(x.expand(nct, N), 0, sel)
            J = torch.cat([torch.gather(J[:, k * nct:(k + 1) * nct], 1, sel[None].expand(s.nv, cap, N))
                           for k in range(3)], 1)
            active, mu, bil = gat(active), gat(mu), gat(bil)
            adj = [None if a is None else gat(a) for a in adj]
            warm = torch.cat([gat(warm[k * nct:(k + 1) * nct]) for k in range(3)], 0)
            nce = cap
        if keys is not None:
            keys.append((phi, key))
        if delassus is not None:
            delassus.append((J, Minv))

        # Delassus A = J^T Minv J over the rows in the solve
        W = sum(Minv[:, j:j + 1, :] * J[j][None] for j in range(s.nv))
        A = sum(J[v][:, None, :] * W[v][None] for v in range(s.nv))
        b_vec = torch.sum(J * qd_free[:, None], dim=0)
        b_vec = torch.cat([b_vec[k * nce:(k + 1) * nce] - (0.0 if a is None else a) for k, a in enumerate(adj)], 0)

        # per-contact Jacobi scaling by the mean block diagonal
        diagA = torch.sum(J * W, dim=0)
        d_c = (diagA[:nce] + diagA[nce:2 * nce] + diagA[2 * nce:]) / 3.0 + 1e-6
        s_c = torch.rsqrt(torch.clamp(d_c, min=1e-12))
        s3 = torch.cat([s_c, s_c, s_c], 0)
        s3sq = s3 * s3
        A = A * s3[:, None] * s3[None]
        b_vec = b_vec * s3
        # Lipschitz bound incl. the scaled 1e-6 regularization of the matvec
        Lip = torch.amax(torch.sum(torch.abs(A), dim=1) + 1e-6 * s3sq, dim=0, keepdim=True)
        step = 1.0 / torch.clamp(Lip, min=1e-8)

        def project(y):
            lnc = y[2 * nce:]
            ln = torch.where(bil, lnc, torch.clamp(lnc, min=0.0))  # bilateral rows: unprojected
            t1_, t2_ = y[:nce], y[nce:2 * nce]
            tn = torch.sqrt(t1_ * t1_ + t2_ * t2_ + 1e-12)
            sc = torch.where(bil, torch.ones_like(ln), torch.clamp(mu * ln / tn, max=1.0)) * active
            return torch.cat([t1_ * sc, t2_ * sc, ln * active], 0)

        lam = project(warm / s3)
        y = lam
        for beta in betas:
            g_vec = torch.sum(A * y[None], dim=1) + 1e-6 * s3sq * y + b_vec
            lam_new = project(y - step * g_vec)
            y = lam_new + beta * (lam_new - lam)
            lam = lam_new
        lam = lam * s3  # back to physical impulses

        qfrc_con = torch.sum(J * lam[None], dim=1)
        if cap:
            # impulses back to full rows, zero off the set: the warm start and
            # the sensors live in full row space
            lam = torch.cat([q.new_zeros(nct, N).scatter(0, sel, lam[k * cap:(k + 1) * cap]) for k in range(3)], 0)
        dqd = torch.sum(Minv * qfrc_con[None], dim=1)
        qd_new = torch.clamp(qd_free + dqd, -p.max_dof_velocity, p.max_dof_velocity)
        q_new = integrate(q, qd_new)

        # sensors: per-body contact force/torque (world, about the body's
        # origin), dof force
        inv_h = 1.0 / h
        lt1, lt2, ln_ = lam[:nct] * inv_h, lam[nct:2 * nct] * inv_h, lam[2 * nct:] * inv_h
        bf = [q.new_zeros(s.nbody, N) for _ in range(3)]
        bt = [q.new_zeros(s.nbody, N) for _ in range(3)]
        if nc:
            Fp = [lt1[:nc], lt2[:nc], ln_[:nc]]
            tq = _cross([xc[k] - bX[k] for k in range(3)], Fp)
            boc = c["boc"]
            bf = [bf[k] + boc @ Fp[k] for k in range(3)]
            bt = [bt[k] + boc @ tq[k] for k in range(3)]
        if npp:
            r1, r2, rn = lt1[nc:nc + npp], lt2[nc:nc + npp], ln_[nc:nc + npp]
            Fw = [t1[k] * r1 + t2[k] * r2 + n_w[k] * rn for k in range(3)]
            tq_a = _cross([xs_w[k] - aX[k] for k in range(3)], Fw)
            tq_b = _cross([xs_w[k] - bXg[k] for k in range(3)], Fw)
            # +F on the point's body, -F on the geom's
            bf = [bf[k].index_add(0, pp_a, Fw[k]).index_add(0, pp_b, -Fw[k]) for k in range(3)]
            bt = [bt[k].index_add(0, pp_a, tq_a[k]).index_add(0, pp_b, -tq_b[k]) for k in range(3)]
        if nsp:
            s0 = nc + npp
            r1, r2, rn = lt1[s0:nuni], lt2[s0:nuni], ln_[s0:nuni]
            Fs = [sp_t1[k] * r1 + sp_t2[k] * r2 + sp_n[k] * rn for k in range(3)]
            # torque arms about each body's origin, at the candidate point
            tq_a = _cross([xs_sp[k] - sX[k] for k in range(3)], Fs)
            tq_b = _cross([xs_sp[k] - Xb[k][sp_b] for k in range(3)], Fs)
            bf = [bf[k].index_add(0, sp_a, Fs[k]).index_add(0, sp_b, -Fs[k]) for k in range(3)]
            bt = [bt[k].index_add(0, sp_a, tq_a[k]).index_add(0, sp_b, -tq_b[k]) for k in range(3)]
        if natt:
            Fa = [lt1[nuni:], lt2[nuni:], ln_[nuni:]]
            tq_at = _cross([xa[k] - aXat[k] for k in range(3)], Fa)
            bf = [bf[k].index_add(0, att_b, Fa[k]) for k in range(3)]
            bt = [bt[k].index_add(0, att_b, tq_at[k]) for k in range(3)]
        return q_new, qd_new, lam, torch.cat(bf, 0), torch.cat(bt, 0), qfrc_con * inv_h

    return substep


def _step_math_torch(s: _Spec, p: SimParams, device, names: tuple = (), keys=None, dtype=torch.float32,
                     delassus=None):
    """Plain PyTorch version of the whole step on (rows, N) tensors.

    Returns run(q, qd, qfrc, xfrc, q_target=None, dyn=None, terr=None,
    warm_reset_every=0, sdf=None) -> (q, qd, body_force, body_torque,
    dof_force), all (rows, N); xfrc is (6*nbody, N) comp-major or None,
    q_target (nq, N) PD-drive setpoints or None (then qpos0), dyn the packed
    (rows, N) per-env leaves of `names` (see `pack_dyn`) or None when `names`
    is empty, terr the (10 nc, N) terrain planes (`pack_terrain`) or None
    for flat ground, sdf the (13 nsp, N) SDF planes (`pack_sdf`) of a model
    with SDF pair rows; with `warm_reset_every` = k the contact warm start
    resets every k slices (a merged decimation window solves like separate
    calls).
    `keys`, `dtype`, `delassus`: see `_substep_fn`.
    """
    n_slices = p.substeps * p.solver_iterations
    substep = _substep_fn(s, p, p.dt / n_slices, device, names, keys, dtype, delassus)
    rows = dyn_rows(s)
    offsets = np.concatenate([[0], np.cumsum([rows[k] for k in names])]).astype(int)

    def run(q, qd, qfrc, xfrc, q_target=None, dyn=None, terr=None, warm_reset_every=0, sdf=None):
        if (dyn is not None) != bool(names) or (names and dyn.shape[0] != offsets[-1]):
            raise ValueError(f"this step was prepared for the per-env leaves {names}")
        if terr is not None and (not s.nc or terr.shape[0] != 10 * s.nc):
            raise ValueError(f"terrain planes need {10 * s.nc} rows (10 per plane candidate), got {terr.shape[0]}")
        if (sdf is None) != (not s.sp_n) or (sdf is not None and sdf.shape[0] != 13 * s.sp_n):
            raise ValueError(f"a model with {s.sp_n} SDF pair rows takes {13 * s.sp_n} rows of SDF planes")
        leaves = {k: dyn[offsets[i]:offsets[i + 1]] for i, k in enumerate(names)}
        warm = None  # zeros at each call, carried across its slices
        for i in range(n_slices):
            if warm_reset_every and i and i % warm_reset_every == 0:
                # a merged window resets the warm start where a separate call would begin
                warm = None
            q, qd, warm, bf, bt, doff = substep(q, qd, qfrc, xfrc, q_target, warm, leaves, terr, sdf)
        return q, qd, bf, bt, doff

    return run


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

# (model, params, device, has q_target, per-env leaf names, has terrain) ->
# prepared step; the model and params objects are held so that their ids
# stay unique while the entry lives. On the card a call with q_target, with
# another set of per-env leaves, or with terrain planes, is another kernel
# instantiation.
_CACHE: dict = {}


def spec_of(model: Model) -> _Spec:
    """The extracted spec of `model`, cached with its prepared steps."""
    key = (id(model), "spec")
    hit = _CACHE.get(key)
    if hit is None or hit[0] is not model:
        hit = (model, _extract(model))
        _CACHE[key] = hit
    return hit[1]


def _prepared(model: Model, params: SimParams, device: torch.device, has_qt: bool = False,
              names: tuple = (), has_terr: bool = False):
    key = (id(model), id(params), str(device), bool(has_qt), names, bool(has_terr))
    hit = _CACHE.get(key)
    if hit is None or hit[0] is not model or hit[1] is not params:
        s = spec_of(model)
        if device.type == "cuda":
            from . import _cuda

            step = _cuda.FusedStepCall(
                s, params, apgd_betas(params.solver_apgd_iterations), device, has_qt=has_qt, names=names,
                has_terr=has_terr,
            )
        else:
            step = _step_math_torch(s, params, device, names)
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
    q_target: torch.Tensor | None = None,  # (N, nq) PD-drive setpoints
    dyn: dict | PackedDyn | None = None,
    warm_reset_every: int = 0,
    terrain: torch.Tensor | None = None,  # (10 nc, N) planes of `pack_terrain`
    sdf: torch.Tensor | None = None,  # (13 nsp, N) planes of `pack_sdf`
) -> FusedOut:
    """Batched full physics step through the fused kernel.

    Env-leading inputs and outputs; internally (rows, N). A CUDA tensor
    launches the CUDA kernel; a CPU tensor runs the plain version. `dyn`
    carries per-env model leaves: {name: (N, *leaf.shape)} over `DYN_LEAVES`
    and "gravity" (N, 3), or the same already packed by `pack_dyn` (a
    caller that steps many times with one sample packs it once). Terrain
    planes come as `terrain` (packed) or as the `TERRAIN_KEYS` of a `dyn`
    dict, the way `terrain_dyn` returns them; a model with SDF pair rows
    needs its SDF planes likewise, as `sdf` or as the `SP_KEYS` of a `dyn`
    dict (`sdf_dyn`). `warm_reset_every` = k resets the contact warm start
    every k slices: a call that merges the k-slice steps of a decimation
    window solves like those separate calls.
    """
    beyond = unsupported_features(model, params)
    if beyond:
        raise NotImplementedError("beyond the ported kernel tiers: " + ", ".join(beyond))
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    N = q.shape[0]
    if isinstance(dyn, dict):
        if any(k in dyn for k in TERRAIN_KEYS):
            if terrain is not None:
                raise ValueError("terrain planes given twice: as `terrain` and in `dyn`")
            terrain = pack_terrain(dyn)
        if any(k in dyn for k in SP_KEYS) and len(model.spair_point):
            if sdf is not None:
                raise ValueError("SDF planes given twice: as `sdf` and in `dyn`")
            sdf = pack_sdf(dyn)
        dyn = pack_dyn(spec_of(model), dyn)
    if (sdf is None) != (not len(model.spair_point)):
        raise ValueError("a model with SDF pair rows takes their entry-sampled planes "
                         "(fused.sdf_dyn(model, q, qd)) as `sdf` or in `dyn`, and only such a model")
    names, dyn_in = (dyn.names, dyn.rows) if dyn is not None else ((), None)
    s, step = _prepared(model, params, q.device, q_target is not None, names, terrain is not None)
    f32 = lambda a: a.to(torch.float32).T.contiguous()
    xf = None
    if xfrc is not None:
        # (N, nbody, 6) -> comp-major rows (6*nbody, N)
        xf = xfrc.to(torch.float32).permute(2, 1, 0).reshape(6 * s.nbody, N).contiguous()
    qt = None if q_target is None else f32(q_target)
    q2, qd2, bf, bt, doff = step(f32(q), f32(qd), f32(qfrc), xf, qt, dyn_in, terrain, int(warm_reset_every), sdf)
    return FusedOut(
        q=q2.T,
        qd=qd2.T,
        body_force=bf.reshape(3, s.nbody, N).permute(2, 1, 0),
        body_torque=bt.reshape(3, s.nbody, N).permute(2, 1, 0),
        dof_force=doff.T,
    )
