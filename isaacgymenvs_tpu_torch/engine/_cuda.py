"""Build, bind and launch the hand-written fused-step kernel.

`csrc/fused_step.cu` is compiled with `nvcc` for `sm_90a` into a shared
library with a plain C interface, one library per model size tuple
(nbody, nq, nv, plane rows, pair rows, anchors, q_target input or not,
tendons, the set of per-env leaves as a bitmask, the model's candidate
point and geom counts where a per-env leaf indexes them, the top-K cap,
terrain planes or not, SDF pair rows, and envs per block), at first use,
into `isaacgymenvs_tpu_torch/_build/` (listed in .gitignore). A block keeps
the spec and each of its envs in shared memory; envs per block is the
largest of 4, 2 and 1 whose bytes (`smem_bytes`) fit the device's opt-in
limit for one block (`envs_per_block`), and a model that does not fit at one
is refused by name (`fused.unsupported_features`) before any launch.
Without any row it is the contact-free instantiation (`-DFS_NC=0`): the
same source with every contact stage compiled out. The library name carries
a hash of the source and the flags, so an edited source is rebuilt. It is
loaded with ctypes; pointers and the stream go in as `c_void_p`.

Nothing here runs at import: the CPU tests import this module without a
compiler or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from .dynamics import SimParams

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "fused_step.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# envs per block, tried in this order: the first whose shared memory fits
ENVS_PER_BLOCK_CHOICES = (4, 2, 1)
# shared memory one block may opt in to on the H100 (cudaDevAttrMaxSharedMemoryPerBlockOptin)
SMEM_OPTIN_BYTES = 232448
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}

# layout of the parameter head of the spec buffer (fused_step.cu P_*)
_NPARAM = 16


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the fused-step kernel is built with the CUDA toolkit")
    return path


def sizes_of(s, has_qt: bool = False, names: tuple = (), cap: int = 0, has_terr: bool = False,
             epb: int = 4) -> tuple:
    """The size tuple of a model's kernel instantiation: (nbody, nq, nv,
    plane rows, pair rows, anchors, 1 with a q_target input, tendons, the
    per-env leaves `names` as a bitmask (`fused.dyn_mask`), the model's
    candidate-point and geom counts, 0 unless a per-env leaf of `names` is
    laid out over them, the top-K cap (`fused.topk_cap`, 0 without), 1 with
    terrain planes, SDF pair rows, and envs per block)."""
    from .fused import dyn_mask

    ncp = s.ncp_model if any(k.startswith("cpoint_") for k in names) else 0
    ngeom = s.ngeom if "geom_size" in names else 0
    return (s.nbody, s.nq, s.nv, s.nc, s.pp_nc, s.att_n, int(bool(has_qt)), s.nt,
            dyn_mask(names), ncp, ngeom, int(cap), int(bool(has_terr)), s.sp_n, int(epb))


def _defines(sizes) -> list:
    nb, nq, nv, nc, npp, natt, qt, nt, dyn, ncp, ngeom, cap, terr, nsp, epb = sizes
    return [f"-DFS_NB={nb}", f"-DFS_NQ={nq}", f"-DFS_NV={nv}", f"-DFS_NC={nc}",
            f"-DFS_NPP={npp}", f"-DFS_NSP={nsp}", f"-DFS_NATT={natt}", f"-DFS_QT={qt}",
            f"-DFS_NT={nt}", f"-DFS_DYN={dyn}", f"-DFS_NCP={ncp}", f"-DFS_NG={ngeom}",
            f"-DFS_CAP={cap}", f"-DFS_TERR={terr}", f"-DFS_EPB={epb}"]


def env_floats(s, has_qt: bool = False, names: tuple = (), cap: int = 0, has_terr: bool = False) -> int:
    """Floats of one env's block of shared memory in the kernel's layout (the
    E_* constants of fused_step.cu, rounded up to a multiple of 4): the
    state, the articulated-body work, M^-1, J and W = M^-1 J over all R = 3
    x contacts rows, the sensors, the per-env leaves, the terrain and SDF
    planes and the top-K keys."""
    from .fused import dyn_rows

    nb, nq, nv, nct, npp, nsp = s.nbody, s.nq, s.nv, s.nct, s.pp_nc, s.sp_n
    n = (nq * (2 if has_qt else 1) + 73 * nb + 26 * nv + 2 * nv * nv + 7 * nct + 2 * nv * 3 * nct
         + 3 * (npp + nsp) + 9 * npp + sum(dyn_rows(s)[k] for k in names)
         + (10 * s.nc if has_terr else 0) + 13 * nsp + (2 * nct if cap else 0))
    return (n + 3) // 4 * 4


def smem_bytes(s, p: SimParams, epb: int, has_qt: bool = False, names: tuple = (),
               has_terr: bool = False) -> int:
    """Dynamic shared memory one block of `epb` envs asks for: the spec
    buffer (`pack_spec`), padded to a multiple of 4 floats, and the envs'
    blocks."""
    from .fused import apgd_betas, topk_cap

    spec = pack_spec(s, p, apgd_betas(p.solver_apgd_iterations)).size
    return 4 * ((spec + 3) // 4 * 4 + epb * env_floats(s, has_qt, names, topk_cap(s, p), has_terr))


def envs_per_block(smem_of, limit: int) -> int:
    """The largest of ENVS_PER_BLOCK_CHOICES whose block fits `limit` bytes,
    `smem_of(epb)` being a block's bytes at epb envs; 0 when none fits."""
    return next((e for e in ENVS_PER_BLOCK_CHOICES if smem_of(e) <= limit), 0)


def device_smem_optin(device: torch.device) -> int:
    """Shared memory one block may opt in to on `device`
    (cudaDevAttrMaxSharedMemoryPerBlockOptin), asked of the CUDA runtime of
    the toolkit that builds the kernel."""
    lib_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.realpath(nvcc()))), "lib64")
    names = sorted(f for f in os.listdir(lib_dir) if f.startswith("libcudart.so")) if os.path.isdir(lib_dir) else []
    if not names:
        raise RuntimeError(f"no libcudart.so under {lib_dir}: the device's shared-memory limit cannot be read")
    rt = ctypes.CDLL(os.path.join(lib_dir, names[0]))
    value = ctypes.c_int(0)
    rc = rt.cudaDeviceGetAttribute(ctypes.byref(value), 97, int(device.index or 0))
    if rc != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute(MaxSharedMemoryPerBlockOptin) failed: CUDA error {rc}")
    return int(value.value)


def library_path(sizes) -> str:
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(_ARCH + _FLAGS + _defines(sizes)).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, "libfused_step_{}_{}.so".format("_".join(map(str, sizes)), tag))


def build(sizes, verbose: bool = False) -> str:
    """Compile the kernel for `sizes` (see `sizes_of`) unless built; with
    `verbose`, print ptxas's register, spill and stack figures."""
    out = library_path(sizes)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *_ARCH, *_FLAGS, *_defines(sizes)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(f"ptxas {'_'.join(map(str, sizes))}:\n{res.stderr.strip()}")
    os.replace(tmp, out)
    return out


def load(sizes):
    """The ctypes library for `sizes`, built on first use."""
    with _lock:
        lib = _libs.get(tuple(sizes))
        if lib is None:
            lib = ctypes.CDLL(build(sizes))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.fused_step_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.fused_step_layout.restype = ci
            lib.fused_step_launch.argtypes = [vp] * 14 + [ci] * 5 + [vp]
            lib.fused_step_launch.restype = ci
            _libs[tuple(sizes)] = lib
    return lib


def layout(lib) -> tuple:
    """The compiled-in size tuple (see `sizes_of`) followed by spec_base,
    env_floats and the rows of the packed per-env input."""
    out = (ctypes.c_int * 18)()
    lib.fused_step_layout(out)
    return tuple(out)


def body_depth(parent) -> np.ndarray:
    depth = np.zeros(len(parent), np.int64)
    for i, p in enumerate(parent):
        depth[i] = 0 if p < 0 else depth[p] + 1
    return depth


def pack_spec(s, p: SimParams, betas) -> np.ndarray:
    """The model, topology and solver constants in the kernel's layout.

    Order and offsets mirror the O_* / P_* constants of fused_step.cu;
    integers are stored as floats (all are small).
    """
    n_slices = p.substeps * p.solver_iterations
    h = p.dt / n_slices
    depth = body_depth(s.parent)
    head = np.zeros(_NPARAM, np.float64)
    head[0:3] = np.asarray(p.gravity, np.float64)
    head[3:15] = [h, h * h, 1.0 / h, p.baumgarte_erp, p.max_depenetration_velocity,
                  p.contact_margin, p.bounce_threshold_velocity, p.limit_stiffness,
                  p.limit_damping, p.max_dof_velocity, int(depth.max()) + 1,
                  p.baumgarte_erp_attractor]
    cat = lambda *a: np.concatenate([np.asarray(x, np.float64) for x in a], 0)
    zeros = np.zeros(s.att_n)
    zsp = np.zeros(s.sp_n)  # an SDF row's radius is in its entry depth phi0
    tendons = ([s.tendon_coef, s.tendon_range, s.tendon_stiffness, s.tendon_damping] if s.nt
               else [np.zeros(0)] * 4)
    setpoint = np.where(s.sq_adr >= 0, s.qpos0[np.maximum(s.sq_adr, 0)], 0.0)
    parts = [
        head, s.parent, s.jnt_type, s.q_adr, s.v_adr, depth,
        s.body_pos, s.body_quat, s.body_ipos, s.body_inertia, s.body_mass,
        s.jnt_axis, s.jnt_pos,
        s.dof_body, s.sq_adr, s.armature, s.dof_damping, s.dof_friction,
        s.dof_stiffness, s.dof_limit_lower, s.dof_limit_upper, s.dof_limited, setpoint,
        s.dof_mask, s.anc,
        # per contact, in row order: plane, pair, SDF, anchor
        cat(s.cp_body, s.pp_a, s.sp_a, s.att_body), cat(s.cp_pos, s.pp_pos, s.sp_pos, s.att_offset),
        cat(s.cp_radius, s.pp_radius, zsp, zeros), cat(s.cp_mu, s.pp_mu, s.sp_mu, zeros), cat(s.rest, zeros),
        cat(s.path_mask, s.pp_path.T, s.sp_path.T, s.att_path.T),
        # per pair row: the geom, and where per-env leaves find the row's
        # point and geom in the model's arrays; per SDF row: the grid's body
        # and the row's point; the tendons; per anchor: the target
        s.pp_b, s.pp_gtype, s.pp_gpos, s.pp_gquat, s.pp_gsize,
        s.pp_pt, s.pp_geom, s.pp_geom_fric, s.sp_b, s.sp_pt, *tendons, s.att_target,
        np.asarray(betas, np.float64),
    ]
    return np.concatenate([np.asarray(a, np.float64).reshape(-1) for a in parts]).astype(np.float32)


# floating-point operations of the small helpers in fused_step.cu
# (transcendentals, divides and square roots count 1)
_CROSS, _QMUL, _QROT, _QNORM, _QEXP = 9, 28, 30, 14, 14


def kernel_flops(s, p: SimParams, has_terr: bool = False) -> int:
    """Floating-point operations one env-step needs, counted from the
    step's algorithm at what the function requires (multiply-add = 2).

    Symmetric matrices count their upper triangle: the mass matrix, and the
    scaled Delassus matrix whose |entries| the Lipschitz row sums add up
    (R(R+1)/2 dot products of length nv, each |entry| added to its row and,
    off the diagonal, to its column's row). The inverse is Gauss-Jordan in
    place, 2 nv^3. J is counted dense (its zeros depend on the tree, not on
    the data). Per-body terms follow the joint type of each body. Pair rows
    and anchors are contacts of the same solve (three rows each): a pair row
    adds its narrowphase (by geom type), its frame and the rotation of its
    Jacobian and force, an anchor its point and error drive. A tendon adds
    its length and rate (two dot products over the dofs), its force, and that
    force times its coefficients. Per-env leaves change where a constant is
    read, not the count. A terrain plane row adds its depth along the
    plane's normal and the rotation of its Jacobian into the plane's frame.
    An SDF row adds its point in the world, its depth against its entry
    plane, its world Jacobian and that Jacobian's rotation into the plane's
    frame; its sensor turns its force to world axes and takes a second arm
    for the grid's body.
    With a top-K cap every row is formed with its J qd_free, each contact's
    key is compared with every other one, and only the cap contacts in the
    solve take W = M^-1 J, their scale, the Lipschitz sums, the APGD and the
    impulse. Without any
    contact the step ends after qd_free with the velocity clip and the
    integration: no rows, solve, impulse or sensors.
    """
    from .fused import topk_cap

    nb, nv, nc, npp, nsp, natt = s.nbody, s.nv, s.nc, s.pp_nc, s.sp_n, s.att_n
    nct = nc + npp + nsp + natt
    cap = topk_cap(s, p)
    nce = cap or nct  # contacts in the solve
    r, rs = 3 * nct, 3 * nce
    it = p.solver_apgd_iterations
    jt = np.asarray(s.jnt_type)
    n_free, n_hinge = int(np.sum(jt == 0)), int(np.sum((jt == 1) | (jt == 2)))
    subtree = np.asarray(s.anc).sum(0)  # bodies in the subtree of each body
    # FK + zeta per body: parent transform, joint transform, motion subspace
    fk = (n_free * (_QROT + 3 + _QMUL + _QNORM + _CROSS + 3 + 3 * 2 * _CROSS + 6 * 12)
          + n_hinge * (_QROT + 3 + _QMUL + _QROT + 3 + 3 + _QMUL + _QROT + 3 + _QROT + 3
                       + 5 * _CROSS + 6 + 24))
    inertia_net = nb * (36 + 18 + 45 + 45 + 5 + 42 + 3 + 144 + 3 * _CROSS + 9 + 6)
    composite = 36 * int(np.sum(np.asarray(s.parent) >= 0))
    crba = nv * 6 * 12 + (nv * (nv + 1) // 2) * 13
    per_dof = int(np.sum(6 * subtree[np.asarray(s.dof_body)])) + nv * 42 + s.nt * (6 * nv + 6)
    inverse = 2 * nv ** 3 + nv * nv + nv
    qd_free = 2 * nv * nv + 2 * nv
    # every row: its Jacobian and J qd_free; the rows in the solve: W and the diagonal
    rows = nc * (_QROT + 4 + 3 * nv * 5 + 3 + 10) + r * 2 * nv + rs * (2 * nv * nv + 2 * nv)
    if has_terr:
        rows += nc * (2 + 3 * nv * 5)
    select = nct * 4 + 2 * nct * nct if cap else 0
    # pair row: point and geom pose in the world, the point in the geom's
    # frame, narrowphase, normal and surface point back to the world, tangent
    # basis, world Jacobian rotated into the frame, velocity target
    gt = np.asarray(s.pp_gtype)
    narrow = int(np.sum(np.where(gt == 2, 30, np.where(gt == 3, 40, 16))))
    rows += npp * (2 * (_QROT + 3) + _QMUL + 3 + _QROT + 2 * _QROT + 3 + 2 * _CROSS + 8
                   + 3 * nv * 5 + 3 * nv * 5 + 13) + narrow
    # SDF row: point, phi0 - n . (x - x0), world Jacobian, its rotation
    rows += nsp * (_QROT + 3 + 9 + 3 * nv * 5 + 3 * nv * 5)
    # anchor: its point, the error drive on three axes, world Jacobian
    rows += natt * (_QROT + 3 + 9 + 3 * nv * 5)
    lipschitz = (rs * (rs + 1) // 2) * (2 * nv + 2) + rs * rs + 4 * rs
    apgd = nce * (3 + 13) + it * (4 * rs * nv + 10 * rs + 15 * nce)
    # with contacts: J^T lambda, M^-1 of it, the add and the clip; without: the clip
    impulse = rs + 2 * rs * nv + 2 * nv * nv + 3 * nv if nct else 2 * nv
    integrate = n_free * (6 + 3 + _QEXP + 2 * _QNORM + _QMUL) + n_hinge * 2
    per_slice = (fk + inertia_net + composite + crba + per_dof + inverse + qd_free + rows + select
                 + lipschitz + apgd + impulse + integrate)
    # per contact force, arm and torque, summed per body; a pair row also
    # turns its force to world axes and takes a second arm for the geom's body
    sensors = nct * (3 + 3 + _CROSS) + 6 * nct + nv + (npp + nsp) * (15 + 3 + _CROSS + 6) if nct else 0
    return int(p.substeps * p.solver_iterations * per_slice + sensors)


def kernel_bytes(s, n_env: int, has_xfrc: bool, has_qt: bool = False, names: tuple = (),
                 has_terr: bool = False) -> int:
    """Boundary traffic of one launch: inputs read once (the per-env leaves
    `names`, the terrain planes and the SDF planes among them), outputs
    written once."""
    from .fused import dyn_rows

    rows_in = s.nq + 2 * s.nv + (6 * s.nbody if has_xfrc else 0) + (s.nq if has_qt else 0)
    rows_in += sum(dyn_rows(s)[k] for k in names) + (10 * s.nc if has_terr else 0) + 13 * s.sp_n
    rows_out = s.nq + s.nv + 6 * s.nbody + s.nv
    return 4 * n_env * (rows_in + rows_out)


def instantiation(s, params: SimParams, device: torch.device, has_qt: bool = False, names: tuple = (),
                  has_terr: bool = False):
    """The kernel instantiation a model takes on `device`: (size tuple with
    the envs per block that fit the device's shared memory, the spec buffer,
    floats per env, dynamic shared-memory bytes per block, the device's
    limit). Raises NotImplementedError, with the byte count, for a model that
    does not fit at one env per block."""
    from .fused import apgd_betas, topk_cap

    limit = device_smem_optin(device)
    smem_of = lambda e: smem_bytes(s, params, e, has_qt, names, has_terr)
    epb = envs_per_block(smem_of, limit)
    if not epb:
        raise NotImplementedError(
            f"shared memory: {smem_of(1)} bytes per block at one env per block, over the "
            f"{limit}-byte limit of one block on {torch.cuda.get_device_name(device)}")
    cap = topk_cap(s, params)
    return (sizes_of(s, has_qt, names, cap, has_terr, epb), pack_spec(s, params, apgd_betas(params.solver_apgd_iterations)),
            env_floats(s, has_qt, names, cap, has_terr), smem_of(epb), limit)


class FusedStepCall:
    """One model's fused step on the card: (rows, N) tensors in and out.

    `FusedStepCall.launches` counts kernel launches across all instances;
    it is incremented where the kernel is launched and nowhere else.
    """

    launches = 0

    def __init__(self, s, params: SimParams, betas, device: torch.device, has_qt: bool = False,
                 names: tuple = (), has_terr: bool = False):
        from .fused import dyn_rows

        if device.type != "cuda":
            raise ValueError(f"FusedStepCall needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        # envs per block from the shared-memory budget of the device
        self.sizes, spec, env_f, self.smem_bytes, self.smem_limit = instantiation(
            s, params, device, has_qt, names, has_terr)
        if not np.array_equal(spec[spec.size - len(betas):], np.asarray(betas, np.float32)):
            raise ValueError("betas disagree with the parameters' APGD iterations")
        self.has_qt = bool(has_qt)
        self.has_terr = bool(has_terr)
        self.names = tuple(names)
        self.dyn_rows = sum(dyn_rows(s)[k] for k in names)
        self.lib = load(self.sizes)
        *built, spec_base, built_env_f, rows = layout(self.lib)
        if tuple(built) != self.sizes or rows != self.dyn_rows or built_env_f != env_f:
            raise RuntimeError(f"kernel built for {tuple(built)} with {rows} per-env rows and {built_env_f} "
                               f"floats per env, model is {self.sizes} with {self.dyn_rows} and {env_f}")
        if spec.size != spec_base + len(betas):
            raise RuntimeError("spec buffer layout disagrees with the kernel")
        self.spec = torch.as_tensor(spec, device=device)
        self.epb = self.sizes[-1]
        self.n_slices = params.substeps * params.solver_iterations
        self.iters = params.solver_apgd_iterations
        self.device = device
        self.s = s

    def __call__(self, q, qd, qfrc, xfrc, q_target=None, dyn=None, terr=None, warm_reset_every=0, sdf=None):
        s, n = self.s, q.shape[-1]
        if (q_target is not None) != self.has_qt:
            raise ValueError("this kernel instantiation was built {} a q_target input".format(
                "with" if self.has_qt else "without"))
        if (dyn is not None) != bool(self.names):
            raise ValueError(f"this kernel instantiation was built for the per-env leaves {self.names}")
        if (terr is not None) != self.has_terr:
            raise ValueError("this kernel instantiation was built {} terrain planes".format(
                "with" if self.has_terr else "without"))
        ins = [(q, s.nq), (qd, s.nv), (qfrc, s.nv)]
        if xfrc is not None:
            ins.append((xfrc, 6 * s.nbody))
        if q_target is not None:
            ins.append((q_target, s.nq))
        if dyn is not None:
            ins.append((dyn, self.dyn_rows))
        if terr is not None:
            ins.append((terr, 10 * s.nc))
        if (sdf is None) != (not s.sp_n):
            raise ValueError(f"a model with {s.sp_n} SDF pair rows takes {13 * s.sp_n} rows of SDF planes")
        if sdf is not None:
            ins.append((sdf, 13 * s.sp_n))
        for t, rows in ins:
            if t.device != self.device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("fused step inputs must be contiguous float32 on the kernel's device")
            if tuple(t.shape) != (rows, n):
                raise ValueError(f"expected shape {(rows, n)}, got {tuple(t.shape)}")
        new = lambda rows: torch.empty((rows, n), dtype=torch.float32, device=self.device)
        q2, qd2 = new(s.nq), new(s.nv)
        bf, bt, df = new(3 * s.nbody), new(3 * s.nbody), new(s.nv)
        ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self.lib.fused_step_launch(
            ptr(q), ptr(qd), ptr(qfrc), ptr(xfrc), ptr(q_target), ptr(dyn), ptr(terr), ptr(sdf),
            ptr(q2), ptr(qd2), ptr(bf), ptr(bt), ptr(df),
            ptr(self.spec), int(self.spec.numel()), int(n), int(self.n_slices),
            int(self.iters), int(warm_reset_every), ctypes.c_void_p(stream),
        )
        if rc != 0:
            raise RuntimeError(f"fused_step kernel launch failed: CUDA error {rc}")
        FusedStepCall.launches += 1
        return q2, qd2, bf, bt, df
