"""The fused-step kernel's shared-memory layout, its choice of envs per
block, and the 3xTF32 arithmetic of its Delassus Gram product, on the CPU.

`_cuda.env_floats` mirrors the E_* constants of `engine/csrc/fused_step.cu`:
here the source's own constexpr chain is evaluated for Anymal, AnymalTerrain
and FactoryTaskInsertion and must give the same count (the wrapper checks it
again against the compiled `ENV_FLOATS` on the card). Envs per block is the
choice that keeps the most envs resident per SM at a given register count.
The kernel forms the Jacobi scale and the Lipschitz bound from W = J M^-1 and
W J^T on the tensor cores with the 3xTF32 split; its torch emulation here
(TF32 rounding by the `cvt.rna` rule on the float bits) agrees with float64
within 1e-6 relative on the plain step's own J and M^-1, where a single TF32
product does not.
"""
import re

import numpy as np
import pytest
import torch

from isaacgymenvs_tpu_torch import maths
from isaacgymenvs_tpu_torch.engine import _cuda, fused
from isaacgymenvs_tpu_torch.engine.dynamics import forward_kinematics
from isaacgymenvs_tpu_torch.tasks import task_map
from isaacgymenvs_tpu_torch.utils.config import load_config

# floats per env, envs per block and resident warps per SM at the planned registers per thread
LAYOUT = {"Anymal": (3608, 4, 12), "AnymalTerrain": (2804, 4, 12), "FactoryTaskInsertion": (3812, 8, 8),
          "Ingenuity": (832, 8, 16)}


@pytest.fixture(scope="module")
def models():
    out = {}
    for task in LAYOUT:
        env = task_map[task](load_config([f"task={task}", "num_envs=2"])["task"], device="cpu")
        s = fused._extract(env.model)
        p = env._merged_params if getattr(env, "merge_slices", False) else env.sim_params
        names = fused.dyn_names(s, env.randomizer.batched_leaf_names()) if env.randomizer is not None else ()
        out[task] = (env, s, p, env.use_pd_targets, names, getattr(env, "terrain", None) is not None)
    return out


def _c_expr(expr: str) -> str:
    """A constexpr of fused_step.cu as a Python expression: `c ? a : b`
    becomes a conditional expression, `/` integer division."""
    expr = expr.strip()
    depth, q = 0, -1
    for i, ch in enumerate(expr):
        depth += (ch == "(") - (ch == ")")
        if ch == "?" and depth == 0:
            q = i
            break
    if q >= 0:
        depth = 0
        for i in range(q + 1, len(expr)):
            ch = expr[i]
            depth += (ch == "(") - (ch == ")")
            if ch == ":" and depth == 0:
                cond, a, b = expr[:q], expr[q + 1:i], expr[i + 1:]
                return f"(({_c_expr(a)}) if ({_c_expr(cond)}) else ({_c_expr(b)}))"
    plain = lambda t: (t.replace("/", "//").replace("true", "True").replace("false", "False")
                       .replace("&&", " and ").replace("||", " or "))
    out, depth, start = [], 0, 0
    for i, ch in enumerate(expr):
        if ch == "(":
            if depth == 0:
                out.append(plain(expr[start:i]))
                start = i + 1
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                out.append("(" + _c_expr(expr[start:i]) + ")")
                start = i + 1
    return "".join(out) + plain(expr[start:])


def _source_layout(sizes, dyn_rows: int) -> dict:
    """Every integer constexpr of fused_step.cu that plain arithmetic gives,
    for the size tuple `sizes` (DYN_ROWS, a constexpr function's value, is
    passed in)."""
    src = open(_cuda.SOURCE).read()
    src = re.sub(r"//[^\n]*", "", src)
    nb, nq, nv, nc, npp, natt, qt, nt, dyn, ncp, ngeom, cap, terr, nsp, epb = sizes
    env = {"FS_NB": nb, "FS_NQ": nq, "FS_NV": nv, "FS_NC": nc, "FS_NPP": npp, "FS_NSP": nsp, "FS_NATT": natt,
           "FS_QT": qt, "FS_NT": nt, "FS_DYN": dyn, "FS_NCP": ncp, "FS_NG": ngeom, "FS_CAP": cap,
           "FS_TERR": terr, "FS_EPB": epb, "DYN_ROWS": dyn_rows}
    for stmt in re.findall(r"constexpr (?:int|bool) ([^;{]+);", src):
        for decl in stmt.split(","):
            name, _, expr = decl.partition("=")
            name = name.strip()
            if not expr or name in env or "(" in name:
                continue
            try:
                env[name] = eval(_c_expr(expr), {}, dict(env))
            except NameError:  # a constexpr function's value (the per-env leaves' offsets)
                pass
    return env


@pytest.mark.parametrize("task", list(LAYOUT))
def test_env_floats_follow_the_kernel_layout(models, task):
    """`_cuda.env_floats` equals ENV_FLOATS of the source's E_* chain: W is
    stored nowhere, J only for the solve's slots (the cap's 20 or 32 under a
    cap, all 44 contacts on flat Anymal), in the region the articulated work
    used before it; the register budget the source's launch bounds hold a
    build to is the one the host plans with: 168 where the tensor cores form
    the Gram product (nv > 8), 128 where each lane does (Ingenuity, nv 6)."""
    env, s, p, has_qt, names, has_terr = models[task]
    cap = fused.topk_cap(s, p)
    smem_of = lambda e: _cuda.smem_bytes(s, p, e, has_qt, names, has_terr)
    epb = _cuda.envs_per_block(smem_of, _cuda.SMEM_OPTIN_BYTES, _cuda.plan_regs(s.nv))
    sizes = _cuda.sizes_of(s, has_qt, names, cap, has_terr, epb)
    lay = _source_layout(sizes, sum(fused.dyn_rows(s)[k] for k in names))
    got = _cuda.env_floats(s, has_qt, names, cap, has_terr)
    assert got == lay["ENV_FLOATS"] == LAYOUT[task][0]
    assert lay["NS"] == (cap or s.nct) and lay["E_J"] + s.nv * 3 * lay["NS"] == lay["E_FS"]
    assert "E_W" not in lay and lay["E_J"] == lay["E_V"] == lay["E_U"]
    assert lay["PLAN_REGS"] == _cuda.plan_regs(s.nv) and lay["GRAM_MMA"] == (s.nv > 8)
    assert lay["MIN_BLOCKS"] == max(1, 65536 // (32 * lay["PLAN_REGS"]) // lay["EPB"])


@pytest.mark.parametrize("task", list(LAYOUT))
def test_envs_per_block_from_bytes_and_registers(models, task):
    """Of 8, 4, 2 and 1 envs per block, the one that keeps the most envs
    resident per SM: at 168 registers per thread Anymal and AnymalTerrain
    take 3 blocks of 4 (12 warps), Insertion one block of 8 (its 16 KB spec
    in every block keeps 2 blocks of 4 from fitting a third), and Ingenuity
    at 128 two blocks of 8 (16 warps, as four blocks of 4 would be); at 255
    registers the register file allows 8 warps, and each takes one block of
    8. The size tuple carries the choice."""
    env, s, p, has_qt, names, has_terr = models[task]
    smem_of = lambda e: _cuda.smem_bytes(s, p, e, has_qt, names, has_terr)
    _, epb, warps = LAYOUT[task]
    regs = _cuda.plan_regs(s.nv)
    got = _cuda.envs_per_block(smem_of, _cuda.SMEM_OPTIN_BYTES, regs)
    assert got == epb and got * _cuda.resident_blocks(smem_of(got), got, regs) == warps
    assert _cuda.envs_per_block(smem_of, _cuda.SMEM_OPTIN_BYTES, regs=255) == 8
    assert _cuda.resident_blocks(smem_of(8), 8, 255) == 1
    assert _cuda.sizes_of(s, has_qt, names, fused.topk_cap(s, p), has_terr, got)[-1] == epb


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as `cvt.rna.tf32.f32` does: to nearest on the
    float's bits, ties away from zero, the low 13 mantissa bits cleared."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    keep = (u & 0x7F800000) == 0x7F800000  # inf and nan
    r = torch.where(keep, u, (u + 0x1000) & 0xFFFFE000)
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b from three TF32 products (lo.hi + hi.lo + hi.hi), fp32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _scale_and_bound(J, Minv, mm):
    """Per env, the kernel's diagonal J_r . W_r (W = J M^-1 through `mm`)
    and its Lipschitz bound max_i s_i sum_j s_j |(W J^T)_ij| + 1e-6 s_i^2."""
    diags, lips = [], []
    for e in range(J.shape[-1]):
        Je, Me = J[:, :, e].T, Minv[:, :, e]
        W = mm(Je, Me.T)
        diag = (W * Je).sum(1)
        ns = Je.shape[0] // 3
        s = torch.rsqrt(torch.clamp((diag[:ns] + diag[ns:2 * ns] + diag[2 * ns:]) / 3 + 1e-6, min=1e-12))
        s3 = torch.cat([s, s, s])
        A = mm(W, Je.T)
        lips.append(torch.amax(s3 * (A.abs() @ s3) + 1e-6 * s3 * s3))
        diags.append(diag)
    return torch.stack(diags, 1), torch.stack(lips)


@pytest.mark.parametrize("task", ["Anymal", "AnymalTerrain"])
def test_3xtf32_gram_product_keeps_float32_accuracy(models, task):
    """J and M^-1 of the plain step's first slice (robots standing 2 mm in
    the ground; AnymalTerrain's rows gathered to its cap of 20, fillers
    included) through the 3xTF32 emulation and through one TF32 product,
    against float64: the diagonal and the Lipschitz bound agree within 1e-6
    relative with the split, and a single TF32 product misses that."""
    env, s, p, has_qt, names, has_terr = models[task]
    m = env.model
    st, _ = env.reset(4)
    q = st.sim.q.clone()
    q[:, :2] = torch.tensor([[0.3, -0.4], [-1.1, 0.7]])
    cb = torch.tensor(m.cpoint_body)
    kin = forward_kinematics(m, q, torch.zeros(2, m.nv))
    x = kin.x[:, cb] + maths.quat_rotate(kin.quat[:, cb], torch.tensor(np.asarray(m.cpoint_pos)))
    q[:, 2] -= (x[..., 2] - torch.tensor(np.asarray(m.cpoint_radius))).amin(1) + 0.002
    qd = torch.zeros(2, m.nv)
    # flat ground for both: the solve's rows and the gather do not depend on the planes' source
    rows = lambda a: a.T.contiguous()
    dyn = None if st.dyn is None else st.dyn.rows
    gram = []
    fused._step_math_torch(s, p, torch.device("cpu"), names, delassus=gram)(
        rows(q), rows(qd), rows(qd), None, rows(q) if has_qt else None, dyn)
    J, Minv = gram[0]
    assert J.shape[1] == 3 * (fused.topk_cap(s, p) or s.nct)
    d64, l64 = _scale_and_bound(J.double(), Minv.double(), lambda a, b: a @ b)
    d3, l3 = _scale_and_bound(J, Minv, _mm_3xtf32)
    d1, l1 = _scale_and_bound(J, Minv, _mm_tf32)
    rel = lambda a, b: float(((a.double() - b).abs() / b.abs()).max())
    assert rel(d3, d64) < 1e-6 and rel(l3, l64) < 1e-6
    assert max(rel(d1, d64), rel(l1, l64)) > 1e-6
