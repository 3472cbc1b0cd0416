"""Split the fused-step kernel's time per env-slice into its phases, on one card.

    python tools/fused_phases.py [--keys AnymalTerrain Anymal Insertion] [--tree <checkout>]

Writes `isaacgymenvs_tpu_torch/_build/fused_step_phases.cu` (gitignored): a
copy of `engine/csrc/fused_step.cu` with `clock64()` counters between the
phases of a slice (the articulated step up to qd_free, the top-K ranking,
the rows of the solve, the diagonal and Jacobi scale, the Lipschitz bound,
APGD, and the impulse, integration and sensors), summed over each warp's
slices by lane 0 into a device array that two extra C functions read and
reset. Builds it through `engine/_cuda.py` (the library name hashes the
source, so it never stands in for the real kernel), runs each listed
instantiation (`Insertion`, the keys of chip_smoke.py's ANYMAL_CASES at 4096
envs, or of its CASES at their full width) in chip_smoke.py's comparison
states, and prints cycles per env-slice and phase (the clock of a warp,
stalls included) with each phase's share, and the instrumented kernel's
device ms per launch.
With `--tree`, the kernel and chip_smoke.py of another checkout (for
example the parent commit unpacked under `_build/`), whose source may mark
its phases as the kernel did before slots. Needs a CUDA device; exits
non-zero without.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ["articulated", "rank", "rows", "diag+scale", "lipschitz", "apgd", "impulse+integrate+sensors"]
# the counters stop before these lines of the slice, in this order
MARKS = ["    // slot state that outlives the solve",
         "      // ---- the rows of the solve, a slot per lane",
         "      // ---- the system's diagonal",
         "      // ---- Lipschitz bound of the scaled system",
         "      // ---- APGD with friction-cone projection",
         "      // ---- impulses back to physical units"]
# the same phases in the source before slots (J and W stored for every row):
# its first pass (J, J qd_free, the ranking) counts as the rows, its second
# (W = M^-1 J, the diagonal, the scale) as the diagonal
MARKS_BEFORE_SLOTS = ["    // contact state that outlives the solve",
                      "    // contact state that outlives the solve",
                      "      // ---- second pass, contacts in the solve",
                      "      // ---- Lipschitz bound of the scaled system",
                      "      // ---- APGD with friction-cone projection",
                      "      // ---- impulses back to physical units"]
SLICE_END = "    }  // NCT > 0\n    __syncwarp();\n  }\n"


def instrumented(src: str) -> str:
    """fused_step.cu with the phase counters."""
    marks = MARKS if MARKS[0] in src else MARKS_BEFORE_SLOTS
    def tick(k):
        return "{ const long long t2_ = clock64(); ph_[%d] += t2_ - t_; t_ = t2_; }\n" % k

    def once(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"fused_step.cu no longer has exactly one {old.strip()!r}")
        return text.replace(old, new)

    src = once(src, "namespace {\n", "namespace {\n__device__ unsigned long long g_phase[9];\n")
    src = once(src, "  for (int sl = 0; sl < n_slices; ++sl) {\n",
               "  long long ph_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
               "  for (int sl = 0; sl < n_slices; ++sl) {\n    long long t_ = clock64();\n")
    for k, mark in enumerate(marks):
        src = once(src, mark, mark[:len(mark) - len(mark.lstrip())] + tick(k) + mark)
    src = once(src, SLICE_END, "    " + tick(6) + SLICE_END +
               "  if (lane == 0) {\n    for (int k = 0; k < 8; ++k) atomicAdd(&g_phase[k], (unsigned long long)ph_[k]);\n"
               "    atomicAdd(&g_phase[8], 1ull);\n  }\n")
    return once(src, 'extern "C" {\n', 'extern "C" {\n'
                'int phases_read(unsigned long long* out) { return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)); }\n'
                'int phases_reset() { unsigned long long z[9] = {0}; return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z)); }\n')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", nargs="+", default=["AnymalTerrain", "Anymal", "Insertion"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tree", default=HERE, help="the checkout whose kernel and chip_smoke.py to use")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fused_phases: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    from isaacgymenvs_tpu_torch.engine import _cuda, fused

    path = os.path.join(_cuda.BUILD_DIR, "fused_step_phases.cu")
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    with open(_cuda.SOURCE) as f:
        text = instrumented(f.read())
    with open(path, "w") as f:
        f.write(text)
    _cuda.SOURCE = path
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    res = {}
    for key in args.keys:
        n = 4096
        if key == "Insertion":
            env = cs.insertion_env(n)
            (q, qd, qfrc, xfrc, qt, sdf), _, _, _ = cs.insertion_inputs(env, n, seed=44)
            p, names, has_t = env.sim_params, (), False
            call = (cs.rows(q), cs.rows(qd), cs.rows(qfrc), cs.xfrc_rows(xfrc), cs.rows(qt), None, None, 0, sdf)
        elif key in cs.ANYMAL_CASES:
            env = cs.anymal_env(key, n)
            (q, qd, qt, dyn, terr, _), _, _ = cs.anymal_inputs(key, env, n, seed=33)
            p, wre = cs.physics_args(env)
            names, has_t = (dyn.names if dyn is not None else ()), terr is not None
            call = (cs.rows(q), cs.rows(qd), cs.rows(torch.zeros_like(qd)), None, cs.rows(qt),
                    None if dyn is None else dyn.rows, terr, wre)
        else:  # an entry of chip_smoke.CASES, in the states its time_case draws
            base, _, n = cs.CASES[key]
            env, names = cs.case(key, n)
            q, qd, qfrc, xfrc, qt = cs.contact_inputs(base, env, n, seed=14, light="body_mass" in names)
            dyn = cs.packed_leaves(env, names, n, seed=27)
            p, has_t = env.sim_params, False
            call = (cs.rows(q), cs.rows(qd), cs.rows(qfrc), None if xfrc is None else cs.xfrc_rows(xfrc),
                    None if qt is None else cs.rows(qt), None if dyn is None else dyn.rows, None, 0)
        _, step = fused._prepared(env.model, p, torch.device("cuda"), call[4] is not None, names, has_t)
        lib = step.lib
        lib.phases_read.argtypes = [ctypes.c_void_p]
        lib.phases_read.restype = lib.phases_reset.restype = ctypes.c_int
        for _ in range(3):
            step(*call)
        torch.cuda.synchronize()
        if lib.phases_reset() != 0:
            raise RuntimeError("phases_reset failed")
        for _ in range(args.reps):
            step(*call)
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 9)()
        if lib.phases_read(ctypes.cast(out, ctypes.c_void_p)) != 0:
            raise RuntimeError("phases_read failed")
        per = {ph: out[k] / out[8] / (p.substeps * p.solver_iterations) for k, ph in enumerate(PHASES)}
        total = sum(per.values())
        res[key] = {"cycles_per_env_slice": per, "total": total, "share": {k: v / total for k, v in per.items()},
                    "device_ms": cs.kernel_device_ms(lambda: step(*call))}
        print(key, json.dumps(res[key]), flush=True)
    print("PHASES " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
