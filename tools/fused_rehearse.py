"""Rehearse an instantiation of the fused-step kernel on the CPU, without a card.

    python tools/fused_rehearse.py [--task Humanoid] [--envs 12] [--seed 5]
    python tools/fused_rehearse.py --task FactoryTaskNutBoltPick --envs 16

Compiles `engine/csrc/fused_step.cu`, cut at `extern "C"`, with `g++
-std=c++20` and the `-DFS_*` defines of the task's size tuple (as
`engine/_cuda.py` would pick it) against a small header of host stand-ins
for the CUDA builtins the kernel uses: one `std::thread` per lane, 32 x
envs-per-block of them per block, `std::barrier`s for `__syncwarp` and
`__syncthreads`, shuffles through a per-warp exchange array between two
barriers; the tensor-core product runs the host branch of `mma_tf32` (the
`mma.m16n8k8` fragment layout written out with shuffles) and `to_tf32`
rounds as `cvt.rna` does. The dynamic shared memory of each block is a host
buffer filled with NaN first, so that a read of a word the kernel never set
shows in the outputs. Runs the task's states (`contact_states` where the
task has them, with the drives holding the pose and no further forces;
else `standing_states` or its reset states, under random motor torques and
body wrenches) through it and through the plain PyTorch step (`_step_math_torch`),
and prints the largest error of each output; exits non-zero when an output
is not finite, when the compiled ENV_FLOATS differs from `_cuda.env_floats`,
or when an error passes the tolerances of chip_smoke.py (q 2e-4, qd 2e-3,
forces 2e-2). A task with SDF pair rows (the nut-bolt family) runs under
its own `compute_force` at zero actions, with its SDF planes sampled at the
states (`fused.sdf_dyn`) as the kernel's sdf input. Builds under
`isaacgymenvs_tpu_torch/_build/rehearse/` (gitignored). Tasks with per-env
leaves or terrain are not covered here.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"q": 2e-4, "qd": 2e-3, "body_force": 2e-2, "body_torque": 2e-2, "dof_force": 2e-2}

STUB = r'''#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(a, b)
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
extern thread_local Dim3 threadIdx;
extern thread_local Dim3 blockIdx;
extern Dim3 blockDim;
extern std::barrier<>* g_block_barrier;
extern std::vector<std::barrier<>*> g_warp_barriers;
extern uint32_t* g_xch;
extern float* g_smem;
inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp_barriers[threadIdx.x >> 5]->arrive_and_wait(); }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline uint32_t xch(uint32_t bits, int src) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  g_xch[w * 32 + l] = bits;
  g_warp_barriers[w]->arrive_and_wait();
  const uint32_t got = g_xch[w * 32 + (src & 31)];
  g_warp_barriers[w]->arrive_and_wait();
  return got;
}
inline float __shfl_sync(unsigned, float v, int src) { return __uint_as_float(xch(__float_as_uint(v), src)); }
inline unsigned __shfl_sync(unsigned, unsigned v, int src) { return xch(v, src); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  return __uint_as_float(xch(__float_as_uint(v), (threadIdx.x & 31) ^ m));
}
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int m) { return xch(v, (threadIdx.x & 31) ^ m); }
'''

MAIN = r'''#include "stub.h"
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <thread>
thread_local Dim3 threadIdx;
thread_local Dim3 blockIdx;
Dim3 blockDim;
std::barrier<>* g_block_barrier;
std::vector<std::barrier<>*> g_warp_barriers;
uint32_t* g_xch;
float* g_smem;
#include "kernel_cut.inc"

static std::vector<float> rd(const char* path, size_t n) {
  std::vector<float> v(n);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), 4, n, f) != n) { std::fprintf(stderr, "cannot read %s\n", path); std::exit(2); }
  std::fclose(f);
  return v;
}
static void wr(const char* path, const std::vector<float>& v) {
  FILE* f = std::fopen(path, "wb");
  std::fwrite(v.data(), 4, v.size(), f);
  std::fclose(f);
}
int main(int argc, char** argv) {
  const int n = std::atoi(argv[1]), spec_len = std::atoi(argv[2]), n_slices = std::atoi(argv[3]);
  const int iters = std::atoi(argv[4]);
  auto spec = rd("spec.bin", spec_len);
  auto q = rd("q.bin", (size_t)NQ * n), qd = rd("qd.bin", (size_t)NV * n), qfrc = rd("qfrc.bin", (size_t)NV * n);
  auto xfrc = rd("xfrc.bin", (size_t)6 * NB * n);
  std::vector<float> qt, sdf;
  if (QT) qt = rd("qt.bin", (size_t)NQ * n);
  if (NSP) sdf = rd("sdf.bin", (size_t)13 * NSP * n);
  std::vector<float> q2(NQ * n), qd2(NV * n), bf(3 * NB * n), bt(3 * NB * n), df(NV * n);
  std::vector<float> smem(block_bytes(spec_len) / 4);
  std::vector<uint32_t> xchbuf(32 * EPB);
  g_xch = xchbuf.data();
  blockDim.x = 32 * EPB;
  for (int b = 0; b < (n + EPB - 1) / EPB; ++b) {
    std::fill(smem.begin(), smem.end(), std::numeric_limits<float>::quiet_NaN());
    g_smem = smem.data();
    std::barrier<> block_bar(32 * EPB);
    std::vector<std::barrier<>*> wb;
    for (int w = 0; w < EPB; ++w) wb.push_back(new std::barrier<>(32));
    g_block_barrier = &block_bar;
    g_warp_barriers = wb;
    std::vector<std::thread> lanes;
    for (int t = 0; t < 32 * EPB; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        fused_step_kernel(q.data(), qd.data(), qfrc.data(), xfrc.data(), QT ? qt.data() : nullptr, nullptr,
                          nullptr, NSP ? sdf.data() : nullptr, q2.data(), qd2.data(), bf.data(), bt.data(),
                          df.data(), spec.data(), spec_len, n, n_slices, iters, 0);
      });
    for (auto& x : lanes) x.join();
    for (auto* p : wb) delete p;
  }
  wr("q_out.bin", q2);
  wr("qd_out.bin", qd2);
  wr("bf_out.bin", bf);
  wr("bt_out.bin", bt);
  wr("df_out.bin", df);
  std::printf("%d\n", (int)ENV_FLOATS);
  return 0;
}
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="Humanoid")
    ap.add_argument("--envs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from isaacgymenvs_tpu_torch.engine import _cuda, fused
    from isaacgymenvs_tpu_torch.tasks import task_map
    from isaacgymenvs_tpu_torch.utils.config import load_config

    n = args.envs
    env = task_map[args.task](load_config([f"task={args.task}", f"num_envs={n}"])["task"], device="cpu")
    if env.randomizer is not None or getattr(env, "terrain", None) is not None:
        raise SystemExit(f"{args.task}: per-env leaves and terrain are not covered by this rehearsal")
    m, p, qt_on = env.model, env.sim_params, env.use_pd_targets
    s = fused._extract(m)
    epb = _cuda.envs_per_block(lambda e: _cuda.smem_bytes(s, p, e, qt_on), _cuda.SMEM_OPTIN_BYTES,
                               _cuda.plan_regs(s.nv))
    cap = fused.topk_cap(s, p)
    sizes = _cuda.sizes_of(s, qt_on, (), cap, False, epb)
    work = os.path.join(HERE, "isaacgymenvs_tpu_torch", "_build", "rehearse")
    os.makedirs(work, exist_ok=True)
    src = open(_cuda.SOURCE).read()
    cut = src[:src.index('extern "C" {')].replace("#include <cuda_runtime.h>", "")
    cut = cut.replace("extern __shared__ float smem[];", "float* smem = g_smem;")
    for name, text in (("stub.h", STUB), ("main.cpp", MAIN), ("kernel_cut.inc", cut)):
        with open(os.path.join(work, name), "w") as f:
            f.write(text)
    exe = "rehearse_" + "_".join(map(str, sizes))
    build = subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", *_cuda._defines(sizes), "-o", exe, "main.cpp"],
                           cwd=work, capture_output=True, text=True)
    if build.returncode:
        print(build.stderr[-4000:])
        return 1

    gentle = hasattr(env, "contact_states")
    if gentle:
        q, qd = env.contact_states(n, args.seed)
    elif hasattr(env, "standing_states"):
        q, qd = env.standing_states(n, args.seed)
    else:
        state, _ = env.reset(args.seed)
        q, qd = state.sim.q, state.sim.qd
    rng = np.random.RandomState(args.seed + 1)
    # contact states rest sub-gram fingers on cubes and handles: no random wrenches there
    qfrc = torch.tensor(rng.uniform(-3, 3, (n, m.nv)).astype(np.float32) * (0.0 if gentle else 1.0))
    xfrc = torch.tensor(rng.uniform(-1, 1, (n, m.nbody, 6)).astype(np.float32) * (0.0 if gentle else 1.0))
    qt = q
    sdf = None
    if len(m.spair_point):
        # the task's own forces under zero actions (the nut-bolt family's
        # controller, gravity compensation and gripper setpoint) and the
        # SDF planes sampled at the entry pose
        task = {"t": torch.zeros(n, dtype=torch.int32)} if hasattr(env, "rl_len") else ()
        qfrc, xfrc, qt = env.compute_force(torch.zeros(n, env.num_acts), q, qd, task)
        sdf = fused.pack_sdf(fused.sdf_dyn(m, q, qd))
    rows = lambda t: t.T.contiguous()
    ins = {"q": rows(q), "qd": rows(qd), "qfrc": rows(qfrc),
           "xfrc": xfrc.permute(2, 1, 0).reshape(6 * m.nbody, n).contiguous()}
    if qt_on:
        ins["qt"] = rows(qt)
    if sdf is not None:
        ins["sdf"] = sdf
    spec = _cuda.pack_spec(s, p, fused.apgd_betas(p.solver_apgd_iterations))
    spec.astype(np.float32).tofile(os.path.join(work, "spec.bin"))
    for name, t in ins.items():
        t.numpy().astype(np.float32).tofile(os.path.join(work, f"{name}.bin"))
    run = subprocess.run([f"./{exe}", str(n), str(spec.size), str(p.substeps * p.solver_iterations),
                          str(p.solver_apgd_iterations)], cwd=work, capture_output=True, text=True)
    if run.returncode:
        print(run.stderr[-4000:])
        return 1
    env_floats = int(run.stdout.split()[-1])
    ref = fused._step_math_torch(s, p, torch.device("cpu"))(ins["q"], ins["qd"], ins["qfrc"], ins["xfrc"],
                                                             ins.get("qt"), None, None, 0, ins.get("sdf"))
    host_floats = _cuda.env_floats(s, qt_on, (), cap)
    ok = env_floats == host_floats
    print(f"{args.task} {'_'.join(map(str, sizes))}, {n} envs in blocks of {epb}: ENV_FLOATS {env_floats} "
          f"(host {host_floats})")
    for i, (name, fname) in enumerate(zip(TOL, ("q_out", "qd_out", "bf_out", "bt_out", "df_out"))):
        got = np.fromfile(os.path.join(work, f"{fname}.bin"), np.float32).reshape(ref[i].shape)
        err = float(np.abs(got - ref[i].numpy()).max())
        finite = bool(np.isfinite(got).all())
        ok &= finite and err < TOL[name]
        print(f"  {name}: max abs error {err:.3e} (tolerance {TOL[name]}), largest |value| "
              f"{float(np.abs(ref[i].numpy()).max()):.3e}, finite {finite}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
