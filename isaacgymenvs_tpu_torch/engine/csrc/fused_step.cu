// Fused whole physics step for Hopper (sm_90a), one warp per env.
//
// Replaces the TPU kernel isaacgymenvs_tpu/engine/fused.py
// `_build_call.<locals>.kernel` (launched by `pl.pallas_call`, fused.py:1883),
// for the feature tiers K1 (articulated step, with PD-drive setpoints from a
// q_target input under -DFS_QT=1, fused.py:774-777), K2 (plane contacts,
// APGD, xfrc), K4 (point-vs-geom pair rows, -DFS_NPP, fused.py:918-1089,
// and bilateral point anchors, -DFS_NATT, fused.py:1129-1147, in the same
// solve as the plane rows), fixed tendons (-DFS_NT, fused.py:803-819) and K3
// (per-env model leaves and per-env gravity, -DFS_DYN=<bitmask>,
// fused.py:1693-1707: one packed (rows, N) input, see "Per-env leaves"
// below), K5 (the top-K active set, -DFS_CAP=<cap>, fused.py:1252-1350 and
// :1422-1435, see "Top-K" below), K6 terrain rows (-DFS_TERR=1,
// fused.py:889-907: plane rows against per-env entry-sampled planes, see
// "Terrain rows" below), K6 SDF rows (-DFS_NSP, fused.py:1091-1127, sensors
// :1476-1501: candidate points against voxel SDF grids through per-env
// entry-sampled planes, see "SDF rows" below) and merged decimation windows (the runtime argument
// `warm_reset_every`, fused.py:1547-1561: the warm start resets at slice i
// when i is a non-zero multiple of it). Built with no rows at all it is the
// contact-free instantiation of K1
// (the `nct == 0` finish of `substep`, fused.py:846-855): qd_free, the
// velocity clip, integration, and zero force outputs; every contact stage
// is compiled out (`if constexpr`), and the per-env shared memory shrinks
// to the articulated part. One launch advances every env by `n_slices =
// substeps x solver_iterations` slices; each slice is `_substep_fn.substep`
// (fused.py:686): FK, spatial inertia, CRBA, bias force with xfrc, implicit
// passive forces, Gauss-Jordan inverse (no pivoting), contact rows (plane,
// pair, anchor) with Baumgarte, restitution and the anchors' error drive,
// Jacobi-scaled Delassus, Lipschitz step, APGD with cone projection that
// leaves bilateral rows unprojected (warm start zero at each call, carried
// across its slices), impulse to qd, velocity clip, integration, and
// sensors of the last slice. The plain PyTorch twin is `_step_math_torch` in
// fused.py.
//
// What bounds it. Per env and slice the work the step needs is dominated by
// the Lipschitz row sums of the symmetric |J^T M^-1 J| (R(R+1)/2 x nv
// multiply-adds, R = 3 x contacts) and the APGD matvecs, then W = M^-1 J and the
// Gauss-Jordan inverse; for Ant (nv 14, nc 25, 16 APGD iterations, 2
// slices) that is about 0.47 MFLOP per env-step (`kernel_flops` in
// engine/_cuda.py counts it) against about 0.8 KB of boundary traffic per
// env. So it is bound by fp32 CUDA-core work, not by memory: 4096 envs need
// ~1.9 GFLOP and ~3 MB. This kernel forms all R x R entries for the row
// sums (twice the needed Lipschitz work) and inverts with an identity
// companion matrix (twice the needed Gauss-Jordan work).
//
// Design. Sizes (nbody, nq, nv, plane rows, pair rows, anchors, q_target or
// not, tendons, the per-env leaf set, the top-K cap, terrain or not, SDF
// rows, envs per block) are compile-time constants (-DFS_NB ..), one library
// per size tuple; the body tree, the model constants and the
// solver parameters come in a small float buffer that each block copies to
// shared memory. A warp owns one env: its state, J, W = M^-1 J and M^-1 stay
// in shared memory (~16 KB for Ant) across all slices and APGD iterations.
// Lanes own contacts (a contact's three rows stay in registers through the
// solve; with more than 32 contacts a lane owns several), bodies (FK and the bias force run level by level over the tree),
// dofs, or matrix entries. The dense Delassus matrix is never stored: the
// APGD matvec runs as J^T (W (s y)), O(R nv) instead of O(R^2), which also
// saves 22.5 KB of shared memory per env; the one pass that needs the
// entries (the Lipschitz row sums) forms them on the fly. Warp reductions
// are xor butterflies, so every lane holds bit-identical sums. At the
// boundary the arrays keep the TPU's (rows, N) layout: a block loads and
// stores its envs cooperatively, neighbouring threads on neighbouring envs,
// and masks the ragged edge (N is not padded).
//
// Row kinds. The lane that owns a contact branches on its kind: a plane row
// has the world axes as its frame and phi = radius - z; a pair row runs the
// narrowphase of its geom type (a real branch per row: box, cylinder or
// sphere), builds the frame (t1, t2, n) from the normal, takes the Jacobian at
// the surface point with the signed dof path (point body minus geom body) and
// rotates it into the frame, which it parks in shared memory for the sensors;
// an anchor has the world axes, phi = 0, is always active and bilateral, and
// drives its point error on all three rows. The sensors give +F to a pair
// row's point body and -F to its geom body, each with its own torque arm;
// every (component, body) output is summed by one lane, without atomics.
//
// SDF rows. With -DFS_NSP=<rows> the contacts of the solve include, after
// the pair rows, NSP rows of a candidate point on body A against the voxel
// SDF grid of body B. The grid is never read here: a (13 NSP, N) input holds
// per row the plane sampled outside at the call's entry pose
// (fused.sdf_dyn: depth phi0 at the point's entry position x0, the grid's
// normal n and tangents t1, t2, all world) and held for all of the call's
// slices, as the TPU kernel holds it. The lane that owns the row takes the
// point x from FK at the slice's pose, sets phi = phi0 - n . (x - x0), forms
// the world point Jacobian at x along the signed dof path (A minus B) and
// rotates it into [t1, t2, n]; the row then enters the solve beside the
// plane rows, with the point's friction and restitution, Baumgarte and its
// top-K key. Its sensor turns the impulse to world axes through the same
// frame and gives +F to A and -F to B, each with its own torque arm. The
// planes are staged in the env's shared memory (E_SDF, 13 NSP floats),
// loaded cooperatively like the terrain input.
//
// Envs per block. FS_EPB envs share a block; the host picks the largest of
// 4, 2 and 1 whose dynamic shared memory (spec + FS_EPB x ENV_FLOATS floats)
// fits the device's opt-in limit for one block (engine/_cuda.py
// envs_per_block), so a model with many rows (Insertion: 128 contacts, J
// and W of 2 x 15 x 384 floats per env) runs at fewer envs per block rather
// than failing its launch.
//
// Terrain rows. With -DFS_TERR=1 a plane row stands against its own plane:
// a (10 NC, N) input holds, per candidate point, the ground height h under
// it and the plane's normal n and tangents t1, t2 (world), sampled outside
// at the call's entry pose (fused.terrain_dyn) and held for all of the
// call's slices, as the TPU kernel holds them. phi = radius - (z - h) n_z,
// and the row's world Jacobian is rotated into [t1, t2, n] the way a pair
// row's is. The sensors keep the TPU kernel's convention for plane rows:
// the impulses are summed as world components, unrotated.
//
// Top-K. With -DFS_CAP=<cap> below the contact count only `cap` contacts
// enter the solve: those of the largest predicted depth phi - min(v_n, 0) h
// (v_n the unscaled normal row times qd_free; anchors first, inactive rows
// last), ties to the lower index, lax.top_k's order. The contact pass is
// split in two: the first forms every row's Jacobian, phi and J qd_free and
// parks the keys in shared memory; each lane then counts, for its contacts,
// the keys that beat them (rank < cap: selected); the second pass forms
// W = M^-1 J and the Jacobi scale of the selected contacts only. The
// Delassus system is never stored, so nothing is gathered: an unselected
// contact is inactive (its impulse and warm start are zero, as the TPU
// kernel's scatter of zeros off the set), its rows enter no matvec, and the
// Lipschitz row sums run over selected rows and columns. When fewer than
// cap rows are active, inactive fillers take the remaining slots by index
// and count in the Lipschitz bound, as they do on the TPU.
//
// Per-env leaves. Where the TPU kernel takes one operand per randomized
// model leaf and swaps a constant for it at trace time, this kernel takes
// one packed (DYN_ROWS, N) input: the leaves of the compile-time set FS_DYN
// one after another in a fixed order (bit i of FS_DYN = leaf i of the L_*
// list below; component leaves comp-major, row = component * entities +
// entity). A block copies each env's rows into the env's shared-memory
// block (E_DYN, sized by the compiled set, not by the full one), and every
// randomizable constant is read through `leaf<>`, which folds to the spec
// read when the leaf's bit is clear: a build without per-env leaves is the
// kernel it was. Per env the input adds 4 x DYN_ROWS bytes of boundary
// traffic (Ant with mass, damping, stiffness and both limits: 65 floats
// beside about 150), so the step stays bound by operations.
//
// The contact-free instantiation (Cartpole: nbody 3, nv 2, 2 slices) needs
// about 4 KFLOP and 120 bytes of boundary traffic per env-step
// (`kernel_flops`, `kernel_bytes`), so both of its bounds lie far below a
// launch's fixed cost: at the sizes a task runs it (512 to 4096 envs) the
// launch is latency-dominated.
#include <cuda_runtime.h>

#ifndef FS_NB
#error "compile with -DFS_NB=<nbody> -DFS_NQ=<nq> -DFS_NV=<nv> -DFS_NC=<plane contacts> [-DFS_NPP=<pair rows> -DFS_NSP=<SDF pair rows> -DFS_NATT=<anchors> -DFS_QT=1 -DFS_NT=<tendons> -DFS_DYN=<leaf bitmask> -DFS_NCP=<model cpoints> -DFS_NG=<model geoms> -DFS_CAP=<top-K cap> -DFS_TERR=1 -DFS_EPB=<envs per block>]"
#endif
#ifndef FS_EPB
#define FS_EPB 4
#endif
#ifndef FS_NPP
#define FS_NPP 0  // point-vs-geom pair rows
#endif
#ifndef FS_NSP
#define FS_NSP 0  // SDF pair rows: candidate points against voxel SDF grids
#endif
#ifndef FS_NATT
#define FS_NATT 0  // bilateral point anchors
#endif
#ifndef FS_QT
#define FS_QT 0  // 1: PD-drive setpoints come per env in a q_target input
#endif
#ifndef FS_NT
#define FS_NT 0  // fixed tendons
#endif
#ifndef FS_DYN
#define FS_DYN 0  // bitmask of the per-env leaves in the packed dyn input
#endif
#ifndef FS_NCP
#define FS_NCP 0  // candidate points of the model (per-env cpoint_* leaves index them)
#endif
#ifndef FS_NG
#define FS_NG 0  // geoms of the model (the per-env geom_size leaf indexes them)
#endif
#ifndef FS_CAP
#define FS_CAP 0  // top-K: contacts in the solve (0: all of them)
#endif
#ifndef FS_TERR
#define FS_TERR 0  // 1: plane rows read per-env terrain planes from a (10 NC, N) input
#endif

namespace {

constexpr int NB = FS_NB, NQ = FS_NQ, NV = FS_NV, NC = FS_NC, EPB = FS_EPB;
constexpr int NPP = FS_NPP, NSP = FS_NSP, NATT = FS_NATT;
constexpr bool QT = FS_QT != 0;
constexpr int NT = FS_NT, NCP = FS_NCP, NG = FS_NG;
constexpr unsigned DYN = FS_DYN;
// contacts of the solve in row order: plane, pair, SDF, anchor; a contact
// has three rows, stored comp-major [t1 | t2 | n] in blocks of NCT
constexpr int NTWO = NPP + NSP;    // two-body contacts (pair and SDF rows)
constexpr int NUNI = NC + NTWO;    // unilateral contacts
constexpr int NCT = NUNI + NATT;
constexpr int R = 3 * NCT;
constexpr int CPL = (NCT + 31) / 32;  // contacts per lane
constexpr int CPLA = CPL > 0 ? CPL : 1;  // size of the per-lane contact arrays (none of length 0)
constexpr int CAP = FS_CAP;
constexpr bool TOPK = CAP > 0;
constexpr bool TERR = FS_TERR != 0;
static_assert(NC >= 0 && NPP >= 0 && NSP >= 0 && NATT >= 0, "negative contact count");
static_assert(EPB == 1 || EPB == 2 || EPB == 4, "envs per block is 4, 2 or 1");
static_assert(!TOPK || (CAP < NCT && CAP > NATT), "the cap must lie below the contacts and above the anchors");
static_assert(!TERR || NC > 0, "terrain planes need plane rows");
static_assert(NV > 0 && NB > 0, "empty model");

constexpr int FREE = 0, HINGE = 1, SLIDE = 2;
constexpr int GEOM_BOX = 2, GEOM_CYLINDER = 3;  // any other pair geom is a sphere

// ---- spec buffer layout (mirrored by _pack_spec in engine/_cuda.py) ----
constexpr int P_G = 0, P_H = 3, P_H2 = 4, P_INVH = 5, P_ERP = 6, P_MAXDEP = 7,
              P_MARGIN = 8, P_BOUNCE = 9, P_LIMK = 10, P_LIMD = 11,
              P_MAXV = 12, P_NLEV = 13, P_ERPATT = 14, NPARAM = 16;
constexpr int O_PARENT = NPARAM;
constexpr int O_JTYPE = O_PARENT + NB;
constexpr int O_QADR = O_JTYPE + NB;
constexpr int O_VADR = O_QADR + NB;
constexpr int O_DEPTH = O_VADR + NB;
constexpr int O_BPOS = O_DEPTH + NB;
constexpr int O_BQUAT = O_BPOS + 3 * NB;
constexpr int O_IPOS = O_BQUAT + 4 * NB;
constexpr int O_INERTIA = O_IPOS + 3 * NB;
constexpr int O_MASS = O_INERTIA + 9 * NB;
constexpr int O_JAXIS = O_MASS + NB;
constexpr int O_JPOS = O_JAXIS + 3 * NB;
constexpr int O_DOFBODY = O_JPOS + 3 * NB;
constexpr int O_SQADR = O_DOFBODY + NV;
constexpr int O_ARM = O_SQADR + NV;
constexpr int O_DAMP = O_ARM + NV;
constexpr int O_FRIC = O_DAMP + NV;
constexpr int O_STIFF = O_FRIC + NV;
constexpr int O_LO = O_STIFF + NV;
constexpr int O_HI = O_LO + NV;
constexpr int O_LIMITED = O_HI + NV;
constexpr int O_SETPT = O_LIMITED + NV;
constexpr int O_DMASK = O_SETPT + NV;
constexpr int O_ANC = O_DMASK + NV * NV;
// per contact (NCT): the body of the candidate point / pair point / anchor,
// that point in the body's frame, its radius, friction, restitution, and the
// dof path mask of its Jacobian (signed A - B for a pair row)
constexpr int O_CPBODY = O_ANC + NB * NB;
constexpr int O_CPPOS = O_CPBODY + NCT;
constexpr int O_CPRAD = O_CPPOS + 3 * NCT;
constexpr int O_CPMU = O_CPRAD + NCT;
constexpr int O_REST = O_CPMU + NCT;
constexpr int O_PATH = O_REST + NCT;
// per pair row (NPP): the geom's body, type, pose in that body, half sizes
constexpr int O_PPB = O_PATH + NCT * NV;
constexpr int O_PPTYPE = O_PPB + NPP;
constexpr int O_PPGPOS = O_PPTYPE + NPP;
constexpr int O_PPGQUAT = O_PPGPOS + 3 * NPP;
constexpr int O_PPGSIZE = O_PPGQUAT + 4 * NPP;
// per pair row, for per-env leaves: the row's candidate point and geom in
// the model's arrays, and the geom-side friction
constexpr int O_PPPT = O_PPGSIZE + 3 * NPP;
constexpr int O_PPGEOM = O_PPPT + NPP;
constexpr int O_PPGFRIC = O_PPGEOM + NPP;
// per SDF row (NSP): the grid's body, and the row's candidate point in the
// model's arrays (for per-env leaves)
constexpr int O_SPB = O_PPGFRIC + NPP;
constexpr int O_SPPT = O_SPB + NSP;
// per tendon (NT): coefficients over the dofs, range, stiffness, damping
constexpr int O_TCOEF = O_SPPT + NSP;
constexpr int O_TRANGE = O_TCOEF + NT * NV;
constexpr int O_TSTIFF = O_TRANGE + 2 * NT;
constexpr int O_TDAMP = O_TSTIFF + NT;
// per anchor (NATT): world target
constexpr int O_ATTTGT = O_TDAMP + NT;
constexpr int SPEC_BASE = O_ATTTGT + 3 * NATT;  // followed by betas[iters]

// ---- per-env shared-memory layout ----
constexpr int E_Q = 0;
constexpr int E_QD = E_Q + NQ;
constexpr int E_QFRC = E_QD + NV;
constexpr int E_XFRC = E_QFRC + NV;      // (6, NB) comp-major
constexpr int E_QTGT = E_XFRC + 6 * NB;  // (NQ,) q_target, only with QT
constexpr int E_QDF = E_QTGT + (QT ? NQ : 0);  // qd_free
constexpr int E_RHS = E_QDF + NV;
constexpr int E_X = E_RHS + NV;          // (NB, 3)
constexpr int E_QT = E_X + 3 * NB;       // (NB, 4)
constexpr int E_V = E_QT + 4 * NB;       // (NB, 6)
constexpr int E_ZETA = E_V + 6 * NB;     // (NB, 6)
constexpr int E_NET = E_ZETA + 6 * NB;   // (NB, 6)
constexpr int E_IC = E_NET + 6 * NB;     // (NB, 6, 6) composite inertia
constexpr int E_S = E_IC + 36 * NB;      // (NV, 6)
constexpr int E_SD = E_S + 6 * NV;
constexpr int E_F = E_SD + 6 * NV;
constexpr int E_AG = E_F + 6 * NV;       // (NV, NV) Gauss-Jordan work
constexpr int E_MINV = E_AG + NV * NV;
constexpr int E_PIVA = E_MINV + NV * NV;
constexpr int E_PIVI = E_PIVA + NV;
constexpr int E_CC = E_PIVI + NV;
constexpr int E_SC = E_CC + NV;          // (NCT,) Jacobi scale per contact
constexpr int E_J = E_SC + NCT;          // (NV, R) comp-major rows
constexpr int E_W = E_J + NV * R;        // (NV, R) = M^-1 J
constexpr int E_FS = E_W + NV * R;       // (6, NCT) world contact force, torque about the point's body
constexpr int E_FSB = E_FS + 6 * NCT;    // (3, NTWO) the same force's torque about body B (geom or grid)
constexpr int E_FR = E_FSB + 3 * NTWO;   // (NPP, 9) pair-row frame t1, t2, n (world)
constexpr int E_BF = E_FR + 9 * NPP;     // (3, NB)
constexpr int E_BT = E_BF + 3 * NB;      // (3, NB)
constexpr int E_DF = E_BT + 3 * NB;      // (NV,)
// ---- per-env leaves: bit order of FS_DYN, rows and offsets in the packed input
enum Leaf {
  L_DAMP = 0, L_STIFF, L_FRIC, L_ARM, L_LO, L_HI, L_MASS, L_CPFRIC, L_CPREST,
  L_TSTIFF, L_TDAMP, L_IPOS, L_INERTIA, L_CPPOS, L_GSIZE, L_GRAV, L_COUNT
};
constexpr bool has_leaf(int l) { return ((DYN >> l) & 1u) != 0; }
constexpr int leaf_rows(int l) {
  return l <= L_HI ? NV
         : l == L_MASS ? NB
         : (l == L_CPFRIC || l == L_CPREST) ? NCP
         : (l == L_TSTIFF || l == L_TDAMP) ? NT
         : l == L_IPOS ? 3 * NB
         : l == L_INERTIA ? 9 * NB
         : l == L_CPPOS ? 3 * NCP
         : l == L_GSIZE ? 3 * NG
         : 3;
}
constexpr int dyn_off(int l) {
  int o = 0;
  for (int k = 0; k < l; ++k)
    if (has_leaf(k)) o += leaf_rows(k);
  return o;
}
constexpr bool H_DAMP = has_leaf(L_DAMP), H_STIFF = has_leaf(L_STIFF), H_FRIC = has_leaf(L_FRIC),
               H_ARM = has_leaf(L_ARM), H_LO = has_leaf(L_LO), H_HI = has_leaf(L_HI),
               H_MASS = has_leaf(L_MASS), H_CPFRIC = has_leaf(L_CPFRIC),
               H_CPREST = has_leaf(L_CPREST), H_TSTIFF = has_leaf(L_TSTIFF),
               H_TDAMP = has_leaf(L_TDAMP), H_IPOS = has_leaf(L_IPOS),
               H_INERTIA = has_leaf(L_INERTIA), H_CPPOS = has_leaf(L_CPPOS),
               H_GSIZE = has_leaf(L_GSIZE), H_GRAV = has_leaf(L_GRAV);
constexpr int DO_DAMP = dyn_off(L_DAMP), DO_STIFF = dyn_off(L_STIFF), DO_FRIC = dyn_off(L_FRIC),
              DO_ARM = dyn_off(L_ARM), DO_LO = dyn_off(L_LO), DO_HI = dyn_off(L_HI),
              DO_MASS = dyn_off(L_MASS), DO_CPFRIC = dyn_off(L_CPFRIC),
              DO_CPREST = dyn_off(L_CPREST), DO_TSTIFF = dyn_off(L_TSTIFF),
              DO_TDAMP = dyn_off(L_TDAMP), DO_IPOS = dyn_off(L_IPOS),
              DO_INERTIA = dyn_off(L_INERTIA), DO_CPPOS = dyn_off(L_CPPOS),
              DO_GSIZE = dyn_off(L_GSIZE), DO_GRAV = dyn_off(L_GRAV);
constexpr int DYN_ROWS = dyn_off(L_COUNT);
static_assert(DYN < (1u << L_COUNT), "unknown per-env leaf bit");
static_assert(!(H_CPFRIC || H_CPREST || H_CPPOS) || (NCP >= NC && NCP > 0),
              "per-env cpoint leaves need -DFS_NCP=<model cpoints>");
static_assert(!H_GSIZE || NG > 0, "the per-env geom_size leaf needs -DFS_NG=<model geoms>");
static_assert(NT >= 0 && NCP >= 0 && NG >= 0, "negative count");

constexpr int E_DYN = E_DF + NV;         // (DYN_ROWS,) the env's per-env leaves
constexpr int E_TERR = E_DYN + DYN_ROWS;  // (10, NC) h, n, t1, t2 per plane row, with TERR
constexpr int E_SDF = E_TERR + (TERR ? 10 * NC : 0);  // (13, NSP) phi0, x0, n, t1, t2 per SDF row
constexpr int E_KEY = E_SDF + 13 * NSP;               // (NCT,) top-K keys, with TOPK
constexpr int E_SEL = E_KEY + (TOPK ? NCT : 0);       // (NCT,) 1 where a contact is in the solve
constexpr int ENV_FLOATS = ((E_SEL + (TOPK ? NCT : 0) + 3) / 4) * 4;

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// Entry i of a randomizable model leaf: the env's own value when the leaf
// is in the compiled set (H), else the model's constant in the spec buffer.
template <bool H, int DOFF, int SOFF>
__device__ __forceinline__ float leaf(const float* sp, const float* e, int i) {
  if constexpr (H) return e[E_DYN + DOFF + i];
  else return sp[SOFF + i];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, m));
  return v;
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  const float x1 = a[0], y1 = a[1], z1 = a[2], w1 = a[3];
  const float x2 = b[0], y2 = b[1], z2 = b[2], w2 = b[3];
  o[0] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[1] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[2] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  o[3] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
}

// rotate v by q (xyzw): v + w t + xyz x t, t = 2 xyz x v
__device__ __forceinline__ void qrot(const float* q, const float* v, float* o) {
  float t[3], u[3];
  cross3(q, v, t);
  t[0] *= 2.f; t[1] *= 2.f; t[2] *= 2.f;
  cross3(q, t, u);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + q[3] * t[k] + u[k];
}

__device__ __forceinline__ void qnormalize(float* q) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float inv = 1.f / fmaxf(n, 1e-9f);
  for (int k = 0; k < 4; ++k) q[k] *= inv;
}

// rotation vector -> quaternion, Taylor branch near 0 (fused.py _qexp)
__device__ __forceinline__ void qexp(const float* p, float* o) {
  const float a2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
  const float angle = sqrtf(fmaxf(a2, 1e-24f));
  const bool small = a2 < 1e-12f;
  const float s = small ? 0.5f - a2 / 48.f : sinf(0.5f * angle) / angle;
  const float w = small ? 1.f - a2 / 8.f : cosf(0.5f * angle);
  o[0] = p[0] * s; o[1] = p[1] * s; o[2] = p[2] * s; o[3] = w;
}

// FK of body b from its parent (fused.py _fk), plus the velocity-product
// acceleration zeta of the bias force (fused.py:733-741).
__device__ void fk_body(const float* __restrict__ sp, float* __restrict__ e, int b) {
  const int p = (int)sp[O_PARENT + b];
  float xp[3] = {0.f, 0.f, 0.f}, qp[4] = {0.f, 0.f, 0.f, 1.f};
  float vp[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, zet[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (p >= 0) {
    for (int k = 0; k < 3; ++k) xp[k] = e[E_X + 3 * p + k];
    for (int k = 0; k < 4; ++k) qp[k] = e[E_QT + 4 * p + k];
    for (int k = 0; k < 6; ++k) {
      vp[k] = e[E_V + 6 * p + k];
      zet[k] = e[E_ZETA + 6 * p + k];
    }
  }
  float rr[3], Xx[3], Xq[4];
  qrot(qp, sp + O_BPOS + 3 * b, rr);
  for (int k = 0; k < 3; ++k) Xx[k] = xp[k] + rr[k];
  qmul(qp, sp + O_BQUAT + 4 * b, Xq);
  const int jt = (int)sp[O_JTYPE + b];
  const int qa = (int)sp[O_QADR + b], va = (int)sp[O_VADR + b];
  const float* q = e + E_Q;
  const float* qd = e + E_QD;
  float xi[3], qi[4], vi[6];
  if (jt == FREE) {
    for (int k = 0; k < 3; ++k) xi[k] = q[qa + k];
    for (int k = 0; k < 4; ++k) qi[k] = q[qa + 3 + k];
    qnormalize(qi);
    float vl[3], om[3], cwx[3];
    for (int k = 0; k < 3; ++k) { vl[k] = qd[va + k]; om[k] = qd[va + 3 + k]; }
    cross3(om, xi, cwx);
    for (int k = 0; k < 3; ++k) { vi[k] = om[k]; vi[3 + k] = vl[k] - cwx[k]; }
    for (int k = 0; k < 3; ++k) {
      float* S = e + E_S + 6 * (va + k);
      float* Sd = e + E_SD + 6 * (va + k);
      for (int c = 0; c < 6; ++c) { S[c] = (c == 3 + k) ? 1.f : 0.f; Sd[c] = 0.f; }
    }
    for (int k = 0; k < 3; ++k) {
      const float ek[3] = {k == 0 ? 1.f : 0.f, k == 1 ? 1.f : 0.f, k == 2 ? 1.f : 0.f};
      float cxe[3], cve[3];
      cross3(xi, ek, cxe);
      cross3(vl, ek, cve);
      float* S = e + E_S + 6 * (va + 3 + k);
      float* Sd = e + E_SD + 6 * (va + 3 + k);
      for (int c = 0; c < 3; ++c) {
        S[c] = ek[c]; S[3 + c] = cxe[c];
        Sd[c] = 0.f; Sd[3 + c] = cve[c];
      }
    }
    for (int d = va; d < va + 6; ++d)
      for (int k = 0; k < 6; ++k) zet[k] = zet[k] + e[E_SD + 6 * d + k] * qd[d];
  } else if (jt == HINGE || jt == SLIDE) {
    const float* ax = sp + O_JAXIS + 3 * b;
    const float* jp = sp + O_JPOS + 3 * b;
    const float s = q[qa], sd = qd[va];
    float axw[3], Srow[6], Sdrow[6];
    qrot(Xq, ax, axw);
    const float* wp = vp;
    const float* vop = vp + 3;
    if (jt == HINGE) {
      const float half = 0.5f * s;
      const float sh = sinf(half), ch = cosf(half);
      const float jq[4] = {ax[0] * sh, ax[1] * sh, ax[2] * sh, ch};
      qmul(Xq, jq, qi);
      float r1[3], r2[3], anchor[3];
      qrot(Xq, jp, r1);
      for (int k = 0; k < 3; ++k) anchor[k] = Xx[k] + r1[k];
      qrot(qi, jp, r2);
      for (int k = 0; k < 3; ++k) xi[k] = anchor[k] - r2[k];
      float cax[3], axd[3], cwa[3], van[3], cva[3], cad[3];
      cross3(anchor, axw, cax);
      cross3(wp, axw, axd);
      cross3(wp, anchor, cwa);
      for (int k = 0; k < 3; ++k) van[k] = vop[k] + cwa[k];
      cross3(van, axw, cva);
      cross3(anchor, axd, cad);
      for (int k = 0; k < 3; ++k) {
        Srow[k] = axw[k]; Srow[3 + k] = cax[k];
        Sdrow[k] = axd[k]; Sdrow[3 + k] = cva[k] + cad[k];
      }
    } else {
      for (int k = 0; k < 4; ++k) qi[k] = Xq[k];
      for (int k = 0; k < 3; ++k) xi[k] = Xx[k] + axw[k] * s;
      float cwa[3];
      cross3(wp, axw, cwa);
      for (int k = 0; k < 3; ++k) {
        Srow[k] = 0.f; Srow[3 + k] = axw[k];
        Sdrow[k] = 0.f; Sdrow[3 + k] = cwa[k];
      }
    }
    for (int k = 0; k < 6; ++k) {
      vi[k] = vp[k] + Srow[k] * sd;
      e[E_S + 6 * va + k] = Srow[k];
      e[E_SD + 6 * va + k] = Sdrow[k];
      zet[k] = zet[k] + Sdrow[k] * sd;
    }
  } else {  // FIXED
    for (int k = 0; k < 3; ++k) xi[k] = Xx[k];
    for (int k = 0; k < 4; ++k) qi[k] = Xq[k];
    for (int k = 0; k < 6; ++k) vi[k] = vp[k];
  }
  for (int k = 0; k < 3; ++k) e[E_X + 3 * b + k] = xi[k];
  for (int k = 0; k < 4; ++k) e[E_QT + 4 * b + k] = qi[k];
  for (int k = 0; k < 6; ++k) {
    e[E_V + 6 * b + k] = vi[k];
    e[E_ZETA + 6 * b + k] = zet[k];
  }
}

// World-origin spatial inertia of body b (fused.py _spatial_inertia) into
// E_IC, and its net bias wrench Io (zeta - a_g) + v x* Io v - xfrc.
__device__ void inertia_and_net(const float* __restrict__ sp, float* __restrict__ e, int b) {
  const float x = e[E_QT + 4 * b], y = e[E_QT + 4 * b + 1];
  const float z = e[E_QT + 4 * b + 2], w = e[E_QT + 4 * b + 3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float Rm[3][3] = {
      {1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy)},
      {2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx)},
      {2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)}};
  const float* ipos = sp + O_IPOS + 3 * b;
  const float* Ib = sp + O_INERTIA + 9 * b;
  float ipos_e[3], Ib_e[9];  // the env's own, comp-major in the packed input
  if constexpr (H_IPOS) {
    for (int k = 0; k < 3; ++k) ipos_e[k] = e[E_DYN + DO_IPOS + k * NB + b];
    ipos = ipos_e;
  }
  if constexpr (H_INERTIA) {
    for (int k = 0; k < 9; ++k) Ib_e[k] = e[E_DYN + DO_INERTIA + k * NB + b];
    Ib = Ib_e;
  }
  const float m = leaf<H_MASS, DO_MASS, O_MASS>(sp, e, b);
  float com[3];
  for (int k = 0; k < 3; ++k)
    com[k] = e[E_X + 3 * b + k] + (Rm[k][0] * ipos[0] + Rm[k][1] * ipos[1] + Rm[k][2] * ipos[2]);
  float RI[3][3], Iw[3][3];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c)
      RI[a][c] = Rm[a][0] * Ib[0 * 3 + c] + Rm[a][1] * Ib[1 * 3 + c] + Rm[a][2] * Ib[2 * 3 + c];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c)
      Iw[a][c] = RI[a][0] * Rm[c][0] + RI[a][1] * Rm[c][1] + RI[a][2] * Rm[c][2];
  const float cx = com[0], cy = com[1], cz = com[2];
  const float c2 = cx * cx + cy * cy + cz * cz;
  const float sk[3][3] = {{0.f, -cz, cy}, {cz, 0.f, -cx}, {-cy, cx, 0.f}};
  float Io[6][6];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) {
      Io[a][c] = Iw[a][c] + m * ((a == c ? c2 : 0.f) - com[a] * com[c]);
      const float v = (a == c) ? 0.f : m * sk[a][c];
      Io[a][3 + c] = v;
      Io[3 + a][c] = -v;
      Io[3 + a][3 + c] = (a == c) ? m : 0.f;
    }
  float* IC = e + E_IC + 36 * b;
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 6; ++c) IC[6 * r + c] = Io[r][c];
  const float* zet = e + E_ZETA + 6 * b;
  const float* V = e + E_V + 6 * b;
  float xin[6];
  for (int k = 0; k < 3; ++k) {
    xin[k] = zet[k];
    xin[3 + k] = zet[3 + k] - leaf<H_GRAV, DO_GRAV, P_G>(sp, e, k);
  }
  float net[6], Iov[6];
  for (int r = 0; r < 6; ++r) {
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < 6; ++k) { a1 += Io[r][k] * xin[k]; a2 += Io[r][k] * V[k]; }
    net[r] = a1; Iov[r] = a2;
  }
  float c1[3], c2v[3], c3[3];
  cross3(V, Iov, c1);
  cross3(V + 3, Iov + 3, c2v);
  cross3(V, Iov + 3, c3);
  for (int k = 0; k < 3; ++k) {
    net[k] = net[k] + c1[k] + c2v[k];
    net[3 + k] = net[3 + k] + c3[k];
  }
  for (int k = 0; k < 6; ++k) e[E_NET + 6 * b + k] = net[k] - e[E_XFRC + k * NB + b];
}

// Cone projection of one contact; a bilateral (anchor) contact is left
// unprojected (fused.py:1398-1410).
__device__ __forceinline__ void project(float t1, float t2, float n, float mu, float act,
                                        bool bil, float* o) {
  const float ln = bil ? n : fmaxf(n, 0.f);
  const float tn = sqrtf(t1 * t1 + t2 * t2 + 1e-12f);
  const float sc = (bil ? 1.f : fminf(mu * ln / tn, 1.f)) * act;
  o[0] = t1 * sc; o[1] = t2 * sc; o[2] = ln * act;
}

// kind of contact i: plane row, pair row, SDF row or bilateral anchor
__device__ __forceinline__ bool is_pair(int i) { return NPP > 0 && i >= NC && i < NC + NPP; }
__device__ __forceinline__ bool is_sdf(int i) { return NSP > 0 && i >= NC + NPP && i < NUNI; }
__device__ __forceinline__ bool is_anchor(int i) { return NATT > 0 && i >= NUNI && i < NCT; }

// Pair row j: the candidate point xw (world) against the analytic geom of
// body B (fused.py:932-1077). Gives phi, the surface point xs and the frame
// (t1, t2, n), all in world coordinates; n points from the geom to the point.
__device__ void pair_row(const float* __restrict__ sp, const float* __restrict__ e, int j,
                         const float* xw, float radius, float* phi, float* xs, float* t1,
                         float* t2, float* nw) {
  const int bB = (int)sp[O_PPB + j];
  const float* bQ = e + E_QT + 4 * bB;
  float rr[3], Xg[3], Qg[4], d[3], dv[3];
  qrot(bQ, sp + O_PPGPOS + 3 * j, rr);
  for (int k = 0; k < 3; ++k) Xg[k] = e[E_X + 3 * bB + k] + rr[k];
  qmul(bQ, sp + O_PPGQUAT + 4 * j, Qg);
  const float Qc[4] = {-Qg[0], -Qg[1], -Qg[2], Qg[3]};
  for (int k = 0; k < 3; ++k) d[k] = xw[k] - Xg[k];
  qrot(Qc, d, dv);  // the point in the geom's frame
  const float* half = sp + O_PPGSIZE + 3 * j;
  float half_e[3];
  if constexpr (H_GSIZE) {
    const int g = (int)sp[O_PPGEOM + j];
    for (int k = 0; k < 3; ++k) half_e[k] = e[E_DYN + DO_GSIZE + k * NG + g];
    half = half_e;
  }
  const int gt = (int)sp[O_PPTYPE + j];
  float nl[3], surf[3];
  if (gt == GEOM_BOX) {
    float cb[3], rel[3], gaps[3];
    for (int k = 0; k < 3; ++k) {
      cb[k] = fminf(fmaxf(dv[k], -half[k]), half[k]);
      rel[k] = dv[k] - cb[k];
      gaps[k] = half[k] - fabsf(dv[k]);
    }
    if (gaps[0] > 0.f && gaps[1] > 0.f && gaps[2] > 0.f) {
      // inside: leave through the nearest face
      const int kk = (gaps[0] <= gaps[1] && gaps[0] <= gaps[2]) ? 0
                     : ((gaps[1] < gaps[0] && gaps[1] <= gaps[2]) ? 1 : 2);
      for (int k = 0; k < 3; ++k) {
        const float sg = dv[k] >= 0.f ? 1.f : -1.f;
        nl[k] = k == kk ? sg : 0.f;
        surf[k] = k == kk ? sg * half[k] : dv[k];
      }
      *phi = radius + fminf(gaps[0], fminf(gaps[1], gaps[2]));
    } else {
      const float dist = sqrtf(rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2] + 1e-18f);
      const float inv = 1.f / fmaxf(dist, 1e-9f);
      for (int k = 0; k < 3; ++k) { nl[k] = rel[k] * inv; surf[k] = cb[k]; }
      *phi = radius - dist;
    }
  } else if (gt == GEOM_CYLINDER) {
    // axis along local z: radius half[0], half-height half[1]
    const float dxy = sqrtf(dv[0] * dv[0] + dv[1] * dv[1] + 1e-18f);
    if (dxy < half[0] && fabsf(dv[2]) < half[1]) {
      const float gap_r = half[0] - dxy, gap_z = half[1] - fabsf(dv[2]);
      const float big = dxy > 1e-6f ? 1.f : 0.f;
      const float inv_dxy = 1.f / fmaxf(dxy, 1e-9f);
      const float rd0 = big * dv[0] * inv_dxy + (1.f - big), rd1 = big * dv[1] * inv_dxy;
      const float sgz = dv[2] > 0.f ? 1.f : (dv[2] < 0.f ? -1.f : 0.f);
      if (gap_r < gap_z) {  // leave through the side
        nl[0] = rd0; nl[1] = rd1; nl[2] = 0.f;
        surf[0] = rd0 * half[0]; surf[1] = rd1 * half[0]; surf[2] = dv[2];
      } else {  // leave through a cap
        nl[0] = 0.f; nl[1] = 0.f; nl[2] = sgz;
        surf[0] = dv[0]; surf[1] = dv[1]; surf[2] = sgz * half[1];
      }
      *phi = radius + fminf(gap_r, gap_z);
    } else {
      const float sc = fminf(1.f, half[0] / fmaxf(dxy, 1e-9f));
      surf[0] = dv[0] * sc; surf[1] = dv[1] * sc;
      surf[2] = fminf(fmaxf(dv[2], -half[1]), half[1]);
      const float r0 = dv[0] - surf[0], r1 = dv[1] - surf[1], r2 = dv[2] - surf[2];
      const float dist = sqrtf(r0 * r0 + r1 * r1 + r2 * r2 + 1e-18f);
      const float inv = 1.f / fmaxf(dist, 1e-9f);
      nl[0] = r0 * inv; nl[1] = r1 * inv; nl[2] = r2 * inv;
      *phi = radius - dist;
    }
  } else {  // sphere of radius half[0]
    const float dist = sqrtf(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2] + 1e-18f);
    const float inv = 1.f / fmaxf(dist, 1e-9f);
    for (int k = 0; k < 3; ++k) { nl[k] = dv[k] * inv; surf[k] = nl[k] * half[0]; }
    *phi = half[0] + radius - dist;
  }
  qrot(Qg, nl, nw);
  qrot(Qg, surf, rr);
  for (int k = 0; k < 3; ++k) xs[k] = Xg[k] + rr[k];
  // tangent basis: t1 = ref x n normalised, ref = z unless n is near z
  const float uz = fabsf(nw[2]) < 0.9f ? 1.f : 0.f;
  const float ref[3] = {1.f - uz, 0.f, uz};
  cross3(ref, nw, t1);
  const float tn = 1.f / fmaxf(sqrtf(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]), 1e-9f);
  for (int k = 0; k < 3; ++k) t1[k] *= tn;
  cross3(nw, t1, t2);
}

// One env, all slices. `e` is the env's shared-memory block; every lane of
// the warp calls this.
__device__ void run_env(const float* __restrict__ sp, float* __restrict__ e, int lane,
                        int n_slices, int iters, int warm_reset_every) {
  const float h = sp[P_H], h2 = sp[P_H2], inv_h = sp[P_INVH];
  const float erp = sp[P_ERP], maxdep = sp[P_MAXDEP], margin = sp[P_MARGIN];
  const float bounce_thr = sp[P_BOUNCE], limk = sp[P_LIMK], limd = sp[P_LIMD];
  const float maxv = sp[P_MAXV];
  const float ke_att = sp[P_ERPATT] / h;  // anchor error drive, erp_att / h
  const int nlev = (int)sp[P_NLEV];
  const float* betas = sp + SPEC_BASE;

  float warm[CPLA][3];  // physical impulses, zero at each call
#pragma unroll
  for (int c = 0; c < CPLA; ++c) warm[c][0] = warm[c][1] = warm[c][2] = 0.f;

  for (int sl = 0; sl < n_slices; ++sl) {
    if (warm_reset_every > 0 && sl > 0 && sl % warm_reset_every == 0) {
      // a merged window: the warm start resets where a separate call would begin
#pragma unroll
      for (int c = 0; c < CPLA; ++c) warm[c][0] = warm[c][1] = warm[c][2] = 0.f;
    }
    // ---- FK + zeta, level by level over the tree
    for (int lev = 0; lev < nlev; ++lev) {
      for (int b = lane; b < NB; b += 32)
        if ((int)sp[O_DEPTH + b] == lev) fk_body(sp, e, b);
      __syncwarp();
    }
    // ---- spatial inertia and bias wrench per body
    for (int b = lane; b < NB; b += 32) inertia_and_net(sp, e, b);
    __syncwarp();
    // ---- composite inertia, reverse topological, one entry per lane
    for (int x = lane; x < 36; x += 32)
      for (int b = NB - 1; b >= 0; --b) {
        const int p = (int)sp[O_PARENT + b];
        if (p >= 0) e[E_IC + 36 * p + x] += e[E_IC + 36 * b + x];
      }
    __syncwarp();
    // ---- F[d] = IC[body(d)] S[d]
    for (int x = lane; x < 6 * NV; x += 32) {
      const int d = x / 6, r = x % 6;
      const float* IC = e + E_IC + 36 * (int)sp[O_DOFBODY + d] + 6 * r;
      const float* S = e + E_S + 6 * d;
      float a = 0.f;
      for (int k = 0; k < 6; ++k) a += IC[k] * S[k];
      e[E_F + x] = a;
    }
    __syncwarp();
    // ---- mass matrix (symmetrised lower part) into AG, identity into MINV
    for (int x = lane; x < NV * NV; x += 32) {
      const int i = x / NV, j = x % NV;
      const int hi = i > j ? i : j, lo = i > j ? j : i;
      const float* F = e + E_F + 6 * hi;
      const float* S = e + E_S + 6 * lo;
      float a = 0.f;
      for (int r = 0; r < 6; ++r) a += F[r] * S[r];
      e[E_AG + x] = a * sp[O_DMASK + hi * NV + lo];
      e[E_MINV + x] = (i == j) ? 1.f : 0.f;
    }
    __syncwarp();
    // ---- per dof: bias C, passive forces, implicit diagonal, rhs
    for (int d = lane; d < NV; d += 32) {
      const int db = (int)sp[O_DOFBODY + d];
      float Fs[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int b = 0; b < NB; ++b)
        if (sp[O_ANC + b * NB + db] != 0.f)
          for (int k = 0; k < 6; ++k) Fs[k] += e[E_NET + 6 * b + k];
      const float* S = e + E_S + 6 * d;
      float C = 0.f;
      for (int k = 0; k < 6; ++k) C += S[k] * Fs[k];
      const int sq = (int)sp[O_SQADR + d];
      const float qs = sq >= 0 ? e[E_Q + sq] : 0.f;
      const float kst = leaf<H_STIFF, DO_STIFF, O_STIFF>(sp, e, d), lim = sp[O_LIMITED + d];
      float setp;
      if constexpr (QT) setp = sq >= 0 ? e[E_QTGT + sq] : 0.f;
      else setp = sp[O_SETPT + d];
      float tau = -kst * (qs - setp);
      const float over = fmaxf(qs - leaf<H_HI, DO_HI, O_HI>(sp, e, d), 0.f);
      const float under = fmaxf(leaf<H_LO, DO_LO, O_LO>(sp, e, d) - qs, 0.f);
      const float viol = (over > 0.f || under > 0.f) ? 1.f : 0.f;
      tau = tau + lim * (-limk * (over - under));
      const float qdv = e[E_QD + d];
      float D = leaf<H_DAMP, DO_DAMP, O_DAMP>(sp, e, d) + lim * viol * limd;
      D = D + leaf<H_FRIC, DO_FRIC, O_FRIC>(sp, e, d) / (fabsf(qdv) + 2e-3f);
      const float K = kst + lim * viol * limk;
      if constexpr (NT > 0) {
        // fixed tendons (fused.py:803-819): a spring outside the range and a
        // damper on the tendon's length, a combination of the scalar dofs;
        // each dof of a tendon forms the tendon's force itself
        for (int t = 0; t < NT; ++t) {
          const float* coef = sp + O_TCOEF + t * NV;
          if (coef[d] != 0.f) {
            float tval = 0.f, tvel = 0.f;
            for (int j = 0; j < NV; ++j) {
              const int sqj = (int)sp[O_SQADR + j];
              tval += coef[j] * (sqj >= 0 ? e[E_Q + sqj] : 0.f);
              tvel += coef[j] * e[E_QD + j];
            }
            const float tv = fmaxf(tval - sp[O_TRANGE + 2 * t + 1], 0.f) +
                             fminf(tval - sp[O_TRANGE + 2 * t], 0.f);
            const float ft = -leaf<H_TSTIFF, DO_TSTIFF, O_TSTIFF>(sp, e, t) * tv -
                             leaf<H_TDAMP, DO_TDAMP, O_TDAMP>(sp, e, t) * tvel;
            tau = tau + coef[d] * ft;
          }
        }
      }
      e[E_AG + d * NV + d] += leaf<H_ARM, DO_ARM, O_ARM>(sp, e, d) + h * D + h2 * K;
      e[E_RHS + d] = e[E_QFRC + d] + tau - D * qdv - C;
    }
    __syncwarp();
    // ---- Gauss-Jordan inverse without pivoting (fused.py:821-844)
    for (int j = 0; j < NV; ++j) {
      const float dj = 1.f / e[E_AG + j * NV + j];
      for (int x = lane; x < 3 * NV; x += 32) {
        if (x < NV) e[E_PIVA + x] = e[E_AG + j * NV + x] * dj;
        else if (x < 2 * NV) e[E_PIVI + x - NV] = e[E_MINV + j * NV + x - NV] * dj;
        else {
          const int i = x - 2 * NV;
          e[E_CC + i] = e[E_AG + i * NV + j] - (i == j ? 1.f : 0.f);
        }
      }
      __syncwarp();
      for (int x = lane; x < 2 * NV * NV; x += 32) {
        if (x < NV * NV) {
          e[E_AG + x] -= e[E_CC + x / NV] * e[E_PIVA + x % NV];
        } else {
          const int y = x - NV * NV;
          e[E_MINV + y] -= e[E_CC + y / NV] * e[E_PIVI + y % NV];
        }
      }
      __syncwarp();
    }
    // ---- unconstrained velocity
    for (int i = lane; i < NV; i += 32) {
      float a = 0.f;
      for (int j = 0; j < NV; ++j) a += e[E_MINV + i * NV + j] * e[E_RHS + j];
      e[E_QDF + i] = e[E_QD + i] + h * a;
    }
    __syncwarp();

    // contact state that outlives the solve: points, impulses, J^T lambda
    float xc[CPLA][3], lam[CPLA][3], qcon[NV];
    if constexpr (NCT > 0) {
      // ---- contact rows, a contact per lane: plane rows (frame = world
      // axes, phi = radius - z, or their terrain plane's frame), pair rows
      // (narrowphase against the geom, frame from its normal, Jacobian at
      // the surface point with the signed path) and anchors (world axes,
      // phi = 0, bilateral). First pass: J, phi, J qd_free for every row.
      float act[CPLA], mu[CPLA], s_c[CPLA], bv[CPLA][3], phic[CPLA];
      bool sel[CPLA];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int i = lane + 32 * c;
        act[c] = 0.f; mu[c] = 0.f; s_c[c] = 1.f; phic[c] = 0.f; sel[c] = i < NCT;
        xc[c][0] = xc[c][1] = xc[c][2] = 0.f;
        bv[c][0] = bv[c][1] = bv[c][2] = 0.f;
        if (i < NCT) {
          const int b = (int)sp[O_CPBODY + i];
          // the row's candidate point in the model's arrays, where per-env
          // cpoint leaves are read: a plane row is its own, a pair or SDF row picks
          const int pt = is_pair(i) ? (int)sp[O_PPPT + i - NC] : is_sdf(i) ? (int)sp[O_SPPT + i - NC - NPP] : i;
          const float* cpos = sp + O_CPPOS + 3 * i;
          float cpos_e[3];
          if constexpr (H_CPPOS) {
            if (!is_anchor(i)) {
              for (int k = 0; k < 3; ++k) cpos_e[k] = e[E_DYN + DO_CPPOS + k * NCP + pt];
              cpos = cpos_e;
            }
          }
          float rot[3];
          qrot(e + E_QT + 4 * b, cpos, rot);
          for (int k = 0; k < 3; ++k) xc[c][k] = e[E_X + 3 * b + k] + rot[k];
          float phi;
          float fr[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
          bool framed = false;  // rows rotated into fr (else the world axes)
          if (is_pair(i)) {
            const float xw[3] = {xc[c][0], xc[c][1], xc[c][2]};
            pair_row(sp, e, i - NC, xw, sp[O_CPRAD + i], &phi, xc[c], fr, fr + 3, fr + 6);
            for (int k = 0; k < 9; ++k) e[E_FR + 9 * (i - NC) + k] = fr[k];
            framed = true;
          } else if (is_sdf(i)) {
            // the row's entry plane: phi = phi0 - n . (x - x0), frame [t1, t2, n]
            const float* pl = e + E_SDF;
            const int j = i - NC - NPP;
            float dn = 0.f;
            for (int k = 0; k < 3; ++k) {
              fr[k] = pl[(7 + k) * NSP + j];
              fr[3 + k] = pl[(10 + k) * NSP + j];
              fr[6 + k] = pl[(4 + k) * NSP + j];
              dn += fr[6 + k] * (xc[c][k] - pl[(1 + k) * NSP + j]);
            }
            phi = pl[j] - dn;
            framed = true;
          } else if (is_anchor(i)) {
            phi = 0.f;
          } else if constexpr (TERR) {
            // the point's terrain plane: height, then t1, t2, n into fr
            const float* tr = e + E_TERR;
            for (int k = 0; k < 3; ++k) {
              fr[k] = tr[(4 + k) * NC + i];
              fr[3 + k] = tr[(7 + k) * NC + i];
              fr[6 + k] = tr[(1 + k) * NC + i];
            }
            phi = sp[O_CPRAD + i] - (xc[c][2] - tr[i]) * fr[8];
            framed = true;
          } else {
            phi = sp[O_CPRAD + i] - xc[c][2];
          }
          phic[c] = phi;
          act[c] = phi > -margin ? 1.f : 0.f;
          mu[c] = sp[O_CPMU + i];
          if constexpr (H_CPFRIC) {
            // a pair row averages its point's friction with the geom's static
            // one; plane and SDF rows take their point's
            if (is_pair(i)) mu[c] = 0.5f * (e[E_DYN + DO_CPFRIC + pt] + sp[O_PPGFRIC + i - NC]);
            else if (!is_anchor(i)) mu[c] = e[E_DYN + DO_CPFRIC + pt];
          }
          for (int v = 0; v < NV; ++v) {
            const float pm = sp[O_PATH + i * NV + v];
            const float* S = e + E_S + 6 * v;
            float jw[3];
            for (int k = 0; k < 3; ++k) {
              const int a = (k + 1) % 3, bb = (k + 2) % 3;
              const float crossk = S[a] * xc[c][bb] - S[bb] * xc[c][a];
              jw[k] = (S[3 + k] + crossk) * pm;
            }
            const float qdf = e[E_QDF + v];
            for (int k = 0; k < 3; ++k) {
              const float jr = framed ? fr[3 * k] * jw[0] + fr[3 * k + 1] * jw[1] + fr[3 * k + 2] * jw[2] : jw[k];
              e[E_J + v * R + k * NCT + i] = jr;
              bv[c][k] += jr * qdf;  // J qd_free, unscaled
            }
          }
          if constexpr (TOPK) {
            // predicted depth; anchors always win a slot, inactive rows fill by index
            const bool bil = is_anchor(i);
            float key = phi - fminf(bv[c][2], 0.f) * h;
            key = bil ? 1e30f : key;
            e[E_KEY + i] = (act[c] > 0.f || bil) ? key : -1e30f;
          }
        }
      }
      if constexpr (TOPK) {
        // ---- selection: a contact's rank is the number of keys that beat
        // it, ties to the lower index; rank < cap is in the solve
        __syncwarp();
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int i = lane + 32 * c;
          if (i < NCT) {
            const float ki = e[E_KEY + i];
            int rank = 0;
            for (int j = 0; j < NCT; ++j) {
              const float kj = e[E_KEY + j];
              rank += (kj > ki || (kj == ki && j < i)) ? 1 : 0;
            }
            sel[c] = rank < CAP;
            e[E_SEL + i] = sel[c] ? 1.f : 0.f;
            if (!sel[c]) act[c] = 0.f;  // no impulse, no warm start
          }
        }
      }
      __syncwarp();
      // ---- second pass, contacts in the solve: W = M^-1 J, the velocity
      // targets (restitution, anchor drive), the Jacobi scale
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int i = lane + 32 * c;
        if (i < NCT && sel[c]) {
          const float phi = phic[c];
          float dg[3];
          for (int k = 0; k < 3; ++k) {
            const int r = k * NCT + i;
            float dd = 0.f;
            for (int v = 0; v < NV; ++v) {
              float wv = 0.f;
              for (int jj = 0; jj < NV; ++jj) wv += e[E_MINV + v * NV + jj] * e[E_J + jj * R + r];
              e[E_W + v * R + r] = wv;
              dd += e[E_J + v * R + r] * wv;
            }
            dg[k] = dd;
          }
          if (is_anchor(i)) {
            // drive the anchor point's error to zero on all three axes
            const float* tgt = sp + O_ATTTGT + 3 * (i - NUNI);
            for (int k = 0; k < 3; ++k) bv[c][k] -= (tgt[k] - xc[c][k]) * ke_att;
          } else {
            // Baumgarte / approach target, Newton restitution: bv[c][2] is
            // the pre-solve normal velocity
            float vnt = phi > 0.f ? fminf(erp * phi / h, maxdep) : phi / h;
            const int pt = is_pair(i) ? (int)sp[O_PPPT + i - NC] : is_sdf(i) ? (int)sp[O_SPPT + i - NC - NPP] : i;
            const float rest = leaf<H_CPREST, DO_CPREST, O_REST>(sp, e, H_CPREST ? pt : i);
            const float vn_pre = bv[c][2];
            if (rest > 0.f && phi > -margin && vn_pre < -bounce_thr) vnt = fmaxf(vnt, -rest * vn_pre);
            bv[c][2] = vn_pre - vnt;
          }
          const float dcm = (dg[0] + dg[1] + dg[2]) / 3.f + 1e-6f;
          s_c[c] = rsqrtf(fmaxf(dcm, 1e-12f));
          e[E_SC + i] = s_c[c];
          for (int k = 0; k < 3; ++k) bv[c][k] *= s_c[c];
        }
      }
      __syncwarp();
      // ---- Lipschitz bound of the scaled system: max row sum of |A| over
      // the rows and columns in the solve
      float lip = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int i = lane + 32 * c;
        if (i < NCT && sel[c]) {
          float Jr[3][NV], acc[3] = {0.f, 0.f, 0.f};
          for (int k = 0; k < 3; ++k)
            for (int v = 0; v < NV; ++v) Jr[k][v] = e[E_J + v * R + k * NCT + i];
          for (int kc = 0; kc < 3; ++kc)
            for (int j = 0; j < NCT; ++j) {
              if constexpr (TOPK) {
                if (e[E_SEL + j] == 0.f) continue;
              }
              const int col = kc * NCT + j;
              float Wc[NV];
              for (int v = 0; v < NV; ++v) Wc[v] = e[E_W + v * R + col];
              const float sc = e[E_SC + j];
              for (int k = 0; k < 3; ++k) {
                float a = 0.f;
                for (int v = 0; v < NV; ++v) a += Jr[k][v] * Wc[v];
                acc[k] += fabsf(a * s_c[c] * sc);
              }
            }
          const float reg = 1e-6f * (s_c[c] * s_c[c]);
          for (int k = 0; k < 3; ++k) lip = fmaxf(lip, acc[k] + reg);
        }
      }
      lip = warp_max(lip);
      const float step = 1.f / fmaxf(lip, 1e-8f);

      // ---- APGD with friction-cone projection
      float yv[CPLA][3];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int i = lane + 32 * c;
        project(warm[c][0] / s_c[c], warm[c][1] / s_c[c], warm[c][2] / s_c[c], mu[c], act[c], is_anchor(i),
                lam[c]);
        for (int k = 0; k < 3; ++k) yv[c][k] = lam[c][k];
      }
      for (int it = 0; it < iters; ++it) {
        float u[NV];
        for (int v = 0; v < NV; ++v) u[v] = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int i = lane + 32 * c;
          if (i < NCT && sel[c])
            for (int k = 0; k < 3; ++k) {
              const float ys = s_c[c] * yv[c][k];
              for (int v = 0; v < NV; ++v) u[v] += e[E_W + v * R + k * NCT + i] * ys;
            }
        }
        for (int v = 0; v < NV; ++v) u[v] = warp_sum(u[v]);
        const float beta = betas[it];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int i = lane + 32 * c;
          float z[3] = {0.f, 0.f, 0.f};
          if (i < NCT && sel[c]) {
            const float reg = 1e-6f * (s_c[c] * s_c[c]);
            for (int k = 0; k < 3; ++k) {
              float a = 0.f;
              for (int v = 0; v < NV; ++v) a += e[E_J + v * R + k * NCT + i] * u[v];
              const float g = s_c[c] * a + reg * yv[c][k] + bv[c][k];
              z[k] = yv[c][k] - step * g;
            }
          }
          float ln[3];
          project(z[0], z[1], z[2], mu[c], act[c], is_anchor(i), ln);
          for (int k = 0; k < 3; ++k) {
            yv[c][k] = ln[k] + beta * (ln[k] - lam[c][k]);
            lam[c][k] = ln[k];
          }
        }
      }
      // ---- impulses back to physical units, generalized contact force
      for (int v = 0; v < NV; ++v) qcon[v] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int i = lane + 32 * c;
        for (int k = 0; k < 3; ++k) {
          lam[c][k] *= s_c[c];
          warm[c][k] = lam[c][k];
        }
        if (i < NCT && sel[c])
          for (int k = 0; k < 3; ++k)
            for (int v = 0; v < NV; ++v) qcon[v] += e[E_J + v * R + k * NCT + i] * lam[c][k];
      }
      for (int v = 0; v < NV; ++v) qcon[v] = warp_sum(qcon[v]);
    }  // NCT > 0
    // ---- new velocity (clipped), then integrate per body
    for (int i = lane; i < NV; i += 32) {
      float vnew = e[E_QDF + i];
      if constexpr (NCT > 0) {
        float a = 0.f;
        for (int j = 0; j < NV; ++j) a += e[E_MINV + i * NV + j] * qcon[j];
        vnew += a;
      }
      e[E_QD + i] = fminf(fmaxf(vnew, -maxv), maxv);
    }
    __syncwarp();
    for (int b = lane; b < NB; b += 32) {
      const int jt = (int)sp[O_JTYPE + b];
      const int qa = (int)sp[O_QADR + b], va = (int)sp[O_VADR + b];
      float* q = e + E_Q;
      const float* qd = e + E_QD;
      if (jt == FREE) {
        for (int k = 0; k < 3; ++k) q[qa + k] = q[qa + k] + h * qd[va + k];
        const float om[3] = {qd[va + 3] * h, qd[va + 4] * h, qd[va + 5] * h};
        float dq[4], quat[4], qn[4];
        qexp(om, dq);
        for (int k = 0; k < 4; ++k) quat[k] = q[qa + 3 + k];
        qnormalize(quat);
        qmul(dq, quat, qn);
        qnormalize(qn);
        for (int k = 0; k < 4; ++k) q[qa + 3 + k] = qn[k];
      } else if (jt == HINGE || jt == SLIDE) {
        q[qa] = q[qa] + h * qd[va];
      }
    }
    // ---- sensors of the last slice
    if constexpr (NCT > 0) {
      if (sl == n_slices - 1) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int i = lane + 32 * c;
          if (i < NCT) {
            const int b = (int)sp[O_CPBODY + i];
            float Fp[3] = {lam[c][0] * inv_h, lam[c][1] * inv_h, lam[c][2] * inv_h};
            const float l0 = Fp[0], l1 = Fp[1], l2 = Fp[2];
            if (is_pair(i)) {
              // row impulses are in the contact frame: back to world axes
              const float* fr = e + E_FR + 9 * (i - NC);
              for (int k = 0; k < 3; ++k) Fp[k] = fr[k] * l0 + fr[3 + k] * l1 + fr[6 + k] * l2;
            } else if (is_sdf(i)) {
              // likewise through the SDF row's entry frame t1, t2, n
              const float* pl = e + E_SDF;
              const int j = i - NC - NPP;
              for (int k = 0; k < 3; ++k)
                Fp[k] = pl[(7 + k) * NSP + j] * l0 + pl[(10 + k) * NSP + j] * l1 + pl[(4 + k) * NSP + j] * l2;
            }
            float rel[3], tq[3];
            for (int k = 0; k < 3; ++k) rel[k] = xc[c][k] - e[E_X + 3 * b + k];
            cross3(rel, Fp, tq);
            for (int k = 0; k < 3; ++k) {
              e[E_FS + k * NCT + i] = Fp[k];
              e[E_FS + (3 + k) * NCT + i] = tq[k];
            }
            if (is_pair(i) || is_sdf(i)) {
              // body B (the geom's or the grid's) takes -F, with its own torque arm
              const int bB = is_pair(i) ? (int)sp[O_PPB + i - NC] : (int)sp[O_SPB + i - NC - NPP];
              for (int k = 0; k < 3; ++k) rel[k] = xc[c][k] - e[E_X + 3 * bB + k];
              cross3(rel, Fp, tq);
              for (int k = 0; k < 3; ++k) e[E_FSB + k * NTWO + i - NC] = tq[k];
            }
          }
        }
        for (int v = lane; v < NV; v += 32) {
          float qv = 0.f;
          for (int j = 0; j < NV; ++j) qv = (j == v) ? qcon[j] : qv;
          e[E_DF + v] = qv * inv_h;
        }
        __syncwarp();
        // each (component, body) output is owned by one lane: no atomics
        for (int x = lane; x < 6 * NB; x += 32) {
          const int k = x / NB, b = x % NB;
          float a = 0.f;
          for (int i = 0; i < NCT; ++i)
            if ((int)sp[O_CPBODY + i] == b) a += e[E_FS + k * NCT + i];
          if constexpr (NTWO > 0) {
            for (int j = 0; j < NTWO; ++j) {
              const int bB = j < NPP ? (int)sp[O_PPB + j] : (int)sp[O_SPB + j - NPP];
              if (bB == b) a -= k < 3 ? e[E_FS + k * NCT + NC + j] : e[E_FSB + (k - 3) * NTWO + j];
            }
          }
          if (k < 3) e[E_BF + k * NB + b] = a;
          else e[E_BT + (k - 3) * NB + b] = a;
        }
      }
    }  // NCT > 0
    __syncwarp();
  }
  if constexpr (NCT == 0) {
    // no contacts: body force, body torque (contiguous) and dof force are zero
    for (int x = lane; x < 6 * NB; x += 32) e[E_BF + x] = 0.f;
    for (int v = lane; v < NV; v += 32) e[E_DF + v] = 0.f;
    __syncwarp();
  }
}

// (rows, N) global <-> per-env shared rows; neighbouring threads take
// neighbouring envs, the ragged edge is masked.
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* envs, int off,
                                          int rows, int env0, int n_env) {
  for (int x = threadIdx.x; x < rows * EPB; x += blockDim.x) {
    const int r = x / EPB, w = x % EPB, n = env0 + w;
    envs[w * ENV_FLOATS + off + r] = (src != nullptr && n < n_env) ? src[(size_t)r * n_env + n] : 0.f;
  }
}

__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* envs, int off,
                                           int rows, int env0, int n_env) {
  for (int x = threadIdx.x; x < rows * EPB; x += blockDim.x) {
    const int r = x / EPB, w = x % EPB, n = env0 + w;
    if (n < n_env) dst[(size_t)r * n_env + n] = envs[w * ENV_FLOATS + off + r];
  }
}

__global__ void __launch_bounds__(32 * EPB)
fused_step_kernel(const float* __restrict__ q_in, const float* __restrict__ qd_in,
                  const float* __restrict__ qfrc_in, const float* __restrict__ xfrc_in,
                  const float* __restrict__ qt_in, const float* __restrict__ dyn_in,
                  const float* __restrict__ terr_in, const float* __restrict__ sdf_in,
                  float* __restrict__ q_out, float* __restrict__ qd_out,
                  float* __restrict__ bf_out, float* __restrict__ bt_out,
                  float* __restrict__ df_out, const float* __restrict__ spec, int spec_len,
                  int n_env, int n_slices, int iters, int warm_reset_every) {
  extern __shared__ float smem[];
  const int spec_pad = (spec_len + 3) & ~3;
  float* sp = smem;
  float* envs = smem + spec_pad;
  const int env0 = blockIdx.x * EPB;
  for (int x = threadIdx.x; x < spec_len; x += blockDim.x) sp[x] = spec[x];
  load_rows(q_in, envs, E_Q, NQ, env0, n_env);
  load_rows(qd_in, envs, E_QD, NV, env0, n_env);
  load_rows(qfrc_in, envs, E_QFRC, NV, env0, n_env);
  load_rows(xfrc_in, envs, E_XFRC, 6 * NB, env0, n_env);
  if constexpr (QT) load_rows(qt_in, envs, E_QTGT, NQ, env0, n_env);
  if constexpr (DYN_ROWS > 0) load_rows(dyn_in, envs, E_DYN, DYN_ROWS, env0, n_env);
  if constexpr (TERR) load_rows(terr_in, envs, E_TERR, 10 * NC, env0, n_env);
  if constexpr (NSP > 0) load_rows(sdf_in, envs, E_SDF, 13 * NSP, env0, n_env);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (env0 + warp < n_env) run_env(sp, envs + warp * ENV_FLOATS, lane, n_slices, iters, warm_reset_every);
  __syncthreads();
  store_rows(q_out, envs, E_Q, NQ, env0, n_env);
  store_rows(qd_out, envs, E_QD, NV, env0, n_env);
  store_rows(bf_out, envs, E_BF, 3 * NB, env0, n_env);
  store_rows(bt_out, envs, E_BT, 3 * NB, env0, n_env);
  store_rows(df_out, envs, E_DF, NV, env0, n_env);
}

}  // namespace

extern "C" {

// out[0..17] = nbody, nq, nv, plane rows, pair rows, anchors, 1 with a
// q_target input, tendons, the per-env leaf bitmask, model cpoints and geoms
// (0 unless a per-env leaf indexes them), the top-K cap (0: none), 1 with
// terrain planes, SDF pair rows, envs per block, spec floats before the
// betas, per-env shared floats, rows of the packed per-env input.
int fused_step_layout(int* out) {
  out[0] = NB; out[1] = NQ; out[2] = NV; out[3] = NC; out[4] = NPP; out[5] = NATT;
  out[6] = QT ? 1 : 0; out[7] = NT; out[8] = (int)DYN; out[9] = NCP; out[10] = NG;
  out[11] = CAP; out[12] = TERR ? 1 : 0; out[13] = NSP; out[14] = EPB;
  out[15] = SPEC_BASE; out[16] = ENV_FLOATS; out[17] = DYN_ROWS;
  return 0;
}

// Launches one fused step on `stream`. Arrays are float32, (rows, n_env)
// row-major; xfrc may be null (no external wrenches); q_target (nq, n_env)
// is read only by a library built with -DFS_QT=1, which refuses a null one
// (cudaErrorInvalidValue); dyn (DYN_ROWS, n_env), the packed per-env leaves,
// likewise by a library built with a non-zero -DFS_DYN, and terr (10 NC,
// n_env), the terrain planes, by one built with -DFS_TERR=1, and sdf
// (13 NSP, n_env), the SDF planes, by one built with a non-zero -DFS_NSP.
// With warm_reset_every = k > 0 the contact warm start resets every k slices.
// Returns the CUDA error code of the launch (0 on success).
int fused_step_launch(const void* q, const void* qd, const void* qfrc, const void* xfrc,
                      const void* q_target, const void* dyn, const void* terr, const void* sdf,
                      void* q_out, void* qd_out,
                      void* bf_out, void* bt_out, void* df_out,
                      const void* spec, int spec_len, int n_env, int n_slices, int iters,
                      int warm_reset_every, void* stream) {
  if (n_env <= 0) return 0;
  if (QT && q_target == nullptr) return (int)cudaErrorInvalidValue;
  if (DYN_ROWS > 0 && dyn == nullptr) return (int)cudaErrorInvalidValue;
  if (TERR && terr == nullptr) return (int)cudaErrorInvalidValue;
  if (NSP > 0 && sdf == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (size_t)(((spec_len + 3) & ~3) + EPB * ENV_FLOATS);
  cudaError_t err = cudaFuncSetAttribute(
      fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_env + EPB - 1) / EPB;
  fused_step_kernel<<<grid, 32 * EPB, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)qd, (const float*)qfrc, (const float*)xfrc,
      (const float*)q_target, (const float*)dyn, (const float*)terr, (const float*)sdf,
      (float*)q_out, (float*)qd_out,
      (float*)bf_out, (float*)bt_out, (float*)df_out,
      (const float*)spec, spec_len, n_env, n_slices, iters, warm_reset_every);
  return (int)cudaGetLastError();
}

}  // extern "C"
