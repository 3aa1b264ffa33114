// 2D squeeze rollouts (kernel K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_rollout_kernel` of dgdm_tpu/sim/pallas2d.py,
// both of its contact solvers, as two instantiations of one kernel body
// (template parameter Solver): the coupled Newton solve (branches a-c) and
// projected Jacobi (branch d, pallas2d.py:221-334). The Pallas grid cell, one (pair, 128-pose group),
// is one thread block cluster here: G threads of a warp carry one rollout
// and share its contour and support points (lane `sub` takes p = sub,
// sub + G, ...; a count that G does not divide leaves the upper lanes one
// point short), so a group is 128 * G threads in Layout<G>::kCluster blocks
// (csrc/rollout_common.cuh). Every lane of a rollout holds the rollout's
// state and runs the 5x5 / 3x3 Cholesky solves and the line search
// redundantly; only the point sums cross lanes (float64 partial sums added
// over the xor butterfly's lane pairs by shuffles, one rounding to
// float32). The pair's finger
// coefficients, body-frame contour, support points and constants (~2.5 KB)
// sit in each block's shared memory, and so do the quantities of a
// rollout's step that stay fixed during its solve (struct Lane). The two
// group-uniform branches of the Pallas kernel keep their 128-pose
// granularity as GroupVote votes over the cluster: the settled-travel gate
// (group max of |v| and the broad-phase reachability test, two bits behind
// one barrier) and the full-vs-cheap solve gate, so results do not depend on
// the thread layout and match the Pallas semantics lane for lane (padded
// lanes vote too).
//
// G is a template parameter of the kernel body and K1 is built for G = 16:
// 256 threads a block, two blocks an SM, clusters of 8, at most 128
// registers a thread and 0 bytes of spills (csrc/rollout_common.cuh says
// what was measured against it).
//
// Bound: operations, not bytes. A call reads ~2.5 KB per pair plus 12 bytes
// per pose and writes 36 bytes per pose; each full-solve step costs a few
// thousand flops per contour point, most of them the point's contact
// geometry, which does not change during a solve. So each lane computes its
// points' geometry once per solve into a slab of shared memory (9 floats a
// point, 7 points a lane at the package's 100 contour points: 63 KB a block,
// two blocks an SM) and the six passes over the points of a solve's three
// Newton iterations read back the rows of the points in contact (below).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W against a body that
// recomputed the geometry in every pass (since removed): 358 ms against
// 528 ms at 16 pairs x 384 poses x 8,000 steps, 114 against 171 ms at 8 x
// 9,088 x 200. The slab bounds the point count: the launcher refuses a
// contour that needs more shared memory than a block may have (P > 384 on
// the H100; above ~170 points an SM holds one block, not two). Nothing of a
// step touches device memory.
//
// The Newton body's point sums. Each pass reduces its float64 sums as one
// vector (a reduce-scatter over the butterfly's lane pairs, so each total
// keeps its bits; csrc/rollout_common.cuh) and broadcasts the totals as
// float32 to every lane, which all run the Cholesky solve and the line
// search. A lane's float64 exchanges, against one butterfly (4) a sum: in a
// full-solve Newton iteration the contour pass's 23 sums (the grip load,
// the 8 force and moment sums, 14 Hessian entries) 23 against 92
// (rollout::group_sum_wide: a lane ends with two totals), the supports' 7
// sums and their load total (added in the same loop) 8 against 32, the
// line search's 6 energies 7 against 24: 38 against 148; in a cheap-solve
// iteration the 7 support sums 8 and the 3 energies 5, against 40 (the
// solve's fixed load total keeps its butterfly). SASS of this
// instantiation: 157 SHFL against 384, 163 DADD against 304, 15
// F2F.F32.F64 against 56, 108 F2F.F64.F32 against 112. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W in one process against the body before
// (one butterfly a sum; scripts/probe_kernel_ab.py): 102.8-103.8 against
// 113.0-114.2 ms at 8 pairs x 9,088 poses x 200 steps, 324.6-339.6 against
// 358.4-358.7 ms at 16 x 384 x 8,000, the outputs bitwise equal at 17, 100,
// 272 and 384 points; 122 registers and 0 spills either way. Parking the
// totals in the rollout's Lane slot and reading them back as float4 (124
// registers) was 1-5% slower than the broadcast.
//
// Contact compaction (Newton). A point out of contact (act == 0) has
// w_nn = w_tt = cap_rough = 0, so each of its 23 contour-pass terms and 3
// line-search terms is +0 or -0, and adding it leaves a float64 partial
// that starts at +0.0 bit for bit as it was. So the geometry pass, which
// visits every point because it decides contact, stores only the points in
// contact, at the next free rows of the thread's column, and the contour
// passes visit those rows: the same partials in the same order, every total
// the one of the pass over all points. A warp runs its loop as often as its
// lane with the most points in contact. Output plane 8 counts, per rollout,
// its points in contact summed over its solves (both solvers): the share
// of point visits that remain is plane 8 / (P * plane 6). Measured on an
// NVIDIA H100 80GB HBM3 at 700 W in one process against the body before
// (every row in each contour pass; scripts/probe_kernel_ab.py): 68.9-69.0
// against 103.1-104.0 ms at 8 pairs x 9,088 poses x 200 steps (1.375% of
// the full solves' point visits in contact), 209.0-211.6 against
// 324.6-336.7 ms at 16 x 384 x 8,000 (1.60%), planes 0-7 bitwise equal at
// 17, 100, 272 and 384 points; 122 registers and 0 spills either way.
//
// Jacobi (Solver = kJacobi). Every normal step is a full solve (no cheap
// path; the settled-travel gate, regrasp and snapshot are shared): the
// contact geometry and explicit elastic wedge impulse of every point, its
// global energy clamp (a min over the rollout's points: a lane min, then a
// shuffle min over the G lanes, exact in any order), the mean-field plane
// unloading, then 6 projected-Jacobi iterations, each three passes (contour
// points; supports' planar friction; supports' torsion) whose float64 sums
// feed the next. Everything a sweep reads and none writes is computed once
// a step with the plain version's expressions (so it rounds the same): each
// contour point's geometry, solve weights, clamped impulse and cap, and its
// lever-arm products rxn and rxt, in the slab (12 floats a contour point);
// each support's rotated lever arm, sw * mass, sw * inertia and its two
// caps (the load's divide, once a support a step), in registers. The
// impulses of a lane's first kJMaxK = 8 contour points and kJMaxS = 4
// supports live in registers (the sweep loops unrolled; 100 points and 64
// supports at G = 16 are 7 and 4 a lane), those of any further points in
// the slab, whose size is that of a design with none in registers: 12
// floats a contour point and 3 a support point, 96 KB a block at 100 points
// and 64 supports, two blocks an SM; the launcher refuses a count that does
// not fit a block (P > 272 at 64 supports on the H100). Each pass reduces
// its sums as one vector (rollout::group_sum_vec: 7, 7, 7 and 5 float64
// exchanges for passes A and C, the contour and the planar sweep, where 6,
// 6, 5 and 3 butterflies take 24, 24, 20 and 12); torsion's one sum keeps
// the butterfly. Measured on an NVIDIA H100 80GB HBM3 at 700 W in one
// process against the design before (everything but the geometry and
// weights recomputed in each sweep, impulses in the slab, one butterfly a
// sum; scripts/probe_kernel_ab.py): 65.8 against 85.5 ms at 8 pairs x
// 9,088 poses x 200 steps, 202-213 against 261-270 ms at 16 x 384 x 8,000,
// the outputs bitwise equal; 122 registers against 80, 0 spills either way.
// The registers were chosen so: 4 contour points' impulses in registers
// (117 registers) tied with 8, 2 supports (109) were 13-15% slower.
//
// Numerics: float32 state and elementwise physics, compiled without fast
// math and with -fmad=false, so that each expression rounds like the plain
// PyTorch version (dgdm_tpu_torch/sim/rollout2d_ref.py), which keeps the
// Pallas operand order. Sums over contour and support points accumulate in
// float64 and round once to float32 (the plain version does the same; with
// sum_group = G it also adds in this kernel's order): the squeeze is chaotic
// enough that reordered float32 sums move ~1% of the 9,000-pose grid's lanes
// by >1e-3 rad in 200 steps. rsqrt is 1/sqrtf, round is rintf (half to
// even), mod is floor-mod, max/min propagate NaN like torch.maximum/minimum.
//
// C interface (bound with ctypes by dgdm_tpu_torch/sim/rollout2d.py): the
// launch runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include "rollout_common.cuh"

namespace {

constexpr int kLane = rollout::kGroup;
constexpr int kThreadsPerRollout = 16;   // the layout K1 is built for
constexpr int kSeg = 6;      // cubic segments per finger curve
constexpr int kScal = 16;    // per-pair scalar slots (rollout2d.scene_arrays)
// contact solvers (rollout2d.SOLVER_CODES): one instantiation each
constexpr int kNewton = 0;
constexpr int kJacobi = 1;

}  // namespace

// Must match rollout2d._Params (ctypes) field for field.
struct Rollout2DParams {
  int steps, regrasp_every, snapshot_step, newton_iters, solver,
      solver_iters;
  float dt, ctrl_l, ctrl_r, x0f, x1f, h, inv_h, surf_l0, surf_r0, kp,
      damping, plane_z, gravity, k_plane, b_plane, depth_el_cap, impedance,
      eps_settled, marg;
  // Jacobi: the base solref gains of its stopping target, the crack
  // capture's saturation depth
  float k_base, b_base, rough_sat;
};

namespace {

using rollout::clampf;
using rollout::group_sum;
using rollout::mn;
using rollout::mx;
using rollout::rsq;

__device__ __forceinline__ float hub(float v, float w, float cap) {
  float av = fabsf(v);
  float q = 0.5f * w * v * v;
  float lin = cap * av - 0.5f * cap * cap / mx(w, 1e-12f);
  return (w * av <= cap) ? q : lin;
}

// Per-pair constants, filled once per block in shared memory and read from
// there where they are used.
struct Pair {
  float mass, inertia, fmass_l, fmass_r, com_bx, com_by;
  float inv_m, inv_i, inv_fml, inv_fmr;
  float mu_plane, mu_finger, mu_torsion, k_con, b_con, unload, rough, c_r2;
  float broad_a, broad_b, w_w, mg_dt;
};
constexpr int kPairFloats = sizeof(Pair) / sizeof(float);

// Quantities of one rollout's normal step that stay fixed during its solve,
// and the solve's unconstrained velocity uu. One per rollout in shared
// memory: lane 0 of the rollout fills it, all its lanes read it.
struct Lane {
  float c, s, cx, cy, ql, qr, vx, vy, om, qdl, qdr, n_total;
  float uu[5];
};
// odd stride in floats: conflict-free when every thread reads its own
constexpr int kLaneStride = (sizeof(Lane) / sizeof(float)) | 1;

// Contact geometry of one contour point and the solve's derived weights.
struct Geo {
  float rx, ry, nx, ny, tx, ty, rxn, rxt, sl, sr, tgt_n, w_nn, w_tt,
      cap_rough;
};

struct Shared {
  const float* coef;   // (2, 6, 4)
  const float* cbx;    // (P,) contour x relative to the COM
  const float* cby;
  const float* sbx;    // (S,) support x relative to the COM
  const float* sby;
  const float* sw;     // (S,) support weights
};

// The contact of one contour point with the nearer finger, from the step's
// start state (both solvers).
struct Contact {
  float rx, ry, nx, ny, rxn, rxt, tx, ty, depth, act, me_n, me_t, vn0;
  bool is_l;
};

__device__ __forceinline__ void contact_at(
    const Shared& sh, const Pair& pc, const Rollout2DParams& prm,
    const Lane& L, int p, Contact& q) {
  const float c = L.c, s = L.s;
  float cbx = sh.cbx[p], cby = sh.cby[p];
  float rx = cbx * c - cby * s;
  float ry = cbx * s + cby * c;
  float px = L.cx + rx;
  float py = L.cy + ry;
  bool x_in = (px >= prm.x0f) && (px <= prm.x1f);
  float xc = clampf(px, prm.x0f, prm.x1f);
  int seg = (int)((xc - prm.x0f) * prm.inv_h);
  seg = seg < 0 ? 0 : (seg > kSeg - 1 ? kSeg - 1 : seg);
  float t = xc - (prm.x0f + (float)seg * prm.h);
  const float* cl = sh.coef + seg * 4;
  const float* cr = sh.coef + kSeg * 4 + seg * 4;
  float f0 = ((cl[3] * t + cl[2]) * t + cl[1]) * t + cl[0];
  float d0 = (3.0f * cl[3] * t + 2.0f * cl[2]) * t + cl[1];
  float f1 = ((cr[3] * t + cr[2]) * t + cr[1]) * t + cr[0];
  float d1 = (3.0f * cr[3] * t + 2.0f * cr[2]) * t + cr[1];
  float surf_l = prm.surf_l0 + L.ql + f0;
  float surf_r = prm.surf_r0 + L.qr + f1;
  float inv_l = rsq(1.0f + d0 * d0);
  float inv_r = rsq(1.0f + d1 * d1);
  float depth_l = (surf_l - py) * inv_l;
  float depth_r = (py - surf_r) * inv_r;
  bool is_l = depth_l > depth_r;
  float depth = is_l ? depth_l : depth_r;
  float nx = is_l ? (-d0) * inv_l : d1 * inv_r;
  float ny = is_l ? inv_l : -inv_r;
  float act = (depth > 0.0f && x_in) ? 1.0f : 0.0f;
  float rxn = rx * ny - ry * nx;
  float tx = -ny, ty = nx;
  float rxt = rx * ty - ry * tx;
  float inv_fm = is_l ? pc.inv_fml : pc.inv_fmr;
  float me_n = 1.0f / (pc.inv_m + rxn * rxn * pc.inv_i + ny * ny * inv_fm);
  float me_t = 1.0f / (pc.inv_m + rxt * rxt * pc.inv_i + ty * ty * inv_fm);
  float qd_c0 = is_l ? L.qdl : L.qdr;
  float vn0 = (L.vx - L.om * ry) * nx + (L.vy + L.om * rx - qd_c0) * ny;
  q.rx = rx; q.ry = ry; q.nx = nx; q.ny = ny; q.tx = tx; q.ty = ty;
  q.rxn = rxn; q.rxt = rxt; q.depth = depth; q.act = act; q.me_n = me_n;
  q.me_t = me_t; q.vn0 = vn0; q.is_l = is_l;
}

// Returns whether the point is in contact (act != 0). One that is not has
// w_nn = w_tt = cap_rough = 0, so each of its terms in the full solve's
// contour sums is +0 or -0.
__device__ __forceinline__ bool point_geo(
    const Shared& sh, const Pair& pc, const Rollout2DParams& prm,
    const Lane& L, int p, Geo& g) {
  const float d_imp = prm.impedance;
  Contact q;
  contact_at(sh, pc, prm, L, p, q);
  g.rx = q.rx; g.ry = q.ry; g.nx = q.nx; g.ny = q.ny; g.tx = q.tx;
  g.ty = q.ty; g.rxn = q.rxn; g.rxt = q.rxt;
  g.sl = q.is_l ? 1.0f : 0.0f;
  g.sr = 1.0f - g.sl;
  g.tgt_n = (1.0f - d_imp * pc.b_con * prm.dt) * q.vn0
      + d_imp * prm.dt * pc.k_con * q.depth;
  g.w_nn = q.act * q.me_n / pc.c_r2;
  g.w_tt = q.act * q.me_t / pc.c_r2;
  float depth_el = q.act * clampf(q.depth, 0.0f, prm.depth_el_cap);
  g.cap_rough = pc.rough * q.me_t * depth_el;
  return q.act != 0.0f;
}

// A lane's contact geometry, held across the passes of a full solve: 9 of
// Geo's 14 floats per point in the thread's own column of a shared-memory
// slab ((point, field) rows of T threads, so a warp's accesses fall in
// distinct banks); the other five are recomputed with the expressions
// point_geo uses.
constexpr int kHeld = 9;

template <int T>
__device__ __forceinline__ void geo_store(float* slab, int k, const Geo& g) {
  float* q = slab + k * kHeld * T;
  q[0 * T] = g.rx; q[1 * T] = g.ry; q[2 * T] = g.nx; q[3 * T] = g.ny;
  q[4 * T] = g.sl; q[5 * T] = g.tgt_n; q[6 * T] = g.w_nn; q[7 * T] = g.w_tt;
  q[8 * T] = g.cap_rough;
}

template <int T>
__device__ __forceinline__ void geo_load(const float* slab, int k, Geo& g) {
  const float* q = slab + k * kHeld * T;
  g.rx = q[0 * T]; g.ry = q[1 * T]; g.nx = q[2 * T]; g.ny = q[3 * T];
  g.sl = q[4 * T]; g.tgt_n = q[5 * T]; g.w_nn = q[6 * T]; g.w_tt = q[7 * T];
  g.cap_rough = q[8 * T];
  g.sr = 1.0f - g.sl;
  g.rxn = g.rx * g.ny - g.ry * g.nx;
  g.tx = -g.ny;
  g.ty = g.nx;
  g.rxt = g.rx * g.ty - g.ry * g.tx;
}

__device__ __forceinline__ void point_vel(const Geo& g, const float* u,
                                          float& vn, float& vt) {
  float qd_cc = u[3] * g.sl + u[4] * g.sr;
  float vpx = u[0] - u[2] * g.ry;
  float vpy = u[1] + u[2] * g.rx - qd_cc;
  vn = vpx * g.nx + vpy * g.ny;
  vt = vpx * g.tx + vpy * g.ty;
}

__device__ __forceinline__ float e_unc(const Pair& pc, const float* u,
                                       const float* uu) {
  float d0 = u[0] - uu[0], d1 = u[1] - uu[1], d2 = u[2] - uu[2];
  float d3 = u[3] - uu[3], d4 = u[4] - uu[4];
  return 0.5f * (pc.mass * (d0 * d0 + d1 * d1) + pc.inertia * (d2 * d2)
                 + pc.fmass_l * (d3 * d3) + pc.fmass_r * (d4 * d4));
}

// One plane support point in the world frame and its friction weight.
struct Sup {
  float rsx, rsy, w_s;
};

__device__ __forceinline__ void support_geo(const Shared& sh, const Pair& pc,
                                            const Lane& L, int k, Sup& g) {
  g.rsx = sh.sbx[k] * L.c - sh.sby[k] * L.s;
  g.rsy = sh.sbx[k] * L.s + sh.sby[k] * L.c;
  float a_s = pc.inv_m + (g.rsx * g.rsx + g.rsy * g.rsy) * pc.inv_i * 0.5f;
  g.w_s = 1.0f / (pc.c_r2 * a_s);
}

// Plane friction sums of one Newton iteration at u: the force and moment,
// and the Hessian terms; with NI also the supports' total normal load (the
// torsion cap's), added in the same loop. `load(k)` is support k's normal
// load n_i. The sums reduce as one vector (rollout::group_sum_vec).
struct SupSums {
  float fx, fy, m, fac, f0, f1, f2, ni;
};

template <int G, bool NI, class Load>
__device__ __forceinline__ void support_sums(
    const Shared& sh, const Pair& pc, const Rollout2DParams& prm,
    const Lane& L, int S, int sub, const float* u, Load load, SupSums& o) {
  constexpr int N = NI ? 8 : 7;
  double s[N];
#pragma unroll
  for (int q = 0; q < N; ++q) s[q] = 0.0;
  for (int k = sub; k < S; k += G) {
    Sup g;
    support_geo(sh, pc, L, k, g);
    const float rsx = g.rsx, rsy = g.rsy;
    const float n_i = load(k);
    float cap_s = pc.mu_plane * n_i * prm.dt;
    float vsx = u[0] - u[2] * rsy;
    float vsy = u[1] + u[2] * rsx;
    float vs = sqrtf(vsx * vsx + vsy * vsy + 1e-16f);
    float fac = mn(g.w_s, cap_s / vs);
    float fx = fac * vsx, fy = fac * vsy;
    s[0] = s[0] + (double)fx;
    s[1] = s[1] + (double)fy;
    s[2] = s[2] + (double)(rsx * fy - rsy * fx);
    s[3] = s[3] + (double)fac;
    s[4] = s[4] + (double)(fac * (-rsy));
    s[5] = s[5] + (double)(fac * rsx);
    s[6] = s[6] + (double)(fac * (rsx * rsx + rsy * rsy));
    if constexpr (NI) s[7] = s[7] + (double)n_i;
  }
  float t[N];
  rollout::group_sum_vec<G, N>(s, t);
  o.fx = t[0];
  o.fy = t[1];
  o.m = t[2];
  o.fac = t[3];
  o.f0 = t[4];
  o.f1 = t[5];
  o.f2 = t[6];
  o.ni = NI ? t[N - 1] : 0.0f;
}

// Coupled semi-smooth Newton on the 5-DOF soft-constraint energy
// (pallas2d.py:359-506): u = (vx, vy, om, qdl, qdr), in/out. Lane `sub` of
// the rollout's G lanes takes the points sub, sub + G, ... The lane's
// geometry is computed once, ahead of the Newton iterations; that of its
// points in contact goes into `slab` (the thread's column), in increasing p
// from row 0, and the contour passes read back those rows only (contact
// compaction, above). Each pass reduces its sums as one vector (the
// contour pass's 23 by rollout::group_sum_wide, the supports' 8 and the
// line search's 6 by rollout::group_sum_vec), and every lane receives every
// total: the Cholesky solve and the line search run on all of them.
// Returns the lane's count of points in contact.
template <int G>
__device__ __forceinline__ int full_solve(
    const Shared& sh, const Pair& pc, const Rollout2DParams& prm,
    const Lane& L, int P, int S, int sub, float* slab, float* u) {
  constexpr int kThreads = rollout::Layout<G>::kThreads;
  const float* uu = L.uu;
  const float n_total = L.n_total;
  const float w_w = pc.w_w;
  int n_act = 0;
  for (int p = sub; p < P; p += G) {
    Geo g;
    if (!point_geo(sh, pc, prm, L, p, g)) continue;
    geo_store<kThreads>(slab, n_act, g);
    ++n_act;
  }
  for (int it = 0; it < prm.newton_iters; ++it) {
    // ---- pass over points: grip load, gradient and Hessian sums ----
    float lam_s, lnx, ftx, lny, fty, lrxn, ftrxt, g3, g4;
    float H[5][5];
    {
      // the grip load, the eight force and moment sums, then the Hessian's
      // upper triangle by rows without (3, 4)
      double s[23];
#pragma unroll
      for (int q = 0; q < 23; ++q) s[q] = 0.0;
      for (int k = 0; k < n_act; ++k) {
        Geo g;
        geo_load<kThreads>(slab, k, g);
        float vn, vt;
        point_vel(g, u, vn, vt);
        float res = mx(g.tgt_n - vn, 0.0f);
        float lam = g.w_nn * res;
        s[0] = s[0] + (double)lam;
        float cap_t = pc.mu_finger * lam + g.cap_rough;
        float f_t = clampf(g.w_tt * vt, -cap_t, cap_t);
        s[1] = s[1] + (double)(lam * g.nx);
        s[2] = s[2] + (double)(f_t * g.tx);
        s[3] = s[3] + (double)(lam * g.ny);
        s[4] = s[4] + (double)(f_t * g.ty);
        s[5] = s[5] + (double)(lam * g.rxn);
        s[6] = s[6] + (double)(f_t * g.rxt);
        s[7] = s[7] + (double)(g.sl * (lam * g.ny - f_t * g.ty));
        s[8] = s[8] + (double)(g.sr * (lam * g.ny - f_t * g.ty));
        float on_n = g.w_nn * ((res > 0.0f) ? 1.0f : 0.0f);
        float on_t = g.w_tt * ((fabsf(g.w_tt * vt) <= cap_t) ? 1.0f : 0.0f);
        float jn[5] = {g.nx, g.ny, g.rxn, -g.ny * g.sl, -g.ny * g.sr};
        float jt[5] = {g.tx, g.ty, g.rxt, -g.ty * g.sl, -g.ty * g.sr};
        int q = 9;
#pragma unroll
        for (int a = 0; a < 5; ++a) {
          float yn = on_n * jn[a];
          float yt = on_t * jt[a];
#pragma unroll
          for (int b = a; b < 5; ++b) {
            if (a == 3 && b == 4) continue;
            s[q] = s[q] + (double)(yn * jn[b] + yt * jt[b]);
            ++q;
          }
        }
      }
      float t[23];
      rollout::group_sum_wide<G, 23>(s, t);
      lam_s = t[0];
      lnx = t[1];
      ftx = t[2];
      lny = t[3];
      fty = t[4];
      lrxn = t[5];
      ftrxt = t[6];
      g3 = t[7];
      g4 = t[8];
      int q = 9;
#pragma unroll
      for (int a = 0; a < 5; ++a)
#pragma unroll
        for (int b = a; b < 5; ++b)
          H[a][b] = (a == 3 && b == 4) ? 0.0f : t[q++];
    }
    float grip = lam_s / pc.mg_dt;
    // ---- pass over plane supports: n_i, torsion cap, friction terms ----
    auto load = [&](int k) {
      return sh.sw[k] * n_total / (1.0f + pc.unload * grip);
    };
    SupSums ss;
    support_sums<G, true>(sh, pc, prm, L, S, sub, u, load, ss);
    float cap_w = pc.mu_torsion * ss.ni * prm.dt;
    float f_w = clampf(w_w * u[2], -cap_w, cap_w);
    float grad[5];
    grad[0] = pc.mass * (u[0] - uu[0]) - lnx + ftx + ss.fx;
    grad[1] = pc.mass * (u[1] - uu[1]) - lny + fty + ss.fy;
    grad[2] = pc.inertia * (u[2] - uu[2]) - lrxn + ftrxt + ss.m + f_w;
    grad[3] = pc.fmass_l * (u[3] - uu[3]) + g3;
    grad[4] = pc.fmass_r * (u[4] - uu[4]) + g4;
    H[0][0] = H[0][0] + (ss.fac + pc.mass);
    H[1][1] = H[1][1] + (ss.fac + pc.mass);
    H[0][2] = H[0][2] + ss.f0;
    H[1][2] = H[1][2] + ss.f1;
    H[2][2] = H[2][2]
        + (ss.f2 + w_w * ((fabsf(w_w * u[2]) <= cap_w) ? 1.0f : 0.0f)
           + pc.inertia);
    H[3][3] = H[3][3] + pc.fmass_l;
    H[4][4] = H[4][4] + pc.fmass_r;

    float dv[5], u1[5], u2[5];
    rollout::cholesky_solve<5>(H, grad, dv);
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      u1[a] = u[a] + dv[a];
      u2[a] = u[a] + 0.5f * dv[a];
    }

    // ---- line search {1, 0.5}: energies of u, u1, u2 (contour points,
    // then supports) ----
    double en[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) en[q] = 0.0;
    for (int k = 0; k < n_act; ++k) {
      Geo g;
      geo_load<kThreads>(slab, k, g);
      float vn, vt;
      point_vel(g, u, vn, vt);
      float res = mx(g.tgt_n - vn, 0.0f);
      float cap_t = pc.mu_finger * (g.w_nn * res) + g.cap_rough;
      en[0] = en[0]
          + (double)(0.5f * g.w_nn * res * res + hub(vt, g.w_tt, cap_t));
      point_vel(g, u1, vn, vt);
      res = mx(g.tgt_n - vn, 0.0f);
      en[1] = en[1]
          + (double)(0.5f * g.w_nn * res * res + hub(vt, g.w_tt, cap_t));
      point_vel(g, u2, vn, vt);
      res = mx(g.tgt_n - vn, 0.0f);
      en[2] = en[2]
          + (double)(0.5f * g.w_nn * res * res + hub(vt, g.w_tt, cap_t));
    }
    for (int k = sub; k < S; k += G) {
      Sup g;
      support_geo(sh, pc, L, k, g);
      const float rsx = g.rsx, rsy = g.rsy, w_s = g.w_s;
      float cap_s = pc.mu_plane * load(k) * prm.dt;
      float vsx = u[0] - u[2] * rsy, vsy = u[1] + u[2] * rsx;
      en[3] = en[3]
          + (double)hub(sqrtf(vsx * vsx + vsy * vsy + 1e-16f), w_s, cap_s);
      vsx = u1[0] - u1[2] * rsy; vsy = u1[1] + u1[2] * rsx;
      en[4] = en[4]
          + (double)hub(sqrtf(vsx * vsx + vsy * vsy + 1e-16f), w_s, cap_s);
      vsx = u2[0] - u2[2] * rsy; vsy = u2[1] + u2[2] * rsx;
      en[5] = en[5]
          + (double)hub(sqrtf(vsx * vsx + vsy * vsy + 1e-16f), w_s, cap_s);
    }
    float et[6];
    rollout::group_sum_vec<G, 6>(en, et);
    float e0 = e_unc(pc, u, uu) + et[0] + et[3] + hub(u[2], w_w, cap_w);
    float e1 = e_unc(pc, u1, uu) + et[1] + et[4] + hub(u1[2], w_w, cap_w);
    float e2 = e_unc(pc, u2, uu) + et[2] + et[5] + hub(u2[2], w_w, cap_w);
    bool best12 = e1 <= e2;
    float eb = best12 ? e1 : e2;
    bool take_new = eb <= e0;
#pragma unroll
    for (int a = 0; a < 5; ++a)
      u[a] = take_new ? (best12 ? u1[a] : u2[a]) : u[a];
  }
  return n_act;
}

// No finger contact reachable in the group: plane friction + torsion only,
// 2 Newton iterations on the 3-DOF subproblem (pallas2d.py:508-580). The
// load total, fixed for the solve, keeps the butterfly; an iteration's
// support sums and its three energies reduce as one vector each.
template <int G>
__device__ __forceinline__ void cheap_solve(
    const Shared& sh, const Pair& pc, const Rollout2DParams& prm,
    const Lane& L, int S, int sub, float* u) {
  const float* uu = L.uu;
  const float n_total = L.n_total;
  const float w_w = pc.w_w;
  auto load = [&](int k) { return sh.sw[k] * n_total; };
  double s_ni = 0.0;
  for (int k = sub; k < S; k += G) s_ni = s_ni + (double)load(k);
  float cap_w = pc.mu_torsion * group_sum<G>(s_ni) * prm.dt;
  for (int it = 0; it < 2; ++it) {
    SupSums ss;
    support_sums<G, false>(sh, pc, prm, L, S, sub, u, load, ss);
    float f_w = clampf(w_w * u[2], -cap_w, cap_w);
    float g0 = pc.mass * (u[0] - uu[0]) + ss.fx;
    float g1 = pc.mass * (u[1] - uu[1]) + ss.fy;
    float g2 = pc.inertia * (u[2] - uu[2]) + f_w + ss.m;
    float h00 = pc.mass + ss.fac;
    float h11 = pc.mass + ss.fac;
    float h02 = ss.f0, h12 = ss.f1;
    float h22 = pc.inertia
        + w_w * ((fabsf(w_w * u[2]) <= cap_w) ? 1.0f : 0.0f) + ss.f2;
    float l00i = rsq(h00);
    float l11i = rsq(h11);
    float l20 = h02 * l00i;
    float l21 = h12 * l11i;
    float l22i = rsq(mx(h22 - l20 * l20 - l21 * l21, 1e-12f));
    float y0 = -g0 * l00i;
    float y1 = -g1 * l11i;
    float y2 = (-g2 - l20 * y0 - l21 * y1) * l22i;
    float d2 = y2 * l22i;
    float d1 = (y1 - l21 * d2) * l11i;
    float d0 = (y0 - l20 * d2) * l00i;
    float u1[3] = {u[0] + d0, u[1] + d1, u[2] + d2};
    float u2[3] = {u[0] + 0.5f * d0, u[1] + 0.5f * d1, u[2] + 0.5f * d2};
    const float* cand[3] = {u, u1, u2};
    double es[3] = {0.0, 0.0, 0.0};
    for (int k = sub; k < S; k += G) {
      Sup g;
      support_geo(sh, pc, L, k, g);
      const float rsx = g.rsx, rsy = g.rsy, w_s = g.w_s;
      float cap_s = pc.mu_plane * load(k) * prm.dt;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* v = cand[q];
        float vsx = v[0] - v[2] * rsy;
        float vsy = v[1] + v[2] * rsx;
        float vs = sqrtf(vsx * vsx + vsy * vsy + 1e-16f);
        float qq = 0.5f * w_s * vs * vs;
        float lin = cap_s * vs - 0.5f * cap_s * cap_s / mx(w_s, 1e-12f);
        es[q] = es[q] + (double)((w_s * vs <= cap_s) ? qq : lin);
      }
    }
    float est[3];
    rollout::group_sum_vec<G, 3>(es, est);
    float e[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* v = cand[q];
      float av = fabsf(v[2]);
      float qw = 0.5f * w_w * v[2] * v[2];
      float linw = cap_w * av - 0.5f * cap_w * cap_w / mx(w_w, 1e-12f);
      float ec = est[q] + ((w_w * av <= cap_w) ? qw : linw);
      float d0_ = v[0] - uu[0], d1_ = v[1] - uu[1], d2_ = v[2] - uu[2];
      e[q] = ec + 0.5f * (pc.mass * (d0_ * d0_ + d1_ * d1_)
                          + pc.inertia * (d2_ * d2_));
    }
    bool b12 = e[1] <= e[2];
    float eb = b12 ? e[1] : e[2];
    bool tk = eb <= e[0];
#pragma unroll
    for (int a = 0; a < 3; ++a) u[a] = tk ? (b12 ? u1[a] : u2[a]) : u[a];
  }
}

// The Jacobi slab: kJHeld floats a contour point (rx, ry, nx, ny, sl, then
// fields that pass A holds for the later passes and pass C replaces with
// the solve's: me_n -> w_c me_n, me_t -> w_c me_t, tgt, the elastic
// impulse (scaled by the clamp in pass C), depth_el -> the crack-capture
// cap, vn0 -> lam_n, act -> lam_t), then kJSup floats a support point
// (lam_sx, lam_sy, lam_w), each in the thread's own column. The sweeps hold
// the impulses of a lane's first kJMaxK contour points and the impulses and
// step constants of its first kJMaxS support points in registers (the point
// loops unrolled); for those contour points pass C puts the lever-arm
// products rxn and rxt in the slots of lam_n and lam_t, and those supports'
// slab slots stay unused. Points beyond them (more than kJMaxK * G contour
// or kJMaxS * G support points) keep their impulses in the slab and
// recompute rxn, rxt and the support constants in each sweep, so the slab,
// and the point counts the launcher accepts, are those of a design with no
// registers held.
constexpr int kJHeld = 12;
constexpr int kJSup = 3;
enum { kRx, kRy, kNx, kNy, kSl, kWcn, kWct, kTgt, kImp, kCapr, kLamN, kLamT };
constexpr int kRxn = kLamN, kRxt = kLamT;
constexpr int kJMaxK = 8;
constexpr int kJMaxS = 4;

// One contour point's sweep update (pallas2d.py:263-289): its normal and
// friction impulses lam_n, lam_t (in/out) and its share of the five sums.
template <int T>
__device__ __forceinline__ void jacobi_contour(const float* f, float rxn,
                                               float rxt, float mu_f,
                                               const float* u, float& lam_n,
                                               float& lam_t,
                                               double (&a)[5]) {
  const float rx = f[kRx * T], ry = f[kRy * T], nx = f[kNx * T],
              ny = f[kNy * T];
  const float sl = f[kSl * T];
  const float tx = -ny, ty = nx;
  const float qd_cc = sl != 0.0f ? u[3] : u[4];
  const float vpx = u[0] - u[2] * ry;
  const float vpy = u[1] + u[2] * rx - qd_cc;
  const float vn = vpx * nx + vpy * ny;
  const float vt = vpx * tx + vpy * ty;
  const float new_n = mx(lam_n + f[kWcn * T] * (f[kTgt * T] - vn), 0.0f);
  const float d_n = new_n - lam_n;
  const float cap = mu_f * (new_n + f[kImp * T]) + f[kCapr * T];
  const float new_t = clampf(lam_t - f[kWct * T] * vt, -cap, cap);
  const float d_t = new_t - lam_t;
  const float ix = d_n * nx + d_t * tx;
  const float iy = d_n * ny + d_t * ty;
  a[0] = a[0] + (double)ix;
  a[1] = a[1] + (double)iy;
  a[2] = a[2] + (double)(d_n * rxn + d_t * rxt);
  a[3] = a[3] + (double)(sl * iy);
  a[4] = a[4] + (double)((1.0f - sl) * iy);
  lam_n = new_n;
  lam_t = new_t;
}

// The constants of support k that a step's sweeps read: its rotated lever
// arm, sw * mass, the planar cap, sw * inertia and the torsion cap, with the
// expressions of the plain version (load = sw n_total / (1 + unload grip)).
struct SupConst {
  float rsx, rsy, swm, cap_s, swi, cap_w;
};

__device__ __forceinline__ void support_const(const Shared& sh,
                                              const Pair& pc, const Lane& L,
                                              int k, float n_total,
                                              float grip, float dt,
                                              SupConst& c) {
  c.rsx = sh.sbx[k] * L.c - sh.sby[k] * L.s;
  c.rsy = sh.sbx[k] * L.s + sh.sby[k] * L.c;
  const float load = sh.sw[k] * n_total / (1.0f + pc.unload * grip);
  c.swm = sh.sw[k] * pc.mass;
  c.cap_s = pc.mu_plane * load * dt;
  c.swi = sh.sw[k] * pc.inertia;
  c.cap_w = pc.mu_torsion * load * dt;
}

// One support's planar friction update: lam_sx, lam_sy in/out, its share of
// the three sums.
__device__ __forceinline__ void jacobi_planar(const SupConst& c,
                                              const float* u, float& lam_sx,
                                              float& lam_sy,
                                              double (&a)[3]) {
  const float vsx = u[0] - u[2] * c.rsy;
  const float vsy = u[1] + u[2] * c.rsx;
  float nsx = lam_sx - c.swm * vsx;
  float nsy = lam_sy - c.swm * vsy;
  const float nrm = sqrtf(nsx * nsx + nsy * nsy + 1e-20f);
  const float sc = mn(1.0f, c.cap_s / nrm);
  nsx = nsx * sc;
  nsy = nsy * sc;
  const float d_sx = nsx - lam_sx, d_sy = nsy - lam_sy;
  a[0] = a[0] + (double)d_sx;
  a[1] = a[1] + (double)d_sy;
  a[2] = a[2] + (double)(c.rsx * d_sy - c.rsy * d_sx);
  lam_sx = nsx;
  lam_sy = nsy;
}

// Projected Jacobi with the explicit elastic wedge impulse
// (pallas2d.py:221-334): u = (vx, vy, om, qdl, qdr) in/out, from the
// step's start velocities. Lane `sub` takes the contour points and the
// support points sub, sub + G, ... Each pass reduces its sums as one vector
// (rollout::group_sum_vec), torsion's single sum by the butterfly. Returns
// the lane's count of points in contact.
template <int G>
__device__ __forceinline__ int jacobi_solve(
    const Shared& sh, const Pair& pc, const Rollout2DParams& prm,
    const Lane& L, int P, int S, int sub, float* slab, float* u) {
  constexpr int T = rollout::Layout<G>::kThreads;
  float* sup = slab + kJHeld * T * ((P + G - 1) / G);
  const float d_imp = prm.impedance, dt = prm.dt;
  const float n_total = L.n_total;
  // ---- pass A: geometry and the unclamped elastic impulse ----
  float cnt, dvx_u, dvy_u, dom_u, dqdl_u, dqdr_u;
  int n_act = 0;
  {
    // act, the impulse's x, y, moment, left and right jaw parts
    double s[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) s[q] = 0.0;
    for (int p = sub, k = 0; p < P; p += G, ++k) {
      Contact q;
      contact_at(sh, pc, prm, L, p, q);
      float tgt = (1.0f - d_imp * prm.b_base * dt) * q.vn0
          + d_imp * dt * prm.k_base * q.depth;
      float depth_el = q.act * clampf(q.depth, 0.0f, prm.depth_el_cap);
      float v_capn = d_imp * dt * pc.k_con * depth_el;
      float dv_el = mn(mx(d_imp * dt * (pc.k_con * depth_el - pc.b_con * q.vn0),
                          0.0f),
                       mx(v_capn - q.vn0, 0.0f));
      float imp = q.act * q.me_n * dv_el;
      float sl = q.is_l ? 1.0f : 0.0f;
      s[0] = s[0] + (double)q.act;
      n_act += q.act != 0.0f;
      s[1] = s[1] + (double)(imp * q.nx);
      s[2] = s[2] + (double)(imp * q.ny);
      s[3] = s[3] + (double)(imp * q.rxn);
      s[4] = s[4] + (double)(sl * imp * q.ny);
      s[5] = s[5] + (double)((1.0f - sl) * imp * q.ny);
      float* f = slab + k * kJHeld * T;
      f[kRx * T] = q.rx; f[kRy * T] = q.ry; f[kNx * T] = q.nx;
      f[kNy * T] = q.ny; f[kSl * T] = sl; f[kWcn * T] = q.me_n;
      f[kWct * T] = q.me_t; f[kTgt * T] = tgt; f[kImp * T] = imp;
      f[kCapr * T] = depth_el; f[kLamN * T] = q.vn0; f[kLamT * T] = q.act;
    }
    float t[6];
    rollout::group_sum_vec<G, 6>(s, t);
    cnt = mx(t[0], 1.0f);
    dvx_u = t[1] * pc.inv_m;
    dvy_u = t[2] * pc.inv_m;
    dom_u = t[3] * pc.inv_i;
    dqdl_u = -t[4] * pc.inv_fml;
    dqdr_u = -t[5] * pc.inv_fmr;
  }
  // ---- pass B: the global energy clamp, a min over the points ----
  float lo = INFINITY;
  for (int p = sub, k = 0; p < P; p += G, ++k) {
    const float* f = slab + k * kJHeld * T;
    float rx = f[kRx * T], ry = f[kRy * T], nx = f[kNx * T], ny = f[kNy * T];
    float act = f[kLamT * T], vn0 = f[kLamN * T];
    float dqd_pt = f[kSl * T] != 0.0f ? dqdl_u : dqdr_u;
    float dvn_ind = (dvx_u - dom_u * ry) * nx + (dvy_u + dom_u * rx - dqd_pt) * ny;
    float v_capn = d_imp * dt * pc.k_con * f[kCapr * T];
    float headroom = mx(v_capn - vn0, 0.0f);
    float ratio = (act > 0.0f && dvn_ind > 1e-9f)
        ? headroom / (dvn_ind + 1e-9f) : INFINITY;
    lo = mn(lo, ratio);
  }
  const float s_clamp = clampf(rollout::group_min<G>(lo), 0.0f, 1.0f);
  // ---- pass C: the clamped impulse, the solve's weights ----
  float grip;
  {
    // the grip load, then the clamped impulse's x, y, moment, jaw parts
    double s[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) s[q] = 0.0;
    for (int p = sub, k = 0; p < P; p += G, ++k) {
      float* f = slab + k * kJHeld * T;
      float rx = f[kRx * T], ry = f[kRy * T], nx = f[kNx * T], ny = f[kNy * T];
      float sl = f[kSl * T];
      float imp = s_clamp * f[kImp * T];
      float w_c = f[kLamT * T] / cnt;
      float me_t = f[kWct * T];
      float rxn = rx * ny - ry * nx;
      s[0] = s[0] + (double)imp;
      s[1] = s[1] + (double)(imp * nx);
      s[2] = s[2] + (double)(imp * ny);
      s[3] = s[3] + (double)(imp * rxn);
      s[4] = s[4] + (double)(sl * imp * ny);
      s[5] = s[5] + (double)((1.0f - sl) * imp * ny);
      f[kWcn * T] = w_c * f[kWcn * T];
      f[kWct * T] = w_c * me_t;
      f[kImp * T] = imp;
      f[kCapr * T] = pc.rough * me_t * mn(f[kCapr * T], prm.rough_sat);
      if (k < kJMaxK) {
        // the impulses live in registers: the slots hold rxn and rxt
        float tx = -ny, ty = nx;
        f[kRxn * T] = rxn;
        f[kRxt * T] = rx * ty - ry * tx;
      } else {
        f[kLamN * T] = 0.0f;
        f[kLamT * T] = 0.0f;
      }
    }
    float t[6];
    rollout::group_sum_vec<G, 6>(s, t);
    grip = t[0] / (dt * pc.mass * prm.gravity);
    u[0] = u[0] + t[1] * pc.inv_m;
    u[1] = u[1] + t[2] * pc.inv_m;
    u[2] = u[2] + t[3] * pc.inv_i;
    // L.uu[3..4] = qd + dt * f * inv_fm, the servo's unconstrained update
    u[3] = L.uu[3] - t[4] * pc.inv_fml;
    u[4] = L.uu[4] - t[5] * pc.inv_fmr;
  }
  for (int k = sub + kJMaxS * G, j = kJMaxS; k < S; k += G, ++j) {
    float* f = sup + j * kJSup * T;
    f[0] = 0.0f; f[T] = 0.0f; f[2 * T] = 0.0f;
  }
  // the first kJMaxS supports of the lane: constants and impulses
  SupConst sc[kJMaxS];
  float ls[kJMaxS][3];
#pragma unroll
  for (int j = 0; j < kJMaxS; ++j) {
    if (sub + j * G < S)
      support_const(sh, pc, L, sub + j * G, n_total, grip, dt, sc[j]);
#pragma unroll
    for (int q = 0; q < 3; ++q) ls[j][q] = 0.0f;
  }
  // the first kJMaxK contour points' impulses
  float lc[kJMaxK][2];
#pragma unroll
  for (int k = 0; k < kJMaxK; ++k) lc[k][0] = lc[k][1] = 0.0f;
  const float mu_f = pc.mu_finger;

  for (int it = 0; it < prm.solver_iters; ++it) {
    // ---- contour points: normal and friction impulses ----
    {
      double a[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) a[q] = 0.0;
#pragma unroll
      for (int k = 0; k < kJMaxK; ++k) {
        if (sub + k * G < P) {
          const float* f = slab + k * kJHeld * T;
          jacobi_contour<T>(f, f[kRxn * T], f[kRxt * T], mu_f, u, lc[k][0],
                            lc[k][1], a);
        }
      }
      for (int p = sub + kJMaxK * G, k = kJMaxK; p < P; p += G, ++k) {
        float* f = slab + k * kJHeld * T;
        const float rx = f[kRx * T], ry = f[kRy * T], nx = f[kNx * T],
                    ny = f[kNy * T];
        const float tx = -ny, ty = nx;
        float lam_n = f[kLamN * T], lam_t = f[kLamT * T];
        jacobi_contour<T>(f, rx * ny - ry * nx, rx * ty - ry * tx, mu_f, u,
                          lam_n, lam_t, a);
        f[kLamN * T] = lam_n;
        f[kLamT * T] = lam_t;
      }
      float t[5];
      rollout::group_sum_vec<G, 5>(a, t);
      u[0] = u[0] + t[0] * pc.inv_m;
      u[1] = u[1] + t[1] * pc.inv_m;
      u[2] = u[2] + t[2] * pc.inv_i;
      u[3] = u[3] - t[3] * pc.inv_fml;
      u[4] = u[4] - t[4] * pc.inv_fmr;
    }
    // ---- supports: planar friction ----
    {
      double a[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) a[q] = 0.0;
#pragma unroll
      for (int j = 0; j < kJMaxS; ++j)
        if (sub + j * G < S) jacobi_planar(sc[j], u, ls[j][0], ls[j][1], a);
      for (int k = sub + kJMaxS * G, j = kJMaxS; k < S; k += G, ++j) {
        float* f = sup + j * kJSup * T;
        SupConst c;
        support_const(sh, pc, L, k, n_total, grip, dt, c);
        float lam_sx = f[0], lam_sy = f[T];
        jacobi_planar(c, u, lam_sx, lam_sy, a);
        f[0] = lam_sx;
        f[T] = lam_sy;
      }
      float t[3];
      rollout::group_sum_vec<G, 3>(a, t);
      u[0] = u[0] + t[0] * pc.inv_m;
      u[1] = u[1] + t[1] * pc.inv_m;
      u[2] = u[2] + t[2] * pc.inv_i;
    }
    // ---- supports: torsion ----
    double s_w = 0.0;
#pragma unroll
    for (int j = 0; j < kJMaxS; ++j) {
      if (sub + j * G < S) {
        const float new_w = clampf(ls[j][2] - sc[j].swi * u[2], -sc[j].cap_w,
                                   sc[j].cap_w);
        s_w = s_w + (double)(new_w - ls[j][2]);
        ls[j][2] = new_w;
      }
    }
    for (int k = sub + kJMaxS * G, j = kJMaxS; k < S; k += G, ++j) {
      float* f = sup + j * kJSup * T;
      SupConst c;
      support_const(sh, pc, L, k, n_total, grip, dt, c);
      const float lam_w = f[2 * T];
      const float new_w = clampf(lam_w - c.swi * u[2], -c.cap_w, c.cap_w);
      s_w = s_w + (double)(new_w - lam_w);
      f[2 * T] = new_w;
    }
    u[2] = u[2] + group_sum<G>(s_w) * pc.inv_i;
  }
  return n_act;
}

template <int G, int Solver>
__global__ void __launch_bounds__(rollout::Layout<G>::kThreads,
                                   rollout::Layout<G>::kMinBlocks)
rollout2d_kernel(const float* __restrict__ coefs,     // (B, 2, 6, 4)
                 const float* __restrict__ contour,   // (B, P, 2)
                 const float* __restrict__ support,   // (B, S, 4)
                 const float* __restrict__ scalars,   // (B, 1, 16)
                 const float* __restrict__ poses,     // (N, 3)
                 float* __restrict__ out,             // (9, B, N)
                 int B, int P, int S, int N, Rollout2DParams prm) {
  using LO = rollout::Layout<G>;
  constexpr int kThreads = LO::kThreads;
  constexpr int kCluster = LO::kCluster;
  extern __shared__ float smem[];
  const int pair = blockIdx.y;
  const int tid = threadIdx.x;
  float* s_coef = smem;                       // 48
  float* s_scal = s_coef + 2 * kSeg * 4;      // 16
  float* s_pair = s_scal + kScal;             // kPairFloats
  int* s_vote = reinterpret_cast<int*>(s_pair + kPairFloats);  // 2 * kCluster
  float* s_lane = s_pair + kPairFloats + 2 * kCluster;   // per rollout
  float* s_cbx = s_lane + LO::kRollouts * kLaneStride;   // P
  float* s_cby = s_cbx + P;                   // P
  float* s_sbx = s_cby + P;                   // S
  float* s_sby = s_sbx + S;                   // S
  float* s_sw = s_sby + S;                    // S
  // one column a thread: Newton kHeld floats a point, ceil(P / G) points a
  // lane; Jacobi kJHeld a point, then kJSup a support point
  float* slab = s_sw + S + tid;
  for (int k = tid; k < 2 * kSeg * 4; k += kThreads)
    s_coef[k] = coefs[(size_t)pair * 2 * kSeg * 4 + k];
  if (tid < kScal) s_scal[tid] = scalars[(size_t)pair * kScal + tid];
  __syncthreads();
  const float com_bx = s_scal[3], com_by = s_scal[4];
  for (int k = tid; k < P; k += kThreads) {
    s_cbx[k] = contour[((size_t)pair * P + k) * 2 + 0] - com_bx;
    s_cby[k] = contour[((size_t)pair * P + k) * 2 + 1] - com_by;
  }
  for (int k = tid; k < S; k += kThreads) {
    s_sbx[k] = support[((size_t)pair * S + k) * 4 + 0] - com_bx;
    s_sby[k] = support[((size_t)pair * S + k) * 4 + 1] - com_by;
    s_sw[k] = support[((size_t)pair * S + k) * 4 + 2];
  }
  if (tid == 0) {
    Pair& w = *reinterpret_cast<Pair*>(s_pair);
    w.mass = s_scal[0];
    w.inertia = s_scal[1];
    w.fmass_l = s_scal[2];
    w.com_bx = com_bx;
    w.com_by = com_by;
    w.fmass_r = s_scal[5];
    w.mu_plane = s_scal[6];
    w.mu_finger = s_scal[7];
    w.mu_torsion = s_scal[8];
    w.k_con = s_scal[9];
    w.b_con = s_scal[10];
    w.unload = s_scal[11];
    w.rough = s_scal[12];
    w.c_r2 = s_scal[13];
    w.broad_a = s_scal[14];
    w.broad_b = s_scal[15];
    w.inv_m = 1.0f / w.mass;
    w.inv_i = 1.0f / w.inertia;
    w.inv_fml = 1.0f / w.fmass_l;
    w.inv_fmr = 1.0f / w.fmass_r;
    w.w_w = w.inertia / w.c_r2;
    w.mg_dt = w.mass * prm.gravity * prm.dt;
  }
  __syncthreads();

  const Shared sh{s_coef, s_cbx, s_cby, s_sbx, s_sby, s_sw};
  const Pair& pc = *reinterpret_cast<const Pair*>(s_pair);
  rollout::GroupVote<kCluster> vote;
  vote.init(s_vote);

  // thread -> (rollout of the pose group, lane of the rollout)
  const int rank = (int)rollout::cg::this_cluster().block_rank();
  const int t_grp = rank * kThreads + tid;
  const int sub = t_grp % G;
  Lane& L = *reinterpret_cast<Lane*>(s_lane + (tid / G) * kLaneStride);
  const int j = (blockIdx.x / kCluster) * kLane + t_grp / G;   // pose index
  const float pose_x = poses[(size_t)j * 3 + 0];
  const float pose_y = poses[(size_t)j * 3 + 1];
  const float theta0 = poses[(size_t)j * 3 + 2];
  const float c0 = cosf(theta0), s0 = sinf(theta0);
  const float com_x = pose_x + c0 * com_bx - s0 * com_by;
  const float com_y = pose_y + s0 * com_bx + c0 * com_by;

  float cx = com_x, cy = com_y, th = theta0;
  float vx = 0.f, vy = 0.f, om = 0.f, zb = 0.f, vz = 0.f;
  float ql = 0.f, qr = 0.f, qdl = 0.f, qdr = 0.f;
  float cnt_f = 0.f, cnt_c = 0.f;
  int n_con = 0;   // the lane's points in contact, summed over its solves
  float scx = com_x, scy = com_y, sth = theta0;
  const float dt = prm.dt;

  for (int i = 0; i < prm.steps; ++i) {
    const bool is_rg =
        prm.regrasp_every > 0 && (i % prm.regrasp_every == 0) && i > 0;
    if (is_rg) {
      ql = 0.f; qr = 0.f; qdl = 0.f; qdr = 0.f;
      vx = 0.f; vy = 0.f; om = 0.f; vz = 0.f;
    }
    // ---- settled-travel gate (group max of |v|, group-any reachability):
    // two bits that do not depend on each other, one vote
    float mot = mx(mx(fabsf(vx), fabsf(vy)), mx(fabsf(om), fabsf(vz)));
    float f_l = prm.kp * (prm.ctrl_l - ql) - prm.damping * qdl;
    float f_r = prm.kp * (prm.ctrl_r - qr) - prm.damping * qdr;
    float ql_n = ql + dt * (qdl + dt * f_l * pc.inv_fml);
    float qr_n = qr + dt * (qdr + dt * f_r * pc.inv_fmr);
    bool maybe = (cy - prm.marg <= pc.broad_a + mx(ql, ql_n))
        || (cy + prm.marg >= pc.broad_b + mn(qr, qr_n));
    // bit 0: some lane unsettled; bit 1: some lane can reach a finger
    const int gate = vote.any2(!(mot < prm.eps_settled), maybe);
    const bool travel = gate == 0 && !is_rg;

    if (travel) {
      // only the finger servos advance
      qdl = qdl + dt * f_l * pc.inv_fml;
      qdr = qdr + dt * f_r * pc.inv_fmr;
      ql = ql + dt * qdl;
      qr = qr + dt * qdr;
    } else {
      const float depth_z = prm.plane_z - zb;
      const float n_total =
          pc.mass * mx(prm.k_plane * depth_z - prm.b_plane * vz, 0.0f);
      // the rollout's lanes are done with the last step's Lane
      __syncwarp();
      if (sub == 0) {
        L.c = cosf(th); L.s = sinf(th);
        L.cx = cx; L.cy = cy; L.ql = ql; L.qr = qr;
        L.vx = vx; L.vy = vy; L.om = om; L.qdl = qdl; L.qdr = qdr;
        L.n_total = n_total;
        L.uu[0] = vx; L.uu[1] = vy; L.uu[2] = om;
        L.uu[3] = qdl + dt * f_l * pc.inv_fml;
        L.uu[4] = qdr + dt * f_r * pc.inv_fmr;
      }
      __syncwarp();
      vz = vz + dt * (-prm.gravity + n_total * pc.inv_m);
      float u[5] = {L.uu[0], L.uu[1], L.uu[2], L.uu[3], L.uu[4]};
      if (Solver == kJacobi) {
        n_con += jacobi_solve<G>(sh, pc, prm, L, P, S, sub, slab, u);
        cnt_f = cnt_f + 1.0f;
      } else {
        bool near = (cy <= pc.broad_a + ql) || (cy >= pc.broad_b + qr);
        const bool any_f = vote.any(near);
        if (any_f) {
          n_con += full_solve<G>(sh, pc, prm, L, P, S, sub, slab, u);
          cnt_f = cnt_f + 1.0f;
        } else {
          cheap_solve<G>(sh, pc, prm, L, S, sub, u);
          cnt_c = cnt_c + 1.0f;
        }
      }
      vx = u[0]; vy = u[1]; om = u[2]; qdl = u[3]; qdr = u[4];
      cx = cx + dt * vx;
      cy = cy + dt * vy;
      th = th + dt * om;
      zb = zb + dt * vz;
      ql = ql + dt * qdl;
      qr = qr + dt * qdr;
    }
    if (i + 1 == prm.snapshot_step) {
      scx = cx; scy = cy; sth = th;
    }
  }
  vote.finish();
  if (prm.snapshot_step <= 0 || prm.snapshot_step >= prm.steps) {
    scx = cx; scy = cy; sth = th;
  }
  // the rollout's points in contact over its solves, exact in float32
  // while P * steps < 2^24 (384 points x 8,000 steps: 3.1e6)
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1)
    n_con += __shfl_xor_sync(0xffffffffu, n_con, m);
  if (sub != 0) return;   // one lane of the rollout writes it out

  const float two_pi = 6.28318530717958647692f;   // float32(2 pi)
  float d_theta = sth - theta0;
  d_theta = d_theta - two_pi * rintf(d_theta / two_pi);
  const float c1 = cosf(sth), s1 = sinf(sth);
  const float sorg_x = scx - (c1 * com_bx - s1 * com_by);
  const float sorg_y = scy - (s1 * com_bx + c1 * com_by);
  const float c = cosf(th), s = sinf(th);
  const float org_x = cx - (c * com_bx - s * com_by);
  const float org_y = cy - (s * com_bx + c * com_by);
  float fth = fmodf(th, two_pi);
  if (fth != 0.0f && ((fth < 0.0f) != (two_pi < 0.0f))) fth = fth + two_pi;

  const size_t plane = (size_t)B * N;
  const size_t o = (size_t)pair * N + j;
  out[0 * plane + o] = d_theta;
  out[1 * plane + o] = sorg_x - pose_x;
  out[2 * plane + o] = sorg_y - pose_y;
  out[3 * plane + o] = fth;
  out[4 * plane + o] = org_x;
  out[5 * plane + o] = org_y;
  out[6 * plane + o] = cnt_f;
  out[7 * plane + o] = cnt_c;
  out[8 * plane + o] = (float)n_con;
}

}  // namespace

// `plan` (5 ints, may be null) receives the rollout::Plan of the launch;
// prm.solver picks the instantiation. Nothing is launched, and an error
// comes back, when P (and, for Jacobi, S) needs more shared memory than a
// block may have or the card cannot hold one cluster
// (rollout::launch_clusters).
extern "C" int rollout2d_launch(const float* coefs, const float* contour,
                                const float* support, const float* scalars,
                                const float* poses, float* out, int B, int P,
                                int S, int N, Rollout2DParams prm, int* plan,
                                void* stream) {
  constexpr int G = kThreadsPerRollout;
  using LO = rollout::Layout<G>;
  if (B <= 0 || P <= 0 || S < 0 || N <= 0 || N % kLane != 0 ||
      (prm.solver != kNewton && prm.solver != kJacobi))
    return (int)cudaErrorInvalidValue;
  const size_t held = prm.solver == kJacobi
      ? (size_t)kJHeld * ((P + G - 1) / G) + (size_t)kJSup * ((S + G - 1) / G)
      : (size_t)kHeld * ((P + G - 1) / G);
  const size_t smem =
      sizeof(float) * (2 * kSeg * 4 + kScal + kPairFloats +
                       LO::kRollouts * kLaneStride + 2 * P + 3 * S +
                       held * LO::kThreads) +
      sizeof(int) * 2 * LO::kCluster;
  const dim3 grid((N / kLane) * LO::kCluster, B);
  rollout::Plan* pl = reinterpret_cast<rollout::Plan*>(plan);
  if (prm.solver == kJacobi)
    return rollout::launch_clusters<LO>(
        rollout2d_kernel<G, kJacobi>, grid, smem, (cudaStream_t)stream, pl, G,
        coefs, contour, support, scalars, poses, out, B, P, S, N, prm);
  return rollout::launch_clusters<LO>(
      rollout2d_kernel<G, kNewton>, grid, smem, (cudaStream_t)stream, pl, G,
      coefs, contour, support, scalars, poses, out, B, P, S, N, prm);
}
