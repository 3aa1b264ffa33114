// 3D squeeze rollouts (kernel K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_rollout3d_kernel` of dgdm_tpu/sim/pallas3d.py,
// both of its contact solvers, as three instantiations of one kernel body
// (template parameter Solver): the coupled Newton solve with its fixed
// iteration count (branches a-c), the same solve with the adaptive
// `newton_tol` loop (branch e, pallas3d.py:714-731) and projected Jacobi
// (branch d, pallas3d.py:302-433; see "Jacobi" below). The Pallas grid cell, one
// (pair, 128-pose group), is one thread block cluster here: G threads of a
// warp carry one rollout and share its surface points (lane r takes
// p = r, r + G, ...), so a group is 128 * G threads in
// Layout<G>::kCluster blocks (csrc/rollout_common.cuh). Every lane of a
// rollout holds the rollout's 6-DOF state (position, quaternion, velocities,
// the two jaws) and runs the 8x8 / 6x6 Cholesky solves and the line search
// redundantly; only the point sums cross lanes (float64 partial sums, an xor
// butterfly of shuffles, one rounding to float32). The pair's fitted finger
// surfaces (2 x 24 cells x 12 coefficients), its body-frame surface points
// (P x 3, P = 256 on the verification and datagen paths) and its constants,
// ~5.5 KB, sit in each block's shared memory. The group-uniform branches of
// the Pallas kernel keep their 128-pose granularity as GroupVote votes over
// the cluster: the settled-travel gate (group max of |v|, |omega| and the
// broad-phase reachability test with the jaws' next position, two bits
// behind one barrier) and the full-vs-cheap solve gate. Padded lanes vote
// too, as in the Pallas kernel.
//
// G is a template parameter of the kernel body and K2 is built for G = 32:
// 512 threads a block, clusters of 8, at most 128 registers a thread and 0
// bytes of spills (csrc/rollout_common.cuh says what was measured against
// it).
//
// Bound: operations, not bytes. A call reads ~5 KB per pair plus 12 bytes per
// pose and writes 48 bytes per pose; a full-solve step costs a few thousand
// flops per surface point, most of them the point's contact geometry (two
// bivariate Horner surface evaluations, normals, contact frames, effective
// masses), which does not change during a solve. So each lane computes its
// points' geometry once per solve into a slab of shared memory (12 floats a
// point, and a 13th for the point's friction factor at the iterate, which
// pass A computes and passes B and C read; 8 points a lane at P = 256:
// 208 KB a block, so one block an SM) and the four passes over the points
// of each Newton iteration read it back.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W against a body that
// recomputed the geometry in every pass (since removed): 60 ms against 81 ms
// at 16 pairs x 128 poses x 2,400 steps, 656 against 909 ms at 8 x 9,088 x
// 800. The slab bounds the point count: P <= 256 fits a block's shared
// memory on the H100, which is what every caller passes; more is refused by
// the launcher.
//
// What binds are registers: 128 a thread, so that an SM holds 16 warps. Each
// pass keeps at most 26 float64 sums live (the eight finger-column sums are
// spread over passes A, B and C for that), reduces them as one vector (a
// reduce-scatter: 27 float64 exchanges a lane for each of passes A, B and
// C, where their 26, 26 and 25 butterflies take 130, 130 and 125; the line
// search's 6 energies 8, the cheap solve's 27 sums 28), and the lane on
// which each total ends parks it in shared memory (Lane::park,
// rollout::group_sum_park) until the 8x8 system is assembled; only the
// grip load and the energies reach every lane. Measured on an NVIDIA H100
// 80GB HBM3 at 700 W in one process against the body before (one butterfly
// a sum, lane 0 parking each total, the friction factor computed in passes
// A, B and C, two votes an adaptive iteration; scripts/probe_kernel_ab.py):
// 580 against 656-659 ms at 8 pairs x 9,088 poses x 800 steps, 661 against
// 746 ms at 16 x 128 x 32,000, 1,675 against 2,079 ms at the first shape
// with newton_iters 6 and newton_tol 1e-4 (T(n) = a + b n over n
// iterations a full step: b 307 against 398 ms), the outputs bitwise equal;
// 122 and 123 registers (newton_tol) against 122, 0 spills either way. The pair's constants
// (Pair), the step's fixed quantities and
// the rollout's state that a solve does not touch (Lane) wait in shared
// memory too, and the lane's index within its rollout is read from %laneid
// where it is used. Nothing of a step touches device memory.
//
// Adaptive Newton (Solver = kNewtonTol). The Newton body repeats while fewer
// than newton_iters iterations have run and the step size, the largest |du|
// of the whole 128-pose group times the group's largest accepted line-search
// step, is above newton_tol: one group vote an iteration
// (GroupVote::any2_max: each warp's accept bits and its max of |du| as
// unsigned bit patterns behind one block barrier, both in one exchange
// across the cluster behind one cluster barrier, in 4 * kCluster words of
// shared memory only this instantiation has). The iterations taken are
// counted in the rollout's Lane. With newton_tol = 0 the launcher runs kNewton, whose
// code is the fixed-count loop alone.
//
// Jacobi (Solver = kJacobi). Every normal step is a full solve (no cheap
// path; the settled-travel gate, regrasp and snapshot are shared): pass A
// computes each point's finger narrow phase and its unclamped elastic wedge
// impulse (ten float64 sums: the two contact counts, the impulse's force,
// torque and jaw components), pass B the global energy clamp s_el (a min over
// the rollout's points: a lane min and a shuffle min, exact in any order),
// pass C the grip load of the clamped impulse; then solver_iters = 8 sweeps,
// each a pass over the finger contact set and one over the plane set, whose
// float64 sums update the velocities between the two. Everything a sweep
// reads and no sweep writes is computed once a step, by passes A and C with
// the plain version's expressions (so it rounds the same), into a slab of 12
// floats a point in the thread's column of shared memory (192 KB a block at
// P = 256, one block an SM): the lever arm, the finger normal, the finger
// set's weight, target, clamped impulse and roughness cap, and the plane
// set's weight and target. The sweeps then do only the impulse updates, on
// each point's 7 impulses held in registers (the lane's 8 points unrolled;
// the plane set's tangential z impulse stays 0 and is not held), and reduce
// a set's sums as one vector (rollout::group_sum_vec: 9 and 8 float64
// exchanges where 8 and 6 butterflies take 40 and 30). Measured on an NVIDIA
// H100 80GB HBM3 at 700 W against the design before (12 floats a point:
// the narrow phase's normal and depth and the impulses, everything else
// recomputed in each of the 19 passes of a step; since replaced), in one
// process (the A/B probe, now scripts/probe_kernel_ab.py): 2,293 against
// 3,997 ms at 8 pairs x 9,088 poses x 800 steps, 4,828 against 8,419 ms at
// 16 x 128 x 32,000, the outputs bitwise equal; 114 registers against 72, 0
// spills either way. The launcher refuses more than 8 points a lane (P > 256), whose
// slab would not fit a block either.
//
// Numerics: float32 state and elementwise physics, compiled without fast
// math and with -fmad=false, so that each expression rounds like the plain
// PyTorch version (dgdm_tpu_torch/sim/rollout3d_ref.py), which keeps the
// Pallas operand order. Every sum over surface points accumulates in float64
// and rounds once to float32 (the plain version does the same; with
// sum_group = G it also adds in this kernel's order). rsqrt is 1/sqrtf;
// max/min propagate NaN like torch.maximum/minimum. The float32 constants
// the Pallas kernel folds from scalars arrive folded in Rollout3DParams
// (rollout3d_ref.constants).
//
// C interface (bound with ctypes by dgdm_tpu_torch/sim/rollout3d.py): the
// launch runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include "rollout_common.cuh"

namespace {

constexpr int kLane = rollout::kGroup;
constexpr int kThreadsPerRollout = 32;   // the layout K2 is built for
constexpr int kNSeg = 12;    // x cells of the fitted surface
constexpr int kNzSeg = 2;    // z cells
constexpr int kTotSeg = kNSeg * kNzSeg;
constexpr int kCoef = 12;    // (DEG_X + 1) x (DEG_Z + 1) per cell
constexpr int kScal = 32;    // per-pair scalar slots (rollout3d.scene_arrays_3d)
// contact solvers (rollout3d.SOLVER_CODES): one instantiation each
constexpr int kNewton = 0;
constexpr int kJacobi = 1;
constexpr int kNewtonTol = 2;
constexpr int kWarpSlots = 2 * 32;   // per-warp vote words (GroupVote)
// the adaptive loop's vote words (GroupVote::any2_max): two a block slot, by
// parity; only that instantiation has them
__host__ __device__ constexpr int tol_slots(int solver, int cs) {
  return solver == kNewtonTol ? 4 * cs : 0;
}

}  // namespace

// Must match rollout3d._Params (ctypes) field for field.
struct Rollout3DParams {
  int steps, regrasp_every, snapshot_step, newton_iters, solver,
      solver_iters;
  float newton_tol, dt, d_imp, ctrl_l, ctrl_r, kp, damping, x0f, x1f, z0f,
      z1f, hseg, hzseg, inv_hseg, inv_hzseg, surf_l0, surf_r0, plane_z,
      tgt_p_v, tgt_p_d, g_dt, gravity, d_imp_dt, v_rest, depth_el_cap,
      eps_settled, marg, tip_atol, tgt_fj_v, tgt_fj_d, rough_sat;
};

namespace {

using rollout::clampf;
using rollout::group_max;
using rollout::group_min;
using rollout::group_sum;
using rollout::lane_in_rollout;
using rollout::mn;
using rollout::mx;
using rollout::rsq;
using rollout::step01;

// Huber-like energy of one soft row (pallas3d.py:488-495), per point.
__device__ __forceinline__ float hub(float vn, float vt2, float w, float cap,
                                     float tgt) {
  float res = mx(tgt - vn, 0.0f);
  float e_n = 0.5f * w * res * res;
  float vt = sqrtf(vt2 + 1e-16f);
  float q_br = 0.5f * w * vt2;
  float lin = cap * vt - 0.5f * cap * cap / mx(w, 1e-12f);
  float e_t = (w * vt <= cap) ? q_br : lin;
  return e_n + e_t;
}

// Per-pair constants, filled once per block in shared memory and read
// from there where they are used (registers go to the float64 sums).
struct Pair {
  float mass, fmass_l, fmass_r, com_x, com_y, com_z;
  float i00, i11, i22, i01, i02, i12;       // body inverse inertia
  float ib00, ib11, ib22, ib01, ib02, ib12; // body inertia
  float mu_plane, mu_finger, rough, unload, c_r, fmax_l, fmin_r, restitution;
  float inv_m, inv_fml, inv_fmr, tgt_f_v, tgt_f_d, mg_dt;
  float k_cal, b_cal;                       // calibrated finger gains
};
constexpr int kPairFloats = sizeof(Pair) / sizeof(float);

struct Shared {
  const float* coef;   // (2, 24, 4, 3) fitted surface polynomials (l, r)
  const float* pbx;    // (P,) body points relative to the COM
  const float* pby;
  const float* pbz;
};

// The rounded sums of a full-solve iteration's passes, parked in Lane::park
// by their owner lanes: pass A's 21 Hessian sums of rows 0-2, finger
// columns 0-3 and the grip load; pass B's finger columns 4-6, 14 Hessian
// sums of rows 3-7 and 9 gradient sums; pass C's finger column 7 and its
// 5 + 6 + 13 friction and plane sums.
constexpr int kParkA = 0, kParkB = 26, kParkC = 52;

// Quantities of one rollout's normal step that stay fixed during its solve,
// and the solve's unconstrained velocity uu. One per rollout in shared
// memory: lane 0 of the rollout fills it, all its lanes read it (one
// broadcast a warp), and the registers stay with the float64 sums. `park`
// holds the rounded sums of the full solve's passes A and B (Hessian rows
// 0-2, finger columns, rows 3-7, gradient terms) while the later passes run:
// held in registers they would push the float64 sums of those passes out.
struct Lane {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;
  float w00, w01, w02, w11, w12, w22;        // world inverse inertia
  float iw00, iw01, iw02, iw11, iw12, iw22;  // world inertia
  float px, py, pz, vx, vy, vz, ox, oy, oz, ql, qr, qdl, qdr;
  float uu[8];
  float park[kParkC + 25];
  // the rollout's state that a solve does not touch (orientation, snapshot,
  // wy span) waits here while the solve runs
  float keep[12];
  float iters;   // full-solve Newton iterations taken (kNewtonTol)
  int pose;   // index of the rollout's pose
};
// odd stride in floats: conflict-free when every thread reads its own
constexpr int kLaneStride = (sizeof(Lane) / sizeof(float)) | 1;

// R M R^T of a symmetric M (upper triangle m) -> its 6 upper entries.
__device__ __forceinline__ void sandwich(const float* r, float m00, float m11,
                                         float m22, float m01, float m02,
                                         float m12, float* o) {
  float a00 = r[0] * m00 + r[1] * m01 + r[2] * m02;
  float a01 = r[0] * m01 + r[1] * m11 + r[2] * m12;
  float a02 = r[0] * m02 + r[1] * m12 + r[2] * m22;
  float a10 = r[3] * m00 + r[4] * m01 + r[5] * m02;
  float a11 = r[3] * m01 + r[4] * m11 + r[5] * m12;
  float a12 = r[3] * m02 + r[4] * m12 + r[5] * m22;
  float a20 = r[6] * m00 + r[7] * m01 + r[8] * m02;
  float a21 = r[6] * m01 + r[7] * m11 + r[8] * m12;
  float a22 = r[6] * m02 + r[7] * m12 + r[8] * m22;
  o[0] = a00 * r[0] + a01 * r[1] + a02 * r[2];
  o[1] = a00 * r[3] + a01 * r[4] + a02 * r[5];
  o[2] = a00 * r[6] + a01 * r[7] + a02 * r[8];
  o[3] = a10 * r[3] + a11 * r[4] + a12 * r[5];
  o[4] = a10 * r[6] + a11 * r[7] + a12 * r[8];
  o[5] = a20 * r[6] + a21 * r[7] + a22 * r[8];
}

// Plane-row quantities of one point (the cheap solve needs only these).
struct PGeo {
  float rx, ry, rz, w_np, tgt_pn;
};

__device__ __forceinline__ void plane_geo(const Shared& sh,
                                          const Pair& pc,
                                          const Rollout3DParams& prm,
                                          const Lane& L, int p,
                                          PGeo& g,
                                          float& wy, float& wx, float& wz) {
  float bx = sh.pbx[p], by = sh.pby[p], bz = sh.pbz[p];
  g.rx = L.r00 * bx + L.r01 * by + L.r02 * bz;
  g.ry = L.r10 * bx + L.r11 * by + L.r12 * bz;
  g.rz = L.r20 * bx + L.r21 * by + L.r22 * bz;
  wx = L.px + g.rx;
  wy = L.py + g.ry;
  wz = L.pz + g.rz;
  float depth_p = prm.plane_z - wz;
  float act_p = step01(depth_p > 0.0f);
  // contact frame r x ez = (ry, -rx, 0)
  float nrx = -g.rx;
  float wxp = L.w00 * g.ry + L.w01 * nrx;
  float wyp = L.w01 * g.ry + L.w11 * nrx;
  float ang_p = g.ry * wxp + nrx * wyp;
  float me_p = 1.0f / (pc.inv_m + ang_p);
  float vpz = L.vz + L.ox * g.ry - L.oy * g.rx;
  g.tgt_pn = prm.tgt_p_v * vpz + prm.tgt_p_d * depth_p;
  g.w_np = act_p * me_p / pc.c_r;
}

// Finger and plane rows of one point for the full solve (pallas3d.py:243-285
// and :497-520).
struct FGeo {
  float rx, ry, rz, w_np, tgt_pn;
  float nfx, nfy, nfz, cfx, cfy, cfz, sl, sr, w_nf, tgt_fn, rough_capn;
};

__device__ __forceinline__ void surface_eval(const float* c, float t, float s,
                                             float& y, float& dy_dx,
                                             float& dy_dz) {
  // c: 12 coefficients of one cell, c[a * 3 + b] for t^a s^b
  float rows[4], drows[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float row = c[a * 3 + 2];
    row = row * s + c[a * 3 + 1];
    row = row * s + c[a * 3 + 0];
    rows[a] = row;
    drows[a] = c[a * 3 + 2] * 2.0f * s + c[a * 3 + 1] * 1.0f;
  }
  y = rows[3];
  dy_dx = rows[3] * 3.0f;
  dy_dz = drows[3];
#pragma unroll
  for (int a = 2; a >= 0; --a) {
    y = y * t + rows[a];
    if (a > 0) dy_dx = dy_dx * t + rows[a] * (float)a;
    dy_dz = dy_dz * t + drows[a];
  }
}

// The finger narrow phase of one point at world position (wx, wy, wz)
// (pallas3d.py:243-278): two surface evaluations and the merged contact set
// (a point can touch only the deeper jaw): its normal, depth and activity.
struct Narrow {
  float nfx, nfy, nfz, depth_f, act_f;
  bool is_l;
};

__device__ __forceinline__ void finger_narrow(const Shared& sh,
                                              const Rollout3DParams& prm,
                                              const Lane& L, float wx,
                                              float wy, float wz, Narrow& o) {
  bool in_dom = (wx >= prm.x0f) && (wx <= prm.x1f) && (wz >= prm.z0f) &&
                (wz <= prm.z1f);
  float xc = clampf(wx, prm.x0f, prm.x1f);
  float zc = clampf(wz, prm.z0f, prm.z1f);
  int xsg = (int)((xc - prm.x0f) * prm.inv_hseg);
  xsg = xsg < 0 ? 0 : (xsg > kNSeg - 1 ? kNSeg - 1 : xsg);
  int zsg = (int)((zc - prm.z0f) * prm.inv_hzseg);
  zsg = zsg < 0 ? 0 : (zsg > kNzSeg - 1 ? kNzSeg - 1 : zsg);
  int seg = xsg * kNzSeg + zsg;
  float t = xc - (prm.x0f + (float)xsg * prm.hseg);
  float s = zc - (prm.z0f + (float)zsg * prm.hzseg);
  float fl, slx, slz, fr, srx, srz;
  surface_eval(sh.coef + seg * kCoef, t, s, fl, slx, slz);
  surface_eval(sh.coef + (kTotSeg + seg) * kCoef, t, s, fr, srx, srz);

  float surf_l = prm.surf_l0 + L.ql + fl;
  float surf_r = prm.surf_r0 + L.qr + fr;
  float inv_nl = rsq(1.0f + slx * slx + slz * slz);
  float inv_nr = rsq(1.0f + srx * srx + srz * srz);
  float depth_l = (surf_l - wy) * inv_nl;
  float depth_r = (wy - surf_r) * inv_nr;
  o.is_l = depth_l > depth_r;
  o.depth_f = o.is_l ? depth_l : depth_r;
  o.nfx = o.is_l ? (-slx) * inv_nl : srx * inv_nr;
  o.nfy = o.is_l ? inv_nl : -inv_nr;
  o.nfz = o.is_l ? (-slz) * inv_nl : srz * inv_nr;
  o.act_f = step01(o.depth_f > 0.0f && in_dom);
}

// The effective mass along a finger normal and the point's pre-update
// normal velocity (pallas3d.py:279-285), from its lever arm r.
__device__ __forceinline__ void finger_mass(const Pair& pc, const Lane& L,
                                            float rx, float ry, float rz,
                                            const Narrow& o, float& me_f,
                                            float& vn_f0) {
  float cfx = ry * o.nfz - rz * o.nfy;
  float cfy = rz * o.nfx - rx * o.nfz;
  float cfz = rx * o.nfy - ry * o.nfx;
  float wfx = L.w00 * cfx + L.w01 * cfy + L.w02 * cfz;
  float wfy = L.w01 * cfx + L.w11 * cfy + L.w12 * cfz;
  float wfz = L.w02 * cfx + L.w12 * cfy + L.w22 * cfz;
  float ang_f = cfx * wfx + cfy * wfy + cfz * wfz;
  float inv_fm = o.is_l ? pc.inv_fml : pc.inv_fmr;
  me_f = 1.0f / (pc.inv_m + ang_f + o.nfy * o.nfy * inv_fm);
  float qd_c0 = o.is_l ? L.qdl : L.qdr;
  float vpx = L.vx + L.oy * rz - L.oz * ry;
  float vpy = L.vy + L.oz * rx - L.ox * rz;
  float vpz = L.vz + L.ox * ry - L.oy * rx;
  vn_f0 = vpx * o.nfx + (vpy - qd_c0) * o.nfy + vpz * o.nfz;
}

__device__ __forceinline__ void full_geo(const Shared& sh,
                                         const Pair& pc,
                                         const Rollout3DParams& prm,
                                         const Lane& L, int p,
                                         FGeo& g) {
  PGeo pg;
  float wx, wy, wz;
  plane_geo(sh, pc, prm, L, p, pg, wy, wx, wz);
  g.rx = pg.rx; g.ry = pg.ry; g.rz = pg.rz;
  g.w_np = pg.w_np; g.tgt_pn = pg.tgt_pn;
  Narrow o;
  finger_narrow(sh, prm, L, wx, wy, wz, o);
  float me_f, vn_f0;
  finger_mass(pc, L, pg.rx, pg.ry, pg.rz, o, me_f, vn_f0);
  g.tgt_fn = pc.tgt_f_v * vn_f0 + pc.tgt_f_d * o.depth_f +
             pc.restitution * mx(-vn_f0 - prm.v_rest, 0.0f);
  g.w_nf = o.act_f * me_f / pc.c_r;
  float depth_eln = o.act_f * clampf(o.depth_f, 0.0f, prm.depth_el_cap);
  g.rough_capn = pc.rough * me_f * depth_eln;
  g.nfx = o.nfx; g.nfy = o.nfy; g.nfz = o.nfz;
  g.sl = step01(o.is_l);
  g.sr = 1.0f - g.sl;
}

// A lane's contact geometry, held across the passes of a full solve: 12 of
// FGeo's 16 floats per point in the thread's own column of a shared-memory
// slab ((point, field) rows of T threads, so a warp's accesses fall in
// distinct banks); the other four are recomputed with the expressions
// full_geo uses. A 13th float a point (kFac) holds the point's finger
// friction factor at the iterate: pass A computes it, passes B and C read it.
constexpr int kFac = 12;
constexpr int kHeld = 13;

template <int T>
__device__ __forceinline__ void geo_store(float* slab, int k, const FGeo& g) {
  float* q = slab + k * kHeld * T;
  q[0 * T] = g.rx; q[1 * T] = g.ry; q[2 * T] = g.rz;
  q[3 * T] = g.w_np; q[4 * T] = g.tgt_pn;
  q[5 * T] = g.nfx; q[6 * T] = g.nfy; q[7 * T] = g.nfz;
  q[8 * T] = g.sl; q[9 * T] = g.w_nf; q[10 * T] = g.tgt_fn;
  q[11 * T] = g.rough_capn;
}

template <int T>
__device__ __forceinline__ void geo_load(const float* slab, int k, FGeo& g) {
  const float* q = slab + k * kHeld * T;
  g.rx = q[0 * T]; g.ry = q[1 * T]; g.rz = q[2 * T];
  g.w_np = q[3 * T]; g.tgt_pn = q[4 * T];
  g.nfx = q[5 * T]; g.nfy = q[6 * T]; g.nfz = q[7 * T];
  g.sl = q[8 * T]; g.w_nf = q[9 * T]; g.tgt_fn = q[10 * T];
  g.rough_capn = q[11 * T];
  g.sr = 1.0f - g.sl;
  g.cfx = g.ry * g.nfz - g.rz * g.nfy;
  g.cfy = g.rz * g.nfx - g.rx * g.nfz;
  g.cfz = g.rx * g.nfy - g.ry * g.nfx;
}

// Contact velocities and forces of one point at the iterate u.
struct Terms {
  float fx, fy, fz, pvy, vnf, vtfx, vtfy, vtfz, resf, lamf, resp, lamp;
};

__device__ __forceinline__ void terms(const FGeo& g, const float* u,
                                      Terms& t) {
  float vpx = u[0] + u[4] * g.rz - u[5] * g.ry;
  float vpy = u[1] + u[5] * g.rx - u[3] * g.rz;
  float vpz = u[2] + u[3] * g.ry - u[4] * g.rx;
  float qd_pt = u[6] * g.sl + u[7] * g.sr;
  t.fx = vpx;
  t.fy = vpy - qd_pt;
  t.fz = vpz;
  t.pvy = vpy;
  t.vnf = t.fx * g.nfx + t.fy * g.nfy + t.fz * g.nfz;
  t.vtfx = t.fx - t.vnf * g.nfx;
  t.vtfy = t.fy - t.vnf * g.nfy;
  t.vtfz = t.fz - t.vnf * g.nfz;
  t.resf = mx(g.tgt_fn - t.vnf, 0.0f);
  t.lamf = g.w_nf * t.resf;
  t.resp = mx(g.tgt_pn - t.fz, 0.0f);
  t.lamp = g.w_np * t.resp;
}

__device__ __forceinline__ float fac_finger(const Pair& pc, const FGeo& g,
                                            const Terms& t) {
  float capf = pc.mu_finger * t.lamf + g.rough_capn;
  float vtfn =
      sqrtf(t.vtfx * t.vtfx + t.vtfy * t.vtfy + t.vtfz * t.vtfz + 1e-16f);
  return mn(g.w_nf, capf / vtfn);
}

__device__ __forceinline__ float fac_plane(const FGeo& g, const Terms& t,
                                           float capp_scale) {
  float capp = capp_scale * t.lamp;
  float vtpn = sqrtf(t.fx * t.fx + t.pvy * t.pvy + 1e-16f);
  return mn(g.w_np, capp / vtpn);
}

// Full-solve energy rows of one point at a candidate v with caps from u.
__device__ __forceinline__ void energy_rows(const Pair& pc, const FGeo& g,
                                            const float* v, float capf,
                                            float capp, float& ef, float& ep) {
  Terms t;
  terms(g, v, t);
  float vtf2 = t.vtfx * t.vtfx + t.vtfy * t.vtfy + t.vtfz * t.vtfz;
  ef = hub(t.vnf, vtf2, g.w_nf, capf, g.tgt_fn);
  float vtp2 = t.fx * t.fx + t.pvy * t.pvy;
  ep = hub(t.fz, vtp2, g.w_np, capp, g.tgt_pn);
}

__device__ __forceinline__ float e_quad(const Pair& pc, const Lane& L,
                                        const float* u, const float* uu) {
  float d[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) d[a] = u[a] - uu[a];
  float ix = L.iw00 * d[3] + L.iw01 * d[4] + L.iw02 * d[5];
  float iy = L.iw01 * d[3] + L.iw11 * d[4] + L.iw12 * d[5];
  float iz = L.iw02 * d[3] + L.iw12 * d[4] + L.iw22 * d[5];
  return 0.5f * (pc.mass * (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) +
                 d[3] * ix + d[4] * iy + d[5] * iz +
                 pc.fmass_l * (d[6] * d[6]) + pc.fmass_r * (d[7] * d[7]));
}

// Coupled semi-smooth Newton on the 8-DOF soft-constraint energy
// (pallas3d.py:497-737): u = (vx, vy, vz, ox, oy, oz, qdl, qdr), in/out.
// Lane r of the rollout's G lanes takes the points r, r + G, ...
// The lane's geometry is computed once, ahead of the passes, into `slab`
// (the thread's column), and the passes read it back; pass A adds each
// point's friction factor at the iterate (kFac), which passes B and C read.
// Each pass reduces its float64 sums as one vector whose owner lanes park
// the totals in L.park (rollout::group_sum_park); only the grip load and
// the line-search energies reach every lane. With Tol the loop ends early
// once the group's step size falls to prm.newton_tol (pallas3d.py:703-731):
// one vote an iteration carries the accepted steps and the largest |du|.
// Returns the iterations run.
template <int G, bool Tol>
__device__ int full_solve(const Shared& sh, const Pair& pc,
                          const Rollout3DParams& prm, Lane& L, int P,
                          float* slab, const float* uu, float* u,
                          rollout::GroupVote<rollout::Layout<G>::kCluster>& vote,
                          unsigned* warp_slots, unsigned* pair_slots) {
  constexpr int kThreads = rollout::Layout<G>::kThreads;
  for (int p = lane_in_rollout<G>(), k = 0; p < P; p += G, ++k) {
    FGeo g;
    full_geo(sh, pc, prm, L, p, g);
    geo_store<kThreads>(slab, k, g);
  }
  float* park = L.park;
  for (int it = 0; it < prm.newton_iters; ++it) {
    // the rollout's lanes have read the last iteration's parked sums
    __syncwarp();
    // ---- pass A: Hessian rows 0-2, finger columns 0-3, the grip load (the
    // eight finger-column sums are spread over passes A, B and C so that no
    // pass holds more than 26 float64 sums) ----
    float grip;
    {
      double s[26];
#pragma unroll
      for (int q = 0; q < 26; ++q) s[q] = 0.0;
      for (int p = lane_in_rollout<G>(), k = 0; p < P; p += G, ++k) {
        FGeo g;
        geo_load<kThreads>(slab, k, g);
        Terms t;
        terms(g, u, t);
        float fac_f = fac_finger(pc, g, t);
        slab[(k * kHeld + kFac) * kThreads] = fac_f;
        float cn_f = g.w_nf * step01(t.resf > 0.0f) - fac_f;
        float jf[8] = {g.nfx, g.nfy, g.nfz, g.cfx, g.cfy, g.cfz,
                       -g.nfy * g.sl, -g.nfy * g.sr};
        int q = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float yf = cn_f * jf[a];
#pragma unroll
          for (int b = a; b < 8; ++b) s[q++] += (double)(yf * jf[b]);
        }
        s[21] += (double)(fac_f * (-g.sl));
        s[22] += (double)(fac_f * (-g.sr));
        s[23] += (double)(fac_f * g.sl * g.rz);
        s[24] += (double)(fac_f * g.sl * (-g.rx));
        s[25] = s[25] + (double)t.lamf;
      }
      const float v = rollout::group_sum_park<G, 26>(s, park + kParkA);
      grip = __shfl_sync(0xffffffffu, v,
                         rollout::detail::vec_owner<G / 2, 26>(25), G) /
             pc.mg_dt;
    }
    const float scale_p = 1.0f / (1.0f + pc.unload * grip);
    const float capp_scale = pc.mu_plane * scale_p;

    // ---- pass B: finger columns 4-6, Hessian rows 3-7, gradient terms
    // without the plane cap ----
    {
      double s[26];
#pragma unroll
      for (int q = 0; q < 26; ++q) s[q] = 0.0;
      for (int p = lane_in_rollout<G>(), k = 0; p < P; p += G, ++k) {
        FGeo g;
        geo_load<kThreads>(slab, k, g);
        Terms t;
        terms(g, u, t);
        const float fac_f = slab[(k * kHeld + kFac) * kThreads];
        float cn_f = g.w_nf * step01(t.resf > 0.0f) - fac_f;
        float jf[8] = {g.nfx, g.nfy, g.nfz, g.cfx, g.cfy, g.cfz,
                       -g.nfy * g.sl, -g.nfy * g.sr};
        s[0] += (double)(fac_f * g.sr * g.rz);
        s[1] += (double)(fac_f * g.sr * (-g.rx));
        s[2] += (double)(fac_f * g.sl);
        int q = 3;
#pragma unroll
        for (int a = 3; a < 8; ++a) {
          float yf = cn_f * jf[a];
#pragma unroll
          for (int b = a; b < 8; ++b) {
            if (a == 6 && b == 7) continue;
            s[q++] += (double)(yf * jf[b]);
          }
        }
        s[17] += (double)(t.lamf * g.nfx);
        s[18] += (double)(t.lamf * g.nfy);
        s[19] += (double)(t.lamf * g.nfz + t.lamp);
        s[20] += (double)(fac_f * t.vtfz);
        s[21] += (double)(t.lamf * g.cfx + t.lamp * g.ry);
        s[22] += (double)(t.lamf * g.cfy - t.lamp * g.rx);
        s[23] += (double)(t.lamf * g.cfz);
        s[24] += (double)(g.sl * (t.lamf * g.nfy - fac_f * t.vtfy));
        s[25] += (double)(g.sr * (t.lamf * g.nfy - fac_f * t.vtfy));
      }
      rollout::group_sum_park<G, 26>(s, park + kParkB);
    }

    // ---- pass C: finger column 7, friction terms with the plane cap, plane
    // Hessian ----
    {
      double s[25];
#pragma unroll
      for (int q = 0; q < 25; ++q) s[q] = 0.0;
      for (int p = lane_in_rollout<G>(), k = 0; p < P; p += G, ++k) {
        FGeo g;
        geo_load<kThreads>(slab, k, g);
        Terms t;
        terms(g, u, t);
        const float rx = g.rx, ry = g.ry, rz = g.rz;
        const float fac_f = slab[(k * kHeld + kFac) * kThreads];
        float fac_p = fac_plane(g, t, capp_scale);
        float vtpx = t.fx, vtpy = t.pvy;
        s[0] += (double)(fac_f * g.sr);
        s[1] += (double)(fac_f * t.vtfx + fac_p * vtpx);
        s[2] += (double)(fac_f * t.vtfy + fac_p * vtpy);
        s[3] += (double)(fac_f * (ry * t.vtfz - rz * t.vtfy) +
                         fac_p * ((-rz) * vtpy));
        s[4] += (double)(fac_f * (rz * t.vtfx - rx * t.vtfz) +
                         fac_p * (rz * vtpx));
        s[5] += (double)(fac_f * (rx * t.vtfy - ry * t.vtfx) +
                         fac_p * (rx * vtpy - ry * vtpx));
        float cn_p = g.w_np * step01(t.resp > 0.0f) - fac_p;
        float yp_n = cn_p * ry;
        s[6] += (double)cn_p;
        s[7] += (double)yp_n;
        s[8] += (double)((-cn_p) * rx);
        s[9] += (double)(yp_n * ry);
        s[10] += (double)((-yp_n) * rx);
        s[11] += (double)(cn_p * rx * rx);
        float facs = fac_f + fac_p;
        s[12] += (double)facs;
        s[13] += (double)(facs * rz);
        s[14] += (double)(facs * (-ry));
        s[15] += (double)(facs * (-rz));
        s[16] += (double)(facs * rx);
        s[17] += (double)(facs * ry);
        s[18] += (double)(facs * (-rx));
        s[19] += (double)(facs * (ry * ry + rz * rz));
        s[20] += (double)(facs * (rx * rx + rz * rz));
        s[21] += (double)(facs * (rx * rx + ry * ry));
        s[22] += (double)(facs * ((-rx) * ry));
        s[23] += (double)(facs * ((-rx) * rz));
        s[24] += (double)(facs * ((-ry) * rz));
      }
      rollout::group_sum_park<G, 25>(s, park + kParkC);
    }

    // ---- gradient and Hessian, in the Pallas kernel's order of adds ----
    __syncwarp();
    float h[8][8], fc[8], gs[9];
    const float* gc = park + kParkC + 1;
    const float* hp = gc + 5;
    const float* hf = hp + 6;
    {
      const float* pa = park + kParkA;
      const float* pb = park + kParkB;
      int q = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = a; b < 8; ++b) h[a][b] = pa[q++];
      q = 3;
#pragma unroll
      for (int a = 3; a < 8; ++a)
#pragma unroll
        for (int b = a; b < 8; ++b) {
          if (a == 6 && b == 7) continue;
          h[a][b] = pb[q++];
        }
      h[6][7] = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) fc[k] = pa[21 + k];
#pragma unroll
      for (int k = 0; k < 3; ++k) fc[4 + k] = pb[k];
      fc[7] = park[kParkC];
#pragma unroll
      for (int k = 0; k < 9; ++k) gs[k] = pb[17 + k];
    }
    float d3 = u[3] - uu[3], d4 = u[4] - uu[4], d5 = u[5] - uu[5];
    float ix = L.iw00 * d3 + L.iw01 * d4 + L.iw02 * d5;
    float iy = L.iw01 * d3 + L.iw11 * d4 + L.iw12 * d5;
    float iz = L.iw02 * d3 + L.iw12 * d4 + L.iw22 * d5;
    float grad[8];
    grad[0] = pc.mass * (u[0] - uu[0]) - gs[0] + gc[0];
    grad[1] = pc.mass * (u[1] - uu[1]) - gs[1] + gc[1];
    grad[2] = pc.mass * (u[2] - uu[2]) - gs[2] + gs[3];
    grad[3] = ix - gs[4] + gc[2];
    grad[4] = iy - gs[5] + gc[3];
    grad[5] = iz - gs[6] + gc[4];
    grad[6] = pc.fmass_l * (u[6] - uu[6]) + gs[7];
    grad[7] = pc.fmass_r * (u[7] - uu[7]) + gs[8];

    h[2][2] = h[2][2] + hp[0];
    h[2][3] = h[2][3] + hp[1];
    h[2][4] = h[2][4] + hp[2];
    h[3][3] = h[3][3] + hp[3];
    h[3][4] = h[3][4] + hp[4];
    h[4][4] = h[4][4] + hp[5];
    const float s_facs = hf[0];
    h[0][0] = h[0][0] + s_facs;
    h[1][1] = h[1][1] + s_facs;
    h[2][2] = h[2][2] + s_facs;
    h[0][4] = h[0][4] + hf[1];
    h[0][5] = h[0][5] + hf[2];
    h[1][3] = h[1][3] + hf[3];
    h[1][5] = h[1][5] + hf[4];
    h[2][3] = h[2][3] + hf[5];
    h[2][4] = h[2][4] + hf[6];
    h[3][3] = h[3][3] + hf[7];
    h[4][4] = h[4][4] + hf[8];
    h[5][5] = h[5][5] + hf[9];
    h[3][4] = h[3][4] + hf[10];
    h[3][5] = h[3][5] + hf[11];
    h[4][5] = h[4][5] + hf[12];
    h[1][6] = h[1][6] + fc[0];
    h[1][7] = h[1][7] + fc[1];
    h[3][6] = h[3][6] + fc[2];
    h[5][6] = h[5][6] + fc[3];
    h[3][7] = h[3][7] + fc[4];
    h[5][7] = h[5][7] + fc[5];
    h[6][6] = h[6][6] + fc[6];
    h[7][7] = h[7][7] + fc[7];
    h[0][0] = h[0][0] + pc.mass;
    h[1][1] = h[1][1] + pc.mass;
    h[2][2] = h[2][2] + pc.mass;
    h[3][3] = h[3][3] + L.iw00;
    h[4][4] = h[4][4] + L.iw11;
    h[5][5] = h[5][5] + L.iw22;
    h[3][4] = h[3][4] + L.iw01;
    h[3][5] = h[3][5] + L.iw02;
    h[4][5] = h[4][5] + L.iw12;
    h[6][6] = h[6][6] + pc.fmass_l;
    h[7][7] = h[7][7] + pc.fmass_r;

    float dv[8], u1[8], u2[8];
    rollout::cholesky_solve<8>(h, grad, dv);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      u1[a] = u[a] + dv[a];
      u2[a] = u[a] + 0.5f * dv[a];
    }

    // ---- pass D: line-search energies of u, u1, u2 (caps at u) ----
    float e0, e1, e2;
    {
      // finger and plane energy of u, u1, u2
      double s[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) s[q] = 0.0;
      for (int p = lane_in_rollout<G>(), k = 0; p < P; p += G, ++k) {
        FGeo g;
        geo_load<kThreads>(slab, k, g);
        Terms t;
        terms(g, u, t);
        float capf = pc.mu_finger * t.lamf + g.rough_capn;
        float capp = capp_scale * t.lamp;
        float ef, ep;
        energy_rows(pc, g, u, capf, capp, ef, ep);
        s[0] += (double)ef;
        s[1] += (double)ep;
        energy_rows(pc, g, u1, capf, capp, ef, ep);
        s[2] += (double)ef;
        s[3] += (double)ep;
        energy_rows(pc, g, u2, capf, capp, ef, ep);
        s[4] += (double)ef;
        s[5] += (double)ep;
      }
      float t[6];
      rollout::group_sum_vec<G, 6>(s, t);
      e0 = e_quad(pc, L, u, uu) + t[0] + t[1];
      e1 = e_quad(pc, L, u1, uu) + t[2] + t[3];
      e2 = e_quad(pc, L, u2, uu) + t[4] + t[5];
    }
    bool best12 = e1 <= e2;
    float eb = best12 ? e1 : e2;
    bool take_new = eb <= e0;
#pragma unroll
    for (int a = 0; a < 8; ++a)
      u[a] = take_new ? (best12 ? u1[a] : u2[a]) : u[a];
    if constexpr (Tol) {
      // the step size: the group's largest |du| times its largest accepted
      // line-search step (0 where every lane kept u)
      float mdv = 0.0f;
#pragma unroll
      for (int a = 0; a < 8; ++a) mdv = mx(mdv, fabsf(dv[a]));
      float dmax;
      const int acc = vote.template any2_max<kThreads / 32>(
          take_new && best12, take_new && !best12, mdv, warp_slots,
          pair_slots, dmax);
      const float alpha = (acc & 1) ? 1.0f : ((acc & 2) ? 0.5f : 0.0f);
      const float step = dmax * alpha;
      if (!(step > prm.newton_tol)) return it + 1;
    }
  }
  return prm.newton_iters;
}

// No finger contact reachable in the group: 3 Newton iterations on the
// 6-DOF plane subproblem (pallas3d.py:739-859); u[6], u[7] stay. The 27
// point sums of an iteration and its 6 energies are each one vector
// reduction.
template <int G>
__device__ void cheap_solve(const Shared& sh, const Pair& pc,
                            const Rollout3DParams& prm, Lane& L, int P,
                            const float* uu, float* u) {
  for (int it = 0; it < 3; ++it) {
    // gq[8], then hp[6], then hf[13]
    float sums[27];
    {
      double s[27];
#pragma unroll
      for (int q = 0; q < 27; ++q) s[q] = 0.0;
      for (int p = lane_in_rollout<G>(); p < P; p += G) {
        PGeo g;
        float wy, wx, wz;
        plane_geo(sh, pc, prm, L, p, g, wy, wx, wz);
        const float rx = g.rx, ry = g.ry, rz = g.rz;
        float vpx = u[0] + u[4] * rz - u[5] * ry;
        float vpy = u[1] + u[5] * rx - u[3] * rz;
        float vpz = u[2] + u[3] * ry - u[4] * rx;
        float resp = mx(g.tgt_pn - vpz, 0.0f);
        float lamp = g.w_np * resp;
        float capp = pc.mu_plane * lamp;
        float vtpn = sqrtf(vpx * vpx + vpy * vpy + 1e-16f);
        float fac_p = mn(g.w_np, capp / vtpn);
        float fx = fac_p * vpx, fy = fac_p * vpy;
        s[0] += (double)fx;
        s[1] += (double)fy;
        s[2] += (double)lamp;
        s[3] += (double)(lamp * ry);
        s[4] += (double)((-rz) * fy);
        s[5] += (double)(lamp * rx);
        s[6] += (double)(rz * fx);
        s[7] += (double)(rx * fy - ry * fx);
        float cn_p = g.w_np * step01(resp > 0.0f) - fac_p;
        float yp_n = cn_p * ry;
        s[8] += (double)cn_p;
        s[9] += (double)yp_n;
        s[10] += (double)((-cn_p) * rx);
        s[11] += (double)(yp_n * ry);
        s[12] += (double)((-yp_n) * rx);
        s[13] += (double)(cn_p * rx * rx);
        s[14] += (double)fac_p;
        s[15] += (double)(fac_p * rz);
        s[16] += (double)(fac_p * (-ry));
        s[17] += (double)(fac_p * (-rz));
        s[18] += (double)(fac_p * rx);
        s[19] += (double)(fac_p * ry);
        s[20] += (double)(fac_p * (-rx));
        s[21] += (double)(fac_p * (ry * ry + rz * rz));
        s[22] += (double)(fac_p * (rx * rx + rz * rz));
        s[23] += (double)(fac_p * (rx * rx + ry * ry));
        s[24] += (double)(fac_p * ((-rx) * ry));
        s[25] += (double)(fac_p * ((-rx) * rz));
        s[26] += (double)(fac_p * ((-ry) * rz));
      }
      rollout::group_sum_vec<G, 27>(s, sums);
    }
    const float* gq = sums;
    const float* hp = sums + 8;
    const float* hf = sums + 14;
    float d3 = u[3] - uu[3], d4 = u[4] - uu[4], d5 = u[5] - uu[5];
    float ix = L.iw00 * d3 + L.iw01 * d4 + L.iw02 * d5;
    float iy = L.iw01 * d3 + L.iw11 * d4 + L.iw12 * d5;
    float iz = L.iw02 * d3 + L.iw12 * d4 + L.iw22 * d5;
    float grad[6];
    grad[0] = pc.mass * (u[0] - uu[0]) + gq[0];
    grad[1] = pc.mass * (u[1] - uu[1]) + gq[1];
    grad[2] = pc.mass * (u[2] - uu[2]) - gq[2];
    grad[3] = ix - gq[3] + gq[4];
    grad[4] = iy + gq[5] + gq[6];
    grad[5] = iz + gq[7];
    float h[6][6];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = 0; b < 6; ++b) h[a][b] = 0.0f;
    const float s_fac = hf[0];
    h[2][2] = hp[0];
    h[2][3] = hp[1];
    h[2][4] = hp[2];
    h[3][3] = hp[3];
    h[3][4] = hp[4];
    h[4][4] = hp[5];
    h[0][0] = s_fac + pc.mass;
    h[1][1] = s_fac + pc.mass;
    h[2][2] = h[2][2] + (s_fac + pc.mass);
    h[0][4] = hf[1];
    h[0][5] = hf[2];
    h[1][3] = hf[3];
    h[1][5] = hf[4];
    h[2][3] = h[2][3] + hf[5];
    h[2][4] = h[2][4] + hf[6];
    h[3][3] = h[3][3] + (hf[7] + L.iw00);
    h[4][4] = h[4][4] + (hf[8] + L.iw11);
    h[5][5] = hf[9] + L.iw22;
    h[3][4] = h[3][4] + (hf[10] + L.iw01);
    h[3][5] = hf[11] + L.iw02;
    h[4][5] = hf[12] + L.iw12;
    float dv[6];
    rollout::cholesky_solve<6>(h, grad, dv);
    float cand[3][6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      cand[0][a] = u[a];
      cand[1][a] = u[a] + dv[a];
      cand[2][a] = u[a] + 0.5f * dv[a];
    }
    // energies of u, u1, u2 with the caps of u
    float en[3];
    {
      // er then eh of each candidate
      double s[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) s[q] = 0.0;
      for (int p = lane_in_rollout<G>(); p < P; p += G) {
        PGeo g;
        float wy, wx, wz;
        plane_geo(sh, pc, prm, L, p, g, wy, wx, wz);
        const float rx = g.rx, ry = g.ry, rz = g.rz;
        float vpz0 = u[2] + u[3] * ry - u[4] * rx;
        float capp = pc.mu_plane * (g.w_np * mx(g.tgt_pn - vpz0, 0.0f));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float* v = cand[c];
          float vpx = v[0] + v[4] * rz - v[5] * ry;
          float vpy = v[1] + v[5] * rx - v[3] * rz;
          float vpz = v[2] + v[3] * ry - v[4] * rx;
          float res = mx(g.tgt_pn - vpz, 0.0f);
          float vt2 = vpx * vpx + vpy * vpy;
          s[2 * c] += (double)(0.5f * g.w_np * res * res);
          float vt = sqrtf(vt2 + 1e-16f);
          float q = 0.5f * g.w_np * vt2;
          float lin = capp * vt - 0.5f * capp * capp / mx(g.w_np, 1e-12f);
          s[2 * c + 1] += (double)((g.w_np * vt <= capp) ? q : lin);
        }
      }
      float t[6];
      rollout::group_sum_vec<G, 6>(s, t);
#pragma unroll
      for (int c = 0; c < 3; ++c) en[c] = t[2 * c] + t[2 * c + 1];
    }
    float e[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* v = cand[c];
      float e0 = v[0] - uu[0], e1 = v[1] - uu[1], e2 = v[2] - uu[2];
      float f3 = v[3] - uu[3], f4 = v[4] - uu[4], f5 = v[5] - uu[5];
      float jx = L.iw00 * f3 + L.iw01 * f4 + L.iw02 * f5;
      float jy = L.iw01 * f3 + L.iw11 * f4 + L.iw12 * f5;
      float jz = L.iw02 * f3 + L.iw12 * f4 + L.iw22 * f5;
      e[c] = en[c] + 0.5f * (pc.mass * (e0 * e0 + e1 * e1 + e2 * e2) +
                             f3 * jx + f4 * jy + f5 * jz);
    }
    bool b12 = e[1] <= e[2];
    float eb = b12 ? e[1] : e[2];
    bool tk = eb <= e[0];
#pragma unroll
    for (int a = 0; a < 6; ++a)
      u[a] = tk ? (b12 ? cand[1][a] : cand[2][a]) : u[a];
  }
}

// ---- Jacobi (Solver = kJacobi) --------------------------------------------

// Points a lane holds at most (ceil(P / G) <= kJMaxK; the launcher refuses
// more): their sweep impulses live in registers, in arrays that the fully
// unrolled point loop of the sweeps indexes.
constexpr int kJMaxK = 8;

// The slab of the Jacobi instantiation, per point in the thread's own
// column: what the sweeps read and none of them writes. Pass A leaves three
// quantities of passes B and C in the slots of final ones (kJWme: the
// effective mass me_f; kJImp: the unclamped wedge impulse dv_el; kJWmeP:
// the pushout headroom), and pass C puts the final ones there.
constexpr int kJRx = 0, kJRy = 1, kJRz = 2;     // lever arm
constexpr int kJNx = 3, kJNy = 4, kJNz = 5;     // finger normal (left: ny > 0)
constexpr int kJWme = 6, kJTgt = 7, kJImp = 8, kJRough = 9;   // finger set
constexpr int kJWmeP = 10, kJTgtP = 11;         // plane set
constexpr int kJHeld = 12;

// A finger point of the Jacobi solve: lever arm, world z and narrow phase.
struct JPoint {
  float rx, ry, rz, wz;
  Narrow o;
};

// The point's lever arm and world position, as plane_geo computes them.
__device__ __forceinline__ void jarm(const Shared& sh, const Lane& L, int p,
                                     JPoint& j, float& wx, float& wy) {
  float bx = sh.pbx[p], by = sh.pby[p], bz = sh.pbz[p];
  j.rx = L.r00 * bx + L.r01 * by + L.r02 * bz;
  j.ry = L.r10 * bx + L.r11 * by + L.r12 * bz;
  j.rz = L.r20 * bx + L.r21 * by + L.r22 * bz;
  wx = L.px + j.rx;
  wy = L.py + j.ry;
  j.wz = L.pz + j.rz;
}

// The elastic wedge's unclamped velocity impulse of a finger point
// (pallas3d.py:311-317), with its clipped depth and pushout cap.
__device__ __forceinline__ float wedge_dv(const Pair& pc,
                                          const Rollout3DParams& prm,
                                          const Narrow& o, float vn_f0,
                                          float& depth_el, float& v_cap) {
  depth_el = o.act_f * clampf(o.depth_f, 0.0f, prm.depth_el_cap);
  v_cap = prm.d_imp_dt * pc.k_cal * depth_el;
  return o.act_f *
         mn(mx(prm.d_imp_dt * (pc.k_cal * depth_el - pc.b_cal * vn_f0),
               0.0f),
            mx(v_cap - vn_f0, 0.0f));
}

// Projected Jacobi with the explicit elastic wedge (pallas3d.py:302-433):
// u = (vx, vy, vz, ox, oy, oz, qdl, qdr) out, from the step's start
// velocities (L). Lane r of the rollout's G lanes takes the points r,
// r + G, ... Passes A-C compute each point's sweep constants once, with the
// expressions of the plain version; the 2 x solver_iters sweeps then do
// only the impulse updates, on impulses held in registers.
template <int G>
__device__ void jacobi_solve(const Shared& sh, const Pair& pc,
                             const Rollout3DParams& prm, const Lane& L, int P,
                             float* slab, float* u) {
  constexpr int T = rollout::Layout<G>::kThreads;
  const float dt = prm.dt;
  // bit k: the lane's point k is in the finger set; bit kJMaxK + k: in the
  // plane set
  unsigned act = 0u;
  // ---- pass A: narrow phase, the unclamped elastic impulse (ten sums) ----
  float cnt_f, cnt_p, dvx_u, dvy_u, dvz_u, dox_u, doy_u, doz_u, dqdl_u, dqdr_u;
  {
    double s[10];
#pragma unroll
    for (int q = 0; q < 10; ++q) s[q] = 0.0;
    for (int p = lane_in_rollout<G>(), k = 0; p < P; p += G, ++k) {
      float* col = slab + k * kJHeld * T;
      JPoint j;
      float wx, wy;
      jarm(sh, L, p, j, wx, wy);
      finger_narrow(sh, prm, L, wx, wy, j.wz, j.o);
      float me_f, vn_f0, depth_el, v_cap;
      finger_mass(pc, L, j.rx, j.ry, j.rz, j.o, me_f, vn_f0);
      const float dv_el = wedge_dv(pc, prm, j.o, vn_f0, depth_el, v_cap);
      const float imp0 = me_f * dv_el;
      const float i0x = imp0 * j.o.nfx, i0y = imp0 * j.o.nfy,
                  i0z = imp0 * j.o.nfz;
      const float sl = step01(j.o.is_l);
      // the plane row of the point, as plane_geo computes it
      const float depth_p = prm.plane_z - j.wz;
      const float act_p = step01(depth_p > 0.0f);
      const float vpz = L.vz + L.ox * j.ry - L.oy * j.rx;
      col[kJRx * T] = j.rx;
      col[kJRy * T] = j.ry;
      col[kJRz * T] = j.rz;
      col[kJNx * T] = j.o.nfx;
      col[kJNy * T] = j.o.nfy;
      col[kJNz * T] = j.o.nfz;
      col[kJWme * T] = me_f;
      col[kJTgt * T] = prm.tgt_fj_v * vn_f0 + prm.tgt_fj_d * j.o.depth_f;
      col[kJImp * T] = dv_el;
      col[kJRough * T] = pc.rough * me_f * mn(depth_el, prm.rough_sat);
      col[kJWmeP * T] = mx(v_cap - vn_f0, 0.0f);
      col[kJTgtP * T] = prm.tgt_p_v * vpz + prm.tgt_p_d * depth_p;
      act |= (j.o.act_f != 0.0f ? 1u : 0u) << k;
      act |= (act_p != 0.0f ? 1u : 0u) << (kJMaxK + k);
      s[0] = s[0] + (double)j.o.act_f;
      s[1] = s[1] + (double)act_p;
      s[2] = s[2] + (double)i0x;
      s[3] = s[3] + (double)i0y;
      s[4] = s[4] + (double)i0z;
      s[5] = s[5] + (double)(j.ry * i0z - j.rz * i0y);
      s[6] = s[6] + (double)(j.rz * i0x - j.rx * i0z);
      s[7] = s[7] + (double)(j.rx * i0y - j.ry * i0x);
      s[8] = s[8] + (double)(sl * i0y);
      s[9] = s[9] + (double)((1.0f - sl) * i0y);
    }
    float t[10];
    rollout::group_sum_vec<G, 10>(s, t);
    cnt_f = mx(t[0], 1.0f);
    cnt_p = mx(t[1], 1.0f);
    dvx_u = t[2] * pc.inv_m;
    dvy_u = t[3] * pc.inv_m;
    dvz_u = t[4] * pc.inv_m;
    dox_u = L.w00 * t[5] + L.w01 * t[6] + L.w02 * t[7];
    doy_u = L.w01 * t[5] + L.w11 * t[6] + L.w12 * t[7];
    doz_u = L.w02 * t[5] + L.w12 * t[6] + L.w22 * t[7];
    dqdl_u = -t[8] * pc.inv_fml;
    dqdr_u = -t[9] * pc.inv_fmr;
  }

  // ---- pass B: the global energy clamp, a min over the points ----
  float lo = INFINITY;
  for (int p = lane_in_rollout<G>(), k = 0; p < P; p += G, ++k) {
    const float* col = slab + k * kJHeld * T;
    const float rx = col[kJRx * T], ry = col[kJRy * T], rz = col[kJRz * T];
    const float nx = col[kJNx * T], ny = col[kJNy * T], nz = col[kJNz * T];
    const float dv_el = col[kJImp * T];
    const float headroom = col[kJWmeP * T];
    const float dqd_pt = ny > 0.0f ? dqdl_u : dqdr_u;
    const float dvn_ind = (dvx_u + doy_u * rz - doz_u * ry) * nx +
                          (dvy_u + doz_u * rx - dox_u * rz - dqd_pt) * ny +
                          (dvz_u + dox_u * ry - doy_u * rx) * nz;
    const bool take = dv_el > 0.0f && dvn_ind > 1e-9f;
    const float denom = take ? dvn_ind : 1.0f;
    lo = mn(lo, take ? headroom / denom : INFINITY);
  }
  const float s_el = clampf(rollout::group_min<G>(lo), 0.0f, 1.0f);

  // ---- pass C: the grip load of the clamped impulse; the sweep weights ----
  float grip_ratio;
  {
    double s_g[1] = {0.0};
    for (int p = lane_in_rollout<G>(), k = 0; p < P; p += G, ++k) {
      float* col = slab + k * kJHeld * T;
      const float me_f = col[kJWme * T];
      const float imp_el = s_el * (me_f * col[kJImp * T]);
      s_g[0] = s_g[0] + (double)imp_el;
      col[kJImp * T] = imp_el;
      col[kJWme * T] = step01((act >> k) & 1u) / cnt_f * me_f;
      // the plane row's effective mass, as plane_geo computes it
      const float rx = col[kJRx * T], ry = col[kJRy * T];
      const float nrx = -rx;
      const float wxp = L.w00 * ry + L.w01 * nrx;
      const float wyp = L.w01 * ry + L.w11 * nrx;
      const float me_p = 1.0f / (pc.inv_m + (ry * wxp + nrx * wyp));
      col[kJWmeP * T] = step01((act >> (kJMaxK + k)) & 1u) / cnt_p * me_p;
    }
    float t[1];
    rollout::group_sum_vec<G, 1>(s_g, t);
    grip_ratio = t[0] / (dt * pc.mass * prm.gravity);
  }
  const float plane_scale = 1.0f / (1.0f + pc.unload * grip_ratio);
  const float mu_p = pc.mu_plane * plane_scale;

  // unconstrained update, the elastic wedge applied
  const float f_l = prm.kp * (prm.ctrl_l - L.ql) - prm.damping * L.qdl;
  const float f_r = prm.kp * (prm.ctrl_r - L.qr) - prm.damping * L.qdr;
  u[0] = L.vx + s_el * dvx_u;
  u[1] = L.vy + s_el * dvy_u;
  u[2] = L.vz - prm.g_dt + s_el * dvz_u;
  u[3] = L.ox + s_el * dox_u;
  u[4] = L.oy + s_el * doy_u;
  u[5] = L.oz + s_el * doz_u;
  u[6] = L.qdl + dt * f_l * pc.inv_fml + s_el * dqdl_u;
  u[7] = L.qdr + dt * f_r * pc.inv_fmr + s_el * dqdr_u;

  // Each point's impulses: the finger set's normal and tangential ones
  // (lf) and the plane set's normal and tangential x, y ones (lp). The
  // plane set's tangential z impulse is not held: its tangential velocity
  // has z part vpz - vpz, so from 0 it stays +0 (any non-finite velocity
  // makes every later value NaN either way).
  float lf[kJMaxK][4], lp[kJMaxK][3];
#pragma unroll
  for (int k = 0; k < kJMaxK; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) lf[k][q] = 0.0f;
#pragma unroll
    for (int q = 0; q < 3; ++q) lp[k][q] = 0.0f;
  }
  const float mu_f = pc.mu_finger;
  for (int it = 0; it < prm.solver_iters; ++it) {
    const int lane = lane_in_rollout<G>();
    // ---- the finger contact set ----
    {
      double a[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) a[q] = 0.0;
#pragma unroll
      for (int k = 0; k < kJMaxK; ++k) {
        if (lane + k * G < P) {
          const float* col = slab + k * kJHeld * T;
          const float rx = col[kJRx * T], ry = col[kJRy * T],
                      rz = col[kJRz * T];
          const float nx = col[kJNx * T], ny = col[kJNy * T],
                      nz = col[kJNz * T];
          const float wme = col[kJWme * T], tgt = col[kJTgt * T];
          const bool is_l = ny > 0.0f;
          const float vpx = u[0] + u[4] * rz - u[5] * ry;
          float vpy = u[1] + u[5] * rx - u[3] * rz;
          const float vpz = u[2] + u[3] * ry - u[4] * rx;
          vpy = vpy - (is_l ? u[6] : u[7]);
          const float vn = vpx * nx + vpy * ny + vpz * nz;
          const float lam_n = lf[k][0];
          const float new_n = mx(lam_n + wme * (tgt - vn), 0.0f);
          const float dn = new_n - lam_n;
          const float ltx = lf[k][1], lty = lf[k][2], ltz = lf[k][3];
          float ctx = ltx - wme * (vpx - vn * nx);
          float cty = lty - wme * (vpy - vn * ny);
          float ctz = ltz - wme * (vpz - vn * nz);
          const float cap =
              mu_f * (new_n + col[kJImp * T]) + col[kJRough * T];
          const float nrm = sqrtf(ctx * ctx + cty * cty + ctz * ctz + 1e-20f);
          const float sc = mn(cap / nrm, 1.0f);
          ctx = ctx * sc;
          cty = cty * sc;
          ctz = ctz * sc;
          lf[k][0] = new_n;
          lf[k][1] = ctx;
          lf[k][2] = cty;
          lf[k][3] = ctz;
          const float ix = dn * nx + (ctx - ltx);
          const float iy = dn * ny + (cty - lty);
          const float iz = dn * nz + (ctz - ltz);
          const float sl = step01(is_l);
          a[0] = a[0] + (double)ix;
          a[1] = a[1] + (double)iy;
          a[2] = a[2] + (double)iz;
          a[3] = a[3] + (double)(ry * iz - rz * iy);
          a[4] = a[4] + (double)(rz * ix - rx * iz);
          a[5] = a[5] + (double)(rx * iy - ry * ix);
          a[6] = a[6] + (double)(sl * iy);
          a[7] = a[7] + (double)((1.0f - sl) * iy);
        }
      }
      float t[8];
      rollout::group_sum_vec<G, 8>(a, t);
      u[0] = u[0] + t[0] * pc.inv_m;
      u[1] = u[1] + t[1] * pc.inv_m;
      u[2] = u[2] + t[2] * pc.inv_m;
      u[3] = u[3] + (L.w00 * t[3] + L.w01 * t[4] + L.w02 * t[5]);
      u[4] = u[4] + (L.w01 * t[3] + L.w11 * t[4] + L.w12 * t[5]);
      u[5] = u[5] + (L.w02 * t[3] + L.w12 * t[4] + L.w22 * t[5]);
      u[6] = u[6] - t[6] * pc.inv_fml;
      u[7] = u[7] - t[7] * pc.inv_fmr;
    }
    // ---- the plane set: normal (0, 0, 1), in the kernel's products ----
    {
      double a[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) a[q] = 0.0;
#pragma unroll
      for (int k = 0; k < kJMaxK; ++k) {
        if (lane + k * G < P) {
          const float* col = slab + k * kJHeld * T;
          const float rx = col[kJRx * T], ry = col[kJRy * T],
                      rz = col[kJRz * T];
          const float wme = col[kJWmeP * T];
          const float vpx = u[0] + u[4] * rz - u[5] * ry;
          const float vpy = u[1] + u[5] * rx - u[3] * rz;
          const float vpz = u[2] + u[3] * ry - u[4] * rx;
          const float vn = vpx * 0.0f + vpy * 0.0f + vpz * 1.0f;
          const float lam_n = lp[k][0];
          const float new_n = mx(lam_n + wme * (col[kJTgtP * T] - vn), 0.0f);
          const float dn = new_n - lam_n;
          const float ltx = lp[k][1], lty = lp[k][2], ltz = 0.0f;
          float ctx = ltx - wme * (vpx - vn * 0.0f);
          float cty = lty - wme * (vpy - vn * 0.0f);
          float ctz = ltz - wme * (vpz - vn * 1.0f);
          const float cap = mu_p * new_n;
          const float nrm = sqrtf(ctx * ctx + cty * cty + ctz * ctz + 1e-20f);
          const float sc = mn(cap / nrm, 1.0f);
          ctx = ctx * sc;
          cty = cty * sc;
          ctz = ctz * sc;
          lp[k][0] = new_n;
          lp[k][1] = ctx;
          lp[k][2] = cty;
          const float ix = dn * 0.0f + (ctx - ltx);
          const float iy = dn * 0.0f + (cty - lty);
          const float iz = dn * 1.0f + (ctz - ltz);
          a[0] = a[0] + (double)ix;
          a[1] = a[1] + (double)iy;
          a[2] = a[2] + (double)iz;
          a[3] = a[3] + (double)(ry * iz - rz * iy);
          a[4] = a[4] + (double)(rz * ix - rx * iz);
          a[5] = a[5] + (double)(rx * iy - ry * ix);
        }
      }
      float t[6];
      rollout::group_sum_vec<G, 6>(a, t);
      u[0] = u[0] + t[0] * pc.inv_m;
      u[1] = u[1] + t[1] * pc.inv_m;
      u[2] = u[2] + t[2] * pc.inv_m;
      u[3] = u[3] + (L.w00 * t[3] + L.w01 * t[4] + L.w02 * t[5]);
      u[4] = u[4] + (L.w01 * t[3] + L.w11 * t[4] + L.w12 * t[5]);
      u[5] = u[5] + (L.w02 * t[3] + L.w12 * t[4] + L.w22 * t[5]);
    }
  }
}

template <int G, int Solver>
__global__ void __launch_bounds__(rollout::Layout<G>::kThreads,
                                   rollout::Layout<G>::kMinBlocks)
rollout3d_kernel(const float* __restrict__ coefs,     // (B, 2, 24, 4, 3)
                 const float* __restrict__ points,    // (B, P, 4)
                 const float* __restrict__ scalars,   // (B, 1, 32)
                 const float* __restrict__ poses,     // (N, 3)
                 float* __restrict__ out,             // (12, B, N)
                 int B, int P, int N, Rollout3DParams prm) {
  using LO = rollout::Layout<G>;
  constexpr int kThreads = LO::kThreads;
  constexpr int kCluster = LO::kCluster;
  extern __shared__ float smem[];
  const int pair = blockIdx.y;
  const int tid = threadIdx.x;
  float* s_coef = smem;                         // 2 * 24 * 12
  float* s_scal = s_coef + 2 * kTotSeg * kCoef; // 32
  float* s_pair = s_scal + kScal;               // kPairFloats
  int* s_vote = reinterpret_cast<int*>(s_pair + kPairFloats);  // 2 * kCluster
  unsigned* warp_slots =
      reinterpret_cast<unsigned*>(s_vote + 2 * kCluster);    // kWarpSlots
  unsigned* t_slots = warp_slots + kWarpSlots;   // tol_slots(Solver, ...)
  float* s_lane = s_pair + kPairFloats + 2 * kCluster + kWarpSlots +
                  tol_slots(Solver, kCluster);
  float* s_pbx = s_lane + LO::kRollouts * kLaneStride;   // P
  float* s_pby = s_pbx + P;                     // P
  float* s_pbz = s_pby + P;                     // P
  // kHeld (Jacobi: kJHeld) floats a point, ceil(P / G) points a lane, one
  // column a thread
  float* slab = s_pbz + P + tid;
  for (int k = tid; k < 2 * kTotSeg * kCoef; k += kThreads)
    s_coef[k] = coefs[(size_t)pair * 2 * kTotSeg * kCoef + k];
  if (tid < kScal) s_scal[tid] = scalars[(size_t)pair * kScal + tid];
  __syncthreads();
  for (int k = tid; k < P; k += kThreads) {
    const float* pt = points + ((size_t)pair * P + k) * 4;
    s_pbx[k] = pt[0] - s_scal[2];
    s_pby[k] = pt[1] - s_scal[3];
    s_pbz[k] = pt[2] - s_scal[4];
  }
  if (tid == 0) {
    Pair& w = *reinterpret_cast<Pair*>(s_pair);
    w.mass = s_scal[0];
    w.fmass_l = s_scal[1];
    w.com_x = s_scal[2];
    w.com_y = s_scal[3];
    w.com_z = s_scal[4];
    w.i00 = s_scal[5];
    w.i11 = s_scal[6];
    w.i22 = s_scal[7];
    w.i01 = s_scal[8];
    w.i02 = s_scal[9];
    w.i12 = s_scal[10];
    w.fmass_r = s_scal[11];
    w.mu_plane = s_scal[12];
    w.mu_finger = s_scal[13];
    const float k_cal = s_scal[14];
    const float b_cal = s_scal[15];
    w.unload = s_scal[16];
    w.rough = s_scal[17];
    w.ib00 = s_scal[18];
    w.ib11 = s_scal[19];
    w.ib22 = s_scal[20];
    w.ib01 = s_scal[21];
    w.ib02 = s_scal[22];
    w.ib12 = s_scal[23];
    w.c_r = s_scal[24];
    w.fmax_l = s_scal[25];
    w.fmin_r = s_scal[26];
    w.restitution = s_scal[27];
    w.inv_m = 1.0f / w.mass;
    w.inv_fml = 1.0f / w.fmass_l;
    w.inv_fmr = 1.0f / w.fmass_r;
    w.tgt_f_v = 1.0f - prm.d_imp * b_cal * prm.dt;
    w.tgt_f_d = prm.d_imp_dt * k_cal;
    w.mg_dt = w.mass * prm.gravity * prm.dt;
    w.k_cal = k_cal;
    w.b_cal = b_cal;
  }
  __syncthreads();

  const Shared sh{s_coef, s_pbx, s_pby, s_pbz};
  const Pair& pc = *reinterpret_cast<const Pair*>(s_pair);
  rollout::GroupVote<kCluster> vote;
  vote.init(s_vote);

  // thread -> (rollout of the pose group, lane of the rollout)
  const int rank = (int)rollout::cg::this_cluster().block_rank();
  const int t_grp = rank * kThreads + tid;
  Lane& L = *reinterpret_cast<Lane*>(s_lane + (tid / G) * kLaneStride);
  float pose_x, pose_y, theta0;
  {
    const int j = (blockIdx.x / kCluster) * kLane + t_grp / G;   // pose index
    pose_x = poses[(size_t)j * 3 + 0];
    pose_y = poses[(size_t)j * 3 + 1];
    theta0 = poses[(size_t)j * 3 + 2];
    if (lane_in_rollout<G>() == 0) {
      L.pose = j;
      L.iters = 0.0f;
    }
  }
  const float half = theta0 * 0.5f;
  const float qw0 = cosf(half), qz0 = sinf(half);
  const float c0 = cosf(theta0), s0 = sinf(theta0);
  const float dt = prm.dt;

  float px = pose_x + c0 * pc.com_x - s0 * pc.com_y;
  float py = pose_y + s0 * pc.com_x + c0 * pc.com_y;
  float pz = 0.0f + pc.com_z;
  float qw = qw0, qx = 0.f, qy = 0.f, qz = qz0;
  float vx = 0.f, vy = 0.f, vz = 0.f, ox = 0.f, oy = 0.f, oz = 0.f;
  float ql = 0.f, qr = 0.f, qdl = 0.f, qdr = 0.f;
  float wyn = -1e9f, wyx = -1e9f;
  float cnt_f = 0.f, cnt_c = 0.f;
  float spx = px, spy = py, sqw = qw0, sqz = qz0;

  for (int i = 0; i < prm.steps; ++i) {
    if (prm.regrasp_every > 0 && (i % prm.regrasp_every == 0) && i > 0) {
      // zero jaws and velocities without a solve confirming equilibrium:
      // invalidate the travel cache so the next step runs the physics
      ql = 0.f; qr = 0.f; qdl = 0.f; qdr = 0.f;
      vx = 0.f; vy = 0.f; vz = 0.f; ox = 0.f; oy = 0.f; oz = 0.f;
      wyn = -1e9f;
    }
    // ---- settled-travel gate (group max of |v|, group-any reachability):
    // two bits that do not depend on each other, one vote
    float mot = mx(mx(fabsf(vx), fabsf(vy)), fabsf(vz));
    mot = mx(mot, mx(mx(fabsf(ox), fabsf(oy)), fabsf(oz)));
    const float f_l = prm.kp * (prm.ctrl_l - ql) - prm.damping * qdl;
    const float f_r = prm.kp * (prm.ctrl_r - qr) - prm.damping * qdr;
    const float ql_n = ql + dt * (qdl + dt * f_l * pc.inv_fml);
    const float qr_n = qr + dt * (qdr + dt * f_r * pc.inv_fmr);
    const bool maybe =
        (wyn - prm.marg <= prm.surf_l0 + mx(ql, ql_n) + pc.fmax_l) ||
        (wyx + prm.marg >= prm.surf_r0 + mn(qr, qr_n) + pc.fmin_r);
    // bit 0: some lane unsettled; bit 1: some lane can reach a finger
    const int gate = vote.any2(!(mot < prm.eps_settled), maybe);

    if (gate == 0) {
      // settled travel: only the finger servos advance
      qdl = qdl + dt * f_l * pc.inv_fml;
      qdr = qdr + dt * f_r * pc.inv_fmr;
      ql = ql + dt * qdl;
      qr = qr + dt * qdr;
    } else {
      // the rollout's lanes are done with the last step's Lane
      __syncwarp();
      if (lane_in_rollout<G>() == 0) {
        float r[9];
        r[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
        r[1] = 2.0f * (qx * qy - qw * qz);
        r[2] = 2.0f * (qx * qz + qw * qy);
        r[3] = 2.0f * (qx * qy + qw * qz);
        r[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
        r[5] = 2.0f * (qy * qz - qw * qx);
        r[6] = 2.0f * (qx * qz - qw * qy);
        r[7] = 2.0f * (qy * qz + qw * qx);
        r[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
        float w6[6], iw6[6];
        sandwich(r, pc.i00, pc.i11, pc.i22, pc.i01, pc.i02, pc.i12, w6);
        sandwich(r, pc.ib00, pc.ib11, pc.ib22, pc.ib01, pc.ib02, pc.ib12,
                 iw6);
        L.r00 = r[0]; L.r01 = r[1]; L.r02 = r[2];
        L.r10 = r[3]; L.r11 = r[4]; L.r12 = r[5];
        L.r20 = r[6]; L.r21 = r[7]; L.r22 = r[8];
        L.w00 = w6[0]; L.w01 = w6[1]; L.w02 = w6[2];
        L.w11 = w6[3]; L.w12 = w6[4]; L.w22 = w6[5];
        L.iw00 = iw6[0]; L.iw01 = iw6[1]; L.iw02 = iw6[2];
        L.iw11 = iw6[3]; L.iw12 = iw6[4]; L.iw22 = iw6[5];
        L.px = px; L.py = py; L.pz = pz;
        L.vx = vx; L.vy = vy; L.vz = vz;
        L.ox = ox; L.oy = oy; L.oz = oz;
        L.ql = ql; L.qr = qr; L.qdl = qdl; L.qdr = qdr;
        L.uu[0] = vx; L.uu[1] = vy; L.uu[2] = vz - prm.g_dt;
        L.uu[3] = ox; L.uu[4] = oy; L.uu[5] = oz;
        L.uu[6] = qdl + dt * f_l * pc.inv_fml;
        L.uu[7] = qdr + dt * f_r * pc.inv_fmr;
        L.keep[0] = qw; L.keep[1] = qx; L.keep[2] = qy; L.keep[3] = qz;
        L.keep[4] = spx; L.keep[5] = spy; L.keep[6] = sqw; L.keep[7] = sqz;
      }
      __syncwarp();

      // the object's wy span as of this step (travel broad-phase cache);
      // min and max are exact under any order
      float lo = INFINITY, hi = -INFINITY;
      for (int p = lane_in_rollout<G>(); p < P; p += G) {
        float ry = L.r10 * sh.pbx[p] + L.r11 * sh.pby[p] + L.r12 * sh.pbz[p];
        float wy = py + ry;
        lo = mn(lo, wy);
        hi = mx(hi, wy);
      }
      wyn = group_min<G>(lo);
      wyx = group_max<G>(hi);
      if (lane_in_rollout<G>() == 0) {
        L.keep[8] = wyn;
        L.keep[9] = wyx;
      }
      const float* uu = L.uu;
      float u[8];
      if constexpr (Solver == kJacobi) {
        // every normal step is a full Jacobi solve
        if (lane_in_rollout<G>() == 0) {
          L.keep[10] = cnt_f + 1.0f;
          L.keep[11] = cnt_c;
        }
        jacobi_solve<G>(sh, pc, prm, L, P, slab, u);
      } else {
#pragma unroll
        for (int a = 0; a < 8; ++a) u[a] = uu[a];
        const bool near = (wyn <= prm.surf_l0 + ql + pc.fmax_l) ||
                          (wyx >= prm.surf_r0 + qr + pc.fmin_r);
        const bool any_f = vote.any(near);
        if (lane_in_rollout<G>() == 0) {
          L.keep[10] = cnt_f + (any_f ? 1.0f : 0.0f);
          L.keep[11] = cnt_c + (any_f ? 0.0f : 1.0f);
        }
        if (any_f) {
          const int its = full_solve<G, Solver == kNewtonTol>(
              sh, pc, prm, L, P, slab, uu, u, vote, warp_slots, t_slots);
          if constexpr (Solver == kNewtonTol) {
            if (lane_in_rollout<G>() == 0) L.iters = L.iters + (float)its;
          }
        } else {
          cheap_solve<G>(sh, pc, prm, L, P, uu, u);
        }
      }
      vx = u[0]; vy = u[1]; vz = u[2];
      ox = u[3]; oy = u[4]; oz = u[5];
      qdl = u[6]; qdr = u[7];
      // back from shared memory: the state the solve did not touch (the
      // votes and shuffles since it was stored order the reads after it)
      px = L.px; py = L.py; pz = L.pz; ql = L.ql; qr = L.qr;
      qw = L.keep[0]; qx = L.keep[1]; qy = L.keep[2]; qz = L.keep[3];
      spx = L.keep[4]; spy = L.keep[5]; sqw = L.keep[6]; sqz = L.keep[7];
      wyn = L.keep[8]; wyx = L.keep[9];
      cnt_f = L.keep[10]; cnt_c = L.keep[11];
      // integrate
      px = px + dt * vx;
      py = py + dt * vy;
      pz = pz + dt * vz;
      float dqw = 0.5f * ((-ox) * qx - oy * qy - oz * qz);
      float dqx = 0.5f * (ox * qw + oy * qz - oz * qy);
      float dqy = 0.5f * ((-ox) * qz + oy * qw + oz * qx);
      float dqz = 0.5f * (ox * qy - oy * qx + oz * qw);
      qw = qw + dt * dqw;
      qx = qx + dt * dqx;
      qy = qy + dt * dqy;
      qz = qz + dt * dqz;
      float qn = rsq(qw * qw + qx * qx + qy * qy + qz * qz + 1e-12f);
      qw = qw * qn; qx = qx * qn; qy = qy * qn; qz = qz * qn;
      ql = ql + dt * qdl;
      qr = qr + dt * qdr;
    }
    if (i + 1 == prm.snapshot_step) {
      spx = px; spy = py; sqw = qw; sqz = qz;
    }
  }
  vote.finish();
  if (prm.snapshot_step <= 0 || prm.snapshot_step >= prm.steps) {
    spx = px; spy = py; sqw = qw; sqz = qz;
  }
  if (lane_in_rollout<G>() != 0) return;   // one lane of the rollout writes it out
  const int j = L.pose;   // index and pose: not kept in registers meanwhile
  pose_x = poses[(size_t)j * 3 + 0];
  pose_y = poses[(size_t)j * 3 + 1];

  // readout: final origin and z-quaternion, tip-over validity, snapshot
  const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const float r01 = 2.0f * (qx * qy - qw * qz);
  const float r02 = 2.0f * (qx * qz + qw * qy);
  const float r10 = 2.0f * (qx * qy + qw * qz);
  const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float r12 = 2.0f * (qy * qz - qw * qx);
  const float org_x = px - (r00 * pc.com_x + r01 * pc.com_y + r02 * pc.com_z);
  const float org_y = py - (r10 * pc.com_x + r11 * pc.com_y + r12 * pc.com_z);
  const bool valid = (fabsf(qx) < prm.tip_atol) && (fabsf(qy) < prm.tip_atol);
  const float sc = 1.0f - 2.0f * sqz * sqz;
  const float ss = 2.0f * sqw * sqz;
  const float sorg_x = spx - (sc * pc.com_x - ss * pc.com_y);
  const float sorg_y = spy - (ss * pc.com_x + sc * pc.com_y);

  const size_t plane = (size_t)B * N;
  const size_t o = (size_t)pair * N + j;
  out[0 * plane + o] = qw;
  out[1 * plane + o] = qz;
  out[2 * plane + o] = org_x - pose_x;
  out[3 * plane + o] = org_y - pose_y;
  out[4 * plane + o] = valid ? 1.0f : 0.0f;
  out[5 * plane + o] = sqw;
  out[6 * plane + o] = sqz;
  out[7 * plane + o] = sorg_x - pose_x;
  out[8 * plane + o] = sorg_y - pose_y;
  out[9 * plane + o] = cnt_f;
  out[10 * plane + o] = cnt_c;
  // iterations: counted where the solve is adaptive; else every full solve
  // runs newton_iters (Jacobi: solver_iters) of them (exact in float32)
  if constexpr (Solver == kNewtonTol)
    out[11 * plane + o] = L.iters;
  else
    out[11 * plane + o] =
        cnt_f * (float)(Solver == kJacobi ? prm.solver_iters
                                          : prm.newton_iters);
}

}  // namespace

// `plan` (5 ints, may be null) receives the rollout::Plan of the launch;
// prm.solver picks the instantiation (kNewton, kJacobi, kNewtonTol).
// Nothing is launched, and an error comes back, when P needs more shared
// memory than a block may have or the card cannot hold one cluster
// (rollout::launch_clusters).
extern "C" int rollout3d_launch(const float* coefs, const float* points,
                                const float* scalars, const float* poses,
                                float* out, int B, int P, int N,
                                Rollout3DParams prm, int* plan, void* stream) {
  constexpr int G = kThreadsPerRollout;
  using LO = rollout::Layout<G>;
  if (B <= 0 || P <= 0 || N <= 0 || N % kLane != 0 ||
      prm.solver < kNewton || prm.solver > kNewtonTol)
    return (int)cudaErrorInvalidValue;
  // the Jacobi sweeps hold kJMaxK points a lane in registers (on the H100
  // the slab of more would not fit a block either)
  if (prm.solver == kJacobi && P > kJMaxK * G)
    return (int)cudaErrorInvalidValue;
  const size_t held = prm.solver == kJacobi ? kJHeld : kHeld;
  const size_t smem =
      sizeof(float) * (2 * kTotSeg * kCoef + kScal + kPairFloats +
                       LO::kRollouts * kLaneStride + 3 * P +
                       held * LO::kThreads * (size_t)((P + G - 1) / G)) +
      sizeof(int) * (2 * LO::kCluster + kWarpSlots +
                     tol_slots(prm.solver, LO::kCluster));
  const dim3 grid((N / kLane) * LO::kCluster, B);
  rollout::Plan* pl = reinterpret_cast<rollout::Plan*>(plan);
  if (prm.solver == kJacobi)
    return rollout::launch_clusters<LO>(
        rollout3d_kernel<G, kJacobi>, grid, smem, (cudaStream_t)stream, pl,
        G, coefs, points, scalars, poses, out, B, P, N, prm);
  if (prm.solver == kNewtonTol)
    return rollout::launch_clusters<LO>(
        rollout3d_kernel<G, kNewtonTol>, grid, smem, (cudaStream_t)stream,
        pl, G, coefs, points, scalars, poses, out, B, P, N, prm);
  return rollout::launch_clusters<LO>(
      rollout3d_kernel<G, kNewton>, grid, smem, (cudaStream_t)stream, pl, G,
      coefs, points, scalars, poses, out, B, P, N, prm);
}
