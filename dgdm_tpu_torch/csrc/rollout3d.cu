// 3D squeeze rollouts (kernel K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_rollout3d_kernel` of dgdm_tpu/sim/pallas3d.py on
// its Newton path (the package's default solver). One CUDA block of 128
// threads runs one (pair, 128-pose block) — the Pallas grid cell — for all
// steps; each thread carries one rollout's 6-DOF state (position, quaternion,
// velocities, the two jaws) in registers. The pair's fitted finger surfaces
// (2 x 24 cells x 12 coefficients) and its body-frame surface points (P x 3,
// P = 256 on the verification and datagen paths), ~5 KB, sit in shared
// memory. The block-uniform branches of the Pallas kernel keep their
// per-block granularity as __syncthreads_or votes: the settled-travel gate
// (block max of |v|, |omega| plus the broad-phase reachability test with the
// jaws' next position) and the full-vs-cheap solve gate. Padded lanes vote
// too, as in the Pallas kernel.
//
// Bound: operations, not bytes. A call reads ~5 KB per pair plus 12 bytes per
// pose and writes 48 bytes per pose; a full-solve step costs a few thousand
// flops per surface point. The per-point contact geometry (two bivariate
// Horner surface evaluations, normals, contact frames, effective masses) is
// recomputed in each of the 4 passes over the points of a Newton iteration
// instead of being held per point: each pass keeps at most 30 float64 sums
// live, so nothing of a step touches device memory.
//
// Numerics: float32 state and elementwise physics, compiled without fast
// math and with -fmad=false, so that each expression rounds like the plain
// PyTorch version (dgdm_tpu_torch/sim/rollout3d_ref.py), which keeps the
// Pallas operand order. Every sum over surface points accumulates in float64
// and rounds once to float32 (the plain version does the same), so it does
// not depend on the summation order. rsqrt is 1/sqrtf; max/min propagate NaN
// like torch.maximum/minimum. The float32 constants the Pallas kernel folds
// from scalars arrive folded in Rollout3DParams (rollout3d_ref.constants).
//
// C interface (bound with ctypes by dgdm_tpu_torch/sim/rollout3d.py): the
// launch runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLane = 128;
constexpr int kNSeg = 12;    // x cells of the fitted surface
constexpr int kNzSeg = 2;    // z cells
constexpr int kTotSeg = kNSeg * kNzSeg;
constexpr int kCoef = 12;    // (DEG_X + 1) x (DEG_Z + 1) per cell
constexpr int kScal = 32;    // per-pair scalar slots (rollout3d.scene_arrays_3d)

}  // namespace

// Must match rollout3d._Params (ctypes) field for field.
struct Rollout3DParams {
  int steps, regrasp_every, snapshot_step, newton_iters;
  float dt, d_imp, ctrl_l, ctrl_r, kp, damping, x0f, x1f, z0f, z1f, hseg,
      hzseg, inv_hseg, inv_hzseg, surf_l0, surf_r0, plane_z, tgt_p_v,
      tgt_p_d, g_dt, gravity, d_imp_dt, v_rest, depth_el_cap, eps_settled,
      marg, tip_atol;
};

namespace {

__device__ __forceinline__ float mx(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float mn(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return mn(mx(x, lo), hi);
}
__device__ __forceinline__ float rsq(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ float step01(bool c) { return c ? 1.0f : 0.0f; }

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

// Per-pair constants, read once from shared memory into registers.
struct Pair {
  float mass, fmass_l, fmass_r, com_x, com_y, com_z;
  float i00, i11, i22, i01, i02, i12;       // body inverse inertia
  float ib00, ib11, ib22, ib01, ib02, ib12; // body inertia
  float mu_plane, mu_finger, rough, unload, c_r, fmax_l, fmin_r, restitution;
  float inv_m, inv_fml, inv_fmr, tgt_f_v, tgt_f_d, mg_dt;
};

struct Shared {
  const float* coef;   // (2, 24, 4, 3) fitted surface polynomials (l, r)
  const float* pbx;    // (P,) body points relative to the COM
  const float* pby;
  const float* pbz;
};

// Lane quantities of one normal step, fixed during its solve.
struct Lane {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;
  float w00, w01, w02, w11, w12, w22;        // world inverse inertia
  float iw00, iw01, iw02, iw11, iw12, iw22;  // world inertia
  float px, py, pz, vx, vy, vz, ox, oy, oz, ql, qr, qdl, qdr;
};

__device__ __forceinline__ void sandwich(const Lane& L, float m00, float m11,
                                         float m22, float m01, float m02,
                                         float m12, float* o) {
  float a00 = L.r00 * m00 + L.r01 * m01 + L.r02 * m02;
  float a01 = L.r00 * m01 + L.r01 * m11 + L.r02 * m12;
  float a02 = L.r00 * m02 + L.r01 * m12 + L.r02 * m22;
  float a10 = L.r10 * m00 + L.r11 * m01 + L.r12 * m02;
  float a11 = L.r10 * m01 + L.r11 * m11 + L.r12 * m12;
  float a12 = L.r10 * m02 + L.r11 * m12 + L.r12 * m22;
  float a20 = L.r20 * m00 + L.r21 * m01 + L.r22 * m02;
  float a21 = L.r20 * m01 + L.r21 * m11 + L.r22 * m12;
  float a22 = L.r20 * m02 + L.r21 * m12 + L.r22 * m22;
  o[0] = a00 * L.r00 + a01 * L.r01 + a02 * L.r02;
  o[1] = a00 * L.r10 + a01 * L.r11 + a02 * L.r12;
  o[2] = a00 * L.r20 + a01 * L.r21 + a02 * L.r22;
  o[3] = a10 * L.r10 + a11 * L.r11 + a12 * L.r12;
  o[4] = a10 * L.r20 + a11 * L.r21 + a12 * L.r22;
  o[5] = a20 * L.r20 + a21 * L.r21 + a22 * L.r22;
}

// Plane-row quantities of one point (the cheap solve needs only these).
struct PGeo {
  float rx, ry, rz, w_np, tgt_pn;
};

__device__ __forceinline__ void plane_geo(const Shared& sh, const Pair& pc,
                                          const Rollout3DParams& prm,
                                          const Lane& L, int p, PGeo& g,
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

__device__ __forceinline__ void full_geo(const Shared& sh, const Pair& pc,
                                         const Rollout3DParams& prm,
                                         const Lane& L, int p, FGeo& g) {
  PGeo pg;
  float wx, wy, wz;
  plane_geo(sh, pc, prm, L, p, pg, wy, wx, wz);
  g.rx = pg.rx; g.ry = pg.ry; g.rz = pg.rz;
  g.w_np = pg.w_np; g.tgt_pn = pg.tgt_pn;
  const float rx = pg.rx, ry = pg.ry, rz = pg.rz;

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
  bool is_l = depth_l > depth_r;
  float depth_f = is_l ? depth_l : depth_r;
  float nfx = is_l ? (-slx) * inv_nl : srx * inv_nr;
  float nfy = is_l ? inv_nl : -inv_nr;
  float nfz = is_l ? (-slz) * inv_nl : srz * inv_nr;
  float act_f = step01(depth_f > 0.0f && in_dom);
  float cfx = ry * nfz - rz * nfy;
  float cfy = rz * nfx - rx * nfz;
  float cfz = rx * nfy - ry * nfx;
  float wfx = L.w00 * cfx + L.w01 * cfy + L.w02 * cfz;
  float wfy = L.w01 * cfx + L.w11 * cfy + L.w12 * cfz;
  float wfz = L.w02 * cfx + L.w12 * cfy + L.w22 * cfz;
  float ang_f = cfx * wfx + cfy * wfy + cfz * wfz;
  float inv_fm = is_l ? pc.inv_fml : pc.inv_fmr;
  float me_f = 1.0f / (pc.inv_m + ang_f + nfy * nfy * inv_fm);
  float qd_c0 = is_l ? L.qdl : L.qdr;
  // pre-update point velocity
  float vpx = L.vx + L.oy * rz - L.oz * ry;
  float vpy = L.vy + L.oz * rx - L.ox * rz;
  float vpz = L.vz + L.ox * ry - L.oy * rx;
  float vn_f0 = vpx * nfx + (vpy - qd_c0) * nfy + vpz * nfz;
  g.tgt_fn = pc.tgt_f_v * vn_f0 + pc.tgt_f_d * depth_f +
             pc.restitution * mx(-vn_f0 - prm.v_rest, 0.0f);
  g.w_nf = act_f * me_f / pc.c_r;
  float depth_eln = act_f * clampf(depth_f, 0.0f, prm.depth_el_cap);
  g.rough_capn = pc.rough * me_f * depth_eln;
  g.nfx = nfx; g.nfy = nfy; g.nfz = nfz;
  g.cfx = cfx; g.cfy = cfy; g.cfz = cfz;
  g.sl = step01(is_l);
  g.sr = 1.0f - g.sl;
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

// Unrolled Cholesky solve of H d = -grad over the upper triangle of H.
template <int N>
__device__ __forceinline__ void cholesky_solve(const float (&h)[N][N],
                                               const float* grad, float* dv) {
  float L[N][N], Ld[N], yv[N];
#pragma unroll
  for (int a = 0; a < N; ++a) {
    float s = h[a][a];
#pragma unroll
    for (int k = 0; k < a; ++k) s = s - L[a][k] * L[a][k];
    float dinv = rsq(mx(s, 1e-12f));
    Ld[a] = dinv;
#pragma unroll
    for (int b = a + 1; b < N; ++b) {
      float s2 = h[a][b];
#pragma unroll
      for (int k = 0; k < a; ++k) s2 = s2 - L[b][k] * L[a][k];
      L[b][a] = s2 * dinv;
    }
  }
#pragma unroll
  for (int a = 0; a < N; ++a) {
    float s = -grad[a];
#pragma unroll
    for (int k = 0; k < a; ++k) s = s - L[a][k] * yv[k];
    yv[a] = s * Ld[a];
  }
#pragma unroll
  for (int a = N - 1; a >= 0; --a) {
    float s = yv[a];
#pragma unroll
    for (int k = a + 1; k < N; ++k) s = s - L[k][a] * dv[k];
    dv[a] = s * Ld[a];
  }
}

__device__ __forceinline__ float f32(double x) { return (float)x; }

// Coupled semi-smooth Newton on the 8-DOF soft-constraint energy
// (pallas3d.py:497-737): u = (vx, vy, vz, ox, oy, oz, qdl, qdr), in/out.
__device__ void full_solve(const Shared& sh, const Pair& pc,
                           const Rollout3DParams& prm, const Lane& L, int P,
                           const float* uu, float* u) {
  for (int it = 0; it < prm.newton_iters; ++it) {
    // ---- pass A: grip load, Hessian rows 0-2, finger columns ----
    double s_lam = 0.0;
    double hA[21];
    double fc[8];
#pragma unroll
    for (int q = 0; q < 21; ++q) hA[q] = 0.0;
#pragma unroll
    for (int q = 0; q < 8; ++q) fc[q] = 0.0;
    for (int p = 0; p < P; ++p) {
      FGeo g;
      full_geo(sh, pc, prm, L, p, g);
      Terms t;
      terms(g, u, t);
      s_lam = s_lam + (double)t.lamf;
      float fac_f = fac_finger(pc, g, t);
      float cn_f = g.w_nf * step01(t.resf > 0.0f) - fac_f;
      float jf[8] = {g.nfx, g.nfy, g.nfz, g.cfx, g.cfy, g.cfz,
                     -g.nfy * g.sl, -g.nfy * g.sr};
      int q = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float yf = cn_f * jf[a];
#pragma unroll
        for (int b = a; b < 8; ++b) hA[q++] += (double)(yf * jf[b]);
      }
      fc[0] += (double)(fac_f * (-g.sl));
      fc[1] += (double)(fac_f * (-g.sr));
      fc[2] += (double)(fac_f * g.sl * g.rz);
      fc[3] += (double)(fac_f * g.sl * (-g.rx));
      fc[4] += (double)(fac_f * g.sr * g.rz);
      fc[5] += (double)(fac_f * g.sr * (-g.rx));
      fc[6] += (double)(fac_f * g.sl);
      fc[7] += (double)(fac_f * g.sr);
    }
    const float grip = f32(s_lam) / pc.mg_dt;
    const float scale_p = 1.0f / (1.0f + pc.unload * grip);
    const float capp_scale = pc.mu_plane * scale_p;

    // ---- pass B: Hessian rows 3-7, gradient terms without the plane cap --
    double hB[14];
    double gs[9];
#pragma unroll
    for (int q = 0; q < 14; ++q) hB[q] = 0.0;
#pragma unroll
    for (int q = 0; q < 9; ++q) gs[q] = 0.0;
    for (int p = 0; p < P; ++p) {
      FGeo g;
      full_geo(sh, pc, prm, L, p, g);
      Terms t;
      terms(g, u, t);
      float fac_f = fac_finger(pc, g, t);
      float cn_f = g.w_nf * step01(t.resf > 0.0f) - fac_f;
      float jf[8] = {g.nfx, g.nfy, g.nfz, g.cfx, g.cfy, g.cfz,
                     -g.nfy * g.sl, -g.nfy * g.sr};
      int q = 0;
#pragma unroll
      for (int a = 3; a < 8; ++a) {
        float yf = cn_f * jf[a];
#pragma unroll
        for (int b = a; b < 8; ++b) {
          if (a == 6 && b == 7) continue;
          hB[q++] += (double)(yf * jf[b]);
        }
      }
      gs[0] += (double)(t.lamf * g.nfx);
      gs[1] += (double)(t.lamf * g.nfy);
      gs[2] += (double)(t.lamf * g.nfz + t.lamp);
      gs[3] += (double)(fac_f * t.vtfz);
      gs[4] += (double)(t.lamf * g.cfx + t.lamp * g.ry);
      gs[5] += (double)(t.lamf * g.cfy - t.lamp * g.rx);
      gs[6] += (double)(t.lamf * g.cfz);
      gs[7] += (double)(g.sl * (t.lamf * g.nfy - fac_f * t.vtfy));
      gs[8] += (double)(g.sr * (t.lamf * g.nfy - fac_f * t.vtfy));
    }

    // ---- pass C: friction terms with the plane cap, plane Hessian ----
    double gc[5], hp[6], hf[13];
#pragma unroll
    for (int q = 0; q < 5; ++q) gc[q] = 0.0;
#pragma unroll
    for (int q = 0; q < 6; ++q) hp[q] = 0.0;
#pragma unroll
    for (int q = 0; q < 13; ++q) hf[q] = 0.0;
    for (int p = 0; p < P; ++p) {
      FGeo g;
      full_geo(sh, pc, prm, L, p, g);
      Terms t;
      terms(g, u, t);
      const float rx = g.rx, ry = g.ry, rz = g.rz;
      float fac_f = fac_finger(pc, g, t);
      float fac_p = fac_plane(g, t, capp_scale);
      float vtpx = t.fx, vtpy = t.pvy;
      gc[0] += (double)(fac_f * t.vtfx + fac_p * vtpx);
      gc[1] += (double)(fac_f * t.vtfy + fac_p * vtpy);
      gc[2] += (double)(fac_f * (ry * t.vtfz - rz * t.vtfy) +
                        fac_p * ((-rz) * vtpy));
      gc[3] += (double)(fac_f * (rz * t.vtfx - rx * t.vtfz) +
                        fac_p * (rz * vtpx));
      gc[4] += (double)(fac_f * (rx * t.vtfy - ry * t.vtfx) +
                        fac_p * (rx * vtpy - ry * vtpx));
      float cn_p = g.w_np * step01(t.resp > 0.0f) - fac_p;
      float yp_n = cn_p * ry;
      hp[0] += (double)cn_p;
      hp[1] += (double)yp_n;
      hp[2] += (double)((-cn_p) * rx);
      hp[3] += (double)(yp_n * ry);
      hp[4] += (double)((-yp_n) * rx);
      hp[5] += (double)(cn_p * rx * rx);
      float facs = fac_f + fac_p;
      hf[0] += (double)facs;
      hf[1] += (double)(facs * rz);
      hf[2] += (double)(facs * (-ry));
      hf[3] += (double)(facs * (-rz));
      hf[4] += (double)(facs * rx);
      hf[5] += (double)(facs * ry);
      hf[6] += (double)(facs * (-rx));
      hf[7] += (double)(facs * (ry * ry + rz * rz));
      hf[8] += (double)(facs * (rx * rx + rz * rz));
      hf[9] += (double)(facs * (rx * rx + ry * ry));
      hf[10] += (double)(facs * ((-rx) * ry));
      hf[11] += (double)(facs * ((-rx) * rz));
      hf[12] += (double)(facs * ((-ry) * rz));
    }

    // ---- gradient and Hessian, in the Pallas kernel's order of adds ----
    float d3 = u[3] - uu[3], d4 = u[4] - uu[4], d5 = u[5] - uu[5];
    float ix = L.iw00 * d3 + L.iw01 * d4 + L.iw02 * d5;
    float iy = L.iw01 * d3 + L.iw11 * d4 + L.iw12 * d5;
    float iz = L.iw02 * d3 + L.iw12 * d4 + L.iw22 * d5;
    float grad[8];
    grad[0] = pc.mass * (u[0] - uu[0]) - f32(gs[0]) + f32(gc[0]);
    grad[1] = pc.mass * (u[1] - uu[1]) - f32(gs[1]) + f32(gc[1]);
    grad[2] = pc.mass * (u[2] - uu[2]) - f32(gs[2]) + f32(gs[3]);
    grad[3] = ix - f32(gs[4]) + f32(gc[2]);
    grad[4] = iy - f32(gs[5]) + f32(gc[3]);
    grad[5] = iz - f32(gs[6]) + f32(gc[4]);
    grad[6] = pc.fmass_l * (u[6] - uu[6]) + f32(gs[7]);
    grad[7] = pc.fmass_r * (u[7] - uu[7]) + f32(gs[8]);

    float h[8][8];
    {
      int q = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = a; b < 8; ++b) h[a][b] = f32(hA[q++]);
      q = 0;
#pragma unroll
      for (int a = 3; a < 8; ++a)
#pragma unroll
        for (int b = a; b < 8; ++b) {
          if (a == 6 && b == 7) continue;
          h[a][b] = f32(hB[q++]);
        }
      h[6][7] = 0.0f;
    }
    h[2][2] = h[2][2] + f32(hp[0]);
    h[2][3] = h[2][3] + f32(hp[1]);
    h[2][4] = h[2][4] + f32(hp[2]);
    h[3][3] = h[3][3] + f32(hp[3]);
    h[3][4] = h[3][4] + f32(hp[4]);
    h[4][4] = h[4][4] + f32(hp[5]);
    const float s_facs = f32(hf[0]);
    h[0][0] = h[0][0] + s_facs;
    h[1][1] = h[1][1] + s_facs;
    h[2][2] = h[2][2] + s_facs;
    h[0][4] = h[0][4] + f32(hf[1]);
    h[0][5] = h[0][5] + f32(hf[2]);
    h[1][3] = h[1][3] + f32(hf[3]);
    h[1][5] = h[1][5] + f32(hf[4]);
    h[2][3] = h[2][3] + f32(hf[5]);
    h[2][4] = h[2][4] + f32(hf[6]);
    h[3][3] = h[3][3] + f32(hf[7]);
    h[4][4] = h[4][4] + f32(hf[8]);
    h[5][5] = h[5][5] + f32(hf[9]);
    h[3][4] = h[3][4] + f32(hf[10]);
    h[3][5] = h[3][5] + f32(hf[11]);
    h[4][5] = h[4][5] + f32(hf[12]);
    h[1][6] = h[1][6] + f32(fc[0]);
    h[1][7] = h[1][7] + f32(fc[1]);
    h[3][6] = h[3][6] + f32(fc[2]);
    h[5][6] = h[5][6] + f32(fc[3]);
    h[3][7] = h[3][7] + f32(fc[4]);
    h[5][7] = h[5][7] + f32(fc[5]);
    h[6][6] = h[6][6] + f32(fc[6]);
    h[7][7] = h[7][7] + f32(fc[7]);
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
    cholesky_solve<8>(h, grad, dv);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      u1[a] = u[a] + dv[a];
      u2[a] = u[a] + 0.5f * dv[a];
    }

    // ---- pass D: line-search energies of u, u1, u2 (caps at u) ----
    double ef0 = 0.0, ep0 = 0.0, ef1 = 0.0, ep1 = 0.0, ef2 = 0.0, ep2 = 0.0;
    for (int p = 0; p < P; ++p) {
      FGeo g;
      full_geo(sh, pc, prm, L, p, g);
      Terms t;
      terms(g, u, t);
      float capf = pc.mu_finger * t.lamf + g.rough_capn;
      float capp = capp_scale * t.lamp;
      float ef, ep;
      energy_rows(pc, g, u, capf, capp, ef, ep);
      ef0 += (double)ef;
      ep0 += (double)ep;
      energy_rows(pc, g, u1, capf, capp, ef, ep);
      ef1 += (double)ef;
      ep1 += (double)ep;
      energy_rows(pc, g, u2, capf, capp, ef, ep);
      ef2 += (double)ef;
      ep2 += (double)ep;
    }
    float e0 = e_quad(pc, L, u, uu) + f32(ef0) + f32(ep0);
    float e1 = e_quad(pc, L, u1, uu) + f32(ef1) + f32(ep1);
    float e2 = e_quad(pc, L, u2, uu) + f32(ef2) + f32(ep2);
    bool best12 = e1 <= e2;
    float eb = best12 ? e1 : e2;
    bool take_new = eb <= e0;
#pragma unroll
    for (int a = 0; a < 8; ++a)
      u[a] = take_new ? (best12 ? u1[a] : u2[a]) : u[a];
  }
}

// No finger contact reachable in the block: 3 Newton iterations on the
// 6-DOF plane subproblem (pallas3d.py:739-859); u[6], u[7] stay.
__device__ void cheap_solve(const Shared& sh, const Pair& pc,
                            const Rollout3DParams& prm, const Lane& L, int P,
                            const float* uu, float* u) {
  for (int it = 0; it < 3; ++it) {
    double gq[8], hp[6], hf[13];
#pragma unroll
    for (int q = 0; q < 8; ++q) gq[q] = 0.0;
#pragma unroll
    for (int q = 0; q < 6; ++q) hp[q] = 0.0;
#pragma unroll
    for (int q = 0; q < 13; ++q) hf[q] = 0.0;
    for (int p = 0; p < P; ++p) {
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
      gq[0] += (double)fx;
      gq[1] += (double)fy;
      gq[2] += (double)lamp;
      gq[3] += (double)(lamp * ry);
      gq[4] += (double)((-rz) * fy);
      gq[5] += (double)(lamp * rx);
      gq[6] += (double)(rz * fx);
      gq[7] += (double)(rx * fy - ry * fx);
      float cn_p = g.w_np * step01(resp > 0.0f) - fac_p;
      float yp_n = cn_p * ry;
      hp[0] += (double)cn_p;
      hp[1] += (double)yp_n;
      hp[2] += (double)((-cn_p) * rx);
      hp[3] += (double)(yp_n * ry);
      hp[4] += (double)((-yp_n) * rx);
      hp[5] += (double)(cn_p * rx * rx);
      hf[0] += (double)fac_p;
      hf[1] += (double)(fac_p * rz);
      hf[2] += (double)(fac_p * (-ry));
      hf[3] += (double)(fac_p * (-rz));
      hf[4] += (double)(fac_p * rx);
      hf[5] += (double)(fac_p * ry);
      hf[6] += (double)(fac_p * (-rx));
      hf[7] += (double)(fac_p * (ry * ry + rz * rz));
      hf[8] += (double)(fac_p * (rx * rx + rz * rz));
      hf[9] += (double)(fac_p * (rx * rx + ry * ry));
      hf[10] += (double)(fac_p * ((-rx) * ry));
      hf[11] += (double)(fac_p * ((-rx) * rz));
      hf[12] += (double)(fac_p * ((-ry) * rz));
    }
    float d3 = u[3] - uu[3], d4 = u[4] - uu[4], d5 = u[5] - uu[5];
    float ix = L.iw00 * d3 + L.iw01 * d4 + L.iw02 * d5;
    float iy = L.iw01 * d3 + L.iw11 * d4 + L.iw12 * d5;
    float iz = L.iw02 * d3 + L.iw12 * d4 + L.iw22 * d5;
    float grad[6];
    grad[0] = pc.mass * (u[0] - uu[0]) + f32(gq[0]);
    grad[1] = pc.mass * (u[1] - uu[1]) + f32(gq[1]);
    grad[2] = pc.mass * (u[2] - uu[2]) - f32(gq[2]);
    grad[3] = ix - f32(gq[3]) + f32(gq[4]);
    grad[4] = iy + f32(gq[5]) + f32(gq[6]);
    grad[5] = iz + f32(gq[7]);
    float h[6][6];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = 0; b < 6; ++b) h[a][b] = 0.0f;
    const float s_fac = f32(hf[0]);
    h[2][2] = f32(hp[0]);
    h[2][3] = f32(hp[1]);
    h[2][4] = f32(hp[2]);
    h[3][3] = f32(hp[3]);
    h[3][4] = f32(hp[4]);
    h[4][4] = f32(hp[5]);
    h[0][0] = s_fac + pc.mass;
    h[1][1] = s_fac + pc.mass;
    h[2][2] = h[2][2] + (s_fac + pc.mass);
    h[0][4] = f32(hf[1]);
    h[0][5] = f32(hf[2]);
    h[1][3] = f32(hf[3]);
    h[1][5] = f32(hf[4]);
    h[2][3] = h[2][3] + f32(hf[5]);
    h[2][4] = h[2][4] + f32(hf[6]);
    h[3][3] = h[3][3] + (f32(hf[7]) + L.iw00);
    h[4][4] = h[4][4] + (f32(hf[8]) + L.iw11);
    h[5][5] = f32(hf[9]) + L.iw22;
    h[3][4] = h[3][4] + (f32(hf[10]) + L.iw01);
    h[3][5] = f32(hf[11]) + L.iw02;
    h[4][5] = f32(hf[12]) + L.iw12;
    float dv[6];
    cholesky_solve<6>(h, grad, dv);
    float cand[3][6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      cand[0][a] = u[a];
      cand[1][a] = u[a] + dv[a];
      cand[2][a] = u[a] + 0.5f * dv[a];
    }
    // energies of u, u1, u2 with the caps of u
    double er[3] = {0.0, 0.0, 0.0}, eh[3] = {0.0, 0.0, 0.0};
    for (int p = 0; p < P; ++p) {
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
        er[c] += (double)(0.5f * g.w_np * res * res);
        float vt = sqrtf(vt2 + 1e-16f);
        float q = 0.5f * g.w_np * vt2;
        float lin = capp * vt - 0.5f * capp * capp / mx(g.w_np, 1e-12f);
        eh[c] += (double)((g.w_np * vt <= capp) ? q : lin);
      }
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
      float en = f32(er[c]) + f32(eh[c]);
      e[c] = en + 0.5f * (pc.mass * (e0 * e0 + e1 * e1 + e2 * e2) +
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

__global__ void __launch_bounds__(kLane)
rollout3d_kernel(const float* __restrict__ coefs,     // (B, 2, 24, 4, 3)
                 const float* __restrict__ points,    // (B, P, 4)
                 const float* __restrict__ scalars,   // (B, 1, 32)
                 const float* __restrict__ poses,     // (N, 3)
                 float* __restrict__ out,             // (12, B, N)
                 int B, int P, int N, Rollout3DParams prm) {
  extern __shared__ float smem[];
  const int pair = blockIdx.y;
  const int tid = threadIdx.x;
  float* s_coef = smem;                         // 2 * 24 * 12
  float* s_scal = s_coef + 2 * kTotSeg * kCoef; // 32
  float* s_pbx = s_scal + kScal;                // P
  float* s_pby = s_pbx + P;                     // P
  float* s_pbz = s_pby + P;                     // P
  for (int k = tid; k < 2 * kTotSeg * kCoef; k += kLane)
    s_coef[k] = coefs[(size_t)pair * 2 * kTotSeg * kCoef + k];
  if (tid < kScal) s_scal[tid] = scalars[(size_t)pair * kScal + tid];
  __syncthreads();
  for (int k = tid; k < P; k += kLane) {
    const float* pt = points + ((size_t)pair * P + k) * 4;
    s_pbx[k] = pt[0] - s_scal[2];
    s_pby[k] = pt[1] - s_scal[3];
    s_pbz[k] = pt[2] - s_scal[4];
  }
  __syncthreads();

  const Shared sh{s_coef, s_pbx, s_pby, s_pbz};
  Pair pc;
  pc.mass = s_scal[0];
  pc.fmass_l = s_scal[1];
  pc.com_x = s_scal[2];
  pc.com_y = s_scal[3];
  pc.com_z = s_scal[4];
  pc.i00 = s_scal[5];
  pc.i11 = s_scal[6];
  pc.i22 = s_scal[7];
  pc.i01 = s_scal[8];
  pc.i02 = s_scal[9];
  pc.i12 = s_scal[10];
  pc.fmass_r = s_scal[11];
  pc.mu_plane = s_scal[12];
  pc.mu_finger = s_scal[13];
  const float k_cal = s_scal[14];
  const float b_cal = s_scal[15];
  pc.unload = s_scal[16];
  pc.rough = s_scal[17];
  pc.ib00 = s_scal[18];
  pc.ib11 = s_scal[19];
  pc.ib22 = s_scal[20];
  pc.ib01 = s_scal[21];
  pc.ib02 = s_scal[22];
  pc.ib12 = s_scal[23];
  pc.c_r = s_scal[24];
  pc.fmax_l = s_scal[25];
  pc.fmin_r = s_scal[26];
  pc.restitution = s_scal[27];
  pc.inv_m = 1.0f / pc.mass;
  pc.inv_fml = 1.0f / pc.fmass_l;
  pc.inv_fmr = 1.0f / pc.fmass_r;
  pc.tgt_f_v = 1.0f - prm.d_imp * b_cal * prm.dt;
  pc.tgt_f_d = prm.d_imp_dt * k_cal;
  pc.mg_dt = pc.mass * prm.gravity * prm.dt;

  const int j = blockIdx.x * kLane + tid;       // pose index (N % 128 == 0)
  const float pose_x = poses[(size_t)j * 3 + 0];
  const float pose_y = poses[(size_t)j * 3 + 1];
  const float theta0 = poses[(size_t)j * 3 + 2];
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
  float cnt_f = 0.f, cnt_c = 0.f, cnt_i = 0.f;
  float spx = px, spy = py, sqw = qw0, sqz = qz0;

  for (int i = 0; i < prm.steps; ++i) {
    if (prm.regrasp_every > 0 && (i % prm.regrasp_every == 0) && i > 0) {
      // zero jaws and velocities without a solve confirming equilibrium:
      // invalidate the travel cache so the next step runs the physics
      ql = 0.f; qr = 0.f; qdl = 0.f; qdr = 0.f;
      vx = 0.f; vy = 0.f; vz = 0.f; ox = 0.f; oy = 0.f; oz = 0.f;
      wyn = -1e9f;
    }
    // ---- settled-travel gate (block max of |v|, block-any reachability)
    float mot = mx(mx(fabsf(vx), fabsf(vy)), fabsf(vz));
    mot = mx(mot, mx(mx(fabsf(ox), fabsf(oy)), fabsf(oz)));
    const bool unsettled = __syncthreads_or(!(mot < prm.eps_settled));
    const float f_l = prm.kp * (prm.ctrl_l - ql) - prm.damping * qdl;
    const float f_r = prm.kp * (prm.ctrl_r - qr) - prm.damping * qdr;
    const float ql_n = ql + dt * (qdl + dt * f_l * pc.inv_fml);
    const float qr_n = qr + dt * (qdr + dt * f_r * pc.inv_fmr);
    const bool maybe =
        (wyn - prm.marg <= prm.surf_l0 + mx(ql, ql_n) + pc.fmax_l) ||
        (wyx + prm.marg >= prm.surf_r0 + mn(qr, qr_n) + pc.fmin_r);
    const bool reach = __syncthreads_or(maybe);

    if (!unsettled && !reach) {
      // settled travel: only the finger servos advance
      qdl = qdl + dt * f_l * pc.inv_fml;
      qdr = qdr + dt * f_r * pc.inv_fmr;
      ql = ql + dt * qdl;
      qr = qr + dt * qdr;
    } else {
      Lane L;
      L.r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
      L.r01 = 2.0f * (qx * qy - qw * qz);
      L.r02 = 2.0f * (qx * qz + qw * qy);
      L.r10 = 2.0f * (qx * qy + qw * qz);
      L.r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
      L.r12 = 2.0f * (qy * qz - qw * qx);
      L.r20 = 2.0f * (qx * qz - qw * qy);
      L.r21 = 2.0f * (qy * qz + qw * qx);
      L.r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
      float w6[6], iw6[6];
      sandwich(L, pc.i00, pc.i11, pc.i22, pc.i01, pc.i02, pc.i12, w6);
      sandwich(L, pc.ib00, pc.ib11, pc.ib22, pc.ib01, pc.ib02, pc.ib12, iw6);
      L.w00 = w6[0]; L.w01 = w6[1]; L.w02 = w6[2];
      L.w11 = w6[3]; L.w12 = w6[4]; L.w22 = w6[5];
      L.iw00 = iw6[0]; L.iw01 = iw6[1]; L.iw02 = iw6[2];
      L.iw11 = iw6[3]; L.iw12 = iw6[4]; L.iw22 = iw6[5];
      L.px = px; L.py = py; L.pz = pz;
      L.vx = vx; L.vy = vy; L.vz = vz;
      L.ox = ox; L.oy = oy; L.oz = oz;
      L.ql = ql; L.qr = qr; L.qdl = qdl; L.qdr = qdr;

      // the object's wy span as of this step (travel broad-phase cache)
      for (int p = 0; p < P; ++p) {
        float ry = L.r10 * sh.pbx[p] + L.r11 * sh.pby[p] + L.r12 * sh.pbz[p];
        float wy = py + ry;
        if (p == 0) {
          wyn = wy;
          wyx = wy;
        } else {
          wyn = mn(wyn, wy);
          wyx = mx(wyx, wy);
        }
      }
      float uu[8] = {vx, vy, vz - prm.g_dt, ox, oy, oz,
                     qdl + dt * f_l * pc.inv_fml, qdr + dt * f_r * pc.inv_fmr};
      float u[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) u[a] = uu[a];
      const bool near = (wyn <= prm.surf_l0 + ql + pc.fmax_l) ||
                        (wyx >= prm.surf_r0 + qr + pc.fmin_r);
      const bool any_f = __syncthreads_or(near);
      if (any_f) {
        full_solve(sh, pc, prm, L, P, uu, u);
        cnt_f = cnt_f + 1.0f;
        cnt_i = cnt_i + (float)prm.newton_iters;
      } else {
        cheap_solve(sh, pc, prm, L, P, uu, u);
        cnt_c = cnt_c + 1.0f;
      }
      vx = u[0]; vy = u[1]; vz = u[2];
      ox = u[3]; oy = u[4]; oz = u[5];
      qdl = u[6]; qdr = u[7];
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
  if (prm.snapshot_step <= 0 || prm.snapshot_step >= prm.steps) {
    spx = px; spy = py; sqw = qw; sqz = qz;
  }

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
  out[11 * plane + o] = cnt_i;
}

}  // namespace

extern "C" int rollout3d_launch(const float* coefs, const float* points,
                                const float* scalars, const float* poses,
                                float* out, int B, int P, int N,
                                Rollout3DParams prm, void* stream) {
  if (B <= 0 || P <= 0 || N <= 0 || N % kLane != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * kTotSeg * kCoef + kScal + 3 * P);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rollout3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(N / kLane, B);
  rollout3d_kernel<<<grid, kLane, smem, (cudaStream_t)stream>>>(
      coefs, points, scalars, poses, out, B, P, N, prm);
  return (int)cudaGetLastError();
}
