// 2D squeeze rollouts (kernel K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_rollout_kernel` of dgdm_tpu/sim/pallas2d.py
// (Newton contact solver). One CUDA block of 128 threads runs one
// (pair, 128-pose block) — the Pallas grid cell — for all steps; each thread
// carries one rollout's state in registers. The pair's finger coefficients,
// body-frame contour, support points and scalars (~2.5 KB) sit in shared
// memory. The two block-uniform branches of the Pallas kernel keep their
// per-block granularity: the settled-travel gate (block max of |v| plus the
// broad-phase reachability test) and the full-vs-cheap solve gate are
// __syncthreads_or votes, so results do not depend on the warp layout and
// match the Pallas semantics lane for lane (padded lanes vote too).
//
// Bound: operations, not bytes. A call reads ~2.5 KB per pair plus 12 bytes
// per pose and writes 32 bytes per pose; each full-solve step costs a few
// thousand flops per contour point. Per-point contact geometry is recomputed
// in each pass over the points (two passes per Newton iteration) instead of
// being held in ~1,300 floats per thread: everything stays in registers and
// shared memory, nothing of a step touches device memory.
//
// Numerics: float32 state and elementwise physics, compiled without fast
// math and with -fmad=false, so that each expression rounds like the plain
// PyTorch version (dgdm_tpu_torch/sim/rollout2d_ref.py), which keeps the
// Pallas operand order. Sums over contour and support points accumulate in
// float64 and round once to float32 (the plain version does the same), so
// they do not depend on summation order: the squeeze is chaotic enough that
// reordered float32 sums move ~1% of the 9,000-pose grid's lanes by >1e-3
// rad in 200 steps. rsqrt is 1/sqrtf, round is rintf (half to even), mod is
// floor-mod, max/min propagate NaN like torch.maximum/minimum.
//
// C interface (bound with ctypes by dgdm_tpu_torch/sim/rollout2d.py): the
// launch runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLane = 128;
constexpr int kSeg = 6;      // cubic segments per finger curve
constexpr int kScal = 16;    // per-pair scalar slots (rollout2d.scene_arrays)

}  // namespace

// Must match rollout2d._Params (ctypes) field for field.
struct Rollout2DParams {
  int steps, regrasp_every, snapshot_step, newton_iters;
  float dt, ctrl_l, ctrl_r, x0f, x1f, h, inv_h, surf_l0, surf_r0, kp,
      damping, plane_z, gravity, k_plane, b_plane, depth_el_cap, impedance,
      eps_settled, marg;
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

__device__ __forceinline__ float hub(float v, float w, float cap) {
  float av = fabsf(v);
  float q = 0.5f * w * v * v;
  float lin = cap * av - 0.5f * cap * cap / mx(w, 1e-12f);
  return (w * av <= cap) ? q : lin;
}

// Per-pair constants, read once from shared memory into registers.
struct Pair {
  float mass, inertia, fmass_l, fmass_r, com_bx, com_by;
  float inv_m, inv_i, inv_fml, inv_fmr;
  float mu_plane, mu_finger, mu_torsion, k_con, b_con, unload, rough, c_r2;
  float broad_a, broad_b;
};

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

__device__ __forceinline__ void point_geo(
    const Shared& sh, const Pair& pc, const Rollout2DParams& prm, int p,
    float c, float s, float cx, float cy, float ql, float qr, float vx,
    float vy, float om, float qdl, float qdr, float d_imp, Geo& g) {
  float cbx = sh.cbx[p], cby = sh.cby[p];
  float rx = cbx * c - cby * s;
  float ry = cbx * s + cby * c;
  float px = cx + rx;
  float py = cy + ry;
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
  float surf_l = prm.surf_l0 + ql + f0;
  float surf_r = prm.surf_r0 + qr + f1;
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
  float qd_c0 = is_l ? qdl : qdr;
  float vn0 = (vx - om * ry) * nx + (vy + om * rx - qd_c0) * ny;
  g.rx = rx; g.ry = ry; g.nx = nx; g.ny = ny; g.tx = tx; g.ty = ty;
  g.rxn = rxn; g.rxt = rxt;
  g.sl = is_l ? 1.0f : 0.0f;
  g.sr = 1.0f - g.sl;
  g.tgt_n = (1.0f - d_imp * pc.b_con * prm.dt) * vn0
      + d_imp * prm.dt * pc.k_con * depth;
  g.w_nn = act * me_n / pc.c_r2;
  g.w_tt = act * me_t / pc.c_r2;
  float depth_el = act * clampf(depth, 0.0f, prm.depth_el_cap);
  g.cap_rough = pc.rough * me_t * depth_el;
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

// Coupled semi-smooth Newton on the 5-DOF soft-constraint energy
// (pallas2d.py:359-506): u = (vx, vy, om, qdl, qdr), in/out.
__device__ __forceinline__ void full_solve(
    const Shared& sh, const Pair& pc, const Rollout2DParams& prm, int P,
    int S, float c, float s, float cx, float cy, float ql, float qr,
    float vx, float vy, float om, float qdl, float qdr, float n_total,
    float w_w, float mg_dt, float d_imp, const float* uu, float* u) {
  for (int it = 0; it < prm.newton_iters; ++it) {
    // ---- pass over points: grip load, gradient and Hessian sums ----
    double s_lam = 0.0;
    double s_lnx = 0.0, s_ftx = 0.0, s_lny = 0.0, s_fty = 0.0;
    double s_lrxn = 0.0, s_ftrxt = 0.0, s_g3 = 0.0, s_g4 = 0.0;
    double Hs[5][5];
#pragma unroll
    for (int a = 0; a < 5; ++a)
#pragma unroll
      for (int b = 0; b < 5; ++b) Hs[a][b] = 0.0;
    for (int p = 0; p < P; ++p) {
      Geo g;
      point_geo(sh, pc, prm, p, c, s, cx, cy, ql, qr, vx, vy, om, qdl, qdr,
                d_imp, g);
      float vn, vt;
      point_vel(g, u, vn, vt);
      float res = mx(g.tgt_n - vn, 0.0f);
      float lam = g.w_nn * res;
      s_lam = s_lam + (double)lam;
      float cap_t = pc.mu_finger * lam + g.cap_rough;
      float f_t = clampf(g.w_tt * vt, -cap_t, cap_t);
      s_lnx = s_lnx + (double)(lam * g.nx);
      s_ftx = s_ftx + (double)(f_t * g.tx);
      s_lny = s_lny + (double)(lam * g.ny);
      s_fty = s_fty + (double)(f_t * g.ty);
      s_lrxn = s_lrxn + (double)(lam * g.rxn);
      s_ftrxt = s_ftrxt + (double)(f_t * g.rxt);
      s_g3 = s_g3 + (double)(g.sl * (lam * g.ny - f_t * g.ty));
      s_g4 = s_g4 + (double)(g.sr * (lam * g.ny - f_t * g.ty));
      float on_n = g.w_nn * ((res > 0.0f) ? 1.0f : 0.0f);
      float on_t = g.w_tt * ((fabsf(g.w_tt * vt) <= cap_t) ? 1.0f : 0.0f);
      float jn[5] = {g.nx, g.ny, g.rxn, -g.ny * g.sl, -g.ny * g.sr};
      float jt[5] = {g.tx, g.ty, g.rxt, -g.ty * g.sl, -g.ty * g.sr};
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        float yn = on_n * jn[a];
        float yt = on_t * jt[a];
#pragma unroll
        for (int b = a; b < 5; ++b) {
          if (a == 3 && b == 4) continue;
          Hs[a][b] = Hs[a][b] + (double)(yn * jn[b] + yt * jt[b]);
        }
      }
    }
    float grip = (float)s_lam / mg_dt;
    // ---- pass over plane supports: n_i, torsion cap, friction terms ----
    double s_ni = 0.0;
    for (int k = 0; k < S; ++k) {
      float n_i = sh.sw[k] * n_total / (1.0f + pc.unload * grip);
      s_ni = s_ni + (double)n_i;
    }
    float cap_w = pc.mu_torsion * (float)s_ni * prm.dt;
    double s_fx = 0.0, s_fy = 0.0, s_m = 0.0, s_fac = 0.0, s_f0 = 0.0,
           s_f1 = 0.0, s_f2 = 0.0;
    for (int k = 0; k < S; ++k) {
      float rsx = sh.sbx[k] * c - sh.sby[k] * s;
      float rsy = sh.sbx[k] * s + sh.sby[k] * c;
      float a_s = pc.inv_m + (rsx * rsx + rsy * rsy) * pc.inv_i * 0.5f;
      float w_s = 1.0f / (pc.c_r2 * a_s);
      float n_i = sh.sw[k] * n_total / (1.0f + pc.unload * grip);
      float cap_s = pc.mu_plane * n_i * prm.dt;
      float vsx = u[0] - u[2] * rsy;
      float vsy = u[1] + u[2] * rsx;
      float vs = sqrtf(vsx * vsx + vsy * vsy + 1e-16f);
      float fac = mn(w_s, cap_s / vs);
      float fx = fac * vsx, fy = fac * vsy;
      s_fx = s_fx + (double)fx;
      s_fy = s_fy + (double)fy;
      s_m = s_m + (double)(rsx * fy - rsy * fx);
      s_fac = s_fac + (double)fac;
      s_f0 = s_f0 + (double)(fac * (-rsy));
      s_f1 = s_f1 + (double)(fac * rsx);
      s_f2 = s_f2 + (double)(fac * (rsx * rsx + rsy * rsy));
    }
    float f_w = clampf(w_w * u[2], -cap_w, cap_w);
    float grad[5];
    grad[0] = pc.mass * (u[0] - uu[0]) - (float)s_lnx + (float)s_ftx
        + (float)s_fx;
    grad[1] = pc.mass * (u[1] - uu[1]) - (float)s_lny + (float)s_fty
        + (float)s_fy;
    grad[2] = pc.inertia * (u[2] - uu[2]) - (float)s_lrxn + (float)s_ftrxt
        + (float)s_m + f_w;
    grad[3] = pc.fmass_l * (u[3] - uu[3]) + (float)s_g3;
    grad[4] = pc.fmass_r * (u[4] - uu[4]) + (float)s_g4;
    float H[5][5];
#pragma unroll
    for (int a = 0; a < 5; ++a)
#pragma unroll
      for (int b = 0; b < 5; ++b) H[a][b] = (float)Hs[a][b];
    H[0][0] = H[0][0] + ((float)s_fac + pc.mass);
    H[1][1] = H[1][1] + ((float)s_fac + pc.mass);
    H[0][2] = H[0][2] + (float)s_f0;
    H[1][2] = H[1][2] + (float)s_f1;
    H[2][2] = H[2][2]
        + ((float)s_f2 + w_w * ((fabsf(w_w * u[2]) <= cap_w) ? 1.0f : 0.0f)
           + pc.inertia);
    H[3][3] = H[3][3] + pc.fmass_l;
    H[4][4] = H[4][4] + pc.fmass_r;

    // ---- unrolled 5x5 Cholesky solve of H d = -grad ----
    float L[5][5], Ld[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      float sa = H[a][a];
#pragma unroll
      for (int k = 0; k < a; ++k) sa = sa - L[a][k] * L[a][k];
      float dinv = rsq(mx(sa, 1e-12f));
      Ld[a] = dinv;
#pragma unroll
      for (int b = a + 1; b < 5; ++b) {
        float s2 = H[a][b];
#pragma unroll
        for (int k = 0; k < a; ++k) s2 = s2 - L[b][k] * L[a][k];
        L[b][a] = s2 * dinv;
      }
    }
    float yv[5], dv[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      float sa = -grad[a];
#pragma unroll
      for (int k = 0; k < a; ++k) sa = sa - L[a][k] * yv[k];
      yv[a] = sa * Ld[a];
    }
#pragma unroll
    for (int a = 4; a >= 0; --a) {
      float sa = yv[a];
#pragma unroll
      for (int k = a + 1; k < 5; ++k) sa = sa - L[k][a] * dv[k];
      dv[a] = sa * Ld[a];
    }
    float u1[5], u2[5];
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      u1[a] = u[a] + dv[a];
      u2[a] = u[a] + 0.5f * dv[a];
    }

    // ---- line search {1, 0.5}: energies of u, u1, u2 ----
    double en0 = 0.0, en1 = 0.0, en2 = 0.0;
    for (int p = 0; p < P; ++p) {
      Geo g;
      point_geo(sh, pc, prm, p, c, s, cx, cy, ql, qr, vx, vy, om, qdl, qdr,
                d_imp, g);
      float vn, vt;
      point_vel(g, u, vn, vt);
      float res = mx(g.tgt_n - vn, 0.0f);
      float cap_t = pc.mu_finger * (g.w_nn * res) + g.cap_rough;
      en0 = en0 + (double)(0.5f * g.w_nn * res * res + hub(vt, g.w_tt, cap_t));
      point_vel(g, u1, vn, vt);
      res = mx(g.tgt_n - vn, 0.0f);
      en1 = en1 + (double)(0.5f * g.w_nn * res * res + hub(vt, g.w_tt, cap_t));
      point_vel(g, u2, vn, vt);
      res = mx(g.tgt_n - vn, 0.0f);
      en2 = en2 + (double)(0.5f * g.w_nn * res * res + hub(vt, g.w_tt, cap_t));
    }
    double es0 = 0.0, es1 = 0.0, es2 = 0.0;
    for (int k = 0; k < S; ++k) {
      float rsx = sh.sbx[k] * c - sh.sby[k] * s;
      float rsy = sh.sbx[k] * s + sh.sby[k] * c;
      float a_s = pc.inv_m + (rsx * rsx + rsy * rsy) * pc.inv_i * 0.5f;
      float w_s = 1.0f / (pc.c_r2 * a_s);
      float n_i = sh.sw[k] * n_total / (1.0f + pc.unload * grip);
      float cap_s = pc.mu_plane * n_i * prm.dt;
      float vsx = u[0] - u[2] * rsy, vsy = u[1] + u[2] * rsx;
      es0 = es0 + (double)hub(sqrtf(vsx * vsx + vsy * vsy + 1e-16f), w_s, cap_s);
      vsx = u1[0] - u1[2] * rsy; vsy = u1[1] + u1[2] * rsx;
      es1 = es1 + (double)hub(sqrtf(vsx * vsx + vsy * vsy + 1e-16f), w_s, cap_s);
      vsx = u2[0] - u2[2] * rsy; vsy = u2[1] + u2[2] * rsx;
      es2 = es2 + (double)hub(sqrtf(vsx * vsx + vsy * vsy + 1e-16f), w_s, cap_s);
    }
    float e0 = e_unc(pc, u, uu) + (float)en0 + (float)es0
        + hub(u[2], w_w, cap_w);
    float e1 = e_unc(pc, u1, uu) + (float)en1 + (float)es1
        + hub(u1[2], w_w, cap_w);
    float e2 = e_unc(pc, u2, uu) + (float)en2 + (float)es2
        + hub(u2[2], w_w, cap_w);
    bool best12 = e1 <= e2;
    float eb = best12 ? e1 : e2;
    bool take_new = eb <= e0;
#pragma unroll
    for (int a = 0; a < 5; ++a)
      u[a] = take_new ? (best12 ? u1[a] : u2[a]) : u[a];
  }
}

// No finger contact reachable in the block: plane friction + torsion only,
// 2 Newton iterations on the 3-DOF subproblem (pallas2d.py:508-580).
__device__ __forceinline__ void cheap_solve(const Shared& sh, const Pair& pc,
                            const Rollout2DParams& prm, int S, float c,
                            float s, float n_total, float w_w,
                            const float* uu, float* u) {
  double s_ni = 0.0;
  for (int k = 0; k < S; ++k) s_ni = s_ni + (double)(sh.sw[k] * n_total);
  float cap_w = pc.mu_torsion * (float)s_ni * prm.dt;
  for (int it = 0; it < 2; ++it) {
    double s_fx = 0.0, s_fy = 0.0, s_m = 0.0, s_fac = 0.0, s_f0 = 0.0,
           s_f1 = 0.0, s_f2 = 0.0;
    for (int k = 0; k < S; ++k) {
      float rsx = sh.sbx[k] * c - sh.sby[k] * s;
      float rsy = sh.sbx[k] * s + sh.sby[k] * c;
      float a_s = pc.inv_m + (rsx * rsx + rsy * rsy) * pc.inv_i * 0.5f;
      float w_s = 1.0f / (pc.c_r2 * a_s);
      float cap_s = pc.mu_plane * (sh.sw[k] * n_total) * prm.dt;
      float vsx = u[0] - u[2] * rsy;
      float vsy = u[1] + u[2] * rsx;
      float vs = sqrtf(vsx * vsx + vsy * vsy + 1e-16f);
      float fac = mn(w_s, cap_s / vs);
      float fx = fac * vsx, fy = fac * vsy;
      s_fx = s_fx + (double)fx;
      s_fy = s_fy + (double)fy;
      s_m = s_m + (double)(rsx * fy - rsy * fx);
      s_fac = s_fac + (double)fac;
      s_f0 = s_f0 + (double)(fac * (-rsy));
      s_f1 = s_f1 + (double)(fac * rsx);
      s_f2 = s_f2 + (double)(fac * (rsx * rsx + rsy * rsy));
    }
    float f_w = clampf(w_w * u[2], -cap_w, cap_w);
    float g0 = pc.mass * (u[0] - uu[0]) + (float)s_fx;
    float g1 = pc.mass * (u[1] - uu[1]) + (float)s_fy;
    float g2 = pc.inertia * (u[2] - uu[2]) + f_w + (float)s_m;
    float h00 = pc.mass + (float)s_fac;
    float h11 = pc.mass + (float)s_fac;
    float h02 = (float)s_f0, h12 = (float)s_f1;
    float h22 = pc.inertia
        + w_w * ((fabsf(w_w * u[2]) <= cap_w) ? 1.0f : 0.0f) + (float)s_f2;
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
    float e[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* v = cand[q];
      double es = 0.0;
      for (int k = 0; k < S; ++k) {
        float rsx = sh.sbx[k] * c - sh.sby[k] * s;
        float rsy = sh.sbx[k] * s + sh.sby[k] * c;
        float a_s = pc.inv_m + (rsx * rsx + rsy * rsy) * pc.inv_i * 0.5f;
        float w_s = 1.0f / (pc.c_r2 * a_s);
        float cap_s = pc.mu_plane * (sh.sw[k] * n_total) * prm.dt;
        float vsx = v[0] - v[2] * rsy;
        float vsy = v[1] + v[2] * rsx;
        float vs = sqrtf(vsx * vsx + vsy * vsy + 1e-16f);
        float qq = 0.5f * w_s * vs * vs;
        float lin = cap_s * vs - 0.5f * cap_s * cap_s / mx(w_s, 1e-12f);
        es = es + (double)((w_s * vs <= cap_s) ? qq : lin);
      }
      float av = fabsf(v[2]);
      float qw = 0.5f * w_w * v[2] * v[2];
      float linw = cap_w * av - 0.5f * cap_w * cap_w / mx(w_w, 1e-12f);
      float ec = (float)es + ((w_w * av <= cap_w) ? qw : linw);
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

__global__ void __launch_bounds__(kLane)
rollout2d_kernel(const float* __restrict__ coefs,     // (B, 2, 6, 4)
                 const float* __restrict__ contour,   // (B, P, 2)
                 const float* __restrict__ support,   // (B, S, 4)
                 const float* __restrict__ scalars,   // (B, 1, 16)
                 const float* __restrict__ poses,     // (N, 3)
                 float* __restrict__ out,             // (8, B, N)
                 int B, int P, int S, int N, Rollout2DParams prm) {
  extern __shared__ float smem[];
  const int pair = blockIdx.y;
  const int tid = threadIdx.x;
  float* s_coef = smem;                       // 48
  float* s_scal = s_coef + 2 * kSeg * 4;      // 16
  float* s_cbx = s_scal + kScal;              // P
  float* s_cby = s_cbx + P;                   // P
  float* s_sbx = s_cby + P;                   // S
  float* s_sby = s_sbx + S;                   // S
  float* s_sw = s_sby + S;                    // S
  for (int k = tid; k < 2 * kSeg * 4; k += kLane)
    s_coef[k] = coefs[(size_t)pair * 2 * kSeg * 4 + k];
  if (tid < kScal) s_scal[tid] = scalars[(size_t)pair * kScal + tid];
  __syncthreads();
  const float com_bx = s_scal[3], com_by = s_scal[4];
  for (int k = tid; k < P; k += kLane) {
    s_cbx[k] = contour[((size_t)pair * P + k) * 2 + 0] - com_bx;
    s_cby[k] = contour[((size_t)pair * P + k) * 2 + 1] - com_by;
  }
  for (int k = tid; k < S; k += kLane) {
    s_sbx[k] = support[((size_t)pair * S + k) * 4 + 0] - com_bx;
    s_sby[k] = support[((size_t)pair * S + k) * 4 + 1] - com_by;
    s_sw[k] = support[((size_t)pair * S + k) * 4 + 2];
  }
  __syncthreads();

  const Shared sh{s_coef, s_cbx, s_cby, s_sbx, s_sby, s_sw};
  Pair pc;
  pc.mass = s_scal[0];
  pc.inertia = s_scal[1];
  pc.fmass_l = s_scal[2];
  pc.com_bx = com_bx;
  pc.com_by = com_by;
  pc.fmass_r = s_scal[5];
  pc.mu_plane = s_scal[6];
  pc.mu_finger = s_scal[7];
  pc.mu_torsion = s_scal[8];
  pc.k_con = s_scal[9];
  pc.b_con = s_scal[10];
  pc.unload = s_scal[11];
  pc.rough = s_scal[12];
  pc.c_r2 = s_scal[13];
  pc.broad_a = s_scal[14];
  pc.broad_b = s_scal[15];
  pc.inv_m = 1.0f / pc.mass;
  pc.inv_i = 1.0f / pc.inertia;
  pc.inv_fml = 1.0f / pc.fmass_l;
  pc.inv_fmr = 1.0f / pc.fmass_r;

  const int j = blockIdx.x * kLane + tid;     // pose index (N % 128 == 0)
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
  float scx = com_x, scy = com_y, sth = theta0;
  const float d_imp = prm.impedance;
  const float dt = prm.dt;

  for (int i = 0; i < prm.steps; ++i) {
    const bool is_rg =
        prm.regrasp_every > 0 && (i % prm.regrasp_every == 0) && i > 0;
    if (is_rg) {
      ql = 0.f; qr = 0.f; qdl = 0.f; qdr = 0.f;
      vx = 0.f; vy = 0.f; om = 0.f; vz = 0.f;
    }
    // ---- settled-travel gate (block max of |v|, block-any reachability)
    float mot = mx(mx(fabsf(vx), fabsf(vy)), mx(fabsf(om), fabsf(vz)));
    const bool unsettled = __syncthreads_or(!(mot < prm.eps_settled));
    float f_l = prm.kp * (prm.ctrl_l - ql) - prm.damping * qdl;
    float f_r = prm.kp * (prm.ctrl_r - qr) - prm.damping * qdr;
    float ql_n = ql + dt * (qdl + dt * f_l * pc.inv_fml);
    float qr_n = qr + dt * (qdr + dt * f_r * pc.inv_fmr);
    bool maybe = (cy - prm.marg <= pc.broad_a + mx(ql, ql_n))
        || (cy + prm.marg >= pc.broad_b + mn(qr, qr_n));
    const bool reach = __syncthreads_or(maybe);
    const bool travel = !unsettled && !reach && !is_rg;

    if (travel) {
      // only the finger servos advance
      qdl = qdl + dt * f_l * pc.inv_fml;
      qdr = qdr + dt * f_r * pc.inv_fmr;
      ql = ql + dt * qdl;
      qr = qr + dt * qdr;
    } else {
      const float c = cosf(th), s = sinf(th);
      const float depth_z = prm.plane_z - zb;
      const float n_total =
          pc.mass * mx(prm.k_plane * depth_z - prm.b_plane * vz, 0.0f);
      const float w_w = pc.inertia / pc.c_r2;
      const float mg_dt = pc.mass * prm.gravity * dt;
      vz = vz + dt * (-prm.gravity + n_total * pc.inv_m);
      float uu[5] = {vx, vy, om, qdl + dt * f_l * pc.inv_fml,
                     qdr + dt * f_r * pc.inv_fmr};
      float u[5] = {uu[0], uu[1], uu[2], uu[3], uu[4]};
      bool near = (cy <= pc.broad_a + ql) || (cy >= pc.broad_b + qr);
      const bool any_f = __syncthreads_or(near);
      if (any_f) {
        full_solve(sh, pc, prm, P, S, c, s, cx, cy, ql, qr, vx, vy, om,
                   qdl, qdr, n_total, w_w, mg_dt, d_imp, uu, u);
        cnt_f = cnt_f + 1.0f;
      } else {
        cheap_solve(sh, pc, prm, S, c, s, n_total, w_w, uu, u);
        cnt_c = cnt_c + 1.0f;
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
  if (prm.snapshot_step <= 0 || prm.snapshot_step >= prm.steps) {
    scx = cx; scy = cy; sth = th;
  }

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
}

}  // namespace

extern "C" int rollout2d_launch(const float* coefs, const float* contour,
                                const float* support, const float* scalars,
                                const float* poses, float* out, int B, int P,
                                int S, int N, Rollout2DParams prm,
                                void* stream) {
  if (B <= 0 || N <= 0 || N % kLane != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * kSeg * 4 + kScal + 2 * P + 3 * S);
  dim3 grid(N / kLane, B);
  rollout2d_kernel<<<grid, kLane, smem, (cudaStream_t)stream>>>(
      coefs, contour, support, scalars, poses, out, B, P, S, N, prm);
  return (int)cudaGetLastError();
}
