// Parts shared by the two rollout kernels (K1 csrc/rollout2d.cu, K2
// csrc/rollout3d.cu) for NVIDIA Hopper (sm_90a).
//
// Layout. A *pose group* is 128 rollouts of one pair: the cell on which the
// Pallas kernels decide their block-uniform branches. G threads carry one
// rollout (G lanes of one warp; G = 32, a whole warp, or 16); lane r of the
// rollout handles the points p = r, r + G, ... and every lane of the
// rollout carries the rollout's state and does its small dense algebra
// redundantly, so nothing is broadcast. A pose group is therefore 128 * G
// threads: one thread block cluster of Layout<G>::kCluster blocks of
// Layout<G>::kThreads threads.
//
// Point sums. Each lane accumulates its points in float64 in increasing p,
// the G partial sums are added by an xor butterfly (strides G/2, ..., 1:
// the same value on every lane, since a + b == b + a), and the total rounds
// once to float32. dgdm_tpu_torch/sim/point_sum.py computes the same order.
// A pass that ends in several sums can reduce them as one vector
// (group_sum_vec): a reduce-scatter over the same strides, in which a lane
// keeps half of the values it still holds at each stride and adds its
// partner's partial of them, so that each value is added over the same
// pairs of lanes as by the butterfly and has its bits; each total then
// rounds once on the lane where it ended and is broadcast as a float32
// (group_sum_vec), or is stored to shared memory by that lane alone
// (group_sum_park). For 8 values over 32 lanes that is 9 float64 exchanges
// and 8 float32 ones, where 8 butterflies take 40 float64 exchanges; for 26
// values 27 float64 exchanges, where 26 butterflies take 130. With more
// values than lanes a lane ends with several totals (group_sum_wide): 23
// values over 16 lanes take 23 exchanges, where 23 butterflies take 92.
//
// Group votes. GroupVote ORs one or two bits over all 128 * G threads of a
// pose group: __syncthreads_or inside each block, then threads
// 0..kCluster-1 of each block store the block's bits into their block's slot
// in every block of the cluster through distributed shared memory, one
// cluster barrier, and every block ORs its kCluster slots. The slots are
// double-buffered by vote parity: a block can run at most one vote ahead of
// a peer (it cannot pass the next cluster barrier before the peer arrives
// there, and the peer arrives only after it has read the current slots), so
// one barrier a vote is enough. GroupVote::any2_max carries two bits and a
// max of non-negative floats in one such vote (two words a block slot).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rollout {

namespace cg = cooperative_groups;

constexpr int kGroup = 128;   // rollouts per pose group

// The two layouts. Each keeps a thread at <= 128 registers, so that an SM
// holds 16 warps: one 512-thread block (G = 32, K2) or two 256-thread blocks
// (G = 16, K1); a pose group is a cluster of 8 blocks either way. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W, each of the two led its kernel over the
// other and over G = 8 at the verification shape, at the datagen shape and at
// every count of pose groups from 16 to 384, so the launchers choose nothing
// and no other layout is built. One thread a rollout (one 128-thread block a
// pose group, ~160 registers, no cluster) had lost to these too.
template <int G>
struct Layout {
  static_assert(G == 16 || G == 32, "unsupported G");
  static constexpr int kThreads = G == 32 ? 512 : 256;
  // blocks an SM must be able to hold (bounds the registers a thread)
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr int kCluster = kGroup * G / kThreads;   // 8
  static constexpr int kRollouts = kThreads / G;   // rollouts of one block
};

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

// The thread's lane within its rollout (0..G-1; a rollout's G lanes are an
// aligned run of one warp's lanes). Read from %laneid at every use and not
// kept: the one register it would hold across a whole solve is the one
// that does not fit beside the float64 sums at 128 registers a thread.
template <int G>
__device__ __forceinline__ int lane_in_rollout() {
  unsigned lane;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  return (int)(lane % G);
}

// Total of the G lanes' float64 partial sums, rounded once to float32.
template <int G>
__device__ __forceinline__ float group_sum(double v) {
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return (float)v;
}

namespace detail {

// One stride M of group_sum_vec's reduce-scatter, with C values held (the
// first C entries of v; a lane holds C - 1 real ones and a padding value
// where an earlier stride split an odd count). A lane whose bit M is clear
// keeps the first H = ceil(C / 2) of them, its partner the rest (padded to
// H), and each adds the other's partial of what it keeps. From C == 1 on,
// the remaining strides are group_sum's butterfly.
template <int M, int C, int N>
__device__ __forceinline__ void vec_stride(double (&v)[N], int lane) {
  if constexpr (M >= 1) {
    if constexpr (C == 1) {
      v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], M);
      vec_stride<M / 2, 1, N>(v, lane);
    } else {
      constexpr int H = (C + 1) / 2;
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const double hi = H + j < C ? v[H + j < C ? H + j : 0] : 0.0;
        const double mine = up ? hi : v[j];
        const double send = up ? v[j] : hi;
        v[j] = mine + __shfl_xor_sync(0xffffffffu, send, M);
      }
      vec_stride<M / 2, H, N>(v, lane);
    }
  }
}

// The lane (within its rollout) on which value q of C held at stride M
// ends: the strides at which q lies in the upper half.
template <int M, int C>
__host__ __device__ constexpr int vec_owner(int q) {
  if constexpr (M == 0) {
    return 0;
  } else if constexpr (C == 1) {
    return vec_owner<M / 2, 1>(q);
  } else {
    constexpr int H = (C + 1) / 2;
    return q < H ? vec_owner<M / 2, H>(q) : M + vec_owner<M / 2, H>(q - H);
  }
}

// The inverse of vec_owner: the value (of C held at stride M, the first R of
// them real) whose owner is `lane`, or -1 where the lane owns none (it holds
// padding, or a butterfly copy of a total whose owner has the lower bits
// clear).
template <int M, int C, int R>
__device__ __forceinline__ int vec_slot(int lane) {
  if constexpr (R <= 0) {
    return -1;
  } else if constexpr (M == 0) {
    return 0;
  } else if constexpr (C == 1) {
    return (lane & M) ? -1 : vec_slot<M / 2, 1, R>(lane);
  } else {
    constexpr int H = (C + 1) / 2;
    if (lane & M) {
      const int s = vec_slot<M / 2, H, R - H>(lane);
      return s < 0 ? -1 : H + s;
    }
    return vec_slot<M / 2, H, (R < H ? R : H)>(lane);
  }
}

}  // namespace detail

// The totals of N float64 partial sums over the G lanes, each rounded once
// to float32, in out[] on every lane: bitwise the N group_sum calls (see
// "Point sums" above). v is consumed.
template <int G, int N>
__device__ __forceinline__ void group_sum_vec(double (&v)[N],
                                              float (&out)[N]) {
  detail::vec_stride<G / 2, N, N>(v, lane_in_rollout<G>());
  if constexpr (N == 1) {
    out[0] = (float)v[0];
  } else {
    const float t = (float)v[0];
#pragma unroll
    for (int q = 0; q < N; ++q)
      out[q] = __shfl_sync(0xffffffffu, t, detail::vec_owner<G / 2, N>(q), G);
  }
}

// The same reduce-scatter, but no broadcast: the lane on which total q ends
// (detail::vec_owner) stores it, rounded once to float32, to dst[q], one
// predicated store a lane. Returns the rounded value the lane holds, so that
// a caller broadcasts only the totals every lane needs:
// __shfl_sync(0xffffffffu, t, detail::vec_owner<G / 2, N>(q), G). v is
// consumed.
template <int G, int N>
__device__ __forceinline__ float group_sum_park(double (&v)[N], float* dst) {
  static_assert(N <= G, "one total a lane at most");
  const int lane = lane_in_rollout<G>();
  detail::vec_stride<G / 2, N, N>(v, lane);
  const float t = (float)v[0];
  const int q = detail::vec_slot<G / 2, N, N>(lane);
  if (q >= 0) dst[q] = t;
  return t;
}

namespace detail {

// The number of values a lane holds after the last stride of the
// reduce-scatter of C values from stride M (padding included): 1 for
// C <= 2M, ceil(C / 2M) beyond.
template <int M, int C>
__host__ __device__ constexpr int vec_held() {
  if constexpr (M == 0 || C == 1) {
    return C;
  } else {
    return vec_held<M / 2, (C + 1) / 2>();
  }
}

// The index, among the vec_held values of its owner lane (vec_owner), at
// which value q of C held at stride M ends.
template <int M, int C>
__host__ __device__ constexpr int vec_index(int q) {
  if constexpr (M == 0) {
    return q;
  } else if constexpr (C == 1) {
    return 0;
  } else {
    constexpr int H = (C + 1) / 2;
    return vec_index<M / 2, H>(q < H ? q : q - H);
  }
}

}  // namespace detail

// group_sum_vec for any N, more values than lanes included (K1 Newton's 23
// contour-pass sums at G = 16): the same reduce-scatter, after which a lane
// holds detail::vec_held values; each rounds once to float32 on its lane,
// and total q is broadcast from lane detail::vec_owner's value
// detail::vec_index. Bitwise the N group_sum calls; for N <= G it is
// group_sum_vec. v is consumed.
template <int G, int N>
__device__ __forceinline__ void group_sum_wide(double (&v)[N],
                                               float (&out)[N]) {
  detail::vec_stride<G / 2, N, N>(v, lane_in_rollout<G>());
  constexpr int K = detail::vec_held<G / 2, N>();
  float t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = (float)v[k];
#pragma unroll
  for (int q = 0; q < N; ++q)
    out[q] = __shfl_sync(0xffffffffu, t[detail::vec_index<G / 2, N>(q)],
                         detail::vec_owner<G / 2, N>(q), G);
}

// NaN-propagating min / max over the G lanes (exact under any order).
template <int G>
__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1)
    v = mn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int m = G / 2; m >= 1; m >>= 1)
    v = mx(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// OR of vote bits over a pose group. `slots` points at 2 * kCluster ints of
// this block's shared memory. Every thread of
// the cluster calls each vote, in the same order.
template <int CS>
struct GroupVote {
  int* slots;
  int parity;

  __device__ __forceinline__ void init(int* s) {
    slots = s;
    parity = 0;
    // no block may store into a peer that has not started
    cg::this_cluster().sync();
  }

  __device__ __forceinline__ int across(int mine) {
    cg::cluster_group cluster = cg::this_cluster();
    const int base = parity * CS;
    if (threadIdx.x < CS) {
      int* peer = cluster.map_shared_rank(
          slots + base + (int)cluster.block_rank(), threadIdx.x);
      *peer = mine;
    }
    cluster.sync();
    const volatile int* s = slots;
    int r = 0;
#pragma unroll
    for (int k = 0; k < CS; ++k) r |= s[base + k];
    parity ^= 1;
    return r;
  }

  // Two independent bits (-> bit 0 | bit 1 << 1, as any2) and the max over
  // the pose group of non-negative floats (into `vmax`; their bit patterns
  // order as unsigned integers, +inf and NaN above every finite value), in
  // one exchange: each warp's __any_sync bits and __reduce_max_sync of the
  // bit patterns go to `warp_slots` (2 * 32 words by parity: W maxima, then
  // W bit words), one block barrier, threads 0..kCluster-1 fold the W warps
  // and store the block's max and bits into their block's two words in every
  // block of the cluster (`pair_slots`: 4 * kCluster words of this block's
  // shared memory, by the vote parity), one cluster barrier, and every
  // thread folds the kCluster pairs. W is the number of warps a block.
  template <int W>
  __device__ __forceinline__ int any2_max(bool b0, bool b1, float v,
                                          unsigned* warp_slots,
                                          unsigned* pair_slots,
                                          float& vmax) {
    static_assert(2 * W <= 32, "warp_slots hold 32 words a parity");
    const unsigned bits = (__any_sync(0xffffffffu, b0) ? 1u : 0u) |
                          (__any_sync(0xffffffffu, b1) ? 2u : 0u);
    const unsigned w = __reduce_max_sync(0xffffffffu, __float_as_uint(v));
    unsigned* ws = warp_slots + parity * 32;
    if ((threadIdx.x & 31) == 0) {
      ws[threadIdx.x >> 5] = w;
      ws[W + (threadIdx.x >> 5)] = bits;
    }
    __syncthreads();
    cg::cluster_group cluster = cg::this_cluster();
    const int base = parity * 2 * CS;
    if (threadIdx.x < CS) {
      unsigned m = 0u, b = 0u;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        m = max(m, ws[k]);
        b |= ws[W + k];
      }
      unsigned* peer = cluster.map_shared_rank(
          pair_slots + base + 2 * (int)cluster.block_rank(), threadIdx.x);
      peer[0] = m;
      peer[1] = b;
    }
    cluster.sync();
    const volatile unsigned* s = pair_slots + base;
    unsigned m = 0u, b = 0u;
#pragma unroll
    for (int k = 0; k < CS; ++k) {
      m = max(m, s[2 * k]);
      b |= s[2 * k + 1];
    }
    parity ^= 1;
    vmax = __uint_as_float(m);
    return (int)b;
  }

  // one bit
  __device__ __forceinline__ bool any(bool b) {
    return across(__syncthreads_or(b) ? 1 : 0) != 0;
  }
  // two independent bits behind one cluster barrier -> bit 0 | bit 1 << 1
  __device__ __forceinline__ int any2(bool b0, bool b1) {
    const int v0 = __syncthreads_or(b0) ? 1 : 0;
    const int v1 = __syncthreads_or(b1) ? 2 : 0;
    return across(v0 | v1);
  }

  // no block may leave while a peer can still store into it or read it
  __device__ __forceinline__ void finish() {
    cg::this_cluster().sync();
  }
};

// Unrolled Cholesky solve of H d = -grad over the upper triangle of H
// (rsqrt(max(s, 1e-12)) on the diagonal, as the Pallas kernels write it).
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

// The layout of a launch (filled by launch_clusters): threads per rollout,
// blocks per cluster, threads per block, cudaOccupancyMaxActiveClusters and
// the bytes of shared memory a block.
struct Plan {
  int g, cluster, threads, max_active_clusters, smem;
};

// Launch `kernel` as clusters of LO::kCluster blocks of LO::kThreads threads
// with `smem` bytes of shared memory a block on `stream`; allocates nothing
// and does not synchronise. Fills `plan` (unless null) and returns a
// cudaError_t, without launching: cudaErrorInvalidValue when `smem` is more
// than a block may have on this card (the per-point geometry that the kernels
// hold there grows with the point count), cudaErrorLaunchOutOfResources when
// the card cannot hold even one such cluster.
template <class LO, class... KArgs, class... Args>
int launch_clusters(void (*kernel)(KArgs...), dim3 grid, size_t smem,
                    cudaStream_t stream, Plan* plan, int g, Args... args) {
  if (plan != nullptr) {
    plan->g = g;
    plan->cluster = LO::kCluster;
    plan->threads = LO::kThreads;
    plan->max_active_clusters = 0;
    plan->smem = (int)smem;
  }
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)most) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(LO::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = LO::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(
      &active, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) return (int)e;
  if (plan != nullptr) plan->max_active_clusters = active;
  if (active == 0) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace rollout
