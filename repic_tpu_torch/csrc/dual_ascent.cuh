// The dual ascent on the vertex prices, shared by kernel 3 (dual.cu:
// the whole lp_device solve in one launch) and the ascent kernel
// (ascent.cu: the staged program's ascent alone): the staging of the
// valid cliques, the count pass, the loop of steps and the averaged
// prices (solver/dual.py: dual_ascent_plain), one block per micrograph.
//
// Float rules: the sum of lam[member] adds slot 0..K-1; the price step
// is one explicit fmaf (the reference's CPU program contracts that
// expression); the build's --fmad=false keeps every other expression
// unfused.  The counts ax are integers (the reference's float32 ax
// holds the same integers), so their atomics are order-independent.
//
// A width K of 0 is the instance for any clique width: the width is
// the run-time k, and the count pass reads a clique's members again
// for its scatter instead of holding them in registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the reference kernel pads C to its lane width; the objective sums run
// over that width
constexpr int kLane = 128;
// window of the reference's CPU tree reduction (solver/dual.py:
// SUM_WINDOW)
constexpr int kWindow = 32;
// cliques and vertices a thread takes at once in an ascent step, so
// that their loads overlap
constexpr int kUnroll = 4;

__host__ __device__ inline int sum_width(int c) {
  return (c + kLane - 1) / kLane * kLane;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// bytes of a staged member id
__host__ __device__ inline int id_bytes(int v) { return v <= 65535 ? 2 : 4; }

// the clique width: K, or the run-time k where K is 0
template <int K>
__device__ __forceinline__ int width(int k) {
  return K > 0 ? K : k;
}

__device__ __forceinline__ void bar(int& nbar) {
  __syncthreads();
  ++nbar;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Stage one micrograph's valid cliques, compacted in position order
// (one ballot scan a tile of kThreads positions): compacted clique `at`
// goes to near_mv/near_w while at < n_near, else to far_mv/far_w at
// at - n_near.  Kernel 3 passes pos and win (its rounding needs each
// clique's position and the first compacted index of each objective
// window); the ascent kernel passes null.  Returns the number of valid
// cliques, and eta0 = max(max(wv), 1e-6): the max over the valid
// weights and over the zeros of the invalid rows, which the 1e-6 floor
// absorbs.
template <typename VT, int K>
__device__ __forceinline__ int stage(const int* __restrict__ mv,
                                     const float* __restrict__ w,
                                     const uint8_t* __restrict__ valid,
                                     int c, int k, VT* near_mv,
                                     float* near_w, int n_near, VT* far_mv,
                                     float* far_w, int* pos, int* win,
                                     int (*tile_cnt)[kWarps], float* red_f,
                                     float& eta0, int& nbar) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kk = width<K>(k);
  const int nwin = sum_width(c) / kWindow;
  const unsigned below = (1u << lane) - 1u;
  int nv = 0;
  float wmax = 0.0f;
  int it = 0;
  for (int t0 = 0; t0 < c; t0 += kThreads, ++it) {
    const int i = t0 + tid;
    const bool ok = i < c && valid[i];
    const unsigned bal = __ballot_sync(kFull, ok);
    if (lane == 0) tile_cnt[it & 1][warp] = __popc(bal);
    bar(nbar);
    int before = 0, tile = 0;
    for (int x = 0; x < kWarps; ++x) {
      const int cnt = tile_cnt[it & 1][x];
      if (x < warp) before += cnt;
      tile += cnt;
    }
    // the warp covers positions [t0 + 32 warp, +32): objective window
    // (t0 >> 5) + warp, which starts at compacted index nv + before
    const int wj = (t0 >> 5) + warp;
    if (win != nullptr && lane == 0 && wj < nwin) win[wj] = nv + before;
    if (ok) {
      const int at = nv + before + __popc(bal & below);
      VT* dst = at < n_near ? near_mv + (size_t)at * kk
                            : far_mv + (size_t)(at - n_near) * kk;
#pragma unroll
      for (int j = 0; j < kk; ++j) dst[j] = (VT)mv[(size_t)i * kk + j];
      if (at < n_near)
        near_w[at] = w[i];
      else
        far_w[at - n_near] = w[i];
      if (pos != nullptr) pos[at] = i;
      wmax = fmaxf(wmax, w[i]);
    }
    nv += tile;
  }
  if (win != nullptr) {
    // windows past the last tile hold no clique
    for (int j = it * kWarps + tid; j <= nwin; j += nt) win[j] = nv;
    if (tid == 0 && it * kWarps > nwin) win[nwin] = nv;
  }
  wmax = warp_max(wmax);
  if (lane == 0) red_f[warp] = wmax;
  bar(nbar);
  float e = red_f[0];
  for (int x = 1; x < kWarps; ++x) e = fmaxf(e, red_f[x]);
  eta0 = fmaxf(e, 1e-6f);
  return nv;
}

// ax += 1 at the members of each of the n staged cliques (ids mv,
// weights w) of positive reduced cost w - sum(lam[member]) (integer
// counts: the float32 ax of the plain loop, exactly)
template <typename VT, int K>
__device__ __forceinline__ void count_pass(const VT* __restrict__ mv,
                                           const float* __restrict__ w,
                                           int n, int k,
                                           const float* __restrict__ lam,
                                           int* __restrict__ ax) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if constexpr (K == 0) {
    for (int idx = tid; idx < n; idx += nt) {
      const VT* r = mv + (size_t)idx * k;
      float s = lam[r[0]];
      for (int j = 1; j < k; ++j) s = s + lam[r[j]];
      if (w[idx] - s > 0.0f)
        for (int j = 0; j < k; ++j) atomicAdd(&ax[r[j]], 1);
    }
  } else {
    for (int b = tid; b < n; b += kUnroll * nt) {
      VT r[kUnroll][K];
      bool pos[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // past n: a copy of the last clique's members, never scattered
        // (unconditional loads keep the batch's loads overlapped)
        const int idx = min(b + u * nt, n - 1);
#pragma unroll
        for (int j = 0; j < K; ++j) r[u][j] = mv[(size_t)idx * K + j];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = b + u * nt;
        pos[u] = false;
        if (idx < n) {
          float s = lam[r[u][0]];
#pragma unroll
          for (int j = 1; j < K; ++j) s = s + lam[r[u][j]];
          pos[u] = w[idx] - s > 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (pos[u]) {
#pragma unroll
          for (int j = 0; j < K; ++j) atomicAdd(&ax[r[u][j]], 1);
        }
    }
  }
}

struct Ascent {
  int t, n_tail;
  float delta;
};

// The dual ascent of one micrograph (solver/dual.py:
// dual_ascent_plain): at most num_iters steps, stopping once
// max|dlam| / eta0 <= tol, the tail from step num_iters / 2 summed into
// lam_sum.  The staged cliques are n0 at mv0/w0 and n1 at mv1/w1 (kernel
// 3 keeps them in one place; the ascent kernel splits them between
// shared memory and a global slice).  Two barriers a step: the count
// pass, then the price pass, which reads and clears ax (each vertex by
// its own thread) and reduces max|dlam| per warp with
// __reduce_max_sync on the float bits (every value is >= +0); the
// per-warp maxima are read after the barrier the next step needs
// anyway.
template <typename VT, int K>
__device__ __forceinline__ Ascent ascent(const VT* mv0, const float* w0,
                                         int n0, const VT* mv1,
                                         const float* w1, int n1, int k,
                                         float* __restrict__ lam,
                                         float* __restrict__ lam_sum,
                                         int* __restrict__ ax, int v,
                                         float eta0, int num_iters,
                                         float tol, unsigned* red_u,
                                         int& nbar) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int half = num_iters / 2;
  Ascent a = {0, 0, INFINITY};
  while (a.t < num_iters && a.delta > tol) {
    count_pass<VT, K>(mv0, w0, n0, k, lam, ax);
    count_pass<VT, K>(mv1, w1, n1, k, lam, ax);
    bar(nbar);
    const float eta = eta0 / (1.0f + (float)a.t);
    const bool in_tail = a.t >= half;
    unsigned dmax = 0u;
    for (int b = tid; b < v; b += kUnroll * nt) {
      float cnt[kUnroll], old[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = b + u * nt;
        if (j < v) {
          cnt[u] = (float)ax[j];
          old[u] = lam[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = b + u * nt;
        if (j < v) {
          const float nw = fmaxf(fmaf(eta, cnt[u] - 1.0f, old[u]), 0.0f);
          dmax = max(dmax, __float_as_uint(fabsf(nw - old[u])));
          ax[j] = 0;
          lam[j] = nw;
          if (in_tail) lam_sum[j] = lam_sum[j] + nw;
        }
      }
    }
    dmax = __reduce_max_sync(kFull, dmax);
    if (lane == 0) red_u[warp] = dmax;
    bar(nbar);
    dmax = __reduce_max_sync(kFull, red_u[lane < kWarps ? lane : 0]);
    a.delta = __uint_as_float(dmax) / eta0;
    a.n_tail += in_tail;
    ++a.t;
  }
  return a;
}

// zero prices and counts, each vertex by the thread that later steps it
__device__ __forceinline__ void clear_state(float* lam, float* lam_sum,
                                            int* ax, int v) {
  for (int j = threadIdx.x; j < v; j += blockDim.x) {
    lam[j] = 0.0f;
    lam_sum[j] = 0.0f;
    ax[j] = 0;
  }
}

// the averaged prices lam_sum / n_tail (lam where the tail is empty)
// into avg, which may be lam_sum itself; each vertex by the thread that
// wrote it
__device__ __forceinline__ void average(const float* lam,
                                        const float* lam_sum, float* avg,
                                        int v, int n_tail) {
  for (int j = threadIdx.x; j < v; j += blockDim.x)
    avg[j] = n_tail > 0 ? lam_sum[j] / (float)max(n_tail, 1) : lam[j];
}
