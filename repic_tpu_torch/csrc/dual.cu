// Fused dual-decomposition LP solve on Hopper: one block per micrograph.
//
// Replaces the TPU kernel repic_tpu/ops/megakernel.py: fused_dual_solve
// (kernel body _solve_kernel), which runs
// repic_tpu/solver/dual.py: solve_dual_decomposition in one program:
// projected dual ascent on the vertex prices (at most num_iters steps,
// early exit once max|dlam| / eta0 <= tol, Polyak tail average), then
// three rounding candidates (zero, final and averaged prices), each a
// greedy pass in reduced-cost order plus a greedy repair pass by raw
// weight, and the best by true objective (first maximum).
//
// Design: the block keeps the prices (lam, lam_sum, ax), the greedy
// scratch (best_w, best_idx, used; V + 1 each, slot V the sentinel)
// and the per-clique flags in dynamic shared memory when they fit,
// in a global scratch slice otherwise.  The greedy fixpoint rounds
// synchronise at block level.  Atomics appear only where the result
// is order-independent: the ax scatter of 1.0 (exact integer counts),
// float max of positive priorities (as int bits) and int min of clique
// indices.  Every other sum has a fixed order: lam[member_vertex] adds
// slot 0..K-1, and the float32 objective sums take the reference's CPU
// order (objective_sum below) over the reference kernel's width, C
// rounded up to a multiple of 128.  The price step is one explicit
// fmaf — the reference's CPU program contracts that expression too;
// the build's --fmad=false keeps every other expression unfused.
//
// Bound on this card: operations and latency — per iteration O(C K)
// gathers plus O(V) updates, ~20 block barriers per greedy round;
// one block per micrograph leaves most SMs idle at 32 micrographs.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
// the reference kernel pads C to its lane width; the objective sums run
// over that width
constexpr int kLane = 128;
// window of the reference's CPU tree reduction (solver/dual.py:
// SUM_WINDOW)
constexpr int kWindow = 32;

__host__ __device__ inline int sum_width(int c) {
  return (c + kLane - 1) / kLane * kLane;
}

struct Layout {
  size_t lam, lam_sum, ax, best_w, prio, best_idx, used, alive, cur,
      cand, sums, total;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__host__ __device__ inline Layout make_layout(int c, int v) {
  Layout L;
  size_t o = 0;
  L.lam = o;      o = align16(o + 4 * (size_t)v);
  L.lam_sum = o;  o = align16(o + 4 * (size_t)v);
  L.ax = o;       o = align16(o + 4 * (size_t)(v + 1));
  L.best_w = o;   o = align16(o + 4 * (size_t)(v + 1));
  L.prio = o;     o = align16(o + 4 * (size_t)c);
  L.best_idx = o; o = align16(o + 4 * (size_t)(v + 1));
  L.used = o;     o = align16(o + (size_t)(v + 1));
  L.alive = o;    o = align16(o + (size_t)c);
  L.cur = o;      o = align16(o + (size_t)c);
  L.cand = o;     o = align16(o + 3 * (size_t)c);
  // two buffers of window sums, each sum_width(c) / kWindow floats
  L.sums = o;     o = align16(o + 8 * (size_t)(sum_width(c) / kWindow));
  L.total = o;
  return L;
}

__device__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = fmaxf(r, red[i]);
  return r;
}

struct Solve {
  const int* mv;        // (C, K) of this micrograph
  const float* w;       // (C,)
  const uint8_t* valid; // (C,)
  int c, k, v;
  float* lam;
  float* lam_sum;
  float* ax;
  float* best_w;
  float* prio;
  int* best_idx;
  uint8_t* used;
  uint8_t* alive;  // 0 dead, 1 alive, 2 selected this round
  uint8_t* cur;
};

__device__ inline float wv_of(const Solve& S, int i) {
  return S.valid[i] ? S.w[i] : 0.0f;
}

__device__ inline float gather_sum(const Solve& S, const float* prices,
                                   int i) {
  const int* r = S.mv + (size_t)i * S.k;
  float s = prices[r[0]];
  for (int j = 1; j < S.k; ++j) s = s + prices[r[j]];
  return s;
}

// Float32 sum of the picked weights (cur) over a row of sum_width(c)
// terms, those past c zero, in the order of solver/dual.py:
// objective_sum: while more than kWindow terms remain, zero-pad to a
// multiple of kWindow (half the padding in front) and replace the row
// by its window sums; then add what is left.  Every sum starts at 0 and
// adds in index order.  The levels alternate between the two halves of
// sums.
__device__ float objective_sum(const Solve& S, float* sums, float* out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int half = sum_width(S.c) / kWindow;
  const float* src = nullptr;  // nullptr: the terms themselves
  float* dst = sums;
  int len = sum_width(S.c);
  while (len > kWindow) {
    const int pad = (kWindow - len % kWindow) % kWindow, lo = pad / 2;
    const int n = (len + pad) / kWindow;
    for (int j = tid; j < n; j += nt) {
      float acc = 0.0f;
      for (int e = 0; e < kWindow; ++e) {
        const int i = j * kWindow - lo + e;
        float x = 0.0f;
        if (i >= 0 && i < len)
          x = src ? src[i] : (i < S.c && S.cur[i] ? wv_of(S, i) : 0.0f);
        acc = acc + x;
      }
      dst[j] = acc;
    }
    __syncthreads();
    src = dst;
    dst = dst == sums ? sums + half : sums;
    len = n;
  }
  if (tid == 0) {
    float acc = 0.0f;
    for (int i = 0; i < len; ++i)
      acc = acc + (src ? src[i] : (i < S.c && S.cur[i] ? wv_of(S, i) : 0.0f));
    *out = acc;
  }
  __syncthreads();
  return *out;
}

// solve_greedy to its fixpoint over the cliques marked alive (prio > 0
// required by the caller); picks are OR-ed into cur.
__device__ void greedy(const Solve& S) {
  const int c = S.c, k = S.k, v = S.v;
  const int tid = threadIdx.x, nt = blockDim.x;
  bool any = false;
  for (int i = tid; i < c; i += nt) any = any || S.alive[i];
  while (__syncthreads_or(any)) {
    for (int j = tid; j <= v; j += nt) {
      S.best_w[j] = -INFINITY;
      S.best_idx[j] = INT_MAX;
      S.used[j] = 0;
    }
    __syncthreads();
    for (int i = tid; i < c; i += nt) {
      if (!S.alive[i]) continue;
      const int* r = S.mv + (size_t)i * k;
      const int bits = __float_as_int(S.prio[i]);  // prio > 0
      for (int j = 0; j < k; ++j) atomicMax((int*)&S.best_w[r[j]], bits);
    }
    __syncthreads();
    for (int i = tid; i < c; i += nt) {
      if (!S.alive[i]) continue;
      const int* r = S.mv + (size_t)i * k;
      for (int j = 0; j < k; ++j)
        if (S.prio[i] >= S.best_w[r[j]]) atomicMin(&S.best_idx[r[j]], i);
    }
    __syncthreads();
    for (int i = tid; i < c; i += nt) {
      if (!S.alive[i]) continue;
      const int* r = S.mv + (size_t)i * k;
      bool sel = true;
      for (int j = 0; j < k; ++j)
        sel = sel && S.prio[i] >= S.best_w[r[j]] && S.best_idx[r[j]] == i;
      if (sel) {
        S.alive[i] = 2;
        for (int j = 0; j < k; ++j) S.used[r[j]] = 1;
      }
    }
    __syncthreads();
    any = false;
    for (int i = tid; i < c; i += nt) {
      if (!S.alive[i]) continue;
      if (S.alive[i] == 2) {
        S.cur[i] = 1;
        S.alive[i] = 0;
        continue;
      }
      const int* r = S.mv + (size_t)i * k;
      bool hit = false;
      for (int j = 0; j < k; ++j) hit = hit || S.used[r[j]];
      if (hit) S.alive[i] = 0;
      any = any || S.alive[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    dual_solve_kernel(const int* __restrict__ mv_all,
                      const float* __restrict__ w_all,
                      const uint8_t* __restrict__ valid_all,
                      uint8_t* __restrict__ picked_all, uint8_t* scratch,
                      int c, int k, int v, int num_iters, int use_smem,
                      float tol) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red_f[32];
  __shared__ float sum_out;
  const int m = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = make_layout(c, v);
  uint8_t* base = use_smem ? smem : scratch + (size_t)m * L.total;
  Solve S;
  S.mv = mv_all + (size_t)m * c * k;
  S.w = w_all + (size_t)m * c;
  S.valid = valid_all + (size_t)m * c;
  S.c = c;
  S.k = k;
  S.v = v;
  S.lam = (float*)(base + L.lam);
  S.lam_sum = (float*)(base + L.lam_sum);
  S.ax = (float*)(base + L.ax);
  S.best_w = (float*)(base + L.best_w);
  S.prio = (float*)(base + L.prio);
  S.best_idx = (int*)(base + L.best_idx);
  S.used = base + L.used;
  S.alive = base + L.alive;
  S.cur = base + L.cur;
  uint8_t* cand = base + L.cand;
  float* sums = (float*)(base + L.sums);

  // eta0 = max(max(wv), 1e-6)
  float mx = -INFINITY;
  for (int i = tid; i < c; i += nt) mx = fmaxf(mx, wv_of(S, i));
  const float eta0 = fmaxf(block_max(mx, red_f), 1e-6f);
  for (int j = tid; j < v; j += nt) {
    S.lam[j] = 0.0f;
    S.lam_sum[j] = 0.0f;
  }
  const int half = num_iters / 2;
  int t = 0, n_tail = 0;
  float delta = INFINITY;
  while (t < num_iters && delta > tol) {
    for (int j = tid; j <= v; j += nt) S.ax[j] = 0.0f;
    __syncthreads();
    for (int i = tid; i < c; i += nt) {
      if (!S.valid[i]) continue;
      const float red = S.w[i] - gather_sum(S, S.lam, i);
      if (red > 0.0f) {
        const int* r = S.mv + (size_t)i * k;
        for (int j = 0; j < k; ++j) atomicAdd(&S.ax[r[j]], 1.0f);
      }
    }
    __syncthreads();
    const float eta = eta0 / (1.0f + (float)t);
    const bool in_tail = t >= half;
    float dmax = 0.0f;
    for (int j = tid; j < v; j += nt) {
      const float old = S.lam[j];
      const float nw = fmaxf(fmaf(eta, S.ax[j] - 1.0f, old), 0.0f);
      dmax = fmaxf(dmax, fabsf(nw - old));
      S.lam[j] = nw;
      if (in_tail) S.lam_sum[j] = S.lam_sum[j] + nw;
    }
    delta = block_max(dmax, red_f) / eta0;
    n_tail += in_tail;
    ++t;
  }
  __syncthreads();
  // lam_sum becomes the averaged prices
  for (int j = tid; j < v; j += nt)
    S.lam_sum[j] = n_tail > 0 ? S.lam_sum[j] / (float)max(n_tail, 1)
                              : S.lam[j];
  __syncthreads();

  float vals[3];
  for (int cnd = 0; cnd < 3; ++cnd) {
    const float* prices = cnd == 1 ? S.lam : S.lam_sum;
    // pass 0: greedy in reduced-cost order
    for (int i = tid; i < c; i += nt) {
      const float wv = wv_of(S, i);
      // zero prices: wv - 0 == wv
      const float red = cnd == 0 ? wv : wv - gather_sum(S, prices, i);
      S.prio[i] = S.valid[i] ? red : -1.0f;
      S.alive[i] = S.valid[i] && S.prio[i] > 0.0f;
      S.cur[i] = 0;
    }
    __syncthreads();
    greedy(S);
    // pass 1: repair by raw weight over what stays feasible
    for (int j = tid; j <= v; j += nt) S.used[j] = 0;
    __syncthreads();
    for (int i = tid; i < c; i += nt) {
      if (!S.cur[i]) continue;
      const int* r = S.mv + (size_t)i * k;
      for (int j = 0; j < k; ++j) S.used[r[j]] = 1;
    }
    __syncthreads();
    for (int i = tid; i < c; i += nt) {
      const int* r = S.mv + (size_t)i * k;
      bool hit = false;
      for (int j = 0; j < k; ++j) hit = hit || S.used[r[j]];
      S.prio[i] = S.w[i];
      S.alive[i] = S.valid[i] && !S.cur[i] && !hit && S.w[i] > 0.0f;
    }
    __syncthreads();
    greedy(S);
    for (int i = tid; i < c; i += nt) cand[(size_t)cnd * c + i] = S.cur[i];
    vals[cnd] = objective_sum(S, sums, &sum_out);
  }
  int pick = 0;
  if (vals[1] > vals[pick]) pick = 1;
  if (vals[2] > vals[pick]) pick = 2;
  uint8_t* out = picked_all + (size_t)m * c;
  for (int i = tid; i < c; i += nt) out[i] = cand[(size_t)pick * c + i];
}

}  // namespace

extern "C" int repic_dual_smem_bytes(int c, int v) {
  return (int)make_layout(c, v).total;
}

extern "C" int repic_dual_solve(const void* mv, const void* w,
                                const void* valid, void* picked,
                                void* scratch, int m, int c, int k, int v,
                                int num_iters, int use_smem, float tol,
                                void* stream) {
  const size_t bytes = make_layout(c, v).total;
  size_t dyn = use_smem ? bytes : 0;
  if (use_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        dual_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  dual_solve_kernel<<<m, kThreads, dyn, (cudaStream_t)stream>>>(
      (const int*)mv, (const float*)w, (const uint8_t*)valid,
      (uint8_t*)picked, (uint8_t*)scratch, c, k, v, num_iters, use_smem,
      tol);
  return (int)cudaGetLastError();
}
