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
// Bound on this card: not bytes or operations but one SM's chain —
// each ascent step and each greedy round is a few short passes that
// must see each other's writes, one block per micrograph (32 of 132 SMs
// at M = 32).  With the state in shared memory, an ascent step is bound
// by that SM's shared-memory traffic: the gathers of lam at random
// members, the count atomics, and the price pass's loads and stores.
// The design shortens the chain and the passes in it:
//
// - The block stages its packing in shared memory once: the valid
//   cliques, compacted in position order (one ballot scan), as member
//   ids (uint16 when V <= 65535), weights and positions.  Every later
//   pass walks those nv cliques, never C, and never global memory.  The
//   staging uses plain coalesced loads: it compacts as it copies, which
//   a bulk copy cannot.  A solve whose state does not fit in shared
//   memory keeps the same layout in a global scratch slice.
// - An ascent step takes two barriers: the scatter of the clique
//   indicators (ax += 1 at the members of each clique of positive
//   reduced cost) and the price pass.  The price pass reads and clears
//   ax (each vertex by its own thread), and reduces max|dlam| per warp
//   with __reduce_max_sync on the float bits (every value is >= +0);
//   the per-warp maxima are read after the barrier the next step needs
//   anyway.
// - The greedy fixpoints walk worklists of alive cliques, rebuilt each
//   round with warp-aggregated appends (a list's order does not matter:
//   every test in a round is per clique or an order-free max).  A round
//   is three passes: each alive clique offers the 64-bit key (priority
//   bits, then the complement of its index) at its members with
//   atomicMax — the maximum priority, then the minimum index among
//   ties, the rule of repic_tpu's solve_greedy; a clique whose key holds
//   at every member is selected and marks its members used; the others
//   survive unless a member is used, and a survivor resets the key at
//   its members for the next round.  `used` is cleared once per
//   candidate, so after the first fixpoint it marks exactly the picks'
//   members, which the repair pass starts from.
// - The objective sums keep the order of solver/dual.py: objective_sum
//   over the reference kernel's width (C rounded up to 128): the first
//   level's 32-position windows are ranges of the compacted list
//   (positions of unpicked or invalid cliques add +0.0, which leaves a
//   sum of positive terms unchanged), the later levels run on one warp,
//   and one lane adds the last <= 32 terms in index order.
//
// The ascent (staging, count pass, steps, averaged prices) is
// dual_ascent.cuh's, which the ascent kernel (ascent.cu) runs too.
//
// Float rules: those of dual_ascent.cuh; atomics appear only where the
// result is order-independent: the integer counts ax and the key
// maximum.
#include "dual_ascent.cuh"

namespace {

// per-micrograph counters: ascent steps, greedy rounds of the six
// fixpoints, block barriers
constexpr int kStats = 8;

struct Layout {
  size_t mv, w, pos, prio, pick, list0, list1, lam, lam_sum, ax, best,
      used, win, sums, total;
};

__host__ __device__ inline Layout make_layout(int c, int k, int v) {
  const size_t nwin = sum_width(c) / kWindow;
  Layout L;
  size_t o = 0;
  L.mv = o;       o = align16(o + (size_t)id_bytes(v) * c * k);
  L.w = o;        o = align16(o + 4 * (size_t)c);
  L.pos = o;      o = align16(o + 4 * (size_t)c);
  L.prio = o;     o = align16(o + 4 * (size_t)c);
  L.pick = o;     o = align16(o + 3 * (size_t)c);
  L.list0 = o;    o = align16(o + 4 * (size_t)c);
  L.list1 = o;    o = align16(o + 4 * (size_t)c);
  L.lam = o;      o = align16(o + 4 * (size_t)v);
  L.lam_sum = o;  o = align16(o + 4 * (size_t)v);
  L.ax = o;       o = align16(o + 4 * (size_t)v);
  L.best = o;     o = align16(o + 8 * (size_t)v);
  L.used = o;     o = align16(o + (size_t)v);
  L.win = o;      o = align16(o + 4 * (nwin + 1));
  // two halves of window sums for the levels past the first
  L.sums = o;     o = align16(o + 8 * nwin);
  L.total = o;
  return L;
}

template <typename VT>
struct Solve {
  const VT* __restrict__ mv;  // (nv, K) staged member ids of the valid cliques
  const float* __restrict__ w;  // (nv,)
  float* __restrict__ prio;     // (nv,)
  int* list0;       // worklists of compacted clique indices: build g
  int* list1;       // writes list0 when g is even, list1 when odd
  int* list_cnt;    // 4 counters, rotating with the build generation
  unsigned long long* __restrict__ best;  // (V,) greedy keys
  uint8_t* __restrict__ used;             // (V,)
  const int* __restrict__ win;  // (nwin + 1,) first compacted index of each window
  float* sums;      // window sums past the first level
  float* obj_out;
  int c;
};

__device__ __forceinline__ unsigned long long greedy_key(float prio,
                                                         int idx) {
  // prio > 0: its bits order as the value
  return ((unsigned long long)__float_as_uint(prio) << 32) |
         (unsigned)(~idx);
}

// Append idx to out (every lane of the warp calls it, converged).
__device__ __forceinline__ void append(int* out, int* counter, bool keep,
                                       int idx) {
  const unsigned bal = __ballot_sync(kFull, keep);
  if (bal == 0) return;
  const int lane = threadIdx.x & 31;
  int at = 0;
  if (lane == 0) at = atomicAdd(counter, __popc(bal));
  at = __shfl_sync(kFull, at, 0);
  if (keep) out[at + __popc(bal & ((1u << lane) - 1u))] = idx;
}

template <typename VT>
__device__ __forceinline__ int* list_of(const Solve<VT>& S, int g) {
  return (g & 1) ? S.list1 : S.list0;
}

// A list build is a pass that appends to list_of(g) under counter
// list_cnt[g & 3]; it clears list_cnt[(g + 2) & 3] for build g + 2.
// Builds are at least one barrier apart, so a counter is never cleared
// while it is read or written.
template <typename VT>
__device__ __forceinline__ int* begin_build(const Solve<VT>& S, int g) {
  if (threadIdx.x == 0) S.list_cnt[(g + 2) & 3] = 0;
  return list_of(S, g);
}

template <typename VT, int K>
__device__ __forceinline__ float gather_sum(const Solve<VT>& S,
                                            const float* __restrict__ prices,
                                            int idx) {
  const VT* r = S.mv + (size_t)idx * K;
  float s = prices[r[0]];
#pragma unroll
  for (int j = 1; j < K; ++j) s = s + prices[r[j]];
  return s;
}

// solve_greedy to its fixpoint over the list built by build g - 1 (n
// cliques, each with prio > 0 and its members' keys reset); picks go to
// cur.  Returns the number of rounds.
template <typename VT, int K>
__device__ __forceinline__ int greedy(const Solve<VT>& S, uint8_t* cur,
                                      int n, int& g, int& nbar) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int rounds = 0;
  while (n > 0) {
    ++rounds;
    const int* in = list_of(S, g - 1);
    for (int li = tid; li < n; li += nt) {
      const int idx = in[li];
      const VT* r = S.mv + (size_t)idx * K;
      const unsigned long long key = greedy_key(S.prio[idx], idx);
#pragma unroll
      for (int j = 0; j < K; ++j) atomicMax(&S.best[r[j]], key);
    }
    bar(nbar);
    for (int li = tid; li < n; li += nt) {
      const int idx = in[li];
      const VT* r = S.mv + (size_t)idx * K;
      const unsigned long long key = greedy_key(S.prio[idx], idx);
      bool sel = true;
#pragma unroll
      for (int j = 0; j < K; ++j) sel = sel && S.best[r[j]] == key;
      if (sel) {
        cur[idx] = 1;
#pragma unroll
        for (int j = 0; j < K; ++j) S.used[r[j]] = 1;
      }
    }
    bar(nbar);
    int* out = begin_build(S, g);
    for (int b = 0; b < n; b += nt) {
      const int li = b + tid;
      bool keep = false;
      int idx = 0;
      if (li < n) {
        idx = in[li];
        if (!cur[idx]) {
          const VT* r = S.mv + (size_t)idx * K;
          bool hit = false;
#pragma unroll
          for (int j = 0; j < K; ++j) hit = hit || S.used[r[j]];
          if (!hit) {
            keep = true;
#pragma unroll
            for (int j = 0; j < K; ++j) S.best[r[j]] = 0ull;
          }
        }
      }
      append(out, &S.list_cnt[g & 3], keep, idx);
    }
    bar(nbar);
    n = S.list_cnt[g & 3];
    ++g;
  }
  return rounds;
}

// Float32 sum of the picked weights over a row of sum_width(c)
// positions, in the order of solver/dual.py: objective_sum: while more
// than kWindow terms remain, zero-pad to a multiple of kWindow (half
// the padding in front) and replace the row by its window sums; then
// add what is left.  Every sum starts at 0 and adds in index order.
// The first level needs no padding (sum_width is a multiple of 128).
template <typename VT>
__device__ __forceinline__ float objective_sum(const Solve<VT>& S,
                                               const uint8_t* cur,
                                               int& nbar) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int nwin = sum_width(S.c) / kWindow;
  for (int j = tid; j < nwin; j += nt) {
    float acc = 0.0f;
    for (int idx = S.win[j]; idx < S.win[j + 1]; ++idx)
      if (cur[idx]) acc = acc + S.w[idx];
    S.sums[j] = acc;
  }
  bar(nbar);
  if (tid < 32) {
    const float* src = S.sums;
    float* dst = S.sums + nwin;
    int len = nwin;
    while (len > kWindow) {
      const int pad = (kWindow - len % kWindow) % kWindow, lo = pad / 2;
      const int n = (len + pad) / kWindow;
      for (int j = lane; j < n; j += 32) {
        float acc = 0.0f;
        for (int e = 0; e < kWindow; ++e) {
          const int i = j * kWindow - lo + e;
          acc = acc + (i >= 0 && i < len ? src[i] : 0.0f);
        }
        dst[j] = acc;
      }
      __syncwarp();
      src = dst;
      dst = dst == S.sums ? S.sums + nwin : S.sums;
      len = n;
    }
    if (lane == 0) {
      float acc = 0.0f;
      for (int i = 0; i < len; ++i) acc = acc + src[i];
      *S.obj_out = acc;
    }
  }
  bar(nbar);
  return *S.obj_out;
}

// kSmem: the solve state lives in dynamic shared memory (known as
// such to the compiler, so its loads, stores and atomics are shared-
// memory instructions), else in this block's slice of scratch.
template <typename VT, int K, bool kSmem>
__global__ void __launch_bounds__(kThreads, 1)
    dual_solve_kernel(const int* __restrict__ mv_all,
                      const float* __restrict__ w_all,
                      const uint8_t* __restrict__ valid_all,
                      uint8_t* __restrict__ picked_all, uint8_t* scratch,
                      int* __restrict__ stats, int c, int v, int num_iters,
                      float tol) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red_f[kWarps];
  __shared__ unsigned red_u[kWarps];
  __shared__ int tile_cnt[2][kWarps];
  __shared__ int list_cnt[4];
  __shared__ float obj_out;
  const int m = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = make_layout(c, K, v);
  uint8_t* base = kSmem ? smem : scratch + (size_t)m * L.total;
  VT* __restrict__ smv = (VT*)(base + L.mv);
  float* __restrict__ sw = (float*)(base + L.w);
  int* __restrict__ spos = (int*)(base + L.pos);
  int* __restrict__ win = (int*)(base + L.win);
  float* __restrict__ lam = (float*)(base + L.lam);
  float* __restrict__ lam_sum = (float*)(base + L.lam_sum);
  int* __restrict__ ax = (int*)(base + L.ax);
  Solve<VT> S;
  S.mv = smv;
  S.w = sw;
  S.prio = (float*)(base + L.prio);
  S.list0 = (int*)(base + L.list0);
  S.list1 = (int*)(base + L.list1);
  S.list_cnt = list_cnt;
  S.best = (unsigned long long*)(base + L.best);
  S.used = base + L.used;
  S.win = win;
  S.sums = (float*)(base + L.sums);
  S.obj_out = &obj_out;
  S.c = c;
  uint8_t* pick = base + L.pick;
  int nbar = 0;

  // ---- stage the valid cliques, compacted in position order ----------
  if (tid < 4) list_cnt[tid] = 0;
  clear_state(lam, lam_sum, ax, v);
  float eta0;
  const int nv = stage<VT, K>(
      mv_all + (size_t)m * c * K, w_all + (size_t)m * c,
      valid_all + (size_t)m * c, c, K, smv, sw, c, (VT*)nullptr,
      (float*)nullptr, spos, win, tile_cnt, red_f, eta0, nbar);

  // ---- dual ascent: two barriers a step ----------------------------
  const Ascent a = ascent<VT, K>(smv, sw, nv, (const VT*)nullptr,
                                 (const float*)nullptr, 0, K, lam,
                                 lam_sum, ax, v, eta0, num_iters, tol,
                                 red_u, nbar);
  const int t = a.t;
  // lam_sum becomes the averaged prices (candidate 2 reads it many
  // barriers later)
  average(lam, lam_sum, lam_sum, v, a.n_tail);

  // ---- three rounding candidates -----------------------------------
  float vals[3];
  int rounds[6];
  int g = 0;  // list build generation
#pragma unroll
  for (int cnd = 0; cnd < 3; ++cnd) {
    const float* prices = cnd == 1 ? lam : lam_sum;
    uint8_t* cur = pick + (size_t)cnd * c;
    // pass 0: greedy in reduced-cost order
    for (int j = tid; j < v; j += nt) {
      S.used[j] = 0;
      S.best[j] = 0ull;
    }
    int* out = begin_build(S, g);
    for (int b = 0; b < nv; b += nt) {
      const int idx = b + tid;
      bool alive = false;
      if (idx < nv) {
        // zero prices: wv - 0 == wv
        const float red =
            cnd == 0 ? sw[idx] : sw[idx] - gather_sum<VT, K>(S, prices, idx);
        S.prio[idx] = red;
        cur[idx] = 0;
        alive = red > 0.0f;
      }
      append(out, &list_cnt[g & 3], alive, idx);
    }
    bar(nbar);
    int n = list_cnt[g & 3];
    ++g;
    rounds[2 * cnd] = greedy<VT, K>(S, cur, n, g, nbar);
    // pass 1: repair by raw weight over what stays feasible; `used`
    // marks exactly the members of pass 0's picks
    out = begin_build(S, g);
    for (int b = 0; b < nv; b += nt) {
      const int idx = b + tid;
      bool alive = false;
      if (idx < nv && !cur[idx] && sw[idx] > 0.0f) {
        const VT* r = smv + (size_t)idx * K;
        bool hit = false;
#pragma unroll
        for (int j = 0; j < K; ++j) hit = hit || S.used[r[j]];
        if (!hit) {
          alive = true;
          S.prio[idx] = sw[idx];
#pragma unroll
          for (int j = 0; j < K; ++j) S.best[r[j]] = 0ull;
        }
      }
      append(out, &list_cnt[g & 3], alive, idx);
    }
    bar(nbar);
    n = list_cnt[g & 3];
    ++g;
    rounds[2 * cnd + 1] = greedy<VT, K>(S, cur, n, g, nbar);
    vals[cnd] = objective_sum(S, cur, nbar);
  }
  int pk = 0;
  if (vals[1] > vals[pk]) pk = 1;
  if (vals[2] > vals[pk]) pk = 2;
  uint8_t* picked = picked_all + (size_t)m * c;
  for (int i = tid; i < c; i += nt) picked[i] = 0;
  bar(nbar);
  const uint8_t* best_pick = pick + (size_t)pk * c;
  for (int idx = tid; idx < nv; idx += nt)
    if (best_pick[idx]) picked[spos[idx]] = 1;
  if (tid == 0) {
    int* st = stats + (size_t)m * kStats;
    st[0] = t;
#pragma unroll
    for (int x = 0; x < 6; ++x) st[1 + x] = rounds[x];
    st[7] = nbar;
  }
}

template <typename VT, int K>
int launch(const void* mv, const void* w, const void* valid, void* picked,
           void* scratch, void* stats, int m, int c, int v, int num_iters,
           int use_smem, float tol, cudaStream_t stream) {
  if (use_smem) {
    const size_t dyn = make_layout(c, K, v).total;
    cudaError_t e = cudaFuncSetAttribute(
        dual_solve_kernel<VT, K, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
    dual_solve_kernel<VT, K, true><<<m, kThreads, dyn, stream>>>(
        (const int*)mv, (const float*)w, (const uint8_t*)valid,
        (uint8_t*)picked, (uint8_t*)scratch, (int*)stats, c, v, num_iters,
        tol);
  } else {
    dual_solve_kernel<VT, K, false><<<m, kThreads, 0, stream>>>(
        (const int*)mv, (const float*)w, (const uint8_t*)valid,
        (uint8_t*)picked, (uint8_t*)scratch, (int*)stats, c, v, num_iters,
        tol);
  }
  return (int)cudaGetLastError();
}

template <typename VT>
int launch_k(const void* mv, const void* w, const void* valid,
             void* picked, void* scratch, void* stats, int m, int c, int k,
             int v, int num_iters, int use_smem, float tol,
             cudaStream_t st) {
  switch (k) {
    case 1: return launch<VT, 1>(mv, w, valid, picked, scratch, stats, m, c, v, num_iters, use_smem, tol, st);
    case 2: return launch<VT, 2>(mv, w, valid, picked, scratch, stats, m, c, v, num_iters, use_smem, tol, st);
    case 3: return launch<VT, 3>(mv, w, valid, picked, scratch, stats, m, c, v, num_iters, use_smem, tol, st);
    case 4: return launch<VT, 4>(mv, w, valid, picked, scratch, stats, m, c, v, num_iters, use_smem, tol, st);
    case 5: return launch<VT, 5>(mv, w, valid, picked, scratch, stats, m, c, v, num_iters, use_smem, tol, st);
    case 6: return launch<VT, 6>(mv, w, valid, picked, scratch, stats, m, c, v, num_iters, use_smem, tol, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repic_dual_smem_bytes(int c, int k, int v) {
  return (int)make_layout(c, k, v).total;
}

// stats: (M, 8) int32 — ascent steps, greedy rounds of the six
// fixpoints (candidate 0 pass 0, pass 1, candidate 1 ...), barriers.
extern "C" int repic_dual_solve(const void* mv, const void* w,
                                const void* valid, void* picked,
                                void* scratch, void* stats, int m, int c,
                                int k, int v, int num_iters, int use_smem,
                                float tol, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (id_bytes(v) == 2)
    return launch_k<uint16_t>(mv, w, valid, picked, scratch, stats, m, c,
                              k, v, num_iters, use_smem, tol, st);
  return launch_k<int>(mv, w, valid, picked, scratch, stats, m, c, k, v,
                       num_iters, use_smem, tol, st);
}
