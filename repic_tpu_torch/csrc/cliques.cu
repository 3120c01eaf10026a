// Fused clique candidates on Hopper: IoU -> top-D -> k-partite join ->
// statistics -> compaction in product-id order.
//
// Replaces the TPU kernel repic_tpu/ops/megakernel.py:
// fused_clique_candidates (kernel body _clique_kernel).  That kernel
// walked anchor tiles in order on one core with a 24 MiB VMEM tile;
// here blocks run in parallel, so the work splits in two launches over
// a grid of (anchor block, micrograph), one warp per anchor and
// kWarps anchors per block:
//
//   count: per anchor and other picker, the top-D neighbours (IoU with
//          masked pairs 0.0; order value desc, index asc) into a global
//          scratch, the above-threshold adjacency count, and the number
//          of valid cliques in the anchor's D^(K-1) product — per
//          anchor and per block.
//   write: the block's offset (sum of the earlier blocks' counts) plus
//          an exclusive scan over its anchors give each anchor its
//          first output slot; the warp re-walks the anchor's product
//          and writes every valid clique (members, weight, median
//          confidence, representative, product id) in product order.
//          Slots past the valid count are zeroed; block 0 writes
//          num_valid and max_adjacency.
//
// Count launch, per anchor: the block stages the candidates of picker
// p in shared memory, kTile at a time, as (x, y, x + s, y + s) with a
// masked candidate's x set to +inf (its IoU then comes out exactly
// +0.0, the masked value).  Lane l scans candidates l, l + 32, ... into
// a register list (LaneList, d <= 16) and the warp merges the 32 lists
// (topd.cuh: warp_merge_topd), which reproduces lax.top_k's order on
// the large classes of tied zero IoUs.  A list of d > 16 is kept per
// warp in the scratch row: the lanes evaluate 32 candidates at once
// and lane 0 inserts, in lane (= index) order, those that beat the
// D-th value.  A masked anchor has no clique: its warp skips the scan.
// The product walk runs across the lanes: lane l evaluates product ids
// q = l mod 32, and __ballot_sync / __popc count (and, in the write
// launch, place) the valid ones, so no atomic touches the output: its
// row order is the product-id order the staged path's buffers have,
// which BOX byte-identity rests on.
//
// Float rules: the build's --fmad=false; no division where the
// intersection is zero (the quotient is that +0.0 itself); medians of
// at most 6 confidences / 15 edges by an in-register sort, an even
// count taking (lo + hi) * 0.5 (jnp.median's midpoint rule); the
// weighted degree adds incident edges in pair order; the
// representative is the first maximum.
//
// Bound on this card: operations — the (K-1) * N * N IoU scan per
// micrograph dominates; inputs and outputs are a few MB per chunk.
#include "topd.cuh"

namespace {

constexpr int kWarps = 8;               // anchors per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;             // candidates per shared tile
constexpr unsigned kFull = 0xffffffffu;

// Blocks per SM the count kernel is built for: short lane lists at
// K <= 4 fit three blocks' registers with no spill; longer lists and
// wider products get more registers per thread instead.
template <int K, int R>
constexpr int count_min_blocks() {
  return R == 8 ? (K <= 4 ? 3 : 2) : 1;
}

constexpr int kMaxK = 6;

struct Problem {
  const float2* xy;      // (M, K, N) float2
  const float* conf;     // (M, K, N)
  const uint8_t* mask;   // (M, K, N)
  float sizes[kMaxK];    // box edge per picker (a kernel argument)
  float* nbr_v;          // (M, K-1, N, D) scratch
  int* nbr_i;            // (M, K-1, N, D) scratch
  int n, d;
  float threshold;
};

template <int K>
struct Clique {
  int mem[K];
  float edge[K * (K - 1) / 2];
};

// Evaluate product id q of anchor a of micrograph m; true when every
// member is real and every edge is above the threshold.
template <int K>
__device__ bool eval_product(const Problem& P, int m, int a, bool am,
                             int q, const float* sz, Clique<K>& cq) {
  const int n = P.n, d = P.d;
  int sel[K - 1];
  int rem = q;
#pragma unroll
  for (int s = K - 2; s >= 0; --s) {
    sel[s] = rem % d;
    rem /= d;
  }
  cq.mem[0] = a;
  bool ok = am;
  size_t base = (size_t)m * (K - 1) * n;
#pragma unroll
  for (int s = 0; s < K - 1; ++s) {
    size_t row = ((base + (size_t)s * n) + a) * d;
    int mm = P.nbr_i[row + sel[s]];
    cq.mem[s + 1] = mm;
    ok = ok && P.mask[((size_t)m * K + s + 1) * n + mm] != 0;
  }
  int e = 0;
  bool valid = ok;
#pragma unroll
  for (int p = 0; p < K; ++p) {
#pragma unroll
    for (int r = p + 1; r < K; ++r) {
      float v;
      if (p == 0) {
        size_t row = ((base + (size_t)(r - 1) * n) + a) * d;
        v = P.nbr_v[row + sel[r - 1]];
      } else if (ok) {
        float2 bp = P.xy[((size_t)m * K + p) * n + cq.mem[p]];
        float2 bq = P.xy[((size_t)m * K + r) * n + cq.mem[r]];
        v = box_iou(bp.x, bp.y, sz[p], bq.x, bq.y, sz[r]);
      } else {
        v = 0.0f;
      }
      cq.edge[e++] = v;
      valid = valid && v > P.threshold;
    }
  }
  return valid;
}

template <int L>
__device__ float median_sorted(float* x) {
  // insertion sort of L register values, then the midpoint rule
#pragma unroll
  for (int i = 1; i < L; ++i) {
#pragma unroll
    for (int j = i; j > 0; --j) {
      float lo = fminf(x[j - 1], x[j]);
      float hi = fmaxf(x[j - 1], x[j]);
      x[j - 1] = lo;
      x[j] = hi;
    }
  }
  return (x[(L - 1) / 2] + x[L / 2]) * 0.5f;
}

template <int K>
__device__ __forceinline__ void load_sizes(const Problem& P, float* sz) {
#pragma unroll
  for (int p = 0; p < K; ++p) sz[p] = P.sizes[p];
}

__device__ __forceinline__ int dprod_of(int d, int k) {
  int r = 1;
  for (int s = 0; s < k - 1; ++s) r *= d;
  return r;
}

// R > 0: lane lists of R register slots and a warp merge (d <= R);
// R == 0: one list per warp in the scratch row (d > 16).
template <int K, int R>
__global__ void __launch_bounds__(kThreads, (count_min_blocks<K, R>()))
    clique_count_kernel(Problem P, int* anchor_count, int* block_count,
                        int* block_adj) {
  __shared__ float4 tile[kTile];
  __shared__ int red_cnt[kWarps];
  __shared__ int red_adj[kWarps];
  const int m = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = blockIdx.x * kWarps + warp;
  const int n = P.n, d = P.d;
  const bool active = a < n;
  float sz[K];
  load_sizes<K>(P, sz);
  float ax = 0.0f, ay = 0.0f;
  bool am = false;
  if (active) {
    float2 p0 = P.xy[(size_t)m * K * n + a];
    ax = p0.x;
    ay = p0.y;
    am = P.mask[(size_t)m * K * n + a] != 0;
  }
  // warp-uniform: a masked anchor's IoUs are all 0.0, so it has no
  // above-threshold neighbour and no valid clique
  const bool scan = active && am;
  const float ax2 = ax + sz[0], ay2 = ay + sz[0];
  int adj = 0;
  for (int p = 1; p < K; ++p) {
    const size_t row = (((size_t)m * (K - 1) + (p - 1)) * n + a) * d;
    float* v = P.nbr_v + row;
    int* idx = P.nbr_i + row;
    const float s2 = sz[0] * sz[0] + sz[p] * sz[p];
    LaneList<R == 0 ? 1 : R> top;
    lanelist_init(top);
    float vmin = -1.0f;
    if (R == 0 && scan) {
      for (int s = lane; s < d; s += 32) {
        v[s] = -1.0f;
        idx[s] = 0;
      }
      __syncwarp();
    }
    int cnt = 0;
    const float2* xb = P.xy + ((size_t)m * K + p) * n;
    const uint8_t* mb = P.mask + ((size_t)m * K + p) * n;
    for (int t0 = 0; t0 < n; t0 += kTile) {
      __syncthreads();
      for (int j = threadIdx.x; j < kTile && t0 + j < n; j += kThreads) {
        const float2 q = xb[t0 + j];
        const float x = mb[t0 + j] ? q.x : INFINITY;
        tile[j] = make_float4(x, q.y, x + sz[p], q.y + sz[p]);
      }
      __syncthreads();
      if (!scan) continue;
      const int tn = min(kTile, n - t0);
      if (R > 0) {
        for (int jj = lane; jj < tn; jj += 32) {
          const float4 b = tile[jj];
          const float iou =
              box_iou_pre(ax, ay, ax2, ay2, b.x, b.y, b.z, b.w, s2);
          cnt += iou > P.threshold;
          if (iou > vmin) vmin = lanelist_insert(top, d, iou, t0 + jj);
        }
      } else {
        for (int jb = 0; jb < tn; jb += 32) {
          const int jj = jb + lane;
          float iou = -1.0f;
          if (jj < tn) {
            const float4 b = tile[jj];
            iou = box_iou_pre(ax, ay, ax2, ay2, b.x, b.y, b.z, b.w, s2);
            cnt += iou > P.threshold;
          }
          unsigned bits = __ballot_sync(kFull, iou > vmin);
          while (bits) {
            const int s = __ffs(bits) - 1;
            bits &= bits - 1;
            const float val = __shfl_sync(kFull, iou, s);
            if (val > vmin) {
              float last = 0.0f;
              if (lane == 0) {
                topd_insert(v, idx, d, val, t0 + jb + s);
                last = v[d - 1];
              }
              vmin = __shfl_sync(kFull, last, 0);
            }
          }
        }
      }
    }
    if (R > 0 && scan) {
      float mv;
      int mi;
      warp_merge_topd(top, d, &mv, &mi);
      if (lane < d) {
        v[lane] = mv;
        idx[lane] = mi;
      }
    }
    adj = max(adj, __reduce_add_sync(kFull, cnt));
  }
  __syncwarp();
  int total = 0;
  if (scan) {
    const int dprod = dprod_of(d, K);
    Clique<K> cq;
    for (int qb = 0; qb < dprod; qb += 32) {
      const int q = qb + lane;
      const bool ok = q < dprod && eval_product<K>(P, m, a, true, q, sz, cq);
      total += __popc(__ballot_sync(kFull, ok));
    }
  }
  if (active && lane == 0) anchor_count[(size_t)m * n + a] = total;
  if (lane == 0) {
    red_cnt[warp] = total;
    red_adj[warp] = adj;
  }
  __syncthreads();
  if (warp == 0) {
    int c = lane < kWarps ? red_cnt[lane] : 0;
    int x = lane < kWarps ? red_adj[lane] : 0;
    c = __reduce_add_sync(kFull, c);
    x = __reduce_max_sync(kFull, x);
    if (lane == 0) {
      block_count[(size_t)m * gridDim.x + blockIdx.x] = c;
      block_adj[(size_t)m * gridDim.x + blockIdx.x] = x;
    }
  }
}

struct Outputs {
  int* member_idx;   // (M, C, K)
  uint8_t* valid;    // (M, C)
  float* w;          // (M, C)
  float* confidence; // (M, C)
  int* rep_slot;     // (M, C)
  float2* rep_xy;    // (M, C)
  int* pid;          // (M, C)
  int* num_valid;    // (M,)
  int* max_adj;      // (M,)
  int cap;
};

template <int K>
__device__ void write_clique(const Problem& P, const Outputs& O, int m,
                             int a, int q, int dprod, float2 p0,
                             const Clique<K>& cq, size_t slot) {
  constexpr int E = K * (K - 1) / 2;
  const int n = P.n;
  float cf[K];
  cf[0] = P.conf[(size_t)m * K * n + a];
#pragma unroll
  for (int s = 1; s < K; ++s)
    cf[s] = P.conf[((size_t)m * K + s) * n + cq.mem[s]];
  float ed[E];
#pragma unroll
  for (int e = 0; e < E; ++e) ed[e] = cq.edge[e];
  const float cmed = median_sorted<K>(cf);
  const float emed = median_sorted<E>(ed);
  float deg[K];
#pragma unroll
  for (int s = 0; s < K; ++s) deg[s] = 0.0f;
  int e = 0;
#pragma unroll
  for (int p = 0; p < K; ++p) {
#pragma unroll
    for (int r = p + 1; r < K; ++r) {
      deg[p] = deg[p] + cq.edge[e];
      deg[r] = deg[r] + cq.edge[e];
      ++e;
    }
  }
  int rs = 0;
#pragma unroll
  for (int s = 1; s < K; ++s)
    if (deg[s] > deg[rs]) rs = s;
#pragma unroll
  for (int s = 0; s < K; ++s) O.member_idx[slot * K + s] = cq.mem[s];
  O.valid[slot] = 1;
  O.w[slot] = cmed * emed;
  O.confidence[slot] = cmed;
  O.rep_slot[slot] = rs;
  O.rep_xy[slot] = rs == 0 ? p0 : P.xy[((size_t)m * K + rs) * n + cq.mem[rs]];
  O.pid[slot] = a * dprod + q;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    clique_write_kernel(Problem P, const int* anchor_count,
                        const int* block_count, const int* block_adj,
                        Outputs O) {
  __shared__ int s_off[kWarps];
  __shared__ int s_tot[kWarps];
  __shared__ int s_adj[kWarps];
  __shared__ int s_cnt[kWarps];
  const int m = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = blockIdx.x * kWarps + warp;
  const int n = P.n, d = P.d, cap = O.cap;
  const int nblk = gridDim.x;
  const bool active = a < n;
  // the earlier blocks' counts, the micrograph's total and max
  // adjacency: a block-wide reduction over block_count / block_adj
  int off = 0, tot = 0, mx = 0;
  for (int b = threadIdx.x; b < nblk; b += kThreads) {
    const int c = block_count[(size_t)m * nblk + b];
    if (b < (int)blockIdx.x) off += c;
    tot += c;
    mx = max(mx, block_adj[(size_t)m * nblk + b]);
  }
  off = __reduce_add_sync(kFull, off);
  tot = __reduce_add_sync(kFull, tot);
  mx = __reduce_max_sync(kFull, mx);
  const int cnt = active ? anchor_count[(size_t)m * n + a] : 0;
  if (lane == 0) {
    s_off[warp] = off;
    s_tot[warp] = tot;
    s_adj[warp] = mx;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  int pos = 0;
  tot = 0;
  mx = 0;
  for (int w = 0; w < kWarps; ++w) {
    pos += s_off[w];
    tot += s_tot[w];
    mx = max(mx, s_adj[w]);
  }
  // exclusive scan over the block's anchors (warps)
  for (int w = 0; w < warp; ++w) pos += s_cnt[w];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    O.num_valid[m] = tot;
    O.max_adj[m] = mx;
  }
  if (cnt > 0 && pos < cap) {
    float sz[K];
    load_sizes<K>(P, sz);
    const float2 p0 = P.xy[(size_t)m * K * n + a];
    const int dprod = dprod_of(d, K);
    const unsigned below = (1u << lane) - 1u;
    int done = 0;
    Clique<K> cq;
    for (int qb = 0; qb < dprod && done < cnt && pos < cap; qb += 32) {
      const int q = qb + lane;
      const bool ok = q < dprod && eval_product<K>(P, m, a, true, q, sz, cq);
      const unsigned bal = __ballot_sync(kFull, ok);
      const int slot = pos + __popc(bal & below);
      if (ok && slot < cap)
        write_clique<K>(P, O, m, a, q, dprod, p0, cq,
                        (size_t)m * cap + slot);
      pos += __popc(bal);
      done += __popc(bal);
    }
  }
  // zero the slots past the valid count
  const int filled = min(tot, cap);
  for (int s = filled + blockIdx.x * kThreads + threadIdx.x; s < cap;
       s += nblk * kThreads) {
    size_t slot = (size_t)m * cap + s;
    for (int k = 0; k < K; ++k) O.member_idx[slot * K + k] = 0;
    O.valid[slot] = 0;
    O.w[slot] = 0.0f;
    O.confidence[slot] = 0.0f;
    O.rep_slot[slot] = 0;
    O.rep_xy[slot] = make_float2(0.0f, 0.0f);
    O.pid[slot] = 0;
  }
}

// sizes: K floats in host memory, copied into the kernel's arguments
Problem make_problem(const void* xy, const void* conf, const void* mask,
                     const void* sizes, int k, void* nbr_v, void* nbr_i,
                     int n, int d, float threshold) {
  Problem P;
  P.xy = (const float2*)xy;
  P.conf = (const float*)conf;
  P.mask = (const uint8_t*)mask;
  for (int p = 0; p < kMaxK; ++p)
    P.sizes[p] = p < k ? ((const float*)sizes)[p] : 0.0f;
  P.nbr_v = (float*)nbr_v;
  P.nbr_i = (int*)nbr_i;
  P.n = n;
  P.d = d;
  P.threshold = threshold;
  return P;
}

template <int K>
void launch_count(int d, dim3 grid, cudaStream_t st, const Problem& P,
                  int* ac, int* bc, int* ba) {
  if (d <= 8)
    clique_count_kernel<K, 8><<<grid, kThreads, 0, st>>>(P, ac, bc, ba);
  else if (d <= kRegD)
    clique_count_kernel<K, kRegD><<<grid, kThreads, 0, st>>>(P, ac, bc, ba);
  else
    clique_count_kernel<K, 0><<<grid, kThreads, 0, st>>>(P, ac, bc, ba);
}

}  // namespace

// sizes: the K box edges, in host memory.  block_count and block_adj
// hold at least M * ceil(N / kWarps) ints.
extern "C" int repic_clique_count(
    const void* xy, const void* mask, const void* sizes, void* nbr_v,
    void* nbr_i, void* anchor_count, void* block_count, void* block_adj,
    int m, int k, int n, int d, float threshold, void* stream) {
  if (k < 2 || k > kMaxK) return (int)cudaErrorInvalidValue;
  Problem P = make_problem(xy, nullptr, mask, sizes, k, nbr_v, nbr_i, n, d,
                           threshold);
  dim3 grid((n + kWarps - 1) / kWarps, m);
  cudaStream_t st = (cudaStream_t)stream;
  int* ac = (int*)anchor_count;
  int* bc = (int*)block_count;
  int* ba = (int*)block_adj;
  switch (k) {
    case 2: launch_count<2>(d, grid, st, P, ac, bc, ba); break;
    case 3: launch_count<3>(d, grid, st, P, ac, bc, ba); break;
    case 4: launch_count<4>(d, grid, st, P, ac, bc, ba); break;
    case 5: launch_count<5>(d, grid, st, P, ac, bc, ba); break;
    case 6: launch_count<6>(d, grid, st, P, ac, bc, ba); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int repic_clique_write(
    const void* xy, const void* conf, const void* mask, const void* sizes,
    void* nbr_v, void* nbr_i, const void* anchor_count,
    const void* block_count, const void* block_adj, void* member_idx,
    void* valid, void* w, void* confidence, void* rep_slot, void* rep_xy,
    void* pid, void* num_valid, void* max_adj, int m, int k, int n, int d,
    int cap, float threshold, void* stream) {
  if (k < 2 || k > kMaxK) return (int)cudaErrorInvalidValue;
  Problem P = make_problem(xy, conf, mask, sizes, k, nbr_v, nbr_i, n, d,
                           threshold);
  Outputs O;
  O.member_idx = (int*)member_idx;
  O.valid = (uint8_t*)valid;
  O.w = (float*)w;
  O.confidence = (float*)confidence;
  O.rep_slot = (int*)rep_slot;
  O.rep_xy = (float2*)rep_xy;
  O.pid = (int*)pid;
  O.num_valid = (int*)num_valid;
  O.max_adj = (int*)max_adj;
  O.cap = cap;
  dim3 grid((n + kWarps - 1) / kWarps, m);
  cudaStream_t st = (cudaStream_t)stream;
  const int* ac = (const int*)anchor_count;
  const int* bc = (const int*)block_count;
  const int* ba = (const int*)block_adj;
  switch (k) {
    case 2: clique_write_kernel<2><<<grid, kThreads, 0, st>>>(P, ac, bc, ba, O); break;
    case 3: clique_write_kernel<3><<<grid, kThreads, 0, st>>>(P, ac, bc, ba, O); break;
    case 4: clique_write_kernel<4><<<grid, kThreads, 0, st>>>(P, ac, bc, ba, O); break;
    case 5: clique_write_kernel<5><<<grid, kThreads, 0, st>>>(P, ac, bc, ba, O); break;
    case 6: clique_write_kernel<6><<<grid, kThreads, 0, st>>>(P, ac, bc, ba, O); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
