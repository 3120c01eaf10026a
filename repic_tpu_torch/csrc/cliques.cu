// Fused clique candidates on Hopper: IoU -> top-D -> k-partite join ->
// statistics -> compaction in product-id order.
//
// Replaces the TPU kernel repic_tpu/ops/megakernel.py:
// fused_clique_candidates (kernel body _clique_kernel).  That kernel
// walked anchor tiles in order on one core with a 24 MiB VMEM tile;
// here blocks run in parallel, so the work splits in two launches over
// a grid of (anchor block, micrograph), one thread per anchor:
//
//   count: per anchor, the top-D neighbours in every other picker
//          (IoU with masked pairs 0.0; list order value desc, index
//          asc; built in registers when D <= 16, as in the neighbour
//          kernel) into a scratch buffer, the above-threshold adjacency
//          count, then a walk of the D^(K-1) product counting the
//          valid cliques — per anchor and per block.
//   write: the block's offset (sum of earlier blocks' counts) plus the
//          anchor's exclusive scan inside the block give each anchor
//          its first output slot; the anchor re-walks its product and
//          writes every valid clique (members, weight, median
//          confidence, representative, product id) in product order.
//          Slots past the valid count are zeroed; num_valid and
//          max_adjacency are reduced in block order.
//
// No atomics touch the output: its row order is the product-id order
// the staged path's buffers have, which BOX byte-identity rests on.
// Medians of at most 6 confidences / 15 edges sort in registers; an
// even count takes (lo + hi) * 0.5 (jnp.median's midpoint rule).  The
// weighted degree adds incident edges in pair order; the
// representative is the first maximum.
//
// Bound on this card: operations — the (K-1) * N * N IoU scan per
// micrograph dominates; inputs and outputs are a few MB per chunk.
#include "topd.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;

struct Problem {
  const float2* xy;      // (M, K, N) float2
  const float* conf;     // (M, K, N)
  const uint8_t* mask;   // (M, K, N)
  const float* sizes;    // (K,)
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
  constexpr int E = K * (K - 1) / 2;
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
  (void)E;
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

__device__ void load_sizes(const float* sizes, int k, float* sz) {
  for (int p = 0; p < k; ++p) sz[p] = sizes[p];
}

template <int K, bool kReg>
__global__ void clique_count_kernel(Problem P, int* anchor_count,
                                    int* block_count, int* block_adj) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ uint8_t sm[kTile];
  __shared__ int red_cnt[kThreads];
  __shared__ int red_adj[kThreads];
  const int m = blockIdx.y;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  const int n = P.n, d = P.d;
  const bool active = a < n;
  float sz[K];
  load_sizes(P.sizes, K, sz);
  float ax = 0.0f, ay = 0.0f;
  bool am = false;
  if (active) {
    float2 p0 = P.xy[(size_t)m * K * n + a];
    ax = p0.x;
    ay = p0.y;
    am = P.mask[(size_t)m * K * n + a] != 0;
  }
  int adj = 0;
  for (int p = 1; p < K; ++p) {
    size_t row = (((size_t)m * (K - 1) + (p - 1)) * n + a) * d;
    float* v = P.nbr_v + row;
    int* idx = P.nbr_i + row;
    RegTopD top;
    if (kReg) regtopd_init(top, -1.0f, 0);
    if (active && !kReg) {
      for (int s = 0; s < d; ++s) {
        v[s] = -1.0f;
        idx[s] = 0;
      }
    }
    float vmin = -1.0f;
    int cnt = 0;
    const float2* xb = P.xy + ((size_t)m * K + p) * n;
    const uint8_t* mb = P.mask + ((size_t)m * K + p) * n;
    for (int t0 = 0; t0 < n; t0 += kTile) {
      __syncthreads();
      for (int j = threadIdx.x; j < kTile && t0 + j < n; j += kThreads) {
        float2 q = xb[t0 + j];
        sx[j] = q.x;
        sy[j] = q.y;
        sm[j] = mb[t0 + j];
      }
      __syncthreads();
      if (!active) continue;
      const int tn = min(kTile, n - t0);
      for (int j = 0; j < tn; ++j) {
        float iou = box_iou(ax, ay, sz[0], sx[j], sy[j], sz[p]);
        iou = (am && sm[j]) ? iou : 0.0f;
        cnt += iou > P.threshold;
        if (iou > vmin) {
          if (kReg) {
            vmin = regtopd_insert(top, d, iou, t0 + j);
          } else {
            topd_insert(v, idx, d, iou, t0 + j);
            vmin = v[d - 1];
          }
        }
      }
    }
    if (kReg && active) regtopd_store(top, d, v, idx);
    adj = max(adj, cnt);
  }
  int total = 0;
  if (active) {
    int dprod = 1;
    for (int s = 0; s < K - 1; ++s) dprod *= d;
    Clique<K> cq;
    for (int q = 0; q < dprod; ++q)
      total += eval_product<K>(P, m, a, am, q, sz, cq);
    anchor_count[(size_t)m * n + a] = total;
  }
  red_cnt[threadIdx.x] = total;
  red_adj[threadIdx.x] = adj;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0, mx = 0;
    for (int i = 0; i < kThreads; ++i) {
      s += red_cnt[i];
      mx = max(mx, red_adj[i]);
    }
    block_count[(size_t)m * gridDim.x + blockIdx.x] = s;
    block_adj[(size_t)m * gridDim.x + blockIdx.x] = mx;
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
__global__ void clique_write_kernel(Problem P, const int* anchor_count,
                                    const int* block_count,
                                    const int* block_adj, Outputs O) {
  constexpr int E = K * (K - 1) / 2;
  __shared__ int excl[kThreads];
  __shared__ int s_off;
  __shared__ int s_total;
  const int m = blockIdx.y;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  const int n = P.n, d = P.d, cap = O.cap;
  const int nblk = gridDim.x;
  const bool active = a < n;
  excl[threadIdx.x] = active ? anchor_count[(size_t)m * n + a] : 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0, total = 0, mx = 0;
    for (int b = 0; b < nblk; ++b) {
      int c = block_count[(size_t)m * nblk + b];
      if (b < (int)blockIdx.x) off += c;
      total += c;
      mx = max(mx, block_adj[(size_t)m * nblk + b]);
    }
    int run = off;
    for (int i = 0; i < kThreads; ++i) {
      int c = excl[i];
      excl[i] = run;
      run += c;
    }
    s_off = off;
    s_total = total;
    if (blockIdx.x == 0) {
      O.num_valid[m] = total;
      O.max_adj[m] = mx;
    }
  }
  __syncthreads();
  float sz[K];
  load_sizes(P.sizes, K, sz);
  if (active) {
    int pos = excl[threadIdx.x];
    const float2 p0 = P.xy[(size_t)m * K * n + a];
    const bool am = P.mask[(size_t)m * K * n + a] != 0;
    int dprod = 1;
    for (int s = 0; s < K - 1; ++s) dprod *= d;
    Clique<K> cq;
    for (int q = 0; q < dprod && pos < cap; ++q) {
      if (!eval_product<K>(P, m, a, am, q, sz, cq)) continue;
      float cf[K];
      cf[0] = P.conf[(size_t)m * K * n + a];
#pragma unroll
      for (int s = 1; s < K; ++s)
        cf[s] = P.conf[((size_t)m * K + s) * n + cq.mem[s]];
      float ed[E];
#pragma unroll
      for (int e = 0; e < E; ++e) ed[e] = cq.edge[e];
      float cmed = median_sorted<K>(cf);
      float emed = median_sorted<E>(ed);
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
      size_t slot = (size_t)m * cap + pos;
#pragma unroll
      for (int s = 0; s < K; ++s) O.member_idx[slot * K + s] = cq.mem[s];
      O.valid[slot] = 1;
      O.w[slot] = cmed * emed;
      O.confidence[slot] = cmed;
      O.rep_slot[slot] = rs;
      O.rep_xy[slot] =
          rs == 0 ? p0 : P.xy[((size_t)m * K + rs) * n + cq.mem[rs]];
      O.pid[slot] = a * dprod + q;
      ++pos;
    }
  }
  // zero the slots past the valid count
  const int filled = min(s_total, cap);
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

Problem make_problem(const void* xy, const void* conf, const void* mask,
                     const void* sizes, void* nbr_v, void* nbr_i, int n,
                     int d, float threshold) {
  Problem P;
  P.xy = (const float2*)xy;
  P.conf = (const float*)conf;
  P.mask = (const uint8_t*)mask;
  P.sizes = (const float*)sizes;
  P.nbr_v = (float*)nbr_v;
  P.nbr_i = (int*)nbr_i;
  P.n = n;
  P.d = d;
  P.threshold = threshold;
  return P;
}

template <int K>
void launch_count(bool reg, dim3 grid, cudaStream_t st, const Problem& P,
                  int* ac, int* bc, int* ba) {
  if (reg)
    clique_count_kernel<K, true><<<grid, kThreads, 0, st>>>(P, ac, bc, ba);
  else
    clique_count_kernel<K, false><<<grid, kThreads, 0, st>>>(P, ac, bc, ba);
}

}  // namespace

extern "C" int repic_clique_count(
    const void* xy, const void* mask, const void* sizes, void* nbr_v,
    void* nbr_i, void* anchor_count, void* block_count, void* block_adj,
    int m, int k, int n, int d, float threshold, void* stream) {
  Problem P = make_problem(xy, nullptr, mask, sizes, nbr_v, nbr_i, n, d,
                           threshold);
  dim3 grid((n + kThreads - 1) / kThreads, m);
  cudaStream_t st = (cudaStream_t)stream;
  int* ac = (int*)anchor_count;
  int* bc = (int*)block_count;
  int* ba = (int*)block_adj;
  const bool reg = d <= kRegD;
  switch (k) {
    case 2: launch_count<2>(reg, grid, st, P, ac, bc, ba); break;
    case 3: launch_count<3>(reg, grid, st, P, ac, bc, ba); break;
    case 4: launch_count<4>(reg, grid, st, P, ac, bc, ba); break;
    case 5: launch_count<5>(reg, grid, st, P, ac, bc, ba); break;
    case 6: launch_count<6>(reg, grid, st, P, ac, bc, ba); break;
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
  Problem P = make_problem(xy, conf, mask, sizes, nbr_v, nbr_i, n, d,
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
  dim3 grid((n + kThreads - 1) / kThreads, m);
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
