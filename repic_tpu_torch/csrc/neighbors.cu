// Fused IoU top-D neighbour search on Hopper.
//
// Replaces the TPU kernel repic_tpu/ops/iou_pallas.py:
// pallas_topk_neighbors (kernel body _neighbor_kernel).  For every
// anchor of set A against all of set B it computes the box IoU, the
// count of candidates above the threshold, and the top-D list in
// (value desc, index asc) order, lax.top_k's, without building the
// (N, M) matrix.  A masked pair has IoU -1 and never enters a list; an
// unmasked pair with no overlap is +0 and does, with its index; empty
// slots hold -1 and the index M.
//
// Design: a warp per anchor, kWarps anchors per block, grid.y over the
// batch items.  The block stages the candidates kTile at a time in
// shared memory, compacted to the unmasked ones in index order, as
// (x, y, x + s_b, y + s_b) with the index beside: a ballot per group of
// 32 candidates, then one warp scan over the 32 group counts.  A masked
// candidate thus costs the scan nothing and needs no test there.  The
// lanes evaluate 32 compacted candidates at a time with box_iou_pre (no
// division at zero intersection).  At real densities an anchor
// overlaps a few candidates and ties at zero IoU with all the others,
// so the list splits in two (d <= 32):
//   - the positive IoUs above the warp's current d-th value are
//     appended, by ballot, to a per-warp buffer in shared memory; when
//     it holds more than 32, the warp keeps its top d (kBuf slots, so
//     a batch of 32 always fits);
//   - the first d zero-IoU candidates, in index order, are recorded by
//     ballot in a per-warp row of shared memory, until d are found.
// At the end each buffered entry's rank is the number of entries ahead
// of it on (value desc, index asc), a total order on distinct indices,
// so ranks below d place the positives; the zeros fill the slots after
// them.  Lists of d > 32 (escalation, up to MAX_D) live per warp in the
// output row: the warp inserts the candidates above the d-th value in
// index order, an append in O(1) and any other insert by a
// warp-parallel count and shift.
// A masked anchor's warp skips the scan; a block with no unmasked
// anchor skips the staging.  Box sizes arrive as kernel arguments (one
// value for every item) or as a per-item array on the card: the
// wrapper makes no copy for them.
//
// Bound on this card: operations.  Each unmasked pair costs ~14 float
// ops; the inputs (9 B per particle) and outputs (8 B per list slot)
// are small next to the pair evaluations.
#include "topd.cuh"

namespace {

constexpr int kWarps = 8;               // anchors per block
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = 32;             // ballot groups of 32 per tile
constexpr int kTile = kGroups * 32;     // candidates staged at a time
constexpr int kShortD = 32;             // longest list kept by ranking
constexpr int kBuf = kShortD + 32;      // buffered positives per warp
constexpr unsigned kFull = 0xffffffffu;

// One side's box edges: dev[item] when dev is set, else value.
struct Sizes {
  const float* dev;
  float value;
};

__device__ __forceinline__ float size_of(const Sizes& s, int item) {
  return s.dev ? s.dev[item] : s.value;
}

struct Args {
  const float2* xy_a;     // (B, N)
  const uint8_t* mask_a;  // (B, N)
  const float2* xy_b;     // (B, M)
  const uint8_t* mask_b;  // (B, M)
  Sizes sa, sb;
  float* out_v;           // (B, N, d)
  int* out_i;             // (B, N, d)
  int* out_cnt;           // (B, N)
  int n, m, d;
  float threshold;
};

// Rank of the warp buffer's entries e = lane and lane + 32 (of np):
// the number of entries ahead of each on (value desc, index asc).
// Entries past np get rank kBuf.
__device__ __forceinline__ void buffer_ranks(const float* bv, const int* bi,
                                             int np, int lane, float ev[2],
                                             int ei[2], int er[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = lane + 32 * h;
    ev[h] = e < np ? bv[e] : 0.0f;
    ei[h] = e < np ? bi[e] : 0;
    er[h] = 0;
  }
  for (int j = 0; j < np; ++j) {
    const float vj = bv[j];
    const int ij = bi[j];
#pragma unroll
    for (int h = 0; h < 2; ++h) er[h] += topd_before(vj, ij, ev[h], ei[h]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lane + 32 * h >= np) er[h] = kBuf;
}

// Insert (val, id) into the warp's sorted list v/idx of `fill` entries
// (at most d): val beats the d-th entry and id is above every listed
// id.  When val is not above the last entry it is appended; otherwise
// the warp counts the entries >= val (equal values have lower ids and
// stay ahead) and shifts the rest up one slot, 32 at a time from the
// top.  Every lane calls it with the same arguments.
__device__ void warp_list_insert(float* v, int* idx, int d, int& fill,
                                 float& vmin, float val, int id,
                                 int lane) {
  int p = fill;
  if (fill > 0 && v[fill - 1] < val) {
    p = 0;
    for (int s0 = 0; s0 < fill; s0 += 32) {
      const int s = s0 + lane;
      const unsigned b = __ballot_sync(kFull, s < fill && v[s] >= val);
      p += __popc(b);
      if (b != kFull) break;
    }
    const int last = min(fill, d - 1);  // entries [p, last) move up
    for (int s0 = p + (last - p - 1) / 32 * 32; s0 >= p; s0 -= 32) {
      const int s = s0 + lane;
      float tv = 0.0f;
      int ti = 0;
      if (s < last) {
        tv = v[s];
        ti = idx[s];
      }
      __syncwarp();
      if (s < last) {
        v[s + 1] = tv;
        idx[s + 1] = ti;
      }
      __syncwarp();
    }
  }
  if (lane == 0) {
    v[p] = val;
    idx[p] = id;
  }
  fill = min(fill + 1, d);
  __syncwarp();
  vmin = fill == d ? v[d - 1] : -1.0f;
}

// kShort: d <= kShortD, the positives buffered and ranked, the zeros
// apart; otherwise one list per warp in the output row.
template <bool kShort>
__global__ void __launch_bounds__(kThreads, 4)
    topk_neighbors_kernel(Args A) {
  __shared__ float4 tile[kTile];
  __shared__ int tile_id[kTile];
  __shared__ int group_count[kGroups];
  __shared__ float buf_v[kShort ? kWarps : 1][kBuf];
  __shared__ int buf_i[kShort ? kWarps : 1][kBuf];
  __shared__ int zero_id[kShort ? kWarps : 1][kShortD];
  const int item = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int a = blockIdx.x * kWarps + warp;
  const int n = A.n, m = A.m, d = A.d;
  const bool active = a < n;
  const size_t arow = (size_t)item * n + a;
  const bool scan = active && A.mask_a[arow] != 0;
  float* v = A.out_v + arow * d;
  int* idx = A.out_i + arow * d;
  // a masked pair's -1 counts only where the threshold is below it
  const bool count_masked = -1.0f > A.threshold;
  const bool any = __syncthreads_or(scan);
  // warp-uniform: a masked anchor's row is empty
  if (active && !scan) {
    for (int s = lane; s < d; s += 32) {
      v[s] = -1.0f;
      idx[s] = m;
    }
    if (lane == 0) A.out_cnt[arow] = count_masked ? m : 0;
  }
  // block-uniform: no unmasked anchor in the block, nothing to stage
  if (!any) return;
  const float sa = size_of(A.sa, item), sb = size_of(A.sb, item);
  float ax = 0.0f, ay = 0.0f;
  if (scan) {
    const float2 p = A.xy_a[arow];
    ax = p.x;
    ay = p.y;
  }
  const float ax2 = ax + sa, ay2 = ay + sa;
  const float s2 = sa * sa + sb * sb;
  const float thr = A.threshold;
  float* bv = buf_v[kShort ? warp : 0];
  int* bi = buf_i[kShort ? warp : 0];
  int* zid = zero_id[kShort ? warp : 0];
  // kShort: positives above vmin are buffered; else the list's d-th
  float vmin = kShort ? 0.0f : -1.0f;
  int np = 0;      // buffered positives (kShort)
  int nz = 0;      // zero-IoU candidates seen (kShort)
  int fill = 0;    // entries in the per-warp list (!kShort)
  int cnt = 0;     // this lane's candidates above the threshold
  int masked = 0;  // masked candidates
  if (!kShort && scan) {
    for (int s = lane; s < d; s += 32) {
      v[s] = -1.0f;
      idx[s] = m;
    }
    __syncwarp();
  }
  const float2* xb = A.xy_b + (size_t)item * m;
  const uint8_t* mb = A.mask_b + (size_t)item * m;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    // stage: warp w loads groups w, w + kWarps, ... of 32 candidates
    constexpr int G = kGroups / kWarps;
    float2 q[G];
    unsigned bal[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int j = t0 + (warp + i * kWarps) * 32 + lane;
      const bool ok = j < m && mb[j] != 0;
      q[i] = ok ? xb[j] : make_float2(0.0f, 0.0f);
      bal[i] = __ballot_sync(kFull, ok);
      if (lane == 0) group_count[warp + i * kWarps] = __popc(bal[i]);
    }
    __syncthreads();
    // exclusive scan of the 32 group counts, lane g holding group g
    const int c = group_count[lane];
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int tn = __shfl_sync(kFull, incl, 31);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int g = warp + i * kWarps;
      const int base = __shfl_sync(kFull, incl - c, g);
      if ((bal[i] >> lane) & 1u) {
        const int pos = base + __popc(bal[i] & below);
        tile[pos] =
            make_float4(q[i].x, q[i].y, q[i].x + sb, q[i].y + sb);
        tile_id[pos] = t0 + g * 32 + lane;
      }
    }
    __syncthreads();
    masked += min(kTile, m - t0) - tn;
    if (!scan) continue;
    // four batches in flight: their tile loads overlap
#pragma unroll 4
    for (int jb = 0; jb < tn; jb += 32) {
      const int jj = jb + lane;
      float iou = -1.0f;
      if (jj < tn) {
        const float4 b = tile[jj];
        iou = box_iou_pre(ax, ay, ax2, ay2, b.x, b.y, b.z, b.w, s2);
        cnt += iou > thr;
      }
      const bool hit = iou > vmin;
      const unsigned hb = __ballot_sync(kFull, hit);
      if (kShort) {
        if (hb) {
          if (hit) {
            const int p = np + __popc(hb & below);
            bv[p] = iou;
            bi[p] = tile_id[jj];
          }
          np += __popc(hb);
          if (np > kBuf - 32) {
            // keep the top d in slots [0, d), in order
            __syncwarp();
            float ev[2];
            int ei[2], er[2];
            buffer_ranks(bv, bi, np, lane, ev, ei, er);
            __syncwarp();
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (er[h] < d) {
                bv[er[h]] = ev[h];
                bi[er[h]] = ei[h];
              }
            np = min(np, d);
            __syncwarp();
            if (d > 0) vmin = bv[d - 1];
          }
        }
        if (nz < d) {
          const bool zero = iou == 0.0f;
          const unsigned zb = __ballot_sync(kFull, zero);
          const int r = nz + __popc(zb & below);
          if (zero && r < d) zid[r] = tile_id[jj];
          nz += __popc(zb);
        }
      } else if (hb) {
        const int id = jj < tn ? tile_id[jj] : 0;
        unsigned bits = hb;
        while (bits) {
          const int s = __ffs(bits) - 1;
          bits &= bits - 1;
          const float val = __shfl_sync(kFull, iou, s);
          const int vid = __shfl_sync(kFull, id, s);
          if (val > vmin)
            warp_list_insert(v, idx, d, fill, vmin, val, vid, lane);
        }
      }
    }
  }
  if (!scan) return;
  if (kShort) {
    __syncwarp();
    float ev[2];
    int ei[2], er[2];
    buffer_ranks(bv, bi, np, lane, ev, ei, er);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (er[h] < d) {
        v[er[h]] = ev[h];
        idx[er[h]] = ei[h];
      }
    // after the positives: the zeros in index order, then empty slots
    const int npos = min(np, d);
    if (lane < d && lane >= npos) {
      const int z = lane - npos;
      const bool zero = z < min(nz, d);
      v[lane] = zero ? 0.0f : -1.0f;
      idx[lane] = zero ? zid[z] : m;
    }
  }
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) A.out_cnt[arow] = cnt + (count_masked ? masked : 0);
}

}  // namespace

// Each side's box sizes: a (batch,) array on the card or, where its
// pointer is null, one value for every item.
extern "C" int repic_topk_neighbors(
    const void* xy_a, const void* mask_a, const void* xy_b,
    const void* mask_b, const void* size_a, float size_a_value,
    const void* size_b, float size_b_value, void* out_v, void* out_i,
    void* out_cnt, int batch, int n, int m, int d, float threshold,
    void* stream) {
  if (d < 0) return (int)cudaErrorInvalidValue;
  Args A;
  A.xy_a = (const float2*)xy_a;
  A.mask_a = (const uint8_t*)mask_a;
  A.xy_b = (const float2*)xy_b;
  A.mask_b = (const uint8_t*)mask_b;
  A.sa = Sizes{(const float*)size_a, size_a_value};
  A.sb = Sizes{(const float*)size_b, size_b_value};
  A.out_v = (float*)out_v;
  A.out_i = (int*)out_i;
  A.out_cnt = (int*)out_cnt;
  A.n = n;
  A.m = m;
  A.d = d;
  A.threshold = threshold;
  dim3 grid((n + kWarps - 1) / kWarps, batch);
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= kShortD)
    topk_neighbors_kernel<true><<<grid, kThreads, 0, st>>>(A);
  else
    topk_neighbors_kernel<false><<<grid, kThreads, 0, st>>>(A);
  return (int)cudaGetLastError();
}
