// Fused IoU top-D neighbour search on Hopper.
//
// Replaces the TPU kernel repic_tpu/ops/iou_pallas.py:
// pallas_topk_neighbors (kernel body _neighbor_kernel).  For every
// anchor of set A against all of set B it computes the box IoU, the
// count of candidates above the threshold, and a running top-D —
// without building the (N, M) matrix.  Masked pairs carry IoU -1 and
// never enter the list; empty slots keep value -1 and index M.
//
// Design: one thread per anchor, 128 anchors per block; candidates
// stream through shared memory in tiles of 256.  The top-D list is
// kept sorted (value desc, index asc) in registers when D <= 16 (the
// main path's case) and in the output row itself for longer lists;
// the thread holds the current D-th value in a register, so the
// common case — a candidate that does not beat it — costs one compare.
// grid.y runs over the batch of (micrograph, picker pair) problems, so
// one launch covers a whole chunk.
//
// Bound on this card: operations.  Each pair costs ~12 float ops; the
// inputs (16 B per particle) and outputs (8 B per list slot) are tiny
// next to B * N * M pair evaluations.
#include "topd.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;

template <bool kReg>
__global__ void topk_neighbors_kernel(
    const float2* __restrict__ xy_a, const uint8_t* __restrict__ mask_a,
    const float2* __restrict__ xy_b, const uint8_t* __restrict__ mask_b,
    const float* __restrict__ size_a, const float* __restrict__ size_b,
    float* __restrict__ out_v, int* __restrict__ out_i,
    int* __restrict__ out_cnt, int n, int m, int d, float threshold) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ uint8_t sm[kTile];
  const int b = blockIdx.y;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  const bool active = a < n;
  const float sa = size_a[b];
  const float sb = size_b[b];
  float ax = 0.0f, ay = 0.0f;
  bool am = false;
  float* v = out_v + ((size_t)b * n + a) * d;
  int* idx = out_i + ((size_t)b * n + a) * d;
  RegTopD top;
  if (kReg) regtopd_init(top, -1.0f, m);
  if (active) {
    float2 p = xy_a[(size_t)b * n + a];
    ax = p.x;
    ay = p.y;
    am = mask_a[(size_t)b * n + a] != 0;
    if (!kReg) {
      for (int s = 0; s < d; ++s) {
        v[s] = -1.0f;
        idx[s] = m;
      }
    }
  }
  float vmin = -1.0f;
  int cnt = 0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile && t0 + j < m; j += kThreads) {
      float2 q = xy_b[(size_t)b * m + t0 + j];
      sx[j] = q.x;
      sy[j] = q.y;
      sm[j] = mask_b[(size_t)b * m + t0 + j];
    }
    __syncthreads();
    if (!active) continue;
    const int tn = min(kTile, m - t0);
    for (int j = 0; j < tn; ++j) {
      float iou = box_iou(ax, ay, sa, sx[j], sy[j], sb);
      iou = (am && sm[j]) ? iou : -1.0f;
      cnt += iou > threshold;
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
  if (active) {
    out_cnt[(size_t)b * n + a] = cnt;
    if (kReg) regtopd_store(top, d, v, idx);
  }
}

}  // namespace

extern "C" int repic_topk_neighbors(
    const void* xy_a, const void* mask_a, const void* xy_b,
    const void* mask_b, const void* size_a, const void* size_b,
    void* out_v, void* out_i, void* out_cnt, int batch, int n, int m,
    int d, float threshold, void* stream) {
  dim3 grid((n + kThreads - 1) / kThreads, batch);
  auto kernel = d <= kRegD ? topk_neighbors_kernel<true>
                           : topk_neighbors_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)xy_a, (const uint8_t*)mask_a, (const float2*)xy_b,
      (const uint8_t*)mask_b, (const float*)size_a, (const float*)size_b,
      (float*)out_v, (int*)out_i, (int*)out_cnt, n, m, d, threshold);
  return (int)cudaGetLastError();
}
