// Device helpers shared by the neighbour-search and clique kernels.
//
// Float discipline: the sources build with --fmad=false, so every
// expression below rounds each operation to float32 on its own, the
// way the plain PyTorch versions (and the JAX reference on the CPU)
// evaluate it.  Division is IEEE round-to-nearest (nvcc's default
// -prec-div=true); --use_fast_math must never be added.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Box IoU of two square boxes with lower-left corners (ax, ay) and
// (bx, by) and edges sa, sb: inter / (sa^2 + sb^2 - inter).
__device__ __forceinline__ float box_iou(float ax, float ay, float sa,
                                         float bx, float by, float sb) {
  float ovx = fmaxf(fminf(ax + sa, bx + sb) - fmaxf(ax, bx), 0.0f);
  float ovy = fmaxf(fminf(ay + sa, by + sb) - fmaxf(ay, by), 0.0f);
  float inter = ovx * ovy;
  return inter / (sa * sa + sb * sb - inter);
}

// The top-d lists below are kept sorted by value descending.  The
// caller inserts only when val > v[d - 1] and offers candidates in
// increasing id order, so an equal value already in the list (a lower
// id) stays ahead: the list order is (value desc, id asc), which is
// lax.top_k's order and the Pallas kernels' min-position tie-break.

// The clique kernel keeps lists of d <= kRegD entries in registers
// (LaneList below).
constexpr int kRegD = 16;

// Its longer lists (d > kRegD) live in memory: insert (val, id) in
// place.
__device__ __forceinline__ void topd_insert(float* v, int* idx, int d,
                                            float val, int id) {
  int j = d - 1;
  while (j > 0 && v[j - 1] < val) {
    v[j] = v[j - 1];
    idx[j] = idx[j - 1];
    --j;
  }
  v[j] = val;
  idx[j] = id;
}

// ---- warp-cooperative top-d: one list per lane, then a warp merge ----
//
// Lane l of a warp offers candidates l, l + 32, l + 64, ... in
// increasing id order to its own register list of R slots (R a
// compile-time length, d <= R), with the strict-greater insertion rule
// above, so each lane list is (value desc, id asc).  warp_merge_topd
// then takes d rounds of a warp arg-max on the key (value desc, id asc)
// over the 32 list heads and pops the winner's head: the result is the
// top-d of all candidates in lax.top_k's order, ties included, because
// the key is a total order on distinct ids and each lane list is itself
// sorted by it.  Empty slots hold (-1, INT_MAX) and lose to any real
// entry (every real value is >= 0 in the clique kernel).

template <int R>
struct LaneList {
  float v[R];
  int idx[R];
};

template <int R>
__device__ __forceinline__ void lanelist_init(LaneList<R>& t) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    t.v[s] = -1.0f;
    t.idx[s] = 0x7fffffff;
  }
}

// Insert (val, id) into the first d slots; returns the new v[d - 1].
// Walking up from the bottom over the R slots (every index a
// compile-time constant after unrolling, so none spills), a slot whose
// value is below val takes its upper neighbour's entry, or val itself
// once the neighbour is not below val.
template <int R>
__device__ __forceinline__ float lanelist_insert(LaneList<R>& t, int d,
                                                 float val, int id) {
  float last = 0.0f;
#pragma unroll
  for (int s = R - 1; s >= 0; --s) {
    if (s < d && t.v[s] < val) {
      if (s > 0 && t.v[s - 1] < val) {
        t.v[s] = t.v[s - 1];
        t.idx[s] = t.idx[s - 1];
      } else {
        t.v[s] = val;
        t.idx[s] = id;
      }
    }
    if (s == d - 1) last = t.v[s];
  }
  return last;
}

// True when (va, ia) comes before (vb, ib): value desc, then id asc.
__device__ __forceinline__ bool topd_before(float va, int ia, float vb,
                                            int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Merge the 32 lane lists of a warp (every lane calls it, converged);
// lane s < d returns merged entry s in (*v, *id).  Lane l holds the
// candidates with id % 32 == l, so the winner of a round is popped by
// lane (id & 31).  d <= R <= 32.
template <int R>
__device__ __forceinline__ void warp_merge_topd(LaneList<R>& t, int d,
                                                float* v, int* id) {
  const int lane = threadIdx.x & 31;
  *v = -1.0f;
  *id = 0x7fffffff;
  for (int r = 0; r < d; ++r) {
    float bv = t.v[0];
    int bi = t.idx[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (topd_before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == r) {
      *v = bv;
      *id = bi;
    }
    if ((bi & 31) == lane) {
#pragma unroll
      for (int s = 0; s + 1 < R; ++s) {
        t.v[s] = t.v[s + 1];
        t.idx[s] = t.idx[s + 1];
      }
      t.v[R - 1] = -1.0f;
      t.idx[R - 1] = 0x7fffffff;
    }
  }
}

// Box IoU as box_iou computes it, from precomputed corner sums:
// ax2 = ax + sa, bx2 = bx + sb (likewise y) and s2 = sa * sa + sb * sb,
// each rounded as box_iou rounds it.  With no overlap the result is
// inter itself (+0: the overlaps are clamped at +0), which is what the
// division by the positive union gives, so the division is skipped.
__device__ __forceinline__ float box_iou_pre(float ax, float ay, float ax2,
                                             float ay2, float bx, float by,
                                             float bx2, float by2,
                                             float s2) {
  const float ovx = fmaxf(fminf(ax2, bx2) - fmaxf(ax, bx), 0.0f);
  const float ovy = fmaxf(fminf(ay2, by2) - fmaxf(ay, by), 0.0f);
  const float inter = ovx * ovy;
  return inter == 0.0f ? inter : inter / (s2 - inter);
}
