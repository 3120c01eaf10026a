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

// Both top-d lists below are kept sorted by value descending.  The
// caller inserts only when val > v[d - 1] and offers candidates in
// increasing id order, so an equal value already in the list (a lower
// id) stays ahead: the list order is (value desc, id asc), which is
// lax.top_k's order and the Pallas kernels' min-position tie-break.

// Lists of d <= kRegD entries live in registers; every index into them
// is a compile-time constant after unrolling, so none spills.
constexpr int kRegD = 16;

struct RegTopD {
  float v[kRegD];
  int idx[kRegD];
};

__device__ __forceinline__ void regtopd_init(RegTopD& t, float val,
                                             int id) {
#pragma unroll
  for (int s = 0; s < kRegD; ++s) {
    t.v[s] = val;
    t.idx[s] = id;
  }
}

// Insert (val, id) into the first d slots; returns the new v[d - 1].
// Walking up from the bottom, a slot whose value is below val takes
// its upper neighbour's entry, or val itself once the neighbour is not
// below val.
__device__ __forceinline__ float regtopd_insert(RegTopD& t, int d,
                                                float val, int id) {
  float last = 0.0f;
#pragma unroll
  for (int s = kRegD - 1; s >= 0; --s) {
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

// Copy the first d entries of a register list to memory.
__device__ __forceinline__ void regtopd_store(const RegTopD& t, int d,
                                              float* v, int* idx) {
#pragma unroll
  for (int s = 0; s < kRegD; ++s) {
    if (s < d) {
      v[s] = t.v[s];
      idx[s] = t.idx[s];
    }
  }
}

// Longer lists (d > kRegD) live in memory: insert (val, id) in place.
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
