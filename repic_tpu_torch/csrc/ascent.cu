// The staged lp_device program's dual ascent on Hopper, one launch an
// attempt, one block per micrograph (solver/dual.py:
// dual_ascent_plain, bit for bit).
//
// Outside kernel 3's envelope (C in the tens of thousands at K = 5)
// kernel 3's layout, every array in shared memory or every array in a
// global slice, would put the whole solve in global memory.  This
// kernel runs kernel 3's staging and ascent (dual_ascent.cuh) with
// split residency: the vertex state (lam, lam_sum, ax: V x 12 B) in
// shared memory, or in the block's global slice where it does not fit;
// the valid cliques, staged once as uint16 ids (uint32 past 65,535
// vertices) and weights, in the rest of shared memory as far as they
// fit and the others in the global slice, which every step after the
// first reads from L2.  It writes lam, the averaged prices, the steps t
// and the stop test's delta of each micrograph; the rounding stays in
// PyTorch.
//
// Instances: the clique widths 1 to 6 with the state in shared memory
// hold a clique's members in registers through a step; any other width,
// and every solve whose state is in the global slice (the bucketed path
// at large N, where the state's global traffic is the step's cost),
// take the width at run time.
#include "dual_ascent.cuh"

namespace {

// Dynamic shared memory holds the solve state when it fits, and the
// first n_near staged cliques; the block's global slice holds the state
// when it does not fit, and the staged cliques past n_near.
struct AscentLayout {
  size_t lam, lam_sum, ax, near_mv, near_w, smem, far_mv, far_w, far;
};

__host__ __device__ inline AscentLayout ascent_layout(int c, int k, int v,
                                                      int n_near,
                                                      bool state_smem) {
  const size_t idb = id_bytes(v), vec = align16(4 * (size_t)v);
  const size_t n_far = c > n_near ? (size_t)(c - n_near) : 0;
  AscentLayout L;
  L.lam = 0;
  L.lam_sum = vec;
  L.ax = 2 * vec;
  size_t o = state_smem ? 3 * vec : 0;
  L.near_mv = o;  o = align16(o + idb * n_near * k);
  L.near_w = o;   o = align16(o + 4 * (size_t)n_near);
  L.smem = o;
  o = state_smem ? 0 : 3 * vec;
  L.far_mv = o;   o = align16(o + idb * n_far * k);
  L.far_w = o;    o = align16(o + 4 * n_far);
  L.far = o;
  return L;
}

// One block per micrograph: the valid cliques are staged once, then
// the ascent runs to its stop test, and the block writes lam, the
// averaged prices, its steps t and the last step's max|dlam| / eta0
// (delta).  kStateSmem: the state lives in shared memory (else in the
// global slice).  K: the clique width, or 0 for the run-time k.
template <typename VT, int K, bool kStateSmem>
__global__ void __launch_bounds__(kThreads, 1)
    dual_ascent_kernel(const int* __restrict__ mv_all,
                       const float* __restrict__ w_all,
                       const uint8_t* __restrict__ valid_all,
                       float* __restrict__ lam_out,
                       float* __restrict__ avg_out, int* __restrict__ t_out,
                       float* __restrict__ delta_out, uint8_t* scratch,
                       int c, int k, int v, int n_near, int num_iters,
                       float tol) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red_f[kWarps];
  __shared__ unsigned red_u[kWarps];
  __shared__ int tile_cnt[2][kWarps];
  const int m = blockIdx.x;
  const int kk = width<K>(k);
  const AscentLayout L = ascent_layout(c, kk, v, n_near, kStateSmem);
  uint8_t* far = scratch + (size_t)m * L.far;
  uint8_t* state = kStateSmem ? smem : far;
  float* lam = (float*)(state + L.lam);
  float* lam_sum = (float*)(state + L.lam_sum);
  int* ax = (int*)(state + L.ax);
  VT* near_mv = (VT*)(smem + L.near_mv);
  float* near_w = (float*)(smem + L.near_w);
  VT* far_mv = (VT*)(far + L.far_mv);
  float* far_w = (float*)(far + L.far_w);
  int nbar = 0;

  clear_state(lam, lam_sum, ax, v);
  float eta0;
  const int nv = stage<VT, K>(
      mv_all + (size_t)m * c * kk, w_all + (size_t)m * c,
      valid_all + (size_t)m * c, c, kk, near_mv, near_w, n_near, far_mv,
      far_w, nullptr, nullptr, tile_cnt, red_f, eta0, nbar);
  const int n0 = min(nv, n_near);
  const Ascent a = ascent<VT, K>(near_mv, near_w, n0, far_mv, far_w,
                                 nv - n0, kk, lam, lam_sum, ax, v, eta0,
                                 num_iters, tol, red_u, nbar);
  average(lam, lam_sum, avg_out + (size_t)m * v, v, a.n_tail);
  float* lo = lam_out + (size_t)m * v;
  for (int j = threadIdx.x; j < v; j += blockDim.x) lo[j] = lam[j];
  if (threadIdx.x == 0) {
    t_out[m] = a.t;
    delta_out[m] = a.delta;
  }
}

template <typename VT, int K, bool kStateSmem>
int launch(const void* mv, const void* w, const void* valid, void* lam,
           void* avg, void* t, void* delta, void* scratch, int m, int c,
           int k, int v, int n_near, int num_iters, float tol,
           cudaStream_t stream) {
  const size_t dyn = ascent_layout(c, k, v, n_near, kStateSmem).smem;
  cudaError_t e = cudaFuncSetAttribute(
      dual_ascent_kernel<VT, K, kStateSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  dual_ascent_kernel<VT, K, kStateSmem><<<m, kThreads, dyn, stream>>>(
      (const int*)mv, (const float*)w, (const uint8_t*)valid, (float*)lam,
      (float*)avg, (int*)t, (float*)delta, (uint8_t*)scratch, c, k, v,
      n_near, num_iters, tol);
  return (int)cudaGetLastError();
}

template <typename VT>
int launch_k(const void* mv, const void* w, const void* valid, void* lam,
             void* avg, void* t, void* delta, void* scratch, int m, int c,
             int k, int v, int n_near, int state_smem, int num_iters,
             float tol, cudaStream_t st) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (!state_smem)
    return launch<VT, 0, false>(mv, w, valid, lam, avg, t, delta, scratch, m, c, k, v, n_near, num_iters, tol, st);
  switch (k) {
    case 1: return launch<VT, 1, true>(mv, w, valid, lam, avg, t, delta, scratch, m, c, k, v, n_near, num_iters, tol, st);
    case 2: return launch<VT, 2, true>(mv, w, valid, lam, avg, t, delta, scratch, m, c, k, v, n_near, num_iters, tol, st);
    case 3: return launch<VT, 3, true>(mv, w, valid, lam, avg, t, delta, scratch, m, c, k, v, n_near, num_iters, tol, st);
    case 4: return launch<VT, 4, true>(mv, w, valid, lam, avg, t, delta, scratch, m, c, k, v, n_near, num_iters, tol, st);
    case 5: return launch<VT, 5, true>(mv, w, valid, lam, avg, t, delta, scratch, m, c, k, v, n_near, num_iters, tol, st);
    case 6: return launch<VT, 6, true>(mv, w, valid, lam, avg, t, delta, scratch, m, c, k, v, n_near, num_iters, tol, st);
    default: return launch<VT, 0, true>(mv, w, valid, lam, avg, t, delta, scratch, m, c, k, v, n_near, num_iters, tol, st);
  }
}

}  // namespace

// The kernel's dynamic shared memory and the bytes of each block's
// global slice, for n_near cliques staged in shared memory and the
// state there (state_smem 1) or in the slice (0).
extern "C" int repic_dual_ascent_smem_bytes(int c, int k, int v, int n_near,
                                            int state_smem) {
  return (int)ascent_layout(c, k, v, n_near, state_smem != 0).smem;
}

extern "C" int repic_dual_ascent_slice_bytes(int c, int k, int v,
                                             int n_near, int state_smem) {
  return (int)ascent_layout(c, k, v, n_near, state_smem != 0).far;
}

// The dual ascent of M packings: lam and the averaged prices (M, V)
// float32, the steps t (M,) int32 and the last step's max|dlam| / eta0
// (M,) float32; scratch holds M global slices.
extern "C" int repic_dual_ascent(const void* mv, const void* w,
                                 const void* valid, void* lam, void* avg,
                                 void* t, void* delta, void* scratch, int m,
                                 int c, int k, int v, int n_near,
                                 int state_smem, int num_iters, float tol,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (id_bytes(v) == 2)
    return launch_k<uint16_t>(mv, w, valid, lam, avg, t, delta, scratch, m,
                              c, k, v, n_near, state_smem, num_iters, tol,
                              st);
  return launch_k<int>(mv, w, valid, lam, avg, t, delta, scratch, m, c, k,
                       v, n_near, state_smem, num_iters, tol, st);
}
