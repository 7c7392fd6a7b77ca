// Gauss-Seidel impulse update for one colour rung with the substep's
// softness and right-hand sides passed in, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel wgmath_tpu/dynamics/gs_pallas.py
// _gs_math_pallas_call (reached through gs_math_block; the window-ladder
// sweep and the chained sweep without rhs-in-rung launch it once per rung
// per sweep). Computes exactly _gs_math_xla: _cm_point_updates for P
// contact points with S = 2 friction directions, then d1 = w1 - v1,
// d2 = w2 - v2. The point update is gs_point_updates.cuh, shared with
// gs_math.cu.
//
// Layout: row-major, one constraint row per thread (the Pallas kernel's
// lane tiling answers a VMEM budget and has no counterpart here). Row i
// reads
//   win[i, :]          packed substep-invariant fields; only the 15 fields
//                      of the point update are read, at the column offsets
//                      passed in `offsets` (the matrix may or may not carry
//                      the rhs-relinearization columns),
//   cfm[i]             softness factor (strided),
//   n_rhs[i, 0:P], t_rhs[i, 0:P*S]   this substep's right-hand sides,
//   p1/p2[i, 0:6]      both sides' linear|angular velocities,
//   prev_n[i, 0:P], prev_t[i, 0:P*S]   impulses of the previous iteration,
// and writes new_n [L,P], new_t [L,P,S], d1/d2 [L,6]. Every input has its
// own leading dimension, so the caller passes strided views (window rows
// of the field matrix, halves of one gathered [2L, 6] block, columns of the
// merged impulse matrix) without a copy. The kernel writes only its own
// rows: no atomics.
//
// Bound on this card: memory. Per row (P = 1) it reads 56 packed f32, cfm,
// 3 rhs, 12 velocity and 3 impulse f32, one i64 and one u8 (309 B) and
// writes 16 f32 (64 B), against ~200 flops. At rung sizes (128..5504 rows)
// launch overhead dominates, as for gs_math.cu.
//
// No fast-math; built without multiply-add contraction like gs_math.cu
// (core/cuda_build.py gives both sources the same flags), so each product
// rounds as in the plain PyTorch version.

#include "gs_point_updates.cuh"

namespace {

using namespace gs;

template <int P>
__global__ void __launch_bounds__(256) gs_math_block_kernel(
    int L, const float* __restrict__ win, int ld_win, Offsets off,
    const float* __restrict__ cfm, int ld_cfm,
    const float* __restrict__ n_rhs, int ld_nr,
    const float* __restrict__ t_rhs, int ld_tr,
    const int64_t* __restrict__ nump, const uint8_t* __restrict__ active,
    const float* __restrict__ p1, int ld_p1,
    const float* __restrict__ p2, int ld_p2,
    const float* __restrict__ prev_n, int ld_pn,
    const float* __restrict__ prev_t, int ld_pt,
    float* __restrict__ new_n, float* __restrict__ new_t,
    float* __restrict__ d1, float* __restrict__ d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const float* f = win + (size_t)i * ld_win;

  float v1l[3], v1a[3], v2l[3], v2a[3];
  load_vel(p1 + (size_t)i * ld_p1, v1l, v1a);
  load_vel(p2 + (size_t)i * ld_p2, v2l, v2a);
  RowFields r;
  load_row_fields(f, off, r);
  const bool act = active[i] != 0;
  const float np_f = (float)nump[i];

  float nr[P], tr[P][S];
  const float* nrow = n_rhs + (size_t)i * ld_nr;
  const float* trow = t_rhs + (size_t)i * ld_tr;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    nr[k] = nrow[k];
#pragma unroll
    for (int j = 0; j < S; ++j) tr[k][j] = trow[S * k + j];
  }

  float w1l[3], w1a[3], w2l[3], w2a[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w1l[a] = v1l[a];
    w1a[a] = v1a[a];
    w2l[a] = v2l[a];
    w2a[a] = v2a[a];
  }
  gs_point_updates<P>(f, off, r, act, np_f, cfm[(size_t)i * ld_cfm], nr, tr,
                      prev_n + (size_t)i * ld_pn, prev_t + (size_t)i * ld_pt,
                      w1l, w1a, w2l, w2a, new_n + (size_t)i * P,
                      new_t + (size_t)i * P * S);
  store_delta(d1 + (size_t)i * 6, w1l, w1a, v1l, v1a);
  store_delta(d2 + (size_t)i * 6, w2l, w2a, v2l, v2a);
}

}  // namespace

// Plain C entry point (bound with ctypes). `offsets` holds N_FIELDS column
// offsets in gs_math.PACK_FIELDS order; the rhs-relinearization entries are
// not read. Returns cudaGetLastError() after the launch; 1000 for an
// unsupported p_max.
extern "C" int gs_math_block_launch(
    int p_max, int L, const float* win, int ld_win, const int* offsets,
    const float* cfm, int ld_cfm, const float* n_rhs, int ld_nr,
    const float* t_rhs, int ld_tr, const int64_t* nump,
    const uint8_t* active, const float* p1, int ld_p1, const float* p2,
    int ld_p2, const float* prev_n, int ld_pn, const float* prev_t,
    int ld_pt, float* new_n, float* new_t, float* d1, float* d2,
    void* stream) {
  if (L <= 0) return 0;
  Offsets off;
  for (int k = 0; k < N_FIELDS; ++k) off.o[k] = offsets[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (L + threads - 1) / threads;
#define WG_LAUNCH(PP)                                                        \
  gs_math_block_kernel<PP><<<blocks, threads, 0, s>>>(                       \
      L, win, ld_win, off, cfm, ld_cfm, n_rhs, ld_nr, t_rhs, ld_tr, nump,    \
      active, p1, ld_p1, p2, ld_p2, prev_n, ld_pn, prev_t, ld_pt, new_n,     \
      new_t, d1, d2)
  if (p_max == 1) {
    WG_LAUNCH(1);
  } else if (p_max == 4) {
    WG_LAUNCH(4);
  } else {
    return 1000;
  }
#undef WG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
