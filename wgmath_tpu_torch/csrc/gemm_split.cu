// f32 matrix product from operands split once into bf16 planes, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel of wgmath_tpu/ops/gemm.py gemm_split. The caller
// splits each f32 operand once, outside the kernel, into three bf16 planes
// hi + mid + lo by mantissa bitmask (ops/gemm.py _split3 of this package).
// The kernel reads the 2 x 3 planes (or 2 x 2 for three passes) and sums the
// cross terms in f32. A product of two bf16 values has at most 16 mantissa
// bits and is exact in f32, so only the additions round. The summation is
// error-ordered as in the Pallas kernel: one accumulator per order of
// magnitude,
//   low   lo.hi + mid.mid + hi.lo     (six passes only)
//   mid   mid.hi + hi.mid
//   high  hi.hi
// each carried over the whole of K, added low to high at the end.
//
// Design. As in gemm.cu, the sequential K grid of the Pallas kernel becomes
// a loop inside the block that owns the output tile. 256 threads on a
// 64 x 64 tile, 4 x 4 outputs and 3 x 16 sums per thread; the planes are
// staged through the loader of gemm_tile.cuh (bf16 widened on load, f32 in
// shared memory). 2-D, both operands plain (not transposed), any M, N,
// K >= 1.
//
// Bound on this card: operations. Six (three) passes of 2 M N K flops
// against 6 (4) bf16 planes read and one f32 matrix written. The card's
// least time for the same result is six bf16 tensor-core passes
// (989 TFLOP/s); this kernel runs them as f32 multiply-adds on the f32 pipes
// (67 TFLOP/s), so it cannot come nearer than 1/15 of that bound.
//
// Multiply-add: explicit fmaf(), which the build's --fmad=false does not
// touch (see gemm.cu).

#include "gemm_tile.cuh"

namespace {

using namespace tile;

constexpr int T4 = 4;        // outputs per thread and side
constexpr int BT = 16 * T4;  // tile edge

template <int NS>  // planes per operand: 3 (six passes) or 2 (three passes)
__global__ void __launch_bounds__(THREADS)
    gemm_split_kernel(const __nv_bfloat16* __restrict__ A,
                      const __nv_bfloat16* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K,
                      long long plane_a, long long plane_b) {
  __shared__ __align__(16) float As[NS][BK][BT + PAD];
  __shared__ __align__(16) float Bs[NS][BK][BT + PAD];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BT, n0 = blockIdx.x * BT;

  float low[T4][T4], mid[T4][T4], high[T4][T4];
#pragma unroll
  for (int i = 0; i < T4; ++i)
#pragma unroll
    for (int j = 0; j < T4; ++j) low[i][j] = mid[i][j] = high[i][j] = 0.0f;

  float ra[NS][BT * BK / THREADS], rb[NS][BT * BK / THREADS];
#pragma unroll
  for (int p = 0; p < NS; ++p) {
    fetch<__nv_bfloat16, BT, true>(A + p * plane_a, K, m0, 0, M, K, ra[p]);
    fetch<__nv_bfloat16, BT, false>(B + p * plane_b, N, n0, 0, N, K, rb[p]);
  }
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      stash<BT, true>(As[p], ra[p]);
      stash<BT, false>(Bs[p], rb[p]);
    }
    __syncthreads();
    if (k0 + BK < K) {
#pragma unroll
      for (int p = 0; p < NS; ++p) {
        fetch<__nv_bfloat16, BT, true>(A + p * plane_a, K, m0, k0 + BK, M, K,
                                       ra[p]);
        fetch<__nv_bfloat16, BT, false>(B + p * plane_b, N, n0, k0 + BK, N, K,
                                        rb[p]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[NS][T4], b[NS][T4];  // plane 0 hi, 1 mid, 2 lo
#pragma unroll
      for (int p = 0; p < NS; ++p) {
        fragment<T4, BT>(As[p], kk, ty, a[p]);
        fragment<T4, BT>(Bs[p], kk, tx, b[p]);
      }
#pragma unroll
      for (int i = 0; i < T4; ++i)
#pragma unroll
        for (int j = 0; j < T4; ++j) {
          if (NS == 3) {
            low[i][j] = fmaf(a[NS - 1][i], b[0][j], low[i][j]);
            low[i][j] = fmaf(a[1][i], b[1][j], low[i][j]);
            low[i][j] = fmaf(a[0][i], b[NS - 1][j], low[i][j]);
          }
          mid[i][j] = fmaf(a[1][i], b[0][j], mid[i][j]);
          mid[i][j] = fmaf(a[0][i], b[1][j], mid[i][j]);
          high[i][j] = fmaf(a[0][i], b[0][j], high[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T4; ++i) {
    const int m = m0 + owned(i, ty);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < T4; ++j) {
      const int n = n0 + owned(j, tx);
      if (n < N)
        C[(long long)m * N + n] = (low[i][j] + mid[i][j]) + high[i][j];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). A holds `n_split` contiguous
// bf16 planes [n_split, M, K], B [n_split, K, N], hi first; C is contiguous
// f32 [M, N]. `n_split` 3 runs six passes, 2 three. Returns
// cudaGetLastError() after the launch; 1000 for another `n_split`, 1001 for
// an M past the grid's limit.
extern "C" int gemm_split_launch(int n_split, int M, int N, int K,
                                 const void* A, const void* B, void* C,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((M + BT - 1) / BT > 65535) return 1001;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BT - 1) / BT, (M + BT - 1) / BT);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(B);
  float* c = static_cast<float*>(C);
  const long long pa = (long long)M * K, pb = (long long)K * N;
  if (n_split == 3) {
    gemm_split_kernel<3><<<grid, THREADS, 0, s>>>(a, b, c, M, N, K, pa, pb);
  } else if (n_split == 2) {
    gemm_split_kernel<2><<<grid, THREADS, 0, s>>>(a, b, c, M, N, K, pa, pb);
  } else {
    return 1000;
  }
  return static_cast<int>(cudaGetLastError());
}
