// Batched matrix product C = op(A) op(B), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel wgmath_tpu/ops/gemm.py _gemm_pallas (reached
// through gemm). Computes what that kernel computes: for every batch matrix,
// op(A) [M, K] times op(B) [K, N] with f32 accumulation, inputs f32 or bf16,
// output in the input type and rounded once at the end. Either operand may
// be stored transposed; a single-matrix operand is broadcast over the batch
// by a batch stride of 0.
//
// Design. The Pallas kernel walks K as the last, sequential dimension of its
// grid and carries the sum in VMEM between grid steps; blocks of a CUDA grid
// run in no order, so here one block owns one output tile of one batch
// matrix and loops over K itself. 256 threads; each keeps a TM x TN patch of
// sums in registers (8 x 8 on a 128 x 128 tile when the product has at least
// one such tile per SM, else 4 x 4 on a 64 x 64 tile so that a small product
// still fills the card). Tiles of both operands are staged through registers
// into shared memory as f32, k-major (gemm_tile.cuh): the next tile's global
// loads are started before the current tile's arithmetic, and the inner loop
// reads float4 fragments and does TM x TN fused multiply-adds per k. The
// block masks the ragged edge itself, so any M, N, K >= 1 is taken.
//
// Bound on this card: operations. 2 M N K flops against 4 (M K + K N + M N)
// bytes is 683 flops a byte at 4096^3, far above the 20 flops a byte where
// the f32 pipes (67 TFLOP/s) and the memory (3.35 TB/s) balance. This kernel
// uses the f32 pipes only: no tensor cores, so "default" precision is as
// exact, and as slow, as "highest".
//
// Multiply-add: core/cuda_build.py builds every source with --fmad=false
// (the Gauss-Seidel kernels need each product rounded on its own). That flag
// only stops the compiler from contracting a * b + c; the explicit fmaf()
// below is not affected, so the inner loop is one FFMA per term.

#include "gemm_tile.cuh"

// Blocks the compiler must fit on one SM. 2 caps a thread at 128 registers,
// so two blocks (16 warps) share an SM and one block's arithmetic covers the
// other's barrier between tiles: 38.2 against 33.4 TFLOP/s at 4096^3 on an
// H100 (700 W), with 24 bytes of spill in one variant.
// scripts/exp_gemm_tiles.py builds other values of this and of the tile depth.
#ifndef WG_GEMM_MIN_BLOCKS
#define WG_GEMM_MIN_BLOCKS 2
#endif

namespace {

using namespace tile;

template <typename T, int TM, int TN, bool TA, bool TB>
__global__ void __launch_bounds__(THREADS, WG_GEMM_MIN_BLOCKS)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ C, int M, int N, int K, long long lda,
                long long ldb, long long batch_a, long long batch_b) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += blockIdx.z * batch_a;
  B += blockIdx.z * batch_b;
  C += (long long)blockIdx.z * M * N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // a plain A has k contiguous, a plain B has n contiguous
  float ra[BM * BK / THREADS], rb[BN * BK / THREADS];
  fetch<T, BM, !TA>(A, lda, m0, 0, M, K, ra);
  fetch<T, BN, TB>(B, ldb, n0, 0, N, K, rb);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash<BM, !TA>(As, ra);
    stash<BN, TB>(Bs, rb);
    __syncthreads();
    if (k0 + BK < K) {
      fetch<T, BM, !TA>(A, lda, m0, k0 + BK, M, K, ra);
      fetch<T, BN, TB>(B, ldb, n0, k0 + BK, N, K, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      fragment<TM, BM>(As, kk, ty, a);
      fragment<TN, BN>(Bs, kk, tx, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + owned(i, ty);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + owned(j, tx);
      if (n < N) C[(long long)m * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int TT, bool TA, bool TB>
void launch(const void* A, const void* B, void* C, int nb, int M, int N, int K,
            long long lda, long long ldb, long long batch_a, long long batch_b,
            cudaStream_t s) {
  const dim3 grid((N + 16 * TT - 1) / (16 * TT), (M + 16 * TT - 1) / (16 * TT),
                  nb);
  gemm_kernel<T, TT, TT, TA, TB><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C),
      M, N, K, lda, ldb, batch_a, batch_b);
}

template <typename T, int TT>
void launch_tr(int ta, int tb, const void* A, const void* B, void* C, int nb,
               int M, int N, int K, long long lda, long long ldb,
               long long batch_a, long long batch_b, cudaStream_t s) {
  if (ta && tb)
    launch<T, TT, true, true>(A, B, C, nb, M, N, K, lda, ldb, batch_a,
                              batch_b, s);
  else if (ta)
    launch<T, TT, true, false>(A, B, C, nb, M, N, K, lda, ldb, batch_a,
                               batch_b, s);
  else if (tb)
    launch<T, TT, false, true>(A, B, C, nb, M, N, K, lda, ldb, batch_a,
                               batch_b, s);
  else
    launch<T, TT, false, false>(A, B, C, nb, M, N, K, lda, ldb, batch_a,
                                batch_b, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). `dtype` 0 is f32, 1 is bf16.
// A is [nb or 1, M, K] (or [.., K, M] when `ta`) with row stride `lda` and
// batch stride `batch_a` (0 broadcasts it); likewise B; C is contiguous
// [nb, M, N]. Returns cudaGetLastError() after the launch; 1000 for an
// unknown dtype, 1001 for a batch past the grid's limit.
extern "C" int gemm_launch(int dtype, int ta, int tb, int nb, int M, int N,
                           int K, const void* A, long long lda,
                           long long batch_a, const void* B, long long ldb,
                           long long batch_b, void* C, void* stream) {
  if (nb <= 0 || M <= 0 || N <= 0) return 0;
  if (nb > 65535 || (M + 63) / 64 > 65535) return 1001;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128 x 128 tiles once there is one for each of the card's 132 SMs
  const long long big =
      (long long)((M + 127) / 128) * ((N + 127) / 128) * nb;
  const bool wide = big >= 132;
#define WG_GEMM(T)                                                            \
  if (wide)                                                                   \
    launch_tr<T, 8>(ta, tb, A, B, C, nb, M, N, K, lda, ldb, batch_a, batch_b, \
                    s);                                                       \
  else                                                                        \
    launch_tr<T, 4>(ta, tb, A, B, C, nb, M, N, K, lda, ldb, batch_a, batch_b, s)
  if (dtype == 0) {
    WG_GEMM(float);
  } else if (dtype == 1) {
    WG_GEMM(__nv_bfloat16);
  } else {
    return 1000;
  }
#undef WG_GEMM
  return static_cast<int>(cudaGetLastError());
}
