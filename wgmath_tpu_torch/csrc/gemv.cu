// Batched matrix-vector products y = A x and y = A^T x, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels wgmath_tpu/ops/gemv.py _gemv_pallas (y = A x,
// reached through gemv) and _gemv_tr_pallas (y = A^T x, reached through
// gemv(..., transpose_a=True)). Both compute what those kernels compute:
// f32 products summed in f32 over K.
//
// Bound on this card: bytes. Each element of A is read once and used in one
// multiply-add (a quarter of an operation per byte against the twenty where
// the f32 pipes and the memory balance), so both kernels stream A at the
// memory rate: (M K + K + M) 4 bytes at 3.35 TB/s, 20.0 us at M = K = 4096.
// A 4096^2 matrix (67 MB) is larger than the 50 MB L2, so a chain
// v <- A v reads A from device memory every time.
//
// gemv_rows (A x, A [M, K] with k contiguous). The Pallas kernel streams
// row blocks of A through VMEM with x resident and reduces along the lanes.
// Here one warp owns one output row: its lanes stride along K with
// coalesced float4 loads (scalar loads where the row pointer or K does not
// allow them, and for the tail), each lane keeps one sum with explicit
// fmaf, and the 32 sums are folded by warp shuffles in a fixed order. x is
// read by every warp of the grid and stays in L1/L2.
//
// gemv_tr_cols (A^T x, A [K, M] with m contiguous). The Pallas kernel walks
// K blocks as a sequential grid and carries the output row in VMEM from one
// step to the next; blocks of a CUDA grid run in no order and share
// nothing. Here a thread owns one output column, so a warp reads 128
// contiguous bytes of a row of A. At M = 4096 that is 16 blocks for 132
// SMs, so K is cut into S chunks, one per block row of the grid: each block
// writes its partial sums [S, M], and gemv_tr_sum adds the S partials of a
// column in chunk order (S = 1 writes y directly).
//
// No atomics anywhere: which terms a thread adds, and in what order,
// depends only on the shapes, so two launches on the same inputs give the
// same bits. The batch is the grid's last dimension, with batch strides (0
// for an operand shared by the whole batch); ragged M and K are masked, so
// any M, K >= 1 is taken.
//
// core/cuda_build.py builds every source with --fmad=false, which only stops
// the compiler from contracting a * b + c; the explicit fmaf() below is one
// FFMA per term.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;  // B5: one warp per output row
constexpr int MAX_GRID_YZ = 65535;
// B6: enough blocks for a few per SM of the card's 132, and chunks of at
// least MIN_CHUNK rows of A
constexpr int TARGET_BLOCKS = 4 * 132;
constexpr int MIN_CHUNK = 32;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    gemv_rows(const float* __restrict__ A, const float* __restrict__ x,
              float* __restrict__ y, int nb, int M, int K, long long lda,
              long long batch_a, long long batch_x) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= M) return;  // uniform over the warp
  for (long long b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* a = A + b * batch_a + (long long)row * lda;
    const float* xv = x + b * batch_x;
    float acc = 0.0f;
    int k0 = 0;
    if (VEC) {
      const int k4 = K / 4;
      const float4* a4 = reinterpret_cast<const float4*>(a);
      const float4* x4 = reinterpret_cast<const float4*>(xv);
#pragma unroll 4
      for (int i = lane; i < k4; i += 32) {
        const float4 av = a4[i];
        const float4 xq = x4[i];
        acc = fmaf(av.x, xq.x, acc);
        acc = fmaf(av.y, xq.y, acc);
        acc = fmaf(av.z, xq.z, acc);
        acc = fmaf(av.w, xq.w, acc);
      }
      k0 = 4 * k4;
    }
    for (int k = k0 + lane; k < K; k += 32) acc = fmaf(a[k], xv[k], acc);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, d);
    if (lane == 0) y[b * M + row] = acc;
  }
}

// out is [nb, gridDim.y, M]: the partial sum of chunk blockIdx.y
__global__ void __launch_bounds__(THREADS)
    gemv_tr_cols(const float* __restrict__ A, const float* __restrict__ x,
                 float* __restrict__ out, int nb, int M, int K, int chunk,
                 long long lda, long long batch_a, long long batch_x) {
  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= M) return;
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(K, k0 + chunk);
  for (long long b = blockIdx.z; b < nb; b += gridDim.z) {
    const float* a = A + b * batch_a + (long long)k0 * lda + m;
    const float* xv = x + b * batch_x;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k, a += lda) acc = fmaf(*a, xv[k], acc);
    out[(b * gridDim.y + blockIdx.y) * M + m] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
    gemv_tr_sum(const float* __restrict__ partial, float* __restrict__ y,
                long long total, int M, int S) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long b = i / M;
  const float* p = partial + b * S * M + (i - b * M);
  float acc = p[0];
  for (int s = 1; s < S; ++s) acc += p[(long long)s * M];
  y[i] = acc;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int chunk_rows(int M, int K, int nb) {
  const long long cols = (long long)((M + THREADS - 1) / THREADS) *
                         (nb < MAX_GRID_YZ ? nb : MAX_GRID_YZ);
  long long s = (TARGET_BLOCKS + cols - 1) / cols;
  const long long most = (K + MIN_CHUNK - 1) / MIN_CHUNK;
  if (s > most) s = most;
  if (s < 1) s = 1;
  return (int)((K + s - 1) / s);
}

}  // namespace

// Number of K chunks (partials per output) gemv_tr_launch uses for these
// shapes; the wrapper sizes its scratch [nb, S, M] with it when S > 1.
extern "C" int gemv_tr_splits(int M, int K, int nb) {
  const int chunk = chunk_rows(M, K, nb);
  return (K + chunk - 1) / chunk;
}

// Plain C entry points (bound with ctypes). A is [nb or 1, M, K] for
// gemv_launch, [nb or 1, K, M] for gemv_tr_launch, with unit inner stride,
// row stride `lda` and batch stride `batch_a` (0 shares one matrix over the
// batch); x is [nb or 1, K] with batch stride `batch_x`; y is contiguous
// [nb, M]; `partial` is f32 scratch of nb * gemv_tr_splits(M, K, nb) * M
// elements (unused when that is 1). Each returns cudaGetLastError() after
// its launches; 1001 for an empty shape.
extern "C" int gemv_launch(int nb, int M, int K, const float* A,
                           long long lda, long long batch_a, const float* x,
                           long long batch_x, float* y, void* stream) {
  if (nb < 1 || M < 1 || K < 1) return 1001;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + ROWS - 1) / ROWS,
                  nb < MAX_GRID_YZ ? nb : MAX_GRID_YZ);
  const bool vec = aligned16(A) && aligned16(x) && lda % 4 == 0 &&
                   batch_a % 4 == 0 && batch_x % 4 == 0;
  if (vec)
    gemv_rows<true><<<grid, THREADS, 0, s>>>(A, x, y, nb, M, K, lda, batch_a,
                                             batch_x);
  else
    gemv_rows<false><<<grid, THREADS, 0, s>>>(A, x, y, nb, M, K, lda, batch_a,
                                              batch_x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gemv_tr_launch(int nb, int M, int K, const float* A,
                              long long lda, long long batch_a,
                              const float* x, long long batch_x, float* y,
                              float* partial, void* stream) {
  if (nb < 1 || M < 1 || K < 1) return 1001;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunk = chunk_rows(M, K, nb);
  const int S = (K + chunk - 1) / chunk;
  const dim3 grid((M + THREADS - 1) / THREADS, S,
                  nb < MAX_GRID_YZ ? nb : MAX_GRID_YZ);
  gemv_tr_cols<<<grid, THREADS, 0, s>>>(A, x, S == 1 ? y : partial, nb, M, K,
                                        chunk, lda, batch_a, batch_x);
  if (S > 1) {
    const long long total = (long long)nb * M;
    gemv_tr_sum<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                  s>>>(partial, y, total, M, S);
  }
  return static_cast<int>(cudaGetLastError());
}
