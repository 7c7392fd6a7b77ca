// Full reduction of a contiguous f32 vector to one scalar, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel wgmath_tpu/ops/reduce.py _reduce_pallas (reached
// through reduce). Computes the same five reductions: sum, prod, min, max
// and sqnorm (the sum of x * x), from the identities 0, 1, +inf, -inf, 0,
// accumulated in f32 and written in the input type.
//
// Design. The Pallas kernel carries one accumulator across a sequential
// grid of 1,024-element blocks. Blocks of a CUDA grid run in no order and
// share nothing, so the reduction has two stages: `reduce_partials` gives
// each block a grid-strided share of x (float4 loads over the 16-byte
// aligned body, scalar loads over the tail; lanes past the end hold the
// identity), folds it by warp shuffles and then through shared memory, and
// writes one f32 partial; `reduce_final`, one block, folds the partials the
// same way and writes the scalar. No atomics: which elements a thread
// folds, and in what order, depends only on the length and the grid, so two
// runs on the same input give the same bits.
//
// min and max return NaN when any element is NaN, as torch.amin / amax and
// jnp.min / max do (fminf / fmaxf would drop it).
//
// Bound on this card: bytes. Each element is read once (4 n bytes at
// 3.35 TB/s: 5 us for 4,194,304 elements) against one or two operations an
// element. Two launches of a few microseconds each are of the same size as
// that bound.
//
// Built with --fmad=false like every source (core/cuda_build.py), so
// sqnorm rounds each square before it is added, as the plain version does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;
enum Op { SUM = 0, PROD = 1, MIN = 2, MAX = 3, SQNORM = 4 };

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == PROD) return 1.0f;
  if (OP == MIN) return __int_as_float(0x7f800000);
  if (OP == MAX) return __int_as_float(0xff800000);
  return 0.0f;
}

template <int OP>
__device__ __forceinline__ float premap(float v) {
  return OP == SQNORM ? v * v : v;
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == PROD) return a * b;
  if (OP == MIN) return (a < b || a != a) ? a : b;
  if (OP == MAX) return (a > b || a != a) ? a : b;
  return a + b;
}

// Fold one value per thread over the block; thread 0 returns the result.
template <int OP>
__device__ __forceinline__ float block_fold(float v) {
  __shared__ float warp_part[THREADS / 32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = combine<OP>(v, __shfl_down_sync(0xffffffffu, v, d));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_part[lane] : identity<OP>();
#pragma unroll
    for (int d = THREADS / 64; d > 0; d >>= 1)
      v = combine<OP>(v, __shfl_down_sync(0xffffffffu, v, d));
  }
  return v;
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
    reduce_partials(const float* __restrict__ x, long long n, long long n4,
                    float* __restrict__ partial) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long step = (long long)gridDim.x * THREADS;
  float acc = identity<OP>();
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (long long i = t; i < n4; i += step) {
    const float4 v = x4[i];
    acc = combine<OP>(acc, premap<OP>(v.x));
    acc = combine<OP>(acc, premap<OP>(v.y));
    acc = combine<OP>(acc, premap<OP>(v.z));
    acc = combine<OP>(acc, premap<OP>(v.w));
  }
  for (long long i = 4 * n4 + t; i < n; i += step)
    acc = combine<OP>(acc, premap<OP>(x[i]));
  acc = block_fold<OP>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
    reduce_final(const float* __restrict__ partial, int count,
                 float* __restrict__ out) {
  float acc = identity<OP>();
  for (int i = threadIdx.x; i < count; i += THREADS)
    acc = combine<OP>(acc, partial[i]);
  acc = block_fold<OP>(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

template <int OP>
void launch(const float* x, long long n, long long n4, int blocks,
            float* partial, float* out, cudaStream_t s) {
  reduce_partials<OP><<<blocks, THREADS, 0, s>>>(x, n, n4, partial);
  reduce_final<OP><<<1, THREADS, 0, s>>>(partial, blocks, out);
}

}  // namespace

// Number of partials (blocks of the first stage) for a vector of n elements;
// the wrapper sizes its scratch with it.
extern "C" int reduce_blocks(long long n) {
  const long long want = (n + 16 * THREADS - 1) / (16 * THREADS);
  return want < 1 ? 1 : (want > MAX_BLOCKS ? MAX_BLOCKS : (int)want);
}

// Plain C entry point (bound with ctypes). `op`: 0 sum, 1 prod, 2 min,
// 3 max, 4 sqnorm. x is contiguous f32 [n], n >= 1; `partial` is f32 scratch
// of reduce_blocks(n) elements; `out` one f32. Returns cudaGetLastError()
// after the two launches; 1000 for an unknown op, 1001 for n < 1.
extern "C" int reduce_launch(int op, const float* x, long long n,
                             float* partial, float* out, void* stream) {
  if (n < 1) return 1001;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = reduce_blocks(n);
  // float4 loads need a 16-byte aligned base
  const long long n4 =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 ? n / 4 : 0;
  switch (op) {
    case SUM: launch<SUM>(x, n, n4, blocks, partial, out, s); break;
    case PROD: launch<PROD>(x, n, n4, blocks, partial, out, s); break;
    case MIN: launch<MIN>(x, n, n4, blocks, partial, out, s); break;
    case MAX: launch<MAX>(x, n, n4, blocks, partial, out, s); break;
    case SQNORM: launch<SQNORM>(x, n, n4, blocks, partial, out, s); break;
    default: return 1000;
  }
  return static_cast<int>(cudaGetLastError());
}
