// Full reduction of a contiguous f32 vector to one scalar, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel wgmath_tpu/ops/reduce.py _reduce_pallas (reached
// through reduce). Computes the same five reductions: sum, prod, min, max
// and sqnorm (the sum of x * x), from the identities 0, 1, +inf, -inf, 0,
// accumulated in f32 and written in the input type.
//
// Bound on this card: bytes. Each element is read once (4 n bytes at
// 3.35 TB/s: 5 us for 4,194,304 elements) against one or two operations an
// element. A launch's fixed cost is of the same size (an empty kernel on
// this grid takes 4.9 us between two CUDA events on the H100), so a call
// is one launch.
//
// Design. The Pallas kernel carries one accumulator across a sequential
// grid of 1,024-element blocks; here one launch of a persistent grid does
// the whole call.
//   - x is cut into groups of 4 elements (the last one may be short). The
//     grid, at most BLOCKS_PER_SM blocks an SM (fewer where the occupancy
//     allows fewer) and at most one block a 8,192 elements (the wrapper's
//     reduce.grid), gives each block one contiguous, even share of the
//     groups.
//   - A thread takes the groups t, t + THREADS, t + 2 THREADS, ... of its
//     block's share, UNROLL at a time: all UNROLL loads are issued into
//     independent registers before the first is folded (float4 loads where
//     x starts on a 16-byte boundary, four scalar loads a group otherwise
//     and for the short last group; groups past the share hold the
//     identity). It folds them in group order, x, y, z, w each.
//   - The block folds its threads' values by warp shuffles and then
//     through shared memory. One block writes the scalar at once. Otherwise
//     each block writes one f32 partial and draws a ticket with one atomic
//     add of acquire-release order (no separate fence); in the block that
//     draws the last ticket, warp 0 folds the partials by index (lane l
//     takes partials l, l + 32, ..., then warp shuffles), writes the scalar
//     and puts the ticket back to 0 for the next launch.
// Which elements a thread folds, and in what order, depends only on n and
// the grid, not on the alignment and not on which block finishes last: two
// runs on the same input give the same bits, and no float atomic is used.
// ops/reduce.py reduce_plan / _reduce_emulated write the same order out.
//
// min and max return NaN when any element is NaN, as torch.amin / amax and
// jnp.min / max do (fminf / fmaxf would drop it).
//
// Built with --fmad=false like every source (core/cuda_build.py), so
// sqnorm rounds each square before it is added, as the plain version does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ops/reduce.py keeps THREADS and UNROLL for its plan
constexpr int THREADS = 512;
constexpr int UNROLL = 4;
constexpr int BLOCKS_PER_SM = 2;
constexpr int WARPS = THREADS / 32;
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

template <int OP>
__device__ __forceinline__ float fold4(float acc, float4 v) {
  acc = combine<OP>(acc, premap<OP>(v.x));
  acc = combine<OP>(acc, premap<OP>(v.y));
  acc = combine<OP>(acc, premap<OP>(v.z));
  return combine<OP>(acc, premap<OP>(v.w));
}

// Group g: elements 4g .. 4g + 3 of x, those at n or past it the identity.
template <int OP, bool ALIGNED>
__device__ __forceinline__ float4 load_group(const float* __restrict__ x,
                                             long long n, long long g) {
  const long long e = 4 * g;
  if (ALIGNED && e + 4 <= n)
    return __ldg(reinterpret_cast<const float4*>(x) + g);
  const float id = identity<OP>();
  return make_float4(__ldg(x + e), e + 1 < n ? __ldg(x + e + 1) : id,
                     e + 2 < n ? __ldg(x + e + 2) : id,
                     e + 3 < n ? __ldg(x + e + 3) : id);
}

// Fold one value per lane over the warp; lane 0 returns the result.
template <int OP>
__device__ __forceinline__ float warp_fold(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = combine<OP>(v, __shfl_down_sync(0xffffffffu, v, d));
  return v;
}

// Fold one value per thread over the block; thread 0 returns the result.
template <int OP>
__device__ __forceinline__ float block_fold(float v) {
  __shared__ float warp_part[WARPS];
  v = warp_fold<OP>(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? warp_part[lane] : identity<OP>();
#pragma unroll
    for (int d = WARPS / 2; d > 0; d >>= 1)
      v = combine<OP>(v, __shfl_down_sync(0xffffffffu, v, d));
  }
  return v;
}

// `partial`: one f32 a block; `ticket`: 0 between launches.
template <int OP, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    reduce_kernel(const float* __restrict__ x, long long n,
                  float* __restrict__ partial, unsigned* ticket,
                  float* __restrict__ out) {
  const long long groups = (n + 3) / 4;
  const long long lo = groups * blockIdx.x / gridDim.x;
  const long long hi = groups * (blockIdx.x + 1) / gridDim.x;
  float acc = identity<OP>();
  for (long long base = lo + threadIdx.x; base < hi;
       base += (long long)UNROLL * THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long g = base + (long long)k * THREADS;
      const float id = identity<OP>();
      v[k] = g < hi ? load_group<OP, ALIGNED>(x, n, g)
                    : make_float4(id, id, id, id);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) acc = fold4<OP>(acc, v[k]);
  }
  acc = block_fold<OP>(acc);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) out[0] = acc;
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = acc;
    // release: this partial is visible before the ticket moves; acquire:
    // the block that draws the last ticket sees every partial
    unsigned t;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(t)
                 : "l"(ticket)
                 : "memory");
    last = t == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // warp 0 folds the partials: lane l takes l, l + 32, ..., then shuffles
  acc = identity<OP>();
  for (int i = threadIdx.x; i < (int)gridDim.x; i += 32)
    acc = combine<OP>(acc, __ldcg(partial + i));
  acc = warp_fold<OP>(acc);
  if (threadIdx.x == 0) {
    out[0] = acc;
    *ticket = 0u;
  }
}

template <int OP, bool ALIGNED>
int occupancy() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reduce_kernel<OP, ALIGNED>, THREADS, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <int OP>
void launch(bool aligned, const float* x, long long n, int blocks,
            float* partial, unsigned* ticket, float* out, cudaStream_t s) {
  if (aligned)
    reduce_kernel<OP, true><<<blocks, THREADS, 0, s>>>(x, n, partial, ticket,
                                                       out);
  else
    reduce_kernel<OP, false><<<blocks, THREADS, 0, s>>>(x, n, partial,
                                                        ticket, out);
}

__global__ void __launch_bounds__(THREADS) empty_kernel() {}

}  // namespace

// The most blocks a launch on the current device takes: its SM count times
// BLOCKS_PER_SM, or times the fewest blocks an SM holds of any instantiation
// if that is fewer. The wrapper sizes its partials with it. A CUDA error
// comes back negated.
extern "C" int reduce_max_blocks() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int occ[10] = {
      occupancy<SUM, true>(),    occupancy<SUM, false>(),
      occupancy<PROD, true>(),   occupancy<PROD, false>(),
      occupancy<MIN, true>(),    occupancy<MIN, false>(),
      occupancy<MAX, true>(),    occupancy<MAX, false>(),
      occupancy<SQNORM, true>(), occupancy<SQNORM, false>()};
  int per_sm = BLOCKS_PER_SM;
  for (int o : occ) {
    if (o < 0) return o;
    per_sm = o < per_sm ? o : per_sm;
  }
  return sms * (per_sm < 1 ? 1 : per_sm);
}

// Plain C entry point (bound with ctypes). `op`: 0 sum, 1 prod, 2 min,
// 3 max, 4 sqnorm. x is contiguous f32 [n], n >= 1; `blocks` the grid, at
// least 1 and at most reduce_max_blocks(); `partial` f32 scratch of
// `blocks` elements; `ticket` one u32 that is 0 (the launch leaves it 0);
// `out` one f32. Returns cudaGetLastError() after the launch; 1000 for an
// unknown op, 1001 for n < 1, 1002 for blocks < 1.
extern "C" int reduce_launch(long long op, const float* x, long long n,
                             long long blocks, float* partial,
                             unsigned* ticket, float* out, void* stream) {
  if (n < 1) return 1001;
  if (blocks < 1) return 1002;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 loads need a 16-byte aligned base
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int b = static_cast<int>(blocks);
  switch (op) {
    case SUM: launch<SUM>(aligned, x, n, b, partial, ticket, out, s); break;
    case PROD: launch<PROD>(aligned, x, n, b, partial, ticket, out, s); break;
    case MIN: launch<MIN>(aligned, x, n, b, partial, ticket, out, s); break;
    case MAX: launch<MAX>(aligned, x, n, b, partial, ticket, out, s); break;
    case SQNORM:
      launch<SQNORM>(aligned, x, n, b, partial, ticket, out, s);
      break;
    default: return 1000;
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the same grid and block size: the fixed cost of one
// launch, which chip_smoke.py times beside the reduction.
extern "C" int reduce_empty_launch(long long blocks, void* stream) {
  empty_kernel<<<static_cast<int>(blocks), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
