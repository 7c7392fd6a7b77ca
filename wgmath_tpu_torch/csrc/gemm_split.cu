// f32 matrix product from operands split once into bf16 planes, CUDA C++ for
// sm_90a on the tensor cores.
//
// Replaces the TPU kernel of wgmath_tpu/ops/gemm.py gemm_split. The caller
// splits each f32 operand once, outside the kernel, into three bf16 planes
// hi + mid + lo by mantissa bitmask (ops/gemm.py _split3 of this package)
// and zero-pads them to the tile multiples below. The kernel reads the
// 2 x 3 planes (or 2 x 2 for three passes) and sums the cross terms in f32.
// A product of two bf16 values is exact in f32, so only the additions
// round. The summation is error-ordered as in the Pallas kernel: one
// accumulator per order of magnitude,
//   low   lo.hi + mid.mid + hi.lo     (six passes only)
//   mid   mid.hi + hi.mid
//   high  hi.hi
// each carried over the whole of K, added low to high at the end.
//
// Design. bf16 wgmma (bf16 x bf16 -> f32) straight from the planes: no
// plane is widened. A block owns a 128 x 64 output tile: two consumer
// warpgroups of 64 x 64 and one producer warp. The producer keeps a ring of
// three stages (four for three passes) filled by TMA, each stage holding
// every plane's 128 x 64 slice of A (K-major) and 64 x 64 slice of B. B is
// [K, N] with N contiguous and is read MN-major through the descriptor's
// transpose bit, so nothing is transposed in memory. Full and empty
// mbarriers hand the stages between producer and consumers.
//
// Accumulation. The tensor core adds each k step's products into its
// accumulator with its own rounding, which need not be round-to-nearest.
// low and mid are 2^-8 and 2^-16 of the result, so their rounding is below
// f32 resolution; high is not: per 64-deep k tile it is computed from zero
// on the tensor core and then added to a register sum with an f32 add
// (round to nearest). The k tile's high product is committed as its own
// wgmma group ahead of low and mid, so the add overlaps their products.
//
// Bound on this card: operations. Six (three) passes of 2 M N K flops on
// the bf16 tensor cores (989 TFLOP/s) against 6 (4) bf16 planes read and
// one f32 matrix written.

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BN = 64, BK = 64;
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 32;
constexpr int A_TILE = BM * BK * 2;  // bytes of one plane's A slice
constexpr int B_TILE = BK * BN * 2;  // bytes of one plane's B slice

template <int NS>
constexpr int STAGES = NS == 3 ? 3 : 4;
template <int NS>
constexpr int STAGE_BYTES = NS * (A_TILE + B_TILE);
template <int NS>
constexpr int SMEM_BYTES = STAGES<NS> * STAGE_BYTES<NS> + 1024 +
                           2 * STAGES<NS> * 8;

template <int NS>  // planes per operand: 3 (six passes) or 2 (three passes)
__global__ void __launch_bounds__(THREADS, 1)
    gemm_split_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      float* __restrict__ C, int Mp, int Np, int Kp) {
  constexpr int S = STAGES<NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * STAGE_BYTES<NS>);
  uint64_t* empty = full + S;

  int tm, tn;
  grouped_tile(blockIdx.x, Mp / BM, Np / BN, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN, k_tiles = Kp / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    if (threadIdx.x == CONSUMERS) {
      for (int t = 0; t < k_tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(&empty[s], (t / S - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES<NS>);
        uint8_t* st = smem + s * STAGE_BYTES<NS>;
#pragma unroll
        for (int p = 0; p < NS; ++p) {
          tma_load_2d(st + p * A_TILE, &map_a, &full[s], t * BK, p * Mp + m0);
          tma_load_2d(st + NS * A_TILE + p * B_TILE, &map_b, &full[s], n0,
                      p * Kp + t * BK);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  float low[32], mid[32], high[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) low[i] = mid[i] = high[i] = part[i] = 0.0f;

  for (int t = 0; t < k_tiles; ++t) {
    const int s = t % S;
    mbar_wait(&full[s], (t / S) & 1);
    const uint32_t a0 = smem_u32(smem + s * STAGE_BYTES<NS>) + wg * 64 * 128;
    const uint32_t b0 = smem_u32(smem + s * STAGE_BYTES<NS> + NS * A_TILE);
    // plane p of A and of B, at k step kk (16 deep); an instruction reads
    // one 64-wide block of N, so B's leading offset is never used and is
    // given the stride offset's value
    auto da = [&](int p, int kk) { return desc_k(a0 + p * A_TILE + kk * 32); };
    auto db = [&](int p, int kk) {
      return desc_mn(b0 + p * B_TILE + kk * 2048, 1024);
    };
    wgmma_fence();
    pin(part);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_bf16_n64_bt(part, da(0, kk), db(0, kk), kk > 0);
    wgmma_commit();
    pin(low);
    pin(mid);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (NS == 3) {
        mma_bf16_n64_bt(low, da(NS - 1, kk), db(0, kk), 1);
        mma_bf16_n64_bt(low, da(1, kk), db(1, kk), 1);
        mma_bf16_n64_bt(low, da(0, kk), db(NS - 1, kk), 1);
      }
      mma_bf16_n64_bt(mid, da(1, kk), db(0, kk), 1);
      mma_bf16_n64_bt(mid, da(0, kk), db(1, kk), 1);
    }
    wgmma_commit();
    // retires this tile's high product and the previous tile's low and mid
    wgmma_wait<1>();
    pin(part);
    if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(t - 1) % S]);
#pragma unroll
    for (int i = 0; i < 32; ++i) high[i] += part[i];
  }
  wgmma_wait<0>();
  pin(low);
  pin(mid);

  const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
  float* c = C + (long long)(m0 + wg * 64 + 16 * w + l / 4) * Np + n0 +
             2 * (l % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      float2 v;
      v.x = (low[i] + mid[i]) + high[i];
      v.y = (low[i + 1] + mid[i + 1]) + high[i + 1];
      *reinterpret_cast<float2*>(c + (long long)8 * h * Np + 8 * j) = v;
    }
}

// a bf16 matrix [rows, cols], row-major, read in boxes of box_rows x 64
// (128 bytes) with the 128-byte swizzle
bool bf16_map(CUtensorMap* map, const void* base, long long rows,
              long long cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                  strides, box);
}

template <int NS>
int launch(int Mp, int Np, int Kp, const void* A, const void* B, void* C,
           cudaStream_t s) {
  CUtensorMap ma, mb;
  if (!bf16_map(&ma, A, (long long)NS * Mp, Kp, BM) ||
      !bf16_map(&mb, B, (long long)NS * Kp, Np, BK))
    return 1003;
  static const cudaError_t e = cudaFuncSetAttribute(
      gemm_split_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES<NS>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (Mp / BM) * (Np / BN);
  gemm_split_kernel<NS><<<blocks, THREADS, SMEM_BYTES<NS>, s>>>(
      ma, mb, static_cast<float*>(C), Mp, Np, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). A holds `n_split` contiguous
// bf16 planes [n_split, Mp, Kp], B [n_split, Kp, Np], hi first, zero-padded
// so that Mp is a multiple of 128, Np of 64 and Kp of 64; C is contiguous
// f32 [Mp, Np]. `n_split` 3 runs six passes, 2 three. Returns
// cudaGetLastError() after the launch; 1000 for another `n_split`, 1002 for
// a shape off the tile multiples, 1003 if a TMA descriptor cannot be made.
extern "C" int gemm_split_launch(int n_split, int Mp, int Np, int Kp,
                                 const void* A, const void* B, void* C,
                                 void* stream) {
  if (Mp <= 0 || Np <= 0 || Kp <= 0 || Mp % BM || Np % BN || Kp % BK)
    return 1002;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split == 3) return launch<3>(Mp, Np, Kp, A, B, C, s);
  if (n_split == 2) return launch<2>(Mp, Np, Kp, A, B, C, s);
  return 1000;
}
