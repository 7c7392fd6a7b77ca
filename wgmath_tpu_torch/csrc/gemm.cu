// Batched matrix product C = op(A) op(B), CUDA C++ for sm_90a on the tensor
// cores.
//
// Replaces the TPU kernel wgmath_tpu/ops/gemm.py _gemm_pallas (reached
// through gemm). Computes what that kernel computes: for every batch matrix,
// op(A) [M, K] times op(B) [K, N] with f32 accumulation, inputs f32 or bf16,
// output in the input type and rounded once at the end. Either operand may
// be stored transposed; a single-matrix operand is broadcast over the batch
// by a batch stride of 0; any M, N, K >= 1 and any row stride.
//
// Arithmetic. bf16 inputs: one bf16 wgmma pass, f32 accumulation, as the TPU
// kernel runs on its matrix unit. f32 inputs: 3 x TF32. Each element x is
// split once, as it is staged, into big = tf32(x) and small = tf32(x - big)
// (round to nearest, ties away; x - big is exact in f32), and three TF32
// products are summed in f32: small.big + big.small into one accumulator,
// big.big into another, added at the end. That drops small.small (2^-22 of
// the product) and small's own rounding: an f32-class result, well inside
// the reference's 1e-3 golden tolerance. ops/gemm.py _gemm_3xtf32_torch is
// the same arithmetic in plain PyTorch.
//
// Design. The Pallas kernel walks K as the last, sequential dimension of its
// grid; here one block owns one output tile of one batch matrix and loops
// over K itself. A block is one or two warpgroups, each with a 64 x 128
// tile (64 x 128 blocks while the product has fewer 128 x 128 tiles than
// the card has SMs, so that a small product still fills it). TF32 wgmma
// takes only K-major operands, so the block stages every tile itself, and
// every warp takes a share (one warpgroup of producers alone cannot split
// and transpose as fast as two warpgroups of wgmma consume). The tiles are
// copied two ahead into a ring of three raw stages: by TMA, issued by one
// thread, where the operand's rows are 16-byte aligned (the main paths),
// else by every thread with cp.async along the stored rows, so that the
// copies fly without holding registers. While tile t's wgmma runs, the
// block reads tile t + 1 back,
// transposing a transposed A or a plain B ([K, N]) in 4 x 4 blocks, splits
// it, and writes the 128-byte-swizzled K-major planes that the descriptors
// name (wgmma.cuh), two plane stages deep, 16 bytes a store and without
// bank conflicts. Copies past the ragged edge write 0, so the block masks
// only its stores.
//
// Bound on this card: operations. 2 M N K flops on the tensor cores, three
// times over at 495 TFLOP/s (TF32) for f32, once at 989 TFLOP/s for bf16,
// against (M K + K N + M N) elements moved.

#include <string.h>

#include <algorithm>
#include <type_traits>

#include "wgmma.cuh"

extern "C" int gemm_last_fetch[2];

namespace {

using namespace hopper;

constexpr int BN = 128;

// global -> shared copies that bypass registers; `bytes` past `valid` are
// written as 0 (and nothing is read when `valid` is 0)
__device__ __forceinline__ void cp_async16(uint8_t* dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint8_t* dst, const void* src,
                                          int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The f32 split of one word into its TF32 planes (bf16 words pass as they
// are, into the one plane).
template <typename T>
__device__ __forceinline__ void split(uint32_t w, uint32_t& big,
                                      uint32_t& small) {
  if constexpr (std::is_same<T, float>::value) {
    const float x = __uint_as_float(w);
    const float b = to_tf32(x);
    big = __float_as_uint(b);
    small = __float_as_uint(to_tf32(x - b));
  } else {
    big = w;
    small = 0;
  }
}

// Stages one [RO x BK] tile of a logical [O, K] operand (RO rows of 128
// bytes: BK = 32 f32 or 64 bf16) for the THREADS threads of the block, in
// two steps. First the tile is copied from global memory into a raw stage:
// by one TMA load where the operand's alignment allows (tma()), else by
// every thread with cp.async, 16 bytes a copy along the stored rows where
// the stride allows (fetch()). After a barrier, load() reads the raw tile
// back in the order the planes want and store() splits and writes the
// swizzled K-major plane tiles, 16 bytes a store.
// `KCONTIG`: element (o, k) at src[o * ld + k] (a plain A, a transposed B).
// The raw tile is then already the K-major swizzled layout: 16-byte chunk
// c of row o at swizzle128(o, c) (a TMA box of BK x RO), and a thread
// moves whole chunks. Else element (o, k) at src[k * ld + o] (a transposed
// A, a plain B), and a thread transposes a block of 4 o by one k chunk (4
// words of k). f32: the raw tile is RO / 32 sub-tiles of 32 o (TMA boxes of
// 32 x BK), each row k of 128 bytes with its chunks swizzled by k % 8, and
// the blocks are dealt to the lanes (block()) so that a quarter warp's raw
// reads and plane stores each hit 8 distinct chunk positions. bf16 (no
// TMA): for each group g of 8 consecutive o and each k, a 16-byte unit at
// swizzle128(g * BK * 16 + k * 16).
template <typename T, int RO, int THREADS, bool KCONTIG>
struct Stager {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int WORDS = RO * 32 / THREADS;  // 32-bit words a thread
  static constexpr int E = 16 / sizeof(T);         // elements per chunk
  static constexpr int BK = 128 / sizeof(T);
  uint32_t r[WORDS];

  // not KCONTIG: raw offset of the 16-byte unit of o group g (E
  // consecutive o) at row k
  static __device__ __forceinline__ uint32_t unit(int g, int k) {
    if constexpr (F32)
      return (g / 8) * BK * 128 + swizzle128(k, g % 8);
    else
      return swizzle128(static_cast<uint32_t>(g * BK * 16 + k * 16));
  }

  // not KCONTIG: the o group (4 o) and k chunk of block b, a bijection of
  // b's bits: og = (b0, b1, b5, b6, ..), kc = (b2, b1 ^ b3, b4); within a
  // quarter warp (b0 .. b2) the raw reads' chunk positions og % 8 ^
  // 4 (kc % 2) and the stores' kc ^ 4 (og % 2) are all distinct
  static __device__ __forceinline__ void block(int b, int& og, int& kc) {
    if constexpr (F32) {
      og = (b & 3) | ((b >> 5) << 2);
      kc = ((b >> 2) & 1) | ((((b >> 1) ^ (b >> 3)) & 1) << 1) |
           (((b >> 4) & 1) << 2);
    } else {
      og = b / 8;
      kc = b % 8;
    }
  }

  // one element, synchronously (the edge of a bf16 operand whose rows are
  // not 4-byte aligned)
  static __device__ __forceinline__ void put(uint8_t* dst, const T* src,
                                             long long i, bool in) {
    *reinterpret_cast<unsigned short*>(dst) =
        in ? reinterpret_cast<const unsigned short*>(src)[i] : 0;
  }

  // E contiguous elements from src + i, `valid` of them in range
  static __device__ __forceinline__ void copy(uint8_t* dst, const T* src,
                                              long long i, int valid,
                                              bool vec) {
    if (vec && (valid == E || valid == 0)) {
      cp_async16(dst, valid > 0 ? src + i : src, valid * sizeof(T));
      return;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (F32)
        cp_async4(dst + 4 * e, e < valid ? src + i + e : src,
                  e < valid ? 4 : 0);
      else
        put(dst + 2 * e, src, i + e, e < valid);
    }
  }

  __device__ __forceinline__ void fetch(int tid, uint8_t* raw,
                                        const T* __restrict__ src,
                                        long long ld, int o0, int k0, int O,
                                        int K, bool vec) const {
#pragma unroll
    for (int u = 0; u < WORDS / 4; ++u) {
      const int c = tid + u * THREADS;
      if constexpr (KCONTIG) {
        const int o = o0 + c / 8, k = k0 + (c % 8) * E;
        const int valid = o < O ? max(0, min(E, K - k)) : 0;
        copy(raw + swizzle128(c / 8, c % 8), src, (long long)o * ld + k,
             valid, vec);
      } else {
        const int kr = c / (RO / E), g = c % (RO / E);
        const int k = k0 + kr, o = o0 + g * E;
        const int valid = k < K ? max(0, min(E, O - o)) : 0;
        copy(raw + unit(g, kr), src, (long long)k * ld + o, valid, vec);
      }
    }
  }

  // the whole tile by one thread: the map's box is the tile (see the host)
  __device__ __forceinline__ void tma(uint8_t* raw, const CUtensorMap* map,
                                      uint64_t* bar, int o0, int k0,
                                      int z) const {
    if constexpr (KCONTIG) {
      tma_load_3d(raw, map, bar, k0, o0, z);
    } else {
#pragma unroll
      for (int q = 0; q < RO / 32; ++q)
        tma_load_3d(raw + q * BK * 128, map, bar, o0 + 32 * q, k0, z);
    }
  }

  __device__ __forceinline__ void load(int tid, const uint8_t* raw) {
    if constexpr (KCONTIG) {
#pragma unroll
      for (int u = 0; u < WORDS / 4; ++u) {
        const int c = tid + u * THREADS;
        const uint4 v =
            *reinterpret_cast<const uint4*>(raw + swizzle128(c / 8, c % 8));
        r[4 * u] = v.x;
        r[4 * u + 1] = v.y;
        r[4 * u + 2] = v.z;
        r[4 * u + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < WORDS / 16; ++u) {
        int og, kc;
        block(tid + u * THREADS, og, kc);
        if constexpr (F32) {  // rows 4 kc + w, o = 4 og .. 4 og + 3
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(raw + unit(og, 4 * kc + w));
            r[16 * u + w] = v.x;
            r[16 * u + 4 + w] = v.y;
            r[16 * u + 8 + w] = v.z;
            r[16 * u + 12 + w] = v.w;
          }
        } else {  // rows 8 kc + 2 w (+ 1): the pair of word w
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            uint2 v[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              v[h] = *reinterpret_cast<const uint2*>(
                  raw + unit(og / 2, 8 * kc + 2 * w + h) + 8 * (og % 2));
            r[16 * u + w] = (v[0].x & 0xFFFFu) | (v[1].x << 16);
            r[16 * u + 4 + w] = (v[0].x >> 16) | (v[1].x & 0xFFFF0000u);
            r[16 * u + 8 + w] = (v[0].y & 0xFFFFu) | (v[1].y << 16);
            r[16 * u + 12 + w] = (v[0].y >> 16) | (v[1].y & 0xFFFF0000u);
          }
        }
      }
    }
  }

  // into the swizzled K-major plane tiles `big` and `small` (f32), or `big`
  __device__ __forceinline__ void store(int tid, uint8_t* big,
                                        uint8_t* small) const {
    // 16-byte chunk `chunk` of plane row `o` from words r[i .. i + 3]
    auto put4 = [&](int o, int chunk, int i) {
      const uint32_t off = swizzle128(o, chunk);
      uint4 b, s;
      split<T>(r[i], b.x, s.x);
      split<T>(r[i + 1], b.y, s.y);
      split<T>(r[i + 2], b.z, s.z);
      split<T>(r[i + 3], b.w, s.w);
      *reinterpret_cast<uint4*>(big + off) = b;
      if constexpr (F32) *reinterpret_cast<uint4*>(small + off) = s;
    };
    if constexpr (KCONTIG) {
#pragma unroll
      for (int u = 0; u < WORDS / 4; ++u) {
        const int c = tid + u * THREADS;
        put4(c / 8, c % 8, 4 * u);
      }
    } else {
#pragma unroll
      for (int u = 0; u < WORDS / 16; ++u) {
        int og, kc;
        block(tid + u * THREADS, og, kc);
#pragma unroll
        for (int i = 0; i < 4; ++i) put4(4 * og + i, kc, 16 * u + 4 * i);
      }
    }
  }
};

// Shared memory: two stages of plane tiles (every plane of A and B), three
// stages of raw tiles, their mbarriers; at most 227 KB.
template <typename T, int WGS>
constexpr int STAGE_BYTES =
    (std::is_same<T, float>::value ? 2 : 1) * (64 * WGS + BN) * 128;
constexpr int RAW_STAGES = 3;
template <int WGS>
constexpr int RAW_BYTES = (64 * WGS + BN) * 128;
template <typename T, int WGS>
constexpr int SMEM_BYTES =
    2 * STAGE_BYTES<T, WGS> + RAW_STAGES * (RAW_BYTES<WGS> + 8) + 1024;

// how an operand's raw tiles are fetched
enum Fetch { PER_ELEMENT = 0, VECTOR = 1, TMA = 2 };
// the best route a launch may take; scripts/exp_gemm_tiles.py builds lower
// caps to time the routes against each other
#ifndef WG_GEMM_MAX_FETCH
#define WG_GEMM_MAX_FETCH TMA
#endif

template <typename T, int WGS, bool TA, bool TB>
__global__ void __launch_bounds__(128 * WGS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ C, int M, int N, int K, long long lda,
                long long ldb, long long batch_a, long long batch_b,
                int fetch_a, int fetch_b, int tiles_m, int tiles_n) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int THREADS = 128 * WGS, BM = 64 * WGS, BK = 128 / sizeof(T);
  constexpr int PLANES = F32 ? 2 : 1;
  constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  constexpr int STAGE = STAGE_BYTES<T, WGS>, RAW = RAW_BYTES<WGS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* raw = smem + 2 * STAGE;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(raw + RAW_STAGES * RAW);

  int tm, tn;
  grouped_tile(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN, k_tiles = (K + BK - 1) / BK;
  const int tid = threadIdx.x;
  // batch coordinates: a broadcast operand (batch stride 0) has one matrix
  const int za = batch_a ? blockIdx.z : 0, zb = batch_b ? blockIdx.z : 0;
  A += za * batch_a;
  B += zb * batch_b;
  const uint32_t tma_bytes =
      (fetch_a == TMA ? A_BYTES : 0) + (fetch_b == TMA ? B_BYTES : 0);
  if (tid == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) mbar_init(&raw_full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // a plain A has k contiguous, a plain B has n contiguous
  Stager<T, BM, THREADS, !TA> sa;
  Stager<T, BN, THREADS, TB> sb;
  // the parameters' own addresses, taken in the kernel's scope: TMA reads
  // a descriptor from parameter, constant or global memory only
  const CUtensorMap* pmap_a = &map_a;
  const CUtensorMap* pmap_b = &map_b;
  // raw tile t (A's, then B's), in flight without registers
  auto fetch = [&](int t) {
    if (t < k_tiles) {
      uint8_t* rs = raw + (t % RAW_STAGES) * RAW;
      if (fetch_a != TMA)
        sa.fetch(tid, rs, A, lda, m0, t * BK, M, K, fetch_a == VECTOR);
      if (fetch_b != TMA)
        sb.fetch(tid, rs + A_BYTES, B, ldb, n0, t * BK, N, K,
                 fetch_b == VECTOR);
      if (tma_bytes && tid == 0) {
        uint64_t* bar = &raw_full[t % RAW_STAGES];
        fence_proxy_async();  // the stage's last readers went before
        mbar_expect_tx(bar, tma_bytes);
        if (fetch_a == TMA) sa.tma(rs, pmap_a, bar, m0, t * BK, za);
        if (fetch_b == TMA) sb.tma(rs + A_BYTES, pmap_b, bar, n0, t * BK, zb);
      }
    }
    cp_async_commit();
  };
  // tile t has landed (the block's barrier that follows makes every
  // thread's copies visible to all)
  auto landed = [&](int t) {
    cp_async_wait<RAW_STAGES - 2>();
    if (tma_bytes) mbar_wait(&raw_full[t % RAW_STAGES], (t / RAW_STAGES) & 1);
  };
  auto load = [&](int t) {
    uint8_t* rs = raw + (t % RAW_STAGES) * RAW;
    sa.load(tid, rs);
    sb.load(tid, rs + A_BYTES);
  };
  // plane stage s: A's planes (big, small), then B's
  auto store = [&](int s) {
    uint8_t* st = smem + s * STAGE;
    sa.store(tid, st, st + A_BYTES);
    sb.store(tid, st + PLANES * A_BYTES, st + PLANES * A_BYTES + B_BYTES);
    fence_proxy_async();
  };

  const int wg = threadIdx.x / 128;
  float big[64], small[F32 ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) big[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (F32 ? 64 : 1); ++i) small[i] = 0.0f;

  for (int t = 0; t < RAW_STAGES - 1; ++t) fetch(t);
  landed(0);
  __syncthreads();
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < k_tiles; ++t) {
    fetch(t + RAW_STAGES - 1);
    const uint32_t a_big = smem_u32(smem + (t % 2) * STAGE) + wg * 64 * 128;
    const uint32_t b_big = smem_u32(smem + (t % 2) * STAGE) + PLANES * A_BYTES;
    wgmma_fence();
    pin(big);
    if constexpr (F32) {
      pin(small);
      const uint32_t a_small = a_big + A_BYTES, b_small = b_big + B_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k steps of 8
        mma_tf32_n128(small, desc_k(a_small + 32 * kk),
                      desc_k(b_big + 32 * kk), 1);
        mma_tf32_n128(small, desc_k(a_big + 32 * kk),
                      desc_k(b_small + 32 * kk), 1);
        mma_tf32_n128(big, desc_k(a_big + 32 * kk), desc_k(b_big + 32 * kk),
                      1);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // k steps of 16
        mma_bf16_n128(big, desc_k(a_big + 32 * kk), desc_k(b_big + 32 * kk),
                      1);
    }
    wgmma_commit();
    if (t + 1 < k_tiles) {
      // this thread's copies of tile t + 1 have landed, and tile t - 1 is
      // retired; after the barrier every copy has landed and the block has
      // retired tile t - 1, whose plane stage is refilled while tile t's
      // products run
      landed(t + 1);
      wgmma_wait<1>();
      __syncthreads();
      load(t + 1);
      store((t + 1) % 2);
      __syncthreads();
    }
  }
  wgmma_wait<0>();
  pin(big);
  if constexpr (F32) pin(small);

  C += (long long)blockIdx.z * M * N;
  const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
  const int row = m0 + wg * 64 + 16 * w + l / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = row + 8 * (i / 2), n = n0 + 8 * j + 2 * (l % 4) + i % 2;
      if (m < M && n < N) {
        const int d = 4 * j + i;
        if constexpr (F32)
          C[(long long)m * N + n] = small[d] + big[d];
        else
          C[(long long)m * N + n] = __float2bfloat16_rn(big[d]);
      }
    }
}

// How one operand's raw tiles are fetched, and its tensor map for TMA. The
// operand is stored as `nb` matrices (one for a broadcast operand, whose
// batch stride is 0) with row stride `ld`; `kcontig` as in Stager; `ro`
// rows of the tile. TMA needs 16-byte-aligned rows and batches (and is not
// used for a transposed bf16 read); cp.async of 16 bytes needs the same
// alignment; else element by element.
template <typename T>
int plan(CUtensorMap* map, const void* base, bool kcontig, int O, int K,
         long long ld, long long batch, int nb, int ro) {
  constexpr int size = sizeof(T), E = 16 / size, BK = 128 / size;
  memset(map, 0, sizeof(*map));
  if (reinterpret_cast<uintptr_t>(base) % 16 || ld % E || batch % E)
    return PER_ELEMENT;
  const CUtensorMapDataType type = size == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t nz = batch ? nb : 1;
  const cuuint64_t zstride =
      (batch ? batch : ld * (kcontig ? O : K)) * static_cast<cuuint64_t>(size);
  bool ok = false;
  if (kcontig) {  // box: BK x ro
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(O), nz};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * size,
                                   zstride};
    const cuuint32_t box[3] = {BK, static_cast<cuuint32_t>(ro), 1};
    ok = make_map(map, type, 3, base, dims, strides, box);
  } else if (size == 4) {  // boxes: 32 x BK (128 bytes of o), ro / 32 of them
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(O),
                                static_cast<cuuint64_t>(K), nz};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * size,
                                   zstride};
    const cuuint32_t box[3] = {32, BK, 1};
    ok = make_map(map, type, 3, base, dims, strides, box);
  }
  return ok ? TMA : VECTOR;
}

template <typename T, int WGS, bool TA, bool TB>
int launch(const void* A, const void* B, void* C, int nb, int M, int N, int K,
           long long lda, long long ldb, long long batch_a, long long batch_b,
           cudaStream_t s) {
  constexpr int bytes = SMEM_BYTES<T, WGS>;
  static const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<T, WGS, TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap ma, mb;
  const int fa = std::min<int>(
      WG_GEMM_MAX_FETCH, plan<T>(&ma, A, !TA, M, K, lda, batch_a, nb, 64 * WGS));
  const int fb = std::min<int>(
      WG_GEMM_MAX_FETCH, plan<T>(&mb, B, TB, N, K, ldb, batch_b, nb, BN));
  gemm_last_fetch[0] = fa;
  gemm_last_fetch[1] = fb;
  const int tiles_m = (M + 64 * WGS - 1) / (64 * WGS);
  const int tiles_n = (N + BN - 1) / BN;
  const dim3 grid(tiles_m * tiles_n, 1, nb);
  gemm_kernel<T, WGS, TA, TB><<<grid, 128 * WGS, bytes, s>>>(
      ma, mb, static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<T*>(C), M, N, K, lda, ldb, batch_a, batch_b, fa, fb,
      tiles_m, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int WGS>
int launch_tr(int ta, int tb, const void* A, const void* B, void* C, int nb,
              int M, int N, int K, long long lda, long long ldb,
              long long batch_a, long long batch_b, cudaStream_t s) {
#define WG_GEMM_ARGS A, B, C, nb, M, N, K, lda, ldb, batch_a, batch_b, s
  if (ta && tb) return launch<T, WGS, true, true>(WG_GEMM_ARGS);
  if (ta) return launch<T, WGS, true, false>(WG_GEMM_ARGS);
  if (tb) return launch<T, WGS, false, true>(WG_GEMM_ARGS);
  return launch<T, WGS, false, false>(WG_GEMM_ARGS);
#undef WG_GEMM_ARGS
}

}  // namespace

// How the last launch fetched A and B (Fetch: 0 element by element, 1
// cp.async of 16 bytes, 2 TMA), for the smoke test's report.
extern "C" {
int gemm_last_fetch[2] = {0, 0};
}

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
  if (nb > 65535) return 1001;
  if (dtype != 0 && dtype != 1) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // two warpgroups (128 x 128 tiles) once there is a tile for each of the
  // card's 132 SMs
  const bool wide =
      (long long)((M + 127) / 128) * ((N + BN - 1) / BN) * nb >= 132;
#define WG_GEMM(T, WGS) \
  launch_tr<T, WGS>(ta, tb, A, B, C, nb, M, N, K, lda, ldb, batch_a, batch_b, s)
  if (dtype == 0) return wide ? WG_GEMM(float, 2) : WG_GEMM(float, 1);
  return wide ? WG_GEMM(__nv_bfloat16, 2) : WG_GEMM(__nv_bfloat16, 1);
#undef WG_GEMM
}
