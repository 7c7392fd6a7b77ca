// Operand-tile loader shared by gemm.cu and gemm_split.cu.
//
// A block of 256 threads stages one [BO x BK] tile of a logical
// [outer, K] operand through registers into shared memory as f32, k-major:
// dst[k][o]. `KCONTIG` says how the operand is stored: element (o, k) at
// src[o * ld + k] (k contiguous: a plain A, a transposed B) or at
// src[k * ld + o] (outer contiguous: a transposed A, a plain B). The
// transpose flags of the product therefore only pick the thread-to-element
// map, so that neighbouring threads always read neighbouring addresses; no
// operand is transposed in memory. Elements past the ragged edge read as 0,
// which adds nothing to the sums.
//
// Shared rows are padded by 4 floats: rows stay 16-byte aligned for the
// float4 reads of the inner loop, and the k-contiguous map's transposed
// store hits each bank at most twice.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile {

// depth of one staged tile; scripts/exp_gemm_tiles.py builds other values
#ifndef WG_TILE_BK
#define WG_TILE_BK 16
#endif
constexpr int BK = WG_TILE_BK;
constexpr int THREADS = 256;  // 16 x 16 threads per block
constexpr int PAD = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// (o, k) offsets inside the tile of this thread's i-th element
template <int BO, bool KCONTIG>
__device__ __forceinline__ void element(int i, int& oo, int& kk) {
  const int t = threadIdx.x;
  if (KCONTIG) {
    kk = t % BK;
    oo = t / BK + (THREADS / BK) * i;
  } else {
    oo = t % BO;
    kk = t / BO + (THREADS / BO) * i;
  }
}

template <typename T, int BO, bool KCONTIG>
__device__ __forceinline__ void fetch(const T* __restrict__ src, long long ld,
                                      int o0, int k0, int O, int K,
                                      float (&r)[BO * BK / THREADS]) {
#pragma unroll
  for (int i = 0; i < BO * BK / THREADS; ++i) {
    int oo, kk;
    element<BO, KCONTIG>(i, oo, kk);
    const int o = o0 + oo, k = k0 + kk;
    float v = 0.0f;
    if (o < O && k < K)
      v = to_f32(KCONTIG ? src[(long long)o * ld + k]
                         : src[(long long)k * ld + o]);
    r[i] = v;
  }
}

template <int BO, bool KCONTIG>
__device__ __forceinline__ void stash(float (*dst)[BO + PAD],
                                      const float (&r)[BO * BK / THREADS]) {
#pragma unroll
  for (int i = 0; i < BO * BK / THREADS; ++i) {
    int oo, kk;
    element<BO, KCONTIG>(i, oo, kk);
    dst[kk][oo] = r[i];
  }
}

// The TM values of row k of a staged tile that thread coordinate `c` (0..15)
// owns: 4 consecutive floats at 4 c in every 64-wide chunk.
template <int TM, int BO>
__device__ __forceinline__ void fragment(const float (*src)[BO + PAD], int k,
                                         int c, float (&f)[TM]) {
#pragma unroll
  for (int q = 0; q < TM / 4; ++q) {
    const float4 v =
        *reinterpret_cast<const float4*>(&src[k][q * 64 + 4 * c]);
    f[4 * q + 0] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

// Row (or column) index inside the block's tile of a thread's i-th value.
__device__ __forceinline__ int owned(int i, int c) {
  return (i / 4) * 64 + 4 * c + i % 4;
}

}  // namespace tile
