// Batched matrix-vector products y = A x and y = A^T x, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels wgmath_tpu/ops/gemv.py _gemv_pallas (y = A x,
// reached through gemv) and _gemv_tr_pallas (y = A^T x, reached through
// gemv(..., transpose_a=True)). Both compute what those kernels compute:
// f32 products summed in f32 over K. One launch per product.
//
// Bound on this card: bytes. Each element of A is read once and used in one
// multiply-add (a quarter of an operation per byte against the twenty where
// the f32 pipes and the memory balance), so both kernels stream A at the
// memory rate: (M K + K + M) 4 bytes at 3.35 TB/s, 20.0 us at M = K = 4096.
// A 4096^2 matrix (67 MB) is larger than the 50 MB L2, so a chain
// v <- A v reads A from device memory every time. What the designs do about
// it: 16-byte loads, many of them in flight per thread, A read with
// streaming loads (ld.global.cs: read once, not kept in L1) so that x stays
// cached, and work spread evenly over the SMs.
//
// gemv_rows (A x, A [M, K] with k contiguous). The Pallas kernel streams
// row blocks of A through VMEM with x resident and reduces along the lanes.
// Here the grid is sized for PLAN_SMS SMs (BLOCKS_PER_SM blocks an SM):
// block i owns the rows [i M / G, (i + 1) M / G), an even share, and each
// warp of it takes ROWS rows at a time. Its lanes stride along K with
// float4 loads (scalar loads where the rows or x are not 16-byte aligned,
// and for the tail), UNROLL float4 of each row in flight;
// each float4 of x is loaded once and used for all of the warp's rows.
// Each lane keeps one sum per row with explicit fmaf; the 32 sums of a row
// are folded by warp shuffles in a fixed order. A block with fewer row
// groups than warps (a narrow M) gives each group several warps, which
// split its K and add their sums in shared memory in warp order.
//
// gemv_tr_cols (A^T x, A [K, M] with m contiguous). The Pallas kernel walks
// K blocks as a sequential grid and carries the output row in VMEM from one
// step to the next; blocks of a CUDA grid run in no order. Here a block of
// TR_THREADS owns a tile of TW columns (128 where M allows: 32 lanes x
// float4, a warp reading 512 contiguous bytes of a row; narrower tiles for
// a narrow M, the lanes then split over 2-32 rows) and a chunk of K. Its
// slice of x is staged in shared memory (TR_XS rows at a time, by cp.async
// while the first rows of A load); its warps take interleaved rows,
// TR_UNROLL rows of A in flight per thread, and add their partials in
// shared memory in a fixed row-slot order. When the grid has fewer blocks
// than SMs, K is split over a
// thread-block cluster of up to 8 blocks on neighbouring SMs (rank r takes
// chunk r): each block leaves its column partials in its shared memory,
// and after cluster.sync() the blocks read each other's through
// distributed shared memory and add them in rank order, each rank writing
// a share of the columns. No scratch tensor, no second launch, no atomics.
// At 4096^2: 32 tiles x a cluster of 4, 128 blocks of 16 warps. Where the
// split at its most still leaves the grid short, the tiles narrow down to
// 32 columns. A narrow M with a tall K is the shape this leaves
// under-filled: at M = 64, 2 tiles x 8 blocks on 16 SMs (see gemv_plan).
//
// No atomics anywhere: which terms a thread adds, and in what order,
// depends only on the shapes, so two launches on the same inputs give the
// same bits. The batch is the grid's last dimension (a grid-stride loop
// past 65,535), with batch strides (0 for an operand shared by the whole
// batch); ragged M and K are masked, so any M, K >= 1 is taken.
//
// core/cuda_build.py builds every source with --fmad=false, which only stops
// the compiler from contracting a * b + c; the explicit fmaf() below is one
// FFMA per term.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;       // B5: threads a block
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 2;            // B5: rows a warp owns at once
constexpr int UNROLL = 4;          // B5: float4 of each row in flight a lane
constexpr int BLOCKS_PER_SM = 4;   // B5: blocks of the grid per SM
constexpr int TR_THREADS = 512;    // B6: threads a block
constexpr int TR_WARPS = TR_THREADS / 32;
constexpr int TR_UNROLL = 8;       // B6: rows of A in flight per thread
constexpr int TR_MAX_CLUSTER = 8;  // B6: largest K split (portable cluster)
constexpr int TR_TILE = 128;       // B6: widest column tile, 32 lanes x float4
constexpr int TR_XS = 4096;        // B6: rows of x staged in shared memory
constexpr int TR_MIN_ROWS = 64;    // B6: fewest rows of K a block of a split
constexpr int TR_MIN_TILE = 32;    // B6: narrowest tile a short grid takes
constexpr int MAX_GRID_YZ = 65535;
// The SM count the grids are sized for: the H100 SXM's. A fixed count, not
// the device's, so that the plan (and with it the order of addition) is a
// function of the shapes alone and the bits hold from card to card.
constexpr int PLAN_SMS = 132;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

__device__ __forceinline__ float4 fma4(float4 a, float s, float4 acc) {
  acc.x = fmaf(a.x, s, acc.x);
  acc.y = fmaf(a.y, s, acc.y);
  acc.z = fmaf(a.z, s, acc.z);
  acc.w = fmaf(a.w, s, acc.w);
  return acc;
}

__device__ __forceinline__ float dot4(float4 a, float4 x, float acc) {
  acc = fmaf(a.x, x.x, acc);
  acc = fmaf(a.y, x.y, acc);
  acc = fmaf(a.z, x.z, acc);
  return fmaf(a.w, x.w, acc);
}

// ---------------------------------------------------------------- B5: A x

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    gemv_rows(const float* __restrict__ A, const float* __restrict__ x,
              float* __restrict__ y, int nb, int M, int K, long long lda,
              long long batch_a, long long batch_x) {
  constexpr int R = ROWS, U = UNROLL;
  __shared__ float red[WARPS][R];  // K-part sums of a pass's rows
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // this block's even share of the rows, in groups of R
  const int r0 = (int)((long long)M * blockIdx.x / gridDim.x);
  const int r1 = (int)((long long)M * (blockIdx.x + 1) / gridDim.x);
  const int n_groups = (r1 - r0 + R - 1) / R;
  // a block with fewer groups than warps gives each group kw warps, which
  // split its K in interleaved runs of 32 float4 (a power of two: the
  // same for every warp of the block)
  int kw = 1;
  while (kw < WARPS && kw * 2 * n_groups <= WARPS) kw *= 2;
  const int per_pass = WARPS / kw, kpart = warp % kw;
  for (long long b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* xv = x + b * batch_x;
    for (int base = 0; base < n_groups; base += per_pass) {
      const int r = r0 + (base + warp / kw) * R;
      const int nr = min(R, r1 - r);  // <= 0: no group for this warp
      float acc[R];
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] = 0.0f;
      if (nr > 0) {
        const float* a[R];
#pragma unroll
        for (int j = 0; j < R; ++j)
          a[j] = A + b * batch_a + (long long)(r + min(j, nr - 1)) * lda;
        int k0 = 0;
        if (VEC) {
          const int k4 = K / 4;
          const float4* x4 = reinterpret_cast<const float4*>(xv);
          int i = lane + 32 * kpart;
          for (; i + 32 * kw * (U - 1) < k4; i += 32 * kw * U) {
            float4 xq[U], av[R][U];
#pragma unroll
            for (int u = 0; u < U; ++u) xq[u] = __ldg(x4 + i + 32 * kw * u);
#pragma unroll
            for (int j = 0; j < R; ++j)
#pragma unroll
              for (int u = 0; u < U; ++u)
                av[j][u] = j < nr ? __ldcs(reinterpret_cast<const float4*>(
                                             a[j]) + i + 32 * kw * u)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int j = 0; j < R; ++j)
                acc[j] = dot4(av[j][u], xq[u], acc[j]);
          }
          for (; i < k4; i += 32 * kw) {
            const float4 xq = __ldg(x4 + i);
#pragma unroll
            for (int j = 0; j < R; ++j)
              if (j < nr)
                acc[j] = dot4(
                    __ldcs(reinterpret_cast<const float4*>(a[j]) + i), xq,
                    acc[j]);
          }
          k0 = 4 * k4;
        }
#pragma unroll 4
        for (int k = k0 + lane + 32 * kpart; k < K; k += 32 * kw) {
          const float xk = __ldg(xv + k);
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (j < nr) acc[j] = fmaf(__ldcs(a[j] + k), xk, acc[j]);
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            acc[j] += __shfl_down_sync(0xffffffffu, acc[j], d);
        }
      }
      if (kw == 1) {
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (j < nr) y[b * M + r + j] = acc[j];
        }
        continue;
      }
      // the kw K-parts of each row, added in part order
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) red[warp][j] = acc[j];
      }
      __syncthreads();
      if (lane == 0 && kpart == 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (j < nr) {
            float t = red[warp][j];
            for (int q = 1; q < kw; ++q) t += red[warp + q][j];
            y[b * M + r + j] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}

// -------------------------------------------------------------- B6: A^T x

// one row's share of the tile for this thread: VEC a float4 of 4
// neighbouring columns, else 4 columns lr apart; 0 past M
template <bool VEC>
__device__ __forceinline__ float4 tile_row(const float* row, int cl,
                                           const int* lc, const bool* ok) {
  if (VEC)  // M % 4 == 0 here, so a float4 is in the matrix or wholly past
    return ok[0] ? __ldcs(reinterpret_cast<const float4*>(row) + cl)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(ok[0] ? __ldcs(row + lc[0]) : 0.f,
                     ok[1] ? __ldcs(row + lc[1]) : 0.f,
                     ok[2] ? __ldcs(row + lc[2]) : 0.f,
                     ok[3] ? __ldcs(row + lc[3]) : 0.f);
}

// grid (column tiles, K split, batch); the K split is the cluster's y
// extent. Tile width tw = 4 << lr_shift: lr lanes cover a row of the tile,
// 32 / lr rows are read by one warp at once.
template <bool VEC>
__global__ void __launch_bounds__(TR_THREADS)
    gemv_tr_cols(const float* __restrict__ A, const float* __restrict__ x,
                 float* __restrict__ y, int nb, int M, int K, int chunk,
                 int lr_shift, long long lda, long long batch_a,
                 long long batch_x) {
  constexpr int U = TR_UNROLL;
  __shared__ float xs[TR_XS];
  __shared__ float red[TR_WARPS * TR_TILE];  // [row slot][column of the tile]
  __shared__ float part[TR_TILE];         // this block's column sums
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lr = 1 << lr_shift, tw = 4 << lr_shift;
  const int groups = 32 >> lr_shift;  // rows one warp reads at once
  const int slots = TR_WARPS * groups;   // row slots of the block
  const int slot = warp * groups + (lane >> lr_shift);
  const int cl = lane & (lr - 1);
  const int c0 = blockIdx.x * tw;
  // the tile's columns this thread sums: VEC 4 neighbours, else 4 strided
  int lc[4];
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lc[j] = VEC ? 4 * cl + j : cl + lr * j;
    ok[j] = c0 + lc[j] < M;
  }
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(K, k0 + chunk);
  const int split = gridDim.y;
  for (long long b = blockIdx.z; b < nb; b += gridDim.z) {
    const float* ab = A + b * batch_a + c0;
    const float* xv = x + b * batch_x;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();  // the previous product is done with xs and red
    for (int s = k0; s < k1; s += TR_XS) {
      const int len = min(TR_XS, k1 - s);
      // this thread's rows are slot, slot + slots, ...: U in flight. The
      // chunk's x is copied to shared memory by cp.async while the first U
      // rows of A are on their way.
      const float* as = ab + (long long)s * lda;
      int r = slot;
      for (int i = tid; i < len; i += TR_THREADS)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         (unsigned)__cvta_generic_to_shared(xs + i)),
                     "l"(xv + s + i)
                     : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      float4 v[U];
      if (r + slots * (U - 1) < len) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[u] = tile_row<VEC>(as + (long long)(r + slots * u) * lda, cl, lc,
                               ok);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      for (; r + slots * (U - 1) < len; r += slots * U) {
#pragma unroll
        for (int u = 0; u < U; ++u) acc = fma4(v[u], xs[r + slots * u], acc);
        const int rn = r + slots * U;
        if (rn + slots * (U - 1) < len) {
#pragma unroll
          for (int u = 0; u < U; ++u)
            v[u] = tile_row<VEC>(as + (long long)(rn + slots * u) * lda, cl,
                                 lc, ok);
        }
      }
      for (; r < len; r += slots)
        acc = fma4(tile_row<VEC>(as + (long long)r * lda, cl, lc, ok), xs[r],
                   acc);
      __syncthreads();  // xs is refilled next
    }
    red[slot * tw + lc[0]] = acc.x;
    red[slot * tw + lc[1]] = acc.y;
    red[slot * tw + lc[2]] = acc.z;
    red[slot * tw + lc[3]] = acc.w;
    __syncthreads();
    // the block's column sums, row slots added in order (slots past the
    // chunk's rows hold nothing)
    float sum = 0.0f;
    if (tid < tw) {
      const int used = min(slots, max(k1 - k0, 1));
      sum = red[tid];
      for (int q = 1; q < used; ++q) sum += red[q * tw + tid];
    }
    if (split == 1) {
      if (tid < tw && c0 + tid < M) y[b * M + c0 + tid] = sum;
      continue;
    }
    // the K split: the cluster's blocks add their sums in rank order, rank
    // r writing the columns tid with tid % split == r
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    if (tid < tw) part[tid] = sum;
    cluster.sync();
    if (tid < tw && tid % split == (int)rank && c0 + tid < M) {
      float t = *cluster.map_shared_rank(&part[tid], 0);
      for (int q = 1; q < split; ++q)
        t += *cluster.map_shared_rank(&part[tid], q);
      y[b * M + c0 + tid] = t;
    }
    cluster.sync();  // every rank's part is read before it is overwritten
  }
}

struct Plan {
  int grid[3];
  int cluster;   // B6: blocks of the K split (1: no cluster)
  int chunk;     // B6: rows of K per block
  int lr_shift;  // B6: tile width 4 << lr_shift
};

Plan plan_rows(int nb, int M) {
  Plan p{};
  const int nbz = nb < MAX_GRID_YZ ? nb : MAX_GRID_YZ;
  const int want = ceil_div((long long)PLAN_SMS * BLOCKS_PER_SM, nbz);
  const int most = ceil_div(M, ROWS);
  p.grid[0] = want < 1 ? 1 : (want > most ? most : want);
  p.grid[1] = nbz;
  p.grid[2] = 1;
  p.cluster = 1;
  return p;
}

Plan plan_tr(int nb, int M, int K) {
  Plan p{};
  const int nbz = nb < MAX_GRID_YZ ? nb : MAX_GRID_YZ;
  // the widest tile M fills
  int s = 0;
  while ((4 << s) < M && (4 << s) < TR_TILE) ++s;
  // a K split, a power of two up to the cluster limit, while the grid is
  // short (full at 15/16 of a block an SM) and each block keeps
  // TR_MIN_ROWS rows
  const int rows_cap = ceil_div(K, TR_MIN_ROWS);
  long long blocks = (long long)ceil_div(M, 4 << s) * nbz;
  int split = 1;
  while (split * 2 <= TR_MAX_CLUSTER && split * 2 <= rows_cap &&
         16 * blocks * split < 15 * PLAN_SMS)
    split *= 2;
  // then narrower tiles (down to TR_MIN_TILE) while it is still short
  while ((4 << s) > TR_MIN_TILE && 16 * blocks * split < 15 * PLAN_SMS) {
    --s;
    blocks = (long long)ceil_div(M, 4 << s) * nbz;
  }
  p.lr_shift = s;
  p.chunk = ceil_div(K, split);
  p.cluster = split;
  p.grid[0] = ceil_div(M, 4 << s);
  p.grid[1] = split;
  p.grid[2] = nbz;
  return p;
}

}  // namespace

// Plain C entry points (bound with ctypes). A is [nb or 1, M, K] for
// gemv_launch, [nb or 1, K, M] for gemv_tr_launch, with unit inner stride,
// row stride `lda` and batch stride `batch_a` (0 shares one matrix over the
// batch); x is [nb or 1, K] with batch stride `batch_x`; y is contiguous
// [nb, M]. Every argument is one 64-bit word: ctypes converts a Python int
// to a pointer-sized argument faster than to an int.
// Each makes one kernel launch and returns cudaGetLastError() after it;
// 1001 for an empty shape or one past int range.
namespace {
bool bad_shape(long long nb, long long M, long long K) {
  return nb < 1 || M < 1 || K < 1 || nb > INT_MAX || M > INT_MAX ||
         K > INT_MAX;
}
}  // namespace

extern "C" int gemv_launch(long long nb64, long long M64, long long K64,
                           const float* A, long long lda, long long batch_a,
                           const float* x, long long batch_x, float* y,
                           void* stream) {
  if (bad_shape(nb64, M64, K64)) return 1001;
  const int nb = (int)nb64, M = (int)M64, K = (int)K64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan_rows(nb, M);
  const dim3 grid(p.grid[0], p.grid[1]);
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

extern "C" int gemv_tr_launch(long long nb64, long long M64, long long K64,
                              const float* A, long long lda,
                              long long batch_a, const float* x,
                              long long batch_x, float* y, void* stream) {
  if (bad_shape(nb64, M64, K64)) return 1001;
  const int nb = (int)nb64, M = (int)M64, K = (int)K64;
  const Plan p = plan_tr(nb, M, K);
  const bool vec =
      aligned16(A) && lda % 4 == 0 && batch_a % 4 == 0 && M % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid[0], p.grid[1], p.grid[2]);
  cfg.blockDim = dim3(TR_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, gemv_tr_cols<true>, A, x, y, nb, M, K,
                               p.chunk, p.lr_shift, lda, batch_a, batch_x)
          : cudaLaunchKernelEx(&cfg, gemv_tr_cols<false>, A, x, y, nb, M, K,
                               p.chunk, p.lr_shift, lda, batch_a, batch_x);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape either entry point uses for these shapes: out = {grid x,
// grid y, grid z, cluster blocks, rows of K per block (A^T x), tile width
// (A^T x)}. For reports; the launches do not need it.
extern "C" void gemv_plan(int transposed, int nb, int M, int K, int* out) {
  const Plan p = transposed ? plan_tr(nb, M, K) : plan_rows(nb, M);
  out[0] = p.grid[0];
  out[1] = p.grid[1];
  out[2] = p.grid[2];
  out[3] = p.cluster;
  out[4] = transposed ? p.chunk : 0;
  out[5] = transposed ? 4 << p.lr_shift : 0;
}
