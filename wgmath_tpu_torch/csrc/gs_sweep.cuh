// One Gauss-Seidel sweep over the whole window ladder in one launch: the
// machinery gs_math.cu (B1) and gs_math_block.cu (B2) share; gs_fused.cu
// (B10, B11) orders its colours with the same ticket, flag polls and
// releases (draw_ticket, flag_in, run_when, release_flags) and stages its
// column-major fields with stage_issue_columns, on its own layout and
// flags. Each ladder kernel
// instantiates its row math twice: once for a sweep (SWEEP = true: the
// plan's chunks, the velocity buffer and the merged impulse matrix, in
// place) and once for one rung with separate inputs and outputs (the
// per-rung entry points gs_math_rhs_launch / gs_math_block_launch).
//
// The plan (dynamics/solver.py build_sweep_plan) cuts every rung into
// chunks of at most rows_per_chunk(P) rows that never cross a rung. A
// rung runs only the slots of its own class (slot < min(count, w)): the
// window's slots past the class belong to later rungs, and in one launch
// a rewrite of them could land after the later rung's update and undo
// it. Every side of every rung has a table entry:
//   x  the buffer row it reads (the chained stream: the chain's src; the
//      ladder: the body),
//   y  the buffer row it writes, -1 for none (chained: its own stream
//      row, where the chain advances; ladder: the body, where the row is
//      active and the side dynamic),
//   z  the side whose write it waits for, -1 when it reads the body table
//      (chained) or no earlier rung wrote its body (ladder),
//   w  2 x the side's body + the row's active flag (slot in the class and
//      contact live).
//
// Ordering: a block takes its chunk from an atomic ticket, and tickets go
// in ladder order. A chunk waits only on sides of earlier rungs, so the
// block holding the lowest unfinished ticket never waits on anything that
// is not already running: no cooperative launch, no grid barrier, no
// assumption on how many blocks are resident. The block that draws the
// last ticket sets the counter back to 0 for the next launch on the
// stream. A writer stores its rows, then releases ready[side] = epoch (a
// gpu-scope fence, then relaxed stores of the flags); a reader polls
// ready[dep] with relaxed loads and __nanosleep backoff until it holds
// this sweep's epoch, then fences (the acquire pattern). One fence serves
// both sides of a row, and each lane of a warp updates its row as soon as
// its own sides are ready (run_when_ready). The epoch is a counter the
// wrapper raises every sweep, so the flags are never cleared. The buffer
// is read and written in the same launch: it is never read through the
// read-only path (no const __restrict__, no __ldg); its rows are loaded
// with ld.global.cg after the acquire.
//
// What bounds a sweep is its chain of rungs: a level costs a poll that
// sees the flag, the fence, two row loads, the row's update and the
// release, ~4 us on the H100 (scripts/exp_sweep_trace.py prints each
// rung's marks), against ~0.1 us of memory time for its rows.
//
// A chunk's packed fields do not depend on earlier rungs, so they are
// staged into shared memory (coalesced 4-byte cp.async, row pitch padded
// to an odd word count: conflict-free per-row reads), and everything else
// a row needs that no earlier rung writes is loaded while that copy is in
// flight, before any wait.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gs_point_updates.cuh"

namespace gs {

// rows of a chunk: one thread a row. A P = 4 row is 216 packed floats
// (864 B), so its chunks are narrower to keep the staging area small.
__host__ __device__ constexpr int rows_per_chunk(int P) {
  return P == 1 ? 128 : 32;
}

struct Sweep {
  const int4* chunks;  // [n, 4]: first row, rows, first a-side, first b-side
  const int4* sides;   // [2 sum(w), 4]: read row, write row, wait side,
                       // 2 body + row active
  unsigned* ready;     // [2 sum(w)]: epoch of the sweep that wrote the side
  unsigned* ticket;    // one counter, 0 between launches
  unsigned epoch;
  int chunk0, nchunks;  // this launch's chunks: [chunk0, chunk0 + nchunks)
  float* buf;          // velocity buffer: body table [+ stream], rows of
  int ld_buf;          // 6 floats
};

// The launch's next ticket in [0, n), for one thread: tickets go out in
// the order blocks ask, and the block that draws the last one sets the
// counter back to 0 for the next launch on the stream.
__device__ __forceinline__ int draw_ticket(unsigned* ticket, int n) {
  const unsigned t = atomicAdd(ticket, 1u);
  if (t == static_cast<unsigned>(n) - 1u) atomicExch(ticket, 0u);
  return static_cast<int>(t);
}

// The sweep's next chunk (every thread of the block gets it).
__device__ __forceinline__ int4 take_chunk(const Sweep& sw) {
  __shared__ int4 ch;
  if (threadIdx.x == 0)
    ch = sw.chunks[sw.chunk0 + draw_ticket(sw.ticket, sw.nchunks)];
  __syncthreads();
  return ch;
}

// One rung's chunk by block index (the per-rung entry points).
__device__ __forceinline__ int4 rows_chunk(int L, int rows) {
  const int row0 = blockIdx.x * rows;
  return make_int4(row0, min(rows, L - row0), 0, 0);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Start staging rows [row0, row0 + len) x columns [0, k) of `win` into
// `stage` (row pitch `pitch`); stage_wait() waits for the copy and for the
// whole block.
__device__ __forceinline__ void stage_issue(float* stage, int pitch,
                                            const float* win, int ld_win,
                                            int k, int row0, int len) {
  const int n = blockDim.x;
  int row = threadIdx.x / k, col = threadIdx.x - row * k;
  const int dr = n / k, dc = n - dr * k;
  while (row < len) {
    cp_async4(stage + row * pitch + col,
              win + (size_t)(row0 + row) * ld_win + col);
    row += dr;
    col += dc;
    if (col >= k) {
      col -= k;
      ++row;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Start staging fields [0, k) of columns [col0, col0 + len) of a
// field-major block (field e of column c at win[e * ld_win + c]: the fused
// solver's window block) into stage[e * R + i], each field's columns
// contiguous: 16-byte copies where the addresses allow (col0, ld_win and
// the base 16-byte aligned), 4-byte ones for the rest. A thread reads its
// column's fields R floats apart (StridedRow<R>, conflict-free).
// stage_wait() as for stage_issue.
template <int R>
__device__ __forceinline__ void stage_issue_columns(float* stage,
                                                    const float* win,
                                                    int ld_win, int k,
                                                    int col0, int len) {
  const int n = blockDim.x;
  const bool aligned = ((col0 | ld_win) & 3) == 0
                       && (reinterpret_cast<size_t>(win) & 15) == 0;
  const int quads = aligned ? len >> 2 : 0;
  for (int i = threadIdx.x; i < k * quads; i += n) {
    const int e = i / quads, q = 4 * (i - e * quads);
    cp_async16(stage + e * R + q, win + (size_t)e * ld_win + col0 + q);
  }
  const int rest = len - 4 * quads;
  for (int i = threadIdx.x; i < k * rest; i += n) {
    const int e = i / rest, c = 4 * quads + i - e * rest;
    cp_async4(stage + e * R + c, win + (size_t)e * ld_win + col0 + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The longest pause between two polls of a flag, in ns: the pause
// doubles from 32 up to it. Longer pauses cost the chain of rungs a level
// of latency each (PERF.md, the B1 / B2 findings).
constexpr unsigned kSpinNsMax = 64;

// A second or more of polling (2^22 polls, each an L2 round trip): a side
// that is never released is a fault of the plan, and trapping ends the
// launch with an error instead of hanging the card.
constexpr unsigned kMaxSpins = 1u << 22;

__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Whether a flag holds a value in [lo, lo + span] (unsigned arithmetic,
// so the window may wrap), by a relaxed load (the poll of the acquire
// pattern, which a fence completes) or, ACQUIRE, by an acquire load (the
// pattern in one load: no fence, which would also wait for the thread's
// earlier stores).
template <bool ACQUIRE = false>
__device__ __forceinline__ bool flag_in(const unsigned* flag, unsigned lo,
                                        unsigned span) {
  unsigned v;
  if (ACQUIRE)
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(flag)
                 : "memory");
  else
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(flag)
                 : "memory");
  return v - lo <= span;
}

__device__ __forceinline__ bool side_ready(const Sweep& sw, int side) {
  return side < 0 || flag_in(sw.ready + side, sw.epoch, 0);
}

// Run `update` for this lane's row once `ready()` holds (ready() makes the
// acquire: the rows `update` reads are the released ones). The lanes of a
// warp (`lanes`: those with a row) poll together and each runs its update
// as soon as its own flags are ready, while the others go on polling: a
// warp does not wait for the latest of its 64 sides before any of its rows
// moves, and a row's release is not held up behind the warp's slowest
// dependency.
template <typename R, typename F>
__device__ __forceinline__ void run_when(unsigned lanes, R&& ready,
                                         F&& update) {
  bool done = false;
  unsigned ns = 32, spins = 0;
  for (;;) {
    if (!done && ready()) {
      update();
      done = true;
    }
    if (__all_sync(lanes, done)) return;
    if (!done) {
      if (++spins == kMaxSpins) __trap();
      __nanosleep(ns);
      if (ns < kSpinNsMax) ns *= 2;
    }
  }
}

// The ladder's wait: both sides' writers (z of their entries, -1: none)
// released this sweep's epoch (relaxed polls, then a fence).
template <typename F>
__device__ __forceinline__ void run_when_ready(const Sweep& sw,
                                               unsigned lanes,
                                               const int4& ea,
                                               const int4& eb, F&& update) {
  run_when(lanes,
           [&]() {
             if (!(side_ready(sw, ea.z) && side_ready(sw, eb.z)))
               return false;
             fence_gpu();
             return true;
           },
           update);
}

// Release up to two flags (nullptr: none) with `value`: one fence for
// both, then relaxed stores (the release pattern).
__device__ __forceinline__ void release_flags(unsigned* fa, unsigned* fb,
                                              unsigned value) {
  if (fa == nullptr && fb == nullptr) return;
  fence_gpu();
  if (fa != nullptr)
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(fa),
                 "r"(value)
                 : "memory");
  if (fb != nullptr)
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(fb),
                 "r"(value)
                 : "memory");
}

// Release the sides that wrote their rows (y >= 0) with the epoch.
__device__ __forceinline__ void release_sides(const Sweep& sw,
                                              const int4& ea, int side_a,
                                              const int4& eb, int side_b) {
  release_flags(ea.y >= 0 ? sw.ready + side_a : nullptr,
                eb.y >= 0 ? sw.ready + side_b : nullptr, sw.epoch);
}

// A buffer row's velocity, past L1 (the row may have been written by
// another SM in this launch).
__device__ __forceinline__ void load_vel_cg(const float* row, float (&l)[3],
                                            float (&a)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    l[q] = __ldcg(row + q);
    a[q] = __ldcg(row + 3 + q);
  }
}

// Write one side's updated row: v + (w - v) on the six velocity columns
// (what the plain sweep's `row + d` computes, not w).
__device__ __forceinline__ void write_side(const Sweep& sw, const int4& e,
                                           const float (&wl)[3],
                                           const float (&wa)[3],
                                           const float (&vl)[3],
                                           const float (&va)[3]) {
  if (e.y < 0) return;
  float* out = sw.buf + (size_t)e.y * sw.ld_buf;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    out[q] = vl[q] + (wl[q] - vl[q]);
    out[3 + q] = va[q] + (wa[q] - va[q]);
  }
}

// A side entry's body and the row's active flag (w = 2 body + active).
__device__ __forceinline__ int side_body(const int4& e) { return e.w >> 1; }
__device__ __forceinline__ bool side_active(const int4& e) {
  return (e.w & 1) != 0;
}

// Store one row's new impulses, `ld` floats apart (after its sides are
// released: the release would otherwise wait for these stores too).
template <int P>
__device__ __forceinline__ void store_impulses(const float (&nn)[P],
                                               const float (&nt)[P * S],
                                               float* out_n, float* out_t,
                                               size_t ld = 1) {
#pragma unroll
  for (int k = 0; k < P; ++k) out_n[k * ld] = nn[k];
#pragma unroll
  for (int k = 0; k < P * S; ++k) out_t[k * ld] = nt[k];
}

// Timestamps of a sweep for scripts/exp_sweep_trace.py, which builds the
// kernels with -DWG_SWEEP_TRACE=1: for every row a sweep runs, the global
// timer when its block has its chunk (0), after the staging barrier (1),
// after its wait (2), after its update (3) and after its release (4). The
// ladder indexes a row by its a-side; gs_fused.cu by its row of the fused
// layout, and lane b of its opening at Ctot + b (marks 0 and 4 only). Off
// by default: no array, no stores.
#ifndef WG_SWEEP_TRACE
#define WG_SWEEP_TRACE 0
#endif
constexpr int kTraceMarks = 5, kTraceSides = 1 << 18;
#if WG_SWEEP_TRACE
__device__ unsigned long long g_sweep_trace[kTraceMarks * kTraceSides];
#endif

template <bool SWEEP>
__device__ __forceinline__ void trace_mark(int side, int mark) {
#if WG_SWEEP_TRACE
  if (SWEEP && side < kTraceSides) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_sweep_trace[(size_t)side * kTraceMarks + mark] = t;
  }
#endif
}

// Copy the trace out (a traced build only; 1001 otherwise).
inline int copy_sweep_trace(void* dst, size_t bytes) {
#if WG_SWEEP_TRACE
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_sweep_trace, bytes, 0,
                           cudaMemcpyDeviceToHost));
#else
  (void)dst;
  (void)bytes;
  return 1001;
#endif
}

// Dynamic shared memory of one chunk's staged fields.
inline size_t stage_bytes(int P, int k) {
  return sizeof(float) * rows_per_chunk(P) * (k | 1);
}

// Allow `bytes` of dynamic shared memory for `kernel` where it is more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gs
