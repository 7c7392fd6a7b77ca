// Gauss-Seidel impulse math with the substep's softness and right-hand
// sides passed in, CUDA C++ for sm_90a: one launch for a whole sweep over
// the window ladder, or one launch for one rung.
//
// Replaces the TPU kernel wgmath_tpu/dynamics/gs_pallas.py
// _gs_math_pallas_call (reached through gs_math_block; the TPU's
// window-ladder sweep and chained sweep without rhs-in-rung launch it
// once per rung per sweep). Each row computes exactly _gs_math_xla:
// _cm_point_updates for P contact points with S = 2 friction directions.
// The point update is gs_point_updates.cuh, shared with gs_math.cu.
//
// Sweep (gs_math_block_sweep; the ladder and the plain chained sweep):
// one launch walks every rung of the ladder, as set out in gs_sweep.cuh.
// Row i of a chunk (constraint row r) reads the point update's packed
// fields from shared memory, and cfm[r], n_rhs[r], t_rhs[r] and its
// previous impulses from the merged impulse matrix before it waits; then
// both sides' velocity rows, and it writes its new impulses in place and
// each side's row where it has one:
//   chained: the side's own stream row = the row it read, v + (w - v), as
//            the plain sweep's copy-then-add computes it;
//   ladder:  the body row, buf[b] + (w - v), the single add of the plain
//            sweep's index_add_ onto distinct rows; only where the row is
//            active and the side dynamic.
// The ladder's ordering comes from each body's previous writer
// (solver.build_sweep_plan): a side waits for the last earlier rung that
// wrote its body. A side that reads a body and writes nothing (static, or
// an inactive row) has no later writer waiting on it, and nothing it
// computes is kept. The window's slots past the rung's class are not run.
//
// One rung (gs_math_block_launch, the entry point gs_math_block): the same
// row math on separate inputs, every row of [0, L), writing new_n, new_t,
// d1 = w1 - v1 and d2 = w2 - v2. Every input has its own leading
// dimension, so the caller passes strided views without a copy.
//
// Bound on this card: the dependency chain, then memory. Per row (P = 1)
// the sweep moves 56 packed f32, cfm, 3 rhs, two 6-f32 velocity rows read
// and up to two written, 3 impulse f32 read and written, one i64 and two
// side entries (about 420 B) against ~200 flops; as for gs_math.cu, the
// chain of rungs, not the bytes, sets a sweep's time.
//
// No fast-math; built without multiply-add contraction like gs_math.cu
// (core/cuda_build.py gives both sources the same flags), so each product
// rounds as in the plain PyTorch version.

#include "gs_point_updates.cuh"
#include "gs_sweep.cuh"

namespace {

using namespace gs;

// Where one launch reads and writes; in a sweep prev_n / new_n and prev_t
// / new_t are the same columns of the impulse matrix (no __restrict__).
struct Args {
  int L;  // one rung: rows [0, L)
  const float* win;
  int ld_win, kstage;
  Offsets off;
  const float* cfm;
  const float* n_rhs;
  const float* t_rhs;
  int ld_cfm, ld_nr, ld_tr;
  const int64_t* nump;
  const uint8_t* active;  // one rung
  const float* p1;        // one rung: both sides' velocity rows
  const float* p2;
  int ld_p1, ld_p2;
  const float* prev_n;
  const float* prev_t;
  float* new_n;
  float* new_t;
  int ld_pn, ld_pt, ld_nn, ld_nt;
  float* d1;  // one rung: [L, 6]
  float* d2;
  Sweep sw;
};

template <int P, bool SWEEP>
__global__ void __launch_bounds__(rows_per_chunk(P))
    gs_math_block_kernel(const Args a) {
  extern __shared__ float stage[];
  const int4 ch =
      SWEEP ? take_chunk(a.sw) : rows_chunk(a.L, rows_per_chunk(P));
  const int pitch = a.kstage | 1;
  stage_issue(stage, pitch, a.win, a.ld_win, a.kstage, ch.x, ch.y);
  // a thread past the chunk's rows reads its first row's data and stops
  // after the staging barrier
  const bool live = threadIdx.x < ch.y;
  const int t = live ? threadIdx.x : 0;
  const int i = ch.x + t;
  trace_mark<SWEEP>(live ? ch.z + t : kTraceSides, 0);

  // what does not depend on earlier rungs is read before the wait
  const float np_f = (float)a.nump[i];
  const float cfm = a.cfm[(size_t)i * a.ld_cfm];
  float nr[P], tr[P][S], pn[P], ptv[P * S];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    nr[k] = a.n_rhs[(size_t)i * a.ld_nr + k];
    pn[k] = a.prev_n[(size_t)i * a.ld_pn + k];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      tr[k][j] = a.t_rhs[(size_t)i * a.ld_tr + S * k + j];
      ptv[k * S + j] = a.prev_t[(size_t)i * a.ld_pt + k * S + j];
    }
  }
  int4 ea{}, eb{};
  if (SWEEP) {
    ea = a.sw.sides[ch.z + t];
    eb = a.sw.sides[ch.w + t];
  }
  stage_wait();
  const unsigned lanes = __ballot_sync(0xffffffffu, live);
  if (!live) return;
  trace_mark<SWEEP>(ch.z + t, 1);
  const float* f = stage + t * pitch;
  RowFields r;
  load_row_fields(f, a.off, r);

  // both sides' velocities -> the point update -> the row's writes
  auto update = [&]() {
    bool act;
    float v1l[3], v1a[3], v2l[3], v2a[3];
    if (SWEEP) {
      trace_mark<SWEEP>(ch.z + t, 2);
      act = side_active(ea);
      load_vel_cg(a.sw.buf + (size_t)ea.x * a.sw.ld_buf, v1l, v1a);
      load_vel_cg(a.sw.buf + (size_t)eb.x * a.sw.ld_buf, v2l, v2a);
    } else {
      act = a.active[i] != 0;
      load_vel(a.p1 + (size_t)i * a.ld_p1, v1l, v1a);
      load_vel(a.p2 + (size_t)i * a.ld_p2, v2l, v2a);
    }
    float w1l[3], w1a[3], w2l[3], w2a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w1l[c] = v1l[c];
      w1a[c] = v1a[c];
      w2l[c] = v2l[c];
      w2a[c] = v2a[c];
    }
    float nn[P], nt[P * S];
    gs_point_updates<P>(f, a.off, r, act, np_f, cfm, nr, tr, pn, ptv, w1l,
                        w1a, w2l, w2a, nn, nt);
    trace_mark<SWEEP>(ch.z + t, 3);
    if (SWEEP) {
      write_side(a.sw, ea, w1l, w1a, v1l, v1a);
      write_side(a.sw, eb, w2l, w2a, v2l, v2a);
      release_sides(a.sw, ea, ch.z + t, eb, ch.w + t);
      trace_mark<SWEEP>(ch.z + t, 4);
    } else {
      store_delta(a.d1 + (size_t)i * 6, w1l, w1a, v1l, v1a);
      store_delta(a.d2 + (size_t)i * 6, w2l, w2a, v2l, v2a);
    }
    store_impulses<P>(nn, nt, a.new_n + (size_t)i * a.ld_nn,
                      a.new_t + (size_t)i * a.ld_nt);
  };
  if (SWEEP)
    run_when_ready(a.sw, lanes, ea, eb, update);
  else
    update();
}

template <int P, bool SWEEP>
int launch(const Args& a, int blocks, cudaStream_t s) {
  auto kernel = gs_math_block_kernel<P, SWEEP>;
  const size_t smem = stage_bytes(P, a.kstage);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, rows_per_chunk(P), smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool SWEEP>
int dispatch(int p_max, const Args& a, int blocks, cudaStream_t s) {
  if (p_max == 1) return launch<1, SWEEP>(a, blocks, s);
  if (p_max == 4) return launch<4, SWEEP>(a, blocks, s);
  return 1000;
}

void fill_common(Args& a, const float* win, int ld_win, int kstage,
                 const int* offsets, const float* cfm, int ld_cfm,
                 const float* n_rhs, int ld_nr, const float* t_rhs,
                 int ld_tr, const int64_t* nump) {
  a.win = win;
  a.ld_win = ld_win;
  a.kstage = kstage;
  for (int k = 0; k < N_FIELDS; ++k) a.off.o[k] = offsets[k];
  a.cfm = cfm;
  a.ld_cfm = ld_cfm;
  a.n_rhs = n_rhs;
  a.ld_nr = ld_nr;
  a.t_rhs = t_rhs;
  a.ld_tr = ld_tr;
  a.nump = nump;
}

}  // namespace

// Plain C entry points (bound with ctypes). `offsets` holds N_FIELDS
// column offsets in gs_math.PACK_FIELDS order; the rhs-relinearization
// entries are not read. Each returns cudaGetLastError() after its launch;
// 1000 for an unsupported p_max.

// One rung: rows [0, L) from separate, strided inputs.
extern "C" int gs_math_block_launch(
    int p_max, int L, const float* win, int ld_win, int kstage,
    const int* offsets, const float* cfm, int ld_cfm, const float* n_rhs,
    int ld_nr, const float* t_rhs, int ld_tr, const int64_t* nump,
    const uint8_t* active, const float* p1, int ld_p1, const float* p2,
    int ld_p2, const float* prev_n, int ld_pn, const float* prev_t,
    int ld_pt, float* new_n, float* new_t, float* d1, float* d2,
    void* stream) {
  if (L <= 0) return 0;
  Args a{};
  fill_common(a, win, ld_win, kstage, offsets, cfm, ld_cfm, n_rhs, ld_nr,
              t_rhs, ld_tr, nump);
  a.L = L;
  a.active = active;
  a.p1 = p1;
  a.ld_p1 = ld_p1;
  a.p2 = p2;
  a.ld_p2 = ld_p2;
  a.prev_n = prev_n;
  a.ld_pn = ld_pn;
  a.prev_t = prev_t;
  a.ld_pt = ld_pt;
  a.new_n = new_n;
  a.ld_nn = p_max;
  a.new_t = new_t;
  a.ld_nt = p_max * S;
  a.d1 = d1;
  a.d2 = d2;
  const int rows = rows_per_chunk(p_max);
  return dispatch<false>(p_max, a, (L + rows - 1) / rows,
                         static_cast<cudaStream_t>(stream));
}

// A sweep (or one rung of it, by chunk0 / nchunks) over the plan's chunks,
// in place: `buf` the velocity buffer [rows, 6] (the chained stream, or
// the ladder's body table), `imp` the merged impulse matrix [C, P (1 + S)].
extern "C" int gs_math_block_sweep(
    int p_max, const int* chunks, const int* sides, unsigned* ready,
    unsigned* ticket, unsigned epoch, int chunk0, int nchunks,
    const float* win, int ld_win, int kstage, const int* offsets,
    const float* cfm, int ld_cfm, const float* n_rhs, int ld_nr,
    const float* t_rhs, int ld_tr, const int64_t* nump, float* buf,
    int ld_buf, float* imp, int ld_imp, void* stream) {
  if (nchunks <= 0) return 0;
  Args a{};
  fill_common(a, win, ld_win, kstage, offsets, cfm, ld_cfm, n_rhs, ld_nr,
              t_rhs, ld_tr, nump);
  a.prev_n = a.new_n = imp;
  a.prev_t = a.new_t = imp + p_max;
  a.ld_pn = a.ld_pt = a.ld_nn = a.ld_nt = ld_imp;
  a.sw = Sweep{reinterpret_cast<const int4*>(chunks),
               reinterpret_cast<const int4*>(sides), ready, ticket, epoch,
               chunk0, nchunks, buf, ld_buf};
  return dispatch<true>(p_max, a, nchunks, static_cast<cudaStream_t>(stream));
}

// The timestamps of the last traced sweep (gs_sweep.cuh).
extern "C" int gs_math_block_sweep_trace(void* dst, size_t bytes) {
  return copy_sweep_trace(dst, bytes);
}
