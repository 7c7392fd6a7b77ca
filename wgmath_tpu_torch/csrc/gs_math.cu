// Gauss-Seidel impulse math with the substep rhs rebuilt in kernel
// ("rhs-in-rung"), CUDA C++ for sm_90a: one launch for a whole sweep over
// the window ladder, or one launch for one rung.
//
// Replaces the TPU kernel wgmath_tpu/dynamics/gs_pallas.py
// _gs_math_rhs_pallas_call (reached through gs_math_block_rhs, which the
// TPU solve launches once per colour rung). Each row computes exactly
// _gs_math_rhs_xla: _cm_rhs (biased mode) then _cm_point_updates for P
// contact points with S = 2 friction directions. The point update is
// gs_point_updates.cuh, shared with gs_math_block.cu.
//
// Sweep (gs_math_rhs_sweep, the chained sweeps of chained_ps and
// chained_rr): one launch walks every rung of the ladder, as set out in
// gs_sweep.cuh. Row i of a chunk (constraint row r) reads its packed
// fields from shared memory, its previous impulses (and, unbiased, its
// stored rhs_wo_bias) from the merged impulse matrix and, biased, both
// bodies' poses from the pose table (which no sweep writes), and rebuilds
// its rhs, all before it waits; after both sides' writers released their
// stream rows it reads the two velocities, updates, and writes, for each
// side where the chain advances, the side's own stream row (v + (w - v)
// on the velocity columns), releases it, and then writes its new
// impulses (and rhs_wo, biased) into the impulse matrix in place. Every row of the rung's class
// writes its impulses (an inactive row returns its previous ones bit for
// bit); the window's slots past the class are not run at all, so they
// write nothing.
//
// One rung (gs_math_rhs_launch, the entry point gs_math_block_rhs): the
// same row math on separate inputs, every row of [0, L), writing new_n,
// new_t, d1 = w1 - v1, d2 = w2 - v2 and rhs_wo. Every input row has its
// own leading dimension, so the caller passes strided views.
//
// Bound on this card: the dependency chain, then memory. Per row (P = 1,
// biased) the sweep moves 66 packed f32, two 6-f32 stream rows and two
// 8-f32 poses read and up to two stream rows written, 3 impulse f32 and
// rhs_wo read and written, one i64 point count, two 16-byte side entries
// and the flags: about 550 B
// against about 300 flops, far below the H100's ~20 flop/B balance. A
// sweep's rows take ~6 us of memory time; what bounds it is the chain of
// rungs (13 deep on the 10k pit), each level a flag seen, two rows read,
// one update and a release (gs_sweep.cuh). The design takes the rungs'
// launches, and the torch gathers, copies and scatter-adds around them,
// out of that chain, and puts everything that does not depend on an
// earlier rung (the staged fields, the impulses, the poses and the whole
// rhs rebuild) before the wait.
//
// No fast-math: maybe_inv's 1e-20 test and the 1e-30 clamp must behave as
// in the reference. Built with --fmad=false (core/cuda_build.py): the rhs
// rebuild takes a millimetre drift as the difference of two world points
// ~20 m from the origin, and a fused multiply-add on either side moves it
// by ~1e-6, which inv_dt amplifies past the plain version's tolerance.

#include "gs_point_updates.cuh"
#include "gs_sweep.cuh"

namespace {

using namespace gs;

struct Consts {
  float inv_dt, erp_inv_dt, allowed, max_corr, cfm;
};

// Where one launch reads and writes. Per-row inputs and outputs are
// indexed by the constraint row with their own leading dimension; in a
// sweep prev_n / new_n (and prev_t / new_t) are the same columns of the
// impulse matrix, so none of them is __restrict__.
struct Args {
  int L;  // one rung: rows [0, L)
  const float* win;
  int ld_win, kstage;
  Offsets off;
  const int64_t* nump;
  const uint8_t* active;  // one rung
  const float* p1;        // one rung: both sides' velocity rows
  const float* p2;
  int ld_p1, ld_p2;
  const float* aux;  // biased, one rung: side-1 pose; unbiased: rhs_wo
  const float* pose2;  // biased, one rung: side-2 pose
  int ld_aux, ld_pose2;
  const float* poses;  // biased sweep: the body table's poses [n, 8]
  const float* prev_n;
  const float* prev_t;
  float* new_n;
  float* new_t;
  float* rhs_wo;  // biased
  int ld_pn, ld_pt, ld_nn, ld_nt, ld_rw;
  float* d1;  // one rung: [L, 6]
  float* d2;
  Sweep sw;
  Consts c;
};

// sim.mul_pt: scale * rot(q, v) + translation; pose = [x y z w, t, s]
__device__ __forceinline__ void mul_pt(const float* pose, const float* v,
                                       float* out) {
  const float ux = pose[0], uy = pose[1], uz = pose[2], w = pose[3];
  const float cx = uy * v[2] - uz * v[1];
  const float cy = uz * v[0] - ux * v[2];
  const float cz = ux * v[1] - uy * v[0];
  const float dx = uy * cz - uz * cy;
  const float dy = uz * cx - ux * cz;
  const float dz = ux * cy - uy * cx;
  out[0] = pose[7] * (v[0] + 2.0f * (w * cx + dx)) + pose[4];
  out[1] = pose[7] * (v[1] + 2.0f * (w * cy + dy)) + pose[5];
  out[2] = pose[7] * (v[2] + 2.0f * (w * cz + dz)) + pose[6];
}

template <int P, bool BIASED, bool SWEEP>
__global__ void __launch_bounds__(rows_per_chunk(P))
    gs_math_rhs_kernel(const Args a) {
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
  float pn[P], ptv[P * S], wo_in[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    pn[k] = a.prev_n[(size_t)i * a.ld_pn + k];
    if (!BIASED) wo_in[k] = a.aux[(size_t)i * a.ld_aux + k];
#pragma unroll
    for (int j = 0; j < S; ++j)
      ptv[k * S + j] = a.prev_t[(size_t)i * a.ld_pt + k * S + j];
  }
  // biased: both poses, in a sweep by body from the pose table (no sweep
  // writes it, so it is read before the wait)
  int4 ea{}, eb{};
  if (SWEEP) {
    ea = a.sw.sides[ch.z + t];
    eb = a.sw.sides[ch.w + t];
  }
  float q1[8], q2[8];
  if (BIASED) {
    const float* pose1 = SWEEP ? a.poses + (size_t)side_body(ea) * 8
                               : a.aux + (size_t)i * a.ld_aux;
    const float* pose2 = SWEEP ? a.poses + (size_t)side_body(eb) * 8
                               : a.pose2 + (size_t)i * a.ld_pose2;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      q1[q] = pose1[q];
      q2[q] = pose2[q];
    }
  }
  stage_wait();
  const unsigned lanes = __ballot_sync(0xffffffffu, live);
  if (!live) return;
  trace_mark<SWEEP>(ch.z + t, 1);
  const float* f = stage + t * pitch;
  RowFields r;
  load_row_fields(f, a.off, r);

  // substep rhs (biased: relinearized from the poses; unbiased: stored);
  // it needs no velocity, so it is built before the wait
  float n_rhs[P], t_rhs[P][S], wo_out[P];
  float cfm;
  if (BIASED) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float p1w[3], p2w[3], drift[3];
      mul_pt(q1, f + a.off.o[F_LOCAL_PT_A] + 3 * k, p1w);
      mul_pt(q2, f + a.off.o[F_LOCAL_PT_B] + 3 * k, p2w);
#pragma unroll
      for (int c = 0; c < 3; ++c) drift[c] = p1w[c] - p2w[c];
      const float dist = f[a.off.o[F_INFO_DIST] + k] + dot3(drift, r.dir);
      const float wo = f[a.off.o[F_INFO_NORMAL_VEL] + k]
                       + fmaxf(dist, 0.0f) * a.c.inv_dt;
      const float bias = fminf(fmaxf((dist + a.c.allowed) * a.c.erp_inv_dt,
                                     -a.c.max_corr), 0.0f);
      n_rhs[k] = wo + bias;
      wo_out[k] = wo;
#pragma unroll
      for (int j = 0; j < S; ++j)
        t_rhs[k][j] = f[a.off.o[F_T_RHS_WO_BIAS] + S * k + j]
                      + dot3(drift, r.tang[j]) * a.c.inv_dt;
    }
    cfm = a.c.cfm;
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      n_rhs[k] = wo_in[k];
#pragma unroll
      for (int j = 0; j < S; ++j)
        t_rhs[k][j] = f[a.off.o[F_T_RHS_WO_BIAS] + S * k + j];
    }
    cfm = 1.0f;
  }

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
    gs_point_updates<P>(f, a.off, r, act, np_f, cfm, n_rhs, t_rhs, pn, ptv,
                        w1l, w1a, w2l, w2a, nn, nt);
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
    if (BIASED) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        a.rhs_wo[(size_t)i * a.ld_rw + k] = wo_out[k];
    }
  };
  if (SWEEP)
    run_when_ready(a.sw, lanes, ea, eb, update);
  else
    update();
}

template <int P, bool BIASED, bool SWEEP>
int launch(const Args& a, int blocks, cudaStream_t s) {
  auto kernel = gs_math_rhs_kernel<P, BIASED, SWEEP>;
  const size_t smem = stage_bytes(P, a.kstage);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, rows_per_chunk(P), smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool SWEEP>
int dispatch(int p_max, bool biased, const Args& a, int blocks,
             cudaStream_t s) {
  if (p_max == 1)
    return biased ? launch<1, true, SWEEP>(a, blocks, s)
                  : launch<1, false, SWEEP>(a, blocks, s);
  if (p_max == 4)
    return biased ? launch<4, true, SWEEP>(a, blocks, s)
                  : launch<4, false, SWEEP>(a, blocks, s);
  return 1000;
}

void fill_fields(Args& a, const float* win, int ld_win, int kstage,
                 const int* offsets, const int64_t* nump) {
  a.win = win;
  a.ld_win = ld_win;
  a.kstage = kstage;
  for (int k = 0; k < N_FIELDS; ++k) a.off.o[k] = offsets[k];
  a.nump = nump;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns cudaGetLastError()
// after its launch; 1000 for an unsupported p_max.

// One rung: rows [0, L) from separate, strided inputs.
extern "C" int gs_math_rhs_launch(
    int p_max, int biased, int L, const float* win, int ld_win, int kstage,
    const int* offsets, const int64_t* nump, const uint8_t* active,
    const float* p1, int ld_p1, const float* p2, int ld_p2,
    const float* prev_n, int ld_pn, const float* prev_t, int ld_pt,
    const float* aux, int ld_aux, const float* pose2, int ld_pose2,
    float* new_n, float* new_t, float* d1, float* d2, float* rhs_wo,
    float inv_dt, float erp_inv_dt, float allowed, float max_corr,
    float cfm, void* stream) {
  if (L <= 0) return 0;
  Args a{};
  fill_fields(a, win, ld_win, kstage, offsets, nump);
  a.L = L;
  a.active = active;
  a.p1 = p1;
  a.ld_p1 = ld_p1;
  a.p2 = p2;
  a.ld_p2 = ld_p2;
  a.aux = aux;
  a.ld_aux = ld_aux;
  a.pose2 = pose2;
  a.ld_pose2 = ld_pose2;
  a.prev_n = prev_n;
  a.ld_pn = ld_pn;
  a.prev_t = prev_t;
  a.ld_pt = ld_pt;
  a.new_n = new_n;
  a.ld_nn = p_max;
  a.new_t = new_t;
  a.ld_nt = p_max * S;
  a.rhs_wo = rhs_wo;
  a.ld_rw = p_max;
  a.d1 = d1;
  a.d2 = d2;
  a.c = Consts{inv_dt, erp_inv_dt, allowed, max_corr, cfm};
  const int rows = rows_per_chunk(p_max);
  return dispatch<false>(p_max, biased != 0, a, (L + rows - 1) / rows,
                         static_cast<cudaStream_t>(stream));
}

// A sweep (or, for chunk0 / nchunks of one rung, one rung of it) over the
// plan's chunks, in place: `buf` the velocity stream (rows of 6 floats),
// `imp` the merged impulse matrix [C, P (1 + S) + P] whose last P columns
// hold rhs_wo_bias (written biased, read unbiased). `poses` [n, 8] the
// bodies' poses, read biased.
extern "C" int gs_math_rhs_sweep(
    int p_max, int biased, const int* chunks, const int* sides,
    unsigned* ready, unsigned* ticket, unsigned epoch, int chunk0,
    int nchunks, const float* win, int ld_win, int kstage,
    const int* offsets, const int64_t* nump, float* buf, int ld_buf,
    const float* poses, float* imp, int ld_imp, float inv_dt,
    float erp_inv_dt, float allowed, float max_corr, float cfm,
    void* stream) {
  if (nchunks <= 0) return 0;
  Args a{};
  fill_fields(a, win, ld_win, kstage, offsets, nump);
  const int pt = p_max * S;
  a.prev_n = a.new_n = imp;
  a.prev_t = a.new_t = imp + p_max;
  float* wo = imp + p_max + pt;
  a.aux = wo;
  a.rhs_wo = wo;
  a.ld_pn = a.ld_pt = a.ld_nn = a.ld_nt = a.ld_rw = a.ld_aux = ld_imp;
  a.poses = poses;
  a.sw = Sweep{reinterpret_cast<const int4*>(chunks),
               reinterpret_cast<const int4*>(sides), ready, ticket, epoch,
               chunk0, nchunks, buf, ld_buf};
  a.c = Consts{inv_dt, erp_inv_dt, allowed, max_corr, cfm};
  return dispatch<true>(p_max, biased != 0, a, nchunks,
                        static_cast<cudaStream_t>(stream));
}

// The timestamps of the last traced sweep (gs_sweep.cuh).
extern "C" int gs_math_rhs_sweep_trace(void* dst, size_t bytes) {
  return copy_sweep_trace(dst, bytes);
}
