// Gauss-Seidel impulse update for one colour rung, with the substep rhs
// rebuilt in kernel ("rhs-in-rung"), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel wgmath_tpu/dynamics/gs_pallas.py
// _gs_math_rhs_pallas_call (reached through gs_math_block_rhs). Computes
// exactly _gs_math_rhs_xla: _cm_rhs (biased mode) then _cm_point_updates
// for P contact points with S = 2 friction directions. The point update
// is gs_point_updates.cuh, shared with gs_math_block.cu.
//
// Layout: row-major, one constraint row per thread. Row i reads
//   win[i, 0:K]        packed substep-invariant fields (gs_math.PACK_FIELDS,
//                      column offsets passed in `offsets`),
//   p1/p2[i, 0:6]      both sides' linear|angular velocities,
//   prev_n[i, 0:P], prev_t[i, 0:P*S]   impulses of the previous iteration,
//   aux[i, :]          biased: side-1 pose [quat xyzw, translation, scale];
//                      unbiased: the stored rhs_wo_bias [P],
//   pose2[i, 0:8]      biased: side-2 pose,
// and writes new_n [L,P], new_t [L,P,S], d1/d2 [L,6], rhs_wo [L,P] (biased).
// Every input row has its own leading dimension, so the caller can pass
// strided views of its stream and impulse matrices without a copy. The
// kernel writes only its own rows: no atomics.
//
// Bound on this card: memory. Per row (P = 1, biased) it reads 66 packed
// f32 + 2x14 stream f32 + 3 impulse f32 + 1 i64 + 1 u8 (about 400 B) and
// writes 16 f32 (64 B), against about 300 flops: far below the H100's
// ~20 flop/B balance point. The design reads every field exactly once
// into registers and writes every output once; rows are independent, so
// the only lever left is coalescing (a component-major copy of the packed
// fields would make each field load one 128 B transaction per warp) and,
// since a rung is 128..5504 rows, launch overhead, which dominates at
// these sizes.
//
// No fast-math: maybe_inv's 1e-20 test and the 1e-30 clamp must behave as
// in the reference. Built with --fmad=false (core/cuda_build.py): the rhs
// rebuild takes a millimetre drift as the difference of two world points
// ~20 m from the origin, and a fused multiply-add on either side moves it
// by ~1e-6, which inv_dt amplifies past the plain version's tolerance.

#include "gs_point_updates.cuh"

namespace {

using namespace gs;

struct Consts {
  float inv_dt, erp_inv_dt, allowed, max_corr, cfm;
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

template <int P, bool BIASED>
__global__ void __launch_bounds__(256) gs_math_rhs_kernel(
    int L, const float* __restrict__ win, int ld_win, Offsets off,
    const int64_t* __restrict__ nump, const uint8_t* __restrict__ active,
    const float* __restrict__ p1, int ld_p1,
    const float* __restrict__ p2, int ld_p2,
    const float* __restrict__ prev_n, int ld_pn,
    const float* __restrict__ prev_t, int ld_pt,
    const float* __restrict__ aux, int ld_aux,
    const float* __restrict__ pose2, int ld_pose2,
    float* __restrict__ new_n, float* __restrict__ new_t,
    float* __restrict__ d1, float* __restrict__ d2,
    float* __restrict__ rhs_wo, Consts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const float* f = win + (size_t)i * ld_win;

  float v1l[3], v1a[3], v2l[3], v2a[3];
  load_vel(p1 + (size_t)i * ld_p1, v1l, v1a);
  load_vel(p2 + (size_t)i * ld_p2, v2l, v2a);
  RowFields r;
  load_row_fields(f, off, r);
  const bool act = active[i] != 0;
  const float np_f = (float)nump[i];

  // substep rhs (biased: relinearized from the poses; unbiased: stored)
  float n_rhs[P], t_rhs[P][S];
  float cfm;
  if (BIASED) {
    float pose1[8], pose2r[8];
    const float* a1 = aux + (size_t)i * ld_aux;
    const float* a2 = pose2 + (size_t)i * ld_pose2;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      pose1[q] = a1[q];
      pose2r[q] = a2[q];
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float p1w[3], p2w[3], drift[3];
      mul_pt(pose1, f + off.o[F_LOCAL_PT_A] + 3 * k, p1w);
      mul_pt(pose2r, f + off.o[F_LOCAL_PT_B] + 3 * k, p2w);
#pragma unroll
      for (int a = 0; a < 3; ++a) drift[a] = p1w[a] - p2w[a];
      const float dist = f[off.o[F_INFO_DIST] + k] + dot3(drift, r.dir);
      const float wo = f[off.o[F_INFO_NORMAL_VEL] + k]
                       + fmaxf(dist, 0.0f) * c.inv_dt;
      const float bias = fminf(fmaxf((dist + c.allowed) * c.erp_inv_dt,
                                     -c.max_corr), 0.0f);
      n_rhs[k] = wo + bias;
      rhs_wo[(size_t)i * P + k] = wo;
#pragma unroll
      for (int j = 0; j < S; ++j)
        t_rhs[k][j] = f[off.o[F_T_RHS_WO_BIAS] + S * k + j]
                      + dot3(drift, r.tang[j]) * c.inv_dt;
    }
    cfm = c.cfm;
  } else {
    const float* a1 = aux + (size_t)i * ld_aux;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      n_rhs[k] = a1[k];
#pragma unroll
      for (int j = 0; j < S; ++j)
        t_rhs[k][j] = f[off.o[F_T_RHS_WO_BIAS] + S * k + j];
    }
    cfm = 1.0f;
  }

  float w1l[3], w1a[3], w2l[3], w2a[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w1l[a] = v1l[a];
    w1a[a] = v1a[a];
    w2l[a] = v2l[a];
    w2a[a] = v2a[a];
  }
  gs_point_updates<P>(f, off, r, act, np_f, cfm, n_rhs, t_rhs,
                      prev_n + (size_t)i * ld_pn, prev_t + (size_t)i * ld_pt,
                      w1l, w1a, w2l, w2a, new_n + (size_t)i * P,
                      new_t + (size_t)i * P * S);
  store_delta(d1 + (size_t)i * 6, w1l, w1a, v1l, v1a);
  store_delta(d2 + (size_t)i * 6, w2l, w2a, v2l, v2a);
}

template <int P, bool BIASED>
void launch(int L, const float* win, int ld_win, const Offsets& off,
            const int64_t* nump, const uint8_t* active, const float* p1,
            int ld_p1, const float* p2, int ld_p2, const float* prev_n,
            int ld_pn, const float* prev_t, int ld_pt, const float* aux,
            int ld_aux, const float* pose2, int ld_pose2, float* new_n,
            float* new_t, float* d1, float* d2, float* rhs_wo,
            const Consts& c, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (L + threads - 1) / threads;
  gs_math_rhs_kernel<P, BIASED><<<blocks, threads, 0, stream>>>(
      L, win, ld_win, off, nump, active, p1, ld_p1, p2, ld_p2, prev_n, ld_pn,
      prev_t, ld_pt, aux, ld_aux, pose2, ld_pose2, new_n, new_t, d1, d2,
      rhs_wo, c);
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns cudaGetLastError() after
// the launch; 1000 for an unsupported (p_max, mode) pair.
extern "C" int gs_math_rhs_launch(
    int p_max, int biased, int L, const float* win, int ld_win,
    const int* offsets, const int64_t* nump, const uint8_t* active,
    const float* p1, int ld_p1, const float* p2, int ld_p2,
    const float* prev_n, int ld_pn, const float* prev_t, int ld_pt,
    const float* aux, int ld_aux, const float* pose2, int ld_pose2,
    float* new_n, float* new_t, float* d1, float* d2, float* rhs_wo,
    float inv_dt, float erp_inv_dt, float allowed, float max_corr,
    float cfm, void* stream) {
  if (L <= 0) return 0;
  Offsets off;
  for (int k = 0; k < N_FIELDS; ++k) off.o[k] = offsets[k];
  const Consts c{inv_dt, erp_inv_dt, allowed, max_corr, cfm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG_LAUNCH(PP, BB)                                                    \
  launch<PP, BB>(L, win, ld_win, off, nump, active, p1, ld_p1, p2, ld_p2,   \
                 prev_n, ld_pn, prev_t, ld_pt, aux, ld_aux, pose2, ld_pose2, \
                 new_n, new_t, d1, d2, rhs_wo, c, s)
  if (p_max == 1 && biased) {
    WG_LAUNCH(1, true);
  } else if (p_max == 1) {
    WG_LAUNCH(1, false);
  } else if (p_max == 4 && biased) {
    WG_LAUNCH(4, true);
  } else if (p_max == 4) {
    WG_LAUNCH(4, false);
  } else {
    return 1000;
  }
#undef WG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
