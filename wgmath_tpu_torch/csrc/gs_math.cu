// Gauss-Seidel impulse update for one colour rung, with the substep rhs
// rebuilt in kernel ("rhs-in-rung"), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel wgmath_tpu/dynamics/gs_pallas.py
// _gs_math_rhs_pallas_call (reached through gs_math_block_rhs). Computes
// exactly _gs_math_rhs_xla: _cm_rhs (biased mode) then _cm_point_updates
// for P contact points with S = 2 friction directions.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Field {
  F_DIR_A = 0, F_TANGENT_A, F_IM_A, F_IM_B, F_LIMIT,
  F_N_TORQUE_A, F_N_TORQUE_B, F_N_II_TORQUE_A, F_N_II_TORQUE_B, F_N_R,
  F_T_TORQUE_A, F_T_TORQUE_B, F_T_II_TORQUE_A, F_T_II_TORQUE_B, F_T_R,
  F_LOCAL_PT_A, F_LOCAL_PT_B, F_INFO_DIST, F_INFO_NORMAL_VEL,
  F_T_RHS_WO_BIAS, N_FIELDS
};

struct Offsets {
  int o[N_FIELDS];
};

struct Consts {
  float inv_dt, erp_inv_dt, allowed, max_corr, cfm;
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

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
  constexpr int S = 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const float* f = win + (size_t)i * ld_win;

  float v1l[3], v1a[3], v2l[3], v2a[3];
  const float* r1 = p1 + (size_t)i * ld_p1;
  const float* r2 = p2 + (size_t)i * ld_p2;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v1l[a] = r1[a];
    v1a[a] = r1[3 + a];
    v2l[a] = r2[a];
    v2a[a] = r2[3 + a];
  }
  float dir[3], im_a[3], im_b[3], tang[S][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    dir[a] = f[off.o[F_DIR_A] + a];
    im_a[a] = f[off.o[F_IM_A] + a];
    im_b[a] = f[off.o[F_IM_B] + a];
#pragma unroll
    for (int j = 0; j < S; ++j) tang[j][a] = f[off.o[F_TANGENT_A] + 3 * j + a];
  }
  const float friction = f[off.o[F_LIMIT]];
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
      const float dist = f[off.o[F_INFO_DIST] + k] + dot3(drift, dir);
      const float wo = f[off.o[F_INFO_NORMAL_VEL] + k]
                       + fmaxf(dist, 0.0f) * c.inv_dt;
      const float bias = fminf(fmaxf((dist + c.allowed) * c.erp_inv_dt,
                                     -c.max_corr), 0.0f);
      n_rhs[k] = wo + bias;
      rhs_wo[(size_t)i * P + k] = wo;
#pragma unroll
      for (int j = 0; j < S; ++j)
        t_rhs[k][j] = f[off.o[F_T_RHS_WO_BIAS] + S * k + j]
                      + dot3(drift, tang[j]) * c.inv_dt;
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
  const float* pn = prev_n + (size_t)i * ld_pn;
  const float* ptr = prev_t + (size_t)i * ld_pt;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const bool pt_active = act && (np_f > (float)k);
    // normal part
    const float* td_a = f + off.o[F_N_TORQUE_A] + 3 * k;
    const float* td_b = f + off.o[F_N_TORQUE_B] + 3 * k;
    const float* iitd_a = f + off.o[F_N_II_TORQUE_A] + 3 * k;
    const float* iitd_b = f + off.o[F_N_II_TORQUE_B] + 3 * k;
    const float r = f[off.o[F_N_R] + k];
    const float prev = pn[k];
    const float dvel = dot3(dir, w1l) + dot3(td_a, w1a) - dot3(dir, w2l)
                       + dot3(td_b, w2a) + n_rhs[k];
    const float cand = cfm * fmaxf(prev - r * dvel, 0.0f);
    const float new_imp = pt_active ? cand : prev;
    const float d_imp = new_imp - prev;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      w1l[a] = w1l[a] + dir[a] * (im_a[a] * d_imp);
      w1a[a] = w1a[a] + iitd_a[a] * d_imp;
      w2l[a] = w2l[a] - dir[a] * (im_b[a] * d_imp);
      w2a[a] = w2a[a] + iitd_b[a] * d_imp;
    }
    const float limit = new_imp * friction;
    new_n[(size_t)i * P + k] = new_imp;

    // tangent (friction) part, S = 2, coupled 2x2 projection
    const float* t_r = f + off.o[F_T_R] + 3 * k;
    const float* ta0 = f + off.o[F_T_TORQUE_A] + (k * S + 0) * 3;
    const float* ta1 = f + off.o[F_T_TORQUE_A] + (k * S + 1) * 3;
    const float* tb0 = f + off.o[F_T_TORQUE_B] + (k * S + 0) * 3;
    const float* tb1 = f + off.o[F_T_TORQUE_B] + (k * S + 1) * 3;
    const float* ia0 = f + off.o[F_T_II_TORQUE_A] + (k * S + 0) * 3;
    const float* ia1 = f + off.o[F_T_II_TORQUE_A] + (k * S + 1) * 3;
    const float* ib0 = f + off.o[F_T_II_TORQUE_B] + (k * S + 0) * 3;
    const float* ib1 = f + off.o[F_T_II_TORQUE_B] + (k * S + 1) * 3;
    const float tp0 = ptr[k * S + 0];
    const float tp1 = ptr[k * S + 1];
    const float dd0 = dot3(tang[0], w1l) + dot3(ta0, w1a) - dot3(tang[0], w2l)
                      + dot3(tb0, w2a) + t_rhs[k][0];
    const float dd1 = dot3(tang[1], w1l) + dot3(ta1, w1a) - dot3(tang[1], w2l)
                      + dot3(tb1, w2a) + t_rhs[k][1];
    const float d00 = dd0 * dd0, d11 = dd1 * dd1, d01 = dd0 * dd1;
    const float lhs = d00 * t_r[0] + d11 * t_r[1] + d01 * t_r[2];
    const bool ok = fabsf(lhs) > 1e-20f;
    const float inv_lhs = (d00 + d11) * (ok ? 1.0f / lhs : 0.0f);
    const float raw0 = tp0 - inv_lhs * dd0;
    const float raw1 = tp1 - inv_lhs * dd1;
    const float nrm = sqrtf(raw0 * raw0 + raw1 * raw1);
    const float scale = nrm > limit ? limit / fmaxf(nrm, 1e-30f) : 1.0f;
    const float t0n = pt_active ? raw0 * scale : tp0;
    const float t1n = pt_active ? raw1 * scale : tp1;
    const float dl0 = t0n - tp0;
    const float dl1 = t1n - tp1;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float lin_dir = tang[0][a] * dl0 + tang[1][a] * dl1;
      w1l[a] = w1l[a] + lin_dir * im_a[a];
      w1a[a] = w1a[a] + ia0[a] * dl0 + ia1[a] * dl1;
      w2l[a] = w2l[a] - lin_dir * im_b[a];
      w2a[a] = w2a[a] + ib0[a] * dl0 + ib1[a] * dl1;
    }
    new_t[((size_t)i * P + k) * S + 0] = t0n;
    new_t[((size_t)i * P + k) * S + 1] = t1n;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    d1[(size_t)i * 6 + a] = w1l[a] - v1l[a];
    d1[(size_t)i * 6 + 3 + a] = w1a[a] - v1a[a];
    d2[(size_t)i * 6 + a] = w2l[a] - v2l[a];
    d2[(size_t)i * 6 + 3 + a] = w2a[a] - v2a[a];
  }
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
