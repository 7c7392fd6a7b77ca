// The Gauss-Seidel point update shared by the two impulse kernels of one
// colour rung: gs_math.cu (substep rhs rebuilt in kernel) and
// gs_math_block.cu (cfm, n_rhs and t_rhs passed in). Both include this
// header, so the two kernels cannot drift apart.
//
// gs_point_updates is a transcription of _cm_point_updates
// (wgmath_tpu/dynamics/gs_pallas.py) for P contact points and S = 2
// friction directions, one constraint row per thread: for each point the
// normal impulse (projected on >= 0, scaled by cfm), then the coupled 2x2
// friction projection capped at limit = new_n * friction. Both sides'
// velocities w1l/w1a/w2l/w2a are updated in place after every impulse, so
// later points see earlier ones (the Gauss-Seidel order within a row).
//
// No fast-math, and the sources are built without multiply-add contraction
// (core/cuda_build.py): maybe_inv's |lhs| > 1e-20 test and the 1e-30 clamp
// behave as in the reference, and an inactive point returns its previous
// impulses bit for bit (a select, not a multiply by a mask).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gs {

// columns of the packed substep-invariant field matrix, in the order of
// gs_math.PACK_FIELDS; the offsets come from the caller's layout map
enum Field {
  F_DIR_A = 0, F_TANGENT_A, F_IM_A, F_IM_B, F_LIMIT,
  F_N_TORQUE_A, F_N_TORQUE_B, F_N_II_TORQUE_A, F_N_II_TORQUE_B, F_N_R,
  F_T_TORQUE_A, F_T_TORQUE_B, F_T_II_TORQUE_A, F_T_II_TORQUE_B, F_T_R,
  // read by the rhs rebuild only (absent columns are passed as -1)
  F_LOCAL_PT_A, F_LOCAL_PT_B, F_INFO_DIST, F_INFO_NORMAL_VEL,
  F_T_RHS_WO_BIAS, N_FIELDS
};

struct Offsets {
  int o[N_FIELDS];
};

constexpr int S = 2;

template <typename A, typename B>
__device__ __forceinline__ float dot3(const A& a, const B& b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// A row's fields STRIDE floats apart, indexed and offset like a pointer:
// what the fused kernels read from their column-major stage (a plain
// `const float*` is the packed row of the ladder kernels).
template <int STRIDE>
struct StridedRow {
  const float* p;
  __device__ __forceinline__ StridedRow operator+(int i) const {
    return {p + i * STRIDE};
  }
  __device__ __forceinline__ float operator[](int i) const {
    return p[i * STRIDE];
  }
};

// Row-shared fields every point of the row uses.
struct RowFields {
  float dir[3], im_a[3], im_b[3], tang[S][3];
  float friction;
};

template <typename Row>
__device__ __forceinline__ void load_row_fields(const Row& f,
                                                const Offsets& off,
                                                RowFields& r) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.dir[a] = f[off.o[F_DIR_A] + a];
    r.im_a[a] = f[off.o[F_IM_A] + a];
    r.im_b[a] = f[off.o[F_IM_B] + a];
#pragma unroll
    for (int j = 0; j < S; ++j)
      r.tang[j][a] = f[off.o[F_TANGENT_A] + 3 * j + a];
  }
  r.friction = f[off.o[F_LIMIT]];
}

// f: this row of the packed matrix (a pointer, or a StridedRow). act/np_f:
// the row's active flag and point count. cfm, n_rhs[P], t_rhs[P][S]: this
// substep's softness and right-hand sides. pn[P], pt[P*S]: previous
// impulses. out_n[P], out_t[P*S]: this row of the outputs.
template <int P, typename Row>
__device__ __forceinline__ void gs_point_updates(
    const Row& f, const Offsets& off, const RowFields& r, bool act,
    float np_f, float cfm, const float (&n_rhs)[P],
    const float (&t_rhs)[P][S], const float* pn, const float* pt,
    float (&w1l)[3], float (&w1a)[3], float (&w2l)[3], float (&w2a)[3],
    float* out_n, float* out_t) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const bool pt_active = act && (np_f > (float)k);
    // normal part
    const auto td_a = f + off.o[F_N_TORQUE_A] + 3 * k;
    const auto td_b = f + off.o[F_N_TORQUE_B] + 3 * k;
    const auto iitd_a = f + off.o[F_N_II_TORQUE_A] + 3 * k;
    const auto iitd_b = f + off.o[F_N_II_TORQUE_B] + 3 * k;
    const float nr = f[off.o[F_N_R] + k];
    const float prev = pn[k];
    const float dvel = dot3(r.dir, w1l) + dot3(td_a, w1a) - dot3(r.dir, w2l)
                       + dot3(td_b, w2a) + n_rhs[k];
    const float cand = cfm * fmaxf(prev - nr * dvel, 0.0f);
    const float new_imp = pt_active ? cand : prev;
    const float d_imp = new_imp - prev;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      w1l[a] = w1l[a] + r.dir[a] * (r.im_a[a] * d_imp);
      w1a[a] = w1a[a] + iitd_a[a] * d_imp;
      w2l[a] = w2l[a] - r.dir[a] * (r.im_b[a] * d_imp);
      w2a[a] = w2a[a] + iitd_b[a] * d_imp;
    }
    const float limit = new_imp * r.friction;
    out_n[k] = new_imp;

    // tangent (friction) part, S = 2, coupled 2x2 projection
    const auto t_r = f + off.o[F_T_R] + 3 * k;
    const auto ta0 = f + off.o[F_T_TORQUE_A] + (k * S + 0) * 3;
    const auto ta1 = f + off.o[F_T_TORQUE_A] + (k * S + 1) * 3;
    const auto tb0 = f + off.o[F_T_TORQUE_B] + (k * S + 0) * 3;
    const auto tb1 = f + off.o[F_T_TORQUE_B] + (k * S + 1) * 3;
    const auto ia0 = f + off.o[F_T_II_TORQUE_A] + (k * S + 0) * 3;
    const auto ia1 = f + off.o[F_T_II_TORQUE_A] + (k * S + 1) * 3;
    const auto ib0 = f + off.o[F_T_II_TORQUE_B] + (k * S + 0) * 3;
    const auto ib1 = f + off.o[F_T_II_TORQUE_B] + (k * S + 1) * 3;
    const float tp0 = pt[k * S + 0];
    const float tp1 = pt[k * S + 1];
    const float dd0 = dot3(r.tang[0], w1l) + dot3(ta0, w1a)
                      - dot3(r.tang[0], w2l) + dot3(tb0, w2a) + t_rhs[k][0];
    const float dd1 = dot3(r.tang[1], w1l) + dot3(ta1, w1a)
                      - dot3(r.tang[1], w2l) + dot3(tb1, w2a) + t_rhs[k][1];
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
      const float lin_dir = r.tang[0][a] * dl0 + r.tang[1][a] * dl1;
      w1l[a] = w1l[a] + lin_dir * r.im_a[a];
      w1a[a] = w1a[a] + ia0[a] * dl0 + ia1[a] * dl1;
      w2l[a] = w2l[a] - lin_dir * r.im_b[a];
      w2a[a] = w2a[a] + ib0[a] * dl0 + ib1[a] * dl1;
    }
    out_t[k * S + 0] = t0n;
    out_t[k * S + 1] = t1n;
  }
}

// Load both sides' [linear | angular] velocity rows, and write the deltas
// d = w - v of one side as a [6] row.
__device__ __forceinline__ void load_vel(const float* row, float (&l)[3],
                                         float (&a)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    l[q] = row[q];
    a[q] = row[3 + q];
  }
}

__device__ __forceinline__ void store_delta(float* row, const float (&wl)[3],
                                            const float (&wa)[3],
                                            const float (&vl)[3],
                                            const float (&va)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    row[q] = wl[q] - vl[q];
    row[3 + q] = wa[q] - va[q];
  }
}

}  // namespace gs
