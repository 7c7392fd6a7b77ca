// Fused contact -> constraint build, CUDA C++ for sm_90a (kernel B9).
//
// Replaces the TPU kernel wgmath_tpu/dynamics/build_pallas.py
// _build_pallas_call (reached through build_constraints_fused). Computes
// exactly its _cm_build, whose plain PyTorch version is
// wgmath_tpu_torch/dynamics/build_fused.py _cm_build: for each constraint
// the force direction, the friction basis (the tangential relative
// velocity, or an orthonormal fallback under 1e-4), and per contact point
// the torque arms, inverse-inertia products, effective masses, the rhs
// without bias and both local anchors.
//
// Layout: one thread per constraint i. It gathers both bodies' rows of the
// packed body table (packed[N, 32]: rotation 4, translation 3, scale 1,
// linear 3, angular 3, inv_mass 3, inv_inertia 9, com 3, then 3 zeros)
// itself, which the TPU version does outside the kernel as a [2C, 29]
// gather, and writes its column of bigT[K, C]: row (rows[field] + e) holds
// component e of the field. Neighbouring threads write neighbouring
// addresses of each row, so every store is coalesced. No atomics, no
// shared memory.
//
// Bound on this card: memory. Per constraint it reads 2 x 29 body floats,
// 2 ids and 4P + 3 contact floats, and writes K floats (71 at P = 1):
// about 440 B, against about 400 flops at P = 1. The writes, the larger
// part, are coalesced. What the design does about the rest:
// - a body row is 128 B at a 128-B boundary (the padding), read as 8
//   16-byte loads from one line; a 29-float row at 4-byte alignment took
//   29 scalar loads across two lines;
// - both ids are loaded first, then the contact fields, which do not wait
//   on them, and both rows' 16 loads together, before any arithmetic:
//   the two gathers are one dependent step;
// - the contact fields are read in place, by row stride: the compaction
//   leaves normal and points as column views of one gathered matrix, and
//   copying them made two more kernels a step;
// - the block size is chosen at the first launch from the occupancy the
//   kernel's register count allows: the largest of 256, 128 and 64 whose
//   grid gives every SM a block and of which every SM holds at least 16
//   warps (256 left 14 of 132 SMs idle at the pit's 30,080 rows).
// The stores are plain: bigT is read by the solver's kernels next, from L2.
//
// No fast-math, built with --fmad=false (core/cuda_build.py): the
// fallback-tangent test (|t| < 1e-4) and safe_inv's zero test must take
// the branch the plain version takes, and every sum is written in the
// plain version's order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the rows of bigT, in the order of build_fused.F32_SORT_FIELDS
enum Out {
  O_DIR_A = 0, O_TANGENT_A, O_IM_A, O_IM_B, O_LIMIT, O_N_TORQUE_A,
  O_N_TORQUE_B, O_N_II_TORQUE_A, O_N_II_TORQUE_B, O_N_R, O_T_TORQUE_A,
  O_T_TORQUE_B, O_T_II_TORQUE_A, O_T_II_TORQUE_B, O_T_R, O_LOCAL_PT_A,
  O_LOCAL_PT_B, O_INFO_DIST, O_INFO_NORMAL_VEL, O_T_RHS_WO_BIAS,
  O_CFM_FACTOR, O_N_RHS, O_T_RHS, O_N_RHS_WO_BIAS, N_OUT
};

struct Rows {
  int r[N_OUT];
};

struct Consts {
  float restitution, inv_dt, friction, cfm;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(const float* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// rotate v by the xyzw quaternion (u, w): v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ V3 quat_rot(V3 u, float w, V3 v) {
  const V3 uv = cross(u, v);
  const V3 uuv = cross(u, uv);
  return {v.x + 2.0f * (w * uv.x + uuv.x), v.y + 2.0f * (w * uv.y + uuv.y),
          v.z + 2.0f * (w * uv.z + uuv.z)};
}

// row-major 3x3 inverse inertia times v
__device__ __forceinline__ V3 ii_mul(const float* ii, V3 v) {
  return {ii[0] * v.x + ii[1] * v.y + ii[2] * v.z,
          ii[3] * v.x + ii[4] * v.y + ii[5] * v.z,
          ii[6] * v.x + ii[7] * v.y + ii[8] * v.z};
}

__device__ __forceinline__ V3 orthonormal(V3 v) {
  const float sign = v.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + v.z);
  const float b = v.x * v.y * a;
  return {b, sign + v.y * v.y * a, -v.y};
}

__device__ __forceinline__ float safe_inv(float x) {
  return x == 0.0f ? 0.0f : 1.0f / x;
}

struct Writer {
  float* out;
  int c, i;
  const Rows& rows;
  __device__ __forceinline__ void put(int field, int e, float v) const {
    out[(size_t)(rows.r[field] + e) * c + i] = v;
  }
  __device__ __forceinline__ void put3(int field, int e, V3 v) const {
    put(field, e, v.x);
    put(field, e + 1, v.y);
    put(field, e + 2, v.z);
  }
};

constexpr int W = 32;  // floats a body row (29 and 3 zeros)

// One side's body, unpacked from its row's 8 float4 (SIDE_OFFS order).
struct Body {
  V3 u, tr, lin, ang, im, com;
  float w, sc, ii[9];
};

__device__ __forceinline__ Body unpack(const float4 (&r)[W / 4]) {
  Body b;
  b.u = {r[0].x, r[0].y, r[0].z};
  b.w = r[0].w;
  b.tr = {r[1].x, r[1].y, r[1].z};
  b.sc = r[1].w;
  b.lin = {r[2].x, r[2].y, r[2].z};
  b.ang = {r[2].w, r[3].x, r[3].y};
  b.im = {r[3].z, r[3].w, r[4].x};
  const float ii[9] = {r[4].y, r[4].z, r[4].w, r[5].x, r[5].y,
                       r[5].z, r[5].w, r[6].x, r[6].y};
#pragma unroll
  for (int e = 0; e < 9; ++e) b.ii[e] = ii[e];
  b.com = {r[6].z, r[6].w, r[7].x};
  return b;
}

template <int P>
__global__ void __launch_bounds__(256) build_fused_kernel(
    int C, const float4* __restrict__ packed,
    const int64_t* __restrict__ body_a, const int64_t* __restrict__ body_b,
    const float* __restrict__ normal, int ld_n,
    const float* __restrict__ points, int ld_p,
    const float* __restrict__ dist_in, int ld_d, Consts k, Rows rows,
    float* __restrict__ big) {
  constexpr int S = 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int64_t ia = __ldg(body_a + i), ib = __ldg(body_b + i);
  // the contact fields do not wait on the ids
  const V3 n = v3(normal + (size_t)i * ld_n);
  float dists[P];
  V3 pts[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    dists[p] = __ldg(dist_in + (size_t)i * ld_d + p);
    pts[p] = v3(points + (size_t)i * ld_p + 3 * p);
  }
  float4 ra[W / 4], rb[W / 4];
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    ra[q] = __ldg(packed + ia * (W / 4) + q);
    rb[q] = __ldg(packed + ib * (W / 4) + q);
  }
  const Body A = unpack(ra), B = unpack(rb);
  const V3 u1 = A.u, u2 = B.u;
  const float w1 = A.w, w2 = B.w;
  const V3 tr1 = A.tr, tr2 = B.tr;
  const float sc1 = A.sc, sc2 = B.sc;
  const V3 lin1 = A.lin, lin2 = B.lin;
  const V3 ang1 = A.ang, ang2 = B.ang;
  const V3 im1 = A.im, im2 = B.im;
  const float* ii1 = A.ii;
  const float* ii2 = B.ii;
  const V3 com1 = A.com, com2 = B.com;
  const Writer wr{big, C, i, rows};

  const V3 dir1 = neg(quat_rot(u1, w1, n));
  // friction basis (compute_tangent_contact_directions)
  const V3 rel = sub(lin1, lin2);
  const V3 t = sub(rel, scale(dot(dir1, rel), dir1));
  const float tn = sqrtf(dot(t, t));
  const float tn_c = fmaxf(tn, 1e-30f);
  const V3 t1 = tn < 1.0e-4f ? orthonormal(dir1)
                             : V3{t.x / tn_c, t.y / tn_c, t.z / tn_c};
  const V3 t2 = cross(dir1, t1);
  const V3 tang[S] = {t1, t2};
  const V3 imsum = add(im1, im2);

  wr.put3(O_DIR_A, 0, dir1);
  wr.put3(O_TANGENT_A, 0, t1);
  wr.put3(O_TANGENT_A, 3, t2);
  wr.put3(O_IM_A, 0, im1);
  wr.put3(O_IM_B, 0, im2);
  wr.put(O_LIMIT, 0, k.friction);
  wr.put(O_CFM_FACTOR, 0, k.cfm);
#pragma unroll
  for (int e = 0; e < P * S; ++e) {
    wr.put(O_T_RHS, e, 0.0f);
    wr.put(O_T_RHS_WO_BIAS, e, 0.0f);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float dist = dists[p];
    const V3 pt_k = pts[p];
    const float half_d = dist / 2.0f;
    const V3 pt_local = add(pt_k, V3{n.x * half_d, n.y * half_d,
                                     n.z * half_d});
    const V3 pt = add(scale(sc1, quat_rot(u1, w1, pt_local)), tr1);
    const V3 dp1 = sub(pt, com1);
    const V3 dp2 = sub(pt, com2);
    const V3 cvel1 = add(lin1, cross(ang1, dp1));
    const V3 cvel2 = add(lin2, cross(ang2, dp2));
    const V3 td1 = cross(dp1, dir1);
    const V3 td2 = cross(dp2, neg(dir1));
    const V3 iitd1 = ii_mul(ii1, td1);
    const V3 iitd2 = ii_mul(ii2, td2);
    const float proj_mass = safe_inv(dot(dir1, mul(imsum, dir1))
                                     + dot(iitd1, td1) + dot(iitd2, td2));
    const float rhs_wo_bias = k.restitution * dot(sub(cvel1, cvel2), dir1)
                              + fmaxf(dist, 0.0f) * k.inv_dt;
    wr.put3(O_N_TORQUE_A, 3 * p, td1);
    wr.put3(O_N_II_TORQUE_A, 3 * p, iitd1);
    wr.put3(O_N_TORQUE_B, 3 * p, td2);
    wr.put3(O_N_II_TORQUE_B, 3 * p, iitd2);
    wr.put(O_N_RHS, p, rhs_wo_bias);
    wr.put(O_N_RHS_WO_BIAS, p, rhs_wo_bias);
    wr.put(O_INFO_NORMAL_VEL, p, rhs_wo_bias);
    wr.put(O_N_R, p, proj_mass);
    wr.put(O_INFO_DIST, p, dist);

    V3 ttd1[S], ttd2[S], tii1[S], tii2[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      ttd1[j] = cross(dp1, tang[j]);
      ttd2[j] = cross(dp2, neg(tang[j]));
      tii1[j] = ii_mul(ii1, ttd1[j]);
      tii2[j] = ii_mul(ii2, ttd2[j]);
      const float r = dot(tang[j], mul(imsum, tang[j]))
                      + dot(tii1[j], ttd1[j]) + dot(tii2[j], ttd2[j]);
      wr.put(O_T_R, 3 * p + j, r);
      wr.put3(O_T_TORQUE_A, (p * S + j) * 3, ttd1[j]);
      wr.put3(O_T_TORQUE_B, (p * S + j) * 3, ttd2[j]);
      wr.put3(O_T_II_TORQUE_A, (p * S + j) * 3, tii1[j]);
      wr.put3(O_T_II_TORQUE_B, (p * S + j) * 3, tii2[j]);
    }
    const float r_cross = 2.0f * (dot(ttd1[0], tii1[1])
                                  + dot(ttd2[0], tii2[1]));
    wr.put(O_T_R, 3 * p + 2, r_cross);
    // both anchors in their body's frame: the conjugate rotation of the
    // world point, divided by the scale
    const V3 la = quat_rot(neg(u1), w1, sub(pt, tr1));
    const V3 lb = quat_rot(neg(u2), w2, sub(pt, tr2));
    wr.put3(O_LOCAL_PT_A, 3 * p, V3{la.x / sc1, la.y / sc1, la.z / sc1});
    wr.put3(O_LOCAL_PT_B, 3 * p, V3{lb.x / sc2, lb.y / sc2, lb.z / sc2});
  }
}

// The block size of kernel `kern` on the current device for C rows (see the
// design note), and the register count and warps an SM holds behind it.
struct Plan {
  int block, regs, warps_per_sm;
};

constexpr int BLOCKS[3] = {256, 128, 64};

// What the choice reads of a kernel on a device, asked once (ids past
// MAX_DEV are asked every launch).
struct Facts {
  bool known;
  int sms, regs, warps[3];  // warps an SM holds, a block of BLOCKS[b]
};
constexpr int MAX_DEV = 16;

template <typename K>
Plan plan_for(K kern, Facts (&cache)[MAX_DEV], int C) {
  int dev = 0;
  cudaGetDevice(&dev);
  Facts local = {};
  Facts& f = dev < MAX_DEV ? cache[dev] : local;
  if (!f.known) {
    cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncAttributes attr = {};
    cudaFuncGetAttributes(&attr, kern);
    f.regs = attr.numRegs;
    for (int b = 0; b < 3; ++b) {
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, BLOCKS[b],
                                                    0);
      f.warps[b] = per_sm * BLOCKS[b] / 32;
    }
    f.known = true;
  }
  for (int b = 0; b < 3; ++b)
    if ((C + BLOCKS[b] - 1) / BLOCKS[b] >= f.sms && f.warps[b] >= 16)
      return {BLOCKS[b], f.regs, f.warps[b]};
  return {BLOCKS[2], f.regs, f.warps[2]};
}

template <int P>
Facts g_facts[MAX_DEV];

template <int P>
int launch(int C, const float* packed, const int64_t* body_a,
           const int64_t* body_b, const float* normal, int ld_n,
           const float* points, int ld_p, const float* dist, int ld_d,
           const Consts& k, const Rows& r, float* big, cudaStream_t s) {
  const Plan plan = plan_for(build_fused_kernel<P>, g_facts<P>, C);
  const int blocks = (C + plan.block - 1) / plan.block;
  build_fused_kernel<P><<<blocks, plan.block, 0, s>>>(
      C, reinterpret_cast<const float4*>(packed), body_a, body_b, normal,
      ld_n, points, ld_p, dist, ld_d, k, r, big);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). packed: [N, 32] floats at a
// 16-byte boundary; normal, points, dist: the contact fields in place,
// each by its row stride in floats (ld_n, ld_p, ld_d; a point's three
// floats and the P points of a row contiguous). rows: the first row of
// each of the 24 fields in bigT. build_fused_launch returns
// cudaGetLastError() after the launch, 1000 for an unsupported p_max.
extern "C" int build_fused_launch(
    int p_max, int C, const float* packed, const int64_t* body_a,
    const int64_t* body_b, const float* normal, int ld_n,
    const float* points, int ld_p, const float* dist, int ld_d,
    float restitution, float inv_dt, float friction, float cfm,
    const int* rows, float* big, void* stream) {
  if (C <= 0) return 0;
  Rows r;
  for (int f = 0; f < N_OUT; ++f) r.r[f] = rows[f];
  const Consts k{restitution, inv_dt, friction, cfm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_max == 1)
    return launch<1>(C, packed, body_a, body_b, normal, ld_n, points, ld_p,
                     dist, ld_d, k, r, big, s);
  if (p_max == 4)
    return launch<4>(C, packed, body_a, body_b, normal, ld_n, points, ld_p,
                     dist, ld_d, k, r, big, s);
  return 1000;
}

// The launch plan build_fused_launch takes for C rows at p_max on the
// current device: out = {block size, registers a thread, warps an SM holds
// of that block}. Returns 1000 for an unsupported p_max.
extern "C" int build_fused_plan(int p_max, int C, int* out) {
  Plan p;
  if (p_max == 1)
    p = plan_for(build_fused_kernel<1>, g_facts<1>, C);
  else if (p_max == 4)
    p = plan_for(build_fused_kernel<4>, g_facts<4>, C);
  else
    return 1000;
  out[0] = p.block;
  out[1] = p.regs;
  out[2] = p.warps_per_sm;
  return static_cast<int>(cudaGetLastError());
}
