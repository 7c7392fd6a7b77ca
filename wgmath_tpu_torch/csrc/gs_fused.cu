// The fused Gauss-Seidel solver, CUDA C++ for sm_90a: kernels B10
// (fused_sweep), B11 (fused_substep1) and B12 (fused_integrate).
//
// Replaces the TPU kernels of wgmath_tpu/dynamics/gs_fused.py:
//   B10 _fused_sweep_pallas: one whole GS sweep over every colour window;
//   B11 _substep1_pallas:    impulses scaled by ws_coeff, the warmstart of
//                            every colour, then per colour the rhs rebuilt
//                            from the poses and the biased sweep;
//   B12 fused_integrate:     the component-major pose update (_cm_integrate).
// Their plain PyTorch versions are wgmath_tpu_torch/dynamics/gs_fused.py
// _fused_sweep_torch, _substep1_torch and _cm_integrate. The point update
// is gs_point_updates.cuh, shared with the ladder kernels B1 and B2.
//
// Layout (component-major, as on the TPU): velocities vt[8, Wg] (rows 0-2
// linear, 3-5 angular, one lane per body), poses [8, Wg] (quat, translation,
// scale), impulses [P, Ctot] and [P*S, Ctot], window fields win[K, Ctot]
// (row e of a field at column col is win[e * ld + col]). Colour c (0-based;
// the layout's colour c + 1) holds rows [off[c], off[c] + rung[c]); idx[c]
// gathers its a-sides at lanes [0, rung) and b-sides at [rung, 2 rung);
// inv[c][body] is the lane of the row that writes the body (a-side j,
// b-side rung + j) or anything >= 2 rung.
//
// Design. The TPU walks the colours in order inside one program with the
// velocity table in VMEM. Here one cooperative launch (every block
// resident, cudaLaunchCooperativeKernel sized by the occupancy query) walks
// the colours in order: within a colour the rows are grid-strided, one
// thread per row; between colours a grid-wide barrier. The velocity table
// (~320 KB at 10k bodies) stays in global memory and the 50 MB L2; its
// loads bypass L1 (ld.cg) because other blocks wrote it. The counts[c] > 0
// skip is read by every thread from the same word, so the barrier inside
// it is reached by every block or by none.
// The scatter is the TPU's inverse permutation applied from the row side:
// row j writes body b's lanes only where inv[c][b] == j (a-side) or
// rung + j (b-side). That test encodes valid, dynamic and in-colour, and
// picks one writer for a duplicate, so no two threads write one lane and no
// atomics are needed: two launches give the same bits. The written value
// is v + (w - v), the TPU's table add, not w.
// B11's warmstart runs lane-parallel: lane b adds, in ascending colour
// order, the delta of the row inv[c][b] names (the TPU's vt += _ws_color(k)
// for k = 1..C), so no barrier is needed between colours there.
//
// Bound on this card. B10 at the 10k pit (Ctot ~30k rows, P = 1, 13
// occupied colours): ~10 MB of field, impulse, index and velocity traffic,
// ~3 us at 3.35 TB/s; what limits it is the latency of the 14 grid
// barriers and of each colour's dependent gather -> update -> scatter
// chain. B11 reads about twice that (rhs sources, poses, the warmstart's
// field gathers). B12 moves 19 floats per lane (0.8 MB): its launch costs
// more than its bytes.
//
// No fast-math, built with --fmad=false (core/cuda_build.py): the rhs
// rebuild takes a millimetre drift from two world points ~20 m from the
// origin, and every sum is written in the plain version's order.

#include "gs_point_updates.cuh"

namespace {

using namespace gs;

constexpr int MAX_C = 64;
constexpr int THREADS = 256;
constexpr int ROWS = 8;
// source rows of the rhs rebuild (gs_fused.SRC_FIELDS)
enum Src { S_LOCAL_PT_A = 0, S_LOCAL_PT_B, S_INFO_DIST, S_INFO_NORMAL_VEL,
           S_T_RHS_WO_BIAS, N_SRC };

// rows of the point update's window block a thread keeps (the packed
// matrix's width at P = 1 and 4)
template <int P>
struct KMax;
template <>
struct KMax<1> {
  static constexpr int value = 66;
};
template <>
struct KMax<4> {
  static constexpr int value = 216;
};

struct FusedArgs {
  int n_colors, w_g, ctot, k_load;
  int off[MAX_C], rung[MAX_C];
  Offsets cols;
  int src[N_SRC];
  const float* vin;
  float* vout;
  const float* nin;
  int ld_n;
  const float* tin;
  int ld_t;
  float* nout;
  float* tout;
  float* nwo;
  const float* win;
  int ld_w;
  const float* srcm;
  int ld_s;
  const float* pose;
  const float* act;
  const float* nump;
  const float* nrhs;
  int ld_nr;
  const float* trhs;
  int ld_tr;
  const int* idx;
  const int* inv;
  const int* counts;
  float ws, cfm, inv_dt, erp_inv_dt, allowed, max_corr;
  unsigned int* bar;
};

// Grid-wide barrier over co-resident blocks: bar[0] counts arrivals,
// bar[1] is the generation. The last block to arrive resets the count and
// advances the generation; the others wait for it to move. Every barrier
// leaves bar[0] at 0, so the buffer serves the next launch as it is. A
// wait of seconds (no real barrier takes a millisecond) traps: a fault
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* vbar = bar;
    const unsigned int gen = vbar[1];
    __threadfence();
    if (atomicAdd(&bar[0], 1u) == gridDim.x - 1) {
      atomicExch(&bar[0], 0u);
      __threadfence();
      atomicAdd(&bar[1], 1u);
    } else {
      for (unsigned int spins = 0; vbar[1] == gen; ++spins) {
        __nanosleep(64);
        if (spins > (1u << 26)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// sim.mul_pt on a pose gathered from the [8, Wg] table at `lane`
__device__ __forceinline__ void mul_pt(const float* pose, int w_g, int lane,
                                       const float v[3], float out[3]) {
  const float ux = __ldg(pose + lane), uy = __ldg(pose + w_g + lane);
  const float uz = __ldg(pose + 2 * w_g + lane);
  const float w = __ldg(pose + 3 * w_g + lane);
  const float cx = uy * v[2] - uz * v[1];
  const float cy = uz * v[0] - ux * v[2];
  const float cz = ux * v[1] - uy * v[0];
  const float dx = uy * cz - uz * cy;
  const float dy = uz * cx - ux * cz;
  const float dz = ux * cy - uy * cx;
  const float s = __ldg(pose + 7 * w_g + lane);
  out[0] = s * (v[0] + 2.0f * (w * cx + dx)) + __ldg(pose + 4 * w_g + lane);
  out[1] = s * (v[1] + 2.0f * (w * cy + dy)) + __ldg(pose + 5 * w_g + lane);
  out[2] = s * (v[2] + 2.0f * (w * cz + dz)) + __ldg(pose + 6 * w_g + lane);
}

// One row of colour c: gather both sides, (B11: rebuild the rhs), the point
// update, the impulses out, the owned lanes' v + (w - v).
template <int P, bool SUBSTEP>
__device__ void sweep_row(const FusedArgs& a, int c, int j) {
  const int rung = a.rung[c];
  const int col = a.off[c] + j;
  const int* idx_row = a.idx + (size_t)c * a.w_g;
  const int* inv_row = a.inv + (size_t)c * a.w_g;
  const int ba = __ldg(idx_row + j);
  const int bb = __ldg(idx_row + rung + j);
  float v1l[3], v1a[3], v2l[3], v2a[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    v1l[q] = __ldcg(a.vout + (size_t)q * a.w_g + ba);
    v1a[q] = __ldcg(a.vout + (size_t)(3 + q) * a.w_g + ba);
    v2l[q] = __ldcg(a.vout + (size_t)q * a.w_g + bb);
    v2a[q] = __ldcg(a.vout + (size_t)(3 + q) * a.w_g + bb);
  }
  float fr[KMax<P>::value];
  for (int e = 0; e < a.k_load; ++e)
    fr[e] = __ldg(a.win + (size_t)e * a.ld_w + col);
  RowFields r;
  load_row_fields(fr, a.cols, r);
  const bool act = __ldg(a.act + col) > 0.5f;
  const float np_f = __ldg(a.nump + col);

  float pn[P], pt[P * S], n_rhs[P], t_rhs[P][S];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    pn[k] = __ldg(a.nin + (size_t)k * a.ld_n + col);
    if (SUBSTEP) pn[k] = pn[k] * a.ws;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      pt[k * S + s] = __ldg(a.tin + (size_t)(k * S + s) * a.ld_t + col);
      if (SUBSTEP) pt[k * S + s] = pt[k * S + s] * a.ws;
    }
  }
  if (SUBSTEP) {
    // the substep rhs relinearized from the poses (_rhs_color)
    const float* src = a.srcm + col;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float lpa[3], lpb[3], p1[3], p2[3], drift[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        lpa[e] = __ldg(src + (size_t)(a.src[S_LOCAL_PT_A] + 3 * k + e)
                       * a.ld_s);
        lpb[e] = __ldg(src + (size_t)(a.src[S_LOCAL_PT_B] + 3 * k + e)
                       * a.ld_s);
      }
      mul_pt(a.pose, a.w_g, ba, lpa, p1);
      mul_pt(a.pose, a.w_g, bb, lpb, p2);
#pragma unroll
      for (int e = 0; e < 3; ++e) drift[e] = p1[e] - p2[e];
      const float dist =
          __ldg(src + (size_t)(a.src[S_INFO_DIST] + k) * a.ld_s)
          + dot3(drift, r.dir);
      const float wo =
          __ldg(src + (size_t)(a.src[S_INFO_NORMAL_VEL] + k) * a.ld_s)
          + fmaxf(dist, 0.0f) * a.inv_dt;
      const float bias = fminf(fmaxf((dist + a.allowed) * a.erp_inv_dt,
                                     -a.max_corr), 0.0f);
      n_rhs[k] = wo + bias;
      a.nwo[(size_t)k * a.ctot + col] = wo;
#pragma unroll
      for (int s = 0; s < S; ++s)
        t_rhs[k][s] =
            __ldg(src + (size_t)(a.src[S_T_RHS_WO_BIAS] + S * k + s)
                  * a.ld_s)
            + dot3(drift, r.tang[s]) * a.inv_dt;
    }
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      n_rhs[k] = __ldg(a.nrhs + (size_t)k * a.ld_nr + col);
#pragma unroll
      for (int s = 0; s < S; ++s)
        t_rhs[k][s] = __ldg(a.trhs + (size_t)(k * S + s) * a.ld_tr + col);
    }
  }

  float w1l[3], w1a[3], w2l[3], w2a[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    w1l[q] = v1l[q];
    w1a[q] = v1a[q];
    w2l[q] = v2l[q];
    w2a[q] = v2a[q];
  }
  float on[P], ot[P * S];
  gs_point_updates<P>(fr, a.cols, r, act, np_f, a.cfm, n_rhs, t_rhs, pn, pt,
                      w1l, w1a, w2l, w2a, on, ot);
#pragma unroll
  for (int k = 0; k < P; ++k) a.nout[(size_t)k * a.ctot + col] = on[k];
#pragma unroll
  for (int k = 0; k < P * S; ++k) a.tout[(size_t)k * a.ctot + col] = ot[k];
  if (__ldg(inv_row + ba) == j) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      __stcg(a.vout + (size_t)q * a.w_g + ba, v1l[q] + (w1l[q] - v1l[q]));
      __stcg(a.vout + (size_t)(3 + q) * a.w_g + ba,
             v1a[q] + (w1a[q] - v1a[q]));
    }
  }
  if (__ldg(inv_row + bb) == rung + j) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      __stcg(a.vout + (size_t)q * a.w_g + bb, v2l[q] + (w2l[q] - v2l[q]));
      __stcg(a.vout + (size_t)(3 + q) * a.w_g + bb,
             v2a[q] + (w2a[q] - v2a[q]));
    }
  }
}

// B11's warmstart delta of one side of row `col` (_ws_color), from the
// scaled impulses: d[0:3] linear, d[3:6] angular.
template <int P>
__device__ __forceinline__ void ws_delta(const FusedArgs& a, int col,
                                         bool b_side, float d[6]) {
  const float* w = a.win + col;
  const size_t ld = a.ld_w;
  const Offsets& o = a.cols;
  float dir[3], im[3], tang[S][3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    dir[e] = __ldg(w + (o.o[F_DIR_A] + e) * ld);
    im[e] = __ldg(w + ((b_side ? o.o[F_IM_B] : o.o[F_IM_A]) + e) * ld);
#pragma unroll
    for (int s = 0; s < S; ++s)
      tang[s][e] = __ldg(w + (o.o[F_TANGENT_A] + 3 * s + e) * ld);
  }
  const int f_nii = b_side ? o.o[F_N_II_TORQUE_B] : o.o[F_N_II_TORQUE_A];
  const int f_tii = b_side ? o.o[F_T_II_TORQUE_B] : o.o[F_T_II_TORQUE_A];
  const bool active = __ldg(a.act + col) > 0.5f;
  const float np_f = __ldg(a.nump + col);
  float dl[3] = {0.0f, 0.0f, 0.0f}, da[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const bool m = active && (np_f > (float)k);
    const float imp =
        m ? __ldg(a.nin + (size_t)k * a.ld_n + col) * a.ws : 0.0f;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float lin = dir[e] * (im[e] * imp);
      dl[e] = b_side ? dl[e] - lin : dl[e] + lin;
      da[e] = da[e] + __ldg(w + (f_nii + 3 * k + e) * ld) * imp;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float timp =
          m ? __ldg(a.tin + (size_t)(k * S + s) * a.ld_t + col) * a.ws
            : 0.0f;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float lin = tang[s][e] * (im[e] * timp);
        dl[e] = b_side ? dl[e] - lin : dl[e] + lin;
        da[e] = da[e] + __ldg(w + (f_tii + (k * S + s) * 3 + e) * ld) * timp;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    d[e] = dl[e];
    d[3 + e] = da[e];
  }
}

template <int P, bool SUBSTEP>
__global__ void __launch_bounds__(THREADS) fused_kernel(const FusedArgs a) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  if (SUBSTEP) {
    // impulses scaled, the rhs store cleared
    for (int i = tid; i < a.ctot; i += nth) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        a.nout[(size_t)k * a.ctot + i] =
            __ldg(a.nin + (size_t)k * a.ld_n + i) * a.ws;
        a.nwo[(size_t)k * a.ctot + i] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < P * S; ++k)
        a.tout[(size_t)k * a.ctot + i] =
            __ldg(a.tin + (size_t)k * a.ld_t + i) * a.ws;
    }
    // the warmstart of every colour, lane by lane in colour order
    for (int b = tid; b < a.w_g; b += nth) {
      float v[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS; ++q)
        v[q] = __ldg(a.vin + (size_t)q * a.w_g + b);
      for (int c = 0; c < a.n_colors; ++c) {
        if (__ldg(a.counts + c + 1) <= 0) continue;
        const int rung = a.rung[c];
        const int jj = __ldg(a.inv + (size_t)c * a.w_g + b);
        if (jj < 0 || jj >= 2 * rung) continue;  // a zero lane of the table
        const bool b_side = jj >= rung;
        float d[6];
        ws_delta<P>(a, a.off[c] + (b_side ? jj - rung : jj), b_side, d);
#pragma unroll
        for (int q = 0; q < 6; ++q) v[q] = v[q] + d[q];
      }
#pragma unroll
      for (int q = 0; q < ROWS; ++q) a.vout[(size_t)q * a.w_g + b] = v[q];
    }
  } else {
    for (int i = tid; i < ROWS * a.w_g; i += nth) a.vout[i] = __ldg(a.vin + i);
    for (int i = tid; i < a.ctot; i += nth) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        a.nout[(size_t)k * a.ctot + i] = __ldg(a.nin + (size_t)k * a.ld_n + i);
#pragma unroll
      for (int k = 0; k < P * S; ++k)
        a.tout[(size_t)k * a.ctot + i] = __ldg(a.tin + (size_t)k * a.ld_t + i);
    }
  }
  grid_sync(a.bar);
  for (int c = 0; c < a.n_colors; ++c) {
    // uniform: every thread reads the same count
    if (__ldg(a.counts + c + 1) <= 0) continue;
    for (int j = tid; j < a.rung[c]; j += nth) sweep_row<P, SUBSTEP>(a, c, j);
    grid_sync(a.bar);
  }
}

template <int P, bool SUBSTEP>
int launch_fused(const FusedArgs& a, int* grid_out, cudaStream_t stream) {
  if (a.k_load > KMax<P>::value) return 1001;
  auto kern = fused_kernel<P, SUBSTEP>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return 1002;
  if (per_sm < 1) return 1003;
  int max_rung = 1;
  for (int c = 0; c < a.n_colors; ++c)
    max_rung = a.rung[c] > max_rung ? a.rung[c] : max_rung;
  const int work = max_rung > a.w_g ? max_rung : a.w_g;
  int grid = (work + THREADS - 1) / THREADS;
  if (grid > per_sm * sms) grid = per_sm * sms;
  FusedArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kern,
                                    dim3(grid), dim3(THREADS), params, 0,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid_out = grid;
  return static_cast<int>(cudaGetLastError());
}

int fill_layout(FusedArgs& a, int n_colors, const int* win_tab, int w_g,
                int ctot, int k_load, const int* cols) {
  if (n_colors <= 0 || n_colors > MAX_C) return 1000;
  a.n_colors = n_colors;
  a.w_g = w_g;
  a.ctot = ctot;
  a.k_load = k_load;
  for (int c = 0; c < n_colors; ++c) {
    a.off[c] = win_tab[c];
    a.rung[c] = win_tab[n_colors + c];
  }
  for (int f = 0; f < N_FIELDS; ++f) a.cols.o[f] = cols[f];
  return 0;
}

__global__ void __launch_bounds__(THREADS) integrate_kernel(
    int L, const float* __restrict__ pose, const float* __restrict__ vt,
    const float* __restrict__ com, float* __restrict__ out, float dt) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float q[4], t[3], lin[3], ang[3], c[3];
#pragma unroll
  for (int e = 0; e < 4; ++e) q[e] = pose[(size_t)e * L + l];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    t[e] = pose[(size_t)(4 + e) * L + l];
    lin[e] = vt[(size_t)e * L + l];
    ang[e] = vt[(size_t)(3 + e) * L + l];
    c[e] = com[(size_t)e * L + l];
  }
  const float s = pose[(size_t)7 * L + l];
  // rot(q, v) = v + 2 (w (u x v) + u x (u x v))
  auto rot = [](const float* u, float w, const float* v, float* o) {
    const float cx = u[1] * v[2] - u[2] * v[1];
    const float cy = u[2] * v[0] - u[0] * v[2];
    const float cz = u[0] * v[1] - u[1] * v[0];
    const float dx = u[1] * cz - u[2] * cy;
    const float dy = u[2] * cx - u[0] * cz;
    const float dz = u[0] * cy - u[1] * cx;
    o[0] = v[0] + 2.0f * (w * cx + dx);
    o[1] = v[1] + 2.0f * (w * cy + dy);
    o[2] = v[2] + 2.0f * (w * cz + dz);
  };
  float rc[3], init_com[3], v[3];
  rot(q, q[3], c, rc);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    init_com[e] = s * rc[e] + t[e];
    v[e] = ang[e] * dt;
  }
  const float angle = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  const float half = 0.5f * angle;
  const float sinc_half = angle < 1e-6f
                              ? 0.5f - angle * angle / 48.0f
                              : sinf(half) / fmaxf(angle, 1e-30f);
  const float dq[4] = {v[0] * sinc_half, v[1] * sinc_half, v[2] * sinc_half,
                       cosf(half)};
  float arm[3], rotated[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) arm[e] = t[e] - init_com[e];
  rot(dq, dq[3], arm, rotated);
  const float ax = dq[0], ay = dq[1], az = dq[2], aw = dq[3];
  const float bx = q[0], by = q[1], bz = q[2], bw = q[3];
  float nq[4] = {aw * bx + ax * bw + ay * bz - az * by,
                 aw * by - ax * bz + ay * bw + az * bx,
                 aw * bz + ax * by - ay * bx + az * bw,
                 aw * bw - ax * bx - ay * by - az * bz};
  const float inv_n = rsqrtf(nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2]
                             + nq[3] * nq[3] + 1e-30f);
#pragma unroll
  for (int e = 0; e < 4; ++e) out[(size_t)e * L + l] = nq[e] * inv_n;
#pragma unroll
  for (int e = 0; e < 3; ++e)
    out[(size_t)(4 + e) * L + l] = init_com[e] + rotated[e] * s + lin[e] * dt;
  out[(size_t)7 * L + l] = s;
}

}  // namespace

// Plain C entry points (bound with ctypes). win_tab: the colours' first
// rows, then their rungs; cols: the point update's field rows
// (gs_point_updates.cuh Field order, -1 for an absent field); bar: the two
// barrier counters (zero before the first launch on the device). Each
// returns cudaGetLastError() after the launch, or 1000 for an unsupported
// p_max / colour count, 1001 for a window block wider than the kernel
// keeps, 1002 for a device without cooperative launch, 1003 for a kernel
// that fits no block on an SM. grid_out receives the launch's block count.

extern "C" int fused_sweep_launch(
    int p_max, int n_colors, const int* win_tab, int w_g, int ctot,
    int k_load, const int* cols, const float* vin, float* vout,
    const float* nin, int ld_n, const float* tin, int ld_t, float* nout,
    float* tout, const float* win, int ld_w, const float* act,
    const float* nump, float cfm, const float* nrhs, int ld_nr,
    const float* trhs, int ld_tr, const int* idx, const int* inv,
    const int* counts, unsigned int* bar, int* grid_out, void* stream) {
  FusedArgs a = {};
  const int bad = fill_layout(a, n_colors, win_tab, w_g, ctot, k_load, cols);
  if (bad) return bad;
  a.vin = vin;
  a.vout = vout;
  a.nin = nin;
  a.ld_n = ld_n;
  a.tin = tin;
  a.ld_t = ld_t;
  a.nout = nout;
  a.tout = tout;
  a.win = win;
  a.ld_w = ld_w;
  a.act = act;
  a.nump = nump;
  a.cfm = cfm;
  a.nrhs = nrhs;
  a.ld_nr = ld_nr;
  a.trhs = trhs;
  a.ld_tr = ld_tr;
  a.idx = idx;
  a.inv = inv;
  a.counts = counts;
  a.bar = bar;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_max == 1) return launch_fused<1, false>(a, grid_out, s);
  if (p_max == 4) return launch_fused<4, false>(a, grid_out, s);
  return 1000;
}

extern "C" int fused_substep1_launch(
    int p_max, int n_colors, const int* win_tab, int w_g, int ctot,
    int k_load, const int* cols, const int* src_cols, const float* vin,
    float* vout, const float* nin, int ld_n, const float* tin, int ld_t,
    float* nout, float* tout, float* nwo, const float* win, int ld_w,
    const float* srcm, int ld_s, const float* pose, const float* act,
    const float* nump, const int* idx, const int* inv, const int* counts,
    float ws, float cfm, float inv_dt, float erp_inv_dt, float allowed,
    float max_corr, unsigned int* bar, int* grid_out, void* stream) {
  FusedArgs a = {};
  const int bad = fill_layout(a, n_colors, win_tab, w_g, ctot, k_load, cols);
  if (bad) return bad;
  for (int f = 0; f < N_SRC; ++f) a.src[f] = src_cols[f];
  a.vin = vin;
  a.vout = vout;
  a.nin = nin;
  a.ld_n = ld_n;
  a.tin = tin;
  a.ld_t = ld_t;
  a.nout = nout;
  a.tout = tout;
  a.nwo = nwo;
  a.win = win;
  a.ld_w = ld_w;
  a.srcm = srcm;
  a.ld_s = ld_s;
  a.pose = pose;
  a.act = act;
  a.nump = nump;
  a.idx = idx;
  a.inv = inv;
  a.counts = counts;
  a.ws = ws;
  a.cfm = cfm;
  a.inv_dt = inv_dt;
  a.erp_inv_dt = erp_inv_dt;
  a.allowed = allowed;
  a.max_corr = max_corr;
  a.bar = bar;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_max == 1) return launch_fused<1, true>(a, grid_out, s);
  if (p_max == 4) return launch_fused<4, true>(a, grid_out, s);
  return 1000;
}

extern "C" int fused_integrate_launch(int L, const float* pose,
                                      const float* vt, const float* com,
                                      float* out, float dt, void* stream) {
  if (L <= 0) return 0;
  const int blocks = (L + THREADS - 1) / THREADS;
  integrate_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      L, pose, vt, com, out, dt);
  return static_cast<int>(cudaGetLastError());
}
