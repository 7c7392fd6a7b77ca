// The fused Gauss-Seidel solver, CUDA C++ for sm_90a: kernels B10
// (fused_sweep), B11 (fused_substep1) and B12 (fused_integrate).
//
// Replaces the TPU kernels of wgmath_tpu/dynamics/gs_fused.py:
//   B10 _fused_sweep_pallas: one whole GS sweep over every colour window;
//   B11 _substep1_pallas:    impulses scaled by ws_coeff, the warmstart of
//                            every colour, then per colour the rhs rebuilt
//                            from the poses and the biased sweep;
//   B12 fused_integrate:     the component-major pose update (_cm_integrate),
//                            carried by B10's opening on the step path.
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
// b-side rung + j) or anything >= 2 rung. A colour is occupied when its
// device count counts[c + 1] is positive; the others are not swept.
//
// Design. The TPU walks the colours in order inside one program with the
// velocity table in VMEM. Here one launch orders them with the readiness
// flags of gs_sweep.cuh, in place of a grid barrier. The work is cut into
// chunks, one thread a row (gs_sweep.cuh rows_per_chunk: R = 128 at P = 1,
// 32 at P = 4), which blocks take from an atomic ticket, one block a chunk
// (FusedArgs.first / open0 / delta0: the static layout's ticket table). B11
// takes its delta chunks, its opening, then each colour's chunks in colour
// order; B10 its colours, then its opening, on which nothing waits.
//   B11's delta chunks (DELTA_ROWS rows a thread): both warmstart deltas of
//     every colour row (_ws_color's per-row arithmetic on the scaled
//     impulses) from coalesced field reads into wsd, 32 bytes a side; each
//     chunk then adds one to `done`. Gathered by a lane from the field
//     matrix, a delta took ~26 scattered sectors.
//   The opening, thread t of chunk i on lane b = i R + t and residue row
//     i R + t: the residue rows' impulses copied (B11: scaled, rhs store
//     0); B10 copies vin to vout at rows 6-7 of every lane and at rows 0-5
//     of a lane no occupied colour writes; B11 waits until every delta
//     chunk is done (the one wait on a count), adds the deltas of the rows
//     inv[c][b] names in ascending colour order (the TPU's vt +=
//     _ws_color(k), k = 1..C), stores the lane's eight rows and releases
//     it at `base`. B10 launched with integrate operands (pose non-null)
//     also integrates lane b (integrate_lane, B12's one copy of the
//     arithmetic): the pose and COM rows loaded first, the velocities
//     the ones it copies, the new pose stored to pose_out. Nothing waits
//     on those stores, and no flag or ticket changes.
//   A colour whose count is 0: its chunks copy (B11: scale) its rows'
//     impulses. An occupied colour: its chunk stages the rows' window
//     block into shared memory by 16-byte cp.async (column-major, as the
//     block lies; a row reads its fields R floats apart) and, with that
//     copy in flight, loads all a row needs that no earlier colour writes:
//     idx, the inverse-permutation tests, act, nump, the impulses, the rhs
//     (B10) or the rhs sources and the pose gathers (B11), and the previous
//     writer of each side's body. B11 then rebuilds the rhs and stores it
//     without bias. (B11's colour chunks first pass the wait on the delta
//     count, so that the deltas' reads, level 0 of the chain, do not share
//     the memory with theirs.) Only then does a row wait; it loads both
//     velocity rows past L1, updates, writes the lanes it owns as v + (w -
//     v) (the TPU's table add), releases them, and stores its impulses.
// Flags: one a body lane, ready[b]. The row that writes body b in colour c
// stores base + c + 1 (B11's warmstart stores base), base = epoch (MAX_C +
// 1) with the epoch raised by the wrapper every launch, so the flags are
// never cleared; a poll is an acquire load. A side whose body an earlier
// occupied colour c' writes (the latest: inv[c'][b] names a row) waits for
// ready[b] in [base + c' + 1, base + MAX_C]; a body no earlier colour
// writes is read from vin without a wait in B10, and after the lane's
// warmstart (ready[b] in [base, base + MAX_C]) in B11. A flag a body rather
// than a side: the wait is found from the body alone, through the inv
// table the layout already has (loaded before the wait, no table of
// sides), and the flags are Wg words. A chunk waits only on lower tickets,
// so the lowest unfinished ticket always runs: no cooperative launch, no
// assumption on residency. A row that is inactive and owns no lane (the
// rung padding, on body 0) keeps its impulses whatever it reads (a
// select), so it neither waits nor reads velocities. Every output element
// is written by one row or lane, except the rows 0-5 of a lane some colour
// writes, which each colour writing it (after B11's warmstart) rewrites in
// order, each after acquiring the previous write. So two launches, and one
// launch against the same kernel launched colour by colour (one epoch, a
// ticket range a launch), give the same bits.
//
// Bound on this card. B10 at the 10k pit (Ctot ~30k rows, P = 1, 13
// occupied colours) moves ~9 MB of fields, impulses, indices and
// velocities, ~2.6 us at 3.35 TB/s; B11 ~3.0 us (rhs sources, poses, the
// warmstart's deltas). What bounds both is the chain of 13 dependent
// colours (B11: 14 levels with the warmstart): a level is a poll that sees
// the previous writer's release, two velocity loads from L2, the row's
// update and the release, ~3.5-4 us at the pit (scripts/exp_sweep_trace.py
// prints each level's marks). Everything else sits before the wait, so it
// overlaps the levels before its own. B12 moves 25 floats per lane (1 MB):
// its launch costs more than its bytes, so the step does not launch it: it
// reads only B11's velocities, the poses and the COMs, and B10 reads no
// pose, so B10's opening, which already holds every lane's B11 velocities
// and runs beside the colour chain, does its work. fused_integrate_launch
// keeps it as a kernel of its own for the public entry point. The precise
// sinf / cosf bring their slow range reduction, a 32-byte stack frame in
// B10, which costs it ~1.5 us inside the step whether or not a launch
// carries (scripts/exp_fused_integrate_step.py); the intrinsics would drop
// it but not keep the plain version's 2 ulp.
//
// No fast-math, built with --fmad=false (core/cuda_build.py): the rhs
// rebuild takes a millimetre drift from two world points ~20 m from the
// origin, and every sum is written in the plain version's order.

#include "gs_point_updates.cuh"
#include "gs_sweep.cuh"

namespace {

using namespace gs;

constexpr int MAX_C = 64;
constexpr int THREADS = 256;  // B12's block
constexpr int ROWS = 8;
constexpr int DELTA_ROWS = 4;  // rows a thread of B11's delta chunks
constexpr int DELTA_LD = 8;    // floats a side's delta takes in wsd
// source rows of the rhs rebuild (gs_fused.SRC_FIELDS)
enum Src { S_LOCAL_PT_A = 0, S_LOCAL_PT_B, S_INFO_DIST, S_INFO_NORMAL_VEL,
           S_T_RHS_WO_BIAS, N_SRC };

struct FusedArgs {
  int n_colors, w_g, ctot, k_load;
  int off[MAX_C], rung[MAX_C];
  int first[MAX_C + 1];  // colour c's chunks: tickets [first[c], first[c+1])
  int open0, open1;      // the opening's: [open0, open1)
  int delta0, delta1;    // B11's delta chunks: [delta0, delta1)
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
  const float* pose;   // B11: the rhs poses; B10: integrate (or null)
  const float* com;    // B10's integrate: [3, Wg] local COMs,
  float* pose_out;     // the new poses [8, Wg]
  float dt;
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
  unsigned* ready;   // [Wg] flags
  unsigned* ticket;  // 0 between launches
  unsigned base;     // epoch (MAX_C + 1)
  int chunk0, nchunks;  // this launch's tickets
  float* wsd;              // B11: [Ctot][2][DELTA_LD] warmstart deltas
  unsigned* done;          // B11: delta chunks done, never cleared
  unsigned done_target;    // its value once this launch's are done
};

__device__ __forceinline__ bool occupied(unsigned long long occ, int c) {
  return (occ >> c) & 1ull;
}

// The latest occupied colour before c whose inverse permutation names a
// row for body b (c = n_colors: the last over all colours), or -1.
__device__ __forceinline__ int prev_writer(const FusedArgs& a,
                                           unsigned long long occ, int c,
                                           int b) {
  int pw = -1;
#pragma unroll 4
  for (int cc = 0; cc < c; ++cc) {
    if (!occupied(occ, cc)) continue;
    const int jj = __ldg(a.inv + (size_t)cc * a.w_g + b);
    if (jj >= 0 && jj < 2 * a.rung[cc]) pw = cc;
  }
  return pw;
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

// B11's delta chunk i: both sides' warmstart deltas of colour rows
// [off[0] + i R DELTA_ROWS, ...) (every colour's rows, DELTA_ROWS a thread,
// coalesced) into wsd; then the chunk counts itself done (each thread's
// stores fenced, then one atomic).
template <int P>
__device__ __forceinline__ void delta_chunk(const FusedArgs& a, int i) {
  constexpr int R = rows_per_chunk(P);
  const int row0 = a.off[0] + i * R * DELTA_ROWS + threadIdx.x;
#pragma unroll
  for (int k = 0; k < DELTA_ROWS; ++k) {
    const int col = row0 + k * R;
    if (col >= a.ctot) break;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      float d[6];
      ws_delta<P>(a, col, side == 1, d);
      float4* dst = reinterpret_cast<float4*>(
          a.wsd + ((size_t)col * 2 + side) * DELTA_LD);
      dst[0] = make_float4(d[0], d[1], d[2], d[3]);
      dst[1] = make_float4(d[4], d[5], 0.0f, 0.0f);
    }
  }
  fence_gpu();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(a.done, 1u);
}

// Every thread of the block past the point where all of this launch's
// delta chunks are done (thread 0 polls with acquire loads; a count never
// reached traps, as a flag does).
__device__ __forceinline__ void await_deltas(const FusedArgs& a) {
  if (threadIdx.x == 0) {
    unsigned ns = 32, spins = 0;
    while (!flag_in<true>(a.done, a.done_target, 0x7fffffffu)) {
      if (++spins == kMaxSpins) __trap();
      __nanosleep(ns);
      if (ns < kSpinNsMax) ns *= 2;
    }
  }
  __syncthreads();
  fence_gpu();
}

// B12's operands of lane l besides its velocities: pose rows (quat xyzw,
// translation, scale) and local COM, from [8, L] and [3, L] tables.
struct LanePose {
  float q[4], t[3], s, c[3];
};

__device__ __forceinline__ LanePose load_lane_pose(const float* pose,
                                                   const float* com, int L,
                                                   int l) {
  LanePose p;
#pragma unroll
  for (int e = 0; e < 4; ++e) p.q[e] = __ldg(pose + (size_t)e * L + l);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    p.t[e] = __ldg(pose + (size_t)(4 + e) * L + l);
    p.c[e] = __ldg(com + (size_t)e * L + l);
  }
  p.s = __ldg(pose + (size_t)7 * L + l);
  return p;
}

// B12's lane: the semi-implicit Euler pose update (_cm_integrate) from the
// lane's linear and angular velocity, stored as rows of out [8, L]. The
// only copy of the arithmetic: the standalone kernel and B10's opening
// both call it, so the two give the same bits.
__device__ __forceinline__ void integrate_lane(const LanePose& p,
                                               const float* lin,
                                               const float* ang, float dt,
                                               float* out, int L, int l) {
  const float* q = p.q;
  const float* t = p.t;
  const float s = p.s;
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
  rot(q, q[3], p.c, rc);
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

// A row no sweep runs: its impulses copied (B11: scaled by ws_coeff, the
// rhs store cleared).
template <int P, bool SUBSTEP>
__device__ __forceinline__ void copy_row(const FusedArgs& a, int col) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float n = __ldg(a.nin + (size_t)k * a.ld_n + col);
    a.nout[(size_t)k * a.ctot + col] = SUBSTEP ? n * a.ws : n;
    if (SUBSTEP) a.nwo[(size_t)k * a.ctot + col] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < P * S; ++k) {
    const float t = __ldg(a.tin + (size_t)k * a.ld_t + col);
    a.tout[(size_t)k * a.ctot + col] = SUBSTEP ? t * a.ws : t;
  }
}

// The opening's lane b: B11 its warmstart, stored and released; B10 the
// rows of vout no colour writes and, with integrate operands, the lane's
// new pose.
template <int P, bool SUBSTEP>
__device__ __forceinline__ void open_lane(const FusedArgs& a,
                                          unsigned long long occ, int b) {
  const bool integrate = !SUBSTEP && a.pose != nullptr;
  LanePose p;
  if (integrate) p = load_lane_pose(a.pose, a.com, a.w_g, b);
  float v[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) v[q] = __ldg(a.vin + (size_t)q * a.w_g + b);
  if (SUBSTEP) {
    // the colours whose inverse permutation names a row for the lane (one
    // independent load each), then their rows' deltas a batch at a time
    // (the batch's loads in flight together), added in ascending colour
    // order
    unsigned long long named = 0;
#pragma unroll 8
    for (int c = 0; c < a.n_colors; ++c) {
      if (!occupied(occ, c)) continue;
      const int jj = __ldg(a.inv + (size_t)c * a.w_g + b);
      if (jj >= 0 && jj < 2 * a.rung[c]) named |= 1ull << c;
    }
    constexpr int NB = 4;
    while (named) {
      int cs[NB];
      bool has[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        has[k] = named != 0;
        cs[k] = has[k] ? __ffsll(static_cast<long long>(named)) - 1 : cs[0];
        named &= named - 1;
      }
      float4 d[NB][2];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int rung = a.rung[cs[k]];
        const int jj = __ldg(a.inv + (size_t)cs[k] * a.w_g + b);
        const bool b_side = jj >= rung;
        const float4* src = reinterpret_cast<const float4*>(
            a.wsd + ((size_t)(a.off[cs[k]] + (b_side ? jj - rung : jj)) * 2
                     + b_side) * DELTA_LD);
        d[k][0] = __ldcg(src);
        d[k][1] = __ldcg(src + 1);
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (!has[k]) continue;
        v[0] = v[0] + d[k][0].x;
        v[1] = v[1] + d[k][0].y;
        v[2] = v[2] + d[k][0].z;
        v[3] = v[3] + d[k][0].w;
        v[4] = v[4] + d[k][1].x;
        v[5] = v[5] + d[k][1].y;
      }
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) a.vout[(size_t)q * a.w_g + b] = v[q];
    release_flags(a.ready + b, nullptr, a.base);
  } else {
    const bool written = prev_writer(a, occ, a.n_colors, b) >= 0;
#pragma unroll
    for (int q = 0; q < ROWS; ++q)
      if (q >= 6 || !written) a.vout[(size_t)q * a.w_g + b] = v[q];
    if (integrate) integrate_lane(p, v, v + 3, a.dt, a.pose_out, a.w_g, b);
  }
}

// One side's velocities: zeros where they do not matter (!need), past L1
// from vout after the acquire (from_out), else from vin (B10, a body no
// earlier colour wrote).
__device__ __forceinline__ void read_side(const FusedArgs& a, int b,
                                          bool need, bool from_out,
                                          float (&l)[3], float (&an)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (!need) {
      l[q] = an[q] = 0.0f;
    } else if (from_out) {
      l[q] = __ldcg(a.vout + (size_t)q * a.w_g + b);
      an[q] = __ldcg(a.vout + (size_t)(3 + q) * a.w_g + b);
    } else {
      l[q] = __ldg(a.vin + (size_t)q * a.w_g + b);
      an[q] = __ldg(a.vin + (size_t)(3 + q) * a.w_g + b);
    }
  }
}

// An owned lane's new velocity: v + (w - v), the plain version's table add.
__device__ __forceinline__ void write_lane(const FusedArgs& a, int b,
                                           const float (&wl)[3],
                                           const float (&wa)[3],
                                           const float (&vl)[3],
                                           const float (&va)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    __stcg(a.vout + (size_t)q * a.w_g + b, vl[q] + (wl[q] - vl[q]));
    __stcg(a.vout + (size_t)(3 + q) * a.w_g + b, va[q] + (wa[q] - va[q]));
  }
}

// Rows [j0, j0 + len) of occupied colour c: everything that no earlier
// colour writes before the wait, then per row the wait, the update, the
// owned lanes and their release, the impulses.
template <int P, bool SUBSTEP>
__device__ __forceinline__ void sweep_chunk(const FusedArgs& a,
                                            unsigned long long occ, int c,
                                            int j0, int len, float* stage) {
  constexpr int R = rows_per_chunk(P);
  const int rung = a.rung[c];
  const int col0 = a.off[c] + j0;
  // B11: the delta chunks' reads first (the warmstart is level 0 of the
  // chain); this chunk's own loads and staging can wait
  if (SUBSTEP) await_deltas(a);
  stage_issue_columns<R>(stage, a.win, a.ld_w, a.k_load, col0, len);
  // a thread past the chunk's rows reads its first row's data and stops
  // after the staging barrier
  const bool live = threadIdx.x < len;
  const int t = live ? threadIdx.x : 0;
  const int j = j0 + t, col = col0 + t;
  if (live) trace_mark<true>(col, 0);

  const int* idx_row = a.idx + (size_t)c * a.w_g;
  const int* inv_row = a.inv + (size_t)c * a.w_g;
  const int ba = __ldg(idx_row + j);
  const int bb = __ldg(idx_row + rung + j);
  const bool own_a = __ldg(inv_row + ba) == j;
  const bool own_b = __ldg(inv_row + bb) == rung + j;
  const bool act = __ldg(a.act + col) > 0.5f;
  const float np_f = __ldg(a.nump + col);
  float pn[P], pt[P * S], n_rhs[P], t_rhs[P][S], p1[P][3], p2[P][3];
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
  const float* src = a.srcm + col;
  if (SUBSTEP) {
    // both world anchors of every point from the poses
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float lpa[3], lpb[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        lpa[e] = __ldg(src + (size_t)(a.src[S_LOCAL_PT_A] + 3 * k + e)
                       * a.ld_s);
        lpb[e] = __ldg(src + (size_t)(a.src[S_LOCAL_PT_B] + 3 * k + e)
                       * a.ld_s);
      }
      mul_pt(a.pose, a.w_g, ba, lpa, p1[k]);
      mul_pt(a.pose, a.w_g, bb, lpb, p2[k]);
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
  // the velocities matter to an active row and to a row that owns a lane
  const bool need = act || own_a || own_b;
  const int pa = need ? prev_writer(a, occ, c, ba) : -1;
  const int pb = need ? prev_writer(a, occ, c, bb) : -1;
  stage_wait();
  const unsigned lanes = __ballot_sync(0xffffffffu, live);
  if (!live) return;
  trace_mark<true>(col, 1);
  const StridedRow<R> f{stage + t};
  RowFields r;
  load_row_fields(f, a.cols, r);
  if (SUBSTEP) {
    // the substep rhs relinearized from the poses (_rhs_color)
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float drift[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) drift[e] = p1[k][e] - p2[k][e];
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
  }

  // a side waits for its body's previous writer (B11: at least the lane's
  // warmstart); B10 reads a body no earlier colour wrote from vin
  const bool out_a = need && (pa >= 0 || SUBSTEP);
  const bool out_b = need && (pb >= 0 || SUBSTEP);
  const unsigned lo_a = static_cast<unsigned>(pa + 1);
  const unsigned lo_b = static_cast<unsigned>(pb + 1);
  auto ready = [&]() {
    return (!out_a
            || flag_in<true>(a.ready + ba, a.base + lo_a, MAX_C - lo_a))
           && (!out_b
               || flag_in<true>(a.ready + bb, a.base + lo_b, MAX_C - lo_b));
  };
  auto update = [&]() {
    trace_mark<true>(col, 2);
    float v1l[3], v1a[3], v2l[3], v2a[3];
    read_side(a, ba, need, out_a, v1l, v1a);
    read_side(a, bb, need, out_b, v2l, v2a);
    float w1l[3], w1a[3], w2l[3], w2a[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      w1l[q] = v1l[q];
      w1a[q] = v1a[q];
      w2l[q] = v2l[q];
      w2a[q] = v2a[q];
    }
    float on[P], ot[P * S];
    gs_point_updates<P>(f, a.cols, r, act, np_f, a.cfm, n_rhs, t_rhs, pn,
                        pt, w1l, w1a, w2l, w2a, on, ot);
    trace_mark<true>(col, 3);
    if (own_a) write_lane(a, ba, w1l, w1a, v1l, v1a);
    if (own_b) write_lane(a, bb, w2l, w2a, v2l, v2a);
    release_flags(own_a ? a.ready + ba : nullptr,
                  own_b ? a.ready + bb : nullptr, a.base + c + 1);
    trace_mark<true>(col, 4);
    store_impulses<P>(on, ot, a.nout + col, a.tout + col, a.ctot);
  };
  run_when(lanes, ready, update);
}

template <int P, bool SUBSTEP>
__global__ void __launch_bounds__(rows_per_chunk(P))
    fused_kernel(const __grid_constant__ FusedArgs a) {
  extern __shared__ float stage[];
  __shared__ int s_chunk;
  __shared__ unsigned long long s_occ;
  if (threadIdx.x == 0)
    s_chunk = a.chunk0 + draw_ticket(a.ticket, a.nchunks);
  if (threadIdx.x < 32) {
    // the occupied colours, from the device counts
    const int l = threadIdx.x;
    const unsigned lo = __ballot_sync(
        0xffffffffu, l < a.n_colors && __ldg(a.counts + l + 1) > 0);
    const unsigned hi = __ballot_sync(
        0xffffffffu, l + 32 < a.n_colors && __ldg(a.counts + l + 33) > 0);
    if (l == 0) s_occ = lo | (static_cast<unsigned long long>(hi) << 32);
  }
  __syncthreads();
  constexpr int R = rows_per_chunk(P);
  const int ch = s_chunk;
  const unsigned long long occ = s_occ;
  if (SUBSTEP && ch >= a.delta0 && ch < a.delta1) {
    delta_chunk<P>(a, ch - a.delta0);
    return;
  }
  if (ch >= a.open0 && ch < a.open1) {
    const int i = (ch - a.open0) * R + threadIdx.x;
    if (i < a.off[0]) copy_row<P, SUBSTEP>(a, i);
    if (SUBSTEP) await_deltas(a);
    if (i < a.w_g) {
      trace_mark<true>(a.ctot + i, 0);
      open_lane<P, SUBSTEP>(a, occ, i);
      trace_mark<true>(a.ctot + i, 4);
    }
    return;
  }
  int c = 0;
  while (ch >= a.first[c + 1]) ++c;
  const int j0 = (ch - a.first[c]) * R;
  const int len = min(R, a.rung[c] - j0);
  if (occupied(occ, c))
    sweep_chunk<P, SUBSTEP>(a, occ, c, j0, len, stage);
  else if (threadIdx.x < len)
    copy_row<P, SUBSTEP>(a, a.off[c] + j0 + threadIdx.x);
}

template <int P, bool SUBSTEP>
int launch_fused(const FusedArgs& a, cudaStream_t stream) {
  if (a.nchunks <= 0) return 0;
  auto kern = fused_kernel<P, SUBSTEP>;
  const size_t smem = sizeof(float) * rows_per_chunk(P) * a.k_load;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<a.nchunks, rows_per_chunk(P), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The static layout (tab: the colours' first rows, their rungs, the
// n_colors + 1 bounds of their tickets, then the opening's and B11's delta
// chunks' first and end ticket), the flags and this launch's tickets.
int fill_layout(FusedArgs& a, int n_colors, const int* tab, int w_g,
                int ctot, int k_load, const int* cols, unsigned* ready,
                unsigned* ticket, unsigned base, int chunk0, int nchunks) {
  if (n_colors <= 0 || n_colors > MAX_C) return 1000;
  a.n_colors = n_colors;
  a.w_g = w_g;
  a.ctot = ctot;
  a.k_load = k_load;
  for (int c = 0; c < n_colors; ++c) {
    a.off[c] = tab[c];
    a.rung[c] = tab[n_colors + c];
  }
  for (int c = 0; c <= n_colors; ++c) a.first[c] = tab[2 * n_colors + c];
  a.open0 = tab[3 * n_colors + 1];
  a.open1 = tab[3 * n_colors + 2];
  a.delta0 = tab[3 * n_colors + 3];
  a.delta1 = tab[3 * n_colors + 4];
  for (int f = 0; f < N_FIELDS; ++f) a.cols.o[f] = cols[f];
  a.ready = ready;
  a.ticket = ticket;
  a.base = base;
  a.chunk0 = chunk0;
  a.nchunks = nchunks;
  return 0;
}

__global__ void __launch_bounds__(THREADS) integrate_kernel(
    int L, const float* __restrict__ pose, const float* __restrict__ vt,
    const float* __restrict__ com, float* __restrict__ out, float dt) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const LanePose p = load_lane_pose(pose, com, L, l);
  float lin[3], ang[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    lin[e] = __ldg(vt + (size_t)e * L + l);
    ang[e] = __ldg(vt + (size_t)(3 + e) * L + l);
  }
  integrate_lane(p, lin, ang, dt, out, L, l);
}

}  // namespace

// Plain C entry points (bound with ctypes). fused_sweep_launch's pose,
// com, pose_out and dt: B12's operands ([8, Wg], [3, Wg], a fresh
// [8, Wg], the step), carried by its opening; a null pose carries none.
// tab: the colours' first rows,
// their rungs, the n_colors + 1 bounds of their tickets, the opening's two
// and the delta chunks' two (gs_fused.fused_chunks);
// cols: the point update's field rows (gs_point_updates.cuh Field order,
// -1 for an absent field); ready: the [Wg] flags; ticket: the chunk counter
// (both zero before the first launch on the device); base: this launch's
// epoch x (MAX_C + 1); [chunk0, chunk0 + nchunks): its tickets (the grid).
// Each returns cudaGetLastError() after the launch, or 1000 for an
// unsupported p_max / colour count.

extern "C" int fused_sweep_launch(
    int p_max, int n_colors, const int* tab, int w_g, int ctot, int k_load,
    const int* cols, const float* vin, float* vout, const float* nin,
    int ld_n, const float* tin, int ld_t, float* nout, float* tout,
    const float* win, int ld_w, const float* act, const float* nump,
    float cfm, const float* nrhs, int ld_nr, const float* trhs, int ld_tr,
    const float* pose, const float* com, float* pose_out, float dt,
    const int* idx, const int* inv, const int* counts, unsigned* ready,
    unsigned* ticket, unsigned base, int chunk0, int nchunks, void* stream) {
  FusedArgs a = {};
  const int bad = fill_layout(a, n_colors, tab, w_g, ctot, k_load, cols,
                              ready, ticket, base, chunk0, nchunks);
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
  a.pose = pose;
  a.com = com;
  a.pose_out = pose_out;
  a.dt = dt;
  a.idx = idx;
  a.inv = inv;
  a.counts = counts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_max == 1) return launch_fused<1, false>(a, s);
  if (p_max == 4) return launch_fused<4, false>(a, s);
  return 1000;
}

extern "C" int fused_substep1_launch(
    int p_max, int n_colors, const int* tab, int w_g, int ctot, int k_load,
    const int* cols, const int* src_cols, const float* vin, float* vout,
    const float* nin, int ld_n, const float* tin, int ld_t, float* nout,
    float* tout, float* nwo, const float* win, int ld_w, const float* srcm,
    int ld_s, const float* pose, const float* act, const float* nump,
    const int* idx, const int* inv, const int* counts, float ws, float cfm,
    float inv_dt, float erp_inv_dt, float allowed, float max_corr,
    float* wsd, unsigned* done, unsigned done_target, unsigned* ready,
    unsigned* ticket, unsigned base, int chunk0, int nchunks, void* stream) {
  FusedArgs a = {};
  const int bad = fill_layout(a, n_colors, tab, w_g, ctot, k_load, cols,
                              ready, ticket, base, chunk0, nchunks);
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
  a.wsd = wsd;
  a.done = done;
  a.done_target = done_target;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_max == 1) return launch_fused<1, true>(a, s);
  if (p_max == 4) return launch_fused<4, true>(a, s);
  return 1000;
}

// The timestamps of the last traced launch of B10 or B11 (gs_sweep.cuh;
// 1001 in an untraced build).
extern "C" int fused_trace(void* dst, size_t bytes) {
  return copy_sweep_trace(dst, bytes);
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
