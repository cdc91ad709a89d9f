// Fused point-mass MPPI solve for Hopper (sm_90a), plain C interface, and
// the dynamics-agnostic kernels every solve shares (phase-B weights, merge,
// noise dump).
//
// Build: mppi_tf_tpu_torch/kernels/_build.py compiles every .cu under csrc/
// with nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 into one
// shared library at first use. Every entry point launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().
//
// Kernels, and the TPU kernels of mppi_tf_tpu/kernels/pm_mppi.py they replace:
//
// pm_noise_dump_kernel<CH> -- replaces fused_noise_dump (make_noise_kernel +
//   _fill_noise). Writes the exact normals the solves consume, z[n][k] with
//   n = t*adim + j, for any adim (the AUV's 6 as well), mirrored past
//   `half` as an antithetic solve reads them: the solves' Philox counters,
//   key and Box-Muller (mppi_common.cuh) bit for bit, rounded to bf16 in
//   the bf16 build. Bound by operations: a Philox4x32-10 and two
//   Box-Muller transforms a 4 normals issue at ~2.5e11 pairs a second
//   (roofline.cu's bm ceiling), 0.030 ms at [50, 3, 100,000], above the
//   0.018 ms its 4 bytes a normal take at 3.35 TB/s. Design: one sample a
//   thread and a run of its Philox blocks, so that the setup and the
//   solve index's read are paid once a run; CH = 2 independent chains a
//   pass at scale, 1 where one chain a pass fits a wave of blocks (there
//   a chain's latency bounds the dump, as at log mode's [H, adim, 512]);
//   each warp stages a pass's normals in shared memory and writes every
//   row as 16-byte streaming stores of 4 samples (a row off the 16-byte
//   grid: shifted windows, its head and tail sample by sample); about two
//   waves of blocks, the passes split evenly over blockIdx.y.
//
// pm_fused_solve_kernel<S, A, MODE, COST, AB, STRUCT> -- MODE kFused replaces
//   fused_pm_call (_make_kernel in mode "fused" + _fill_noise); MODE kCosts
//   replaces fused_pm_costs (mode "costs", phase A of the normalized
//   solve). COST is the state cost of _make_kernel's cost_kind:
//   kQuadratic, (x - g)^T Q (x - g) around the goal in dyn (StaticCost, and
//   WayPointsCost as its effective goal: the host adds the dropped
//   constant back, kernels/pm_mppi.py); kElipse, the 2D ellipse cost over
//   [x, vx, y, vy] (cost_kind "elipse", :474-485), built for (S, A) = (4, 2)
//   only, with native sqrtf in place of the TPU's vector sqrt. One
//   thread owns one sample (two in the bf16 build, below); the state
//   stays in registers over the horizon, the per-solve dyn array sits in
//   shared memory. Bound by operations: the
//   Philox + Box-Muller passes (~32 ops a normal each; in kFused one, and a
//   second over the normals past the held prefix, below; one in kCosts)
//   and the rollout/cost FMA chains; kCosts also writes 4 bytes a sample.
//   Design:
//   * the TPU grid ran its tiles in order and carried (m, l, zsum) across
//     grid steps; GPU blocks run concurrently, so each block writes its own
//     partial row (mppi_common.cuh) and pm_merge_kernel combines them: no
//     atomics, and the result is deterministic;
//   * kFused holds z in shared memory from pass one to pass two: pass one
//     stores each normal it draws below `held` to s_z[n][threadIdx.x]
//     (n = t A + j; a row of kBlock floats a normal, so that a warp's
//     stores and loads touch 32 banks once), and pass two reads them back
//     there instead of drawing them again; the normals from `held` on it
//     regenerates from the same Philox counters. The same values, so the
//     same bits at any `held`. The host sizes it (kernels/pm_mppi.py
//     held_normals): every normal where they fit, else the longest prefix
//     of whole Philox blocks, that leaves room for two blocks an SM. At
//     the point mass's 150 normals (K=100,000, H=50) that is 104: a block
//     of 256 holding all 150 takes 153.6 KB, one block an SM, and ran
//     slower than two holding 104 at every shape of the sweep that chose
//     the rule (NVIDIA H100 80GB HBM3, 700 W: 0.0726 against 0.0718 ms at
//     K=100,000, 2.250 against 2.042 for 32 vehicles, 0.0895 and 2.564
//     drawing every normal twice; three blocks holding 64, 0.0785 and
//     2.225); at H=100 it holds 96 of 300;
//   * kCosts writes costs[k] and a stats-only row (m_b = l_b = 0, no zsum):
//     pm_merge with n_z = 0 gives the cost min / max / sum that phase B
//     normalizes with;
//   * the `scheduled` (per-step c_t, _Dyn.sched of :144-148, the algebra
//     of :490-553) and `antithetic` (:184-187) variants are runtime
//     arguments, not instantiations: c_t sits at the end of dyn in shared
//     memory and scales the noise drive, x' = A x + inv_m (B u_t + c_t B
//     scale z_t), and the z-quadratic, nc_half c_t z^T Mz z (rhs_z is
//     schedule-invariant; the host packs u_half as sum_t u_half_t / c_t
//     and unfolds wnoise_t = c_t scale zsum_t); an antithetic solve
//     mirrors Philox samples as mppi_common.cuh says, uniformly over the
//     grid's second half;
//   * AB kDynAB replaces _make_kernel's `dynamic_ab` variant (the _Dyn A /
//     Bs blocks of :140-143, smem_dot of :444-456, the step of :497-508):
//     A and B scale come from the dyn array (kernels/pm_mppi.py Dyn.A,
//     Dyn.Bs, after u_half) instead of the by-value constants, so an
//     identified linear model (FusedLTIMPPI) changes them as data, with no
//     rebuild and no host repack. The host packs inv_mass = 1 and bu = the
//     true B u_t, so the step fmaf(1, bu + c_t bz, ax) is the TPU's ax +
//     (bu + c_t bz);
//   * STRUCT is the TPU kernel's compile-time zero elision (sparse_dot,
//     :430-442, over its constants; kernels/pm_mppi.py PmConsts.structure
//     picks it exactly). kIntegrator (f32, constant (A, B): every bundled
//     point-mass task at a diagonal sigma) emits no instruction for the
//     zeros of A, B scale, Q and Mz and no multiply for A's unit
//     diagonal: a step is A(2d, 2d+1) x_(2d+1) + x_2d, B scale's one
//     product a row, Q_ii d_i, and the z-quadratic only where nc_half is
//     not 0 (a uniform branch, the TPU's `if nc_half != 0.0`); the values
//     stay runtime data in the constants. Its per-sample costs are
//     kDense's bits: the one product a dense chain would round in its
//     first FMA is rounded alone (mul_r), so ptxas cannot contract it
//     into the next add. kDense runs every matrix dense, for any other
//     constants, dynamic_ab and the bf16 build;
//   * the f32 body (one sample a thread) draws its normals a group of
//     steps at a time: lcm(A, 4) / A steps read lcm(A, 4) / 4 whole
//     Philox blocks, drawn as independent chains ahead of the group's
//     steps (A = 3: 4 steps, 3 blocks), then a tail of H mod that; normal
//     t A + j is still block (t A + j) / 4, word (t A + j) % 4, and
//     injected z is read as z[t A + j][k]. Pass two takes 16 normals at a
//     time, read from s_z or regenerated as 4 Philox blocks, and reduces
//     their 16 products w_k z_k over the warp at once (mppi_common.cuh
//     warp_sum_each: 16 SHFL for 16 normals against 5 a normal, each sum
//     warp_sum's bits). ptxas is asked for three
//     blocks of 256 an SM (at most 80 registers): so kCosts fits the 391
//     blocks of K=100,000 in one wave on 132 SMs, and kFused, at two
//     blocks an SM by its held prefix's shared memory, in 1.48. kDense
//     reads A and B scale at each use from
//     rows padded in shared memory (volatile loads, AbRows): hoisted
//     into registers, they spill at that bound;
//   * the TPU's sin polynomial and mantissa-stuffing uniform worked around
//     Mosaic; here logf / sqrtf / sincospif are used directly;
//   * the bf16 block compute (compute_dtype "bfloat16", :363-368 and the
//     casts of :417-428, :459-560) is this source compiled at Val = bf16x2
//     through pm_mppi_bf16.cu (mppi_common.cuh, MPPI_BF16_PAIRS), with a
//     body of its own (kDense alone): two
//     samples a thread, 128 threads a block for one partial row, each
//     rollout op one native add.rn / sub.rn / mul.rn.bf16x2 for both. The
//     state, x0, goal, the rollout and cost chains round at every op in
//     the TPU kernel's order (the dense chains here equal its sparse_dot,
//     whose skipped zeros and unmultiplied ones are exact),
//     x' = ax + inv_m (bu + bz), or with a schedule
//     ax + (r(inv_m bu) + r(inv_m c_t) bz) with the scalar products formed
//     in f32 and rounded once (:497-531); each step cost, rhs_z . z and
//     nc_half z^T Mz z term is a bf16 value added to each lane's f32 cost;
//     the softmax, stats and Box-Muller stay f32. Every runtime operand is
//     rounded once: the constants reach the kernel as duplicated bf16x2
//     words (pair_consts); x0, the goal, bu (r(inv_m bu) scheduled) and
//     rhs_z are staged as words in shared memory (stage_dyn); A, B scale
//     (kDynAB: dyn's, rounded), Q and Mz are staged likewise and then held
//     in registers over the solve (Mats: a bf16x2 op takes no
//     constant-bank operand, so the f32 build's FFMA operands would
//     become an LDC or LDS a use a step); inv_m, the ellipse's constants
//     and the step's inv_m c_t and nc_half c_t take one cvt each; the
//     ellipse's sqrt runs per lane in f32. Both lanes' Philox blocks are
//     drawn in one branch (mppi_common.cuh next_lanes_f32), so the two
//     chains interleave. At K=100,000 the 391 blocks of 128 threads fit
//     one wave at 3 blocks an SM. Its kernels and entry points carry a
//     _bf16 suffix and read bf16-rounded normals in every phase; the
//     weights and noise dump stay one sample a thread.
//
// mppi_weights_kernel -- replaces make_weights_kernel (fused_pm_weights and
//   auv_mppi._fused_auv_weights, phase B of the normalized solve, for both
//   models). Reads costs[k] and nrm = (beta, 1/(denom*lam)) from device
//   memory (no host sync between the phases), regenerates the normals of
//   the same (seed, solve) (n_z = tau*adim, any adim; mirrored when
//   antithetic, :222 of the TPU kernel) and writes partial
//   rows with m_b = 0: w = exp(-(c - beta) * nrm[1]) lies in
//   [exp(-1/lam), 1], so no max shift is needed. Bound by operations (one
//   Philox + Box-Muller pass, ~32 a normal, part of them on the half-rate
//   integer multiplier and the quarter-rate MUFU and I2F units); it reads
//   4 bytes a sample. Design:
//   * pass two draws kWeightBlocks Philox blocks at a time as independent
//     chains (NoiseStream::blocks) and reduces their 16 products w_k z_k
//     across the warp at once (warp_sum_each: 16 SHFL where the per-normal
//     warp_sum took 80), each sum the per-normal loop's bits; the bf16
//     build rounds each normal to bf16 before its product (read_normal);
//   * the normals are split into G groups of Philox blocks over
//     blockIdx.y: a sample's normals are addressed by (sample, Philox
//     block), so a group regenerates its own and writes its own columns
//     of the tile's row, and group 0 alone its stats; the host picks G from
//     n_z (mppi_weights below): three 16-normal chunks a group, which
//     gives the flagships 1.3-5.2 waves of blocks, so that a partial
//     wave's tail is a group's work, not a whole row's. No G moves a bit.
//
// pm_merge_kernel -- the cross-block step, the shard-merge algebra of
//   mppi_tf_tpu/parallel/fused.py (m = max m_b, f_b = exp(m_b - m),
//   l = sum f_b l_b, zsum = sum f_b zsum_b, cost min/max/sum); n_z = 0
//   merges stats-only rows. Bound by the bytes of the rows it reads (~250
//   KB at K=100k, H=50: 0.0001 ms at 3.35 TB/s); launch latency is its
//   floor. Design: column tiles of 32 (a lane a column) x 8 row
//   slices (a warp a slice), f_b once a row into shared memory (not once
//   a (row, column) pair); from 640 rows on (the AUV's 1,024) each tile is
//   a thread-block cluster of 8 blocks over slices of the rows, m reduced
//   across the cluster through distributed shared memory and rank 0
//   adding the ranks in order (below that, as for the point mass's 391
//   rows, one block a tile). Every sum runs in a fixed order: no atomics,
//   the same bits on every call.

#include <string.h>

#include <algorithm>

#ifndef MPPI_BF16
#include <cooperative_groups.h>
#endif

#include "mppi_common.cuh"

namespace {

using namespace mppi;

// State costs (kernels/pm_mppi.py COST_KINDS).
enum PmCost { kQuadratic = 0, kElipse = 1 };

// Where the solve reads A and B scale: the by-value constants, or dyn.
enum PmAB { kConstAB = 0, kDynAB = 1 };


// Structure of the solve constants (kernels/pm_mppi.py STRUCTURES):
// kIntegrator takes A as the per-DoF double integrator (a unit diagonal,
// A(2d, 2d+1) its only other nonzeros), B scale's nonzeros at (2d, d) and
// (2d+1, d), and Q and Mz diagonal; kDense runs every matrix dense. The
// f32 build alone has kIntegrator.
enum PmStruct { kDense = 0, kIntegrator = 1 };

// Solve constants, in the order of kernels/pm_mppi.py PmConsts.packed; W
// is the type of the rollout's constants: float, or in the pair build the
// duplicated bf16x2 word (w, w) of each (the host packs them rounded).
template <int S, int A, typename W>
struct ConstsT {
  W a[S * S];   // A
  W bs[S * A];  // B @ scale (mass free)
  W q[S * S];   // Q (zero for kElipse)
  W mz[A * A];  // scale^T Sigma^-1 scale
  float lam;
  float nc_half;
  float el[7];  // kElipse: a, b, cx, cy, gv, m_state, m_vel
};
template <int S, int A>
using HostConsts = ConstsT<S, A, float>;

#ifdef MPPI_BF16
template <int S, int A>
using Consts = ConstsT<S, A, bf16x2>;

// The pair build's constants: A, B scale, Q and Mz (each already a bf16
// value) as duplicated bf16x2 words, the scalars as they are.
template <int S, int A>
Consts<S, A> pair_consts(const HostConsts<S, A>& f) {
  static_assert(sizeof(Consts<S, A>) == sizeof(HostConsts<S, A>),
                "Consts layout");
  Consts<S, A> c;
  memcpy(&c, &f, sizeof(c));
  auto words = [](bf16x2* dst, const float* src, int n) {
    for (int i = 0; i < n; ++i) dst[i] = bf16x2(src[i]);
  };
  words(c.a, f.a, S * S);
  words(c.bs, f.bs, S * A);
  words(c.q, f.q, S * S);
  words(c.mz, f.mz, A * A);
  return c;
}

// The ellipse's constants as the pair build's cost reads them, one word
// each, converted once a solve: 1/a and 1/b formed in f32 and rounded
// once (the TPU kernel's bf16 form, :474-485), the rest rounded.
struct ElipseVals {
  Val inv_a, inv_b, cx, cy, gv, ms, mv;
};
__device__ __forceinline__ ElipseVals elipse_vals(const float* el) {
  return {to_val(1.0f / el[0]), to_val(1.0f / el[1]), to_val(el[2]),
          to_val(el[3]),        to_val(el[4]),        to_val(el[5]),
          to_val(el[6])};
}

// How the pair build stages dyn entry i (the TPU kernel's d_() reads):
// x0, the goal, bu and rhs_z as duplicated bf16x2 words, each rounded
// once from f32, with a schedule bu as r(inv_m bu), the product formed in
// f32 (:519-527); inv_mass, u_half, the schedule's c_t (and kDynAB's A
// and B scale, which the rollout reads through Mats) as they are.
template <int S, int A>
__device__ __forceinline__ float stage_dyn(const float* dyn, int i, int tau,
                                           int sched_off) {
  const int bu = 1 + 2 * S, rhs_z = bu + tau * S, u_half = rhs_z + tau * A;
  if (i == 0 || i >= u_half) return dyn[i];
  if (sched_off >= 0 && i >= bu && i < rhs_z)
    return stage_word(dyn[0] * dyn[i]);
  return stage_word(dyn[i]);
}

// cost[l] += lane l of v: each lane's own f32 cost
__device__ __forceinline__ void add_lanes(float* cost, Val v) {
#pragma unroll
  for (int l = 0; l < kLanes; ++l) cost[l] += widen(v, l);
}

// The rollout's matrices, entry i of each: A (row-major), B scale (mass
// free), Q and Mz. In the pair build every entry is a word held in a
// register over the solve, loaded once from its copy in shared memory
// (stage_mats): a bf16x2 op takes no constant-bank operand, and read at
// every use each entry would cost an LDC (ptxas rematerialises
// constant-bank loads) or, with kDynAB, an LDS (NVVM moves no load across
// the ops' inline asm) a use a step.
template <int S, int A, int AB>
struct Mats {
  static constexpr int kN = 2 * S * S + S * A + A * A;
  Val w[kN];
  __device__ __forceinline__ Val a(int i) const { return w[i]; }
  __device__ __forceinline__ Val bs(int i) const { return w[S * S + i]; }
  __device__ __forceinline__ Val q(int i) const { return w[S * (S + A) + i]; }
  __device__ __forceinline__ Val mz(int i) const {
    return w[S * (2 * S + A) + i];
  }
};

// Word i of Mats from the constants (a compile-time i: a kernel parameter
// indexed at run time would be copied to local memory).
template <int S, int A>
__device__ __forceinline__ uint32_t const_word(const Consts<S, A>& c,
                                               int i) {
  if (i < S * S) return c.a[i].v;
  if (i < S * (S + A)) return c.bs[i - S * S].v;
  if (i < S * (2 * S + A)) return c.q[i - S * (S + A)].v;
  return c.mz[i - S * (2 * S + A)].v;
}

// Stage Mats' words in s_mat (all threads call it): the constants', or
// with kDynAB dyn's A and B scale (ab, in device memory) rounded once.
template <int S, int A, int AB>
__device__ __forceinline__ void stage_mats(const Consts<S, A>& c,
                                           const float* ab,
                                           uint32_t* s_mat) {
  constexpr int kDyn = AB == kDynAB ? S * (S + A) : 0;
#pragma unroll 1
  for (int i = threadIdx.x; i < kDyn; i += kThreads)
    s_mat[i] = to_val(ab[i]).v;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = kDyn; i < Mats<S, A, AB>::kN; ++i)
      s_mat[i] = const_word(c, i);
  }
}

// goal: the staged goal words
template <int S, int A, int COST, typename M>
__device__ __forceinline__ Val state_cost(const Consts<S, A>& c, const M& m,
                                          const ElipseVals& e, const Val* x,
                                          const float* goal) {
  if constexpr (COST == kElipse) {
    static_assert(S == 4 && A == 2, "the ellipse cost is 2D: [x, vx, y, vy]");
    // m_state |((x-cx)/a)^2 + ((y-cy)/b)^2 - 1| + m_vel (|v| - gv)^2 in
    // the TPU kernel's bf16 form (:474-485): scaled by 1/a, the sqrt per
    // lane in f32
    const Val ex = (x[0] - e.cx) * e.inv_a;
    const Val ey = (x[2] - e.cy) * e.inv_b;
    const Val d = abs_r(ex * ex + ey * ey - Val(1.0f));
    const Val dv = per_lane(x[1] * x[1] + x[3] * x[3],
                            [](float v) { return sqrtf(v); }) - e.gv;
    return e.ms * d + e.mv * (dv * dv);
  } else {
    Val d[S];
#pragma unroll
    for (int i = 0; i < S; ++i) d[i] = x[i] - exact_val(goal[i]);
    Val out = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      Val qd = 0.0f;
#pragma unroll
      for (int j = 0; j < S; ++j)
        qd = fma_r(m.q(i * S + j), d[j], qd);
      out = fma_r(d[i], qd, out);
    }
    return out;
  }
}

// The pair build's body (PR 9's form): two samples a thread, kDense alone.
template <int S, int A, int MODE, int COST, int AB, int STRUCT>
__global__ void __launch_bounds__(kThreads)
    MPPI_KERNEL(pm_fused_solve)(const Consts<S, A> c,
                                const float* __restrict__ dyn, int dyn_size,
                                int sched_off, const float* __restrict__ z,
                                float* __restrict__ costs,
                                float* __restrict__ partials, int k_total,
                                int tau, int /* held: 0 */, Seeds sd) {
  static_assert(STRUCT == kDense, "the pair build has kDense alone");
  dyn += static_cast<size_t>(blockIdx.z) * dyn_size;  // vehicle's (fleets)
  extern __shared__ float smem[];
  float* s_dyn = smem;             // dyn_size
  float* s_red = smem + dyn_size;  // kWarps * n_z: pass-two warp sums

  using M = Mats<S, A, AB>;
  __shared__ uint32_t s_mat[M::kN];
  stage_mats<S, A, AB>(c, dyn + 1 + 2 * S + tau * (S + A) + 1, s_mat);
  // a few passes a block: no unrolled copies of the staging's cvts
#pragma unroll 1
  for (int i = threadIdx.x; i < dyn_size; i += kThreads)
    s_dyn[i] = stage_dyn<S, A>(dyn, i, tau, sched_off);
  __syncthreads();

  // dyn layout (kernels/pm_mppi.py Dyn): inv_mass, x0, goal, bu, rhs_z,
  // u_half, with kDynAB A and B scale, then the schedule's c_t at
  // sched_off when scheduled
  const float* x0 = s_dyn + 1;
  const float* goal = s_dyn + 1 + S;
  const float* bu = s_dyn + 1 + 2 * S;
  const float* rhs_z = bu + tau * S;
  const float u_half = rhs_z[tau * A];
  const float inv_m = s_dyn[0];
  M m;
#pragma unroll
  for (int i = 0; i < M::kN; ++i) m.w[i] = bf16x2::bits(s_mat[i]);
  const Val inv_m_v = to_val(inv_m);
  ElipseVals e{};
  if constexpr (COST == kElipse) e = elipse_vals(c.el);

  // block b: partial row b; lane l of thread t: sample b kBlock +
  // l kThreads + t
  int k[kLanes];
  bool valid[kLanes];
  NoiseStream ns[kLanes];
  float cost[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    k[l] = blockIdx.x * kBlock + l * kThreads + threadIdx.x;
    valid[l] = k[l] < k_total;
    ns[l].init(vehicle_z(z, tau * A, k_total), k_total, k[l], sd);
    cost[l] = 0.0f;
  }

  // ---- pass one: rollout + cost ------------------------------------------
  {
    Val x[S];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = exact_val(x0[i]);
    int n = 0;
    for (int t = 0; t < tau; ++t) {
      const float ct = sched_factor(s_dyn, sched_off, t);
      Val zt[A];
#pragma unroll
      for (int j = 0; j < A; ++j) zt[j] = draw(ns, n++);
      // the step's scalars, formed in f32 and rounded once
      const Val ct_m = to_val(inv_m * ct);
      const Val nq_c = to_val(c.nc_half * ct);
      Val xn[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        Val ax = 0.0f;
#pragma unroll
        for (int j = 0; j < S; ++j)
          ax = fma_r(m.a(i * S + j), x[j], ax);
        Val bz = 0.0f;
#pragma unroll
        for (int j = 0; j < A; ++j)
          bz = fma_r(m.bs(i * A + j), zt[j], bz);
        // ax + r(inv_m) (r(bu) + bz), scheduled ax + (r(inv_m bu) +
        // r(inv_m c_t) bz) (:497-531)
        const Val b = exact_val(bu[t * S + i]);
        xn[i] = sched_off >= 0 ? ax + (b + ct_m * bz)
                               : ax + inv_m_v * (b + bz);
      }
#pragma unroll
      for (int i = 0; i < S; ++i) x[i] = xn[i];
      add_lanes(cost, state_cost<S, A, COST>(c, m, e, x, goal));
      Val quad = 0.0f;
#pragma unroll
      for (int j = 0; j < A; ++j) {
        add_lanes(cost, exact_val(rhs_z[t * A + j]) * zt[j]);
        Val mz = 0.0f;
#pragma unroll
        for (int i = 0; i < A; ++i)
          mz = fma_r(m.mz(j * A + i), zt[i], mz);
        quad = fma_r(zt[j], mz, quad);
      }
      // eps^T Sigma_t^-1 eps = c_t z^T Mz z
      add_lanes(cost, nq_c * quad);
    }
    add_lanes(cost, state_cost<S, A, COST>(c, m, e, x, goal));
  }

  float zarg[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    cost[l] += u_half;
    zarg[l] = MODE == kFused ? -cost[l] / c.lam : -INFINITY;
    if (MODE == kCosts && valid[l])
      costs[vehicle_row(k[l], k_total)] = cost[l];
  }
  if (MODE == kFused)
    write_partial_row_lanes<true, kLanes>(
        zarg, cost, valid, ns, tau * A, s_red,
        partials + vehicle_row(blockIdx.x, gridDim.x) * (kStats + tau * A));
  else
    write_partial_row_lanes<false, kLanes>(
        zarg, cost, valid, ns, 0, s_red,
        partials + vehicle_row(blockIdx.x, gridDim.x) * kStats);
}

// Shared memory of the pair build ahead of s_red: dyn.
template <int S, int A, int STRUCT>
constexpr int smem_lead(int dyn_size) {
  return dyn_size;
}
#else
template <int S, int A>
using Consts = HostConsts<S, A>;

// kDense's A and B scale in shared memory, rows padded to 16- (8-) byte
// loads (A: 8, 4 or 2 words; B scale: 4, 2 or 1), read at each use
// through volatile loads, which no pass hoists out of the horizon loop:
// hoisted (from dyn with kDynAB, from the constant bank as FFMA operands
// held in registers across the unrolled group), the 54 floats of (6, 3)
// spilled at three blocks an SM, and held 98 registers at two.
template <int S, int A, int STRUCT>
struct AbRows {
  static constexpr int kRA = S == 6 ? 8 : S, kRB = A == 3 ? 4 : A;
  static constexpr int kWords = STRUCT == kDense ? S * (kRA + kRB) : 0;
  // word w of the rows from A (row-major) and B scale
  static __device__ __forceinline__ float word(int w, const float* a,
                                               const float* bs) {
    if (w < S * kRA) return w % kRA < S ? a[w / kRA * S + w % kRA] : 0.0f;
    const int v = w - S * kRA;
    return v % kRB < A ? bs[v / kRB * A + v % kRB] : 0.0f;
  }
  // all threads: from dyn's blocks (kDynAB; ab: A, then B scale) or, by
  // thread 0 at compile-time offsets, from the constants
  template <int AB>
  static __device__ __forceinline__ void stage(const Consts<S, A>& c,
                                               const float* ab, float* s) {
    if constexpr (kWords == 0) {
      return;
    } else if constexpr (AB == kDynAB) {
#pragma unroll 1
      for (int w = threadIdx.x; w < kWords; w += kThreads)
        s[w] = word(w, ab, ab + S * S);
    } else if (threadIdx.x == 0) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) s[w] = word(w, c.a, c.bs);
    }
  }
};

// N floats of a padded row in shared memory, v4 / v2 / v1 volatile loads
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* r) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
#pragma unroll
  for (int j = 0; j + 4 <= N; j += 4)
    asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(r[j]), "=f"(r[j + 1]), "=f"(r[j + 2]), "=f"(r[j + 3])
                 : "r"(a + 4 * j));
  constexpr int j2 = N / 4 * 4;
  if constexpr (N % 4 >= 2)
    asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];"
                 : "=f"(r[j2]), "=f"(r[j2 + 1])
                 : "r"(a + 4 * j2));
  if constexpr (N % 2 == 1)
    asm volatile("ld.volatile.shared.f32 %0, [%1];"
                 : "=f"(r[N - 1])
                 : "r"(a + 4 * (N - 1)));
}

// The f32 state cost; kIntegrator reads Q's diagonal alone, each Q_ii d_i
// rounded alone (mul_r): the dense row's value, whose other terms add +-0
// (contracted into the next FMA, the product would move its bits).
template <int S, int A, int COST, int STRUCT>
__device__ __forceinline__ float state_cost(const Consts<S, A>& c,
                                            const float* x,
                                            const float* goal) {
  if constexpr (COST == kElipse) {
    static_assert(S == 4 && A == 2, "the ellipse cost is 2D: [x, vx, y, vy]");
    // m_state |((x-cx)/a)^2 + ((y-cy)/b)^2 - 1| + m_vel (|v| - gv)^2
    const float ex = (x[0] - c.el[2]) / c.el[0];
    const float ey = (x[2] - c.el[3]) / c.el[1];
    const float dv = sqrtf(x[1] * x[1] + x[3] * x[3]) - c.el[4];
    return c.el[5] * fabsf(ex * ex + ey * ey - 1.0f) + c.el[6] * dv * dv;
  } else {
    float d[S];
#pragma unroll
    for (int i = 0; i < S; ++i) d[i] = x[i] - goal[i];
    float out = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float qd = 0.0f;
      if constexpr (STRUCT == kIntegrator) {
        qd = mul_r(c.q[i * S + i], d[i]);
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j) qd = fmaf(c.q[i * S + j], d[j], qd);
      }
      out = fmaf(d[i], qd, out);
    }
    return out;
  }
}

// Steps of one noise group: lcm(A, 4) / A steps read lcm(A, 4) / 4 whole
// Philox blocks (A = 3: 4 steps, 3 blocks; A = 2: 2 steps, 1 block; A = 1:
// 4 steps, 1 block).
__host__ __device__ constexpr int group_steps(int a) {
  return a % 4 == 0 ? 1 : a % 2 == 0 ? 2 : 4;
}
// Philox blocks that pass two regenerates together (16 normals, 16 SHFL).
constexpr int kPassTwoBlocks = 4;

// The f32 body. Each thread owns one sample; its normals come a group of
// steps at a time (NoiseStream::blocks), the horizon loop runs whole
// groups, then a tail of the last H mod group_steps(A) steps; kFused
// stores the normals below `held` to s_z as they are drawn, for pass two.
// ptxas is asked for three blocks of 256 an SM (at most 80 registers): the
// 391 blocks of kCosts at K=100,000 fit one wave on 132 SMs; kFused's held
// prefix leaves room for two (the head of this file).
template <int S, int A, int MODE, int COST, int AB, int STRUCT>
__global__ void __launch_bounds__(kThreads, 3)
    MPPI_KERNEL(pm_fused_solve)(const Consts<S, A> c,
                                const float* __restrict__ dyn, int dyn_size,
                                int sched_off, const float* __restrict__ z,
                                float* __restrict__ costs,
                                float* __restrict__ partials, int k_total,
                                int tau, int held, Seeds sd) {
  static_assert(STRUCT == kDense || AB == kConstAB,
                "kIntegrator reads A and B scale from the constants");
  dyn += static_cast<size_t>(blockIdx.z) * dyn_size;  // vehicle's (fleets)
  using R = AbRows<S, A, STRUCT>;
  extern __shared__ __align__(16) float smem[];
  float* s_dyn = smem;                          // dyn_size
  float* s_ab = smem + ((dyn_size + 3) & ~3);   // R::kWords, 16-byte aligned
  float* s_z = s_ab + R::kWords;                // held * kBlock: [n][thread]
  float* s_red = s_z + held * kBlock;           // kWarps * n_z
  for (int i = threadIdx.x; i < dyn_size; i += kThreads) s_dyn[i] = dyn[i];
  R::template stage<AB>(c, dyn + 1 + 2 * S + tau * (S + A) + 1, s_ab);
  __syncthreads();

  // dyn layout (kernels/pm_mppi.py Dyn): inv_mass, x0, goal, bu, rhs_z,
  // u_half, with kDynAB A and B scale, then the schedule's c_t at
  // sched_off when scheduled
  const float* goal = s_dyn + 1 + S;
  const float* bu = s_dyn + 1 + 2 * S;
  const float* rhs_z = bu + tau * S;
  const float u_half = rhs_z[tau * A];
  const float inv_m = s_dyn[0];

  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < k_total;
  NoiseStream ns;
  ns.init(vehicle_z(z, tau * A, k_total), k_total, k, sd);
  float cost = 0.0f;
  float x[S];
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = s_dyn[1 + i];

  // one step t over its normals zt: x' = A x + inv_m (B u_t + c_t B scale
  // z_t), cost += q(x') + rhs_z_t . z_t + nc_half c_t z_t^T Mz z_t
  auto step = [&](int t, const float* zt) {
    const float ct = sched_factor(s_dyn, sched_off, t);
    float xn[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float ax, bz;
      if constexpr (STRUCT == kIntegrator) {
        // the dense chains' bits: 1 x is exact, a zero adds +-0, and the
        // one product of B scale's row is rounded alone as the chain's
        // first FMA rounds it
        ax = i % 2 == 0 ? fmaf(c.a[i * S + i + 1], x[i + 1], x[i]) : x[i];
        bz = mul_r(c.bs[i * A + i / 2], zt[i / 2]);
      } else {
        float ar[S], br[A];
        load_row<S>(s_ab + i * R::kRA, ar);
        load_row<A>(s_ab + S * R::kRA + i * R::kRB, br);
        ax = 0.0f;
#pragma unroll
        for (int j = 0; j < S; ++j) ax = fmaf(ar[j], x[j], ax);
        bz = 0.0f;
#pragma unroll
        for (int j = 0; j < A; ++j) bz = fmaf(br[j], zt[j], bz);
      }
      xn[i] = fmaf(inv_m, bu[t * S + i] + ct * bz, ax);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = xn[i];
    cost += state_cost<S, A, COST, STRUCT>(c, x, goal);
#pragma unroll
    for (int j = 0; j < A; ++j) cost = fmaf(rhs_z[t * A + j], zt[j], cost);
    // eps^T Sigma_t^-1 eps = c_t z^T Mz z: adds +-0 at nc_half = 0 (the
    // TPU kernel's `if nc_half != 0.0`), a uniform branch
    if (c.nc_half != 0.0f) {
      float quad = 0.0f;
#pragma unroll
      for (int j = 0; j < A; ++j) {
        float mz = 0.0f;
        if constexpr (STRUCT == kIntegrator) {
          mz = mul_r(c.mz[j * A + j], zt[j]);
        } else {
#pragma unroll
          for (int i = 0; i < A; ++i) mz = fmaf(c.mz[j * A + i], zt[i], mz);
        }
        quad = fmaf(zt[j], mz, quad);
      }
      cost = fmaf(c.nc_half * ct, quad, cost);
    }
  };

  // ---- pass one: rollout + cost, a group of steps a Philox block set -----
  constexpr int kG = group_steps(A), kNB = kG * A / 4;
  // normals n0 .. n0 + count - 1 of v into the held prefix (normals below
  // `held`, zero in kCosts), column threadIdx.x of rows n
  auto hold = [&](int n0, int count, const float* v) {
#pragma unroll
    for (int i = 0; i < 4 * kNB; ++i)
      if (i < count && n0 + i < held)
        s_z[(n0 + i) * kBlock + threadIdx.x] = v[i];
  };
  {
    float zz[4 * kNB];
    int t0 = 0;
#pragma unroll 1
    for (; t0 + kG <= tau; t0 += kG) {
      ns.blocks<kNB>(t0 * A / 4, 4 * kNB, zz);
      if constexpr (MODE == kFused) hold(t0 * A, 4 * kNB, zz);
#pragma unroll
      for (int s = 0; s < kG; ++s) step(t0 + s, zz + s * A);
    }
    if (t0 < tau) {  // the tail, H mod kG steps
      const int rem = tau - t0;
      ns.blocks<kNB>(t0 * A / 4, rem * A, zz);
      if constexpr (MODE == kFused) hold(t0 * A, rem * A, zz);
#pragma unroll
      for (int s = 0; s + 1 < kG; ++s)
        if (s < rem) step(t0 + s, zz + s * A);
    }
  }
  cost += state_cost<S, A, COST, STRUCT>(c, x, goal);
  cost += u_half;

  const float zarg = MODE == kFused ? -cost / c.lam : -INFINITY;
  if (MODE == kCosts && valid) costs[vehicle_row(k, k_total)] = cost;
  if (MODE == kFused)
    write_partial_row_lanes<true, 1, kPassTwoBlocks>(
        &zarg, &cost, &valid, &ns, tau * A, s_red,
        partials + vehicle_row(blockIdx.x, gridDim.x) * (kStats + tau * A),
        s_z, held);
  else
    write_partial_row_lanes<false, 1>(
        &zarg, &cost, &valid, &ns, 0, s_red,
        partials + vehicle_row(blockIdx.x, gridDim.x) * kStats);
}

// Shared memory of the f32 build ahead of s_red: dyn, padded to 16 bytes,
// and kDense's rows.
template <int S, int A, int STRUCT>
constexpr int smem_lead(int dyn_size) {
  return ((dyn_size + 3) & ~3) + AbRows<S, A, STRUCT>::kWords;
}
#endif

// Philox blocks that phase B's pass two regenerates together: 16 normals
// a warp_sum_each, 16 SHFL where a per-normal warp_sum takes 80.
constexpr int kWeightBlocks = 4;
constexpr int kWeightNormals = 4 * kWeightBlocks;

// Phase B: the partial row of samples blockIdx.x * kBlock .. + kBlock, its
// normals split over gridDim.y groups of group_blocks Philox blocks each
// (normals 4 group_blocks blockIdx.y .. + 4 group_blocks). Every block
// computes its samples' w_k; group 0 alone writes the stats columns
// (m_b = 0, l_b, cost min / max / sum). Each group regenerates its
// normals kWeightBlocks Philox blocks at a time (NoiseStream::blocks,
// independent chains), multiplies each by w_k rounded alone (in the bf16
// build the normal rounded to bf16 first, NoiseStream::read_normal), and
// reduces the 16 products across the warp at once (warp_sum_each, each
// sum warp_sum's bits), then over the block's warps in order: every
// column is the per-normal loop's sum, bit for bit, at any group count.
__global__ void __launch_bounds__(kBlock)
    MPPI_KERNEL(mppi_weights)(const float* __restrict__ nrm,
                              const float* __restrict__ costs,
                              const float* __restrict__ z,
                              float* __restrict__ partials, int k_total,
                              int n_z, int group_blocks, Seeds sd) {
  extern __shared__ float s_red[];  // kWarps * the group's normals
  __shared__ float s_stat[4][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < k_total;
  // vehicle blockIdx.z's costs, nrm, z and row (mppi_common.cuh, fleets)
  const float cost = valid ? costs[vehicle_row(k, k_total)] : 0.0f;
  nrm += 2 * blockIdx.z;
  const float zarg = -(cost - nrm[0]) * nrm[1];
  const float m_b = 0.0f;  // zarg lies in [-1/lam, 0]
  const float w = valid ? expf(zarg - m_b) : 0.0f;
  float* row = partials + vehicle_row(blockIdx.x, gridDim.x) * (kStats + n_z);
  if (blockIdx.y == 0) {
    const float l_w = warp_sum(w);
    const float cmin = warp_min(valid ? cost : INFINITY);
    const float cmax = warp_max(valid ? cost : -INFINITY);
    const float csum = warp_sum(valid ? cost : 0.0f);
    if (lane == 0) {
      s_stat[0][warp] = l_w;
      s_stat[1][warp] = cmin;
      s_stat[2][warp] = cmax;
      s_stat[3][warp] = csum;
    }
  }

  const int n0 = blockIdx.y * group_blocks * 4;
  const int n_loc = min(n_z - n0, group_blocks * 4);
  NoiseStream ns;
  ns.init(vehicle_z(z, n_z, k_total), k_total, k, sd);
  constexpr int kCopies = 32 / kWeightNormals;
#pragma unroll 1
  for (int c0 = 0; c0 < n_loc; c0 += kWeightNormals) {
    const int count = min(kWeightNormals, n_loc - c0);
    float v[kWeightNormals];
    ns.blocks<kWeightBlocks>((n0 + c0) / 4, count, v);
#pragma unroll
    for (int i = 0; i < kWeightNormals; ++i)
      v[i] = i < count ? mul_r(w, NoiseStream::read_normal(v[i])) : 0.0f;
    const float s = warp_sum_each<kWeightNormals>(v, lane);
    const int n = c0 + lane / kCopies;
    if (lane % kCopies == 0 && n < n_loc) s_red[warp * n_loc + n] = s;
  }
  __syncthreads();

  if (blockIdx.y == 0 && threadIdx.x == 0) {
    float bl = 0.0f, bmin = INFINITY, bmax = -INFINITY, bsum = 0.0f;
    for (int i = 0; i < kWarps; ++i) {
      bl += s_stat[0][i];
      bmin = fminf(bmin, s_stat[1][i]);
      bmax = fmaxf(bmax, s_stat[2][i]);
      bsum += s_stat[3][i];
    }
    row[0] = m_b;
    row[1] = bl;
    row[2] = bmin;
    row[3] = bmax;
    row[4] = bsum;
    row[5] = row[6] = row[7] = 0.0f;
  }
  for (int n = threadIdx.x; n < n_loc; n += kBlock) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += s_red[i * n_loc + n];
    row[kStats + n0 + n] = s;
  }
}

// The dump's geometry: one sample a thread, kDumpThreads threads a block;
// a pass of a thread draws CH Philox blocks of its sample (CH independent
// chains), and each warp stores them through a tile of its normals in
// shared memory.
constexpr int kDumpThreads = 128;
constexpr int kDumpWarps = kDumpThreads / 32;

// One row (normal) of a warp's tile t, its samples kw .. kw + 31, stored
// by the row's eight lanes: lane q (0-7) stores samples kw + 4q + h .. + 3
// as one 16-byte streaming store. h (0-3): the samples of the row before its
// first 16-byte boundary past kw, 0 where the row starts on one (k_total
// a multiple of 4, as at every flagship shape). At h > 0 group 7's window
// would reach the next warp's samples: it stores its last 4 - h samples
// alone, and group 0 the warp's first h. A window past k_total (the row's
// tail) goes sample by sample.
__device__ __forceinline__ void dump_row(float* row, const float* t, int kw,
                                         int k_total, int h, int q) {
  if (h == 0) {
    const int s = kw + 4 * q;
    if (s + 3 < k_total) {
      __stcs(reinterpret_cast<float4*>(row + s),
             *reinterpret_cast<const float4*>(t + 4 * q));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (s + i < k_total) __stcs(row + s + i, t[4 * q + i]);
    }
    return;
  }
  if (q == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < h && kw + i < k_total) __stcs(row + kw + i, t[i]);
  }
  if (q == 7) {
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (i >= h && kw + 28 + i < k_total)
        __stcs(row + kw + 28 + i, t[28 + i]);
    return;
  }
  const int s = kw + 4 * q + h;
  const float* w = t + 4 * q + h;
  if (s + 3 < k_total) {
    __stcs(reinterpret_cast<float4*>(row + s),
           make_float4(w[0], w[1], w[2], w[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (s + i < k_total) __stcs(row + s + i, w[i]);
  }
}

template <int CH>
__global__ void __launch_bounds__(kDumpThreads)
    MPPI_KERNEL(pm_noise_dump)(float* __restrict__ out, int k_total, int n_z,
                               Seeds sd) {
  __shared__ __align__(16) float tile[kDumpWarps][CH * 4][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kDumpThreads + threadIdx.x;
  const int kw = k - lane;  // the warp's first sample
  if (kw >= k_total) return;  // a whole warp past the end
  float sign;
  const uint32_t src = noise_source(static_cast<uint32_t>(k), sd, &sign);
  uint32_t s_lo = sd.s_lo, s_hi = sd.s_hi;
  if (sd.solve != nullptr) {  // philox_normals' read of the solve index
    const unsigned long long s = __ldg(sd.solve);
    s_lo = static_cast<uint32_t>(s);
    s_hi = static_cast<uint32_t>(s >> 32);
  }
  // the words of out before its first 16-byte boundary, mod 4
  const int base = static_cast<int>(
      (reinterpret_cast<uintptr_t>(out) >> 2) & 3);
  const int q = lane & 7, rs = lane >> 3;  // this lane's store: group, row
  const int n_blk = (n_z + 3) / 4;
#pragma unroll 1
  for (int b0 = blockIdx.y * CH; b0 < n_blk; b0 += gridDim.y * CH) {
    uint4 c[CH];  // philox_normals of blocks b0 .. b0 + CH - 1
#pragma unroll
    for (int j = 0; j < CH; ++j)
      c[j] = philox4x32_10(
          make_uint4(src, static_cast<uint32_t>(b0 + j), s_lo, s_hi),
          sd.seed_lo, sd.seed_hi);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float v[4];
      box_muller(c[j].x, c[j].y, sign, v[0], v[1]);
      box_muller(c[j].z, c[j].w, sign, v[2], v[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#ifdef MPPI_BF16
        v[i] = round_bf16(v[i]);
#endif
        tile[warp][j * 4 + i][lane] = v[i];
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int n = (b0 + j) * 4 + rs;
      if (n < n_z) {
        const size_t r = static_cast<size_t>(n) * k_total;
        dump_row(out + r, tile[warp][j * 4 + rs], kw, k_total,
                 static_cast<int>((4 - ((base + r) & 3)) & 3), q);
      }
    }
    __syncwarp();  // the tile is read before the next pass writes it
  }
}

// Launch the dump at CH chains a pass: blocks of kDumpThreads samples
// along k, and along blockIdx.y about two waves of blocks (the blocks an
// SM at CH times the SMs, twice), the passes split evenly over them.
template <int CH>
cudaError_t launch_dump(float* out, int k, int n_z, const Seeds& sd,
                        int sms, cudaStream_t stream) {
  static int per_sm = 0;  // blocks an SM at CH, the same on every call
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, MPPI_KERNEL(pm_noise_dump)<CH>, kDumpThreads, 0);
    if (e != cudaSuccess) return e;
  }
  const int gx = (k + kDumpThreads - 1) / kDumpThreads;
  const int passes = ((n_z + 3) / 4 + CH - 1) / CH;
  const int fit = std::max(1, std::min(passes, 2 * sms * per_sm / gx));
  const int per = (passes + fit - 1) / fit;  // passes a thread
  const dim3 grid(gx, (passes + per - 1) / per);
  MPPI_KERNEL(pm_noise_dump)<CH><<<grid, kDumpThreads, 0, stream>>>(
      out, k, n_z, sd);
  return cudaGetLastError();
}

#ifndef MPPI_BF16
constexpr int kMergeCols = 32;    // zsum columns of a block: one a lane
constexpr int kMergeSlices = 8;   // row slices of a block: one a warp
constexpr int kMergeThreads = kMergeCols * kMergeSlices;
constexpr int kMergeChunk = 4096;  // rows whose f_b shared memory holds
constexpr int kMergeRanks = 8;     // most blocks a cluster (row slices)

// m = max_b m_b over rows [b0, b1), by every thread of the block: exact in
// any order.
__device__ __forceinline__ float block_max_m(const float* __restrict__ p,
                                             int width, int b0, int b1,
                                             float* s_w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int b = b0 + threadIdx.x; b < b1; b += kMergeThreads)
    m = fmaxf(m, p[static_cast<size_t>(b) * width]);
  m = warp_max(m);
  if (lane == 0) s_w[warp] = m;
  __syncthreads();
  float mm = s_w[0];
  for (int w = 1; w < kMergeSlices; ++w) mm = fmaxf(mm, s_w[w]);
  __syncthreads();  // s_w is reused
  return mm;
}

// Rows [b0, b1) against m: f_b = exp(m_b - m) once a row into shared
// memory (kMergeChunk rows at a time); with `stats` the row stats (l =
// sum f_b l_b, cost min / max / sum) of thread t's rows b0 + t + 256 i;
// column `col` (lane) summed over the warp's rows b0 + warp + 8 i. Every
// sum runs in a fixed order.
__device__ __forceinline__ void merge_rows(const float* __restrict__ p,
                                           int width, int n_z, int b0,
                                           int b1, float mg, bool stats,
                                           int col, float* s_f, float st[4],
                                           float* acc) {
  const int warp = threadIdx.x >> 5;
  for (int c0 = b0; c0 < b1; c0 += kMergeChunk) {
    const int c1 = min(b1, c0 + kMergeChunk);
    for (int b = c0 + threadIdx.x; b < c1; b += kMergeThreads) {
      const float* r = p + static_cast<size_t>(b) * width;
      const float f = expf(r[0] - mg);
      s_f[b - c0] = f;
      if (stats) {
        st[0] = fmaf(f, r[1], st[0]);
        st[1] = fminf(st[1], r[2]);
        st[2] = fmaxf(st[2], r[3]);
        st[3] += r[4];
      }
    }
    __syncthreads();
    if (col < n_z) {
      const float* x = p + kStats + col;
#pragma unroll 8
      for (int b = c0 + warp; b < c1; b += kMergeSlices)
        *acc = fmaf(s_f[b - c0], x[static_cast<size_t>(b) * width], *acc);
    }
    __syncthreads();  // s_f is rewritten by the next chunk
  }
}

// The block's stats (thread t's partial st) reduced over the warps in
// order into out[0 .. 3] by thread 0.
__device__ __forceinline__ void block_stats(float st[4], float (*s_red)[8],
                                            float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float l = warp_sum(st[0]), cmin = warp_min(st[1]),
              cmax = warp_max(st[2]), csum = warp_sum(st[3]);
  if (lane == 0) {
    s_red[0][warp] = l;
    s_red[1][warp] = cmin;
    s_red[2][warp] = cmax;
    s_red[3][warp] = csum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tl = 0.0f, tmin = INFINITY, tmax = -INFINITY, tsum = 0.0f;
    for (int w = 0; w < kMergeSlices; ++w) {
      tl += s_red[0][w];
      tmin = fminf(tmin, s_red[1][w]);
      tmax = fmaxf(tmax, s_red[2][w]);
      tsum += s_red[3][w];
    }
    out[0] = tl;
    out[1] = tmin;
    out[2] = tmax;
    out[3] = tsum;
  }
}

// The 8 slices' column sums of a block, a fixed-order tree.
__device__ __forceinline__ float slice_tree(float (*s_part)[kMergeCols],
                                            int lane) {
  const float* c = &s_part[0][lane];
  constexpr int L = kMergeCols;
  return ((c[0] + c[L]) + (c[2 * L] + c[3 * L])) +
         ((c[4 * L] + c[5 * L]) + (c[6 * L] + c[7 * L]));
}

// The merge: a cluster of R blocks (cluster.num_blocks(): 1, or
// kMergeRanks from kMergeClusterRows rows on) for each tile of kMergeCols
// columns. Rank r takes rows [r per, (r + 1) per), per = ceil(nb / R):
// its m_r, then (R > 1) m = max_r m_r through distributed shared memory
// after a cluster barrier; f_b, its slices' column sums and, in tile 0,
// its stats partial; the rank-0 block adds the ranks' partials in rank
// order. At R = 1 each block is a column tile alone, with no cluster
// barrier. n_z > 0 (stats-only rows: pm_merge_stats_kernel). The bound's
// minimum of one block an SM lets ptxas (CUDA 12.9) past the 32
// registers at which it spilled this kernel without one.
__global__ void __launch_bounds__(kMergeThreads, 1)
    pm_merge_kernel(const float* __restrict__ p, int nb, int n_z,
                    float* __restrict__ zsum, float* __restrict__ stats) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float s_f[];  // f_b of up to kMergeChunk rows
  __shared__ float s_part[kMergeSlices][kMergeCols];
  __shared__ float s_red[4][kMergeSlices];
  __shared__ float s_out[5 + kMergeCols];  // m_r, stats, column partials
  const int width = kStats + n_z;
  {  // vehicle blockIdx.z's rows (mppi_common.cuh, fleets)
    const size_t v = blockIdx.z;
    p += v * nb * width;
    zsum += v * n_z;
    stats += v * kStats;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ranks = static_cast<int>(cluster.num_blocks());
  int tile = blockIdx.x, b0 = 0, b1 = nb;
  if (ranks > 1) {
    const int rank = static_cast<int>(cluster.block_rank());
    const int per = (nb + ranks - 1) / ranks;
    tile = blockIdx.x / ranks;
    b0 = min(nb, rank * per);
    b1 = min(nb, b0 + per);
  }
  float mg = block_max_m(p, width, b0, b1, s_red[0]);
  if (ranks > 1) {
    if (threadIdx.x == 0) s_out[0] = mg;
    cluster.sync();
    mg = -INFINITY;
    for (int r = 0; r < ranks; ++r)
      mg = fmaxf(mg, *cluster.map_shared_rank(&s_out[0], r));
  }
  const bool with_stats = tile == 0;
  const int col = tile * kMergeCols + lane;
  float st[4] = {0.0f, INFINITY, -INFINITY, 0.0f}, acc = 0.0f;
  merge_rows(p, width, n_z, b0, b1, mg, with_stats, col, s_f, st, &acc);
  s_part[warp][lane] = acc;
  if (ranks == 1) {  // a tile alone: the outputs straight from the block
    if (with_stats) {
      block_stats(st, s_red, stats + 1);
      if (threadIdx.x == 0) {
        stats[0] = mg;
        stats[5] = stats[6] = stats[7] = 0.0f;
      }
    }
    __syncthreads();
    if (warp == 0 && col < n_z) zsum[col] = slice_tree(s_part, lane);
    return;
  }
  if (with_stats) block_stats(st, s_red, s_out + 1);
  __syncthreads();
  if (warp == 0) s_out[5 + lane] = slice_tree(s_part, lane);
  cluster.sync();
  if (cluster.block_rank() == 0) {
    if (warp == 0 && col < n_z) {
      float s = 0.0f;
      for (int r = 0; r < ranks; ++r)
        s += cluster.map_shared_rank(s_out, r)[5 + lane];
      zsum[col] = s;
    }
    if (with_stats && threadIdx.x == 0) {
      float tl = 0.0f, tmin = INFINITY, tmax = -INFINITY, tsum = 0.0f;
      for (int r = 0; r < ranks; ++r) {
        const float* o = cluster.map_shared_rank(s_out, r);
        tl += o[1];
        tmin = fminf(tmin, o[2]);
        tmax = fmaxf(tmax, o[3]);
        tsum += o[4];
      }
      stats[0] = mg;
      stats[1] = tl;
      stats[2] = tmin;
      stats[3] = tmax;
      stats[4] = tsum;
      stats[5] = stats[6] = stats[7] = 0.0f;
    }
  }
  cluster.sync();  // the ranks' shared memory outlives rank 0's reads
}

// Stats-only rows (n_z = 0, after phase A): one block, each thread over
// rows t, t + 256, ..., its stats reduced over the warps in order.
__global__ void __launch_bounds__(kMergeThreads, 1)
    pm_merge_stats_kernel(const float* __restrict__ p, int nb,
                          float* __restrict__ stats) {
  __shared__ float s_red[4][kMergeSlices];
  p += static_cast<size_t>(blockIdx.z) * nb * kStats;  // vehicle's rows
  stats += static_cast<size_t>(blockIdx.z) * kStats;
  const float mg = block_max_m(p, kStats, 0, nb, s_red[0]);
  float st[4] = {0.0f, INFINITY, -INFINITY, 0.0f};
  for (int b = threadIdx.x; b < nb; b += kMergeThreads) {
    const float* r = p + static_cast<size_t>(b) * kStats;
    st[0] = fmaf(expf(r[0] - mg), r[1], st[0]);
    st[1] = fminf(st[1], r[2]);
    st[2] = fmaxf(st[2], r[3]);
    st[3] += r[4];
  }
  block_stats(st, s_red, stats + 1);
  if (threadIdx.x == 0) {
    stats[0] = mg;
    stats[5] = stats[6] = stats[7] = 0.0f;
  }
}

// The launch floor: a kernel that does nothing.
__global__ void pm_empty_kernel() {}
#endif  // MPPI_BF16: pm_merge reads f32 partial rows only

// The launch of one solve: k samples over horizon tau; scheduled (0 / 1)
// appends the tau factors c_t to dyn. With occupancy set nothing launches:
// the kernel's blocks an SM at this shared memory are written there.
struct PmLaunch {
  const float* consts;  // PmConsts.packed
  const float* dyn;
  const float* z;
  float* costs;
  float* partials;
  int k, tau, scheduled;
  Seeds sd;
  cudaStream_t stream;
  int* occupancy;
  int n;     // vehicles: the grid's third axis
  int held;  // normals a sample held in shared memory (kFused)
};

template <int S, int A, int MODE, int COST, int AB, int STRUCT>
int launch_solve(const PmLaunch& a) {
  HostConsts<S, A> f;
  memcpy(&f, a.consts, sizeof(f));
#ifdef MPPI_BF16
  const Consts<S, A> c = pair_consts(f);
#else
  const Consts<S, A>& c = f;
#endif
  const int base = 1 + 2 * S + a.tau * (S + A) + 1 +
                   (AB == kDynAB ? S * S + S * A : 0);
  const int sched_off = a.scheduled ? base : -1;
  const int dyn_size = a.scheduled ? base + a.tau : base;
  auto kernel = MPPI_KERNEL(pm_fused_solve)<S, A, MODE, COST, AB, STRUCT>;
  size_t smem = 0;
  // the held prefix: every normal, or whole Philox blocks; none in kCosts
  // and in the pair build
  const int n_z = MODE == kFused ? a.tau * A : 0;
  const int held = MODE == kFused ? a.held : 0;
  if (held < 0 || held > n_z || (held < n_z && held % 4 != 0) ||
      (kLanes > 1 && held != 0))
    return cudaErrorInvalidValue;
  // dyn and the dense rows, the held rows, then s_red
  const cudaError_t e = smem_for(
      kernel, smem_lead<S, A, STRUCT>(dyn_size) + held * kBlock, n_z, &smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // not left to fail the next launch's check
    return e;
  }
  if (a.occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kernel,
                                                         kThreads, smem);
  const dim3 grid((a.k + kBlock - 1) / kBlock, 1, a.n);
  MPPI_KERNEL(pm_fused_solve)<S, A, MODE, COST, AB, STRUCT>
      <<<grid, kThreads, smem, a.stream>>>(c, a.dyn, dyn_size, sched_off, a.z,
                                         a.costs, a.partials, a.k, a.tau,
                                         held, a.sd);
  return cudaGetLastError();
}

template <int MODE, int AB, int STRUCT>
int dispatch_dims(int sdim, int adim, int cost, const PmLaunch& a) {
  if (cost == kElipse) {
    if (sdim == 4 && adim == 2)
      return launch_solve<4, 2, MODE, kElipse, AB, STRUCT>(a);
    return cudaErrorInvalidValue;
  }
  if (cost != kQuadratic) return cudaErrorInvalidValue;
  if (sdim == 6 && adim == 3)
    return launch_solve<6, 3, MODE, kQuadratic, AB, STRUCT>(a);
  if (sdim == 2 && adim == 1)
    return launch_solve<2, 1, MODE, kQuadratic, AB, STRUCT>(a);
  if (sdim == 4 && adim == 2)
    return launch_solve<4, 2, MODE, kQuadratic, AB, STRUCT>(a);
  return cudaErrorInvalidValue;
}

// kIntegrator exists in the f32 build alone, with constant (A, B).
template <int MODE>
int dispatch_solve(int sdim, int adim, int cost, int structure, int dyn_ab,
                   const PmLaunch& a) {
  if (a.k <= 0 || a.tau <= 0 || a.n <= 0 || a.n > 65535 ||
      (a.n > 1 && a.sd.solve == nullptr))
    return cudaErrorInvalidValue;
  if (structure == kDense) {
    if (dyn_ab)
      return dispatch_dims<MODE, kDynAB, kDense>(sdim, adim, cost, a);
    return dispatch_dims<MODE, kConstAB, kDense>(sdim, adim, cost, a);
  }
#ifndef MPPI_BF16
  if (structure == kIntegrator && !dyn_ab)
    return dispatch_dims<MODE, kConstAB, kIntegrator>(sdim, adim, cost, a);
#endif
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The solves, mppi_weights and pm_merge take `n`, the vehicles of a fleet
// launch (mppi_common.cuh), last before the stream: every array they read
// or write then holds n vehicles' rows, one after another, and at n > 1
// `solve` holds the n vehicles' solve indices on the device; n = 1 is the
// one-vehicle launch.
//
// Every entry point that reads the noise takes `half`, the first mirrored
// sample of an antithetic solve (0: none; mppi_common.cuh), and the solve
// index as two words or, where `solve` is not null, at that device
// address (Seeds in mppi_common.cuh), and the solves
// take `scheduled` (1: dyn ends in the tau factors c_t) and `dynamic_ab`
// (1: A and B scale are read from dyn, PmAB kDynAB). pm_mppi_bf16.cu
// defines the same entry points with a _bf16 suffix (not pm_merge).
int MPPI_ENTRY(pm_noise_dump)(float* out, int k, int n_z, uint32_t half,
                  uint32_t seed_lo, uint32_t seed_hi, uint32_t s_lo,
                  uint32_t s_hi, const unsigned long long* solve,
                  void* stream) {
  if (k <= 0 || n_z <= 0) return cudaErrorInvalidValue;
  const Seeds sd{seed_lo, seed_hi, s_lo, s_hi, half, solve};
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // two chains a pass once one a pass would take more than a wave of
  // blocks; below that (log mode's [H, adim, 512]) the latency of one
  // chain, over the most SMs, bounds the dump
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = static_cast<long long>(
      (k + kDumpThreads - 1) / kDumpThreads) * ((n_z + 3) / 4);
  return blocks > static_cast<long long>(sms) * (2048 / kDumpThreads)
             ? launch_dump<2>(out, k, n_z, sd, sms, st)
             : launch_dump<1>(out, k, n_z, sd, sms, st);
}

// consts: PmConsts.packed, sizeof(HostConsts<sdim, adim>) bytes; cost:
// PmCost; structure: PmStruct (kDense alone in the bf16 build and with
// dynamic_ab).
int MPPI_ENTRY(pm_fused_solve)(int sdim, int adim, int cost, int structure,
                               const float* consts,
                   const float* dyn, const float* z, float* partials, int k,
                   int tau, int scheduled, int dynamic_ab, uint32_t half,
                   uint32_t seed_lo, uint32_t seed_hi, uint32_t s_lo,
                   uint32_t s_hi, const unsigned long long* solve, int n,
                   int held, void* stream) {
  return dispatch_solve<kFused>(
      sdim, adim, cost, structure, dynamic_ab,
      PmLaunch{consts, dyn, z, nullptr, partials, k, tau, scheduled,
               Seeds{seed_lo, seed_hi, s_lo, s_hi, half, solve},
               static_cast<cudaStream_t>(stream), nullptr, n, held});
}

int MPPI_ENTRY(pm_fused_costs)(int sdim, int adim, int cost, int structure,
                               const float* consts,
                   const float* dyn, const float* z, float* costs,
                   float* partials, int k, int tau, int scheduled,
                   int dynamic_ab, uint32_t half, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t s_lo, uint32_t s_hi,
                   const unsigned long long* solve, int n, void* stream) {
  return dispatch_solve<kCosts>(
      sdim, adim, cost, structure, dynamic_ab,
      PmLaunch{consts, dyn, z, costs, partials, k, tau, scheduled,
               Seeds{seed_lo, seed_hi, s_lo, s_hi, half, solve},
               static_cast<cudaStream_t>(stream), nullptr, n, 0});
}

// out[0]: blocks an SM of the solve (mode 0) or costs (1) kernel of
// (sdim, adim, cost, structure, dynamic_ab) at horizon tau, unscheduled,
// the solve holding `held` normals a sample; out[1]: samples a thread.
int MPPI_ENTRY(pm_occupancy)(int sdim, int adim, int cost, int structure,
                             int mode, int dynamic_ab, int tau, int held,
                             int* out) {
  static const float zeros[sizeof(HostConsts<6, 3>) / sizeof(float)] = {};
  const PmLaunch a{zeros, nullptr, nullptr, nullptr, nullptr, 1, tau, 0,
                   Seeds{}, nullptr, out, 1, held};
  out[1] = kLanes;
  return mode ? dispatch_solve<kCosts>(sdim, adim, cost, structure,
                                       dynamic_ab, a)
              : dispatch_solve<kFused>(sdim, adim, cost, structure,
                                       dynamic_ab, a);
}

// mppi_weights launches a grid of (ceil(k / 256), G): G groups of the
// n_z normals' Philox blocks, each group a whole number of kWeightBlocks
// chunks, kWeightGroupChunks (48 normals) a group as near as the chunks
// divide: G = ceil(chunks / 3). A sweep of G on the H100 put this rule at
// or next to the fastest G at every flagship shape (K=65,536 to 262,144,
// n_z = 150 and 300); one group (the whole row a block) and one chunk a
// group both ran slower. The grid then holds 1.3-5.2 waves of the
// kernel's six blocks an SM: a partial wave's tail is a group's work, and
// a group's fixed work (its w_k, its share of the row) stays small beside
// its three chunks. No G changes a bit of the rows.
constexpr int kWeightGroupChunks = 3;

// (G, Philox blocks a group) of a phase B over n_z normals.
static void weights_groups(int n_z, int* gy, int* group_blocks) {
  const int chunks = ((n_z + 3) / 4 + kWeightBlocks - 1) / kWeightBlocks;
  const int groups = (chunks + kWeightGroupChunks - 1) / kWeightGroupChunks;
  const int per = (chunks + groups - 1) / groups;
  *group_blocks = per * kWeightBlocks;
  *gy = (chunks + per - 1) / per;
}

int MPPI_ENTRY(mppi_weights)(const float* nrm, const float* costs,
                             const float* z, float* partials, int k,
                             int n_z, uint32_t half, uint32_t seed_lo,
                             uint32_t seed_hi, uint32_t s_lo, uint32_t s_hi,
                             const unsigned long long* solve, int n,
                             void* stream) {
  if (k <= 0 || n_z <= 0 || n <= 0 || n > 65535 ||
      (n > 1 && solve == nullptr))
    return cudaErrorInvalidValue;
  int gy = 1, group_blocks = 0;
  weights_groups(n_z, &gy, &group_blocks);
  size_t smem = 0;
  const cudaError_t e = smem_for(MPPI_KERNEL(mppi_weights), 0,
               std::min(n_z, 4 * group_blocks), &smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((k + kBlock - 1) / kBlock, gy, n);
  MPPI_KERNEL(mppi_weights)<<<grid, kBlock, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      nrm, costs, z, partials, k, n_z, group_blocks,
      Seeds{seed_lo, seed_hi, s_lo, s_hi, half, solve});
  return cudaGetLastError();
}

// out[0]: blocks an SM of the phase-B kernel, out[1]: the G the rule picks
// for n_z normals.
int MPPI_ENTRY(mppi_weights_occupancy)(int n_z, int* out) {
  if (n_z <= 0) return cudaErrorInvalidValue;
  int group_blocks = 0;
  weights_groups(n_z, &out[1], &group_blocks);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], MPPI_KERNEL(mppi_weights), kBlock, 0);
}

#ifndef MPPI_BF16
// pm_merge launches one block of pm_merge_stats_kernel for stats-only
// rows (n_z = 0), else ceil(n_z / 32) column tiles of pm_merge_kernel:
// from kMergeClusterRows rows on a cluster of kMergeRanks blocks a tile,
// below that one block a tile, launched without a cluster. A sweep of
// the cluster size on the H100 found one block a tile fastest at the
// point mass's 391 rows and eight the fastest at the AUV's 1,024.
constexpr int kMergeClusterRows = 640;
int pm_merge(const float* partials, int nb, int n_z, float* zsum,
             float* stats, int n, void* stream) {
  if (nb <= 0 || n_z < 0 || n <= 0 || n > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_z == 0) {
    pm_merge_stats_kernel<<<dim3(1, 1, n), kMergeThreads, 0, st>>>(
        partials, nb, stats);
    return cudaGetLastError();
  }
  const int ranks = nb >= kMergeClusterRows ? kMergeRanks : 1;
  const int tiles = (n_z + kMergeCols - 1) / kMergeCols;
  const size_t smem =
      std::min((nb + ranks - 1) / ranks, kMergeChunk) * sizeof(float);
  if (ranks == 1) {
    pm_merge_kernel<<<dim3(tiles, 1, n), kMergeThreads, smem, st>>>(
        partials, nb, n_z, zsum, stats);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * ranks, 1, n);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, pm_merge_kernel, partials, nb, n_z, zsum,
                         stats);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the launch floor pm_merge is measured against (chip_smoke.py)
int pm_empty(void* stream) {
  pm_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// out[3]: the current card's shared memory in bytes: the most a block may
// opt in to, an SM's, and what the system reserves a block (what the held
// prefix of kernels/pm_mppi.py held_normals is sized from)
int pm_smem_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &out[1], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[2],
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return e;
}

const char* pm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // MPPI_BF16

}  // extern "C"
