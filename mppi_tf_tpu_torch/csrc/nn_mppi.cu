// Fused learned-dynamics (NNAUVModel MLP) MPPI solve for Hopper (sm_90a),
// plain C interface; built with the other sources into one library by
// kernels/_build.py.
//
// nn_fused_solve_kernel<N1, N2, N3, MODE> replaces the TPU kernel
//   mppi_tf_tpu/kernels/nn_mppi.py::_nn_pallas (body _make_nn_kernel, the
//   MLP at :279-292 in f32 VPU FMAs, noise _fill_noise_steps): MODE kFused
//   is _fused_nn_call (mode "fused"), MODE kCosts _fused_nn_costs (mode
//   "costs", phase A of the normalized solve). Phase B (_fused_nn_weights,
//   mode "weights") is mppi_weights in pm_mppi.cu at adim 6, shared with
//   the other models.
//
//   Per step t of sample k, with the normals z_t (6) of the port's one
//   Philox stream (mppi_common.cuh NoiseStream, normal n = t*6 + j):
//     u = useq_t + scale (c_t z_t)     (c_t: the schedule, 1 unscheduled)
//     h = [x[3:13], u] (16 features, position dropped)
//     h = relu(W1' h + b1'), ..., delta = W_L' h + b_L'   (ReLU hidden, linear out)
//     x += delta; quaternion renormalised (rsqrt, floor 1e-24 on |q|^2)
//     cost += q(x) + rhs_z_t . z_t + nc_half c_t z_t^T Mz z_t
//   (the TPU kernel's :255-275 and :323), then + q(x_H) + u_half, with q
//   the StaticQuatCost (mppi_common.cuh). The schedule (c_t at the end of
//   dyn) and the antithetic mirror (`half` in Seeds, the XLA layout of
//   mppi_common.cuh, not _fill_noise_steps' :110-114) are runtime
//   arguments, not instantiations.
//
//   Weights are runtime data. kernels/nn_mppi.py FusedNNMPPI.pack_dyn folds
//   the X/Y normalisers into layers 1 and L on the device with torch ops
//   (W1' = W1 / x_std, b1' = b1 - (x_mean / x_std) W1; W_L' = W_L y_std,
//   b_L' = b_L y_std + y_mean) and writes every layer as W^T rows (one row
//   of fan_in floats an output) and its biases, each layer's block padded to
//   a multiple of 4 floats, ahead of the per-solve scalars in dyn. A weight
//   update (a learner step) reaches the kernel as data: nothing rebuilds.
//   The widths are template parameters: (32, 32, 32), the reference
//   topology 16->32->32->32->13, and (8, 8), the test topology. The wrapper
//   raises on any other.
//
// The f32 body: the MLP on the tensor cores (mma.sync), the rest on the
// CUDA cores. Thread i of a block of kBlock = 256 owns sample
// 256 b + i for everything that is not the MLP: its 13-state, cost, Philox
// stream, the force, the renormalisation, the StaticQuatCost and the z
// terms, in the order above. The MLP is a product over samples: warp w's
// 32 samples are two m16 tiles of the [K, 16] x [16, 32] ... [K, 32] x
// [32, 13] chain. Per step each lane writes its 16 features to its row of
// the warp's [32 x 16] f32 tile in shared memory; after __syncwarp the
// warp loads the A fragments of an m tile (both at once in the bf16
// build, kMTiles), runs the layers with the activations in registers, and
// writes the last layer's C fragments (13 outputs padded to 16) back into
// the tile, where each lane reads its delta row. No block barrier inside the horizon loop; every lane takes
// part in every mma, the samples past k_total on valid inputs (injected z
// reads 0 there), masked in the partial row as before.
//
//   f32 build: 3xTF32, mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. Each
//   operand a is split into a_hi = cvt.rna.tf32(a) and a_lo =
//   cvt.rna.tf32(a - a_hi) (the weights once, at staging; the activations
//   at use), and c += a_lo b_hi, then a_hi b_lo, then a_hi b_hi: the small
//   products first, into the bias that initialises C. The dropped a_lo b_lo
//   and the splits' remainders are ~2^-22 of each product, a few f32 ulps:
//   the port's COST_RTOL 1e-4 against the plain f32 version holds
//   (tests/test_torch_nn_kernel.py emulates this arithmetic on the CPU
//   against the f64 JAX rollout).
//   bf16-products build (nn_mppi_bfp.cu): mma.sync.m16n8k16.row.col.
//   f32.bf16.bf16.f32, bf16 operands with exact products and f32
//   accumulation, what the XLA path's mlp_apply computes; a fan_in of 8
//   is one k16 step with its upper half 0.
//
//   Fragment layout (lane = 4 g + t). C of n tile j holds units 8 j + 2 t
//   and 8 j + 2 t + 1 of rows g and g + 8: c0 = (g, 2t), c1 = (g, 2t+1),
//   c2 = (g+8, 2t), c3 = (g+8, 2t+1). In the f32 build the next layer's A
//   of k block j is taken straight from it, a0 = c0, a1 = c2, a2 = c1,
//   a3 = c3: its logical column t holds unit 8 j + 2 t and column t + 4
//   unit 8 j + 2 t + 1, so that layer's B rows are staged in that order
//   (b0 = W^T[8 n + g][8 j + 2 t], b1 = W^T[8 n + g][8 j + 2 t + 1], two
//   neighbours of a W^T row); the first layer reads its A from the tile in
//   the same order. In the bf16 build the C fragments of n tiles 2 j and
//   2 j + 1, packed by cvt.rn.bf16x2 (the round of each hidden output, as
//   the plain version rounds it), are A of k16 block j in natural order.
//   Each layer's B fragments sit in shared memory in lane order, one
//   16-byte {b0 hi, b1 hi, b0 lo, b1 lo} (bf16: 8-byte {b0, b1}) a lane a
//   (k block, n tile), staged once a block from dyn's W^T rows, so that a
//   warp's fragment load is one conflict-free LDS.128 (LDS.64, reused by
//   both m tiles) (3 x 32: 24 KB at f32, 6 KB at bf16); the biases,
//   padded to whole n tiles, initialise C. The tile's rows are padded to
//   20 floats and mma row g holds the sample of tile row 2 (g % 4) + g / 4
//   (mma_row), so that the lanes' 16-byte row writes and reads and the
//   warp's 8-byte fragment loads and stores are all free of bank
//   conflicts, each at a lane's base plus a constant.
//
//   Bound: at K=65,536, H=25, 3x32 the padded MLP is 3,072 MACs a
//   sample-step, 3 x 2 x 3,072 flops of TF32 (0.061 ms at 495 TFLOP/s;
//   bf16 2 x 3,072, 0.010 ms at 989), beside ~0.7 kFLOP a sample-step of
//   force, renormalisation, cost, Philox and Box-Muller and the splits'
//   conversions on the CUDA cores (~0.02 ms at 67 TFLOP/s)
//   (chip_smoke.py::nn_tc_bound). The scalar form this body replaces,
//   2,976 FFMAs a sample-step fed by 16-byte broadcast loads, is bound at
//   0.157 ms by the f32 FMA rate alone. Two blocks of 256 an SM (__launch_bounds__:
//   at most 128 registers a thread): K=65,536 is one wave of 256 blocks in
//   264 slots.
//
//   The TPU kernel's folded (8, L) layout, its per-step noise scratch, its
//   pid == 0 initialisation and its read-modify-write carry across the grid
//   are not copied: each block writes its partial row (mppi_common.cuh),
//   merged by pm_merge as for the other models.
//
// Two more builds of this source, each a translation unit of its own:
// * nn_mppi_bf16.cu, the bf16 block compute (compute_dtype "bfloat16",
//   :148-149, :191-325): Val = bf16x2 (mppi_common.cuh, MPPI_BF16_PAIRS),
//   two samples a thread and 128 threads a block for one partial row,
//   kernels and entry points suffixed _bf16. It keeps its own body of
//   bf16x2 FMA chains: the TPU kernel's bf16 blocks round every product
//   and every sum of the MLP chains to bf16 (acc + w h, in the order of
//   fan_in), which no tensor-core product with f32 accumulation computes.
//   The folded weights and biases are staged as duplicated bf16x2 words
//   (w, w) in place, so a float4 read of a W^T row is 4 weights a 16-byte
//   broadcast load and 8 bf16x2 instructions for the two samples; x0,
//   useq and rhs_z are staged as words too, scale and Mz come as words in
//   the kernel's constants (NnConstsT, packed by the entry point), and the
//   noise is rounded as it is drawn (one cvt a normal pair). The force
//   u_t + c_t (scale z_t) in the TPU kernel's order, every MLP chain
//   acc + w h (each product and sum rounded), the ReLU (max.bf16x2 against
//   +0, as fmaxf) and the state update are bf16; the renormalisation's
//   rsqrt, the StaticQuatCost (against the unrounded goal) and each lane's
//   cost sum are f32, the z terms bf16 values added to it (:296-325).
// * nn_mppi_bfp.cu, the f32 body for a model whose compute_dtype is bf16
//   (suffix _bfp): the JAX XLA path's bf16 products with f32 accumulation
//   (models/nn.py mlp_apply), not the TPU kernel, which ignores the
//   model's compute_dtype. The normalisers are not folded: they sit after
//   the layers in dyn (x_mean, x_std, y_mean, y_std), the features are
//   normalised in f32 and rounded, the weights come rounded from the host,
//   each hidden layer's output is rounded as the next layer's input, the
//   biases and the output's denormalisation stay f32.

#include <string.h>

#include "mppi_common.cuh"

namespace {

using namespace mppi;

constexpr int kFeatures = 16;  // 10 state features (x[3:13]) + 6 actions
constexpr int kSdim = 13;
constexpr int kAdim = 6;

// Solve constants, in the order of kernels/nn_mppi.py NnConsts.packed; W:
// float, or in the pair build the bf16x2 word (w, w) of each.
template <typename W>
struct NnConstsT {
  float lam;
  float nc_half;
  float renorm;  // 1: renormalise the quaternion after each step
  float pad;
  W scale[36];   // upsilon sigma, row-major
  W mz[36];      // scale^T Sigma^-1 scale
  float q[100];  // 10x10 cost weight
};
using HostConsts = NnConstsT<float>;
#ifdef MPPI_BF16_PAIRS
using NnConsts = NnConstsT<bf16x2>;

// scale and Mz (bf16 values, packed rounded by the host) as words
NnConsts pair_consts(const HostConsts& f) {
  NnConsts c;
  memcpy(&c, &f, sizeof(c));
  for (int i = 0; i < 36; ++i) {
    c.scale[i] = bf16x2(f.scale[i]);
    c.mz[i] = bf16x2(f.mz[i]);
  }
  return c;
}
#else
using NnConsts = HostConsts;
#endif
static_assert(sizeof(NnConsts) == 176 * sizeof(float), "NnConsts layout");

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// one layer's block in dyn: O rows of I weights (W^T), O biases, padded
__host__ __device__ constexpr int layer_floats(int i, int o) {
  return round4(o * i + o);
}

// The bf16-products build puts the normalisers (x mean, x std, y mean,
// y std) after the layers.
#ifdef MPPI_NN_BF16_PRODUCTS
constexpr int kNormFloats = round4(2 * kFeatures + 2 * kSdim);
#else
constexpr int kNormFloats = 0;
#endif

// Offsets of the folded layers in dyn for hidden widths (N1, N2, N3);
// N3 == 0: two hidden layers. kernels/nn_mppi.py NNDyn is the same layout.
template <int N1, int N2, int N3>
struct Topo {
  static constexpr int kLast = N3 ? N3 : N2;
  static constexpr int w1 = 0;
  static constexpr int w2 = w1 + layer_floats(kFeatures, N1);
  static constexpr int w3 = w2 + layer_floats(N1, N2);
  static constexpr int wl = w3 + (N3 ? layer_floats(N2, N3) : 0);
  static constexpr int size = wl + layer_floats(kLast, kSdim);
  static constexpr int norm = size;
  static constexpr int end = size + kNormFloats;
};

#ifdef MPPI_BF16_PAIRS
// ---- the bf16 pair build: bf16x2 chains on the CUDA cores -------------

// out = act(W^T in + b) over one block of dyn in shared memory (16-byte
// aligned): row j of W^T is read as I / 4 broadcast float4 loads of
// staged words.
template <int I, int O, bool kRelu>
__device__ __forceinline__ void dense(const float* __restrict__ w,
                                      const Val* in, Val* out) {
  static_assert(I % 4 == 0, "fan_in must be a multiple of 4");
  const float4* rows = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < O; ++j) {
    Val acc = exact_val(w[O * I + j]);
#pragma unroll
    for (int i = 0; i < I / 4; ++i) {
      const float4 v = rows[j * (I / 4) + i];
      acc = fma_r(exact_val(v.x), in[4 * i], acc);
      acc = fma_r(exact_val(v.y), in[4 * i + 1], acc);
      acc = fma_r(exact_val(v.z), in[4 * i + 2], acc);
      acc = fma_r(exact_val(v.w), in[4 * i + 3], acc);
    }
    out[j] = kRelu ? relu_r(acc) : acc;
  }
}

// delta = MLP(features) over the folded weights at s_w.
template <int N1, int N2, int N3>
__device__ __forceinline__ void mlp(const float* __restrict__ s_w,
                                    const Val* feats, Val* delta) {
  using T = Topo<N1, N2, N3>;
  Val h1[N1];
  dense<kFeatures, N1, true>(s_w + T::w1, feats, h1);
  Val h2[N2];
  dense<N1, N2, true>(s_w + T::w2, h1, h2);
  if constexpr (N3 != 0) {
    Val h3[N3];
    dense<N2, N3, true>(s_w + T::w3, h2, h3);
    dense<N3, kSdim, false>(s_w + T::wl, h3, delta);
  } else {
    dense<N2, kSdim, false>(s_w + T::wl, h2, delta);
  }
}

// StaticQuatCost of lane l of a rollout state, at bf16 on the state
// widened to f32.
__device__ __forceinline__ float rollout_state_cost(const float* q,
                                                   const Val* x,
                                                   const float* goal,
                                                   int l) {
  float xf[kSdim];
#pragma unroll
  for (int i = 0; i < kSdim; ++i) xf[i] = widen(x[i], l);
  return quat_state_cost(q, xf, goal);
}

// floats of dynamic shared memory ahead of the pass-two sums: dyn
template <int N1, int N2, int N3>
__host__ __device__ constexpr int staged_floats(int dyn_size) {
  return round4(dyn_size);
}

// The (8, 8) network has a floor of two blocks an SM: at ptxas's own
// 80-register target it spills.
template <int N1, int N2, int N3, int MODE>
__global__ void __launch_bounds__(kThreads, N3 == 0 ? 2 : 0)
    MPPI_KERNEL(nn_fused_solve)(const NnConsts c,
                                const float* __restrict__ dyn, int dyn_size,
                                int sched_off, const float* __restrict__ z,
                                float* __restrict__ costs,
                                float* __restrict__ partials, int k_total,
                                int tau, Seeds sd) {
  using T = Topo<N1, N2, N3>;
  extern __shared__ __align__(16) float smem[];
  float* s_dyn = smem;                     // dyn_size
  float* s_red = smem + round4(dyn_size);  // kWarps * n_z: pass-two sums

  // the layers, x0, useq and rhs_z staged as bf16x2 words (the rollout's
  // operands); the goal, u_half and c_t stay f32
  for (int i = threadIdx.x; i < dyn_size; i += kThreads) {
    const int from_x0 = i - T::end;
    const bool word = i < T::size ||
                      (from_x0 >= 0 && from_x0 < kSdim) ||
                      (from_x0 >= 2 * kSdim &&
                       from_x0 < 2 * kSdim + 2 * kAdim * tau);
    s_dyn[i] = word ? stage_word(dyn[i]) : dyn[i];
  }
  __syncthreads();

  // dyn layout (kernels/nn_mppi.py NNDyn): layers, x0, goal, useq, rhs_z,
  // u_half, then the schedule's c_t at sched_off when scheduled
  const float* x0 = s_dyn + T::end;
  const float* goal = x0 + kSdim;
  const float* useq = goal + kSdim;
  const float* rhs_z = useq + kAdim * tau;
  const float u_half = rhs_z[kAdim * tau];

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
    ns[l].init(z, k_total, k[l], sd);
    cost[l] = 0.0f;
  }

  Val x[kSdim];
#pragma unroll
  for (int i = 0; i < kSdim; ++i) x[i] = exact_val(x0[i]);
  int n = 0;
#pragma unroll 1
  for (int t = 0; t < tau; ++t) {
    // the weights are loop-invariant: without this barrier the compiler
    // hoists the (8, 8) network's ~330 shared-memory loads out of the
    // horizon loop into registers and spills; each step reloads them from
    // shared memory instead
    asm volatile("" ::: "memory");
    const float ct = sched_factor(s_dyn, sched_off, t);
    Val zt[kAdim], feats[kFeatures];
#pragma unroll
    for (int j = 0; j < kAdim; ++j) zt[j] = draw(ns, n++);
#pragma unroll
    for (int i = 0; i < kSdim - 3; ++i) feats[i] = x[3 + i];
    // u_t + c_t (scale z_t), the TPU kernel's order (:255-275)
    const Val ct_v = to_val(ct);
#pragma unroll
    for (int i = 0; i < kAdim; ++i) {
      Val sz = 0.0f;
#pragma unroll
      for (int j = 0; j < kAdim; ++j)
        sz = fma_r(exact_val(c.scale[i * kAdim + j]), zt[j], sz);
      feats[kSdim - 3 + i] = exact_val(useq[t * kAdim + i]) + ct_v * sz;
    }
    Val delta[kSdim];
    mlp<N1, N2, N3>(s_dyn, feats, delta);
#pragma unroll
    for (int i = 0; i < kSdim; ++i) x[i] += delta[i];
    if (c.renorm != 0.0f) {
      const Val s2 = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6];
      const Val inv =
          per_lane(s2, [](float v) { return rsqrtf(fmaxf(v, 1e-24f)); });
#pragma unroll
      for (int i = 3; i < 7; ++i) x[i] *= inv;
    }

#pragma unroll
    for (int l = 0; l < kLanes; ++l)
      cost[l] += rollout_state_cost(c.q, x, goal, l);
    Val quad = 0.0f;
#pragma unroll
    for (int j = 0; j < kAdim; ++j) {
      const Val rz = exact_val(rhs_z[t * kAdim + j]) * zt[j];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) cost[l] += widen(rz, l);
      Val mz = 0.0f;
#pragma unroll
      for (int i = 0; i < kAdim; ++i)
        mz = fma_r(exact_val(c.mz[j * kAdim + i]), zt[i], mz);
      quad = fma_r(zt[j], mz, quad);
    }
    const Val nq = to_val(c.nc_half * ct) * quad;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) cost[l] += widen(nq, l);
  }

  float zarg[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    cost[l] += rollout_state_cost(c.q, x, goal, l);
    cost[l] += u_half;
    zarg[l] = MODE == kFused ? -cost[l] / c.lam : -INFINITY;
    if (MODE == kCosts && valid[l]) costs[k[l]] = cost[l];
  }
  if (MODE == kFused)
    write_partial_row_lanes<true, kLanes>(
        zarg, cost, valid, ns, tau * kAdim, s_red,
        partials + static_cast<size_t>(blockIdx.x) * (kStats + tau * kAdim));
  else
    write_partial_row_lanes<false, kLanes>(
        zarg, cost, valid, ns, 0, s_red,
        partials + static_cast<size_t>(blockIdx.x) * kStats);
}

#else
// ---- the f32 and bf16-products builds: the MLP on the tensor cores -----

// One mma.sync shape a build: the k of one product, an A register, a
// lane's staged B fragment of one (k block, n tile), and kMTiles, the m16
// tiles of a warp's 32 samples that run the MLP together (each B fragment
// load serves them all). The f32 build takes one at a time: with both, its
// activations, accumulators and splits spill at 128 registers a thread;
// the bf16 build runs both, 8-11% faster than one (PERF.md).
#ifdef MPPI_NN_BF16_PRODUCTS
constexpr int kMmaK = 16;  // m16n8k16, bf16 operands
constexpr int kMTiles = 2;
using AReg = uint32_t;     // a bf16x2 pair of A
using BFrag = uint2;       // {b0, b1}, bf16x2 pairs
#else
constexpr int kMmaK = 8;   // m16n8k8, tf32 operands
constexpr int kMTiles = 1;
using AReg = float;        // an f32 value of A, split at use
using BFrag = float4;      // {b0 hi, b1 hi, b0 lo, b1 lo}
#endif
constexpr int kFragFloats = sizeof(BFrag) / sizeof(float);
constexpr int kTileStride = kFeatures + 4;  // floats a tile row, padded
constexpr int kTile = 32 * kTileStride;     // a warp's [32 x 16] f32 tile

__host__ __device__ constexpr int ksteps(int fan_in) {
  return (fan_in + kMmaK - 1) / kMmaK;
}
__host__ __device__ constexpr int ntiles(int fan_out) {
  return (fan_out + 7) / 8;
}
// a layer's B fragments, and its biases as C fragments {b_2t, b_2t+1,
// b_2t, b_2t+1} a (n tile, t), floats
__host__ __device__ constexpr int frag_floats(int i, int o) {
  return ksteps(i) * ntiles(o) * 32 * kFragFloats;
}
__host__ __device__ constexpr int bias_floats(int o) {
  return 16 * ntiles(o);
}

// Dynamic shared memory of the body (floats): each layer's B fragments,
// each layer's biases, the warps' tiles, then dyn from its normalisers on
// (the rest: normalisers, x0, goal, useq, rhs_z, u_half, c_t) and the
// pass-two sums.
template <int N1, int N2, int N3>
struct Smem {
  static constexpr int kLast = N3 ? N3 : N2;
  static constexpr int frag1 = 0;
  static constexpr int frag2 = frag1 + frag_floats(kFeatures, N1);
  static constexpr int frag3 = frag2 + frag_floats(N1, N2);
  static constexpr int fragl = frag3 + (N3 ? frag_floats(N2, N3) : 0);
  static constexpr int bias1 = fragl + frag_floats(kLast, kSdim);
  static constexpr int bias2 = bias1 + bias_floats(N1);
  static constexpr int bias3 = bias2 + bias_floats(N2);
  static constexpr int biasl = bias3 + (N3 ? bias_floats(N3) : 0);
  static constexpr int tiles = biasl + bias_floats(kSdim);
  static constexpr int rest = tiles + kWarps * kTile;
};

// floats of dynamic shared memory ahead of the pass-two sums
template <int N1, int N2, int N3>
__host__ __device__ constexpr int staged_floats(int dyn_size) {
  return Smem<N1, N2, N3>::rest +
         round4(dyn_size - Topo<N1, N2, N3>::size);
}

#ifdef MPPI_NN_BF16_PRODUCTS
// (lo, hi) rounded to bf16 as one bf16x2 word, lo in the low half (the
// lower k index of an mma operand)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// c += a b over one m16n8k16 tile
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#else
// f rounded to tf32 (10 mantissa bits, nearest, ties away from zero; the
// low 13 bits 0), held in f32: cvt.rna.tf32.f32 of a finite f in two
// integer ops (half the dropped range added to the magnitude's bits, then
// cut; a carry moves into the exponent). The instruction itself is four
// on sm_90 (its NaN and infinity test and select).
__device__ __forceinline__ float tf32_rna(float f) {
  return __uint_as_float((__float_as_uint(f) + 0x1000u) & 0xffffe000u);
}

// c += a b over one m16n8k8 tile
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#endif

// W^T[o][i] of a layer block of dyn, 0 past its O outputs or I inputs
template <int I, int O>
__device__ __forceinline__ float weight(const float* __restrict__ w, int o,
                                        int i) {
  return (o < O && i < I) ? w[o * I + i] : 0.0f;
}

// One layer's B fragments, in lane order a (k block, n tile), and its
// biases as C fragments (0 past its O outputs), from its block of dyn (all
// threads).
template <int I, int O>
__device__ __forceinline__ void stage_layer(const float* __restrict__ w,
                                            float* s_frag, float* s_bias) {
  constexpr int kN = ntiles(O);
  BFrag* frag = reinterpret_cast<BFrag*>(s_frag);
  for (int s = threadIdx.x; s < ksteps(I) * kN * 32; s += kBlock) {
    const int lane = s & 31, pair = s >> 5;
    const int o = 8 * (pair % kN) + (lane >> 2);
    const int i = kMmaK * (pair / kN) + 2 * (lane & 3);
#ifdef MPPI_NN_BF16_PRODUCTS
    frag[s] = make_uint2(
        pack_bf16x2(weight<I, O>(w, o, i), weight<I, O>(w, o, i + 1)),
        pack_bf16x2(weight<I, O>(w, o, i + 8), weight<I, O>(w, o, i + 9)));
#else
    const float w0 = weight<I, O>(w, o, i), w1 = weight<I, O>(w, o, i + 1);
    const float h0 = tf32_rna(w0), h1 = tf32_rna(w1);
    frag[s] = make_float4(h0, h1, tf32_rna(w0 - h0), tf32_rna(w1 - h1));
#endif
  }
  for (int j = threadIdx.x; j < bias_floats(O); j += kBlock) {
    const int unit = 8 * (j >> 4) + 2 * ((j >> 2) & 3) + (j & 1);
    s_bias[j] = unit < O ? w[O * I + unit] : 0.0f;
  }
}

template <int N1, int N2, int N3>
__device__ __forceinline__ void stage_mlp(const float* __restrict__ dyn,
                                          float* smem) {
  using T = Topo<N1, N2, N3>;
  using S = Smem<N1, N2, N3>;
  stage_layer<kFeatures, N1>(dyn + T::w1, smem + S::frag1, smem + S::bias1);
  stage_layer<N1, N2>(dyn + T::w2, smem + S::frag2, smem + S::bias2);
  if constexpr (N3 != 0)
    stage_layer<N2, N3>(dyn + T::w3, smem + S::frag3, smem + S::bias3);
  stage_layer<T::kLast, kSdim>(dyn + T::wl, smem + S::fragl,
                               smem + S::biasl);
}

// Tile rows: lane i keeps its sample's features, then its deltas, in row
// i; mma row 16 m + 8 h + g (fragment row g = lane / 4 of m tile m) is
// the sample of tile row 16 m + 8 h + mma_row(g). With rows of 20 floats,
// eight lanes writing or reading 16 bytes of eight consecutive rows meet
// 32 distinct banks, and so does a half warp loading or storing 8 bytes
// at columns 8 j + 2 t of its four rows: they hold samples 0, 2, 4, 6 (or
// 1, 3, 5, 7) of eight, whose rows start 8 banks apart (20 s mod 32).
// Every address is then a lane's base plus a constant.
__device__ __forceinline__ int mma_row(int g) {
  return ((g & 3) << 1) | (g >> 2);
}

__device__ __forceinline__ float2 pair_at(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The first layer's A fragments of m tiles m0 .. m0 + kMTiles - 1 from
// the tile (``frag``: the lane's mma row of m tile 0 at column 2 t):
// columns 8 j + 2 t and 8 j + 2 t + 1 are k block j's logical t and t + 4
// (f32), or k16 block j's natural pairs (bf16).
__device__ __forceinline__ void input_acts(
    const float* frag, int m0, AReg (&a)[kMTiles][ksteps(kFeatures)][4]) {
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
    for (int j = 0; j < ksteps(kFeatures); ++j) {
      const float* p = frag + 16 * (m0 + m) * kTileStride + kMmaK * j;
      const float2 v0 = pair_at(p);
      const float2 v1 = pair_at(p + 8 * kTileStride);
#ifdef MPPI_NN_BF16_PRODUCTS
      const float2 v2 = pair_at(p + 8);
      const float2 v3 = pair_at(p + 8 * kTileStride + 8);
      a[m][j][0] = pack_bf16x2(v0.x, v0.y);
      a[m][j][1] = pack_bf16x2(v1.x, v1.y);
      a[m][j][2] = pack_bf16x2(v2.x, v2.y);
      a[m][j][3] = pack_bf16x2(v3.x, v3.y);
#else
      a[m][j][0] = v0.x;
      a[m][j][1] = v1.x;
      a[m][j][2] = v0.y;
      a[m][j][3] = v1.y;
#endif
    }
  }
}

// A of the next layer from a hidden layer's C: the ReLU on C, then (f32)
// a0 = c0, a1 = c2, a2 = c1, a3 = c3 of n tile j as k block j, or (bf16)
// n tiles 2 j and 2 j + 1 packed, rounded, as k16 block j.
template <int O>
__device__ __forceinline__ void hidden_acts(
    const float (&c)[kMTiles][ntiles(O)][4],
    AReg (&a)[kMTiles][ksteps(O)][4]) {
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
    for (int j = 0; j < ksteps(O); ++j) {
#ifdef MPPI_NN_BF16_PRODUCTS
      const float(&lo)[4] = c[m][2 * j];
      a[m][j][0] = pack_bf16x2(relu_r(lo[0]), relu_r(lo[1]));
      a[m][j][1] = pack_bf16x2(relu_r(lo[2]), relu_r(lo[3]));
      if (2 * j + 1 < ntiles(O)) {
        const float(&hi)[4] = c[m][2 * j + 1];
        a[m][j][2] = pack_bf16x2(relu_r(hi[0]), relu_r(hi[1]));
        a[m][j][3] = pack_bf16x2(relu_r(hi[2]), relu_r(hi[3]));
      } else {
        a[m][j][2] = a[m][j][3] = 0u;
      }
#else
      a[m][j][0] = relu_r(c[m][j][0]);
      a[m][j][1] = relu_r(c[m][j][2]);
      a[m][j][2] = relu_r(c[m][j][1]);
      a[m][j][3] = relu_r(c[m][j][3]);
#endif
    }
  }
}

// C = b + A W over kMTiles m tiles: the biases initialise C, each B
// fragment is one load for them all; in the f32 build each A value is
// split at use and c += a_lo b_hi, a_hi b_lo, a_hi b_hi in that order.
template <int I, int O>
__device__ __forceinline__ void layer(const float* __restrict__ s_frag,
                                      const float* __restrict__ s_bias,
                                      int lane,
                                      const AReg (&a)[kMTiles][ksteps(I)][4],
                                      float (&c)[kMTiles][ntiles(O)][4]) {
  constexpr int kN = ntiles(O);
  const BFrag* frag = reinterpret_cast<const BFrag*>(s_frag);
  const float4* bias = reinterpret_cast<const float4*>(s_bias) + (lane & 3);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      const float4 b = bias[4 * n];
      c[m][n][0] = b.x;
      c[m][n][1] = b.y;
      c[m][n][2] = b.z;
      c[m][n][3] = b.w;
    }
  }
#pragma unroll
  for (int j = 0; j < ksteps(I); ++j) {
#ifdef MPPI_NN_BF16_PRODUCTS
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const BFrag b = frag[(j * kN + n) * 32 + lane];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) mma(c[m][n], a[m][j], b.x, b.y);
    }
#else
    uint32_t hi[kMTiles][4], lo[kMTiles][4];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float h = tf32_rna(a[m][j][r]);
        hi[m][r] = __float_as_uint(h);
        lo[m][r] = __float_as_uint(tf32_rna(a[m][j][r] - h));
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const BFrag b = frag[(j * kN + n) * 32 + lane];
      const uint32_t b0h = __float_as_uint(b.x), b1h = __float_as_uint(b.y);
      const uint32_t b0l = __float_as_uint(b.z), b1l = __float_as_uint(b.w);
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        mma(c[m][n], lo[m], b0h, b1h);
        mma(c[m][n], hi[m], b0l, b1l);
        mma(c[m][n], hi[m], b0h, b1h);
      }
    }
#endif
  }
}

// The warp's MLP step: features in the tile (each lane's row) in, deltas
// (columns 0-12 of each lane's row) out, kMTiles m tiles at a time.
template <int N1, int N2, int N3>
__device__ __forceinline__ void mlp_warp(const float* smem, float* tile,
                                         int lane) {
  using S = Smem<N1, N2, N3>;
  float* frag = tile + mma_row(lane >> 2) * kTileStride + 2 * (lane & 3);
#pragma unroll
  for (int m0 = 0; m0 < 2; m0 += kMTiles) {
    AReg a1[kMTiles][ksteps(kFeatures)][4];
    input_acts(frag, m0, a1);
    float c1[kMTiles][ntiles(N1)][4];
    layer<kFeatures, N1>(smem + S::frag1, smem + S::bias1, lane, a1, c1);
    AReg a2[kMTiles][ksteps(N1)][4];
    hidden_acts<N1>(c1, a2);
    float c2[kMTiles][ntiles(N2)][4];
    layer<N1, N2>(smem + S::frag2, smem + S::bias2, lane, a2, c2);
    AReg a3[kMTiles][ksteps(N2)][4];
    hidden_acts<N2>(c2, a3);
    float out[kMTiles][ntiles(kSdim)][4];
    if constexpr (N3 != 0) {
      float c3[kMTiles][ntiles(N3)][4];
      layer<N2, N3>(smem + S::frag3, smem + S::bias3, lane, a3, c3);
      AReg a4[kMTiles][ksteps(N3)][4];
      hidden_acts<N3>(c3, a4);
      layer<N3, kSdim>(smem + S::fragl, smem + S::biasl, lane, a4, out);
    } else {
      layer<N2, kSdim>(smem + S::fragl, smem + S::biasl, lane, a3, out);
    }
    __syncwarp();  // the lanes' A loads of these rows are done
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int n = 0; n < ntiles(kSdim); ++n) {
        float* p = frag + 16 * (m0 + m) * kTileStride + 8 * n;
        *reinterpret_cast<float2*>(p) =
            make_float2(out[m][n][0], out[m][n][1]);
        *reinterpret_cast<float2*>(p + 8 * kTileStride) =
            make_float2(out[m][n][2], out[m][n][3]);
      }
    }
  }
}

// Two blocks of 256 an SM: at most 128 registers a thread.
template <int N1, int N2, int N3, int MODE>
__global__ void __launch_bounds__(kBlock, 2)
    MPPI_KERNEL(nn_fused_solve)(const NnConsts c,
                                const float* __restrict__ dyn, int dyn_size,
                                int sched_off, const float* __restrict__ z,
                                float* __restrict__ costs,
                                float* __restrict__ partials, int k_total,
                                int tau, Seeds sd) {
  using T = Topo<N1, N2, N3>;
  using S = Smem<N1, N2, N3>;
  extern __shared__ __align__(16) float smem[];
  // dyn from its normalisers on; the pass-two sums (kWarps * n_z) after it
  float* s_dyn = smem + S::rest;
  float* s_red = smem + staged_floats<N1, N2, N3>(dyn_size);
  stage_mlp<N1, N2, N3>(dyn, smem);
  for (int i = threadIdx.x; i < dyn_size - T::size; i += kBlock)
    s_dyn[i] = dyn[T::size + i];
  __syncthreads();

  // dyn layout (kernels/nn_mppi.py NNDyn): layers (and the normalisers of
  // the bf16-products build), x0, goal, useq, rhs_z, u_half, then the
  // schedule's c_t at sched_off when scheduled
#ifdef MPPI_NN_BF16_PRODUCTS
  const float* norm = s_dyn;
#endif
  const float* x0 = s_dyn + kNormFloats;
  const float* goal = x0 + kSdim;
  const float* useq = goal + kSdim;
  const float* rhs_z = useq + kAdim * tau;
  const int s_off = sched_off < 0 ? -1 : sched_off - T::size;

  // block b: partial row b; thread i: sample b kBlock + i, row i % 32 of
  // its warp's tile
  const int lane = threadIdx.x & 31;
  float* tile = smem + S::tiles + (threadIdx.x >> 5) * kTile;
  float* row = tile + lane * kTileStride;  // this sample's
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < k_total;
  NoiseStream ns;
  ns.init(z, k_total, k, sd);
  float cost = 0.0f;

  float x[kSdim];
#pragma unroll
  for (int i = 0; i < kSdim; ++i) x[i] = x0[i];
  int n = 0;
#pragma unroll 1
  for (int t = 0; t < tau; ++t) {
    const float ct = sched_factor(s_dyn, s_off, t);
    float zt[kAdim], feats[kFeatures];
#pragma unroll
    for (int j = 0; j < kAdim; ++j) zt[j] = ns.next(n++);
#pragma unroll
    for (int i = 0; i < kSdim - 3; ++i) feats[i] = x[3 + i];
    // u = useq_t + scale (c_t z_t)
#pragma unroll
    for (int i = 0; i < kAdim; ++i) {
      float s = useq[t * kAdim + i];
#pragma unroll
      for (int j = 0; j < kAdim; ++j)
        s = fmaf(c.scale[i * kAdim + j], ct * zt[j], s);
      feats[kSdim - 3 + i] = s;
    }
#ifdef MPPI_NN_BF16_PRODUCTS
    // models/nn.py normalize_x, then the products' bf16 operand
#pragma unroll
    for (int i = 0; i < kFeatures; ++i)
      feats[i] = round_bf16((feats[i] - norm[i]) / norm[kFeatures + i]);
#endif
#pragma unroll
    for (int q = 0; q < kFeatures / 4; ++q)
      *reinterpret_cast<float4*>(row + 4 * q) = make_float4(
          feats[4 * q], feats[4 * q + 1], feats[4 * q + 2], feats[4 * q + 3]);
    __syncwarp();
    mlp_warp<N1, N2, N3>(smem, tile, lane);
    __syncwarp();
    float delta[kFeatures];
#pragma unroll
    for (int q = 0; q < kFeatures / 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(row + 4 * q);
      delta[4 * q] = v.x;
      delta[4 * q + 1] = v.y;
      delta[4 * q + 2] = v.z;
      delta[4 * q + 3] = v.w;
    }
#ifdef MPPI_NN_BF16_PRODUCTS
    // denormalize_y: y y_std + y_mean
#pragma unroll
    for (int i = 0; i < kSdim; ++i)
      delta[i] = delta[i] * norm[2 * kFeatures + kSdim + i] +
                 norm[2 * kFeatures + i];
#endif
#pragma unroll
    for (int i = 0; i < kSdim; ++i) x[i] += delta[i];
    if (c.renorm != 0.0f) {
      const float s2 =
          x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6];
      const float inv = rsqrtf(fmaxf(s2, 1e-24f));
#pragma unroll
      for (int i = 3; i < 7; ++i) x[i] *= inv;
    }

    cost += quat_state_cost(c.q, x, goal);
    float quad = 0.0f;
#pragma unroll
    for (int j = 0; j < kAdim; ++j) {
      cost = fmaf(rhs_z[t * kAdim + j], zt[j], cost);
      float mz = 0.0f;
#pragma unroll
      for (int i = 0; i < kAdim; ++i) mz = fmaf(c.mz[j * kAdim + i], zt[i], mz);
      quad = fmaf(zt[j], mz, quad);
    }
    cost = fmaf(c.nc_half * ct, quad, cost);
  }

  cost += quat_state_cost(c.q, x, goal);
  // read here, not held in a register through the horizon loop
  cost += rhs_z[kAdim * tau];  // u_half
  const float zarg = MODE == kFused ? -cost / c.lam : -INFINITY;
  if (MODE == kCosts && valid) costs[k] = cost;
  if (MODE == kFused)
    write_partial_row_lanes<true, 1>(
        &zarg, &cost, &valid, &ns, tau * kAdim, s_red,
        partials + static_cast<size_t>(blockIdx.x) * (kStats + tau * kAdim));
  else
    write_partial_row_lanes<false, 1>(
        &zarg, &cost, &valid, &ns, 0, s_red,
        partials + static_cast<size_t>(blockIdx.x) * kStats);
}
#endif

// With occupancy set nothing launches: the kernel's blocks an SM at this
// shared memory are written there.
template <int N1, int N2, int N3, int MODE>
int launch_nn(const NnConsts& c, const float* dyn, const float* z,
              float* costs, float* partials, int k, int tau, int scheduled,
              Seeds sd, cudaStream_t stream, int* occupancy) {
  const int base = Topo<N1, N2, N3>::end + 2 * kSdim + 2 * kAdim * tau + 1;
  const int dyn_size = scheduled ? base + tau : base;
  size_t smem = 0;
  const cudaError_t e =
      smem_for(MPPI_KERNEL(nn_fused_solve)<N1, N2, N3, MODE>,
               staged_floats<N1, N2, N3>(dyn_size),
               MODE == kFused ? tau * kAdim : 0, &smem);
  if (e != cudaSuccess) return e;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, MPPI_KERNEL(nn_fused_solve)<N1, N2, N3, MODE>, kThreads,
        smem);
  const int nb = (k + kBlock - 1) / kBlock;
  MPPI_KERNEL(nn_fused_solve)<N1, N2, N3, MODE>
      <<<nb, kThreads, smem, stream>>>(
      c, dyn, dyn_size, scheduled ? base : -1, z, costs, partials, k, tau,
      sd);
  return cudaGetLastError();
}

template <int MODE>
int dispatch_nn(int n1, int n2, int n3, const float* consts,
                const float* dyn, const float* z, float* costs,
                float* partials, int k, int tau, int sch, Seeds sd,
                cudaStream_t st, int* occupancy = nullptr) {
  if (k <= 0 || tau <= 0) return cudaErrorInvalidValue;
  HostConsts f;
  memcpy(&f, consts, sizeof(f));
#ifdef MPPI_BF16_PAIRS
  const NnConsts c = pair_consts(f);
#else
  const NnConsts& c = f;
#endif
  if (n1 == 32 && n2 == 32 && n3 == 32)
    return launch_nn<32, 32, 32, MODE>(c, dyn, z, costs, partials, k, tau,
                                       sch, sd, st, occupancy);
  if (n1 == 8 && n2 == 8 && n3 == 0)
    return launch_nn<8, 8, 0, MODE>(c, dyn, z, costs, partials, k, tau, sch,
                                    sd, st, occupancy);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// scheduled: dyn ends in the tau factors c_t; half: the antithetic solve's
// first mirrored sample, 0 for none (mppi_common.cuh). nn_mppi_bf16.cu and
// nn_mppi_bfp.cu define both solves with their suffixes.
int MPPI_ENTRY(nn_fused_solve)(int n1, int n2, int n3, const float* consts,
                   const float* dyn, const float* z, float* partials, int k,
                   int tau, int scheduled, uint32_t half, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t s_lo, uint32_t s_hi,
                   void* stream) {
  return dispatch_nn<kFused>(n1, n2, n3, consts, dyn, z, nullptr, partials,
                             k, tau, scheduled,
                             Seeds{seed_lo, seed_hi, s_lo, s_hi, half},
                             static_cast<cudaStream_t>(stream));
}

int MPPI_ENTRY(nn_fused_costs)(int n1, int n2, int n3, const float* consts,
                   const float* dyn, const float* z, float* costs,
                   float* partials, int k, int tau, int scheduled,
                   uint32_t half, uint32_t seed_lo, uint32_t seed_hi,
                   uint32_t s_lo, uint32_t s_hi, void* stream) {
  return dispatch_nn<kCosts>(n1, n2, n3, consts, dyn, z, costs, partials, k,
                             tau, scheduled,
                             Seeds{seed_lo, seed_hi, s_lo, s_hi, half},
                             static_cast<cudaStream_t>(stream));
}

// out[0]: blocks an SM of the solve (mode 0) or costs (1) kernel of the
// (n1, n2, n3) network at horizon tau, unscheduled; out[1]: samples a
// thread.
int MPPI_ENTRY(nn_occupancy)(int n1, int n2, int n3, int mode, int tau,
                             int* out) {
  static const float zeros[sizeof(HostConsts) / sizeof(float)] = {};
  out[1] = kLanes;
  return mode ? dispatch_nn<kCosts>(n1, n2, n3, zeros, nullptr, nullptr,
                                    nullptr, nullptr, 1, tau, 0, Seeds{},
                                    nullptr, out)
              : dispatch_nn<kFused>(n1, n2, n3, zeros, nullptr, nullptr,
                                    nullptr, nullptr, 1, tau, 0, Seeds{},
                                    nullptr, out);
}

}  // extern "C"
