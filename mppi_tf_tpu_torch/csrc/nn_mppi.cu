// Fused learned-dynamics (NNAUVModel MLP) MPPI solve for Hopper (sm_90a),
// plain C interface; built with the other sources into one library by
// kernels/_build.py.
//
// nn_fused_solve_kernel<N1, N2, N3, MODE> -- MODE kFused replaces
//   mppi_tf_tpu/kernels/nn_mppi.py::_fused_nn_call (_make_nn_kernel mode
//   "fused" through _nn_pallas, with the noise of _fill_noise_steps); MODE
//   kCosts replaces _fused_nn_costs (mode "costs", phase A of the
//   normalized solve). Phase B (_fused_nn_weights, mode "weights") is
//   mppi_weights in pm_mppi.cu at adim 6, shared with the other models.
//
//   One thread owns one sample. Its 13-state and cost stay in registers and
//   the horizon is a loop (not unrolled: the MLP body is ~3k FMAs). Per step
//   t, with the normals z_t (6) of the port's one Philox stream
//   (mppi_common.cuh NoiseStream, normal n = t*6 + j):
//     u = useq_t + scale (c_t z_t)     (c_t: the schedule, 1 unscheduled)
//     h = [x[3:13], u] (16 features, position dropped)
//     h = relu(W1' h + b1'), ..., delta = W_L' h + b_L'   (ReLU hidden, linear out)
//     x += delta; quaternion renormalised (rsqrt, floor 1e-24 on |q|^2)
//     cost += q(x) + rhs_z_t . z_t + nc_half c_t z_t^T Mz z_t
//   (the TPU kernel's :255-275 and :323). The schedule (c_t at the end of
//   dyn) and the antithetic mirror (`half` in Seeds, the XLA layout of
//   mppi_common.cuh, not _fill_noise_steps' :110-114) are runtime
//   arguments, not instantiations.
//   then + q(x_H) + u_half, with q the StaticQuatCost (mppi_common.cuh).
//
//   Weights are runtime data. kernels/nn_mppi.py FusedNNMPPI.pack_dyn folds
//   the X/Y normalisers into layers 1 and L on the device with torch ops
//   (W1' = W1 / x_std, b1' = b1 - (x_mean / x_std) W1; W_L' = W_L y_std,
//   b_L' = b_L y_std + y_mean) and writes every layer as W^T rows (one row
//   of fan_in floats an output) and its biases, each layer's block padded to
//   a multiple of 4 floats, ahead of the per-solve scalars in dyn. A weight
//   update (a learner step) reaches the kernel as data: nothing rebuilds.
//   The widths are template parameters, so the hidden vectors stay in
//   registers: (32, 32, 32), the reference topology 16->32->32->32->13, and
//   (8, 8), the test topology. The wrapper raises on any other.
//
//   Bound by operations: 2,976 MACs of the MLP a sample-step at 3x32, plus
//   ~0.3 kFLOP of force, renormalisation and cost, and the Philox +
//   Box-Muller normals. Every weight is the same for all threads, so it
//   sits once in shared memory and each load is a broadcast. A 32-bit
//   shared load a warp a clock is a quarter of the SM's FFMA rate, so a
//   scalar load per FMA would bind the MLP at ~4x its FMA time. Chosen
//   here: W^T rows read as float4, one 16-byte broadcast load for four
//   FMAs of one output's chain, which takes the loads to the FFMA rate's
//   level; the O outputs of a layer are independent chains for the
//   scheduler to interleave. (Weights as FFMA constant-bank operands, or
//   tensor-core MMA over 16-64 samples a tile, are later designs.)
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
//   kernels and entry points suffixed _bf16. The folded weights and
//   biases are staged as duplicated bf16x2 words (w, w) in place, so a
//   float4 read of a W^T row is 4 weights a 16-byte broadcast load and 8
//   bf16x2 instructions for the two samples; x0, useq
//   and rhs_z are staged as words too, scale and Mz come as words in the
//   kernel's constants (NnConstsT, packed by the entry point), and the
//   noise is rounded as it is drawn (one cvt a normal pair). The force
//   u_t + c_t (scale z_t) in the TPU kernel's order, every MLP chain
//   acc + w h (each product and sum rounded), the ReLU (max.bf16x2 against
//   +0, as fmaxf) and the state update are bf16; the renormalisation's
//   rsqrt, the StaticQuatCost (against the unrounded goal) and each lane's
//   cost sum are f32, the z terms bf16 values added to it (:296-325).
// * nn_mppi_bfp.cu, the f32 kernel for a model whose compute_dtype is
//   bf16 (suffix _bfp): the JAX XLA path's bf16 products with f32
//   accumulation (models/nn.py mlp_apply), not the TPU kernel, which
//   ignores the model's compute_dtype. The normalisers are not folded:
//   they sit after the layers in dyn (x_mean, x_std, y_mean, y_std), the
//   features are normalised in f32 and rounded, the weights come rounded
//   from the host, each hidden layer's output is rounded as the next
//   layer's input, the biases and the output's denormalisation stay f32.

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

// out = act(W^T in + b) over one block of dyn in shared memory (16-byte
// aligned): row j of W^T is read as I / 4 broadcast float4 loads. The
// staged weights already hold Vals; the bf16-products build rounds each
// hidden output, the next layer's input.
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
#ifdef MPPI_NN_BF16_PRODUCTS
    out[j] = kRelu ? round_bf16(relu_r(acc)) : acc;
#else
    out[j] = kRelu ? relu_r(acc) : acc;
#endif
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
// widened to f32 (the f32 builds call quat_state_cost on the state).
__device__ __forceinline__ float rollout_state_cost(const float* q,
                                                   const Val* x,
                                                   const float* goal,
                                                   int l) {
#ifdef MPPI_BF16
  float xf[kSdim];
#pragma unroll
  for (int i = 0; i < kSdim; ++i) xf[i] = widen(x[i], l);
  return quat_state_cost(q, xf, goal);
#else
  return quat_state_cost(q, x, goal);
#endif
}

// The bf16 and bf16-products builds give the two-layer (8, 8) network a
// floor of two blocks an SM: at ptxas's own 80-register target both
// spill.
#if defined(MPPI_BF16_PAIRS) || defined(MPPI_NN_BF16_PRODUCTS)
#define NN_LAUNCH_BOUNDS __launch_bounds__(kThreads, N3 == 0 ? 2 : 0)
#else
#define NN_LAUNCH_BOUNDS __launch_bounds__(kBlock)
#endif

template <int N1, int N2, int N3, int MODE>
__global__ void NN_LAUNCH_BOUNDS
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

  // the bf16 build stages the layers, x0, useq and rhs_z as bf16x2 words
  // (the rollout's operands); the goal, u_half and c_t stay f32
  for (int i = threadIdx.x; i < dyn_size; i += kThreads) {
#ifdef MPPI_BF16
    const int from_x0 = i - T::end;
    const bool word = i < T::size ||
                      (from_x0 >= 0 && from_x0 < kSdim) ||
                      (from_x0 >= 2 * kSdim &&
                       from_x0 < 2 * kSdim + 2 * kAdim * tau);
    s_dyn[i] = word ? stage_word(dyn[i]) : dyn[i];
#else
    s_dyn[i] = dyn[i];
#endif
  }
  __syncthreads();

  // dyn layout (kernels/nn_mppi.py NNDyn): layers (and the normalisers of
  // the bf16-products build), x0, goal, useq, rhs_z, u_half, then the
  // schedule's c_t at sched_off when scheduled
  const float* norm = s_dyn + T::norm;
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
    // horizon loop into registers and spills (255 registers, a 440-byte
    // stack); each step reloads them from shared memory instead
    asm volatile("" ::: "memory");
    const float ct = sched_factor(s_dyn, sched_off, t);
    Val zt[kAdim], feats[kFeatures];
#pragma unroll
    for (int j = 0; j < kAdim; ++j) zt[j] = draw(ns, n++);
#pragma unroll
    for (int i = 0; i < kSdim - 3; ++i) feats[i] = x[3 + i];
    // u = useq_t + scale (c_t z_t); at bf16 u_t + c_t (scale z_t), the TPU
    // kernel's order (:255-275)
#ifdef MPPI_BF16
    const Val ct_v = to_val(ct);
#endif
#pragma unroll
    for (int i = 0; i < kAdim; ++i) {
#ifdef MPPI_BF16
      Val sz = 0.0f;
#pragma unroll
      for (int j = 0; j < kAdim; ++j)
        sz = fma_r(exact_val(c.scale[i * kAdim + j]), zt[j], sz);
      feats[kSdim - 3 + i] = exact_val(useq[t * kAdim + i]) + ct_v * sz;
#else
      float s = useq[t * kAdim + i];
#pragma unroll
      for (int j = 0; j < kAdim; ++j)
        s = fmaf(c.scale[i * kAdim + j], ct * zt[j], s);
      feats[kSdim - 3 + i] = s;
#endif
    }
#ifdef MPPI_NN_BF16_PRODUCTS
    // models/nn.py normalize_x, then the products' bf16 operand
#pragma unroll
    for (int i = 0; i < kFeatures; ++i)
      feats[i] = round_bf16((feats[i] - norm[i]) / norm[kFeatures + i]);
#endif
    Val delta[kSdim];
    mlp<N1, N2, N3>(s_dyn, feats, delta);
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
#ifdef MPPI_BF16
      const Val rz = exact_val(rhs_z[t * kAdim + j]) * zt[j];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) cost[l] += widen(rz, l);
#else
      cost[0] = fmaf(rhs_z[t * kAdim + j], zt[j], cost[0]);
#endif
      Val mz = 0.0f;
#pragma unroll
      for (int i = 0; i < kAdim; ++i)
        mz = fma_r(exact_val(c.mz[j * kAdim + i]), zt[i], mz);
      quad = fma_r(zt[j], mz, quad);
    }
#ifdef MPPI_BF16
    const Val nq = to_val(c.nc_half * ct) * quad;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) cost[l] += widen(nq, l);
#else
    cost[0] = fmaf(c.nc_half * ct, quad, cost[0]);
#endif
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
               round4(dyn_size), MODE == kFused ? tau * kAdim : 0, &smem);
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
