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

#include <string.h>

#include "mppi_common.cuh"

namespace {

using namespace mppi;

constexpr int kFeatures = 16;  // 10 state features (x[3:13]) + 6 actions
constexpr int kSdim = 13;
constexpr int kAdim = 6;

// Solve constants, in the order of kernels/nn_mppi.py NnConsts.packed.
struct NnConsts {
  float lam;
  float nc_half;
  float renorm;     // 1: renormalise the quaternion after each step
  float pad;
  float scale[36];  // upsilon sigma, row-major
  float mz[36];     // scale^T Sigma^-1 scale
  float q[100];     // 10x10 cost weight
};
static_assert(sizeof(NnConsts) == 176 * sizeof(float), "NnConsts layout");

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// one layer's block in dyn: O rows of I weights (W^T), O biases, padded
__host__ __device__ constexpr int layer_floats(int i, int o) {
  return round4(o * i + o);
}

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
};

// out = act(W^T in + b) over one block of dyn in shared memory (16-byte
// aligned): row j of W^T is read as I / 4 broadcast float4 loads.
template <int I, int O, bool kRelu>
__device__ __forceinline__ void dense(const float* __restrict__ w,
                                      const float* in, float* out) {
  static_assert(I % 4 == 0, "fan_in must be a multiple of 4");
  const float4* rows = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < O; ++j) {
    float acc = w[O * I + j];
#pragma unroll
    for (int i = 0; i < I / 4; ++i) {
      const float4 v = rows[j * (I / 4) + i];
      acc = fmaf(v.x, in[4 * i], acc);
      acc = fmaf(v.y, in[4 * i + 1], acc);
      acc = fmaf(v.z, in[4 * i + 2], acc);
      acc = fmaf(v.w, in[4 * i + 3], acc);
    }
    out[j] = kRelu ? fmaxf(acc, 0.0f) : acc;
  }
}

// delta = MLP(features) over the folded weights at s_w.
template <int N1, int N2, int N3>
__device__ __forceinline__ void mlp(const float* __restrict__ s_w,
                                    const float* feats, float* delta) {
  using T = Topo<N1, N2, N3>;
  float h1[N1];
  dense<kFeatures, N1, true>(s_w + T::w1, feats, h1);
  float h2[N2];
  dense<N1, N2, true>(s_w + T::w2, h1, h2);
  if constexpr (N3 != 0) {
    float h3[N3];
    dense<N2, N3, true>(s_w + T::w3, h2, h3);
    dense<N3, kSdim, false>(s_w + T::wl, h3, delta);
  } else {
    dense<N2, kSdim, false>(s_w + T::wl, h2, delta);
  }
}

template <int N1, int N2, int N3, int MODE>
__global__ void __launch_bounds__(kBlock)
    nn_fused_solve_kernel(const NnConsts c, const float* __restrict__ dyn,
                          int dyn_size, int sched_off,
                          const float* __restrict__ z,
                          float* __restrict__ costs,
                          float* __restrict__ partials, int k_total,
                          int tau, Seeds sd) {
  using T = Topo<N1, N2, N3>;
  extern __shared__ __align__(16) float smem[];
  float* s_dyn = smem;                     // dyn_size
  float* s_red = smem + round4(dyn_size);  // kWarps * n_z: pass-two sums

  for (int i = threadIdx.x; i < dyn_size; i += kBlock) s_dyn[i] = dyn[i];
  __syncthreads();

  // dyn layout (kernels/nn_mppi.py NNDyn): layers, x0, goal, useq, rhs_z,
  // u_half, then the schedule's c_t at sched_off when scheduled
  const float* x0 = s_dyn + T::size;
  const float* goal = x0 + kSdim;
  const float* useq = goal + kSdim;
  const float* rhs_z = useq + kAdim * tau;
  const float u_half = rhs_z[kAdim * tau];

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
    // the weights are loop-invariant: without this barrier the compiler
    // hoists the (8, 8) network's ~330 shared-memory loads out of the
    // horizon loop into registers and spills (255 registers, a 440-byte
    // stack); each step reloads them from shared memory instead
    asm volatile("" ::: "memory");
    const float ct = sched_factor(s_dyn, sched_off, t);
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
    float delta[kSdim];
    mlp<N1, N2, N3>(s_dyn, feats, delta);
#pragma unroll
    for (int i = 0; i < kSdim; ++i) x[i] += delta[i];
    if (c.renorm != 0.0f) {
      const float s2 = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6];
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
  cost += u_half;

  if (MODE == kFused) {
    float* row = partials + static_cast<size_t>(blockIdx.x) *
                                (kStats + tau * kAdim);
    write_partial_row<true>(-cost / c.lam, cost, valid, ns, tau * kAdim,
                            s_red, row);
  } else {
    if (valid) costs[k] = cost;
    write_partial_row<false>(-INFINITY, cost, valid, ns, 0, s_red,
                             partials + static_cast<size_t>(blockIdx.x) *
                                            kStats);
  }
}

template <int N1, int N2, int N3, int MODE>
int launch_nn(const NnConsts& c, const float* dyn, const float* z,
              float* costs, float* partials, int k, int tau, int scheduled,
              Seeds sd, cudaStream_t stream) {
  const int base = Topo<N1, N2, N3>::size + 2 * kSdim + 2 * kAdim * tau + 1;
  const int dyn_size = scheduled ? base + tau : base;
  size_t smem = 0;
  const cudaError_t e =
      smem_for(nn_fused_solve_kernel<N1, N2, N3, MODE>, round4(dyn_size),
               MODE == kFused ? tau * kAdim : 0, &smem);
  if (e != cudaSuccess) return e;
  const int nb = (k + kBlock - 1) / kBlock;
  nn_fused_solve_kernel<N1, N2, N3, MODE><<<nb, kBlock, smem, stream>>>(
      c, dyn, dyn_size, scheduled ? base : -1, z, costs, partials, k, tau,
      sd);
  return cudaGetLastError();
}

template <int MODE>
int dispatch_nn(int n1, int n2, int n3, const float* consts,
                const float* dyn, const float* z, float* costs,
                float* partials, int k, int tau, int sch, Seeds sd,
                cudaStream_t st) {
  if (k <= 0 || tau <= 0) return cudaErrorInvalidValue;
  NnConsts c;
  memcpy(&c, consts, sizeof(c));
  if (n1 == 32 && n2 == 32 && n3 == 32)
    return launch_nn<32, 32, 32, MODE>(c, dyn, z, costs, partials, k, tau,
                                       sch, sd, st);
  if (n1 == 8 && n2 == 8 && n3 == 0)
    return launch_nn<8, 8, 0, MODE>(c, dyn, z, costs, partials, k, tau, sch,
                                    sd, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// scheduled: dyn ends in the tau factors c_t; half: the antithetic solve's
// first mirrored sample, 0 for none (mppi_common.cuh).
int nn_fused_solve(int n1, int n2, int n3, const float* consts,
                   const float* dyn, const float* z, float* partials, int k,
                   int tau, int scheduled, uint32_t half, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t s_lo, uint32_t s_hi,
                   void* stream) {
  return dispatch_nn<kFused>(n1, n2, n3, consts, dyn, z, nullptr, partials,
                             k, tau, scheduled,
                             Seeds{seed_lo, seed_hi, s_lo, s_hi, half},
                             static_cast<cudaStream_t>(stream));
}

int nn_fused_costs(int n1, int n2, int n3, const float* consts,
                   const float* dyn, const float* z, float* costs,
                   float* partials, int k, int tau, int scheduled,
                   uint32_t half, uint32_t seed_lo, uint32_t seed_hi,
                   uint32_t s_lo, uint32_t s_hi, void* stream) {
  return dispatch_nn<kCosts>(n1, n2, n3, consts, dyn, z, costs, partials, k,
                             tau, scheduled,
                             Seeds{seed_lo, seed_hi, s_lo, s_hi, half},
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
