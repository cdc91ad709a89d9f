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
// pm_noise_dump_kernel -- replaces fused_noise_dump (make_noise_kernel +
//   _fill_noise). Writes the exact normals the solves consume, z[n][k] with
//   n = t*adim + j, for any adim (the AUV's 6 as well). Bound by the bytes
//   it writes (4 per normal); Philox and Box-Muller are ~32 operations per
//   normal, below that.
//
// pm_fused_solve_kernel<S, A, MODE, COST> -- MODE kFused replaces
//   fused_pm_call (_make_kernel in mode "fused" + _fill_noise); MODE kCosts
//   replaces fused_pm_costs (mode "costs", phase A of the normalized
//   solve). COST is the state cost of _make_kernel's cost_kind:
//   kQuadratic, (x - g)^T Q (x - g) around the goal in dyn (StaticCost, and
//   WayPointsCost as its effective goal: the host adds the dropped
//   constant back, kernels/pm_mppi.py); kElipse, the 2D ellipse cost over
//   [x, vx, y, vy] (cost_kind "elipse", :474-485), built for (S, A) = (4, 2)
//   only, with native sqrtf in place of the TPU's vector sqrt. One
//   thread owns one sample; the state stays in registers over the horizon,
//   the per-solve dyn array sits in shared memory. Bound by operations: the
//   Philox + Box-Muller passes (~32 ops a normal each; two in kFused, one in
//   kCosts) and the rollout/cost FMA chains; kCosts also writes 4 bytes a
//   sample. Design:
//   * the TPU grid ran its tiles in order and carried (m, l, zsum) across
//     grid steps; GPU blocks run concurrently, so each block writes its own
//     partial row (mppi_common.cuh) and pm_merge_kernel combines them: no
//     atomics, and the result is deterministic;
//   * pass two regenerates z from the same Philox counters instead of
//     holding tau*adim normals per thread;
//   * kCosts writes costs[k] and a stats-only row (m_b = l_b = 0, no zsum):
//     pm_merge with n_z = 0 gives the cost min / max / sum that phase B
//     normalizes with;
//   * the TPU's sin polynomial and mantissa-stuffing uniform worked around
//     Mosaic; here logf / sqrtf / sincospif are used directly.
//
// mppi_weights_kernel -- replaces make_weights_kernel (fused_pm_weights and
//   auv_mppi._fused_auv_weights, phase B of the normalized solve, for both
//   models). Reads costs[k] and nrm = (beta, 1/(denom*lam)) from device
//   memory (no host sync between the phases), regenerates the normals of
//   the same (seed, solve) (n_z = tau*adim, any adim) and writes partial
//   rows with m_b = 0: w = exp(-(c - beta) * nrm[1]) lies in
//   [exp(-1/lam), 1], so no max shift is needed. Bound by operations (one
//   Philox + Box-Muller pass); it reads 4 bytes a sample.
//
// pm_merge_kernel -- the cross-block step: one block applies the shard-merge
//   algebra of mppi_tf_tpu/parallel/fused.py (m = max m_b, f_b = exp(m_b - m),
//   l = sum f_b l_b, zsum = sum f_b zsum_b, cost min/max/sum); n_z = 0 merges
//   stats-only rows. Bound by the bytes of the partials it reads (~250 KB
//   at K=100k, H=50): launch latency and one block's serial walk dominate it.

#include <string.h>

#include "mppi_common.cuh"

namespace {

using namespace mppi;

// State costs (kernels/pm_mppi.py COST_KINDS).
enum PmCost { kQuadratic = 0, kElipse = 1 };

// Solve constants, in the order of kernels/pm_mppi.py PmConsts.packed.
template <int S, int A>
struct Consts {
  float a[S * S];   // A
  float bs[S * A];  // B @ scale (mass free)
  float q[S * S];   // Q (zero for kElipse)
  float mz[A * A];  // scale^T Sigma^-1 scale
  float lam;
  float nc_half;
  float el[7];      // kElipse: a, b, cx, cy, gv, m_state, m_vel
};

template <int S, int A, int COST>
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
#pragma unroll
      for (int j = 0; j < S; ++j) qd = fmaf(c.q[i * S + j], d[j], qd);
      out = fmaf(d[i], qd, out);
    }
    return out;
  }
}

template <int S, int A, int MODE, int COST>
__global__ void __launch_bounds__(kBlock)
    pm_fused_solve_kernel(const Consts<S, A> c, const float* __restrict__ dyn,
                          int dyn_size, const float* __restrict__ z,
                          float* __restrict__ costs,
                          float* __restrict__ partials, int k_total, int tau,
                          Seeds sd) {
  extern __shared__ float smem[];
  float* s_dyn = smem;             // dyn_size
  float* s_red = smem + dyn_size;  // kWarps * n_z: pass-two warp sums

  for (int i = threadIdx.x; i < dyn_size; i += kBlock) s_dyn[i] = dyn[i];
  __syncthreads();

  // dyn layout (kernels/pm_mppi.py Dyn): inv_mass, x0, goal, bu, rhs_z, u_half
  const float* x0 = s_dyn + 1;
  const float* goal = s_dyn + 1 + S;
  const float* bu = s_dyn + 1 + 2 * S;
  const float* rhs_z = bu + tau * S;
  const float u_half = rhs_z[tau * A];
  const float inv_m = s_dyn[0];

  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < k_total;
  NoiseStream ns;
  ns.init(z, k_total, k, sd);

  // ---- pass one: rollout + cost ------------------------------------------
  float cost = 0.0f;
  {
    float x[S];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x0[i];
    int n = 0;
    for (int t = 0; t < tau; ++t) {
      float zt[A];
#pragma unroll
      for (int j = 0; j < A; ++j) zt[j] = ns.next(n++);
      float xn[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        float ax = 0.0f;
#pragma unroll
        for (int j = 0; j < S; ++j) ax = fmaf(c.a[i * S + j], x[j], ax);
        float bz = 0.0f;
#pragma unroll
        for (int j = 0; j < A; ++j) bz = fmaf(c.bs[i * A + j], zt[j], bz);
        xn[i] = fmaf(inv_m, bu[t * S + i] + bz, ax);
      }
#pragma unroll
      for (int i = 0; i < S; ++i) x[i] = xn[i];
      cost += state_cost<S, A, COST>(c, x, goal);
      float quad = 0.0f;
#pragma unroll
      for (int j = 0; j < A; ++j) {
        cost = fmaf(rhs_z[t * A + j], zt[j], cost);
        float mz = 0.0f;
#pragma unroll
        for (int i = 0; i < A; ++i) mz = fmaf(c.mz[j * A + i], zt[i], mz);
        quad = fmaf(zt[j], mz, quad);
      }
      cost = fmaf(c.nc_half, quad, cost);
    }
    cost += state_cost<S, A, COST>(c, x, goal);
    cost += u_half;
  }

  if (MODE == kFused) {
    float* row = partials + static_cast<size_t>(blockIdx.x) *
                                (kStats + tau * A);
    write_partial_row<true>(-cost / c.lam, cost, valid, ns, tau * A, s_red,
                            row);
  } else {
    if (valid) costs[k] = cost;
    write_partial_row<false>(-INFINITY, cost, valid, ns, 0, s_red,
                             partials + static_cast<size_t>(blockIdx.x) *
                                            kStats);
  }
}

__global__ void __launch_bounds__(kBlock)
    mppi_weights_kernel(const float* __restrict__ nrm,
                        const float* __restrict__ costs,
                        const float* __restrict__ z,
                        float* __restrict__ partials, int k_total, int n_z,
                        Seeds sd) {
  extern __shared__ float s_red[];  // kWarps * n_z
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < k_total;
  NoiseStream ns;
  ns.init(z, k_total, k, sd);
  const float cost = valid ? costs[k] : 0.0f;
  write_partial_row<false>(-(cost - nrm[0]) * nrm[1], cost, valid, ns, n_z,
                           s_red,
                           partials + static_cast<size_t>(blockIdx.x) *
                                          (kStats + n_z));
}

__global__ void pm_noise_dump_kernel(float* __restrict__ out, int k_total,
                                     int n_z, Seeds sd) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= k_total) return;
  const int blk = blockIdx.y;
  float v[4];
  philox_normals(static_cast<uint32_t>(k), static_cast<uint32_t>(blk), sd, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = blk * 4 + i;
    if (n < n_z) out[static_cast<size_t>(n) * k_total + k] = v[i];
  }
}

constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
    pm_merge_kernel(const float* __restrict__ p, int nb, int n_z,
                    float* __restrict__ zsum, float* __restrict__ stats) {
  constexpr int warps = kMergeThreads / 32;
  __shared__ float s_red[4][warps];
  __shared__ float s_m;
  const int width = kStats + n_z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float m = -INFINITY;
  for (int b = threadIdx.x; b < nb; b += kMergeThreads)
    m = fmaxf(m, p[static_cast<size_t>(b) * width]);
  m = warp_max(m);
  if (lane == 0) s_red[0][warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = s_red[0][0];
    for (int w = 1; w < warps; ++w) mm = fmaxf(mm, s_red[0][w]);
    s_m = mm;
  }
  __syncthreads();
  const float mg = s_m;
  __syncthreads();  // s_red is reused below

  float l = 0.0f, cmin = INFINITY, cmax = -INFINITY, csum = 0.0f;
  for (int b = threadIdx.x; b < nb; b += kMergeThreads) {
    const float* r = p + static_cast<size_t>(b) * width;
    l = fmaf(expf(r[0] - mg), r[1], l);
    cmin = fminf(cmin, r[2]);
    cmax = fmaxf(cmax, r[3]);
    csum += r[4];
  }
  l = warp_sum(l);
  cmin = warp_min(cmin);
  cmax = warp_max(cmax);
  csum = warp_sum(csum);
  if (lane == 0) {
    s_red[0][warp] = l;
    s_red[1][warp] = cmin;
    s_red[2][warp] = cmax;
    s_red[3][warp] = csum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tl = 0.0f, tmin = INFINITY, tmax = -INFINITY, tsum = 0.0f;
    for (int w = 0; w < warps; ++w) {
      tl += s_red[0][w];
      tmin = fminf(tmin, s_red[1][w]);
      tmax = fmaxf(tmax, s_red[2][w]);
      tsum += s_red[3][w];
    }
    stats[0] = mg;
    stats[1] = tl;
    stats[2] = tmin;
    stats[3] = tmax;
    stats[4] = tsum;
    stats[5] = stats[6] = stats[7] = 0.0f;
  }
  for (int n = threadIdx.x; n < n_z; n += kMergeThreads) {
    float s = 0.0f;
    for (int b = 0; b < nb; ++b) {
      const float* r = p + static_cast<size_t>(b) * width;
      s = fmaf(expf(r[0] - mg), r[kStats + n], s);
    }
    zsum[n] = s;
  }
}

template <int S, int A, int MODE, int COST>
int launch_solve(const float* consts, const float* dyn, const float* z,
                 float* costs, float* partials, int k, int tau, Seeds sd,
                 cudaStream_t stream) {
  Consts<S, A> c;
  memcpy(&c, consts, sizeof(c));
  const int dyn_size = 1 + 2 * S + tau * (S + A) + 1;
  size_t smem = 0;
  const cudaError_t e =
      smem_for(pm_fused_solve_kernel<S, A, MODE, COST>, dyn_size,
               MODE == kFused ? tau * A : 0, &smem);
  if (e != cudaSuccess) return e;
  const int nb = (k + kBlock - 1) / kBlock;
  pm_fused_solve_kernel<S, A, MODE, COST><<<nb, kBlock, smem, stream>>>(
      c, dyn, dyn_size, z, costs, partials, k, tau, sd);
  return cudaGetLastError();
}

template <int MODE>
int dispatch_solve(int sdim, int adim, int cost, const float* consts,
                   const float* dyn, const float* z, float* costs,
                   float* partials, int k, int tau, Seeds sd,
                   cudaStream_t st) {
  if (k <= 0 || tau <= 0) return cudaErrorInvalidValue;
  if (cost == kElipse) {
    if (sdim == 4 && adim == 2)
      return launch_solve<4, 2, MODE, kElipse>(consts, dyn, z, costs,
                                               partials, k, tau, sd, st);
    return cudaErrorInvalidValue;
  }
  if (cost != kQuadratic) return cudaErrorInvalidValue;
  if (sdim == 6 && adim == 3)
    return launch_solve<6, 3, MODE, kQuadratic>(consts, dyn, z, costs,
                                                partials, k, tau, sd, st);
  if (sdim == 2 && adim == 1)
    return launch_solve<2, 1, MODE, kQuadratic>(consts, dyn, z, costs,
                                                partials, k, tau, sd, st);
  if (sdim == 4 && adim == 2)
    return launch_solve<4, 2, MODE, kQuadratic>(consts, dyn, z, costs,
                                                partials, k, tau, sd, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int pm_noise_dump(float* out, int k, int n_z, uint32_t seed_lo,
                  uint32_t seed_hi, uint32_t s_lo, uint32_t s_hi,
                  void* stream) {
  if (k <= 0 || n_z <= 0) return cudaErrorInvalidValue;
  const Seeds sd{seed_lo, seed_hi, s_lo, s_hi};
  const dim3 grid((k + 255) / 256, (n_z + 3) / 4);
  pm_noise_dump_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, k, n_z, sd);
  return cudaGetLastError();
}

// consts: PmConsts.packed, sizeof(Consts<sdim, adim>) bytes; cost: PmCost.
int pm_fused_solve(int sdim, int adim, int cost, const float* consts,
                   const float* dyn, const float* z, float* partials, int k,
                   int tau, uint32_t seed_lo, uint32_t seed_hi,
                   uint32_t s_lo, uint32_t s_hi, void* stream) {
  return dispatch_solve<kFused>(sdim, adim, cost, consts, dyn, z, nullptr,
                                partials, k, tau,
                                Seeds{seed_lo, seed_hi, s_lo, s_hi},
                                static_cast<cudaStream_t>(stream));
}

int pm_fused_costs(int sdim, int adim, int cost, const float* consts,
                   const float* dyn, const float* z, float* costs,
                   float* partials, int k, int tau, uint32_t seed_lo,
                   uint32_t seed_hi, uint32_t s_lo, uint32_t s_hi,
                   void* stream) {
  return dispatch_solve<kCosts>(sdim, adim, cost, consts, dyn, z, costs,
                                partials, k, tau,
                                Seeds{seed_lo, seed_hi, s_lo, s_hi},
                                static_cast<cudaStream_t>(stream));
}

int mppi_weights(const float* nrm, const float* costs, const float* z,
                 float* partials, int k, int n_z, uint32_t seed_lo,
                 uint32_t seed_hi, uint32_t s_lo, uint32_t s_hi,
                 void* stream) {
  if (k <= 0 || n_z <= 0) return cudaErrorInvalidValue;
  size_t smem = 0;
  const cudaError_t e = smem_for(mppi_weights_kernel, 0, n_z, &smem);
  if (e != cudaSuccess) return e;
  const int nb = (k + kBlock - 1) / kBlock;
  mppi_weights_kernel<<<nb, kBlock, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      nrm, costs, z, partials, k, n_z, Seeds{seed_lo, seed_hi, s_lo, s_hi});
  return cudaGetLastError();
}

int pm_merge(const float* partials, int nb, int n_z, float* zsum,
             float* stats, void* stream) {
  if (nb <= 0 || n_z < 0) return cudaErrorInvalidValue;
  pm_merge_kernel<<<1, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, nb, n_z, zsum, stats);
  return cudaGetLastError();
}

const char* pm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
