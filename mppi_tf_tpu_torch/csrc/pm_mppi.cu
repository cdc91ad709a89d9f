// Fused point-mass MPPI solve for Hopper (sm_90a), plain C interface.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpm_mppi.so pm_mppi.cu
// (mppi_tf_tpu_torch/kernels/_build.py does this at first use.) Every entry
// point launches on the given stream, does not synchronise, allocates
// nothing and returns cudaGetLastError().
//
// Kernels, and the TPU kernels of mppi_tf_tpu/kernels/pm_mppi.py they replace:
//
// pm_noise_dump_kernel -- replaces fused_noise_dump (make_noise_kernel +
//   _fill_noise). Writes the exact normals the solve consumes, z[n][k] with
//   n = t*adim + j. Bound by the bytes it writes (4 per normal); Philox and
//   Box-Muller are ~32 operations per normal, below that.
//
// pm_fused_solve_kernel<S, A> -- replaces fused_pm_call (_make_kernel in
//   mode "fused" + _fill_noise). One thread owns one sample; the state stays
//   in registers over the horizon, the per-solve dyn array sits in shared
//   memory. Bound by operations: two Philox + Box-Muller passes (~32 ops a
//   normal each) and the rollout/cost FMA chains; it reads and writes next
//   to nothing. Design:
//   * the TPU grid ran its tiles in order and carried (m, l, zsum) across
//     grid steps; GPU blocks run concurrently, so each block writes its own
//     partial row and pm_merge_kernel combines them: no atomics, and the
//     result is deterministic;
//   * pass two regenerates z from the same Philox counters instead of
//     holding tau*adim normals per thread, and reduces sum_k w_k z_k per
//     normal with warp shuffles, then over the block's warps in shared memory;
//   * the TPU's sin polynomial and mantissa-stuffing uniform worked around
//     Mosaic; here logf / sqrtf / sincospif are used directly.
//
// pm_merge_kernel -- the cross-block step: one block applies the shard-merge
//   algebra of mppi_tf_tpu/parallel/fused.py (m = max m_b, f_b = exp(m_b - m),
//   l = sum f_b l_b, zsum = sum f_b zsum_b, cost min/max/sum). Bound by the
//   bytes of the partials it reads (~250 KB at K=100k, H=50): launch latency
//   dominates it.
//
// Noise stream (reproduced by the plain version in kernels/pm_mppi.py):
// normal n of sample k in solve s is lane n%4 of
// Philox4x32-10(counter=(k, n/4, s_lo, s_hi), key=(seed_lo, seed_hi));
// lanes (0,1) and (2,3) are Box-Muller pairs with u = ((bits>>9)+0.5)*2^-23.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlock = 256;          // samples per block of the fused solve
constexpr int kWarps = kBlock / 32;
constexpr int kStats = 8;            // (m, l, cmin, cmax, csum, pad x3)

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// exact in f32: (b >> 9) < 2^23, so (2m + 1) * 2^-24 needs 24 bits
__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
  return (static_cast<float>(b >> 9) + 0.5f) * 1.1920928955078125e-7f;
}

__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& za,
                                           float& zb) {
  const float r = sqrtf(-2.0f * logf(bits_to_uniform(a)));
  float s, c;
  sincospif(2.0f * bits_to_uniform(b), &s, &c);
  za = r * c;
  zb = r * s;
}

struct Seeds {
  uint32_t seed_lo, seed_hi, s_lo, s_hi;
};

__device__ __forceinline__ void philox_normals(uint32_t sample, uint32_t blk,
                                               const Seeds& sd, float v[4]) {
  const uint4 w =
      philox4x32_10(make_uint4(sample, blk, sd.s_lo, sd.s_hi), sd.seed_lo,
                    sd.seed_hi);
  box_muller(w.x, w.y, v[0], v[1]);
  box_muller(w.z, w.w, v[2], v[3]);
}

// Sequential reader of one sample's normals n = 0, 1, 2, ...: the Philox
// stream four at a time, or injected z[n][k] when z is given.
struct NoiseStream {
  const float* z;
  int k_total;
  uint32_t sample;
  bool valid;
  Seeds sd;
  uint32_t blk;
  int lane;
  float buf[4];

  __device__ __forceinline__ void reset() {
    blk = 0;
    lane = 4;
  }
  __device__ __forceinline__ float next(int n) {
    if (z != nullptr)
      return valid ? z[static_cast<size_t>(n) * k_total + sample] : 0.0f;
    if (lane == 4) {
      philox_normals(sample, blk++, sd, buf);
      lane = 0;
    }
    const float v = lane == 0 ? buf[0]
                  : lane == 1 ? buf[1]
                  : lane == 2 ? buf[2]
                              : buf[3];
    ++lane;
    return v;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int S, int A>
struct Consts {
  float a[S * S];   // A
  float bs[S * A];  // B @ scale (mass free)
  float q[S * S];   // Q
  float mz[A * A];  // scale^T Sigma^-1 scale
  float lam;
  float nc_half;
};

template <int S, int A>
__device__ __forceinline__ float state_cost(const Consts<S, A>& c,
                                            const float* x,
                                            const float* goal) {
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

template <int S, int A>
__global__ void __launch_bounds__(kBlock)
    pm_fused_solve_kernel(const Consts<S, A> c, const float* __restrict__ dyn,
                          int dyn_size, const float* __restrict__ z,
                          float* __restrict__ partials, int k_total, int tau,
                          Seeds sd) {
  extern __shared__ float smem[];
  float* s_dyn = smem;             // dyn_size
  float* s_red = smem + dyn_size;  // kWarps * n_z: pass-two warp sums
  __shared__ float s_stat[5][kWarps];
  __shared__ float s_m;

  const int n_z = tau * A;
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
  ns.z = z;
  ns.k_total = k_total;
  ns.sample = static_cast<uint32_t>(k);
  ns.valid = valid;
  ns.sd = sd;
  ns.reset();

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
      cost += state_cost<S, A>(c, x, goal);
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
    cost += state_cost<S, A>(c, x, goal);
    cost += u_half;
  }

  // ---- block softmax of -cost/lam (padding sentinel -inf) -----------------
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float zarg = valid ? -cost / c.lam : -INFINITY;
  const float wm = warp_max(zarg);
  if (lane == 0) s_stat[0][warp] = wm;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = s_stat[0][0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_stat[0][w]);
    s_m = m;
  }
  __syncthreads();
  const float m_b = s_m;
  const float wgt = valid ? expf(zarg - m_b) : 0.0f;
  const float l = warp_sum(wgt);
  const float cmin = warp_min(valid ? cost : INFINITY);
  const float cmax = warp_max(valid ? cost : -INFINITY);
  const float csum = warp_sum(valid ? cost : 0.0f);
  if (lane == 0) {
    s_stat[1][warp] = l;
    s_stat[2][warp] = cmin;
    s_stat[3][warp] = cmax;
    s_stat[4][warp] = csum;
  }

  // ---- pass two: regenerate z, reduce sum_k w_k z_k per normal ------------
  ns.reset();
  for (int n = 0; n < n_z; ++n) {
    const float v = warp_sum(wgt * ns.next(n));
    if (lane == 0) s_red[warp * n_z + n] = v;
  }
  __syncthreads();

  float* row = partials + static_cast<size_t>(blockIdx.x) * (kStats + n_z);
  if (threadIdx.x == 0) {
    float bl = 0.0f, bmin = INFINITY, bmax = -INFINITY, bsum = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      bl += s_stat[1][w];
      bmin = fminf(bmin, s_stat[2][w]);
      bmax = fmaxf(bmax, s_stat[3][w]);
      bsum += s_stat[4][w];
    }
    row[0] = m_b;
    row[1] = bl;
    row[2] = bmin;
    row[3] = bmax;
    row[4] = bsum;
    row[5] = row[6] = row[7] = 0.0f;
  }
  for (int n = threadIdx.x; n < n_z; n += kBlock) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_red[w * n_z + n];
    row[kStats + n] = s;
  }
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

template <int S, int A>
int launch_solve(const float* consts, const float* dyn, const float* z,
                 float* partials, int k, int tau, Seeds sd,
                 cudaStream_t stream) {
  Consts<S, A> c;
  const float* p = consts;
  memcpy(c.a, p, sizeof(c.a));
  p += S * S;
  memcpy(c.bs, p, sizeof(c.bs));
  p += S * A;
  memcpy(c.q, p, sizeof(c.q));
  p += S * S;
  memcpy(c.mz, p, sizeof(c.mz));
  p += A * A;
  c.lam = p[0];
  c.nc_half = p[1];

  const int dyn_size = 1 + 2 * S + tau * (S + A) + 1;
  const size_t smem =
      (static_cast<size_t>(dyn_size) + static_cast<size_t>(kWarps) * tau * A) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pm_fused_solve_kernel<S, A>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int nb = (k + kBlock - 1) / kBlock;
  pm_fused_solve_kernel<S, A><<<nb, kBlock, smem, stream>>>(
      c, dyn, dyn_size, z, partials, k, tau, sd);
  return cudaGetLastError();
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

int pm_fused_solve(int sdim, int adim, const float* consts, const float* dyn,
                   const float* z, float* partials, int k, int tau,
                   uint32_t seed_lo, uint32_t seed_hi, uint32_t s_lo,
                   uint32_t s_hi, void* stream) {
  if (k <= 0 || tau <= 0) return cudaErrorInvalidValue;
  const Seeds sd{seed_lo, seed_hi, s_lo, s_hi};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sdim == 6 && adim == 3)
    return launch_solve<6, 3>(consts, dyn, z, partials, k, tau, sd, st);
  if (sdim == 2 && adim == 1)
    return launch_solve<2, 1>(consts, dyn, z, partials, k, tau, sd, st);
  if (sdim == 4 && adim == 2)
    return launch_solve<4, 2>(consts, dyn, z, partials, k, tau, sd, st);
  return cudaErrorInvalidValue;
}

int pm_merge(const float* partials, int nb, int n_z, float* zsum,
             float* stats, void* stream) {
  if (nb <= 0 || n_z <= 0) return cudaErrorInvalidValue;
  pm_merge_kernel<<<1, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, nb, n_z, zsum, stats);
  return cudaGetLastError();
}

const char* pm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
