// Shared pieces of the MPPI kernels (pm_mppi.cu, auv_mppi.cu): the
// Philox4x32-10 noise stream, warp reductions, and the block epilogue that
// turns each sample's cost into the block's partial row.
//
// Noise stream (reproduced by the plain version in kernels/pm_mppi.py):
// normal n of sample k in solve s is lane n%4 of
// Philox4x32-10(counter=(k, n/4, s_lo, s_hi), key=(seed_lo, seed_hi));
// lanes (0,1) and (2,3) are Box-Muller pairs with u = ((bits>>9)+0.5)*2^-23.
// With n = t*adim + j the stream of a sample does not depend on adim's
// place in a Philox block: a step of 6 normals straddles two blocks and
// NoiseStream reads straight on.
//
// Partial row of one block (kStats + n_z floats), merged by pm_merge:
//   (m_b, l_b, cost min, cost max, cost sum, 0, 0, 0, zsum_b[n_z])
// with w_k = exp(zarg_k - m_b), l_b = sum_k w_k, zsum_b = sum_k w_k z_k.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mppi {

constexpr int kBlock = 256;          // samples (threads) per solve block
constexpr int kWarps = kBlock / 32;
constexpr int kStats = 8;            // (m, l, cmin, cmax, csum, pad x3)

// What a solve kernel writes: kFused, the block's softmax partial row;
// kCosts (phase A of the normalized solve), costs[k] + a stats-only row.
enum Mode { kFused = 0, kCosts = 1 };

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

  __device__ __forceinline__ void init(const float* z_, int k_total_,
                                       int k, const Seeds& sd_) {
    z = z_;
    k_total = k_total_;
    sample = static_cast<uint32_t>(k);
    valid = k < k_total_;
    sd = sd_;
    reset();
  }
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

// StaticQuatCost.state_cost of a 13-dim AUV state (auv_mppi.cu,
// nn_mppi.cu): d^T Q d, d = [p - g_p, 2 acos(clamp(q.g_q)), nu - g_nu] with
// the signed dot (costs/static.py) and Q the 10x10 row-major weight; with
// kAbsDot the geodesic |q.g_q| of WayPointsQuatCost (costs/waypoints.py).
// The native acosf: the TPU kernels' polynomial _acos only worked around
// Mosaic.
template <bool kAbsDot = false>
__device__ __forceinline__ float quat_state_cost(const float* q,
                                                 const float* x,
                                                 const float* goal) {
  float d[10];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = x[i] - goal[i];
  float dot = x[3] * goal[3] + x[4] * goal[4] + x[5] * goal[5] +
              x[6] * goal[6];
  if (kAbsDot) dot = fabsf(dot);
  d[3] = 2.0f * acosf(fminf(fmaxf(dot, -1.0f), 1.0f));
#pragma unroll
  for (int i = 0; i < 6; ++i) d[4 + i] = x[7 + i] - goal[7 + i];
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    float qd = 0.0f;
#pragma unroll
    for (int j = 0; j < 10; ++j) qd = fmaf(q[i * 10 + j], d[j], qd);
    out = fmaf(d[i], qd, out);
  }
  return out;
}

// Block epilogue of every solve kernel (blockDim.x == kBlock, all threads
// call it). Each thread brings its sample's log-weight zarg and cost;
// padding threads (valid false) weigh exactly 0 and leave the cost stats
// alone. kMaxShift: m_b = the block's max zarg (fused solve, unbounded
// exponent); else m_b = 0 (phase B, exponent in [-1/lam, 0]; phase A, with
// zarg = -inf and n_z = 0, writes the cost stats only). Pass two
// regenerates z from ns and reduces sum_k w_k z_k per normal with warp
// shuffles, then over the block's warps in s_red (kWarps * n_z floats).
template <bool kMaxShift>
__device__ __forceinline__ void write_partial_row(float zarg, float cost,
                                                  bool valid,
                                                  NoiseStream& ns, int n_z,
                                                  float* s_red, float* row) {
  __shared__ float s_stat[5][kWarps];
  __shared__ float s_m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m_b = 0.0f;
  if (kMaxShift) {
    const float wm = warp_max(valid ? zarg : -INFINITY);
    if (lane == 0) s_stat[0][warp] = wm;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = s_stat[0][0];
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_stat[0][w]);
      s_m = m;
    }
    __syncthreads();
    m_b = s_m;
  }
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

  ns.reset();
  for (int n = 0; n < n_z; ++n) {
    const float v = warp_sum(wgt * ns.next(n));
    if (lane == 0) s_red[warp * n_z + n] = v;
  }
  __syncthreads();

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

// Dynamic shared memory for dyn (dyn_size floats) + s_red; raises the
// kernel's limit above 48 KB when needed.
template <typename Kernel>
inline cudaError_t smem_for(Kernel kernel, int dyn_size, int n_z,
                            size_t* bytes) {
  *bytes = (static_cast<size_t>(dyn_size) +
            static_cast<size_t>(kWarps) * n_z) *
           sizeof(float);
  if (*bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*bytes));
  return cudaSuccess;
}

}  // namespace mppi
