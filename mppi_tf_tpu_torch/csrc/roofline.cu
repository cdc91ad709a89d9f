// Microbenchmarks of the card's ceilings, for roofline.py
// (measure_ceilings): the f32 FMA rate, the __expf (MUFU) rate, the rate of
// Box-Muller pairs drawn through the kernels' own Philox4x32-10 and
// transforms (mppi_common.cuh), and the HBM stream-read rate.
//
// They replace no TPU kernel: they are the port's counterparts of the
// compiled microbenchmarks of mppi_tf_tpu/roofline.py:62-209, which the JAX
// package timed through a relay with fetch-forced round trips; here each
// is timed with CUDA events by its wrapper. Each is bound by the resource
// it measures, and its design keeps everything else off the path:
// - fma: 8 independent fmaf chains a thread (ILP above the FMA latency), a
//   runtime multiplier so that nothing folds, 2048 threads an SM;
// - expf: 8 independent __expf chains a thread (FMUL + MUFU.EX2 each);
// - bm: one philox4x32_10 and two box_muller a loop (4 normals, 2 pairs),
//   the code the solve kernels run (philox_normals), summed so that
//   nothing is dead;
// - stream: float4 reads through the read-only path, four in flight a
//   thread, grid-stride over a buffer far beyond the 50 MB L2, one float a
//   thread written.
// None keeps anything in shared memory; none spills (chip_smoke.py fails
// the build on a spill). The kernels sit outside every count of the solve
// kernels' instantiations (their names match no entry of chip_smoke.py's
// BASE_REGISTERS or SASS_KERNELS).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mppi_common.cuh"

namespace {

using namespace mppi;

constexpr int kRoofThreads = 256;
constexpr int kChains = 8;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kRoofThreads)
    mppi_roofline_fma_kernel(float* __restrict__ out, int iters, float c) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float a[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) a[j] = 1.0f + 1e-3f * (t & 1023) + j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) a[j] = fmaf(a[j], c, 1e-9f);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += a[j];
  out[t] = s;
}

__global__ void __launch_bounds__(kRoofThreads)
    mppi_roofline_expf_kernel(float* __restrict__ out, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float x[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j)
    x[j] = 0.1f + 1e-4f * (t & 1023) + 0.1f * j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) x[j] = __expf(-x[j]);  // in (0, 1)
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += x[j];
  out[t] = s;
}

__global__ void __launch_bounds__(kRoofThreads)
    mppi_roofline_bm_kernel(float* __restrict__ out, int iters,
                            uint32_t seed) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    const uint4 w = philox4x32_10(
        make_uint4(t, static_cast<uint32_t>(i), 0u, 0u), seed, 0u);
    float z0, z1, z2, z3;
    box_muller(w.x, w.y, 1.0f, z0, z1);
    box_muller(w.z, w.w, 1.0f, z2, z3);
    acc += (z0 + z1) + (z2 + z3);
  }
  out[t] = acc;
}

__global__ void __launch_bounds__(kRoofThreads)
    mppi_roofline_stream_kernel(const float4* __restrict__ in, long long n4,
                                float* __restrict__ out) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float acc = 0.0f;
  long long i = tid;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const float4 v0 = __ldg(in + i), v1 = __ldg(in + i + stride),
                 v2 = __ldg(in + i + 2 * stride),
                 v3 = __ldg(in + i + 3 * stride);
    acc += ((v0.x + v0.y) + (v0.z + v0.w)) + ((v1.x + v1.y) + (v1.z + v1.w))
           + ((v2.x + v2.y) + (v2.z + v2.w))
           + ((v3.x + v3.y) + (v3.z + v3.w));
  }
  for (; i < n4; i += stride) {
    const float4 v = __ldg(in + i);
    acc += (v.x + v.y) + (v.z + v.w);
  }
  out[tid] = acc;
}

}  // namespace

extern "C" {

// Each writes one float a thread to `out` ([blocks * 256]) and returns the
// launch's error code. Work a launch: fma 2 * kChains * kUnroll * iters
// flops a thread; expf kChains * kUnroll * iters; bm 2 * iters pairs a
// thread; stream 16 * n4 bytes read.
int roofline_threads() { return kRoofThreads; }
int roofline_chains() { return kChains * kUnroll; }

int roofline_fma(float* out, int blocks, int iters, float c, void* stream) {
  if (blocks <= 0 || iters <= 0) return cudaErrorInvalidValue;
  mppi_roofline_fma_kernel<<<blocks, kRoofThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(out, iters,
                                                                  c);
  return cudaGetLastError();
}

int roofline_expf(float* out, int blocks, int iters, void* stream) {
  if (blocks <= 0 || iters <= 0) return cudaErrorInvalidValue;
  mppi_roofline_expf_kernel<<<blocks, kRoofThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(out,
                                                                   iters);
  return cudaGetLastError();
}

int roofline_bm(float* out, int blocks, int iters, uint32_t seed,
                void* stream) {
  if (blocks <= 0 || iters <= 0) return cudaErrorInvalidValue;
  mppi_roofline_bm_kernel<<<blocks, kRoofThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(out, iters,
                                                                 seed);
  return cudaGetLastError();
}

int roofline_stream(const float* in, long long n4, float* out, int blocks,
                    void* stream) {
  if (blocks <= 0 || n4 <= 0) return cudaErrorInvalidValue;
  mppi_roofline_stream_kernel<<<blocks, kRoofThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), n4, out);
  return cudaGetLastError();
}

}  // extern "C"
