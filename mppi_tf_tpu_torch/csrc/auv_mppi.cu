// Fused AUV (Fossen 6-DoF) MPPI solve for Hopper (sm_90a), plain C
// interface; built with pm_mppi.cu into one library by kernels/_build.py.
//
// auv_fused_solve_kernel<RK, MODE> -- MODE kFused replaces
//   mppi_tf_tpu/kernels/auv_mppi.py::_fused_auv_call (_make_kernel mode
//   "fused", cost "static_quat"); MODE kCosts replaces _fused_auv_costs
//   (mode "costs", phase A of the normalized solve). Phase B is
//   mppi_weights in pm_mppi.cu, shared with the point mass.
//
//   One thread owns one sample and keeps its 13-state in registers over the
//   horizon; the per-solve dyn array (mass matrix and inverse, mass, goal,
//   x0, the nominal sequence and its folded action-cost terms, ~400 floats
//   at H=25) sits in shared memory; the solve constants (damping, cog/cob,
//   buoyancy, noise scale, Mz, Q: 260 floats) come as a kernel parameter,
//   read from the constant bank. Per step t, with the normals z_t (6):
//     gen_force = u_t + scale z_t
//     rk step of state_dot: rotation, quaternion rates, D nu, C nu from
//       M nu, restoring forces, nu_dot = M^-1 rhs (models/auv.py:254-295,
//       matrix free as the JAX XLA path computes it)
//     quaternion renormalisation, floor 1e-24 on the squared norm
//     cost += q(x) + rhs_z_t . z_t + nc_half z_t^T Mz z_t
//   then + q(x_H) + u_half; q is the 10-dim StaticQuatCost with the signed
//   dot, clamped, under the native acosf (mppi_common.cuh quat_state_cost;
//   the TPU kernel's polynomial _acos only worked around Mosaic).
//
//   RK is 1, 2 or 4, each integrated as models/auv.py::AUVModel.step does;
//   the TPU kernel runs every rk != 1 as rk2, a fault not copied here.
//
//   Bound by operations: ~0.3 kFLOP a state_dot (two a step at rk2, four at
//   rk4), ~0.2 kFLOP of cost and force a step, and the Philox + Box-Muller
//   passes (~32 ops a normal; two in kFused, one in kCosts); kCosts writes 4
//   bytes a sample. The matrices are dense loops (no compile-time zero
//   elision yet). The softmax epilogue, the regenerated-z zsum pass and the
//   block partial rows are those of pm_mppi.cu (mppi_common.cuh), so
//   pm_merge merges them unchanged; the TPU grid's pid == 0 initialisation
//   and read-modify-write carry are not copied.

#include <string.h>

#include "mppi_common.cuh"

namespace {

using namespace mppi;

constexpr float kGravity = 9.81f;

// Solve constants, in the order of kernels/auv_mppi.py AuvConsts.packed.
struct AuvConsts {
  float dt;
  float lam;
  float nc_half;
  float buoyancy;          // rho V g
  float lin_damp[36];      // L, row-major
  float lin_damp_fwd[36];  // L_fwd
  float quad_damp[6];      // diag(Q_d)
  float cog[3];
  float cob[3];
  float scale[36];         // upsilon sigma
  float mz[36];            // scale^T Sigma^-1 scale
  float q[100];            // 10x10 cost weight
};
static_assert(sizeof(AuvConsts) == 260 * sizeof(float), "AuvConsts layout");

// dyn layout (kernels/auv_mppi.py Dyn)
constexpr int kMTot = 0, kInvM = 36, kMass = 72, kGoal = 73, kX0 = 86,
              kUseq = 99;

__device__ __forceinline__ void cross3(const float* u, const float* v,
                                       float* out) {
  out[0] = u[1] * v[2] - u[2] * v[1];
  out[1] = u[2] * v[0] - u[0] * v[2];
  out[2] = u[0] * v[1] - u[1] * v[0];
}

// x_dot = f(x, gen_force) of models/auv.py::AUVModel.state_dot.
__device__ __forceinline__ void state_dot(const AuvConsts& c,
                                          const float* s_dyn, float fng,
                                          const float* x, const float* gf,
                                          float* xd) {
  const float qx = x[3], qy = x[4], qz = x[5], qw = x[6];
  const float* nu = x + 7;
  const float* v = x + 7;
  const float* w = x + 10;
  // rotation body -> inertial (quaternion.to_rotation_matrix)
  const float r11 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const float r12 = 2.0f * (qx * qy - qz * qw);
  const float r13 = 2.0f * (qx * qz + qy * qw);
  const float r21 = 2.0f * (qx * qy + qz * qw);
  const float r22 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float r23 = 2.0f * (qy * qz - qx * qw);
  const float r31 = 2.0f * (qx * qz - qy * qw);
  const float r32 = 2.0f * (qy * qz + qx * qw);
  const float r33 = 1.0f - 2.0f * (qx * qx + qy * qy);
  xd[0] = r11 * v[0] + r12 * v[1] + r13 * v[2];
  xd[1] = r21 * v[0] + r22 * v[1] + r23 * v[2];
  xd[2] = r31 * v[0] + r32 * v[1] + r33 * v[2];
  // quaternion rates 0.5 T(q) w
  xd[3] = 0.5f * (qw * w[0] - qz * w[1] + qy * w[2]);
  xd[4] = 0.5f * (qz * w[0] + qw * w[1] - qx * w[2]);
  xd[5] = 0.5f * (-qy * w[0] + qx * w[1] + qw * w[2]);
  xd[6] = 0.5f * (-qx * w[0] - qy * w[1] - qz * w[2]);

  float rhs[6];
  // D nu = -L nu - u (L_fwd nu) - Q_d (|nu| . nu)
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float ld = 0.0f, lf = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      ld = fmaf(c.lin_damp[i * 6 + j], nu[j], ld);
      lf = fmaf(c.lin_damp_fwd[i * 6 + j], nu[j], lf);
    }
    const float dv = -ld - nu[0] * lf - c.quad_damp[i] * (fabsf(nu[i]) * nu[i]);
    rhs[i] = gf[i] - dv;
  }
  // C nu = [-a1 x w ; -a1 x v - a2 x w], [a1; a2] = M nu
  float a[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s = fmaf(s_dyn[kMTot + i * 6 + j], nu[j], s);
    a[i] = s;
  }
  float c1[3], c2[3], c3[3];
  cross3(a, w, c1);
  cross3(a, v, c2);
  cross3(a + 3, w, c3);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rhs[i] += c1[i];
    rhs[3 + i] += c2[i] + c3[i];
  }
  // restoring g = -[fbg + fbb ; cog x fbg + cob x fbb], f = R^T (0, 0, f_z)
  const float fbg[3] = {r31 * fng, r32 * fng, r33 * fng};
  const float fbb[3] = {r31 * c.buoyancy, r32 * c.buoyancy,
                        r33 * c.buoyancy};
  float mbg[3], mbb[3];
  cross3(c.cog, fbg, mbg);
  cross3(c.cob, fbb, mbb);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rhs[i] += fbg[i] + fbb[i];
    rhs[3 + i] += mbg[i] + mbb[i];
  }
  // nu_dot = M^-1 rhs
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s = fmaf(s_dyn[kInvM + i * 6 + j], rhs[j], s);
    xd[7 + i] = s;
  }
}

template <int RK, int MODE>
__global__ void __launch_bounds__(kBlock)
    auv_fused_solve_kernel(const AuvConsts c, const float* __restrict__ dyn,
                           int dyn_size, const float* __restrict__ z,
                           float* __restrict__ costs,
                           float* __restrict__ partials, int k_total,
                           int tau, Seeds sd) {
  extern __shared__ float smem[];
  float* s_dyn = smem;             // dyn_size
  float* s_red = smem + dyn_size;  // kWarps * n_z: pass-two warp sums

  for (int i = threadIdx.x; i < dyn_size; i += kBlock) s_dyn[i] = dyn[i];
  __syncthreads();

  const float* goal = s_dyn + kGoal;
  const float* useq = s_dyn + kUseq;
  const float* rhs_z = useq + 6 * tau;
  const float u_half = rhs_z[6 * tau];
  const float fng = -s_dyn[kMass] * kGravity;

  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < k_total;
  NoiseStream ns;
  ns.init(z, k_total, k, sd);

  float cost = 0.0f;
  float x[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = s_dyn[kX0 + i];
  int n = 0;
  for (int t = 0; t < tau; ++t) {
    float zt[6], gf[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) zt[j] = ns.next(n++);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float s = useq[t * 6 + i];
#pragma unroll
      for (int j = 0; j < 6; ++j) s = fmaf(c.scale[i * 6 + j], zt[j], s);
      gf[i] = s;
    }

    float k1[13], xs[13];
    state_dot(c, s_dyn, fng, x, gf, k1);
    if (RK == 1) {
#pragma unroll
      for (int i = 0; i < 13; ++i) x[i] = fmaf(c.dt, k1[i], x[i]);
    } else if (RK == 2) {
      float k2[13];
#pragma unroll
      for (int i = 0; i < 13; ++i) xs[i] = fmaf(c.dt, k1[i], x[i]);
      state_dot(c, s_dyn, fng, xs, gf, k2);
      const float h = 0.5f * c.dt;
#pragma unroll
      for (int i = 0; i < 13; ++i) x[i] = fmaf(h, k1[i] + k2[i], x[i]);
    } else {
      // acc = k1 + 2 k2 + 2 k3 + k4, x += dt/6 acc (models/auv.py:316-320)
      float acc[13], kk[13];
      const float h = 0.5f * c.dt;
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        acc[i] = k1[i];
        xs[i] = fmaf(h, k1[i], x[i]);
      }
      state_dot(c, s_dyn, fng, xs, gf, kk);
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        acc[i] = fmaf(2.0f, kk[i], acc[i]);
        xs[i] = fmaf(h, kk[i], x[i]);
      }
      state_dot(c, s_dyn, fng, xs, gf, kk);
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        acc[i] = fmaf(2.0f, kk[i], acc[i]);
        xs[i] = fmaf(c.dt, kk[i], x[i]);
      }
      state_dot(c, s_dyn, fng, xs, gf, kk);
      const float h6 = c.dt / 6.0f;
#pragma unroll
      for (int i = 0; i < 13; ++i) x[i] = fmaf(h6, acc[i] + kk[i], x[i]);
    }
    // quaternion renormalisation
    const float s2 = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6];
    const float inv = rsqrtf(fmaxf(s2, 1e-24f));
#pragma unroll
    for (int i = 3; i < 7; ++i) x[i] *= inv;

    cost += quat_state_cost(c.q, x, goal);
    float quad = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      cost = fmaf(rhs_z[t * 6 + j], zt[j], cost);
      float mz = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) mz = fmaf(c.mz[j * 6 + i], zt[i], mz);
      quad = fmaf(zt[j], mz, quad);
    }
    cost = fmaf(c.nc_half, quad, cost);
  }
  cost += quat_state_cost(c.q, x, goal);
  cost += u_half;

  if (MODE == kFused) {
    float* row = partials + static_cast<size_t>(blockIdx.x) *
                                (kStats + tau * 6);
    write_partial_row<true>(-cost / c.lam, cost, valid, ns, tau * 6, s_red,
                            row);
  } else {
    if (valid) costs[k] = cost;
    write_partial_row<false>(-INFINITY, cost, valid, ns, 0, s_red,
                             partials + static_cast<size_t>(blockIdx.x) *
                                            kStats);
  }
}

template <int RK, int MODE>
int launch_auv(const AuvConsts& c, const float* dyn, const float* z,
               float* costs, float* partials, int k, int tau, Seeds sd,
               cudaStream_t stream) {
  const int dyn_size = kUseq + 12 * tau + 1;
  size_t smem = 0;
  const cudaError_t e = smem_for(auv_fused_solve_kernel<RK, MODE>, dyn_size,
                                 MODE == kFused ? tau * 6 : 0, &smem);
  if (e != cudaSuccess) return e;
  const int nb = (k + kBlock - 1) / kBlock;
  auv_fused_solve_kernel<RK, MODE><<<nb, kBlock, smem, stream>>>(
      c, dyn, dyn_size, z, costs, partials, k, tau, sd);
  return cudaGetLastError();
}

template <int MODE>
int dispatch_auv(int rk, const float* consts, const float* dyn,
                 const float* z, float* costs, float* partials, int k,
                 int tau, Seeds sd, cudaStream_t st) {
  if (k <= 0 || tau <= 0) return cudaErrorInvalidValue;
  AuvConsts c;
  memcpy(&c, consts, sizeof(c));
  if (rk == 1)
    return launch_auv<1, MODE>(c, dyn, z, costs, partials, k, tau, sd, st);
  if (rk == 2)
    return launch_auv<2, MODE>(c, dyn, z, costs, partials, k, tau, sd, st);
  if (rk == 4)
    return launch_auv<4, MODE>(c, dyn, z, costs, partials, k, tau, sd, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int auv_fused_solve(int rk, const float* consts, const float* dyn,
                    const float* z, float* partials, int k, int tau,
                    uint32_t seed_lo, uint32_t seed_hi, uint32_t s_lo,
                    uint32_t s_hi, void* stream) {
  return dispatch_auv<kFused>(rk, consts, dyn, z, nullptr, partials, k, tau,
                              Seeds{seed_lo, seed_hi, s_lo, s_hi},
                              static_cast<cudaStream_t>(stream));
}

int auv_fused_costs(int rk, const float* consts, const float* dyn,
                    const float* z, float* costs, float* partials, int k,
                    int tau, uint32_t seed_lo, uint32_t seed_hi,
                    uint32_t s_lo, uint32_t s_hi, void* stream) {
  return dispatch_auv<kCosts>(rk, consts, dyn, z, costs, partials, k, tau,
                              Seeds{seed_lo, seed_hi, s_lo, s_hi},
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
