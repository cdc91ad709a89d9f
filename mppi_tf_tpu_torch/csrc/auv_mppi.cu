// Fused AUV (Fossen 6-DoF) MPPI solve for Hopper (sm_90a), plain C
// interface; built with pm_mppi.cu into one library by kernels/_build.py.
//
// auv_fused_solve_kernel<RK, MODE, COST> -- MODE kFused replaces
//   mppi_tf_tpu/kernels/auv_mppi.py::_fused_auv_call (_make_kernel mode
//   "fused"); MODE kCosts replaces _fused_auv_costs (mode "costs", phase A
//   of the normalized solve). Phase B is mppi_weights in pm_mppi.cu,
//   shared with the point mass. COST is _make_kernel's cost_kind:
//   kStaticQuat (:321-359), kWaypointsQuat (:360-368) and kElipse3D
//   (:369-431).
//
//   One thread owns one sample and keeps its 13-state in registers over the
//   horizon; the per-solve dyn array (mass matrix and inverse, mass, goal,
//   x0, the nominal sequence and its folded action-cost terms, ~400 floats
//   at H=25) sits in shared memory; the solve constants (damping, cog/cob,
//   buoyancy, noise scale, Mz, Q: 260 floats) come as a kernel parameter,
//   read from the constant bank. Per step t, with the normals z_t (6) and
//   the schedule's factor c_t (1 unscheduled; :447-463 and :493-497):
//     gen_force = u_t + scale (c_t z_t)
//     rk step of state_dot: rotation, quaternion rates, D nu, C nu from
//       M nu, restoring forces, nu_dot = M^-1 rhs (models/auv.py:254-295,
//       matrix free as the JAX XLA path computes it)
//     quaternion renormalisation, floor 1e-24 on the squared norm
//     cost += q(x) + rhs_z_t . z_t + nc_half c_t z_t^T Mz z_t
//   The schedule and the antithetic mirror are runtime arguments (the c_t
//   at the end of dyn, `half` in Seeds; mppi_common.cuh), not more
//   instantiations of the 18.
//   then + q(x_H) + u_half, where q is
//   * kStaticQuat: the 10-dim StaticQuatCost with the signed dot, clamped,
//     under the native acosf (mppi_common.cuh quat_state_cost; the TPU
//     kernel's polynomial _acos only worked around Mosaic);
//   * kWaypointsQuat: wblend[0] q(x; goal) + wblend[1] q(x; goal2), both
//     with the |dot| geodesic of WayPointsQuatCost. Two exact evaluations,
//     not one effective goal, because the angle is not linear in the goal;
//     they run one after the other through one 10-vector (an unroll-1
//     loop) with both goals and the runtime blend in shared memory, so a
//     pop is new data and the second quadratic costs no registers;
//   * kElipse3D: ElipseCost3D (costs/elipse.py): the pose taken into the
//     plane frame (R_plane, q_plane (x) q), the algebraic ellipse distance,
//     the angle to the ellipse tangent (between_two_vectors of the x-axis,
//     with its antiparallel branch) and the speed error, under native
//     acosf / rsqrtf; the constants share AuvConsts' 100 floats of Q.
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

// State costs (kernels/auv_mppi.py COST_KINDS).
enum AuvCost { kStaticQuat = 0, kWaypointsQuat = 1, kElipse3D = 2 };

// kElipse3D constants (kernels/auv_mppi.py AuvConsts.packed), 25 floats.
struct Elipse3D {
  float r_plane[9];  // inertial -> plane rotation, row-major
  float q_plane[4];  // the same rotation as a quaternion (xyzw)
  float center[3];
  float axis[3];     // (a, b, 1)
  float mapping[3];  // tangent map (-a/b, b/a, 0)
  float gv;          // target speed
  float ms;          // state weight
  float mv;          // speed weight
};

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
  union {
    float q[100];          // 10x10 cost weight (the quaternion costs)
    Elipse3D el;           // kElipse3D
  };
};
static_assert(sizeof(Elipse3D) == 25 * sizeof(float), "Elipse3D layout");
static_assert(sizeof(AuvConsts) == 260 * sizeof(float), "AuvConsts layout");

// dyn layout (kernels/auv_mppi.py Dyn, held equal to auv_dyn_size below):
// the mass matrices, mass, goal, x0, useq and rhs_z (tau*6 each), u_half,
// then the waypoint blocks goal2 (13) and wblend (2).
constexpr int kMTot = 0, kInvM = 36, kMass = 72, kGoal = 73, kX0 = 86,
              kUseq = 99;
__host__ __device__ constexpr int dyn_u_half(int tau) {
  return kUseq + 12 * tau;
}
__host__ __device__ constexpr int dyn_goal2(int tau) {
  return dyn_u_half(tau) + 1;
}
__host__ __device__ constexpr int dyn_wblend(int tau) {
  return dyn_goal2(tau) + 13;
}
__host__ __device__ constexpr int dyn_size(int tau) {
  return dyn_wblend(tau) + 2;
}

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

// ElipseCost3D.state_cost of one 13-state.
__device__ __forceinline__ float elipse3d_cost(const Elipse3D& e,
                                               const float* x) {
  const float pc[3] = {x[0] - e.center[0], x[1] - e.center[1],
                       x[2] - e.center[2]};
  float pf[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pf[i] = e.r_plane[i * 3] * pc[0] + e.r_plane[i * 3 + 1] * pc[1] +
            e.r_plane[i * 3 + 2] * pc[2];
  // position: |sum((p / axis)^2) - 1|
  const float a0 = pf[0] / e.axis[0], a1 = pf[1] / e.axis[1],
              a2 = pf[2] / e.axis[2];
  const float p_err = fabsf(a0 * a0 + a1 * a1 + a2 * a2 - 1.0f);
  // plane-frame attitude q_pf = q_plane (x) q (Hamilton product)
  const float px = e.q_plane[0], py = e.q_plane[1], pz = e.q_plane[2],
              pw = e.q_plane[3];
  const float qx = x[3], qy = x[4], qz = x[5], qw = x[6];
  const float fx = px * qw + py * qz - pz * qy + pw * qx;
  const float fy = -px * qz + py * qw + pz * qx + pw * qy;
  const float fz = px * qy - py * qx + pz * qw + pw * qz;
  const float fw = -px * qx - py * qy - pz * qz + pw * qw;
  // unit tangent at the plane-frame position
  float tx = pf[1] * e.mapping[0], ty = pf[0] * e.mapping[1],
        tz = pf[2] * e.mapping[2];
  const float t2 = tx * tx + ty * ty + tz * tz;
  const float tn = rsqrtf(fmaxf(t2, 1e-24f));
  tx *= tn;
  ty *= tn;
  tz *= tn;
  // between_two_vectors(x-axis, t) = (0, -tz, ty, 1 + tx), normalized;
  // antiparallel (1 + tx < 1e-10): a half turn about z, (0, 0, 1, 0)
  const float wt = 1.0f + tx;
  const bool deg = wt < 1e-10f;
  const float by = deg ? 0.0f : -tz, bz = deg ? 1.0f : ty,
              bw = deg ? 0.0f : wt;
  const float bn = rsqrtf(fmaxf(by * by + bz * bz + bw * bw, 1e-24f));
  const float dot = (by * fy + bz * fz + bw * fw) * bn;
  // a zero tangent (the position on the plane normal through the center)
  // makes between_two_vectors the zero quaternion, whose relative angle is
  // pi in ElipseCost3D; the TPU kernel's w = 1 + tx scores the identity
  // there instead, a disagreement with its XLA path not copied
  const float o_err = t2 > 0.0f ? 2.0f * acosf(fminf(fabsf(dot), 1.0f))
                                : 3.14159265358979f;
  // speed: ||v|^2 - gv^2|
  const float v2 = x[7] * x[7] + x[8] * x[8] + x[9] * x[9];
  const float v_err = fabsf(v2 - e.gv * e.gv);
  return e.ms * p_err + e.ms * o_err + e.mv * v_err;
}

template <int COST>
__device__ __forceinline__ float auv_state_cost(const AuvConsts& c,
                                                const float* s_dyn, int tau,
                                                const float* x) {
  if constexpr (COST == kStaticQuat) {
    return quat_state_cost(c.q, x, s_dyn + kGoal);
  } else if constexpr (COST == kWaypointsQuat) {
    const float* wb = s_dyn + dyn_wblend(tau);
    float out = 0.0f;
#pragma unroll 1
    for (int g = 0; g < 2; ++g) {
      const float* goal = s_dyn + (g == 0 ? kGoal : dyn_goal2(tau));
      out = fmaf(wb[g], quat_state_cost<true>(c.q, x, goal), out);
    }
    return out;
  } else {
    return elipse3d_cost(c.el, x);
  }
}

template <int RK, int MODE, int COST>
__global__ void __launch_bounds__(kBlock)
    auv_fused_solve_kernel(const AuvConsts c, const float* __restrict__ dyn,
                           int n_dyn, int sched_off,
                           const float* __restrict__ z,
                           float* __restrict__ costs,
                           float* __restrict__ partials, int k_total,
                           int tau, Seeds sd) {
  extern __shared__ float smem[];
  float* s_dyn = smem;          // n_dyn = dyn_size(tau) (+ tau scheduled)
  float* s_red = smem + n_dyn;  // kWarps * n_z: pass-two warp sums

  for (int i = threadIdx.x; i < n_dyn; i += kBlock) s_dyn[i] = dyn[i];
  __syncthreads();

  const float* useq = s_dyn + kUseq;
  const float* rhs_z = useq + 6 * tau;
  const float u_half = s_dyn[dyn_u_half(tau)];
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
    const float ct = sched_factor(s_dyn, sched_off, t);
    float zt[6], gf[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) zt[j] = ns.next(n++);
    // gen_force = u_t + scale (c_t z_t)
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float s = useq[t * 6 + i];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        s = fmaf(c.scale[i * 6 + j], ct * zt[j], s);
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

    cost += auv_state_cost<COST>(c, s_dyn, tau, x);
    float quad = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      cost = fmaf(rhs_z[t * 6 + j], zt[j], cost);
      float mz = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) mz = fmaf(c.mz[j * 6 + i], zt[i], mz);
      quad = fmaf(zt[j], mz, quad);
    }
    cost = fmaf(c.nc_half * sched_factor(s_dyn, sched_off, t), quad, cost);
  }
  cost += auv_state_cost<COST>(c, s_dyn, tau, x);
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

// The launch of one solve: k samples over horizon tau; scheduled (0 / 1)
// appends the tau factors c_t to dyn.
struct AuvLaunch {
  const float* dyn;
  const float* z;
  float* costs;
  float* partials;
  int k, tau, scheduled;
  Seeds sd;
  cudaStream_t stream;
};

template <int RK, int MODE, int COST>
int launch_auv(const AuvConsts& c, const AuvLaunch& a) {
  const int n_dyn = dyn_size(a.tau) + (a.scheduled ? a.tau : 0);
  const int sched_off = a.scheduled ? dyn_size(a.tau) : -1;
  size_t smem = 0;
  const cudaError_t e =
      smem_for(auv_fused_solve_kernel<RK, MODE, COST>, n_dyn,
               MODE == kFused ? a.tau * 6 : 0, &smem);
  if (e != cudaSuccess) return e;
  const int nb = (a.k + kBlock - 1) / kBlock;
  auv_fused_solve_kernel<RK, MODE, COST><<<nb, kBlock, smem, a.stream>>>(
      c, a.dyn, n_dyn, sched_off, a.z, a.costs, a.partials, a.k, a.tau,
      a.sd);
  return cudaGetLastError();
}

template <int MODE, int COST>
int dispatch_rk(int rk, const AuvConsts& c, const AuvLaunch& a) {
  if (rk == 1) return launch_auv<1, MODE, COST>(c, a);
  if (rk == 2) return launch_auv<2, MODE, COST>(c, a);
  if (rk == 4) return launch_auv<4, MODE, COST>(c, a);
  return cudaErrorInvalidValue;
}

template <int MODE>
int dispatch_auv(int rk, int cost, const float* consts, const AuvLaunch& a) {
  if (a.k <= 0 || a.tau <= 0) return cudaErrorInvalidValue;
  AuvConsts c;
  memcpy(&c, consts, sizeof(c));
  if (cost == kStaticQuat) return dispatch_rk<MODE, kStaticQuat>(rk, c, a);
  if (cost == kWaypointsQuat)
    return dispatch_rk<MODE, kWaypointsQuat>(rk, c, a);
  if (cost == kElipse3D) return dispatch_rk<MODE, kElipse3D>(rk, c, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// consts: AuvConsts.packed (260 floats); cost: AuvCost; dyn: dyn_size(tau)
// floats, then tau factors c_t when scheduled; half: the antithetic
// solve's first mirrored sample, 0 for none (mppi_common.cuh).
int auv_fused_solve(int rk, int cost, const float* consts, const float* dyn,
                    const float* z, float* partials, int k, int tau,
                    int scheduled, uint32_t half, uint32_t seed_lo,
                    uint32_t seed_hi, uint32_t s_lo, uint32_t s_hi,
                    void* stream) {
  return dispatch_auv<kFused>(
      rk, cost, consts,
      AuvLaunch{dyn, z, nullptr, partials, k, tau, scheduled,
                Seeds{seed_lo, seed_hi, s_lo, s_hi, half},
                static_cast<cudaStream_t>(stream)});
}

int auv_fused_costs(int rk, int cost, const float* consts, const float* dyn,
                    const float* z, float* costs, float* partials, int k,
                    int tau, int scheduled, uint32_t half, uint32_t seed_lo,
                    uint32_t seed_hi, uint32_t s_lo, uint32_t s_hi,
                    void* stream) {
  return dispatch_auv<kCosts>(
      rk, cost, consts,
      AuvLaunch{dyn, z, costs, partials, k, tau, scheduled,
                Seeds{seed_lo, seed_hi, s_lo, s_hi, half},
                static_cast<cudaStream_t>(stream)});
}

// The dyn length the kernels stage for horizon tau: the wrappers hold
// kernels/auv_mppi.py Dyn(tau).size against it before a launch.
int auv_dyn_size(int tau) { return dyn_size(tau); }

}  // extern "C"
