// Fused AUV (Fossen 6-DoF) MPPI solve for Hopper (sm_90a), plain C
// interface; built with pm_mppi.cu into one library by kernels/_build.py.
//
// auv_fused_solve_kernel<RK, MODE, COST, STRUCT> -- MODE kFused replaces
//   mppi_tf_tpu/kernels/auv_mppi.py::_fused_auv_call (_make_kernel mode
//   "fused"); MODE kCosts replaces _fused_auv_costs (mode "costs", phase A
//   of the normalized solve). Phase B is mppi_weights in pm_mppi.cu,
//   shared with the point mass. COST is _make_kernel's cost_kind:
//   kStaticQuat (:321-359), kWaypointsQuat (:360-368) and kElipse3D
//   (:369-431). STRUCT is the structure of the solve constants (below).
//
//   One thread owns one sample and keeps its 13-state in registers over the
//   horizon; the per-solve dyn array (mass matrix and inverse, mass, goal,
//   x0, the nominal sequence and its folded action-cost terms, ~400 floats
//   at H=25) sits in shared memory, the mass matrices once more as padded
//   rows (mass_row); the solve constants (damping, cog/cob, buoyancy, noise
//   scale, Mz, Q: 260 floats) come as a kernel parameter, read from the
//   constant bank. Per step t, with the normals z_t (6) and the schedule's
//   factor c_t (1 unscheduled; :447-463 and :493-497):
//     gen_force = u_t + scale (c_t z_t)
//     rk step of state_dot: rotation, quaternion rates, D nu, C nu from
//       M nu, restoring forces, nu_dot = M^-1 rhs (models/auv.py:254-295,
//       matrix free as the JAX XLA path computes it)
//     quaternion renormalisation, floor 1e-24 on the squared norm
//     cost += q(x) + rhs_z_t . z_t + nc_half c_t z_t^T Mz z_t
//   The schedule and the antithetic mirror are runtime arguments (the c_t
//   at the end of dyn, `half` in Seeds; mppi_common.cuh), not more
//   instantiations.
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
//   STRUCT, the TPU kernel's compile-time zero elision (its constants are
//   Python floats and "zero entries generate NO code", :15-20, :235, :248,
//   :346, :459, :478, :484) as a template argument the host picks exactly
//   (kernels/auv_mppi.py structure): kDiag reads L, scale = upsilon sigma,
//   Mz and Q as their diagonals and takes L_fwd and cog as zero, and emits
//   no instruction for the entries it leaves out; kDense runs every matrix
//   dense, for any other model. Both drop the z-quadratic when nc_half is
//   0 (upsilon 1; a uniform branch). An FMA by an exact 0.0 adds +-0, so
//   kDiag gives kDense's bits: each product a dense chain would start from
//   0 is rounded alone (mul_r), as the chain's first nonzero FMA rounds it,
//   and so are the restoring forces, whose products the compiler would
//   otherwise fuse into their sum once cog's use of them is elided.
//   The rexrov2 flagship and its tasks at a diagonal sigma are kDiag: a
//   rk2 step's FMAs on constants fall from 316 to 34 (the damping
//   matrices' 72 a state_dot to 6, scale's and Mz's 36 each to 6, Q's 100
//   to 10; kWaypointsQuat 416 to 44), the z-quadratic goes at upsilon 1.
//
//   Bound by operations: ~0.2 kFLOP a state_dot at kDiag (two a step at
//   rk2, four at rk4), ~0.1 kFLOP of cost and force a step, and the Philox
//   + Box-Muller passes (~32 ops a normal; two in kFused, one in kCosts);
//   kCosts writes 4 bytes a sample. The op count leaves the latency of the
//   dependent FMA chains, the mass-row loads and the MUFU ops (acosf,
//   rsqrtf) to be hidden by warps: the kDiag build asks ptxas for two
//   blocks of 256 an SM at rk 1 and 2 (__launch_bounds__ minimum, so at
//   most 128 registers a thread: 16 warps an SM, against one block at the
//   160-225 registers the dense body held); kDense and rk4 keep one. The
//   budget holds because M and M^-1 (the model's, dense and dynamic, as in
//   the TPU kernel) are read at each use from padded 8-float rows in shared
//   memory through volatile loads, one LDS.128 and one LDS.64 a row: plain
//   loads of loop-invariant addresses are hoisted out of the horizon loop
//   into 72 registers, as kDense keeps them (its rk2 costs mode spills at
//   128 registers, and at one block the loads cost it 3%). The softmax
//   epilogue, the regenerated-z zsum pass and the block partial rows are
//   those of pm_mppi.cu (mppi_common.cuh), so pm_merge merges them
//   unchanged; the TPU grid's pid == 0 initialisation and
//   read-modify-write carry are not copied.
//
//   The bf16 block compute (compute_dtype "bfloat16", :132-133, :189-199,
//   :433-443) is this source at Val = bf16x2 through auv_mppi_bf16.cu
//   (mppi_common.cuh, MPPI_BF16_PAIRS), at kDense alone: two samples a
//   thread, 128 threads a block for one partial row, each rollout op one
//   native bf16x2 instruction for both samples. The 13-state, the force
//   u_t + c_t (scale z_t) in the TPU kernel's order, every op of state_dot,
//   the rk stages and the renormalisation round to bf16, with the dyn
//   reads the TPU kernel casts (mass matrices, x0, useq, goals, blend
//   weights) rounded and -m g formed in f32 and rounded once; state_dot
//   keeps this source's own algebra (M nu, the cross products, the cached
//   M^-1), which the plain bf16 version in kernels/auv_mppi.py follows op
//   for op. The renormalisation's rsqrt and the state cost run per lane in
//   f32 on the widened state (the TPU kernel's :312-313 and :433-443); the
//   z terms are bf16 values added to each lane's f32 cost. The solve
//   constants reach the kernel as duplicated bf16x2 words (AuvConstsT,
//   packed by the entry point) in the constant bank, loaded with LDC (a
//   bf16x2 op takes no constant-bank operand, an FFMA does); the mass
//   matrices are staged as padded bf16x2 rows in shared memory, x0, useq
//   and rhs_z as words in place; the dt factors and the literals are
//   converted once. No conversion a rollout op is left: the cvts are the
//   noise packing (one a normal pair), the renormalisation's factor and
//   the per-step scalars c_t and nc_half c_t.

#include <string.h>

#include "mppi_common.cuh"

namespace {

using namespace mppi;

constexpr float kGravity = 9.81f;

// State costs (kernels/auv_mppi.py COST_KINDS).
enum AuvCost { kStaticQuat = 0, kWaypointsQuat = 1, kElipse3D = 2 };
// Structure of the solve constants (kernels/auv_mppi.py STRUCTURES): kDiag
// reads L, scale, Mz and Q as diagonals and L_fwd, cog as zero.
enum AuvStruct { kDense = 0, kDiag = 1 };

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

// Solve constants, in the order of kernels/auv_mppi.py AuvConsts.packed;
// W is the type of the rollout's constants (the host's BF16_FIELDS): float,
// or in the pair build the bf16x2 word (w, w) of each.
template <typename W>
struct AuvConstsT {
  float dt;
  float lam;
  float nc_half;
  W buoyancy;          // rho V g
  W lin_damp[36];      // L, row-major
  W lin_damp_fwd[36];  // L_fwd
  W quad_damp[6];      // diag(Q_d)
  W cog[3];
  W cob[3];
  W scale[36];         // upsilon sigma
  W mz[36];            // scale^T Sigma^-1 scale
  union {
    float q[100];      // 10x10 cost weight (the quaternion costs)
    Elipse3D el;       // kElipse3D
  };
};
using HostConsts = AuvConstsT<float>;
#ifdef MPPI_BF16_PAIRS
using AuvConsts = AuvConstsT<bf16x2>;

// The pair build's constants: each rollout constant (already a bf16 value,
// packed rounded by the host) as its duplicated bf16x2 word.
AuvConsts pair_consts(const HostConsts& f) {
  AuvConsts c;
  memcpy(&c, &f, sizeof(c));
  const float* src = &f.buoyancy;
  bf16x2* dst = &c.buoyancy;
  for (int i = 0; i < 1 + 36 + 36 + 6 + 3 + 3 + 36 + 36; ++i)
    dst[i] = bf16x2(src[i]);
  return c;
}
#else
using AuvConsts = HostConsts;
#endif
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

// Row i of the staged mass matrix (mat 0: M, 1: M^-1), each row padded to
// 8 words in shared memory. The pair build stages both as bf16x2 words:
// two 16-byte broadcast loads a row. The f32 kDiag build reads the floats
// at each use through volatile loads (16 and 8 bytes), which no compiler
// pass hoists out of the horizon loop into registers; kDense, at one block
// an SM, reads them with plain loads, which are hoisted (72 registers).
constexpr int kMassWords = 2 * 6 * 8;
#ifdef MPPI_BF16_PAIRS
template <int STRUCT>
__device__ __forceinline__ void mass_row(const float* s_mass, int mat, int i,
                                         Val* r) {
  const uint4* p = reinterpret_cast<const uint4*>(s_mass) + mat * 12 + 2 * i;
  const uint4 a = p[0], b = p[1];
  r[0] = bf16x2::bits(a.x);
  r[1] = bf16x2::bits(a.y);
  r[2] = bf16x2::bits(a.z);
  r[3] = bf16x2::bits(a.w);
  r[4] = bf16x2::bits(b.x);
  r[5] = bf16x2::bits(b.y);
}
#else
template <int STRUCT>
__device__ __forceinline__ void mass_row(const float* s_mass, int mat, int i,
                                         Val* r) {
  const float* p = s_mass + (mat * 6 + i) * 8;
  if constexpr (STRUCT == kDense) {
#pragma unroll
    for (int j = 0; j < 6; ++j) r[j] = p[j];
  } else {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(r[0]), "=f"(r[1]), "=f"(r[2]), "=f"(r[3])
                 : "r"(a));
    asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2+16];"
                 : "=f"(r[4]), "=f"(r[5])
                 : "r"(a));
  }
}
#endif

// u: Vals, or solve constants (packed rounded at bf16)
template <typename U>
__device__ __forceinline__ void cross3(const U* u, const Val* v, Val* out) {
  out[0] = exact_val(u[1]) * v[2] - exact_val(u[2]) * v[1];
  out[1] = exact_val(u[2]) * v[0] - exact_val(u[0]) * v[2];
  out[2] = exact_val(u[0]) * v[1] - exact_val(u[1]) * v[0];
}

// x_dot = f(x, gen_force) of models/auv.py::AUVModel.state_dot; s_mass:
// the staged mass matrices (mass_row). kRows: the unroll of the 6x6
// products' rows (the pair build's rk4 runs them one row at a time: fully
// unrolled its four-stage step spills).
template <int STRUCT, int kRows>
__device__ __forceinline__ void state_dot(const AuvConsts& c,
                                          const float* s_mass, Val fng,
                                          const Val* x, const Val* gf,
                                          Val* xd) {
  const Val qx = x[3], qy = x[4], qz = x[5], qw = x[6];
  const Val* nu = x + 7;
  const Val* v = x + 7;
  const Val* w = x + 10;
  // rotation body -> inertial (quaternion.to_rotation_matrix)
  const Val r11 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const Val r12 = 2.0f * (qx * qy - qz * qw);
  const Val r13 = 2.0f * (qx * qz + qy * qw);
  const Val r21 = 2.0f * (qx * qy + qz * qw);
  const Val r22 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const Val r23 = 2.0f * (qy * qz - qx * qw);
  const Val r31 = 2.0f * (qx * qz - qy * qw);
  const Val r32 = 2.0f * (qy * qz + qx * qw);
  const Val r33 = 1.0f - 2.0f * (qx * qx + qy * qy);
  xd[0] = r11 * v[0] + r12 * v[1] + r13 * v[2];
  xd[1] = r21 * v[0] + r22 * v[1] + r23 * v[2];
  xd[2] = r31 * v[0] + r32 * v[1] + r33 * v[2];
  // quaternion rates 0.5 T(q) w
  xd[3] = 0.5f * (qw * w[0] - qz * w[1] + qy * w[2]);
  xd[4] = 0.5f * (qz * w[0] + qw * w[1] - qx * w[2]);
  xd[5] = 0.5f * (-qy * w[0] + qx * w[1] + qw * w[2]);
  xd[6] = 0.5f * (-qx * w[0] - qy * w[1] - qz * w[2]);

  Val rhs[6];
  // D nu = -L nu - u (L_fwd nu) - Q_d (|nu| . nu); kDiag: -L_ii nu_i -
  // Q_d,i |nu_i| nu_i, the dense row's value (its zero products add +-0,
  // and -ld - nu_0 lf contracts to -ld there)
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    Val dv;
    if constexpr (STRUCT == kDiag) {
      dv = -mul_r(exact_val(c.lin_damp[i * 7]), nu[i]) -
           exact_val(c.quad_damp[i]) * (abs_r(nu[i]) * nu[i]);
    } else {
      Val ld = 0.0f, lf = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        ld = fma_r(exact_val(c.lin_damp[i * 6 + j]), nu[j], ld);
        lf = fma_r(exact_val(c.lin_damp_fwd[i * 6 + j]), nu[j], lf);
      }
      dv = -ld - nu[0] * lf -
           exact_val(c.quad_damp[i]) * (abs_r(nu[i]) * nu[i]);
    }
    rhs[i] = gf[i] - dv;
  }
  // C nu = [-a1 x w ; -a1 x v - a2 x w], [a1; a2] = M nu
  Val a[6];
#pragma unroll (kRows)
  for (int i = 0; i < 6; ++i) {
    Val mr[6];
    mass_row<STRUCT>(s_mass, 0, i, mr);
    Val s = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s = fma_r(mr[j], nu[j], s);
    a[i] = s;
  }
  Val c1[3], c2[3], c3[3];
  cross3(a, w, c1);
  cross3(a, v, c2);
  cross3(a + 3, w, c3);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rhs[i] += c1[i];
    rhs[3 + i] += c2[i] + c3[i];
  }
  // restoring g = -[fbg + fbb ; cog x fbg + cob x fbb], f = R^T (0, 0, f_z);
  // the forces rounded alone (mul_r): with cog x fbg elided, a plain
  // product fbg would have one use left and be fused into fbg + fbb
  const Val fbg[3] = {mul_r(r31, fng), mul_r(r32, fng), mul_r(r33, fng)};
  const Val buoy = exact_val(c.buoyancy);
  const Val fbb[3] = {mul_r(r31, buoy), mul_r(r32, buoy), mul_r(r33, buoy)};
  Val mb[3];  // cog x fbg + cob x fbb; kDiag: cob x fbb (cog = 0)
  cross3(c.cob, fbb, mb);
  if constexpr (STRUCT == kDense) {
    Val mbg[3];
    cross3(c.cog, fbg, mbg);
#pragma unroll
    for (int i = 0; i < 3; ++i) mb[i] = mbg[i] + mb[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rhs[i] += fbg[i] + fbb[i];
    rhs[3 + i] += mb[i];
  }
  // nu_dot = M^-1 rhs
#pragma unroll (kRows)
  for (int i = 0; i < 6; ++i) {
    Val mr[6];
    mass_row<STRUCT>(s_mass, 1, i, mr);
    Val s = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s = fma_r(mr[j], rhs[j], s);
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

template <int COST, int STRUCT>
__device__ __forceinline__ float auv_state_cost(const AuvConsts& c,
                                                const float* s_dyn, int tau,
                                                const float* x) {
  constexpr bool kDiagQ = STRUCT == kDiag;
  if constexpr (COST == kStaticQuat) {
    return quat_state_cost<false, kDiagQ>(c.q, x, s_dyn + kGoal);
  } else if constexpr (COST == kWaypointsQuat) {
    const float* wb = s_dyn + dyn_wblend(tau);
    float out = 0.0f;
#pragma unroll 1
    for (int g = 0; g < 2; ++g) {
      const float* goal = s_dyn + (g == 0 ? kGoal : dyn_goal2(tau));
      out = fmaf(wb[g], quat_state_cost<true, kDiagQ>(c.q, x, goal), out);
    }
    return out;
  } else {
    return elipse3d_cost(c.el, x);
  }
}

// The state cost of lane l of a rollout state: at bf16 on the state
// widened to f32 (the TPU kernel's :433-443), with the goals and blend
// weights rounded at staging.
template <int COST, int STRUCT>
__device__ __forceinline__ float rollout_state_cost(const AuvConsts& c,
                                                   const float* s_dyn,
                                                   int tau, const Val* x,
                                                   int l) {
#ifdef MPPI_BF16
  float xf[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) xf[i] = widen(x[i], l);
  return auv_state_cost<COST, STRUCT>(c, s_dyn, tau, xf);
#else
  return auv_state_cost<COST, STRUCT>(c, s_dyn, tau, x);
#endif
}

#ifdef MPPI_BF16
// How a bf16 kernel stages dyn entry i (the TPU kernel's d_() reads): x0,
// useq and rhs_z as bf16x2 words (the rollout's operands; the mass
// matrices go to their padded rows, mass_row); the goals and the waypoint
// blend rounded, in f32 (the state cost's); the mass, u_half and the
// schedule's c_t as they are.
__device__ __forceinline__ float stage_dyn(float f, int i, int tau) {
  if (i >= kX0 && i < dyn_u_half(tau)) return stage_word(f);
  if ((i >= kGoal && i < kGoal + 13) ||
      (i >= dyn_goal2(tau) && i < dyn_size(tau)))
    return round_bf16(f);
  return f;
}
#else
// The f32 build stages dyn and the mass rows as they are.
__device__ __forceinline__ float stage_dyn(float f, int, int) { return f; }
__device__ __forceinline__ float stage_word(float f) { return f; }
#endif

// The f32 kDiag build asks ptxas for two blocks of 256 threads an SM at
// rk 1 and 2 (at most 128 registers a thread); kDense (whose rk2 costs
// mode spills at 128), rk4 and the pair build ask for one.
#ifdef MPPI_BF16_PAIRS
#define AUV_LAUNCH_BOUNDS __launch_bounds__(kThreads)
#else
#define AUV_LAUNCH_BOUNDS \
  __launch_bounds__(kThreads, STRUCT == kDiag && RK <= 2 ? 2 : 1)
#endif

template <int RK, int MODE, int COST, int STRUCT>
__global__ void AUV_LAUNCH_BOUNDS
    MPPI_KERNEL(auv_fused_solve)(const AuvConsts c,
                                 const float* __restrict__ dyn, int n_dyn,
                                 int sched_off, const float* __restrict__ z,
                                 float* __restrict__ costs,
                                 float* __restrict__ partials, int k_total,
                                 int tau, Seeds sd) {
  static_assert(STRUCT == kDense || kLanes == 1, "kDiag is an f32 build");
  extern __shared__ __align__(16) float smem[];
  float* s_dyn = smem;  // n_dyn = dyn_size(tau) (+ tau scheduled)
  float* s_mass = smem + ((n_dyn + 3) & ~3);  // kMassWords, 16-byte aligned
  float* s_red = s_mass + kMassWords;          // kWarps * n_z
  for (int i = threadIdx.x; i < n_dyn; i += kThreads)
    s_dyn[i] = stage_dyn(dyn[i], i, tau);
  for (int w = threadIdx.x; w < kMassWords; w += kThreads) {
    const int col = w & 7, row = w >> 3;  // rows 0-5: M, 6-11: M^-1
    s_mass[w] = col < 6 ? stage_word(dyn[kMTot + row * 6 + col]) : 0.0f;
  }
  __syncthreads();

  const float* useq = s_dyn + kUseq;
  const float* rhs_z = useq + 6 * tau;
  const float u_half = s_dyn[dyn_u_half(tau)];
  const Val fng = to_val(-s_dyn[kMass] * kGravity);
  // the rk factors dt, dt / 2 and dt / 6, formed in f32
  const Val dt = to_val(c.dt), h = to_val(0.5f * c.dt),
            h6 = to_val(c.dt / 6.0f);

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

  Val x[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = exact_val(s_dyn[kX0 + i]);
  constexpr int kRows = kLanes == 2 && RK == 4 ? 1 : 6;
  int n = 0;
  for (int t = 0; t < tau; ++t) {
    const float ct = sched_factor(s_dyn, sched_off, t);
    Val zt[6], gf[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) zt[j] = draw(ns, n++);
    // gen_force = u_t + scale (c_t z_t); at bf16 u_t + c_t (scale z_t),
    // the TPU kernel's order (:447-463)
#ifdef MPPI_BF16
    const Val ct_v = to_val(ct);
#endif
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#ifdef MPPI_BF16
      Val sz = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        sz = fma_r(exact_val(c.scale[i * 6 + j]), zt[j], sz);
      gf[i] = exact_val(useq[t * 6 + i]) + ct_v * sz;
#else
      float s = useq[t * 6 + i];
      if constexpr (STRUCT == kDiag) {  // the dense chain's one nonzero FMA
        s = fmaf(c.scale[i * 7], ct * zt[i], s);
      } else {
#pragma unroll
        for (int j = 0; j < 6; ++j)
          s = fmaf(c.scale[i * 6 + j], ct * zt[j], s);
      }
      gf[i] = s;
#endif
    }

    Val k1[13], xs[13];
    state_dot<STRUCT, kRows>(c, s_mass, fng, x, gf, k1);
    if (RK == 1) {
#pragma unroll
      for (int i = 0; i < 13; ++i) x[i] = fma_r(dt, k1[i], x[i]);
    } else if (RK == 2) {
      Val k2[13];
#pragma unroll
      for (int i = 0; i < 13; ++i) xs[i] = fma_r(dt, k1[i], x[i]);
      state_dot<STRUCT, kRows>(c, s_mass, fng, xs, gf, k2);
#pragma unroll
      for (int i = 0; i < 13; ++i) x[i] = fma_r(h, k1[i] + k2[i], x[i]);
    } else {
      // acc = k1 + 2 k2 + 2 k3 + k4, x += dt/6 acc (models/auv.py:316-320)
      Val acc[13], kk[13];
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        acc[i] = k1[i];
        xs[i] = fma_r(h, k1[i], x[i]);
      }
      state_dot<STRUCT, kRows>(c, s_mass, fng, xs, gf, kk);
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        acc[i] = fma_r(2.0f, kk[i], acc[i]);
        xs[i] = fma_r(h, kk[i], x[i]);
      }
      state_dot<STRUCT, kRows>(c, s_mass, fng, xs, gf, kk);
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        acc[i] = fma_r(2.0f, kk[i], acc[i]);
        xs[i] = fma_r(dt, kk[i], x[i]);
      }
      state_dot<STRUCT, kRows>(c, s_mass, fng, xs, gf, kk);
#pragma unroll
      for (int i = 0; i < 13; ++i) x[i] = fma_r(h6, acc[i] + kk[i], x[i]);
    }
    // quaternion renormalisation (the rsqrt in f32, per lane)
    const Val s2 = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6];
    const Val inv =
        per_lane(s2, [](float v) { return rsqrtf(fmaxf(v, 1e-24f)); });
#pragma unroll
    for (int i = 3; i < 7; ++i) x[i] *= inv;

#pragma unroll
    for (int l = 0; l < kLanes; ++l)
      cost[l] += rollout_state_cost<COST, STRUCT>(c, s_dyn, tau, x, l);
#ifdef MPPI_BF16
    Val quad = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const Val rz = exact_val(rhs_z[t * 6 + j]) * zt[j];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) cost[l] += widen(rz, l);
      Val mz = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        mz = fma_r(exact_val(c.mz[j * 6 + i]), zt[i], mz);
      quad = fma_r(zt[j], mz, quad);
    }
    const Val nq = to_val(c.nc_half * ct) * quad;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) cost[l] += widen(nq, l);
#else
#pragma unroll
    for (int j = 0; j < 6; ++j)
      cost[0] = fmaf(rhs_z[t * 6 + j], zt[j], cost[0]);
    // nc_half c_t z^T Mz z: adds +-0 at nc_half = 0, a uniform branch
    if (c.nc_half != 0.0f) {
      float quad = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        float mz = 0.0f;
        if constexpr (STRUCT == kDiag) {
          mz = mul_r(c.mz[j * 7], zt[j]);
        } else {
#pragma unroll
          for (int i = 0; i < 6; ++i) mz = fmaf(c.mz[j * 6 + i], zt[i], mz);
        }
        quad = fmaf(zt[j], mz, quad);
      }
      cost[0] = fmaf(c.nc_half * ct, quad, cost[0]);
    }
#endif
  }

  float zarg[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    cost[l] += rollout_state_cost<COST, STRUCT>(c, s_dyn, tau, x, l);
    cost[l] += u_half;
    zarg[l] = MODE == kFused ? -cost[l] / c.lam : -INFINITY;
    if (MODE == kCosts && valid[l]) costs[k[l]] = cost[l];
  }
  if (MODE == kFused)
    write_partial_row_lanes<true, kLanes>(
        zarg, cost, valid, ns, tau * 6, s_red,
        partials + static_cast<size_t>(blockIdx.x) * (kStats + tau * 6));
  else
    write_partial_row_lanes<false, kLanes>(
        zarg, cost, valid, ns, 0, s_red,
        partials + static_cast<size_t>(blockIdx.x) * kStats);
}

// The launch of one solve: k samples over horizon tau; scheduled (0 / 1)
// appends the tau factors c_t to dyn. With occupancy set nothing launches:
// the kernel's blocks an SM at this shared memory are written there.
struct AuvLaunch {
  const float* dyn;
  const float* z;
  float* costs;
  float* partials;
  int k, tau, scheduled;
  Seeds sd;
  cudaStream_t stream;
  int* occupancy;
};

template <int RK, int MODE, int COST, int STRUCT>
int launch_auv(const AuvConsts& c, const AuvLaunch& a) {
  const int n_dyn = dyn_size(a.tau) + (a.scheduled ? a.tau : 0);
  const int sched_off = a.scheduled ? dyn_size(a.tau) : -1;
  size_t smem = 0;
  const cudaError_t e =
      smem_for(MPPI_KERNEL(auv_fused_solve)<RK, MODE, COST, STRUCT>,
               ((n_dyn + 3) & ~3) + kMassWords,
               MODE == kFused ? a.tau * 6 : 0, &smem);
  if (e != cudaSuccess) return e;
  if (a.occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.occupancy, MPPI_KERNEL(auv_fused_solve)<RK, MODE, COST, STRUCT>,
        kThreads, smem);
  const int nb = (a.k + kBlock - 1) / kBlock;
  MPPI_KERNEL(auv_fused_solve)<RK, MODE, COST, STRUCT>
      <<<nb, kThreads, smem, a.stream>>>(c, a.dyn, n_dyn, sched_off, a.z,
                                         a.costs, a.partials, a.k, a.tau,
                                         a.sd);
  return cudaGetLastError();
}

template <int MODE, int COST, int STRUCT>
int dispatch_rk(int rk, const AuvConsts& c, const AuvLaunch& a) {
  if (rk == 1) return launch_auv<1, MODE, COST, STRUCT>(c, a);
  if (rk == 2) return launch_auv<2, MODE, COST, STRUCT>(c, a);
  if (rk == 4) return launch_auv<4, MODE, COST, STRUCT>(c, a);
  return cudaErrorInvalidValue;
}

// kDiag exists in the f32 build alone.
template <int MODE, int COST>
int dispatch_struct(int rk, int st, const AuvConsts& c, const AuvLaunch& a) {
  if (st == kDense) return dispatch_rk<MODE, COST, kDense>(rk, c, a);
#ifndef MPPI_BF16
  if (st == kDiag) return dispatch_rk<MODE, COST, kDiag>(rk, c, a);
#endif
  return cudaErrorInvalidValue;
}

template <int MODE>
int dispatch_auv(int rk, int cost, int st, const float* consts,
                 const AuvLaunch& a) {
  if (a.k <= 0 || a.tau <= 0) return cudaErrorInvalidValue;
  HostConsts f;
  memcpy(&f, consts, sizeof(f));
#ifdef MPPI_BF16_PAIRS
  const AuvConsts c = pair_consts(f);
#else
  const AuvConsts& c = f;
#endif
  if (cost == kStaticQuat)
    return dispatch_struct<MODE, kStaticQuat>(rk, st, c, a);
  if (cost == kWaypointsQuat)
    return dispatch_struct<MODE, kWaypointsQuat>(rk, st, c, a);
  if (cost == kElipse3D) return dispatch_struct<MODE, kElipse3D>(rk, st, c, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// consts: AuvConsts.packed (260 floats); cost: AuvCost; structure:
// AuvStruct (kDense alone in the bf16 build); dyn: dyn_size(tau) floats,
// then tau factors c_t when scheduled; half: the antithetic solve's first
// mirrored sample, 0 for none; solve: the solve index on the device, or
// null for (s_lo, s_hi) (mppi_common.cuh). auv_mppi_bf16.cu defines
// both solves with a _bf16 suffix.
int MPPI_ENTRY(auv_fused_solve)(int rk, int cost, int structure,
                                const float* consts, const float* dyn,
                                const float* z, float* partials, int k,
                                int tau, int scheduled, uint32_t half,
                                uint32_t seed_lo, uint32_t seed_hi,
                                uint32_t s_lo, uint32_t s_hi,
                                const unsigned long long* solve,
                                void* stream) {
  return dispatch_auv<kFused>(
      rk, cost, structure, consts,
      AuvLaunch{dyn, z, nullptr, partials, k, tau, scheduled,
                Seeds{seed_lo, seed_hi, s_lo, s_hi, half, solve},
                static_cast<cudaStream_t>(stream), nullptr});
}

int MPPI_ENTRY(auv_fused_costs)(int rk, int cost, int structure,
                                const float* consts, const float* dyn,
                                const float* z, float* costs,
                                float* partials, int k, int tau,
                                int scheduled, uint32_t half,
                                uint32_t seed_lo, uint32_t seed_hi,
                                uint32_t s_lo, uint32_t s_hi,
                                const unsigned long long* solve,
                                void* stream) {
  return dispatch_auv<kCosts>(
      rk, cost, structure, consts,
      AuvLaunch{dyn, z, costs, partials, k, tau, scheduled,
                Seeds{seed_lo, seed_hi, s_lo, s_hi, half, solve},
                static_cast<cudaStream_t>(stream), nullptr});
}

// out[0]: blocks an SM of the solve (mode 0) or costs (1) kernel of
// (rk, cost, structure) at horizon tau, unscheduled; out[1]: samples a
// thread.
int MPPI_ENTRY(auv_occupancy)(int rk, int cost, int structure, int mode,
                              int tau, int* out) {
  static const float zeros[sizeof(HostConsts) / sizeof(float)] = {};
  const AuvLaunch a{nullptr, nullptr, nullptr, nullptr, 1, tau, 0, Seeds{},
                    nullptr, out};
  out[1] = kLanes;
  return mode ? dispatch_auv<kCosts>(rk, cost, structure, zeros, a)
              : dispatch_auv<kFused>(rk, cost, structure, zeros, a);
}

#ifndef MPPI_BF16
// The dyn length the kernels stage for horizon tau: the wrappers hold
// kernels/auv_mppi.py Dyn(tau).size against it before a launch.
int auv_dyn_size(int tau) { return dyn_size(tau); }
#endif

}  // extern "C"
