// The on-device plants' steps: one launch steps every vehicle through all
// the substeps of a control period, the action held (zero-order hold).
//
// They replace no TPU kernel: the JAX package's plants
// (mppi_tf_tpu/envs/mjx_env.py JaxPointMassEnv.step_fn,
// mppi_tf_tpu/envs/analytic.py AUVEnv.step_fn) are plain jnp code that
// XLA fuses into the loop's program. In PyTorch the same step is a few
// hundred small kernels a period (kernels/plant.py's plain versions), so
// these were added to make the plant of the on-device loop
// (envs/mjx_env.py) one node of its period's graph.
//
// What bounds them: one launch and the dependent chain of the integration.
// A period steps one vehicle (or a fleet's few) through 5-10 substeps of a
// 13-state (or 2n-state) ODE; there are a few hundred flops a state
// derivative and a few hundred bytes in all, so neither the card's rate
// nor its bandwidth is near. The design keeps the chain short and on chip:
// - auv_plant_kernel<T, RK>: one vehicle a thread, its 13-state, the stage
//   state and the RK sum in registers (every loop over the state unrolled),
//   the model's constants staged once a block in shared memory (188 values
//   a launch, read by all the block's vehicles; SharedConsts), the
//   substeps a loop in the thread. The state derivative is
//   AUVModel.state_dot's algebra (models/auv.py): the rotation and the
//   attitude Jacobian, D nu and C nu in their matrix-free forms, the
//   restoring forces with the weight and the buoyancy kept apart as the
//   model keeps them, rhs @ M^-1^T; the standard RK weights of
//   AUVModel.step; after each substep the quaternion renormalised as
//   quat.normalize does, q / max(|q|, 1e-12) with an IEEE sqrt and divide.
//   The sums run in the kernel's order (FMA chains, row by row), not
//   cuBLAS's: at f32 it is within a few ulps of the torch step, not bit
//   for bit.
// - pm_plant_kernel<T>: one (vehicle, axis) pair a thread, the exact
//   update of the frictionless point mass in the JAX step's order,
//   q + v dt + ((0.5 a) dt) dt, then v + a dt, every product and sum
//   rounded alone (__fmul_rn / __fadd_rn: no FMA contraction), with
//   a = u * (1 / m) as PyTorch's CUDA division by a Python scalar computes
//   it (the reciprocal rounded on the host, kernels/plant.py), so that it
//   is the torch step on the card bit for bit.
// Neither uses fast math: division and sqrt stay IEEE; the library's flags
// (kernels/_build.py) hold no --use_fast_math.

#include <cuda_runtime.h>

namespace {

// The layout of the AUV's constants (kernels/plant.py AUV_CONSTS): the
// total mass matrix and its inverse, the linear, forward-speed and
// quadratic damping matrices (row-major 6x6), cog, cob, the weight
// -m g and the buoyancy rho V g.
constexpr int kMTot = 0, kInvM = 36, kLin = 72, kLinFwd = 108, kQuad = 144,
              kCog = 180, kCob = 183, kWeight = 186, kBuoy = 187,
              kAuvConsts = 188;
constexpr int kAuvThreads = 32;
constexpr int kPmThreads = 128;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
// IEEE square roots (the library builds with -prec-sqrt=true, nvcc's
// default)
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }

// a x b
template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// How a state derivative reads the constants in shared memory. At f32 the
// compiler keeps them in registers across the substeps (243-255 registers
// a thread and no spill on the H100; the mission's period took 5.4 device
// us against 8.4 read at each use). At f64 they do not fit beside the
// stages and spilled, so they are read at each use, through a volatile
// pointer.
template <typename T>
struct SharedConsts {
  using ptr = const T*;
};
template <>
struct SharedConsts<double> {
  using ptr = const volatile double*;
};

// f = x_dot(x, u) of AUVModel.state_dot, with the constants c in shared
// memory.
template <typename T>
__device__ __forceinline__ void auv_state_dot(typename SharedConsts<T>::ptr c,
                                              const T (&x)[13],
                                              const T (&u)[6], T (&f)[13]) {
  const T qx = x[3], qy = x[4], qz = x[5], qw = x[6];
  const T one = T(1), two = T(2), half = T(0.5);
  // body-to-inertial rotation (ops/quaternion.py to_rotation_matrix)
  const T r[9] = {one - two * (qy * qy + qz * qz),
                  two * (qx * qy - qz * qw),
                  two * (qx * qz + qy * qw),
                  two * (qx * qy + qz * qw),
                  one - two * (qx * qx + qz * qz),
                  two * (qy * qz - qx * qw),
                  two * (qx * qz - qy * qw),
                  two * (qy * qz + qx * qw),
                  one - two * (qx * qx + qy * qy)};
  T vel[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) vel[i] = x[7 + i];
  // position rate R v; quaternion rate T(q) w (attitude_jacobian)
#pragma unroll
  for (int i = 0; i < 3; ++i)
    f[i] = r[3 * i] * vel[0] + r[3 * i + 1] * vel[1] + r[3 * i + 2] * vel[2];
  const T tq[12] = {qw, -qz, qy, qz, qw, -qx, -qy, qx, qw, -qx, -qy, -qz};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[3 + i] = (half * tq[3 * i]) * vel[3] + (half * tq[3 * i + 1]) * vel[4]
               + (half * tq[3 * i + 2]) * vel[5];
  // D nu = -L nu - u (L_fwd nu) - Q_d (|nu| . nu)
  T absv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) absv[j] = abs_t(vel[j]) * vel[j];
  T dv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T lin = T(0), fwd = T(0), quad = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      lin += c[kLin + 6 * i + j] * vel[j];
      fwd += c[kLinFwd + 6 * i + j] * vel[j];
      quad += c[kQuad + 6 * i + j] * absv[j];
    }
    dv[i] = -lin - vel[0] * fwd - quad;
  }
  // C nu = [-a1 x w ; -a1 x v - a2 x w], [a1; a2] = M nu
  T a[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) s += c[kMTot + 6 * i + j] * vel[j];
    a[i] = s;
  }
  T c1[3], c2[3], c3[3];
  cross3(a, vel + 3, c1);
  cross3(a, vel, c2);
  cross3(a + 3, vel + 3, c3);
  // restoring forces: -[fbg + fbb ; cog x fbg + cob x fbb], the world z
  // axis in the body frame being R's last row
  const T wgt = c[kWeight], buoy = c[kBuoy];
  T fbg[3], fbb[3], mbg[3], mbb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    fbg[i] = wgt * r[6 + i];
    fbb[i] = buoy * r[6 + i];
  }
  const T cog[3] = {c[kCog], c[kCog + 1], c[kCog + 2]};
  const T cob[3] = {c[kCob], c[kCob + 1], c[kCob + 2]};
  cross3(cog, fbg, mbg);
  cross3(cob, fbb, mbb);
  // rhs = ((tau - C nu) - D nu) - g, in the model's order
  T rhs[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rhs[i] = ((u[i] + c1[i]) - dv[i]) + (fbg[i] + fbb[i]);
    rhs[3 + i] = ((u[3 + i] + (c2[i] + c3[i])) - dv[3 + i])
                 + (mbg[i] + mbb[i]);
  }
  // nu_dot = rhs @ M^-1^T
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) s += c[kInvM + 6 * i + j] * rhs[j];
    f[7 + i] = s;
  }
}

// n vehicles' [n, 13] states through `substeps` RK steps of dt under their
// held [n, 6] forces (AUVModel.step, rk = RK), into out.
template <typename T, int RK>
__global__ void __launch_bounds__(kAuvThreads)
    auv_plant_kernel(const T* __restrict__ xs, const T* __restrict__ us,
                     T* __restrict__ out, const T* __restrict__ consts,
                     int n, int substeps, T dt, T h2, T h6) {
  __shared__ T c[kAuvConsts];
  for (int i = threadIdx.x; i < kAuvConsts; i += blockDim.x)
    c[i] = consts[i];
  __syncthreads();
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  T x[13], u[6];
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = xs[13 * v + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) u[i] = us[6 * v + i];
#pragma unroll 1
  for (int s = 0; s < substeps; ++s) {
    T k[13], xk[13], sum[13];
    auv_state_dot(c, x, u, k);
    if (RK == 1) {
#pragma unroll
      for (int i = 0; i < 13; ++i) x[i] = x[i] + dt * k[i];
    } else if (RK == 2) {
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        sum[i] = k[i];
        xk[i] = x[i] + dt * k[i];
      }
      auv_state_dot(c, xk, u, k);
#pragma unroll
      for (int i = 0; i < 13; ++i) x[i] = x[i] + h2 * (sum[i] + k[i]);
    } else {
      // (dt / 6) (k1 + 2 k2 + 2 k3 + k4), summed left to right
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        sum[i] = k[i];
        xk[i] = x[i] + h2 * k[i];
      }
      auv_state_dot(c, xk, u, k);
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        sum[i] = sum[i] + T(2) * k[i];
        xk[i] = x[i] + h2 * k[i];
      }
      auv_state_dot(c, xk, u, k);
#pragma unroll
      for (int i = 0; i < 13; ++i) {
        sum[i] = sum[i] + T(2) * k[i];
        xk[i] = x[i] + dt * k[i];
      }
      auv_state_dot(c, xk, u, k);
#pragma unroll
      for (int i = 0; i < 13; ++i) x[i] = x[i] + h6 * (sum[i] + k[i]);
    }
    // quat.normalize: q / max(|q|, 1e-12)
    T nq = sqrt_t(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
    if (nq < T(1e-12)) nq = T(1e-12);   // a NaN stays, as torch.clamp
#pragma unroll
    for (int i = 3; i < 7; ++i) x[i] = x[i] / nq;
  }
#pragma unroll
  for (int i = 0; i < 13; ++i) out[13 * v + i] = x[i];
}

// n vehicles' interleaved [n, 2 n_dof] states through `substeps` exact
// steps of dt under their held forces (row stride u_stride), into out.
template <typename T>
__global__ void __launch_bounds__(kPmThreads)
    pm_plant_kernel(const T* __restrict__ xs, const T* __restrict__ us,
                    T* __restrict__ out, int n, int n_dof, int u_stride,
                    int substeps, T inv_m, T dt) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * n_dof) return;
  const int v = t / n_dof, d = t - v * n_dof;
  const int iq = 2 * t;   // q of axis d of vehicle v; its v follows
  T q = xs[iq], vel = xs[iq + 1];
  const T a = mul_rn(us[static_cast<long long>(v) * u_stride + d], inv_m);
  // the same in every substep, as the torch step computes it each time
  const T drift = mul_rn(mul_rn(mul_rn(T(0.5), a), dt), dt);
  const T kick = mul_rn(a, dt);
#pragma unroll 1
  for (int s = 0; s < substeps; ++s) {
    q = add_rn(add_rn(q, mul_rn(vel, dt)), drift);
    vel = add_rn(vel, kick);
  }
  out[iq] = q;
  out[iq + 1] = vel;
}

template <typename T>
cudaError_t launch_auv(const void* x, const void* u, void* out,
                       const void* consts, int n, int rk, int substeps,
                       double dt, double h2, double h6, cudaStream_t st) {
  const int blocks = (n + kAuvThreads - 1) / kAuvThreads;
  const T* xs = static_cast<const T*>(x);
  const T* us = static_cast<const T*>(u);
  const T* cs = static_cast<const T*>(consts);
  T* o = static_cast<T*>(out);
  const T tdt = static_cast<T>(dt), th2 = static_cast<T>(h2),
          th6 = static_cast<T>(h6);
  if (rk == 1)
    auv_plant_kernel<T, 1><<<blocks, kAuvThreads, 0, st>>>(
        xs, us, o, cs, n, substeps, tdt, th2, th6);
  else if (rk == 2)
    auv_plant_kernel<T, 2><<<blocks, kAuvThreads, 0, st>>>(
        xs, us, o, cs, n, substeps, tdt, th2, th6);
  else
    auv_plant_kernel<T, 4><<<blocks, kAuvThreads, 0, st>>>(
        xs, us, o, cs, n, substeps, tdt, th2, th6);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pm(const void* x, const void* u, void* out, int n,
                      int n_dof, int u_stride, int substeps, double inv_m,
                      double dt, cudaStream_t st) {
  const int blocks = (n * n_dof + kPmThreads - 1) / kPmThreads;
  pm_plant_kernel<T><<<blocks, kPmThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(u),
      static_cast<T*>(out), n, n_dof, u_stride, substeps,
      static_cast<T>(inv_m), static_cast<T>(dt));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both take the vehicles n, the substeps, the scalars as doubles (each
// rounded once to the kernel's type, as PyTorch rounds a Python scalar)
// and f64 (0: float, 1: double) before the stream, and return the
// launch's error code. x, out: [n, 13]; u: [n, 6]; consts: AUV_CONSTS's
// 188 values in the kernel's type; h2, h6: dt / 2 and dt / 6.
int auv_plant(const void* x, const void* u, void* out, const void* consts,
              int n, int rk, int substeps, double dt, double h2, double h6,
              int f64, void* stream) {
  if (n <= 0 || substeps < 1 || (rk != 1 && rk != 2 && rk != 4))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? launch_auv<double>(x, u, out, consts, n, rk, substeps, dt,
                                  h2, h6, st)
             : launch_auv<float>(x, u, out, consts, n, rk, substeps, dt, h2,
                                 h6, st);
}

// x, out: [n, 2 n_dof] interleaved; u: [n, >= n_dof], rows u_stride apart;
// inv_m: 1 / m as PyTorch's CUDA division by a scalar rounds it.
int pm_plant(const void* x, const void* u, void* out, int n, int n_dof,
             int u_stride, int substeps, double inv_m, double dt, int f64,
             void* stream) {
  if (n <= 0 || n_dof <= 0 || u_stride < n_dof || substeps < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f64 ? launch_pm<double>(x, u, out, n, n_dof, u_stride, substeps,
                                 inv_m, dt, st)
             : launch_pm<float>(x, u, out, n, n_dof, u_stride, substeps,
                                inv_m, dt, st);
}

}  // extern "C"
