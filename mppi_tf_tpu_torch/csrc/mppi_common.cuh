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
// Antithetic noise (the XLA layout of ops/noise.py, not the TPU kernel's
// in-tile lane pairs): with half = ceil(K/2) > 0, sample k >= half reads
// the counters of sample k - half and negates every normal, so
// z[half + i] = -z[i] for i < K - half (for odd K sample half - 1 has no
// mirror). half = 0 turns it off. Injected z is data and is never mirrored.
//
// Noise schedule: the per-step factors c_t ride at the end of each solve's
// dyn array (sched_off >= 0, else c_t = 1); the kernels scale the noise
// drive and the z-quadratic by c_t so that c_t = 1 is the unscheduled
// arithmetic bit for bit (1 * v == v).
//
// Partial row of one block (kStats + n_z floats), merged by pm_merge:
//   (m_b, l_b, cost min, cost max, cost sum, 0, 0, 0, zsum_b[n_z])
// with w_k = exp(zarg_k - m_b), l_b = sum_k w_k, zsum_b = sum_k w_k z_k.
//
// Block compute type. Each kernel source is compiled twice: as itself
// (Val = float, the f32 kernels) and through its *_bf16.cu wrapper, which
// defines MPPI_BF16, MPPI_BF16_PAIRS and MPPI_SUFFIX before including it
// (the bf16 block compute of the TPU kernels' compute_dtype="bfloat16":
// every rollout op rounds to bf16, the cost accumulator, softmax, stats
// and Box-Muller stay f32). MPPI_KERNEL / MPPI_ENTRY name a source's
// kernels and C entry points with the suffix (pm_fused_solve_bf16_kernel,
// pm_fused_solve_bf16), so the f32 kernels keep their names and code.
// Every normal a bf16 kernel consumes, injected or Philox, is the f32
// normal rounded to bf16 (NoiseStream::next), in every phase.
//
// Two samples a thread (MPPI_BF16_PAIRS): Val = bf16x2, one bf16 value of
// each of two samples in one 32-bit register, every rollout op one native
// Hopper add.rn / sub.rn / mul.rn.bf16x2 for both. Each rounds its exact
// result once to bf16: the value of the f32 op rounded to bf16 (a product
// of two bf16 values is exact in f32; a sum rounded to f32 and then to
// bf16 is innocuous double rounding, 24 >= 2 * 8 + 2), which is what
// PyTorch's bf16 ops and the plain versions compute, without a conversion
// a op. Never fused: fma.rn.bf16x2 rounds once and gives other bits (and
// mul without .rn may be contracted into one). A block of kBlock / 2 = 128
// threads holds one partial row of kBlock samples: thread t of block b
// has lane 0 = sample b * kBlock + t and lane 1 = sample b * kBlock + 128
// + t, each lane with its own NoiseStream and f32 cost; the epilogue sums
// a thread's two lanes before the warp (write_partial_row_lanes), so the
// rows hold the f32 layout's samples in another order of summation.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef MPPI_SUFFIX
#define MPPI_SUFFIX
#endif
#define MPPI_CAT2(a, b) a##b
#define MPPI_CAT(a, b) MPPI_CAT2(a, b)
#define MPPI_ENTRY(base) MPPI_CAT(base, MPPI_SUFFIX)
#define MPPI_KERNEL(base) MPPI_CAT(MPPI_ENTRY(base), _kernel)

// The bf16 builds alone hold bf16 code (#if on MPPI_BF16, and
// MPPI_NN_BF16_PRODUCTS for nn_mppi_bfp.cu): the f32 translation units
// neither include cuda_bf16.h nor see round_bf16, bf16x2 or a bf16 branch.
#if defined(MPPI_BF16) || defined(MPPI_NN_BF16_PRODUCTS)
#include <cuda_bf16.h>
#endif
#ifdef MPPI_BF16_PAIRS
#include <string.h>
#endif

namespace mppi {

// The generic forms the kernels write their chains in: at f32 the FMA and
// intrinsics they always used, at bf16 the rounded ops below.
__device__ __forceinline__ float fma_r(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ float abs_r(float a) { return fabsf(a); }
// a product rounded alone: never contracted into an FMA
__device__ __forceinline__ float mul_r(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float relu_r(float a) { return fmaxf(a, 0.0f); }

#if defined(MPPI_BF16) || defined(MPPI_NN_BF16_PRODUCTS)
// f rounded to the nearest bf16 (ties to even), held in f32.
__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}
#endif

#ifdef MPPI_BF16_PAIRS
// The bf16 bits nearest f (ties to even; NaN stays NaN): integer ops, so a
// literal folds to its bit pattern at compile time. The host uses it to
// pack the solve constants.
__host__ __device__ __forceinline__ uint32_t bf16_bits_rn(float f) {
  uint32_t u;
#ifdef __CUDA_ARCH__
  u = __float_as_uint(f);
#else
  memcpy(&u, &f, sizeof(u));
#endif
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// One bf16 value of each of two samples: lane 0 in the low half, lane 1 in
// the high half. A float converts to (f, f) rounded: meant for literals
// (0.5f, 1.0f, 2.0f fold to constants); a value known only at run time
// goes through pack2() (to_val), one cvt.
struct bf16x2 {
  uint32_t v;
  bf16x2() = default;
  __host__ __device__ __forceinline__ bf16x2(float f)
      : v(bf16_bits_rn(f) * 0x00010001u) {}
  static __host__ __device__ __forceinline__ bf16x2 bits(uint32_t w) {
    bf16x2 r;
    r.v = w;
    return r;
  }
};
#define MPPI_BF16X2_OP(op, ptx)                                            \
  __device__ __forceinline__ bf16x2 operator op(bf16x2 a, bf16x2 b) {     \
    bf16x2 r;                                                             \
    asm(ptx " %0, %1, %2;" : "=r"(r.v) : "r"(a.v), "r"(b.v));             \
    return r;                                                             \
  }
MPPI_BF16X2_OP(+, "add.rn.bf16x2")
MPPI_BF16X2_OP(-, "sub.rn.bf16x2")
MPPI_BF16X2_OP(*, "mul.rn.bf16x2")
#undef MPPI_BF16X2_OP
__device__ __forceinline__ bf16x2 operator-(bf16x2 a) {
  return bf16x2::bits(a.v ^ 0x80008000u);
}
__device__ __forceinline__ bf16x2& operator+=(bf16x2& a, bf16x2 b) {
  return a = a + b;
}
__device__ __forceinline__ bf16x2& operator*=(bf16x2& a, bf16x2 b) {
  return a = a * b;
}
__device__ __forceinline__ bf16x2 fma_r(bf16x2 a, bf16x2 b, bf16x2 c) {
  return c + a * b;
}
__device__ __forceinline__ bf16x2 mul_r(bf16x2 a, bf16x2 b) { return a * b; }
__device__ __forceinline__ bf16x2 abs_r(bf16x2 a) {
  return bf16x2::bits(a.v & 0x7fff7fffu);
}
// max.bf16x2 against +0, as fmaxf(a, 0.0f) rounded: -0 and NaN give +0
__device__ __forceinline__ bf16x2 relu_r(bf16x2 a) {
  bf16x2 r;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(r.v) : "r"(a.v), "r"(0u));
  return r;
}
// lane l of a pair in f32: a shift, not a conversion
__device__ __forceinline__ float widen(bf16x2 a, int lane) {
  return __uint_as_float(lane ? a.v & 0xffff0000u : a.v << 16);
}
// (lo, hi) rounded to bf16, one cvt for both lanes
__device__ __forceinline__ bf16x2 pack2(float lo, float hi) {
  bf16x2 r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r.v) : "f"(hi), "f"(lo));
  return r;
}
#endif

// A float that already holds a Val (a rounded normal, a staged weight, a
// solve constant the host packed rounded to bf16) as a Val, without
// rounding again: a constant stays an operand of the multiply, not a
// converted value the compiler hoists into a register. In the pair builds
// the float is a staged shared-memory word that holds a bf16x2's bits.
#if defined(MPPI_BF16_PAIRS)
using Val = bf16x2;
constexpr int kLanes = 2;
__device__ __forceinline__ Val exact_val(float f) {
  return bf16x2::bits(__float_as_uint(f));
}
__device__ __forceinline__ Val exact_val(bf16x2 v) { return v; }
// a run-time f32 scalar as a Val (rounded, both lanes)
__device__ __forceinline__ Val to_val(float f) { return pack2(f, f); }
// the staged word of dyn entry f: (f, f) rounded, as a float's bits
__device__ __forceinline__ float stage_word(float f) {
  return __uint_as_float(to_val(f).v);
}
// f applied to each lane of v in f32, rounded back (one cvt)
template <typename F>
__device__ __forceinline__ Val per_lane(Val v, F f) {
  return pack2(f(widen(v, 0)), f(widen(v, 1)));
}
#elif defined(MPPI_BF16)
#error "a bf16 build computes in bf16x2 pairs: define MPPI_BF16_PAIRS"
#else
using Val = float;
constexpr int kLanes = 1;
__device__ __forceinline__ Val exact_val(float f) { return f; }
__device__ __forceinline__ Val to_val(float f) { return f; }
template <typename F>
__device__ __forceinline__ Val per_lane(Val v, F f) {
  return f(v);
}
#endif

constexpr int kBlock = 256;          // samples (threads) per solve block
constexpr int kWarps = kBlock / 32;
constexpr int kThreads = kBlock / kLanes;  // threads of a pair build's block
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

// sign = -1 mirrors the pair: (-r) c == -(r c) bit for bit.
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float sign,
                                           float& za, float& zb) {
  const float r = sign * sqrtf(-2.0f * logf(bits_to_uniform(a)));
  float s, c;
  sincospif(2.0f * bits_to_uniform(b), &s, &c);
  za = r * c;
  zb = r * s;
}

// The solve index (s_lo, s_hi) comes by value, or, where `solve` is not
// null, from device memory: a replayed CUDA graph freezes its kernels'
// arguments, so the loop of envs/mjx_env.py advances a device counter that
// the kernels read (philox_normals, through the read-only path). The bits
// are the same either way. Read where the words are used, not once into
// the struct: ptxas then keeps the by-value words as constant operands,
// and no instantiation gains registers (a copy at kernel start spilled
// the (4, 2) bf16 pair solves).
struct Seeds {
  uint32_t seed_lo, seed_hi, s_lo, s_hi;
  uint32_t half;  // first mirrored sample of an antithetic solve, 0: none
  const unsigned long long* solve;  // the solve index on the device, or null
};

// The Philox sample whose normals sample k reads, and their sign.
__device__ __forceinline__ uint32_t noise_source(uint32_t k, const Seeds& sd,
                                                 float* sign) {
  const bool mirrored = sd.half != 0u && k >= sd.half;
  *sign = mirrored ? -1.0f : 1.0f;
  return mirrored ? k - sd.half : k;
}

// c_t of step t: the schedule block of the staged dyn array, or 1.
__device__ __forceinline__ float sched_factor(const float* s_dyn,
                                              int sched_off, int t) {
  return sched_off >= 0 ? s_dyn[sched_off + t] : 1.0f;
}

__device__ __forceinline__ void philox_normals(uint32_t sample, uint32_t blk,
                                               const Seeds& sd, float sign,
                                               float v[4]) {
  uint32_t s_lo = sd.s_lo, s_hi = sd.s_hi;
  if (sd.solve != nullptr) {
    const unsigned long long s = __ldg(sd.solve);
    s_lo = static_cast<uint32_t>(s);
    s_hi = static_cast<uint32_t>(s >> 32);
  }
  const uint4 w =
      philox4x32_10(make_uint4(sample, blk, s_lo, s_hi), sd.seed_lo,
                    sd.seed_hi);
  box_muller(w.x, w.y, sign, v[0], v[1]);
  box_muller(w.z, w.w, sign, v[2], v[3]);
}

// Sequential reader of one sample's normals n = 0, 1, 2, ...: the Philox
// stream four at a time (of the mirrored sample, negated, in the second
// half of an antithetic solve), or injected z[n][k] when z is given; in
// the bf16 builds each normal, injected or drawn, rounded to bf16.
struct NoiseStream {
  const float* z;
  int k_total;
  uint32_t sample;  // the sample's own column of injected z
  uint32_t source;  // the Philox sample it reads
  bool valid;
  float sign;  // -1 for a mirrored sample
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
    source = noise_source(sample, sd_, &sign);
    reset();
  }
  __device__ __forceinline__ void reset() {
    blk = 0;
    lane = 4;
  }
  // normal n in f32: injected, or the next of the buffered Philox block
  // (drawn when the buffer is empty)
  __device__ __forceinline__ float next_f32(int n) {
    if (z != nullptr) return injected(n);
    if (lane == 4) refill();
    return take();
  }
  // normal n as the kernels read it
  __device__ __forceinline__ float next(int n) {
    return read_normal(next_f32(n));
  }
  __device__ __forceinline__ float injected(int n) const {
    return valid ? z[static_cast<size_t>(n) * k_total + sample] : 0.0f;
  }
  __device__ __forceinline__ void refill() {
    philox_normals(source, blk++, sd, sign, buf);
    lane = 0;
  }
  __device__ __forceinline__ float take() {
    const float v = lane == 0 ? buf[0]
                  : lane == 1 ? buf[1]
                  : lane == 2 ? buf[2]
                              : buf[3];
    ++lane;
    return v;
  }
  // Normals 4 b0 .. 4 b0 + count - 1 (count <= 4 NB) into v[0 .. count - 1],
  // in f32: injected z[n][k], or the Philox blocks b0, b0 + 1, ... that
  // hold them, drawn as independent chains (no buffer, no refill branch).
  template <int NB>
  __device__ __forceinline__ void blocks(int b0, int count, float* v) const {
    if (z != nullptr) {
#pragma unroll
      for (int i = 0; i < 4 * NB; ++i)
        if (i < count) v[i] = injected(4 * b0 + i);
    } else {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (4 * b < count)
          philox_normals(source, static_cast<uint32_t>(b0 + b), sd, sign,
                         v + 4 * b);
    }
  }
  // a normal as the kernels read it: rounded to bf16 in the bf16 builds
  static __device__ __forceinline__ float read_normal(float f) {
#ifdef MPPI_BF16
    return round_bf16(f);
#else
    return f;
#endif
  }
};

// Normal n of each of kL lanes' streams, in f32. The lanes read in step,
// so their Philox blocks run out together: one branch refills them all,
// and their chains interleave in one basic block (with one lane, the
// stream's own next_f32).
template <int kL>
__device__ __forceinline__ void next_lanes_f32(NoiseStream* ns, int n,
                                               float* v) {
  if constexpr (kL == 1) {
    v[0] = ns[0].next_f32(n);
  } else if (ns[0].z != nullptr) {  // injected z: every lane's
#pragma unroll
    for (int l = 0; l < kL; ++l) v[l] = ns[l].injected(n);
  } else {
    if (ns[0].lane == 4) {
#pragma unroll
      for (int l = 0; l < kL; ++l) ns[l].refill();
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) v[l] = ns[l].take();
  }
}

// Normal n of every lane's stream as one Val: at f32 the normal itself,
// in the pair builds both lanes' f32 normals rounded by one cvt.
__device__ __forceinline__ Val draw(NoiseStream* ns, int n) {
#ifdef MPPI_BF16_PAIRS
  float v[2];
  next_lanes_f32<2>(ns, n, v);
  return pack2(v[0], v[1]);
#else
  return exact_val(ns[0].next(n));
#endif
}

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

// warp_sum of each of v[0 .. N - 1] (N a power of two <= 32) at once, a
// transposed butterfly: at offset O each lane keeps the half of its N
// partial sums that its lane bit O selects and adds the partner's copy of
// that half, one SHFL a kept sum, until one is left (then plain warp_sum
// levels). Lane l ends with the sum of v[l / (32 / N)]: N - 1 + 5 - log2 N
// SHFL for N sums, against 5 N. The lanes pair at xor 16, 8, 4, 2, 1 as in
// warp_sum and each level adds the same two partial sums (in either
// order: IEEE addition commutes), so every sum is warp_sum's bits.
template <int N, int O = 16>
__device__ __forceinline__ float warp_sum_each(float* v, int lane) {
  if constexpr (N > 1) {
    constexpr int h = N / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep = up ? v[i + h] : v[i];
      const float send = up ? v[i] : v[i + h];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
  }
  if constexpr (O > 1)
    return warp_sum_each<(N > 1 ? N / 2 : 1), O / 2>(v, lane);
  else
    return v[0];
}

// StaticQuatCost.state_cost of a 13-dim AUV state (auv_mppi.cu,
// nn_mppi.cu): d^T Q d, d = [p - g_p, 2 acos(clamp(q.g_q)), nu - g_nu] with
// the signed dot (costs/static.py) and Q the 10x10 row-major weight; with
// kAbsDot the geodesic |q.g_q| of WayPointsQuatCost (costs/waypoints.py).
// The native acosf: the TPU kernels' polynomial _acos only worked around
// Mosaic. kDiagQ reads Q's diagonal alone (its other entries exactly 0):
// d_i (Q_ii d_i) with the product rounded alone, the dense row's value
// (fma(0, d_j, s) adds +-0).
template <bool kAbsDot = false, bool kDiagQ = false>
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
    if (kDiagQ) {
      qd = mul_r(q[i * 11], d[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 10; ++j) qd = fmaf(q[i * 10 + j], d[j], qd);
    }
    out = fmaf(d[i], qd, out);
  }
  return out;
}

// Block epilogue of every solve kernel: one partial row of kBlock samples
// from kBlock / kL threads of kL lanes each (all threads call it). Each
// lane brings its sample's log-weight zarg and cost; padding samples
// (valid false) weigh exactly 0 and leave the cost stats alone. kMaxShift:
// m_b = the block's max zarg (fused solve, unbounded exponent); else m_b =
// 0 (phase B, exponent in [-1/lam, 0]; phase A, with zarg = -inf and n_z =
// 0, writes the cost stats only). Pass two regenerates z from each lane's
// stream and reduces sum_k w_k z_k per normal with warp shuffles (a
// thread's lanes summed first), then over the block's warps in s_red
// (kWarps * n_z floats). At kL = 1 every sum is the f32 kernels' own.
// kZBlocks > 0 (one lane, the point-mass f32 body): pass two regenerates
// kZBlocks Philox blocks at a time (NoiseStream::blocks, independent
// chains) and reduces their 4 kZBlocks products w_k z_k across the warp
// together (warp_sum_each), each lane writing one sum: the same sums (the
// product rounded alone, as the per-normal loop's is: it multiplies, then
// shuffles, then adds).
template <bool kMaxShift, int kL, int kZBlocks = 0>
__device__ __forceinline__ void write_partial_row_lanes(
    const float* zarg, const float* cost, const bool* valid, NoiseStream* ns,
    int n_z, float* s_red, float* row) {
  constexpr int kThreads = kBlock / kL, kRowWarps = kThreads / 32;
  __shared__ float s_stat[5][kRowWarps];
  __shared__ float s_m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m_b = 0.0f;
  if (kMaxShift) {
    float zm = valid[0] ? zarg[0] : -INFINITY;
#pragma unroll
    for (int l = 1; l < kL; ++l) zm = fmaxf(zm, valid[l] ? zarg[l] : -INFINITY);
    const float wm = warp_max(zm);
    if (lane == 0) s_stat[0][warp] = wm;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = s_stat[0][0];
      for (int w = 1; w < kRowWarps; ++w) m = fmaxf(m, s_stat[0][w]);
      s_m = m;
    }
    __syncthreads();
    m_b = s_m;
  }
  float wgt[kL];
  float ws = 0.0f, c_lo = INFINITY, c_hi = -INFINITY, cs = 0.0f;
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    wgt[l] = valid[l] ? expf(zarg[l] - m_b) : 0.0f;
    const float lo = valid[l] ? cost[l] : INFINITY;
    const float hi = valid[l] ? cost[l] : -INFINITY;
    const float c = valid[l] ? cost[l] : 0.0f;
    ws = l ? ws + wgt[l] : wgt[l];
    c_lo = l ? fminf(c_lo, lo) : lo;
    c_hi = l ? fmaxf(c_hi, hi) : hi;
    cs = l ? cs + c : c;
  }
  const float l_w = warp_sum(ws);
  const float cmin = warp_min(c_lo);
  const float cmax = warp_max(c_hi);
  const float csum = warp_sum(cs);
  if (lane == 0) {
    s_stat[1][warp] = l_w;
    s_stat[2][warp] = cmin;
    s_stat[3][warp] = cmax;
    s_stat[4][warp] = csum;
  }

  if constexpr (kZBlocks == 0) {
#pragma unroll
    for (int l = 0; l < kL; ++l) ns[l].reset();
    for (int n = 0; n < n_z; ++n) {
      float zl[kL];
      next_lanes_f32<kL>(ns, n, zl);
      float wz = wgt[0] * NoiseStream::read_normal(zl[0]);
#pragma unroll
      for (int l = 1; l < kL; ++l)
        wz += wgt[l] * NoiseStream::read_normal(zl[l]);
      const float v = warp_sum(wz);
      if (lane == 0) s_red[warp * n_z + n] = v;
    }
  } else {
    static_assert(kL == 1, "grouped regeneration: one sample a thread");
    constexpr int kN = 4 * kZBlocks, kCopies = 32 / kN;
#pragma unroll 1
    for (int n0 = 0; n0 < n_z; n0 += kN) {
      const int count = min(kN, n_z - n0);
      float v[kN];
      ns[0].template blocks<kZBlocks>(n0 / 4, count, v);
#pragma unroll
      for (int i = 0; i < kN; ++i)
        v[i] = i < count ? mul_r(wgt[0], v[i]) : 0.0f;
      const float s = warp_sum_each<kN>(v, lane);
      const int n = n0 + lane / kCopies;
      if (lane % kCopies == 0 && n < n_z) s_red[warp * n_z + n] = s;
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    float bl = 0.0f, bmin = INFINITY, bmax = -INFINITY, bsum = 0.0f;
    for (int w = 0; w < kRowWarps; ++w) {
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
  for (int n = threadIdx.x; n < n_z; n += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kRowWarps; ++w) s += s_red[w * n_z + n];
    row[kStats + n] = s;
  }
}

// The epilogue of a kernel with one sample a thread (blockDim.x == kBlock).
template <bool kMaxShift>
__device__ __forceinline__ void write_partial_row(float zarg, float cost,
                                                  bool valid,
                                                  NoiseStream& ns, int n_z,
                                                  float* s_red, float* row) {
  write_partial_row_lanes<kMaxShift, 1>(&zarg, &cost, &valid, &ns, n_z,
                                        s_red, row);
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
