"""Fused point-mass MPPI solve on Hopper and the kernels every fused solve
shares: five CUDA kernels and their plain PyTorch versions.

Replaces the Pallas kernels of ``mppi_tf_tpu/kernels/pm_mppi.py``:

- ``pm_fused_solve`` replaces ``fused_pm_call`` (``_make_kernel`` in mode
  "fused" with the in-kernel noise of ``_fill_noise``): one thread per
  sample rolls x' = A x + (1/m)(B u_t + B scale z_t) over the horizon with
  the state in registers, sums the cost
  sum_t [q(x_{t+1}) + rhs_z_t . z_t + nc_half z_t^T Mz z_t] + phi(x_H) + u_half,
  then each block writes its softmax partial (m_b, l_b, cost min/max/sum,
  zsum_b = sum_k w_k z_k) to a scratch row. q is the quadratic around the
  goal in ``dyn`` (the static cost, or the waypoint blend's effective goal
  with its dropped constant added back on the host) or the 2D ellipse cost
  (cost_kind "elipse" of ``_make_kernel``, state [x, vx, y, vy] only);
- ``pm_fused_costs`` replaces ``fused_pm_costs`` (mode "costs", phase A of
  the normalized solve): the same rollout, writing costs[k] and a
  stats-only row per block;
- ``mppi_weights`` replaces ``make_weights_kernel`` (``fused_pm_weights``
  and ``auv_mppi._fused_auv_weights``, phase B, for any action dim): it
  regenerates the normals of the solve and writes rows with
  w = exp(-(c - beta) / ((max - beta) lam)) and m_b = 0, the normals
  split into groups of Philox blocks across the grid's second axis (the
  same rows at any group count);
- ``pm_merge`` merges the per-block rows with the shard-merge algebra of
  ``mppi_tf_tpu/parallel/fused.py`` (m = max m_b, f_b = exp(m_b - m),
  l = sum f_b l_b, zsum = sum f_b zsum_b), in column tiles of 32 and, from
  640 rows on, a thread-block cluster a tile over slices of the rows:
  sums in a fixed order, so two merges of the same rows give the same
  bits, within float rounding of ``merge_plain``;
- ``pm_noise_dump`` replaces ``fused_noise_dump``: it writes the exact
  normals the solves consume, for the statistics check, the log-mode noise
  sample and tests.

The noise is a counter-based stream fixed element by element, so the
plain version reproduces it: normal n = t*adim + j of sample k in solve s
is lane (n mod 4) of Philox4x32-10(counter=(k, n div 4, s_lo, s_hi),
key=(seed_lo, seed_hi)); lanes (0, 1) and (2, 3) each form one Box-Muller
pair, u = ((bits >> 9) + 0.5) * 2^-23, z_a = sqrt(-2 ln u_a) cos(2 pi u_b),
z_b = sqrt(-2 ln u_a) sin(2 pi u_b). (23 bits, not 24: with 24 bits the
top uniforms round to 1.0 in f32; with 23 every u is exact in f32 and lies
in [2^-24, 1 - 2^-24], so the tail is clipped at 5.77 sigma as on the TPU.)
The AUV kernels (``kernels/auv_mppi.py``) read the same stream at adim 6.

Two runtime variants of every kernel that reads the noise (no more
instantiations): **antithetic**, in the XLA layout of ``ops/noise.py``
(half = ceil(K/2); sample k >= half reads the Philox counters of sample
k - half and negates them, so z[half + i] = -z[i]; injected z is data and
is never mirrored); and **scheduled**, the per-step factors c_t at the end
of ``dyn`` (``Dyn.sched``): x' = A x + inv_m (B u_t + c_t B scale z_t), the
z-quadratic nc_half c_t z^T Mz z, u_half packed as sum_t u_half_t / c_t and
wnoise_t = c_t scale zsum_t unfolded on the host, once
(``TwoPhaseSolve.unfold_wnoise``). c_t = 1 is the unscheduled arithmetic
bit for bit.

One compile-time variant of the two solves, **dynamic_ab** (template
argument AB = kDynAB in pm_mppi.cu): A and B scale are read from ``dyn``
(``Dyn.A``, ``Dyn.Bs``) instead of the constants, with inv_mass = 1 and
bu the true B u_t, so that an identified linear model
(``FusedLTIMPPI``) changes them as data.

The f32 solves come in two structures of the constants (``STRUCTURES``,
template argument STRUCT): "integrator" takes A as the per-DoF double
integrator of ``PointMassModel`` (a unit diagonal and A[2d, 2d+1] its
only other nonzeros), B scale's nonzeros at [2d, d] and [2d+1, d], and Q
and Mz diagonal, and emits no instruction for the rest (the TPU kernel's
``sparse_dot`` elision, with the values still runtime data); "dense" runs
every matrix dense. ``PmConsts.structure`` picks "integrator" exactly:
where every entry it leaves out is 0.0 and every one it takes as 1 is 1.0
in the packed f32 constants, at f32 and without dynamic_ab. Both give the
same per-sample costs bit for bit.

The bf16 block compute (``compute_dtype="bfloat16"``, the JAX kernels'
``compute_dtype``): the ``*_bf16`` kernels, pm_mppi.cu compiled at the
block type bf16 (``csrc/pm_mppi_bf16.cu``: two samples a thread in native
bf16x2 arithmetic, the same partial rows of ``BLOCK`` samples). The
state, x0, goal and every rollout and cost op round to bf16 (round to
nearest even) after each op, in the JAX kernel's order: x' = ax + inv_m (bu + bz), or with a schedule
ax + (r(inv_m bu) + r(inv_m c_t) bz) with the scalar products formed in f32
and rounded once; each step's state cost, rhs_z . z and nc_half z^T Mz z
is a bf16 value added to the f32 cost. The softmax, the partial rows,
``pm_merge``, the stats, u_half and Box-Muller stay f32. Every normal a
bf16 kernel consumes, injected or drawn, and every normal its noise dump
writes is the f32 normal rounded to bf16. The plain bf16 versions run the
same ops on ``torch.bfloat16`` tensors (PyTorch computes a bf16 op in f32
and rounds once, as the kernels do).

The solve index s of every wrapper that reads the noise is an int or a
one-element int64 tensor on the kernel's device, which the kernel reads
when it draws (``_launch.solve_words``): the same bits either way, and the
form a replayed CUDA graph needs (``envs/mjx_env.py``).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Each launch adds one to
``launch_counts[name]`` (``kernels/_launch.py``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ._launch import (check, launch, launch_counts, on_card,
                      reset_launch_counts, solve_words, split64)
from .errors import KernelUnsupportedError

# launch_counts and reset_launch_counts are re-exported for callers of
# this module (chip_smoke.py, the tests)
NEG_INF = float("-inf")
#: samples (threads) per block of the fused solve
BLOCK = 256
#: leading stats slots of a partial row: (m, l, cost min, max, sum, pad x3)
STATS = 8
#: (state dim, action dim) pairs the CUDA kernel is instantiated for
SUPPORTED_DIMS = ((6, 3), (2, 1), (4, 2))
#: state costs of the kernel (``PmCost`` in pm_mppi.cu); "elipse" is built
#: for (4, 2) only
COST_KINDS = {"quadratic": 0, "elipse": 1}
#: block compute types of the kernels (the JAX kernels' ``compute_dtype``)
COMPUTE_DTYPES = ("float32", "bfloat16")
#: structures of the solve constants (``PmStruct`` in pm_mppi.cu)
STRUCTURES = {"dense": 0, "integrator": 1}


def check_compute_dtype(compute_dtype: str) -> str:
    """``compute_dtype`` if the kernels are built for it; else ValueError,
    as the JAX solve objects raise (pm_mppi.py:674-677)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                         f"got {compute_dtype!r}")
    return compute_dtype


def entry(name: str, compute_dtype: str) -> str:
    """The C entry point of kernel ``name`` at ``compute_dtype``: the bf16
    build carries a ``_bf16`` suffix."""
    return name + "_bf16" if check_compute_dtype(
        compute_dtype) == "bfloat16" else name


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest, ties to even), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def round_bf16_np(a) -> np.ndarray:
    """Host array ``a`` rounded to f32, then to bf16, as f64: the solve
    constants the bf16 kernels read (packed rounded, so that the kernels
    multiply by them as they are)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).double().numpy()


def bf16_const(v, device) -> torch.Tensor:
    """A host constant as the bf16 kernels read it: rounded to f32 (the
    packed constants), then to bf16; a 0-dim bf16 tensor."""
    return torch.tensor(np.float32(v), device=device).to(torch.bfloat16)


def bf16_dot(row, vec):
    """sum_j row[j] vec[j] with a bf16 round after every product and sum, j
    in order: a kernel's fma_r chain. ``row`` holds host floats (a zero is
    skipped and a one not multiplied, as the JAX kernel's sparse_dot does;
    both are exact) or 0-dim bf16 tensors (dense); ``vec`` bf16 tensors."""
    acc = None
    for m, v in zip(row, vec):
        if isinstance(m, float):
            if m == 0.0:
                continue
            term = v if m == 1.0 else bf16_const(m, v.device) * v
        else:
            term = m * v
        acc = term if acc is None else acc + term
    return acc if acc is not None else torch.zeros_like(vec[0])


class Dyn:
    """Layout of the per-solve parameter array ``dyn`` (the JAX package's
    ``_Dyn``), staged into shared memory by the kernel. A ``dynamic_ab``
    solve (``FusedLTIMPPI``) appends A (sdim*sdim, row-major) and B scale
    (sdim*adim), read by the kernel in place of the constants; a scheduled
    solve then appends the tau factors c_t."""

    def __init__(self, tau: int, sdim: int, adim: int,
                 dynamic_ab: bool = False, scheduled: bool = False):
        self.inv_mass = 0                      # 1
        self.x0 = 1                            # sdim
        self.goal = 1 + sdim                   # sdim
        self.bu = 1 + 2 * sdim                 # tau*sdim: B u_t (mass-free)
        self.rhs_z = self.bu + tau * sdim      # tau*adim
        self.u_half = self.rhs_z + tau * adim  # 1: summed pure-action cost
        self.size = self.u_half + 1
        self.A = self.Bs = None
        if dynamic_ab:
            self.A = self.size                 # sdim*sdim
            self.Bs = self.A + sdim * sdim     # sdim*adim: B @ scale
            self.size = self.Bs + sdim * adim
        self.sched = _sched_block(self, tau, scheduled)


def _sched_block(lay, tau: int, scheduled: bool):
    """Append the tau schedule factors to layout ``lay``; their offset, or
    None unscheduled."""
    if not scheduled:
        return None
    off, lay.size = lay.size, lay.size + tau
    return off


def antithetic_half(k: int, antithetic: bool = True) -> int:
    """The first mirrored sample of an antithetic K-sample solve,
    ceil(K/2) (ops/noise.sample_noise_antithetic), or 0 for none."""
    return (int(k) + 1) // 2 if antithetic else 0


@dataclass
class PmConsts:
    """Solve constants: A (sdim x sdim), Bs = B @ scale (sdim x adim, mass
    free), Q (sdim x sdim; zero for the ellipse), Mz = scale^T Sigma^-1
    scale (adim x adim), lam, nc_half = lam (1 - 1/upsilon) / 2, the cost
    kind (``COST_KINDS``) and the ellipse's (a, b, cx, cy, gv, m_state,
    m_vel); ``scheduled`` and ``antithetic`` are the runtime variants (not
    packed: launch arguments). With ``dynamic_ab`` the kernel reads A and
    Bs from ``dyn`` (``Dyn.A``, ``Dyn.Bs``) and the packed A and Bs are
    zeros that it never reads. ``compute_dtype`` picks the f32 or the bf16
    build of the kernels."""

    A: np.ndarray
    Bs: np.ndarray
    Q: np.ndarray
    Mz: np.ndarray
    lam: float
    nc_half: float
    cost_kind: str = "quadratic"
    elipse: tuple = (0.0,) * 7
    scheduled: bool = False
    antithetic: bool = False
    dynamic_ab: bool = False
    compute_dtype: str = "float32"

    @property
    def dims(self):
        return self.Bs.shape

    @functools.cached_property
    def structure(self) -> str:
        """The kernels' ``STRUCTURES`` entry: "integrator" when, in the
        packed f32 constants, A's diagonal is 1.0 and its only other
        nonzeros lie at [2d, 2d+1], B scale's nonzeros at [2d, d] and
        [2d+1, d], Q (the quadratic cost's; the ellipse reads none) and Mz
        are diagonal, the state is 2 adim, and the build is f32 without
        dynamic_ab; else "dense" (the bf16 build and dynamic_ab have
        kDense alone)."""
        sdim, adim = self.dims
        if (self.compute_dtype != "float32" or self.dynamic_ab
                or sdim != 2 * adim):
            return "dense"
        A, Bs, Q, Mz = (np.asarray(m, np.float32)
                        for m in (self.A, self.Bs, self.Q, self.Mz))
        d = np.arange(adim)
        kept_a = np.eye(sdim, dtype=bool)
        kept_a[2 * d, 2 * d + 1] = True
        kept_b = np.zeros((sdim, adim), dtype=bool)
        kept_b[2 * d, d] = kept_b[2 * d + 1, d] = True
        left_out = [A[~kept_a], Bs[~kept_b],
                    Mz[~np.eye(adim, dtype=bool)]]
        if self.cost_kind == "quadratic":
            left_out.append(Q[~np.eye(sdim, dtype=bool)])
        integrator = (np.all(np.diag(A) == 1.0)
                      and not any(np.count_nonzero(a) for a in left_out))
        return "integrator" if integrator else "dense"

    @functools.cached_property
    def packed(self) -> np.ndarray:
        """f32 host array in the order of ``Consts`` in pm_mppi.cu: A, Bs,
        Q, Mz, lam, nc_half, the seven ellipse constants; at bf16 with A,
        Bs, Q and Mz rounded to bf16 (the f32 scalars stay f32)."""
        mats = [self.A, self.Bs, self.Q, self.Mz]
        if self.compute_dtype == "bfloat16":
            mats = [round_bf16_np(m) for m in mats]
        return np.ascontiguousarray(np.concatenate(
            [m.ravel() for m in mats]
            + [[self.lam, self.nc_half], self.elipse]).astype(np.float32))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for 32-bit unsigned a, b held in
    int64, split into 16-bit pieces so that no product overflows."""
    t = a * (b & 0xFFFF)                 # < 2^48
    u = a * (b >> 16)                    # < 2^48
    mid = ((u & 0xFFFF) << 16) + t       # < 2^49
    return (u >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 values.

    counter: [..., 4], key: [..., 2] (broadcast) -> [..., 4] random words.
    """
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key[..., 0], key[..., 1]
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def box_muller(bits: torch.Tensor) -> torch.Tensor:
    """Four 32-bit words [..., 4] -> four standard normals [..., 4] (f32);
    the transcendental math runs in f64 and rounds once."""
    u = ((bits >> 9).to(torch.float64) + 0.5) * 2.0 ** -23
    ua, ub = u[..., 0::2], u[..., 1::2]
    r = torch.sqrt(-2.0 * torch.log(ua))
    th = 2.0 * math.pi * ub
    z = torch.stack([r * torch.cos(th), r * torch.sin(th)], dim=-1)
    return z.reshape(bits.shape).to(torch.float32)


def noise_plain(seed: int, solve: int, k: int, tau: int, adim: int,
                device=None, half: int = 0) -> torch.Tensor:
    """The in-kernel noise stream of one solve: z f32 [tau, adim, k],
    mirrored from sample ``half`` on (an antithetic solve's
    ``antithetic_half``; 0: none)."""
    n_z = tau * adim
    nb = -(-n_z // 4)
    s_lo, s_hi = split64(solve)
    seed_lo, seed_hi = split64(seed)
    kk = torch.arange(k, dtype=torch.int64, device=device)
    mirrored = (kk >= half) & (half > 0)
    src = torch.where(mirrored, kk - half, kk)
    bb = torch.arange(nb, dtype=torch.int64, device=device)
    ctr = torch.stack(torch.broadcast_tensors(
        src[None, :], bb[:, None],
        torch.tensor(s_lo, device=device), torch.tensor(s_hi, device=device)),
        dim=-1)                                         # [nb, k, 4]
    key = torch.tensor([seed_lo, seed_hi], dtype=torch.int64, device=device)
    z = box_muller(philox4x32_10(ctr, key))             # [nb, k, 4]
    z = z.permute(0, 2, 1).reshape(nb * 4, k)[:n_z]
    z = torch.where(mirrored, -z, z)
    return z.reshape(tau, adim, k).contiguous()


def sample_costs_plain(consts: PmConsts, dyn: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """Per-sample rollout costs [k] in the kernel's folded algebra: the
    rollout_costs of the point-mass model and its state cost (the
    quadratic around dyn's goal, or the ellipse) over eps = c_t scale @ z,
    with B scale, Sigma^-1, u and the schedule folded into dyn; at bf16
    ``_sample_costs_bf16``."""
    if consts.compute_dtype == "bfloat16":
        return _sample_costs_bf16(consts, dyn, z)
    tau, adim, k = z.shape
    sdim = consts.A.shape[0]
    lay = Dyn(tau, sdim, adim, consts.dynamic_ab, consts.scheduled)
    ct = sched_factors(dyn, lay, tau)

    def t_(a):
        return torch.as_tensor(a, dtype=dyn.dtype, device=dyn.device)

    Q, Mz = t_(consts.Q), t_(consts.Mz)
    if consts.dynamic_ab:
        A = dyn[lay.A:lay.Bs].reshape(sdim, sdim)
        Bs = dyn[lay.Bs:lay.Bs + sdim * adim].reshape(sdim, adim)
    else:
        A, Bs = t_(consts.A), t_(consts.Bs)
    inv_m = dyn[lay.inv_mass]
    goal = dyn[lay.goal:lay.goal + sdim]
    bu = dyn[lay.bu:lay.rhs_z].reshape(tau, sdim)
    rhs_z = dyn[lay.rhs_z:lay.u_half].reshape(tau, adim)

    if consts.cost_kind == "elipse":
        a, b, cx, cy, gv, mx, mv = consts.elipse

        def q(x):   # reference elipse_cost.py:46-79 over [x, vx, y, vy]
            ex, ey = (x[:, 0] - cx) / a, (x[:, 2] - cy) / b
            dv = torch.sqrt(x[:, 1] ** 2 + x[:, 3] ** 2) - gv
            return mx * torch.abs(ex * ex + ey * ey - 1.0) + mv * dv * dv
    else:
        def q(x):
            d = x - goal
            return torch.sum((d @ Q.T) * d, dim=-1)

    x = dyn[lay.x0:lay.x0 + sdim].expand(k, sdim)
    cost = torch.zeros(k, dtype=dyn.dtype, device=dyn.device)
    for t in range(tau):
        zt = z[t].T                                     # [k, adim]
        x = x @ A.T + inv_m * (bu[t] + ct[t] * (zt @ Bs.T))
        cost = (cost + q(x) + zt @ rhs_z[t] + consts.nc_half * ct[t]
                * torch.sum((zt @ Mz.T) * zt, dim=-1))
    return cost + q(x) + dyn[lay.u_half]


def _sample_costs_bf16(consts: PmConsts, dyn: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's per-sample costs [k], op for op (pm_mppi.cu at
    Val = bf16x2): the state as bf16 columns, each op rounded, in the JAX
    kernel's order, every runtime operand (x0, goal, bu or r(inv_m bu),
    rhs_z, A and B scale, the scalars) rounded once; the state cost and
    the z terms bf16 values summed in f32. Not the f32 path's matrix
    products, which round once."""
    tau, adim, k = z.shape
    sdim = consts.A.shape[0]
    lay = Dyn(tau, sdim, adim, consts.dynamic_ab, consts.scheduled)
    d = dyn.to(torch.float32)
    dev = d.device

    def r(v):
        return v.to(torch.bfloat16)

    def c(v):
        return bf16_const(v, dev)

    if consts.dynamic_ab:     # dense smem_dot rows over runtime (A, B scale)
        A = r(d[lay.A:lay.Bs]).reshape(sdim, sdim)
        Bs = r(d[lay.Bs:lay.Bs + sdim * adim]).reshape(sdim, adim)
        A = [list(row.unbind()) for row in A]
        Bs = [list(row.unbind()) for row in Bs]
    else:                     # sparse_dot rows over the constants
        A = np.float32(consts.A).astype(float).tolist()
        Bs = np.float32(consts.Bs).astype(float).tolist()
    Q = np.float32(consts.Q).astype(float).tolist()
    Mz = np.float32(consts.Mz).astype(float).tolist()
    inv_m = d[lay.inv_mass]
    goal = [r(g) for g in d[lay.goal:lay.goal + sdim].unbind()]
    bu = d[lay.bu:lay.rhs_z].reshape(tau, sdim)
    rhs_z = r(d[lay.rhs_z:lay.u_half]).reshape(tau, adim)
    ct = sched_factors(d, lay, tau)
    nc_half = np.float32(consts.nc_half)

    if consts.cost_kind == "elipse":
        a, b, cx, cy, gv, mx, mv = (np.float32(v) for v in consts.elipse)
        inv_a, inv_b = np.float32(1.0) / a, np.float32(1.0) / b

        def q(x):   # the JAX kernel's bf16 ellipse (:474-485)
            ex = (x[0] - c(cx)) * c(inv_a)
            ey = (x[2] - c(cy)) * c(inv_b)
            dd = torch.abs(ex * ex + ey * ey - c(1.0))
            dv = r(torch.sqrt((x[1] * x[1] + x[3] * x[3]).float())) - c(gv)
            return c(mx) * dd + c(mv) * (dv * dv)
    else:
        def q(x):
            dvec = [xi - gi for xi, gi in zip(x, goal)]
            out = None
            for i in range(sdim):
                if not any(Q[i]):
                    continue
                term = dvec[i] * bf16_dot(Q[i], dvec)
                out = term if out is None else out + term
            return out if out is not None else torch.zeros_like(x[0])

    zb = r(z.to(torch.float32))
    x = [r(v).expand(k) for v in d[lay.x0:lay.x0 + sdim].unbind()]
    cost = torch.zeros(k, dtype=torch.float32, device=dev)
    for t in range(tau):
        zt = list(zb[t].unbind())
        xn = []
        for i in range(sdim):
            ax, bz = bf16_dot(A[i], x), bf16_dot(Bs[i], zt)
            if lay.sched is not None:
                xn.append(ax + (r(inv_m * bu[t, i]) + r(inv_m * ct[t]) * bz))
            else:
                xn.append(ax + r(inv_m) * (r(bu[t, i]) + bz))
        x = xn
        cost = cost + q(x).float()
        quad = None
        for j in range(adim):
            cost = cost + (rhs_z[t, j] * zt[j]).float()
            term = zt[j] * bf16_dot(Mz[j], zt)
            quad = term if quad is None else quad + term
        cost = cost + (r(torch.as_tensor(nc_half, device=dev) * ct[t])
                       * quad).float()
    return (cost + q(x).float() + d[lay.u_half]).to(dyn.dtype)


def sched_factors(dyn: torch.Tensor, lay, tau: int) -> list:
    """The c_t a kernel reads from ``dyn`` (layout ``lay``), or 1.0."""
    if lay.sched is None:
        return [1.0] * tau
    return list(dyn[lay.sched:lay.sched + tau].unbind())


def _partial_rows(costs: torch.Tensor, zarg: torch.Tensor, zf: torch.Tensor,
                  block: int, max_shift: bool) -> torch.Tensor:
    """Rows (m_b, l_b, cmin_b, cmax_b, csum_b, 0, 0, 0, zsum_b) of the
    per-block weights w = exp(zarg - m_b), zsum_b = sum_k w_k z_k; m_b is
    the block max of zarg with ``max_shift``, else 0. Padding samples
    carry the -inf sentinel and weigh exactly 0 (mppi_common.cuh
    write_partial_row)."""
    n_z, k = zf.shape
    nb = -(-k // block)
    pad = nb * block - k
    valid = (torch.arange(nb * block, device=costs.device) < k).reshape(
        nb, block)
    c = torch.nn.functional.pad(costs, (0, pad)).reshape(nb, block)
    za = torch.where(valid, torch.nn.functional.pad(zarg, (0, pad)).reshape(
        nb, block), NEG_INF)
    m = za.max(dim=1).values if max_shift else za.new_zeros(nb)
    w = torch.where(valid, torch.exp(za - m[:, None]), 0.0)
    zb = torch.nn.functional.pad(zf, (0, pad)).reshape(n_z, nb, block)
    stats = torch.stack([
        m, w.sum(dim=1),
        torch.where(valid, c, float("inf")).min(dim=1).values,
        torch.where(valid, c, NEG_INF).max(dim=1).values,
        torch.where(valid, c, 0.0).sum(dim=1)], dim=1)
    return torch.cat([stats, stats.new_zeros(nb, STATS - 5),
                      torch.einsum("bk,nbk->bn", w, zb)], dim=1)


def block_partials(costs: torch.Tensor, zf: torch.Tensor, lam: float,
                   block: int = BLOCK) -> torch.Tensor:
    """Per-block online-softmax partials of -cost/lam (fused solve).

    costs [k], zf [n_z, k] -> [n_blocks, STATS + n_z] rows
    (m_b, l_b, cmin_b, cmax_b, csum_b, 0, 0, 0, zsum_b).

    -costs / lam is the kernels' quotient, correctly rounded, on every
    device: lam is divided by as a tensor, because PyTorch's CUDA division
    by a Python scalar multiplies by the scalar's rounded reciprocal, one
    ulp of -cost/lam off for many costs.
    """
    lam_t = torch.as_tensor(lam, dtype=costs.dtype, device=costs.device)
    return _partial_rows(costs, -costs / lam_t, zf, block, max_shift=True)


def weight_partials(costs: torch.Tensor, nrm: torch.Tensor,
                    zf: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Phase-B rows: w = exp(-(c - beta) * inv_dl) with nrm = (beta, inv_dl),
    bounded in [exp(-1/lam), 1], so m_b = 0."""
    return _partial_rows(costs, -(costs - nrm[0]) * nrm[1], zf, block,
                         max_shift=False)


def cost_partials(costs: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Phase-A rows: (0, 0, cmin_b, cmax_b, csum_b, 0, 0, 0), no zsum."""
    return _partial_rows(costs, torch.full_like(costs, NEG_INF),
                         costs.new_zeros(0, costs.shape[0]), block,
                         max_shift=False)


def fused_solve_plain(consts: PmConsts, dyn: torch.Tensor, k: int, tau: int,
                      seed: int = 0, solve: int = 0, z=None,
                      block: int = BLOCK) -> torch.Tensor:
    """Plain version of ``pm_fused_solve``: per-block partials
    [n_blocks, STATS + tau*adim]."""
    adim = consts.Bs.shape[1]
    z = solve_noise(seed, solve, k, tau, adim, dyn, z,
                    consts.antithetic, consts.compute_dtype)
    costs = sample_costs_plain(consts, dyn, z)
    return block_partials(costs, z.reshape(tau * adim, k), consts.lam, block)


def solve_noise(seed: int, solve: int, k: int, tau: int, adim: int,
                like: torch.Tensor, z=None, antithetic: bool = False,
                compute_dtype: str = "float32") -> torch.Tensor:
    """The normals [tau, adim, k] a solve consumes, in ``like``'s dtype and
    device: injected ``z`` or the Philox stream of (seed, solve), mirrored
    when ``antithetic``, rounded to bf16 at ``compute_dtype`` bf16."""
    if z is None:
        z = noise_plain(seed, solve, k, tau, adim, device=like.device,
                        half=antithetic_half(k, antithetic))
    z = z.to(like.dtype)
    return round_bf16(z) if compute_dtype == "bfloat16" else z


def fused_costs_plain(consts: PmConsts, dyn: torch.Tensor, k: int, tau: int,
                      seed: int = 0, solve: int = 0, z=None,
                      block: int = BLOCK):
    """Plain version of ``pm_fused_costs``: (costs [k], stats-only rows
    [n_blocks, STATS])."""
    z = solve_noise(seed, solve, k, tau, consts.Bs.shape[1], dyn, z,
                    consts.antithetic, consts.compute_dtype)
    costs = sample_costs_plain(consts, dyn, z)
    return costs, cost_partials(costs, block)


def weights_plain(nrm: torch.Tensor, costs: torch.Tensor, tau: int,
                  adim: int, seed: int = 0, solve: int = 0, z=None,
                  block: int = BLOCK, antithetic: bool = False,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """Plain version of ``mppi_weights``: rows [n_blocks, STATS + tau*adim]
    of the normalized weights over the solve's normals (rounded to bf16 at
    ``compute_dtype`` bf16)."""
    k = costs.shape[0]
    z = solve_noise(seed, solve, k, tau, adim, costs, z, antithetic,
                    compute_dtype)
    return weight_partials(costs, nrm, z.reshape(tau * adim, k), block)


def merge_plain(partials: torch.Tensor):
    """Plain version of ``pm_merge``: (zsum [n_z], stats [8]) with stats
    (m, l, cost min, cost max, cost sum, 0, 0, 0)."""
    m_b = partials[:, 0]
    m = m_b.max()
    f = torch.exp(m_b - m)
    stats = torch.stack([
        m, (f * partials[:, 1]).sum(), partials[:, 2].min(),
        partials[:, 3].max(), partials[:, 4].sum()])
    return (f @ partials[:, STATS:],
            torch.cat([stats, stats.new_zeros(STATS - 5)]))


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

def pm_noise_dump(seed: int, solve: int, k: int, tau: int, adim: int,
                  device, half: int = 0,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """The exact normals of solve ``solve`` at ``seed``: z f32 [tau, adim, k],
    mirrored from sample ``half`` on as in ``noise_plain``; at
    ``compute_dtype`` bf16 each rounded to bf16, as the bf16 kernels read
    them."""
    device = torch.device(device)
    name = entry("pm_noise_dump", compute_dtype)
    if device.type == "cpu":
        z = noise_plain(seed, solve, k, tau, adim, half=half)
        return round_bf16(z) if compute_dtype == "bfloat16" else z
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((tau, adim, k), dtype=torch.float32, device=device)
    launch(name, device, out.data_ptr(), k, tau * adim, half,
           *split64(seed), *solve_words(solve, out.device))
    return out


def fleet_dims(t: torch.Tensor, ndim: int) -> tuple:
    """The leading vehicle axis of a wrapper's input ``t`` whose one-vehicle
    form has ``ndim`` dims: () for one vehicle, (n,) for a fleet of n."""
    lead = tuple(t.shape[:t.dim() - ndim])
    if len(lead) > 1:
        raise ValueError(f"expected {ndim} dims or a vehicle axis before "
                         f"them, got shape {tuple(t.shape)}")
    return lead


def per_vehicle(fn, n: int, solve, *rows):
    """The plain version of a fleet launch: ``fn(solve * n + v, *rows[v])``
    for each vehicle v (the index vehicle v of a fleet launch draws,
    mppi_common.cuh; ``solve`` an int or a one-element tensor on the CPU;
    rows of None stay None), stacked output by output."""
    outs = [fn(int(solve) * n + v,
               *(None if r is None else r[v] for r in rows))
            for v in range(n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _check_solve_inputs(name, consts, dyn, z, k, tau):
    """The vehicle axis ((), or (n,) for a fleet) of a solve's inputs."""
    sdim, adim = consts.dims
    if (sdim, adim) not in SUPPORTED_DIMS:
        raise KernelUnsupportedError(
            f"{name} is built for (sdim, adim) in {SUPPORTED_DIMS}, got "
            f"{(sdim, adim)}")
    if consts.cost_kind == "elipse" and (sdim, adim) != (4, 2):
        raise KernelUnsupportedError(
            f"{name}: the ellipse cost is built for (4, 2), got "
            f"{(sdim, adim)}")
    lead = fleet_dims(dyn, 1)
    check(dyn, "dyn", (*lead, Dyn(tau, sdim, adim, consts.dynamic_ab,
                                  consts.scheduled).size))
    if z is not None:
        check(z, "z", (*lead, tau, adim, k))
    return lead


def n_vehicles(lead: tuple) -> int:
    """The ``n`` a launch passes for vehicle axis ``lead``."""
    return lead[0] if lead else 1


def variant_args(consts, k: int):
    """(scheduled, half): the launch arguments of a solve's runtime
    variants."""
    return int(consts.scheduled), antithetic_half(k, consts.antithetic)


def _pm_launch_args(consts, k: int, seed: int, solve, device,
                    n: int) -> tuple:
    """scheduled, dynamic_ab, half, seed and solve words and the vehicles
    of a point-mass solve's launch (``_launch.solve_words``)."""
    scheduled, half = variant_args(consts, k)
    return (scheduled, int(consts.dynamic_ab), half, *split64(seed),
            *solve_words(solve, device, n), n)


def pm_fused_solve(consts: PmConsts, dyn: torch.Tensor, k: int, tau: int,
                   seed: int = 0, solve: int = 0, z=None) -> torch.Tensor:
    """Fused rollout + block softmax partials [n_blocks, STATS + tau*adim].

    ``z`` (f32 [tau, adim, k]) injects the normals in place of the
    in-kernel Philox stream of (seed, solve). A fleet's ``dyn`` [n, size]
    (and z [n, tau, adim, k]) runs n vehicles in one launch, vehicle v
    drawing solve solve * n + v: partials [n, n_blocks, ...]."""
    if not on_card(dyn, z):
        if dyn.dim() == 2:
            return per_vehicle(lambda s, d, zv: fused_solve_plain(
                consts, d, k, tau, seed, s, zv), dyn.shape[0], solve, dyn, z)
        return fused_solve_plain(consts, dyn, k, tau, seed, solve, z)
    lead = _check_solve_inputs("pm_fused_solve", consts, dyn, z, k, tau)
    sdim, adim = consts.dims
    partials = torch.empty((*lead, -(-k // BLOCK), STATS + tau * adim),
                           dtype=torch.float32, device=dyn.device)
    launch(entry("pm_fused_solve", consts.compute_dtype), dyn.device, sdim,
           adim, COST_KINDS[consts.cost_kind], STRUCTURES[consts.structure],
           consts.packed.ctypes.data, dyn.data_ptr(),
           None if z is None else z.data_ptr(), partials.data_ptr(), k, tau,
           *_pm_launch_args(consts, k, seed, solve, dyn.device,
                            n_vehicles(lead)))
    return partials


def pm_fused_costs(consts: PmConsts, dyn: torch.Tensor, k: int, tau: int,
                   seed: int = 0, solve: int = 0, z=None):
    """Phase A: the fused rollout's per-sample costs [k] and stats-only
    rows [n_blocks, STATS] (``pm_merge`` gives cost min / max / sum); for
    a fleet's ``dyn`` [n, size], [n, k] and [n, n_blocks, STATS] from one
    launch (``pm_fused_solve``)."""
    if not on_card(dyn, z):
        if dyn.dim() == 2:
            return per_vehicle(lambda s, d, zv: fused_costs_plain(
                consts, d, k, tau, seed, s, zv), dyn.shape[0], solve, dyn, z)
        return fused_costs_plain(consts, dyn, k, tau, seed, solve, z)
    lead = _check_solve_inputs("pm_fused_costs", consts, dyn, z, k, tau)
    sdim, adim = consts.dims
    costs = torch.empty((*lead, k), dtype=torch.float32, device=dyn.device)
    partials = torch.empty((*lead, -(-k // BLOCK), STATS),
                           dtype=torch.float32, device=dyn.device)
    launch(entry("pm_fused_costs", consts.compute_dtype), dyn.device, sdim,
           adim, COST_KINDS[consts.cost_kind], STRUCTURES[consts.structure],
           consts.packed.ctypes.data, dyn.data_ptr(),
           None if z is None else z.data_ptr(), costs.data_ptr(),
           partials.data_ptr(), k, tau,
           *_pm_launch_args(consts, k, seed, solve, dyn.device,
                            n_vehicles(lead)))
    return costs, partials


def mppi_weights(nrm: torch.Tensor, costs: torch.Tensor, tau: int,
                 adim: int, seed: int = 0, solve: int = 0, z=None,
                 antithetic: bool = False,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """Phase B over phase-A ``costs`` [k] with nrm = (beta, 1/(denom lam))
    (f32 [2], on the device): rows [n_blocks, STATS + tau*adim] of the
    normalized weights over the normals of (seed, solve), mirrored when
    ``antithetic``, or ``z``; rounded to bf16 at ``compute_dtype`` bf16.
    A fleet's nrm [n, 2] and costs [n, k] (z [n, tau, adim, k]) run in one
    launch, vehicle v over the normals of solve solve * n + v: rows
    [n, n_blocks, ...]."""
    name = entry("mppi_weights", compute_dtype)
    if not on_card(nrm, costs, z):
        if costs.dim() == 2:
            return per_vehicle(lambda s, nv, cv, zv: weights_plain(
                nv, cv, tau, adim, seed, s, zv, antithetic=antithetic,
                compute_dtype=compute_dtype), costs.shape[0], solve, nrm,
                costs, z)
        return weights_plain(nrm, costs, tau, adim, seed, solve, z,
                             antithetic=antithetic,
                             compute_dtype=compute_dtype)
    lead = fleet_dims(costs, 1)
    k = costs.shape[-1]
    check(nrm, "nrm", (*lead, 2))
    check(costs, "costs", (*lead, k))
    if z is not None:
        check(z, "z", (*lead, tau, adim, k))
    partials = torch.empty((*lead, -(-k // BLOCK), STATS + tau * adim),
                           dtype=torch.float32, device=costs.device)
    launch(name, costs.device, nrm.data_ptr(), costs.data_ptr(),
           None if z is None else z.data_ptr(), partials.data_ptr(), k,
           tau * adim, antithetic_half(k, antithetic), *split64(seed),
           *solve_words(solve, costs.device, n_vehicles(lead)),
           n_vehicles(lead))
    return partials


def pm_merge(partials: torch.Tensor):
    """Merge block partials -> (zsum [n_z], stats [8]); see ``merge_plain``.
    Stats-only rows (n_z = 0) give an empty zsum; on the card they run a
    kernel of their own (``_launch.EXTRA_KERNELS``). A fleet's rows
    [n, nb, width] merge vehicle by vehicle in one launch: zsum [n, n_z],
    stats [n, 8]."""
    if not on_card(partials):
        if partials.dim() == 3:
            return tuple(torch.stack(o) for o in
                         zip(*(merge_plain(p) for p in partials)))
        return merge_plain(partials)
    lead = fleet_dims(partials, 2)
    nb, width = partials.shape[-2:]
    check(partials, "partials", (*lead, nb, width))
    n_z = width - STATS
    zsum = torch.empty((*lead, n_z), dtype=torch.float32,
                       device=partials.device)
    stats = torch.empty((*lead, STATS), dtype=torch.float32,
                        device=partials.device)
    launch("pm_merge", partials.device, partials.data_ptr(), nb, n_z,
           zsum.data_ptr(), stats.data_ptr(), n_vehicles(lead))
    return zsum, stats


# ---------------------------------------------------------------------------
# solve objects: host glue around the kernels
# ---------------------------------------------------------------------------

class TwoPhaseSolve:
    """``solve``, ``costs_phase``, ``weights_phase``, ``unfold_wnoise`` and
    ``noise_sample`` of a fused solve object. A subclass sets k, tau, adim,
    lam and ``_scale`` (the noise scale, f32 on the device) and defines
    ``pack_dyn(x0, useq)``, ``_fused(dyn, seed, solve, z)`` (block partials)
    and ``_costs(dyn, seed, solve, z)`` ((costs, stats-only rows)).

    The normalized solve (reference controller_base.py:468-474) runs as two
    phases: A, the rollout's per-sample costs and their min / max / sum; B,
    the weights exp(-(c - beta) / ((max - beta) lam)) over the regenerated
    normals. The glue between them stays on the device: no host sync.

    A subclass whose kernel drops a per-sample constant from the cost
    returns it from ``_cost_offset()`` (a device scalar); the costs and
    their stats get it back, while the weights, invariant to a constant
    shift, stay as computed.

    The runtime variants (``_noise_options``): ``antithetic`` mirrors the
    Philox samples past ceil(K/2); ``sched`` holds the schedule's c_t
    ([tau], appended to ``dyn``), which ``set_schedule`` replaces as data.
    ``compute_dtype`` ("float32" or "bfloat16") picks the kernels' build
    in every phase, the weights and the noise sample included.

    Fleets: ``solve`` also takes the states [n, sdim] and sequences [n,
    tau, adim] of n vehicles with their cost params ``cp`` (the cost's
    ``params()`` stacked [n, ...]), and runs every phase as one launch
    over all vehicles (vehicle v draws solve solve * n + v); wnoise and
    every info entry then lead with [n]. With ``cp`` None the cost's own
    params are read.
    """

    compute_dtype = "float32"

    def _noise_options(self, antithetic: bool, schedule, like: dict) -> None:
        """Set ``antithetic`` and ``sched`` (a spec of
        ``ops/noise.resolve_noise_schedule``, as a tensor ``like`` the
        solve's dtype and device)."""
        from ..ops.noise import resolve_noise_schedule

        self.antithetic = bool(antithetic)
        c = resolve_noise_schedule(schedule, self.tau)
        self.sched = None if c is None else torch.as_tensor(c, **like)

    @property
    def scheduled(self) -> bool:
        return self.sched is not None

    def set_schedule(self, schedule) -> None:
        """New c_t for a scheduled solve: repacked data, no rebuild."""
        from ..ops.noise import resolve_noise_schedule

        if self.sched is None:
            raise ValueError("this solve was built without a noise schedule")
        self.sched = torch.as_tensor(
            resolve_noise_schedule(schedule, self.tau),
            dtype=self.sched.dtype, device=self.sched.device)

    def _action_terms(self, useq: torch.Tensor):
        """(rhs_z [..., tau, adim], u_half [...]) of the nominal sequence
        folded into dyn: rhs_z_t = scale^T gamma Sigma^-1 u_t
        (schedule-invariant) and u_half = sum_t 0.5 gamma u_t^T Sigma^-1
        u_t / c_t; a leading vehicle axis of ``useq`` carries through."""
        rhs_z = (self.gamma * (useq @ self._inv_sigma.T)) @ self._scale
        if self.sched is None:
            u_half = 0.5 * self.gamma * torch.einsum(
                "...ti,ij,...tj->...", useq, self._inv_sigma, useq)
        else:
            u_half = (0.5 * self.gamma * torch.einsum(
                "...ti,ij,...tj->...t", useq, self._inv_sigma, useq)
                / self.sched).sum(-1)
        return rhs_z, u_half

    def _sched_tail(self) -> list:
        """dyn's trailing schedule block: [c_t] when scheduled."""
        return [] if self.sched is None else [self.sched]

    def _cost_offset(self, cp=None):
        """The constant the kernel's costs lack (for the cost params
        ``cp``), or None."""
        return None

    def forget_cached_terms(self) -> None:
        """Drop whatever the solve derived from the cost's buffers and
        keyed on their host-side versions, so that the next solve derives
        it from the buffers again: a CUDA graph that changes the buffers
        (the on-device loop's pops) bumps no version, and one captured
        from a cached value would replay it stale."""

    def template_args(self, entry: str) -> tuple:
        """The integer template arguments of the kernel that entry point
        ``entry`` launches for this solve; () for the shared kernels."""
        base = entry.removesuffix("_bf16").removesuffix("_bfp")
        if base in ("mppi_weights", "pm_merge", "pm_noise_dump"):
            return ()
        return self._template_args(1 if base.endswith("_costs") else 0)

    def unfold_wnoise(self, zsum: torch.Tensor) -> torch.Tensor:
        """One vehicle's weighted standard-normal sums [tau*adim] (or
        [tau, adim]) -> action units [tau, adim]: wnoise_t = c_t scale @
        zsum_t."""
        return self._unfold(zsum.reshape(self.tau * self.adim))

    def _unfold(self, zsum: torch.Tensor) -> torch.Tensor:
        """``unfold_wnoise`` of sums [..., tau*adim] -> [..., tau, adim]."""
        w = zsum.reshape(*zsum.shape[:-1], self.tau, self.adim) \
            @ self._scale.T
        return w if self.sched is None else w * self.sched[:, None]

    def _pack_cp(self, x0, useq, cp):
        """``pack_dyn`` with the fleet's cost params ``cp`` (None: the
        cost's own)."""
        with tracing.span("mppi.solve.pack"):
            return (self.pack_dyn(x0, useq) if cp is None
                    else self.pack_dyn(x0, useq, cp))

    def solve(self, x0, useq, seed: int = 0, solve: int = 0, z=None,
              normalize: bool = False, cp=None):
        """One MPPI solve -> (wnoise [tau, adim], info); ``normalize`` runs
        the two-phase normalized variant, whose info also carries the
        phase-A ``sample_costs``. A fleet's states [n, sdim] (``cp``: its
        stacked cost params) give wnoise [n, tau, adim] and [n]-leading
        info."""
        if normalize:
            costs, cst = self.costs_phase(x0, useq, seed, solve, z, cp)
            zsum, l = self.weights_phase(costs, cst["cost_min"],
                                         cst["cost_max"], seed, solve, z)
            info = {"cost_min": cst["cost_min"], "cost_max": cst["cost_max"],
                    "cost_mean": cst["cost_sum"] / self.k, "nabla": l,
                    "sample_costs": costs}
            zsum = zsum.flatten(-2)
        else:
            zsum, stats = self.solve_raw(x0, useq, seed, solve, z, cp)
            l = stats[..., 1]
            info = {"cost_min": stats[..., 2], "cost_max": stats[..., 3],
                    "cost_mean": stats[..., 4] / self.k, "nabla": l}
        with tracing.span("mppi.solve.unfold"):
            return self._unfold(zsum) / l[..., None, None], info

    def solve_raw(self, x0, useq, seed: int = 0, solve: int = 0, z=None,
                  cp=None, dyn=None):
        """The unnormalized solve's merged block rows before the division
        by l (the JAX package's ``return_raw=True``): (zsum [tau*adim],
        stats [STATS]) of ``pm_merge``, (m, l, cost min, max, sum, ...),
        with ``_cost_offset`` added to the cost min / max / sum (a fleet's:
        [n]-leading). A shard merge (``parallel/fused.py``) combines such
        pieces with the merge's algebra; its shards share one ``dyn``
        (``pack_dyn`` of x0 and useq), packed once."""
        if dyn is None:
            dyn = self._pack_cp(x0, useq, cp)
        with tracing.span("mppi.solve.rollout"):
            rows = self._fused(dyn, seed, solve, z)
        with tracing.span("mppi.solve.merge"):
            zsum, stats = pm_merge(rows)
        if self._cost_offset(cp) is None:
            return zsum, stats
        cst = self._with_offset(stats, cp=cp)
        return zsum, torch.cat([
            stats[..., :2], torch.stack([cst["cost_min"], cst["cost_max"],
                                         cst["cost_sum"]], dim=-1),
            stats[..., 5:]], dim=-1)

    def _with_offset(self, stats, costs=None, cp=None):
        """{cost_min, cost_max, cost_sum} of merged ``stats`` (and the
        per-sample ``costs``) with ``_cost_offset(cp)`` added back."""
        cst = {"cost_min": stats[..., 2], "cost_max": stats[..., 3],
               "cost_sum": stats[..., 4]}
        off = self._cost_offset(cp)
        if off is None:
            return cst if costs is None else (costs, cst)
        cst = {"cost_min": cst["cost_min"] + off,
               "cost_max": cst["cost_max"] + off,
               "cost_sum": cst["cost_sum"] + self.k * off}
        return cst if costs is None else (costs + off[..., None], cst)

    def costs_phase(self, x0, useq, seed: int = 0, solve: int = 0, z=None,
                    cp=None, dyn=None):
        """Phase A: per-sample costs [k] and {cost_min, cost_max, cost_sum}
        (a fleet's: [n, k] and [n] each); ``dyn`` as for ``solve_raw``."""
        if dyn is None:
            dyn = self._pack_cp(x0, useq, cp)
        with tracing.span("mppi.solve.rollout"):
            costs, rows = self._costs(dyn, seed, solve, z)
        with tracing.span("mppi.solve.merge"):
            _, stats = pm_merge(rows)
        return self._with_offset(stats, costs, cp)

    def weights_nrm(self, beta, cmax) -> torch.Tensor:
        """Phase B's (beta, 1 / (denom lam)); the guard against all-equal
        costs matches ops/update.norm_arg (denom = 1 when max - beta ==
        0)."""
        denom = cmax - beta
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        return torch.stack([beta, 1.0 / (denom * self.lam)], dim=-1)

    def weights_phase(self, costs, beta, cmax, seed: int = 0, solve: int = 0,
                      z=None, nrm=None):
        """Phase B over phase-A costs -> (zsum [tau, adim], l) (a fleet's
        costs [n, k]: [n, tau, adim] and [n]); ``nrm``: ``weights_nrm``
        of (beta, cmax) when the caller has it (a shard merge's shards
        share it)."""
        with tracing.span("mppi.solve.weights"):
            if nrm is None:
                nrm = self.weights_nrm(beta, cmax)
            rows = mppi_weights(nrm, costs, self.tau, self.adim, seed, solve,
                                z, antithetic=self.antithetic,
                                compute_dtype=self.compute_dtype)
        with tracing.span("mppi.solve.merge"):
            zsum, stats = pm_merge(rows)
        return (zsum.reshape(*zsum.shape[:-1], self.tau, self.adim),
                stats[..., 1])

    def noise_sample(self, seed: int, solve: int,
                     max_samples: int = 512) -> torch.Tensor:
        """The first min(max_samples, k) samples' noise of solve ``solve``
        in action units, eps [n, tau, adim] with eps_t = c_t scale z_t (JAX
        fused_noise_sample; bf16-rounded normals at bf16)."""
        n = min(max_samples, self.k)
        z = pm_noise_dump(seed, solve, n, self.tau, self.adim,
                          self._scale.device,
                          half=antithetic_half(self.k, self.antithetic),
                          compute_dtype=self.compute_dtype)
        eps = torch.einsum("ij,tjn->nti", self._scale,
                           z.to(self._scale.dtype))
        return eps if self.sched is None else eps * self.sched[None, :, None]


class FusedPointMassMPPI(TwoPhaseSolve):
    """Fused solve for MPPI over PointMassModel + {StaticCost,
    WayPointsCost, ElipseCost}: packs the per-solve ``dyn`` array and runs
    ``pm_fused_solve`` + ``pm_merge``, or the two phases ``pm_fused_costs``
    and ``mppi_weights``; un-folds the weighted normals to action units.
    The host glue is torch ops on the model's device, with no host sync.

    The waypoint blend (1-a) q(x; w0) + a q(x; w1) with one Q is a single
    quadratic around the effective goal g = (1-a) w0 + a w1 plus a
    constant: the kernel runs the quadratic around g (w0 alone while one
    waypoint remains), packed into ``dyn`` every solve so that a pop is new
    data, and ``_cost_offset`` adds the constant back to the costs and
    their stats (the weights do not depend on it).

    Counterpart of the JAX package's ``FusedPointMassMPPI``; ``antithetic``
    and ``schedule`` (a noise schedule spec) are its runtime variants,
    ``compute_dtype`` ("float32" or "bfloat16", the block compute type)
    its build, and ``FusedLTIMPPI`` its runtime-(A, B) subclass.
    """

    #: True where the kernel reads (A, B scale) from ``dyn``
    #: (``FusedLTIMPPI``) instead of the solve's constants
    dynamic_ab = False

    def _check_model(self, model) -> None:
        from ..models.point_mass import PointMassModel

        if not isinstance(model, PointMassModel):
            raise KernelUnsupportedError(
                "fused kernel supports PointMassModel only")

    def __init__(self, model, cost, k: int, tau: int, lam: float,
                 upsilon: float, sigma, antithetic: bool = False,
                 schedule=None, compute_dtype: str = "float32"):
        from ..costs.elipse import ElipseCost
        from ..costs.static import StaticCost
        from ..costs.waypoints import WayPointsCost

        self.compute_dtype = check_compute_dtype(compute_dtype)
        self._check_model(model)
        dims = (model.get_state_dim(), model.get_action_dim())
        if type(cost) in (StaticCost, WayPointsCost):
            cost_kind = "quadratic"
        elif type(cost) is ElipseCost:
            if dims != (4, 2):
                raise KernelUnsupportedError(
                    "the ellipse cost needs the 4-dim [x, vx, y, vy] "
                    f"point-mass state, got (sdim, adim) = {dims}")
            cost_kind = "elipse"
        else:
            raise KernelUnsupportedError(
                "fused kernel supports StaticCost, WayPointsCost or "
                "ElipseCost only")
        if model.dtype != torch.float32:
            raise KernelUnsupportedError(
                f"fused kernel is float32, model is {model.dtype}")
        if model.device.type == "cuda" and dims not in SUPPORTED_DIMS:
            raise KernelUnsupportedError(
                f"the CUDA kernel is built for (sdim, adim) in "
                f"{SUPPORTED_DIMS}, got {dims}")
        self.model, self.cost = model, cost
        self.k, self.tau = int(k), int(tau)
        self.sdim, self.adim = dims
        self.lam, self.upsilon = float(lam), float(upsilon)
        self.gamma = float(cost.gamma)
        self._waypoints = type(cost) is WayPointsCost
        sigma = np.asarray(sigma, np.float64)
        scale = self.upsilon * sigma
        inv_sigma = np.linalg.inv(sigma)
        if self.dynamic_ab:   # read from the live model in every pack_dyn
            A = np.zeros((self.sdim, self.sdim))
            B = np.zeros((self.sdim, self.adim))
        else:
            A = model.A.detach().cpu().numpy().astype(np.float64)
            B = model.B.detach().cpu().numpy().astype(np.float64)
        if cost_kind == "elipse":
            Q = np.zeros((self.sdim, self.sdim))
            elipse = (cost.a, cost.b, cost.cx, cost.cy, cost.gv, cost.mx,
                      cost.mv)
        else:
            Q = cost.Q.detach().cpu().numpy().astype(np.float64)
            elipse = (0.0,) * 7
        like = {"dtype": torch.float32, "device": model.device}
        self._noise_options(antithetic, schedule, like)
        self.consts = PmConsts(
            A=A, Bs=B @ scale, Q=Q, Mz=scale.T @ inv_sigma @ scale,
            lam=self.lam, nc_half=0.5 * self.lam * (1.0 - 1.0 / self.upsilon),
            cost_kind=cost_kind, elipse=elipse, scheduled=self.scheduled,
            antithetic=self.antithetic, dynamic_ab=self.dynamic_ab,
            compute_dtype=self.compute_dtype)

        def f32(a):
            return torch.as_tensor(a, **like)

        self._B = None if self.dynamic_ab else f32(B)
        self._scale, self._inv_sigma = f32(scale), f32(inv_sigma)
        self._Q = f32(Q)
        self._wp_key, self._wp_terms = None, None

    def _waypoint_terms(self, cp=None):
        """(dyn's goal, the cost offset) of the waypoint queue, computed on
        the device with ``torch.where`` on the count (no host sync): for
        the cost's own queue again only when its buffers change (a pop, a
        new mission), for a fleet's stacked queues ``cp`` ([n, ...]) every
        time, for all vehicles at once.

        The goal is g = (1-a) w0 + a w1, or w0 while one waypoint remains.
        The offset is the constant the quadratic around g drops from each
        sample's cost: (tau+1) evaluations (tau steps and the terminal) of
        (1-a) w0'Qw0 + a w1'Qw1 - g'Qg (>= 0 by convexity), zero while one
        waypoint remains."""
        if cp is not None:
            return self._queue_terms(cp["waypoints"], cp["count"])
        key = self.cost.queue_key()
        if key != self._wp_key:
            self._wp_terms = self._queue_terms(self.cost.waypoints,
                                               self.cost.count)
            self._wp_key = key
        return self._wp_terms

    def _queue_terms(self, waypoints, count):
        wps = waypoints.to(torch.float32)
        w0, w1, a = wps[..., 0, :], wps[..., 1, :], self.cost.alpha
        g = (1.0 - a) * w0 + a * w1

        def q(w):
            return torch.sum((w @ self._Q.T) * w, dim=-1)

        c = (1.0 - a) * q(w0) + a * q(w1) - q(g)
        one = count < 2
        return (torch.where(one[..., None], w0, g),
                torch.where(one, torch.zeros_like(c), (self.tau + 1) * c))

    def forget_cached_terms(self) -> None:
        self._wp_key = None

    def _goal(self, cp, lead: tuple) -> torch.Tensor:
        """dyn's goal: the static goal, the waypoint queue's effective goal,
        or zeros for the ellipse, which reads no goal (``lead``: the
        vehicle axis)."""
        if self._waypoints:
            return self._waypoint_terms(cp)[0]
        if self.consts.cost_kind == "elipse":
            return torch.zeros((*lead, self.sdim), dtype=torch.float32,
                               device=self._scale.device)
        goal = self.cost.goal if cp is None else cp["goal"]
        return goal.to(torch.float32)

    def _cost_offset(self, cp=None):
        """The waypoint cost's offset (``_waypoint_terms``), else None."""
        return self._waypoint_terms(cp)[1] if self._waypoints else None

    def pack_dyn(self, x0: torch.Tensor, useq: torch.Tensor,
                 cp=None) -> torch.Tensor:
        """The per-solve ``dyn`` array (f32 [Dyn.size]) from the state, the
        nominal sequence, the live mass and goal, and the schedule; a
        fleet's [n, Dyn.size] from states [n, sdim], sequences
        [n, tau, adim] and stacked cost params ``cp``."""
        return self._pack(
            x0, useq,
            (1.0 / self.model.mass.detach()).to(torch.float32).reshape(1),
            self._B, [], cp)

    def _pack(self, x0, useq, inv_mass, B, ab: list, cp) -> torch.Tensor:
        """``dyn`` in the order of ``Dyn``: inv_mass, x0, goal, bu = u_t
        B^T, rhs_z, u_half, the (A, B scale) blocks ``ab`` of a
        dynamic_ab solve, then the schedule; rows [n, Dyn.size] for the
        states x0 [n, sdim] of a fleet (the shared entries repeated)."""
        lead = tuple(x0.shape[:-1]) if x0.dim() == 2 else ()
        useq = useq.to(torch.float32).reshape(*lead, self.tau, self.adim)
        rhs_z, u_half = self._action_terms(useq)

        def row(t):   # a shared entry, repeated a vehicle
            return t.expand(*lead, t.shape[-1])

        return torch.cat([
            row(inv_mass), x0.to(torch.float32).reshape(*lead, self.sdim),
            self._goal(cp, lead),
            (useq @ B.T).reshape(*lead, -1), rhs_z.reshape(*lead, -1),
            u_half.reshape(*lead, 1), *map(row, ab),
            *map(row, self._sched_tail())], dim=-1)

    def _template_args(self, mode: int) -> tuple:
        """<S, A, MODE, COST, AB, STRUCT> of pm_fused_solve_kernel."""
        c = self.consts
        return (self.sdim, self.adim, mode, COST_KINDS[c.cost_kind],
                int(self.dynamic_ab), STRUCTURES[c.structure])

    def _fused(self, dyn, seed, solve, z):
        return pm_fused_solve(self.consts, dyn, self.k, self.tau, seed=seed,
                              solve=solve, z=z)

    def _costs(self, dyn, seed, solve, z):
        return pm_fused_costs(self.consts, dyn, self.k, self.tau, seed=seed,
                              solve=solve, z=z)


class FusedLTIMPPI(FusedPointMassMPPI):
    """Fused solve for the identified linear model x' = A x + B u
    (``models/dmd.DMDModel``) with runtime (A, B): ``pack_dyn`` writes A
    and B scale into ``dyn`` from the model's live tensors on the device
    in every solve, and the kernel's ``kDynAB`` instantiation reads them
    from shared memory. A refit (``controller/dmd.py``, in place through
    ``MPPI.model_params``) is new data for the same kernel: no rebuild, no
    host sync, nothing cached from the (A, B) of construction time.

    Same cost domain and runtime variants as ``FusedPointMassMPPI``.
    Counterpart of the JAX package's ``FusedLTIMPPI``.
    """

    dynamic_ab = True

    def _check_model(self, model) -> None:
        from ..models.dmd import DMDModel

        if not isinstance(model, DMDModel):
            raise KernelUnsupportedError(
                "fused LTI kernel supports DMDModel only (PointMassModel "
                "uses FusedPointMassMPPI)")

    def pack_dyn(self, x0: torch.Tensor, useq: torch.Tensor,
                 cp=None) -> torch.Tensor:
        """``dyn`` with inv_mass = 1, bu = u_t B^T (the true B u_t) and the
        A and B scale blocks, all from the model's live (A, B)."""
        A = self.model.A.detach().to(torch.float32)
        B = self.model.B.detach().to(torch.float32)
        return self._pack(x0, useq, torch.ones_like(A[0, :1]), B,
                          [A.reshape(-1), (B @ self._scale).reshape(-1)], cp)
