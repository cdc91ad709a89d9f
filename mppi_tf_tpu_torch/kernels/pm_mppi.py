"""Fused point-mass MPPI solve on Hopper: three CUDA kernels and their plain
PyTorch versions.

Replaces the Pallas kernels of ``mppi_tf_tpu/kernels/pm_mppi.py``:

- ``pm_fused_solve`` replaces ``fused_pm_call`` (``_make_kernel`` in mode
  "fused" with the in-kernel noise of ``_fill_noise``): one thread per
  sample rolls x' = A x + (1/m)(B u_t + B scale z_t) over the horizon with
  the state in registers, sums the cost
  sum_t [q(x_{t+1}) + rhs_z_t . z_t + nc_half z_t^T Mz z_t] + phi(x_H) + u_half,
  then each block writes its softmax partial (m_b, l_b, cost min/max/sum,
  zsum_b = sum_k w_k z_k) to a scratch row;
- ``pm_merge`` merges the per-block partials with the shard-merge algebra
  of ``mppi_tf_tpu/parallel/fused.py`` (m = max m_b, f_b = exp(m_b - m),
  l = sum f_b l_b, zsum = sum f_b zsum_b);
- ``pm_noise_dump`` replaces ``fused_noise_dump``: it writes the exact
  normals the solve consumes, for the statistics check and for tests.

The noise is a counter-based stream fixed element by element, so the
plain version reproduces it: normal n = t*adim + j of sample k in solve s
is lane (n mod 4) of Philox4x32-10(counter=(k, n div 4, s_lo, s_hi),
key=(seed_lo, seed_hi)); lanes (0, 1) and (2, 3) each form one Box-Muller
pair, u = ((bits >> 9) + 0.5) * 2^-23, z_a = sqrt(-2 ln u_a) cos(2 pi u_b),
z_b = sqrt(-2 ln u_a) sin(2 pi u_b). (23 bits, not 24: with 24 bits the
top uniforms round to 1.0 in f32; with 23 every u is exact in f32 and lies
in [2^-24, 1 - 2^-24], so the tail is clipped at 5.77 sigma as on the TPU.)

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Each launch adds one to
``launch_counts[name]``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .errors import KernelLaunchError, KernelUnsupportedError

NEG_INF = float("-inf")
#: samples (threads) per block of the fused solve
BLOCK = 256
#: leading stats slots of a partial row: (m, l, cost min, max, sum, pad x3)
STATS = 8
#: (state dim, action dim) pairs the CUDA kernel is instantiated for
SUPPORTED_DIMS = ((6, 3), (2, 1), (4, 2))

launch_counts = {"pm_noise_dump": 0, "pm_fused_solve": 0, "pm_merge": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class Dyn:
    """Layout of the per-solve parameter array ``dyn`` (the JAX package's
    ``_Dyn`` without its DMD and schedule blocks), staged into shared memory
    by the kernel."""

    def __init__(self, tau: int, sdim: int, adim: int):
        self.inv_mass = 0                      # 1
        self.x0 = 1                            # sdim
        self.goal = 1 + sdim                   # sdim
        self.bu = 1 + 2 * sdim                 # tau*sdim: B u_t (mass-free)
        self.rhs_z = self.bu + tau * sdim      # tau*adim
        self.u_half = self.rhs_z + tau * adim  # 1: summed pure-action cost
        self.size = self.u_half + 1


@dataclass
class PmConsts:
    """Solve constants: A (sdim x sdim), Bs = B @ scale (sdim x adim, mass
    free), Q (sdim x sdim), Mz = scale^T Sigma^-1 scale (adim x adim), lam,
    nc_half = lam (1 - 1/upsilon) / 2."""

    A: np.ndarray
    Bs: np.ndarray
    Q: np.ndarray
    Mz: np.ndarray
    lam: float
    nc_half: float

    @property
    def dims(self):
        return self.Bs.shape

    @functools.cached_property
    def packed(self) -> np.ndarray:
        """f32 host array in the C struct's order: A, Bs, Q, Mz, lam, nc_half."""
        return np.ascontiguousarray(np.concatenate([
            self.A.ravel(), self.Bs.ravel(), self.Q.ravel(), self.Mz.ravel(),
            [self.lam, self.nc_half]]).astype(np.float32))


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


def _split64(v: int):
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v & _MASK32, v >> 32


def noise_plain(seed: int, solve: int, k: int, tau: int, adim: int,
                device=None) -> torch.Tensor:
    """The in-kernel noise stream of one solve: z f32 [tau, adim, k]."""
    n_z = tau * adim
    nb = -(-n_z // 4)
    s_lo, s_hi = _split64(solve)
    seed_lo, seed_hi = _split64(seed)
    kk = torch.arange(k, dtype=torch.int64, device=device)
    bb = torch.arange(nb, dtype=torch.int64, device=device)
    ctr = torch.stack(torch.broadcast_tensors(
        kk[None, :], bb[:, None],
        torch.tensor(s_lo, device=device), torch.tensor(s_hi, device=device)),
        dim=-1)                                         # [nb, k, 4]
    key = torch.tensor([seed_lo, seed_hi], dtype=torch.int64, device=device)
    z = box_muller(philox4x32_10(ctr, key))             # [nb, k, 4]
    z = z.permute(0, 2, 1).reshape(nb * 4, k)[:n_z]
    return z.reshape(tau, adim, k).contiguous()


def sample_costs_plain(consts: PmConsts, dyn: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """Per-sample rollout costs [k] in the kernel's folded algebra: the
    rollout_costs of the point-mass model and static cost over
    eps = scale @ z, with B scale, Sigma^-1 and u folded into dyn."""
    tau, adim, k = z.shape
    sdim = consts.A.shape[0]
    lay = Dyn(tau, sdim, adim)

    def t_(a):
        return torch.as_tensor(a, dtype=dyn.dtype, device=dyn.device)

    A, Bs, Q, Mz = t_(consts.A), t_(consts.Bs), t_(consts.Q), t_(consts.Mz)
    inv_m = dyn[lay.inv_mass]
    goal = dyn[lay.goal:lay.goal + sdim]
    bu = dyn[lay.bu:lay.rhs_z].reshape(tau, sdim)
    rhs_z = dyn[lay.rhs_z:lay.u_half].reshape(tau, adim)

    def q(x):
        d = x - goal
        return torch.sum((d @ Q.T) * d, dim=-1)

    x = dyn[lay.x0:lay.x0 + sdim].expand(k, sdim)
    cost = torch.zeros(k, dtype=dyn.dtype, device=dyn.device)
    for t in range(tau):
        zt = z[t].T                                     # [k, adim]
        x = x @ A.T + inv_m * (bu[t] + zt @ Bs.T)
        cost = (cost + q(x) + zt @ rhs_z[t]
                + consts.nc_half * torch.sum((zt @ Mz.T) * zt, dim=-1))
    return cost + q(x) + dyn[lay.u_half]


def block_partials(costs: torch.Tensor, zf: torch.Tensor, lam: float,
                   block: int = BLOCK) -> torch.Tensor:
    """Per-block online-softmax partials of -cost/lam.

    costs [k], zf [n_z, k] -> [n_blocks, STATS + n_z] rows
    (m_b, l_b, cmin_b, cmax_b, csum_b, 0, 0, 0, zsum_b). Padding samples
    carry the -inf sentinel and weigh exactly 0.
    """
    n_z, k = zf.shape
    nb = -(-k // block)
    pad = nb * block - k
    valid = (torch.arange(nb * block, device=costs.device) < k).reshape(
        nb, block)
    c = torch.nn.functional.pad(costs, (0, pad)).reshape(nb, block)
    zarg = torch.where(valid, -c / lam, NEG_INF)
    m = zarg.max(dim=1).values
    w = torch.where(valid, torch.exp(zarg - m[:, None]), 0.0)
    zb = torch.nn.functional.pad(zf, (0, pad)).reshape(n_z, nb, block)
    stats = torch.stack([
        m, w.sum(dim=1),
        torch.where(valid, c, float("inf")).min(dim=1).values,
        torch.where(valid, c, NEG_INF).max(dim=1).values,
        torch.where(valid, c, 0.0).sum(dim=1)], dim=1)
    return torch.cat([stats, stats.new_zeros(nb, STATS - 5),
                      torch.einsum("bk,nbk->bn", w, zb)], dim=1)


def fused_solve_plain(consts: PmConsts, dyn: torch.Tensor, k: int, tau: int,
                      seed: int = 0, solve: int = 0, z=None,
                      block: int = BLOCK) -> torch.Tensor:
    """Plain version of ``pm_fused_solve``: per-block partials
    [n_blocks, STATS + tau*adim]."""
    adim = consts.Bs.shape[1]
    if z is None:
        z = noise_plain(seed, solve, k, tau, adim, device=dyn.device)
    costs = sample_costs_plain(consts, dyn, z)
    return block_partials(costs, z.reshape(tau * adim, k), consts.lam, block)


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

def _on_card(*tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors if t is not None}) != 1:
            raise ValueError("all tensors must be on the same CUDA device")
        return True
    raise ValueError(f"tensors must all be on the CPU or all on one CUDA "
                     f"device, got {sorted(kinds)}")


def _check(t: torch.Tensor, name: str, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, *args) -> None:
    from . import _build

    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise KernelLaunchError(f"{name} failed: {_build.error_string(rc)}")
    launch_counts[name] += 1


def pm_noise_dump(seed: int, solve: int, k: int, tau: int, adim: int,
                  device) -> torch.Tensor:
    """The exact normals of solve ``solve`` at ``seed``: z f32 [tau, adim, k]."""
    device = torch.device(device)
    if device.type == "cpu":
        return noise_plain(seed, solve, k, tau, adim)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((tau, adim, k), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        _launch("pm_noise_dump", out.data_ptr(), k, tau * adim,
                *_split64(seed), *_split64(solve))
    return out


def pm_fused_solve(consts: PmConsts, dyn: torch.Tensor, k: int, tau: int,
                   seed: int = 0, solve: int = 0, z=None) -> torch.Tensor:
    """Fused rollout + block softmax partials [n_blocks, STATS + tau*adim].

    ``z`` (f32 [tau, adim, k]) injects the normals in place of the
    in-kernel Philox stream of (seed, solve)."""
    sdim, adim = consts.dims
    if not _on_card(dyn, z):
        return fused_solve_plain(consts, dyn, k, tau, seed, solve, z)
    if (sdim, adim) not in SUPPORTED_DIMS:
        raise KernelUnsupportedError(
            f"pm_fused_solve is built for (sdim, adim) in {SUPPORTED_DIMS}, "
            f"got {(sdim, adim)}")
    _check(dyn, "dyn", (Dyn(tau, sdim, adim).size,))
    if z is not None:
        _check(z, "z", (tau, adim, k))
    nb = -(-k // BLOCK)
    partials = torch.empty((nb, STATS + tau * adim), dtype=torch.float32,
                           device=dyn.device)
    with torch.cuda.device(dyn.device):
        _launch("pm_fused_solve", sdim, adim, consts.packed.ctypes.data,
                dyn.data_ptr(), None if z is None else z.data_ptr(),
                partials.data_ptr(), k, tau, *_split64(seed),
                *_split64(solve))
    return partials


def pm_merge(partials: torch.Tensor):
    """Merge block partials -> (zsum [n_z], stats [8]); see ``merge_plain``."""
    if not _on_card(partials):
        return merge_plain(partials)
    nb, width = partials.shape
    _check(partials, "partials", (nb, width))
    n_z = width - STATS
    zsum = torch.empty(n_z, dtype=torch.float32, device=partials.device)
    stats = torch.empty(STATS, dtype=torch.float32, device=partials.device)
    with torch.cuda.device(partials.device):
        _launch("pm_merge", partials.data_ptr(), nb, n_z, zsum.data_ptr(),
                stats.data_ptr())
    return zsum, stats


# ---------------------------------------------------------------------------
# solve object: host glue around the kernels
# ---------------------------------------------------------------------------

class FusedPointMassMPPI:
    """Fused solve for MPPI over PointMassModel + StaticCost: packs the
    per-solve ``dyn`` array, runs ``pm_fused_solve`` + ``pm_merge`` and
    un-folds the weighted normals to action units. The host glue is torch
    ops on the model's device, with no host sync.

    Counterpart of the JAX package's ``FusedPointMassMPPI`` without its
    DMD, ellipse, waypoint, schedule, antithetic and bf16 variants.
    """

    def __init__(self, model, cost, k: int, tau: int, lam: float,
                 upsilon: float, sigma):
        from ..costs.static import StaticCost
        from ..models.point_mass import PointMassModel

        if not isinstance(model, PointMassModel):
            raise KernelUnsupportedError(
                "fused kernel supports PointMassModel only")
        if type(cost) is not StaticCost:
            raise KernelUnsupportedError(
                "fused kernel supports StaticCost only (other costs: "
                "ROADMAP queue-2 item 4)")
        if model.dtype != torch.float32:
            raise KernelUnsupportedError(
                f"fused kernel is float32, model is {model.dtype}")
        dims = (model.get_state_dim(), model.get_action_dim())
        if model.device.type == "cuda" and dims not in SUPPORTED_DIMS:
            raise KernelUnsupportedError(
                f"the CUDA kernel is built for (sdim, adim) in "
                f"{SUPPORTED_DIMS}, got {dims}")
        self.model, self.cost = model, cost
        self.k, self.tau = int(k), int(tau)
        self.sdim, self.adim = model.get_state_dim(), model.get_action_dim()
        self.lam, self.upsilon = float(lam), float(upsilon)
        self.gamma = float(cost.gamma)
        sigma = np.asarray(sigma, np.float64)
        scale = self.upsilon * sigma
        inv_sigma = np.linalg.inv(sigma)
        B = model.B.detach().cpu().numpy().astype(np.float64)
        self.consts = PmConsts(
            A=model.A.detach().cpu().numpy().astype(np.float64),
            Bs=B @ scale,
            Q=cost.Q.detach().cpu().numpy().astype(np.float64),
            Mz=scale.T @ inv_sigma @ scale,
            lam=self.lam,
            nc_half=0.5 * self.lam * (1.0 - 1.0 / self.upsilon))
        dev = model.device

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        self._B, self._scale, self._inv_sigma = f32(B), f32(scale), f32(
            inv_sigma)

    def pack_dyn(self, x0: torch.Tensor, useq: torch.Tensor) -> torch.Tensor:
        """The per-solve ``dyn`` array (f32 [Dyn.size]) from the state, the
        nominal sequence and the live mass and goal."""
        useq = useq.to(torch.float32).reshape(self.tau, self.adim)
        bu = useq @ self._B.T
        rhs_z = (self.gamma * (useq @ self._inv_sigma.T)) @ self._scale
        u_half = 0.5 * self.gamma * torch.einsum(
            "ti,ij,tj->", useq, self._inv_sigma, useq)
        return torch.cat([
            (1.0 / self.model.mass.detach()).to(torch.float32).reshape(1),
            x0.to(torch.float32).reshape(self.sdim),
            self.cost.goal.to(torch.float32),
            bu.reshape(-1), rhs_z.reshape(-1), u_half.reshape(1)])

    def unfold_wnoise(self, zsum: torch.Tensor) -> torch.Tensor:
        """Weighted standard-normal sums [tau*adim] -> action units
        [tau, adim]: wnoise_t = scale @ zsum_t."""
        return zsum.reshape(self.tau, self.adim) @ self._scale.T

    def solve(self, x0, useq, seed: int = 0, solve: int = 0, z=None):
        """One MPPI solve -> (wnoise [tau, adim], info)."""
        dyn = self.pack_dyn(x0, useq)
        partials = pm_fused_solve(self.consts, dyn, self.k, self.tau,
                                  seed=seed, solve=solve, z=z)
        zsum, stats = pm_merge(partials)
        l = stats[1]
        info = {"cost_min": stats[2], "cost_max": stats[3],
                "cost_mean": stats[4] / self.k, "nabla": l}
        return self.unfold_wnoise(zsum) / l, info
