"""The controller's exploration normals, regenerated from their definition.

The program draws its normals inside its kernels from a counter-based
stream, fixed element by element, so a reference can draw the same ones
from the seed, the solve index and the sample alone: normal n = t * adim + j
of sample k in solve s is lane (n mod 4) of

    Philox4x32-10(counter = (k, n div 4, s_lo, s_hi), key = (seed_lo, seed_hi))

(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011),
and lanes (0, 1) and (2, 3) each form one Box-Muller pair from 23-bit
uniforms u = ((bits >> 9) + 0.5) 2^-23:

    z_a = sqrt(-2 ln u_a) cos(2 pi u_b),  z_b = sqrt(-2 ln u_a) sin(2 pi u_b).

A fleet's vehicle v at fleet step s draws solve s * n + v. This module is a
frozen copy of that definition, computed in float64 with int64 tensors
holding the 32-bit words; it imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def split64(v: int) -> tuple:
    """(low, high) 32-bit words of a 64-bit seed or solve index."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v & _MASK32, v >> 32


def index_tensor(solve: int, device=None) -> torch.Tensor:
    """A 64-bit solve index as a one-element int64 tensor (same bits)."""
    v = int(solve) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([v - (1 << 64) if v >> 63 else v],
                        dtype=torch.int64, device=device)


def _mulhilo(a: int, b: torch.Tensor) -> tuple:
    """(hi, lo) 32-bit halves of a * b (a, b unsigned 32-bit, b in int64),
    in 16-bit pieces so that no product leaves int64."""
    t = a * (b & 0xFFFF)
    u = a * (b >> 16)
    mid = ((u & 0xFFFF) << 16) + t
    return (u >> 16) + (mid >> 32), mid & _MASK32


def philox(c0, c1, c2, c3, k0: int, k1: int) -> tuple:
    """Philox4x32-10 over int64 tensors of counter words -> 4 words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def normals(seed: int, solve, k: int, tau: int, adim: int,
            device=None) -> torch.Tensor:
    """The standard normals of one solve: float64 [k, tau, adim]. The
    solve index is an int or a one-element int64 tensor on ``device``
    (what a captured graph reads at each replay)."""
    n_z = tau * adim
    nb = -(-n_z // 4)
    if not isinstance(solve, torch.Tensor):
        solve = index_tensor(solve, device)
    s_lo, s_hi = solve & _MASK32, (solve >> 32) & _MASK32
    k_lo, k_hi = split64(seed)
    kk = torch.arange(k, dtype=torch.int64, device=device)[None, :]
    bb = torch.arange(nb, dtype=torch.int64, device=device)[:, None]
    c0 = kk.expand(nb, k)
    c1 = bb.expand(nb, k)
    c2 = s_lo.expand(nb, k)
    c3 = s_hi.expand(nb, k)
    words = philox(c0, c1, c2, c3, k_lo, k_hi)
    u = [((w >> 9).to(torch.float64) + 0.5) * 2.0 ** -23 for w in words]
    lanes = []
    for ua, ub in ((u[0], u[1]), (u[2], u[3])):
        r = torch.sqrt(-2.0 * torch.log(ua))
        th = (2.0 * math.pi) * ub
        lanes += [r * torch.cos(th), r * torch.sin(th)]
    z = torch.stack(lanes, dim=1)                  # [nb, 4, k]
    z = z.reshape(nb * 4, k)[:n_z]                 # normal n = 4 b + lane
    return z.T.reshape(k, tau, adim).contiguous()
