"""Exploration-noise generation for MPPI rollouts.

The reference draws standard normals of shape [k, tau, aDim] and scales them
by the matrix ``upsilon * sigma`` (reference:
scripts/src/controllers/controller_base.py:348-369). ``sigma`` is a *scale
matrix* multiplying standard normals, not a covariance square root.

Random numbers come from an explicit ``torch.Generator`` on the noise's
device; a generator's stream differs from JAX's, so parity tests inject
noise as data.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_noise_schedule(spec, tau: int):
    """Resolve a noise-schedule spec to a ``[tau]`` float64 array (or None).

    The schedule is a per-step positive scalar ``c_t`` multiplying the noise
    scale matrix: step t draws ``eps_t = c_t * (upsilon * sigma) @ z_t`` and
    the action cost uses the matching ``Sigma_t = c_t * sigma``.

    Accepted specs:
        None                                        -> None (constant sigma)
        [c_0, ..., c_{tau-1}] (list/array)          -> as given
        {"type": "constant", "value": v}            -> v everywhere
        {"type": "linear", "start": s, "end": e}    -> linspace(s, e, tau)
        {"type": "exp", "start": s, "end": e}       -> geomspace(s, e, tau)
        {"type": "cosine", "start": s, "end": e}    -> cosine anneal s -> e
    """
    if spec is None:
        return None
    if isinstance(spec, dict):
        kind = spec.get("type")
        if kind == "constant":
            out = np.full(tau, float(spec["value"]), np.float64)
        elif kind == "linear":
            out = np.linspace(float(spec["start"]), float(spec["end"]), tau)
        elif kind == "exp":
            out = np.geomspace(float(spec["start"]), float(spec["end"]), tau)
        elif kind == "cosine":
            s, e = float(spec["start"]), float(spec["end"])
            t = np.linspace(0.0, np.pi, tau)
            out = e + 0.5 * (s - e) * (1.0 + np.cos(t))
        else:
            raise ValueError(
                f"unknown noise_schedule type {kind!r}; valid: constant, "
                "linear, exp, cosine, or an explicit [tau] array")
    else:
        out = np.asarray(spec, np.float64).reshape(-1)
        if out.shape != (tau,):
            raise ValueError(
                f"explicit noise_schedule must have length tau={tau}, "
                f"got {out.shape}")
    if not np.all(out > 0.0):
        raise ValueError("noise_schedule entries must be positive "
                         "(sigma_t = c_t * sigma must stay a valid scale)")
    return out


def scale_noise(z: torch.Tensor, sigma: torch.Tensor, upsilon=1.0,
                schedule=None) -> torch.Tensor:
    """Scale standard normals by the matrix ``upsilon * sigma``.

    z: [k, tau, aDim]; sigma: [aDim, aDim]. Returns eps with
    eps[k, t] = (upsilon * sigma) @ z[k, t], times c_t when a [tau]
    ``schedule`` is given. Reference: controller_base.py:368.
    """
    eps = z @ (upsilon * sigma).T
    if schedule is not None:
        eps = eps * torch.as_tensor(schedule, dtype=eps.dtype,
                                    device=eps.device)[None, :, None]
    return eps


def sample_noise(generator: torch.Generator, k: int, tau: int, adim: int,
                 sigma: torch.Tensor, upsilon=1.0, dtype=torch.float32,
                 schedule=None) -> torch.Tensor:
    """Draw eps = (upsilon * sigma) @ N(0, I) of shape [k, tau, aDim] on
    ``generator``'s device. Reference: controller_base.py:348-369."""
    z = torch.randn((k, tau, adim), generator=generator, dtype=dtype,
                    device=generator.device)
    return scale_noise(z, sigma.to(dtype), upsilon, schedule=schedule)


def sample_noise_antithetic(generator: torch.Generator, k: int, tau: int,
                            adim: int, sigma: torch.Tensor, upsilon=1.0,
                            dtype=torch.float32,
                            schedule=None) -> torch.Tensor:
    """Antithetic variant of :func:`sample_noise`: draws half = ceil(k/2)
    sequences and mirrors them, eps[half + i] = -eps[i] for i < k - half."""
    half = (k + 1) // 2
    z = torch.randn((half, tau, adim), generator=generator, dtype=dtype,
                    device=generator.device)
    z = torch.cat([z, -z], dim=0)[:k]
    return scale_noise(z, sigma.to(dtype), upsilon, schedule=schedule)
