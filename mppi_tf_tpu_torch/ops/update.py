"""The MPPI update law as pure, individually-testable functions.

Information-theoretic MPPI (Williams et al.): given per-sample rollout costs
``S_k`` and the noise realisations ``eps_k`` that produced them, compute

    beta   = min_k S_k
    arg_k  = (S_k - beta)            (optionally / max_k (S_k - beta))
    w_k    = exp(-arg_k / lambda) / sum_j exp(-arg_j / lambda)
    U     += sum_k w_k * eps_k

The decomposition mirrors the reference's testable structure (reference:
scripts/src/controllers/controller_base.py:464-498). Shapes are flat:
costs ``[k]``, noise ``[k, tau, aDim]``. Single-device only: the
cross-device reductions are a later part of the port.
"""

from __future__ import annotations

import torch


def beta(costs: torch.Tensor) -> torch.Tensor:
    """Minimum cost over samples. costs: [k] -> scalar.

    Reference: controller_base.py:464-466.
    """
    return torch.min(costs, dim=0).values


def norm_arg(costs: torch.Tensor, beta_val: torch.Tensor,
             normalize: bool = False) -> torch.Tensor:
    """Shift costs by beta, optionally normalize by the max shifted cost.

    costs: [k] -> [k]. Reference: controller_base.py:468-474.
    """
    shifted = costs - beta_val
    if normalize:
        m = torch.max(shifted, dim=0).values
        # all-equal costs give m == 0; dividing would produce NaN weights
        # (with all costs equal the weights are uniform either way)
        m = torch.where(m > 0, m, torch.ones_like(m))
        shifted = shifted / m
    return shifted


def exp_arg(arg: torch.Tensor, lam) -> torch.Tensor:
    """Multiply by -1/lambda. [k] -> [k]. Reference: controller_base.py:476-478."""
    return (-1.0 / lam) * arg


def exp(arg: torch.Tensor) -> torch.Tensor:
    """Elementwise exponential. Reference: controller_base.py:480-482."""
    return torch.exp(arg)


def nabla(e: torch.Tensor) -> torch.Tensor:
    """Normalizer: sum over samples of the exponentiated costs. [k] -> scalar.

    Reference: controller_base.py:484-486.
    """
    return torch.sum(e, dim=0)


def weights(e: torch.Tensor, nabla_val: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax weights. [k], scalar -> [k].

    Reference: controller_base.py:488-490.
    """
    return e / nabla_val


def weighted_noise(w: torch.Tensor, noises: torch.Tensor) -> torch.Tensor:
    """Weight-averaged noise: sum_k w_k * eps_k.

    w: [k], noises: [k, tau, aDim] -> [tau, aDim].
    Reference: controller_base.py:492-498.
    """
    k = noises.shape[0]
    out = w @ noises.reshape(k, -1)
    return out.reshape(noises.shape[1:])


def mppi_update(costs: torch.Tensor, noises: torch.Tensor, lam,
                normalize: bool = False) -> torch.Tensor:
    """Full update chain beta -> arg -> exp -> nabla -> weights -> wnoise.

    costs: [k], noises: [k, tau, aDim] -> weighted noise [tau, aDim].
    Reference: controller_base.py:436-462.
    """
    b = beta(costs)
    arg = norm_arg(costs, b, normalize=normalize)
    e = exp(exp_arg(arg, lam))
    n = nabla(e)
    w = weights(e, n)
    return weighted_noise(w, noises)


def shift(useq: torch.Tensor, init: torch.Tensor,
          length: int = 1) -> torch.Tensor:
    """Receding-horizon shift: drop the first ``length`` actions, append init.

    useq: [tau, aDim], init: [length, aDim] -> [tau, aDim].
    Reference: controller_base.py:547-552.
    """
    return torch.cat([useq[length:], init], dim=0)


def get_next(useq: torch.Tensor, length: int = 1) -> torch.Tensor:
    """First ``length`` actions of the sequence. [tau, aDim] -> [length, aDim].

    Reference: controller_base.py:554-556.
    """
    return useq[:length]


def init_zeros(length: int, adim: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Zero-filled tail for the shifted sequence. Reference: controller_base.py:558-560."""
    return torch.zeros((length, adim), dtype=dtype, device=device)
