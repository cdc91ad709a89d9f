"""The MPPI update law as pure, individually-testable functions.

Information-theoretic MPPI (Williams et al.): given per-sample rollout costs
``S_k`` and the noise realisations ``eps_k`` that produced them, compute

    beta   = min_k S_k
    arg_k  = (S_k - beta)            (optionally / max_k (S_k - beta))
    w_k    = exp(-arg_k / lambda) / sum_j exp(-arg_j / lambda)
    U     += sum_k w_k * eps_k

The decomposition mirrors the reference's testable structure (reference:
scripts/src/controllers/controller_base.py:464-498). Shapes are flat:
costs ``[k]``, noise ``[k, tau, aDim]``.

Every reduction optionally takes a ``mesh`` (``parallel/mesh.Mesh``), the
counterpart of the JAX package's ``axis_name``: its per-sample arguments
are then lists of per-shard tensors (one a local shard), the local partial
reductions are combined with the mesh's ``pmin`` / ``pmax`` / ``psum``,
and a per-sample result is a list again. Without a mesh they are the
single-device reductions, bit for bit as before.
"""

from __future__ import annotations

import torch


def beta(costs, mesh=None) -> torch.Tensor:
    """Minimum cost over samples. costs: [k] -> scalar.

    Reference: controller_base.py:464-466.
    """
    if mesh is not None:
        return mesh.pmin([torch.min(c, dim=0).values for c in costs])
    return torch.min(costs, dim=0).values


def norm_arg(costs, beta_val: torch.Tensor, normalize: bool = False,
             mesh=None):
    """Shift costs by beta, optionally normalize by the max shifted cost.

    costs: [k] -> [k]. Reference: controller_base.py:468-474.
    """
    if mesh is not None:
        shifted = [c - beta_val.to(c.device) for c in costs]
        if normalize:
            m = mesh.pmax([torch.max(s, dim=0).values for s in shifted])
            m = torch.where(m > 0, m, torch.ones_like(m))
            shifted = [s / m.to(s.device) for s in shifted]
        return shifted
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


def nabla(e, mesh=None) -> torch.Tensor:
    """Normalizer: sum over samples of the exponentiated costs. [k] -> scalar.

    Reference: controller_base.py:484-486. Under a mesh this is the psum
    that makes the softmax global across shards.
    """
    if mesh is not None:
        return mesh.psum([torch.sum(x, dim=0) for x in e])
    return torch.sum(e, dim=0)


def weights(e: torch.Tensor, nabla_val: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax weights. [k], scalar -> [k].

    Reference: controller_base.py:488-490.
    """
    return e / nabla_val


def weighted_noise(w, noises, mesh=None) -> torch.Tensor:
    """Weight-averaged noise: sum_k w_k * eps_k.

    w: [k], noises: [k, tau, aDim] -> [tau, aDim].
    Reference: controller_base.py:492-498.
    """
    if mesh is not None:
        return mesh.psum([weighted_noise(wi, ni)
                          for wi, ni in zip(w, noises)])
    k = noises.shape[0]
    out = w @ noises.reshape(k, -1)
    return out.reshape(noises.shape[1:])


def mppi_update(costs, noises, lam, normalize: bool = False,
                mesh=None) -> torch.Tensor:
    """Full update chain beta -> arg -> exp -> nabla -> weights -> wnoise.

    costs: [k], noises: [k, tau, aDim] -> weighted noise [tau, aDim].
    Reference: controller_base.py:436-462. Under a mesh the four
    collectives of the law: pmin beta, pmax normalizer, psum nabla and
    psum weighted noise.
    """
    if mesh is not None:
        b = beta(costs, mesh)
        arg = norm_arg(costs, b, normalize=normalize, mesh=mesh)
        e = [exp(exp_arg(a, lam)) for a in arg]
        n = nabla(e, mesh)
        w = [weights(x, n.to(x.device)) for x in e]
        return weighted_noise(w, noises, mesh)
    b = beta(costs)
    arg = norm_arg(costs, b, normalize=normalize)
    e = exp(exp_arg(arg, lam))
    n = nabla(e)
    w = weights(e, n)
    return weighted_noise(w, noises)


def shift(useq: torch.Tensor, init: torch.Tensor,
          length: int = 1) -> torch.Tensor:
    """Receding-horizon shift: drop the first ``length`` actions, append init.

    useq: [tau, aDim], init: [length, aDim] -> [tau, aDim]; a fleet's
    leading vehicle axis [n, tau, aDim] carries through (init repeated).
    Reference: controller_base.py:547-552.
    """
    init = init.expand(*useq.shape[:-2], *init.shape[-2:])
    return torch.cat([useq[..., length:, :], init], dim=-2)


def get_next(useq: torch.Tensor, length: int = 1) -> torch.Tensor:
    """First ``length`` actions of the sequence. [tau, aDim] -> [length, aDim]
    (a fleet's [n, tau, aDim] -> [n, length, aDim]).

    Reference: controller_base.py:554-556.
    """
    return useq[..., :length, :]


def init_zeros(length: int, adim: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Zero-filled tail for the shifted sequence. Reference: controller_base.py:558-560."""
    return torch.zeros((length, adim), dtype=dtype, device=device)
