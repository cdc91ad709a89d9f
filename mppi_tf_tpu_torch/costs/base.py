"""Cost-function protocol and the information-theoretic action cost.

Reference: scripts/src/costs/cost_base.py. The action cost
(cost_base.py:114-170) is

    action_cost = 0.5 * ( gamma * (u^T S^-1 u  +  2 u^T S^-1 eps)
                          + lam * (1 - 1/upsilon) * (eps^T S^-1 eps) )

A cost is an ``nn.Module``; its mutable quantities (the goal) are buffers
named in ``param_names`` and updated in place, so a goal change never
rebuilds anything. Shapes: state [k, sDim], action [aDim] (the unperturbed
nominal action), noise [k, aDim]; costs return [k].
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class CostBase(nn.Module):
    """Abstract cost: running state cost + info-theoretic action cost."""

    #: buffers that are mutable controller state (checkpointed, set_goal)
    param_names: tuple = ()

    def __init__(self, lam: float, gamma: float, upsilon: float, sigma,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.lam = float(lam)
        self.gamma = float(gamma)
        self.upsilon = float(upsilon)
        sig = np.asarray(sigma, dtype=np.float64)
        if sig.ndim != 2 or sig.shape[0] != sig.shape[1]:
            raise AssertionError(
                "noise covariance must be a square [aDim, aDim] matrix")
        # inverted on the host in f64 once (cost_base.py:41)
        self.register_buffer("inv_sigma", torch.as_tensor(
            np.linalg.inv(sig), dtype=dtype, device=device))

    def params(self) -> dict:
        """The mutable cost parameters, by name (in sorted name order)."""
        return {n: getattr(self, n) for n in sorted(self.param_names)}

    def state_cost(self, state: torch.Tensor) -> torch.Tensor:
        """Running state cost q(x). state: [k, sDim] -> [k]."""
        raise NotImplementedError

    def action_cost(self, action: torch.Tensor, noise: torch.Tensor,
                    sched_scale=None) -> torch.Tensor:
        """Information-theoretic action cost. action: [aDim], noise: [k, aDim] -> [k].

        ``sched_scale``: the per-step noise-schedule factor c_t; the step's
        covariance is then Sigma_t = c_t * sigma, so Sigma_t^-1 = Sigma^-1 / c_t.
        Reference: cost_base.py:114-170.
        """
        inv_sig = self.inv_sigma
        if sched_scale is not None:
            inv_sig = inv_sig / sched_scale
        rhs_a = inv_sig @ action
        rhs_n = noise @ inv_sig.T
        a_cost = self.gamma * (action @ rhs_a)
        mix_cost = 2.0 * self.gamma * (noise @ rhs_a)
        n_cost = (self.lam * (1.0 - 1.0 / self.upsilon)) * torch.sum(
            noise * rhs_n, dim=-1)
        return 0.5 * (a_cost + mix_cost + n_cost)

    def step_cost(self, state: torch.Tensor, action: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
        """q(x) + action_cost. Reference: cost_base.py:43-77."""
        return self.state_cost(state) + self.action_cost(action, noise)

    def final_cost(self, state: torch.Tensor) -> torch.Tensor:
        """Terminal cost phi(x): the state cost. Reference: cost_base.py:98-112."""
        return self.state_cost(state)

    def set_goal(self, goal) -> None:
        """Update the goal in place."""
        raise NotImplementedError

    def sync_host(self) -> None:
        """Bring any host-side copy of the params up to date after their
        buffers were written directly (a checkpoint, interop); the static
        costs keep none."""

    @property
    def dtype(self) -> torch.dtype:
        return self.inv_sigma.dtype
