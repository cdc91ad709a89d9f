"""Static (fixed-goal) quadratic cost (reference: scripts/src/costs/static_cost.py:6-70)."""

from __future__ import annotations

import numpy as np
import torch

from .base import CostBase


class StaticCost(CostBase):
    """Quadratic goal-tracking cost (x - g)^T Q (x - g).

    ``diag=True`` expands a vector Q into a diagonal matrix
    (static_cost.py:25-26). The goal is a buffer updated in place.
    """

    param_names = ("goal",)

    def __init__(self, lam, gamma, upsilon, sigma, goal, Q, diag=False,
                 dtype=torch.float32, device=None):
        super().__init__(lam, gamma, upsilon, sigma, dtype=dtype,
                         device=device)
        Qm = np.asarray(Q, dtype=np.float64)
        if diag:
            Qm = np.diag(Qm)
        goal = np.asarray(goal, dtype=np.float64).reshape(-1)
        if goal.shape[0] != Qm.shape[0]:
            raise AssertionError(
                f"goal shape {goal.shape} incompatible with Q {Qm.shape}")
        self.register_buffer("Q", torch.as_tensor(Qm, dtype=dtype,
                                                  device=device))
        self.register_buffer("goal", torch.as_tensor(goal, dtype=dtype,
                                                     device=device))

    def set_goal(self, goal) -> None:
        goal = torch.as_tensor(np.asarray(goal, np.float64).reshape(-1),
                               dtype=self.goal.dtype)
        if goal.shape != self.goal.shape:
            raise ValueError(
                f"goal must have shape {tuple(self.goal.shape)}, got "
                f"{tuple(goal.shape)}")
        self.goal.copy_(goal)

    def state_cost(self, state: torch.Tensor) -> torch.Tensor:
        """(x-g)^T Q (x-g), batched. Reference: static_cost.py:40-63."""
        diff = state - self.goal[None, :]
        return torch.sum((diff @ self.Q.T) * diff, dim=-1)

    def dist(self, state: torch.Tensor) -> torch.Tensor:
        """Reference: static_cost.py:69-70."""
        return state - self.goal
