"""Static (fixed-goal) quadratic costs (reference:
scripts/src/costs/static_cost.py): ``StaticCost`` on the raw state and
``StaticQuatCost`` on the AUV's 10-dim pose/attitude/velocity error."""

from __future__ import annotations

import numpy as np
import torch

from .base import CostBase


def _copy_goal(buf: torch.Tensor, goal) -> None:
    """Write ``goal`` into the goal buffer in place (shape checked)."""
    goal = torch.as_tensor(np.asarray(goal, np.float64).reshape(-1),
                           dtype=buf.dtype)
    if goal.shape != buf.shape:
        raise ValueError(
            f"goal must have shape {tuple(buf.shape)}, got "
            f"{tuple(goal.shape)}")
    buf.copy_(goal)


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
        _copy_goal(self.goal, goal)

    def state_cost(self, state: torch.Tensor) -> torch.Tensor:
        """(x-g)^T Q (x-g), batched. Reference: static_cost.py:40-63."""
        diff = state - self.goal[None, :]
        return torch.sum((diff @ self.Q.T) * diff, dim=-1)

    def dist(self, state: torch.Tensor) -> torch.Tensor:
        """Reference: static_cost.py:69-70."""
        return state - self.goal


class StaticQuatCost(CostBase):
    """Quadratic cost for the 13-dim quaternion AUV state.

    The error is 10-dim: [position error (3), 2 acos(<q, q_goal>) (1),
    velocity error (6)], scored against a 10x10 Q. The dot product is the
    signed one of the reference, clamped to [-1, 1]. The goal is a buffer
    updated in place. Reference: static_cost.py:73-159.
    """

    STATE_DIM = 13
    param_names = ("goal",)

    def __init__(self, lam, gamma, upsilon, sigma, goal, Q, diag=False,
                 dtype=torch.float32, device=None):
        super().__init__(lam, gamma, upsilon, sigma, dtype=dtype,
                         device=device)
        Qm = np.asarray(Q, dtype=np.float64)
        if diag:
            Qm = np.diag(Qm)
        if Qm.shape != (10, 10):
            raise AssertionError(f"Q must be [10, 10], got {Qm.shape}")
        goal = np.asarray(goal, dtype=np.float64).reshape(-1)
        if goal.shape[0] != self.STATE_DIM:
            raise AssertionError(f"goal must be [13], got {goal.shape}")
        self.register_buffer("Q", torch.as_tensor(Qm, dtype=dtype,
                                                  device=device))
        self.register_buffer("goal", torch.as_tensor(goal, dtype=dtype,
                                                     device=device))

    def set_goal(self, goal) -> None:
        _copy_goal(self.goal, goal)

    def dist(self, state: torch.Tensor) -> torch.Tensor:
        """10-dim error [pos, angle, vel]. Reference: static_cost.py:145-159."""
        goal = self.goal
        dot = torch.clamp(state[:, 3:7] @ goal[3:7], -1.0, 1.0)
        return torch.cat([state[:, :3] - goal[None, :3],
                          2.0 * torch.acos(dot)[:, None],
                          state[:, 7:13] - goal[None, 7:13]], dim=-1)

    def state_cost(self, state: torch.Tensor) -> torch.Tensor:
        """d^T Q d on the 10-dim error. Reference: static_cost.py:116-139."""
        diff = self.dist(state)
        return torch.sum((diff @ self.Q.T) * diff, dim=-1)
