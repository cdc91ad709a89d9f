"""Point-mass double-integrator LTI model.

Reference: scripts/src/models/point_mass_model.py. Dynamics
x' = A x + (B / mass) u with per-DoF blocks

    A = [[1, dt], [0, 1]]        B = [[dt^2 / 2], [dt]]

assembled block-diagonally over stateDim/2 DoFs; the state is interleaved
[q0, v0, q1, v1, ...]. The mass is the single trainable parameter.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.blockdiag import block_diag
from .base import ModelBase


class PointMassModel(ModelBase):
    """LTI double integrator with trainable mass."""

    def __init__(self, mass: float = 1.0, dt: float = 0.1, state_dim: int = 2,
                 action_dim: int = 1, act_max=None, act_min=None,
                 name: str = "point_mass", dtype=torch.float32, device=None):
        if state_dim != 2 * action_dim:
            raise ValueError(
                f"point-mass expects state_dim == 2*action_dim, got "
                f"{state_dim}/{action_dim}")
        super().__init__(state_dim, action_dim, dt=dt, name=name,
                         act_max=act_max, act_min=act_min, dtype=dtype,
                         device=device)
        self.mass = nn.Parameter(
            torch.tensor(float(mass), dtype=dtype, device=device))
        self._configured = {"mass": float(mass)}
        a = np.array([[1.0, dt], [0.0, 1.0]])
        b = np.array([[dt * dt / 2.0], [dt]])
        self.register_buffer("A", torch.as_tensor(
            block_diag(a, state_dim // 2), dtype=dtype, device=device))
        self.register_buffer("B", torch.as_tensor(
            block_diag(b, action_dim), dtype=dtype, device=device))

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """x_next = A x + (B / mass) u, batched over the leading axis.

        Reference: point_mass_model.py:66-125.
        """
        return x @ self.A.T + (u @ self.B.T) / self.mass
