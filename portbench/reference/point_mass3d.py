"""Plain reference of ``point_mass3d``: NicolayP/mppi-tf's point-mass model.

A frictionless mass on n_dof axes, the state interleaved [q0, v0, q1, v1,
...], driven by one force an axis. Over a step dt with the force held,
the exact update is

    q' = q + v dt + 0.5 (u / m) dt^2,   v' = v + (u / m) dt,

which is both the controller's model (at the configuration's dt) and the
plant (``plant``: substeps of the plant's dt). The state cost is
(x - g)^T Q (x - g) about the goal g, a cost parameter. Float64; imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .mppi import Controller


class Reference(Controller):
    """The configuration's model, state cost and plant on ``device``."""

    def __init__(self, config: dict, device):
        super().__init__(config, device)
        like = {"dtype": torch.float64, "device": self.device}
        self.dt = float(config["dt"])
        self.mass = float(config["model"]["mass"])
        self.n_dof = int(config["action_dim"])
        q = torch.tensor(config["cost"]["Q"], **like)
        self.Q = torch.diag(q) if config["cost"].get("diag") else q
        self.goal = torch.tensor(config["cost"]["goal"], **like)

    def _advance(self, x, u, dt: float):
        q, v = x[..., 0::2], x[..., 1::2]
        a = u[..., :self.n_dof] / self.mass
        q = q + v * dt + 0.5 * a * dt * dt
        v = v + a * dt
        return torch.stack([q, v], dim=-1).reshape(x.shape)

    def step(self, x, u):
        """The model: x [k, 6], u [k, 3] -> x' [k, 6] over dt."""
        return self._advance(x, u, self.dt)

    def plant(self, x, u, dt: float, substeps: int):
        """``substeps`` plant steps of ``dt`` with the force held."""
        for _ in range(substeps):
            x = self._advance(x, u, dt)
        return x

    def host_plant(self, x, u, dt: float, substeps: int):
        """``plant`` on the host, in numpy (a fleet's [n, 6], [n, 3])."""
        x = np.array(x, np.float64)
        a = np.asarray(u, np.float64)[..., :self.n_dof] / self.mass
        for _ in range(substeps):
            q, v = x[..., 0::2], x[..., 1::2]
            x[..., 0::2] = q + v * dt + 0.5 * a * dt * dt
            x[..., 1::2] = v + a * dt
        return x

    def state_cost(self, x, cp):
        d = x - cp["goal"]
        return torch.sum((d @ self.Q.T) * d, dim=-1)

    def static_params(self, goal=None) -> dict:
        """The state cost's parameters: the goal (default the
        configuration's)."""
        g = self.goal if goal is None else torch.as_tensor(
            goal, dtype=torch.float64, device=self.device)
        return {"goal": g}
