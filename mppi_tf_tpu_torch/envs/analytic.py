"""Analytic plants for the closed loop (no MuJoCo dependency).

- ``PointMassEnv`` (numpy): an exact plant independent of the model code,
  a point mass on N frictionless slide joints driven by per-axis forces,
  with the exact double-integrator update over dt (what RK4 gives for this
  LTI plant), the interleaved state [q0, v0, q1, v1, ...] and a goal site
  (reference: scripts/src/mujoco/simulation.py);
- ``AUVEnv``: the Fossen dynamics of ``models/auv.py`` stepped at a fine
  dt in float64 on the CPU; its ``step_fn`` also steps a state on the card
  (the on-device loop, envs/mjx_env.py).
"""

from __future__ import annotations

import copy

import numpy as np
import torch


class PointMassEnv:
    """N-DoF frictionless point mass driven by per-axis forces."""

    def __init__(self, n_dof: int = 3, mass: float = 1.0, dt: float = 0.01,
                 goal=None, render: bool = False):
        self.n_dof = int(n_dof)
        self.mass = float(mass)
        self.dt = float(dt)
        self.render = render  # accepted for API parity; nothing to draw
        self._q = np.zeros(self.n_dof)
        self._v = np.zeros(self.n_dof)
        self._t = 0.0
        if goal is None:
            goal = np.zeros(2 * self.n_dof)
        self.goal = np.asarray(goal, np.float64).reshape(2 * self.n_dof, 1)

    def getTime(self) -> float:
        return self._t

    def getGoal(self) -> np.ndarray:
        return self.goal

    def getState(self) -> np.ndarray:
        """Interleaved [q0, v0, q1, v1, ...] column (simulation.py:32-37)."""
        x = np.zeros((2 * self.n_dof, 1))
        x[0::2, 0] = self._q
        x[1::2, 0] = self._v
        return x

    def setState(self, x) -> None:
        x = np.asarray(x, np.float64).reshape(-1)
        self._q = x[0::2].copy()
        self._v = x[1::2].copy()

    def step(self, u, goal=None) -> np.ndarray:
        """Apply a force command [aDim] and advance one step of dt."""
        u = np.asarray(u, np.float64).reshape(-1)[: self.n_dof]
        a = u / self.mass
        self._q = self._q + self._v * self.dt + 0.5 * a * self.dt * self.dt
        self._v = self._v + a * self.dt
        self._t += self.dt
        return self.getState()

    def reset(self, x0=None) -> np.ndarray:
        self._t = 0.0
        if x0 is None:
            self._q[:] = 0.0
            self._v[:] = 0.0
        else:
            self.setState(x0)
        return self.getState()


class AUVEnv:
    """Analytic AUV plant: the Fossen dynamics themselves as the simulator.

    The reference has no AUV simulation in-tree (its AUV runs went through
    external ROS / uuv_sim nodes), so the closed loop uses the port's
    ``AUVModel`` as the plant, stepped at a finer dt than the controller,
    in float64 on the CPU whatever device the controller uses. The 13-dim
    state is not interleaved: [x y z | qx qy qz qw | u v w p q r].
    ``step_fn`` is pure on tensors and steps one on its own device in its
    own dtype (the JAX package's AUVEnv.step_fn surface).
    """

    STATE_DIM = 13

    def __init__(self, model_cfg: dict, dt: float = 0.02, goal=None,
                 x0=None, render: bool = False):
        from ..models import get_model

        self.dt = float(dt)
        self.render = render
        cfg = {"type": "auv", **model_cfg}
        self._model = get_model(cfg, dt=self.dt, action_dim=6,
                                dtype=torch.float64, device="cpu")
        self._model.requires_grad_(False)
        self._models = {(self._model.device, self._model.dtype): self._model}
        self._t = 0.0
        if goal is None:
            goal = np.zeros(self.STATE_DIM)
            goal[6] = 1.0
        self.goal = np.asarray(goal, np.float64).reshape(-1, 1)
        self._x = self._rest()
        if x0 is not None:
            self.setState(x0)

    def _rest(self) -> np.ndarray:
        x = np.zeros(self.STATE_DIM)
        x[6] = 1.0
        return x

    def _model_on(self, device, dtype):
        """The plant's model on ``device`` in ``dtype``: a copy made at
        first use and kept (an on-device loop makes it in its warm-up,
        before a capture)."""
        key = (torch.device(device), dtype)
        if key not in self._models:
            self._models[key] = copy.deepcopy(self._model).to(
                device=key[0], dtype=dtype)
        return self._models[key]

    @torch.no_grad()
    def step_fn(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One plant step at the plant dt, on x's device in x's dtype.
        x: [13], u: [6] -> [13], or a fleet's [n, 13] and [n, 6] -> [n, 13]
        (the model's batched step, a row a vehicle)."""
        model = self._model_on(x.device, x.dtype)
        xb = x.reshape(-1, x.shape[-1])
        ub = u.reshape(-1, u.shape[-1]).to(x.dtype)
        return model.step(xb, ub).reshape(x.shape)

    def getTime(self) -> float:
        return self._t

    def getGoal(self) -> np.ndarray:
        return self.goal

    def getState(self) -> np.ndarray:
        return self._x.reshape(-1, 1).copy()

    def setState(self, x) -> None:
        self._x = np.asarray(x, np.float64).reshape(-1).copy()

    def step(self, u, goal=None) -> np.ndarray:
        """Apply a generalised force [6] for one plant step of dt."""
        u = np.asarray(u, np.float64).reshape(-1)[:6]
        self._x = self.step_fn(torch.from_numpy(self._x),
                               torch.from_numpy(u)).numpy()
        self._t += self.dt
        return self.getState()

    def reset(self, x0=None) -> np.ndarray:
        self._t = 0.0
        self._x = self._rest()
        if x0 is not None:
            self.setState(x0)
        return self.getState()
