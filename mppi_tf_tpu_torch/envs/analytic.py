"""Analytic point-mass environment (numpy; no MuJoCo dependency).

An exact plant for the closed loop, independent of the model code: a
point mass on N frictionless slide joints driven by per-axis forces, with
the exact double-integrator update over dt (what RK4 gives for this LTI
plant), the interleaved state [q0, v0, q1, v1, ...] and a goal site
(reference: scripts/src/mujoco/simulation.py).
"""

from __future__ import annotations

import numpy as np


class PointMassEnv:
    """N-DoF frictionless point mass driven by per-axis forces."""

    def __init__(self, n_dof: int = 3, mass: float = 1.0, dt: float = 0.01,
                 goal=None):
        self.n_dof = int(n_dof)
        self.mass = float(mass)
        self.dt = float(dt)
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

    def step(self, u) -> np.ndarray:
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
