"""Elliptic trajectory-tracking costs (2D and 3D).

Reference: scripts/src/costs/elipse_cost.py: ``ElipseCost`` (a 2D ellipse
in the interleaved point-mass state, :9-98) and ``ElipseCost3D`` (an
ellipse in any plane for the 13-dim AUV state, :101-246). The spelling
"elipse" is the reference's config ``type`` string. The ellipse is the
goal, so neither cost has mutable parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import quaternion as quat
from .base import CostBase


class ElipseCost(CostBase):
    """2D ellipse tracking for the 4-dim interleaved state [x, vx, y, vy]:

        m_state |((x-cx)/a)^2 + ((y-cy)/b)^2 - 1| + m_vel (|v| - gv)^2

    Reference: elipse_cost.py:9-98.
    """

    def __init__(self, lam, gamma, upsilon, sigma, a, b, center_x, center_y,
                 speed, m_state, m_vel, dtype=torch.float32, device=None):
        super().__init__(lam, gamma, upsilon, sigma, dtype=dtype,
                         device=device)
        self.a, self.b = float(a), float(b)
        self.cx, self.cy = float(center_x), float(center_y)
        self.gv = float(speed)
        self.mx, self.mv = float(m_state), float(m_vel)

    def set_goal(self, goal) -> None:
        """The ellipse itself is the goal: nothing to update."""

    def state_cost(self, state: torch.Tensor) -> torch.Tensor:
        """Reference: elipse_cost.py:46-79. state: [k, 4] -> [k]."""
        x, vx, y, vy = state.unbind(-1)
        v = torch.sqrt(vx * vx + vy * vy)
        dx = (x - self.cx) / self.a
        dy = (y - self.cy) / self.b
        d = torch.abs(dx * dx + dy * dy - 1.0)
        return self.mx * d + self.mv * (v - self.gv) ** 2

    def dist(self, state) -> dict:
        """Radial and speed distance of one state.
        Reference: elipse_cost.py:87-98."""
        x, vx, y, vy = torch.as_tensor(state).reshape(-1)[:4].unbind()
        v = torch.sqrt(vx * vx + vy * vy)
        x_dist = (((x - self.cx) / self.a) ** 2
                  + ((y - self.cy) / self.b) ** 2 - 1.0)
        return {"x_dist": x_dist, "v_dist": torch.abs(v - self.gv)}

    def draw_goal(self, n: int = 1000):
        """Points of the ellipse. Reference: elipse_cost.py:81-85."""
        alpha = np.linspace(0, 2 * np.pi, n)
        return (self.a * np.cos(alpha) + self.cx,
                self.b * np.sin(alpha) + self.cy)


class ElipseCost3D(CostBase):
    """3D ellipse tracking in any plane for the 13-dim AUV state.

    The plane frame is built from the ellipse normal and major-axis vector;
    poses are taken into it, then scored by position (algebraic ellipse
    distance), orientation (the angle between the body x-axis and the
    ellipse tangent) and speed. Reference: elipse_cost.py:101-246, with its
    factory completed (cost.py:33-42 passes an old signature).

    Intent fix, as in the JAX package: the reference stores the center
    (elipse_cost.py:165) but rotates raw positions (:170); here positions
    are translated by the center before rotating.
    """

    def __init__(self, lam, gamma, upsilon, sigma, normal, aVec, axis,
                 center, speed, m_state, m_vel, dtype=torch.float32,
                 device=None):
        """normal [3]: the plane normal; aVec [3]: the unit major axis (in
        the plane); axis [2]: (a, b); center [3]; speed: the target linear
        speed; m_state / m_vel: the state / speed weights."""
        super().__init__(lam, gamma, upsilon, sigma, dtype=dtype,
                         device=device)
        normal = np.asarray(normal, np.float64).reshape(3)
        a_vec = np.asarray(aVec, np.float64).reshape(3)
        # axis padded with 1 for the z term (elipse_cost.py:132-133)
        axis3 = np.concatenate([np.asarray(axis, np.float64).reshape(-1),
                                [1.0]])
        # plane frame: R takes inertial to plane (elipse_cost.py:160-164)
        N = np.stack([a_vec, np.cross(normal, a_vec), normal], axis=-1)
        R = np.linalg.inv(N).T
        q_plane = quat.from_rotation_matrix(torch.as_tensor(R)).numpy()

        def buf(name, value):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(value, np.float64), dtype=dtype, device=device))

        buf("axis", axis3)
        buf("center", np.asarray(center, np.float64).reshape(3))
        buf("q_plane", q_plane)
        # tangent map: swap x and y, scaled by the axis ratio
        # (elipse_cost.py:144-151)
        buf("mapping", [-axis3[0] / axis3[1], axis3[1] / axis3[0], 0.0])
        self.gv = float(speed)
        self.mS, self.mV = float(m_state), float(m_vel)

    def set_goal(self, goal) -> None:
        """The ellipse itself is the goal: nothing to update."""

    def position_error(self, pos_pf: torch.Tensor) -> torch.Tensor:
        """|sum((p / axis)^2) - 1| in the plane frame. [k, 3] -> [k].
        Reference: elipse_cost.py:181-200."""
        return torch.abs(torch.sum((pos_pf / self.axis) ** 2, dim=-1) - 1.0)

    def orientation_error(self, pos_pf: torch.Tensor,
                          quat_pf: torch.Tensor) -> torch.Tensor:
        """Angle between the body x-axis and the ellipse tangent. -> [k].
        Reference: elipse_cost.py:202-226."""
        tg = pos_pf[:, [1, 0, 2]] * self.mapping
        tg = tg / torch.clamp(torch.linalg.vector_norm(tg, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
        x_axis = tg.new_tensor([1.0, 0.0, 0.0]).expand_as(tg)
        return quat.relative_angle(quat.between_two_vectors(x_axis, tg),
                                   quat_pf)

    def velocity_error(self, vel: torch.Tensor) -> torch.Tensor:
        """||v_lin|^2 - gv^2|. [k, 6] -> [k]. Reference: elipse_cost.py:228-246."""
        v = torch.linalg.vector_norm(vel[:, 0:3], dim=-1)
        return torch.abs(v * v - self.gv * self.gv)

    def _plane_pos(self, pos: torch.Tensor) -> torch.Tensor:
        return quat.rotate(pos - self.center,
                           self.q_plane.expand(pos.shape[0], 4))

    def state_cost(self, state: torch.Tensor) -> torch.Tensor:
        """mS (position + orientation) + mV velocity.
        Reference: elipse_cost.py:166-179."""
        pos_pf = self._plane_pos(state[:, 0:3])
        quat_pf = quat.multiply(self.q_plane.expand(state.shape[0], 4),
                                state[:, 3:7])
        return (self.mS * self.position_error(pos_pf)
                + self.mS * self.orientation_error(pos_pf, quat_pf)
                + self.mV * self.velocity_error(state[:, 7:13]))

    def dist(self, state) -> dict:
        """Position and speed errors of one state."""
        x = torch.as_tensor(state).reshape(1, -1)
        return {"x_dist": self.position_error(self._plane_pos(x[:, 0:3]))[0],
                "v_dist": self.velocity_error(x[:, 7:13])[0]}
