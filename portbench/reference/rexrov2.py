"""Plain reference of ``rexrov2``: Fossen's 6-DoF AUV model with RexROV 2's
table (NicolayP/mppi-tf ``config/models/rexrov2.default.yaml``, UUV
Simulator's RexROV 2).

State [x y z | qx qy qz qw | u v w p q r] (position in the world frame,
the body-to-world attitude as a unit quaternion, scalar last, the body
velocities nu = [v; w]); the action is the generalised body force tau.
Fossen, "Handbook of Marine Craft Hydrodynamics and Motion Control"
(2011), eq. 7.190, z up:

    p' = R(q) v,   q' = T(q) w,
    nu' = M^-1 (tau - C(nu) nu - D(nu) nu - g(q)),
    M = M_RB + M_A,   M_RB = [[m I, -m S(r_g)], [m S(r_g), I_b]],
    D(nu) nu = -L nu - nu_0 L_fwd nu - Q_d (|nu| * nu)   (L, Q_d as tabled,
                                                          signs included),
    C(nu) nu = [-a1 x w; -a1 x v - a2 x w],   [a1; a2] = M nu,
    g(q) = -[f_g + f_b; r_g x f_g + r_b x f_b],
    f_g = R^T (0, 0, -m g0),   f_b = R^T (0, 0, rho V g0),

stepped by Heun's method (the table's rk = 2: x' = x + dt/2 (k1 + k2),
k2 at x + dt k1) and the quaternion renormalised after each step. The
state cost scores the 10-dim error [p - g_p, 2 acos(dot), nu - g_nu] on Q:
the static goal with the signed dot q . g_q, a waypoint with |q . w_q|,
the first two waypoints blended (1 - alpha, alpha) while two remain
(the blend is data, so that a pop changes no code path).
Float64; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .mppi import Controller

G0 = 9.81


def _skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def _rotation(q):
    x, y, z, w = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def _quat_rate(q, w):
    qx, qy, qz, qw = q.unbind(-1)
    wx, wy, wz = w.unbind(-1)
    return 0.5 * torch.stack([qw * wx - qz * wy + qy * wz,
                              qz * wx + qw * wy - qx * wz,
                              -qy * wx + qx * wy + qw * wz,
                              -qx * wx - qy * wy - qz * wz], dim=-1)


def _np_cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                     a0 * b1 - a1 * b0], axis=-1)


class Reference(Controller):
    """The configuration's model, state costs, plant and waypoint pop on
    ``device``."""

    def __init__(self, config: dict, device):
        super().__init__(config, device)
        like = {"dtype": torch.float64, "device": self.device}
        p = config["model"]
        self.dt = float(config["dt"])
        self.rk = int(p["rk"])
        if self.rk != 2:
            raise ValueError(f"the reference steps rk 2, the table asks "
                             f"for rk {self.rk}")
        self.m = float(p["mass"])
        self.buoyancy = float(p["volume"]) * float(p["density"]) * G0
        self.cog = torch.tensor(p["cog"], **like)
        self.cob = torch.tensor(p["cob"], **like)

        def square(v):
            t = torch.tensor(v, **like)
            return torch.diag(t) if t.ndim == 1 else t

        self.L = square(p["linear_damping"])
        self.L_fwd = square(p["linear_damping_forward_speed"])
        self.Qd = torch.tensor(p["quad_damping"], **like)
        i = p["inertial"]
        inertia = torch.tensor([[i["ixx"], i["ixy"], i["ixz"]],
                                [i["ixy"], i["iyy"], i["iyz"]],
                                [i["ixz"], i["iyz"], i["izz"]]], **like)
        sg = self.m * _skew(self.cog)
        m_rb = torch.cat([
            torch.cat([self.m * torch.eye(3, **like), -sg], dim=1),
            torch.cat([sg, inertia], dim=1)])
        self.M = m_rb + torch.tensor(p["Ma"], **like)
        self.M_inv = torch.linalg.inv(self.M)
        c = config["cost"]
        q = torch.tensor(c["Q"], **like)
        self.Q = torch.diag(q) if c.get("diag") else q
        self.alpha = float(c.get("alpha", 0.0))

    # --- dynamics ----------------------------------------------------------
    def state_dot(self, x, tau):
        q, v, w = x[:, 3:7], x[:, 7:10], x[:, 10:13]
        nu = x[:, 7:13]
        rot = _rotation(q)
        p_dot = torch.einsum("kij,kj->ki", rot, v)
        q_dot = _quat_rate(q, w)
        d_nu = (-(nu @ self.L.T) - nu[:, :1] * (nu @ self.L_fwd.T)
                - self.Qd * torch.abs(nu) * nu)
        a = nu @ self.M.T
        cross = torch.linalg.cross
        c_nu = torch.cat([-cross(a[:, :3], w, dim=-1),
                          -cross(a[:, :3], v, dim=-1)
                          - cross(a[:, 3:], w, dim=-1)], dim=-1)
        up = rot[:, 2, :]                           # R^T (0, 0, 1)
        f_g, f_b = -self.m * G0 * up, self.buoyancy * up
        g = -torch.cat([f_g + f_b,
                        cross(self.cog.expand_as(f_g), f_g, dim=-1)
                        + cross(self.cob.expand_as(f_b), f_b, dim=-1)],
                       dim=-1)
        nu_dot = (tau - c_nu - d_nu - g) @ self.M_inv.T
        return torch.cat([p_dot, q_dot, nu_dot], dim=-1)

    def _advance(self, x, tau, dt: float):
        k1 = self.state_dot(x, tau)
        k2 = self.state_dot(x + dt * k1, tau)
        x = x + (dt / 2.0) * (k1 + k2)
        q = x[:, 3:7]
        n = torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
        return torch.cat([x[:, :3], q / n, x[:, 7:]], dim=-1)

    def step(self, x, u):
        """The model: x [k, 13], tau [k, 6] -> x' [k, 13] over dt."""
        return self._advance(x, u, self.dt)

    def plant(self, x, u, dt: float, substeps: int):
        """``substeps`` plant steps of ``dt`` with the force held; x [13]
        or [n, 13]."""
        xb = x.reshape(-1, 13)
        ub = u.reshape(-1, 6)
        for _ in range(substeps):
            xb = self._advance(xb, ub, dt)
        return xb.reshape(x.shape)

    def host_plant(self, x: np.ndarray, u: np.ndarray, dt: float,
                   substeps: int) -> np.ndarray:
        """``plant`` in numpy on the host, for a fleet's vehicles [n, 13]
        under their forces [n, 6]: the same equations, without the cost
        of a torch call a small operation."""
        if not hasattr(self, "_np"):
            self._np = {n: getattr(self, n).cpu().numpy()
                        for n in ("M", "M_inv", "L", "L_fwd", "Qd", "cog",
                                  "cob")}
        c = self._np
        mg, b = self.m * G0, self.buoyancy

        def f(x):
            qx, qy, qz, qw = x[:, 3], x[:, 4], x[:, 5], x[:, 6]
            v, w, nu = x[:, 7:10], x[:, 10:13], x[:, 7:13]
            rot = np.stack([
                1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                2 * (qx * qz + qy * qw), 2 * (qx * qy + qz * qw),
                1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw),
                2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                1 - 2 * (qx * qx + qy * qy)], axis=-1).reshape(-1, 3, 3)
            wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
            q_dot = 0.5 * np.stack([qw * wx - qz * wy + qy * wz,
                                    qz * wx + qw * wy - qx * wz,
                                    -qy * wx + qx * wy + qw * wz,
                                    -qx * wx - qy * wy - qz * wz], axis=-1)
            d_nu = (-(nu @ c["L"].T) - nu[:, :1] * (nu @ c["L_fwd"].T)
                    - c["Qd"] * np.abs(nu) * nu)
            a = nu @ c["M"].T
            c_nu = np.concatenate([-_np_cross(a[:, :3], w),
                                   -_np_cross(a[:, :3], v)
                                   - _np_cross(a[:, 3:], w)], axis=-1)
            up = rot[:, 2, :]
            f_g, f_b = -mg * up, b * up
            g = -np.concatenate([f_g + f_b, _np_cross(c["cog"], f_g)
                                 + _np_cross(c["cob"], f_b)], axis=-1)
            nu_dot = (u - c_nu - d_nu - g) @ c["M_inv"].T
            return np.concatenate([(rot @ v[:, :, None])[:, :, 0], q_dot,
                                   nu_dot], axis=-1)

        for _ in range(substeps):
            k1 = f(x)
            x = x + (dt / 2.0) * (k1 + f(x + dt * k1))
            n = np.maximum(np.linalg.norm(x[:, 3:7], axis=-1,
                                          keepdims=True), 1e-12)
            x = np.concatenate([x[:, :3], x[:, 3:7] / n, x[:, 7:]], axis=-1)
        return x

    # --- costs -------------------------------------------------------------
    @staticmethod
    def error10(x, wp, geodesic: bool):
        dot = x[:, 3:7] @ wp[3:7]
        if geodesic:
            dot = torch.abs(dot)
        dot = torch.clamp(dot, -1.0, 1.0)
        return torch.cat([x[:, :3] - wp[None, :3],
                          2.0 * torch.acos(dot)[:, None],
                          x[:, 7:13] - wp[None, 7:13]], dim=-1)

    def _quad(self, e):
        return torch.sum((e @ self.Q.T) * e, dim=-1)

    def state_cost(self, x, cp):
        if "goal" in cp:
            return self._quad(self.error10(x, cp["goal"], geodesic=False))
        lead, blend = cp["lead"], cp["blend"]
        return (blend[0] * self._quad(self.error10(x, lead[0], True))
                + blend[1] * self._quad(self.error10(x, lead[1], True)))

    def static_params(self, goal) -> dict:
        return {"goal": torch.as_tensor(goal, dtype=torch.float64,
                                        device=self.device)}

    def mission_params(self, waypoints) -> dict:
        """A waypoint queue: its legs in order, how many remain, the
        leading two (a zero row where one remains) and their blend:
        (1 - alpha, alpha) while two remain, else (1, 0)."""
        queue = [[float(v) for v in w] for w in waypoints]
        lead = (queue + [[0.0] * 13])[:2]
        blend = [1.0 - self.alpha, self.alpha] if len(queue) >= 2 \
            else [1.0, 0.0]
        like = {"dtype": torch.float64, "device": self.device}
        return {"queue": queue, "count": len(queue),
                "lead": torch.tensor(lead, **like),
                "blend": torch.tensor(blend, **like)}

    def pop(self, cp: dict, x, radius: float) -> dict:
        """The queue after the plant reached ``x`` [13]: the leading
        waypoint dropped where the 10-dim error to it is within ``radius``
        and at least two legs remain."""
        if cp["count"] < 2:
            return cp
        e = self.error10(x.reshape(1, 13), cp["lead"][0], geodesic=True)
        if float(torch.sum(e * e)) >= radius * radius:
            return cp
        return self.mission_params(cp["queue"][1:])
