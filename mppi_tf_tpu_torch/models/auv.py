"""AUV (autonomous underwater vehicle) 6-DoF Fossen dynamics.

Reference: scripts/src/models/auv_model.py, a uuv_sim-style vehicle model:
state ``[x y z | qx qy qz qw | u v w p q r]`` (13), rigid-body + added mass,
linear / quadratic / forward-speed damping, Coriolis, restoring (gravity,
buoyancy) forces, quaternion kinematics, RK1/RK2/RK4 integration with
quaternion renormalisation.

Mass and the six inertia moments are ``nn.Parameter``s (the reference's
trainable variables); every other constant is a buffer. The total mass
matrix and its inverse depend only on those parameters, so ``precompute``
builds them once and rebuilds them when a parameter changes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..ops import quaternion as quat
from .base import ModelBase

GRAVITY = 9.81


class AUVModel(ModelBase):
    """Fossen-equation AUV dynamics.

    ``parameters`` follows the reference model-config family
    (config/models/rexrov2.default.yaml): mass, volume, density, cog, cob,
    Ma (6x6 added mass), linear_damping (6 or 6x6), quad_damping (6),
    linear_damping_forward_speed (6 or 6x6), inertial {ixx iyy izz ixy ixz
    iyz}, rk (integration order 1, 2 or 4).

    Reference: auv_model.py:87-241 (constructor, validation), :285-306
    (step), :308-333 (state_dot), :544-559 (acc).
    """

    STATE_DIM = 13

    def __init__(self, parameters: Dict[str, Any], dt: float = 0.1,
                 action_dim: int = 6, act_max=None, act_min=None,
                 name: str = "AUV", inertial_frame_id: str = "world",
                 dtype=torch.float32, device=None):
        super().__init__(self.STATE_DIM, action_dim, dt=dt, name=name,
                         act_max=act_max, act_min=act_min, dtype=dtype,
                         device=device)
        if inertial_frame_id not in ("world", "world_ned"):
            raise AssertionError("inertial frame must be world or world_ned")
        if inertial_frame_id == "world_ned":
            # the restoring forces are written for z up ('world'); NED
            # would silently flip gravity and buoyancy
            raise NotImplementedError(
                "inertial_frame_id='world_ned' is not implemented: the "
                "restoring-force model is z-up ('world'); transform NED "
                "states at the boundary instead")
        self._rk = int(parameters.get("rk", 1))
        if self._rk not in (1, 2, 4):
            raise AssertionError(f"rk must be 1, 2, or 4, got {self._rk}")

        # parameter validation (auv_model.py:126-228)
        mass = float(parameters.get("mass", 0.0))
        assert mass > 0, "Mass has to be positive."
        volume = float(parameters.get("volume", 0.0))
        assert volume > 0, "Volume has to be positive."
        density = float(parameters.get("density", 0.0))
        assert density > 0, "Liquid density has to be positive."
        if "cog" not in parameters:
            raise AssertionError(
                "need to define the center of gravity in the body frame")
        cog = np.asarray(parameters["cog"], dtype=np.float64)
        assert cog.shape == (3,), "Invalid center of gravity vector."
        if "cob" not in parameters:
            raise AssertionError(
                "need to define the center of buoyancy in the body frame")
        cob = np.asarray(parameters["cob"], dtype=np.float64)
        assert cob.shape == (3,), "Invalid center of buoyancy vector."

        added_mass = np.zeros((6, 6))
        if "Ma" in parameters:
            added_mass = np.asarray(parameters["Ma"], dtype=np.float64)
            assert added_mass.shape == (6, 6), "Invalid added mass matrix."

        def square(key, what):
            m = np.zeros((6, 6))
            if key in parameters:
                m = np.asarray(parameters[key], np.float64)
                if m.shape == (6,):
                    m = np.diag(m)
                assert m.shape == (6, 6), f"Invalid {what}."
            return m

        lin_damp = square("linear_damping", "linear damping")
        lin_damp_fwd = square("linear_damping_forward_speed",
                              "forward damping")
        quad_damp = np.zeros(6)
        if "quad_damping" in parameters:
            quad_damp = np.asarray(parameters["quad_damping"], np.float64)
            assert quad_damp.shape == (6,), "Invalid quadratic damping."

        inertial_cfg = parameters.get("inertial", {})
        keys = ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")
        if any(k not in inertial_cfg for k in keys):
            raise AssertionError("Invalid moments of inertia")

        self.volume = volume
        self.density = density

        def buf(name, value):
            self.register_buffer(name, torch.as_tensor(
                value, dtype=dtype, device=device))

        buf("cog", cog)
        buf("cob", cob)
        buf("added_mass", added_mass)
        buf("lin_damp", lin_damp)
        buf("lin_damp_fwd", lin_damp_fwd)
        buf("quad_damp", np.diag(quad_damp))
        # the world z axis, kept on the model's device: built per call it
        # would be a host-to-device copy, which a CUDA graph cannot capture
        self.register_buffer("unit_z", torch.tensor(
            [0.0, 0.0, 1.0], dtype=dtype, device=device), persistent=False)
        self.mass = nn.Parameter(torch.tensor(mass, dtype=dtype,
                                              device=device))
        self.inertial = nn.Parameter(torch.tensor(
            [float(inertial_cfg[k]) for k in keys], dtype=dtype,
            device=device))
        self._configured = {"mass": mass, "inertial": [
            float(inertial_cfg[k]) for k in keys]}
        self._mats = None
        self._mats_key = None

    @property
    def rk(self) -> int:
        return self._rk

    @property
    def buoyancy(self) -> float:
        """Buoyant force rho V g (N)."""
        return self.volume * self.density * GRAVITY

    # ------------------------------------------------------------------
    # mass matrices
    # ------------------------------------------------------------------
    def _mass_matrices(self):
        """Total mass matrix M = M_RB + M_A and its inverse.
        Reference: auv_model.py:234-241, 257-263."""
        m, ix = self.mass, self.inertial
        inertia = torch.stack([
            torch.stack([ix[0], ix[3], ix[4]]),
            torch.stack([ix[3], ix[1], ix[5]]),
            torch.stack([ix[4], ix[5], ix[2]])])
        mass_eye = m * torch.eye(3, dtype=m.dtype, device=m.device)
        mass_lower = m * quat.skew(self.cog)
        m_rb = torch.cat([torch.cat([mass_eye, -mass_lower], dim=1),
                          torch.cat([mass_lower, inertia], dim=1)], dim=0)
        m_tot = m_rb + self.added_mass
        # inv_ex: no host sync for an error check on the card
        return m_tot, torch.linalg.inv_ex(m_tot).inverse

    def precompute(self):
        """(M_tot, M_tot^-1), hoisted out of the horizon: built once and
        rebuilt when ``mass`` or ``inertial`` change (their version counters
        and storage), or on every call while autograd records them."""
        if torch.is_grad_enabled() and (self.mass.requires_grad
                                        or self.inertial.requires_grad):
            return self._mass_matrices()
        key = tuple((p._version, p.data_ptr(), p.dtype, p.device)
                    for p in (self.mass, self.inertial))
        if key != self._mats_key:
            with torch.no_grad():
                self._mats = self._mass_matrices()
            self._mats_key = key
        return self._mats

    # ------------------------------------------------------------------
    # dynamics terms, batched over a leading k
    # ------------------------------------------------------------------
    def damping_matrix(self, vel: torch.Tensor) -> torch.Tensor:
        """D(nu): linear + forward-speed + quadratic damping.
        vel: [k, 6] -> [k, 6, 6]. Reference: auv_model.py:478-506."""
        D = -self.lin_damp[None] - vel[:, 0, None, None] * \
            self.lin_damp_fwd[None]
        eye = torch.eye(6, dtype=vel.dtype, device=vel.device)
        quad = -torch.einsum("ij,kjl->kil", self.quad_damp,
                             torch.abs(vel)[:, :, None] * eye[None])
        return D + quad

    def coriolis_matrix(self, m_tot: torch.Tensor,
                        vel: torch.Tensor) -> torch.Tensor:
        """C(nu) from skew products of M nu. vel: [k, 6] -> [k, 6, 6].
        Reference: auv_model.py:508-542."""
        s12 = -quat.skew(vel[:, :3] @ m_tot[0:3, 0:3].T
                         + vel[:, 3:6] @ m_tot[0:3, 3:6].T)
        s22 = -quat.skew(vel[:, :3] @ m_tot[3:6, 0:3].T
                         + vel[:, 3:6] @ m_tot[3:6, 3:6].T)
        top = torch.cat([torch.zeros_like(s12), s12], dim=-1)
        return torch.cat([top, torch.cat([s12, s22], dim=-1)], dim=-2)

    def restoring_forces(self, rot_btoi: torch.Tensor) -> torch.Tensor:
        """Gravity and buoyancy wrench in the body frame.
        rot: [k, 3, 3] -> [k, 6]. Reference: auv_model.py:450-476."""
        unit_z = self.unit_z.to(rot_btoi.dtype)
        rot_itob = rot_btoi.transpose(-1, -2)
        fbg = rot_itob @ (-self.mass * GRAVITY * unit_z)
        fbb = rot_itob @ (self.buoyancy * unit_z)
        mbg = torch.linalg.cross(self.cog.expand_as(fbg), fbg, dim=-1)
        mbb = torch.linalg.cross(self.cob.expand_as(fbb), fbb, dim=-1)
        return -torch.cat([fbg + fbb, mbg + mbb], dim=-1)

    def acc(self, vel: torch.Tensor, gen_force: torch.Tensor,
            rot_btoi: torch.Tensor) -> torch.Tensor:
        """nu_dot = M^-1 (tau - C nu - D nu - g). vel: [k, 6] -> [k, 6].

        D nu and C nu are computed without the [k, 6, 6] matrices:
          D nu = -L nu - u (L_fwd nu) - Q_d (|nu| . nu)
          C nu = [-a1 x w ; -a1 x v - a2 x w],  [a1; a2] = M nu
        (``damping_matrix`` / ``coriolis_matrix`` are the matrix forms the
        tests hold this against). Reference: auv_model.py:544-559."""
        m_tot, inv_m = self.precompute()
        Dv = (-(vel @ self.lin_damp.T)
              - vel[:, 0:1] * (vel @ self.lin_damp_fwd.T)
              - (torch.abs(vel) * vel) @ self.quad_damp.T)
        v, w = vel[:, 0:3], vel[:, 3:6]
        a1 = v @ m_tot[0:3, 0:3].T + w @ m_tot[0:3, 3:6].T
        a2 = v @ m_tot[3:6, 0:3].T + w @ m_tot[3:6, 3:6].T
        cross = torch.linalg.cross
        Cv = torch.cat([-cross(a1, w, dim=-1),
                        -cross(a1, v, dim=-1) - cross(a2, w, dim=-1)],
                       dim=-1)
        rhs = gen_force - Cv - Dv - self.restoring_forces(rot_btoi)
        return rhs @ inv_m.T

    def state_dot(self, state: torch.Tensor,
                  action: torch.Tensor) -> torch.Tensor:
        """x_dot = f(x, u). state: [k, 13], action: [k, 6] -> [k, 13].
        Reference: auv_model.py:308-333."""
        q, vel = state[:, 3:7], state[:, 7:13]
        rot = quat.to_rotation_matrix(q)
        pos_dot = torch.einsum("kij,kj->ki", rot, vel[:, :3])
        quat_dot = torch.einsum("kij,kj->ki", quat.attitude_jacobian(q),
                                vel[:, 3:6])
        return torch.cat([pos_dot, quat_dot, self.acc(vel, action, rot)],
                         dim=-1)

    def normalize_quat(self, state: torch.Tensor) -> torch.Tensor:
        """Renormalise the quaternion block. Reference: auv_model.py:426-448."""
        return torch.cat([state[:, 0:3], quat.normalize(state[:, 3:7]),
                          state[:, 7:13]], dim=-1)

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """RK1 / RK2 / RK4 step + quaternion renormalisation.

        Reference: auv_model.py:285-306. The reference's rk == 4 branch
        scales k4 by dt inside the average, a defect; this is the standard
        RK4 weighting, as in the JAX package (models/auv.py:316-320)."""
        dt = self._dt
        k1 = self.state_dot(x, u)
        if self._rk == 1:
            delta = dt * k1
        elif self._rk == 2:
            k2 = self.state_dot(x + dt * k1, u)
            delta = (dt / 2.0) * (k1 + k2)
        else:
            k2 = self.state_dot(x + (dt / 2.0) * k1, u)
            k3 = self.state_dot(x + (dt / 2.0) * k2, u)
            k4 = self.state_dot(x + dt * k3, u)
            delta = (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        return self.normalize_quat(x + delta)

    def get_jacobian(self, state: torch.Tensor) -> torch.Tensor:
        """J: [k, 7, 6] pose-rate map, blockdiag(R, T_q).
        Reference: auv_model.py:335-351."""
        q = state[:, 3:7]
        rot, tq = quat.to_rotation_matrix(q), quat.attitude_jacobian(q)
        top = torch.cat([rot, rot.new_zeros(rot.shape)], dim=-1)
        bottom = torch.cat([tq.new_zeros(tq.shape), tq], dim=-1)
        return torch.cat([top, bottom], dim=-2)
