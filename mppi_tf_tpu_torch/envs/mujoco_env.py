"""MuJoCo simulation environment through the official ``mujoco`` bindings.

The port of the JAX package's ``envs/mujoco_env.py``; like it, host numpy
(the plant steps on the host in both packages while the controller runs on
the card). It replaces the reference's mujoco_py wrapper
(scripts/src/mujoco/simulation.py) and the C++ MuJoCo env
(src/mj_pm_env.cpp: mj_loadXML / mj_makeData / mj_step). The GLFW viewer of
the C++ env (mj_pm_env.cpp:68-95, 204-263) maps to ``mujoco.viewer`` where
a display exists; headless is the default. The repo ships no ``.xml``
scene: ``point_mass_xml`` generates the reference's point-mass MJCF.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

try:
    import mujoco

    HAVE_MUJOCO = True
except ImportError:  # pragma: no cover - the package is optional
    mujoco = None
    HAVE_MUJOCO = False


class MujocoEnv:
    """MJCF-backed environment with the reference Simulation surface."""

    def __init__(self, xml_file: str, s_dim: int, a_dim: int,
                 goal=None, render: bool = False):
        if not HAVE_MUJOCO:
            raise ImportError(
                "the 'mujoco' package is unavailable; use the analytic env")
        self.model = mujoco.MjModel.from_xml_path(xml_file)
        self.data = mujoco.MjData(self.model)
        self.s_dim = int(s_dim)
        self.a_dim = int(a_dim)
        self.render = render
        self._viewer = None
        self.goal = goal
        if goal is None:
            self.goal = np.zeros((self.s_dim, 1))
            site = _site_id(self.model, "target")
            if site is not None:
                mujoco.mj_forward(self.model, self.data)
                g = self.data.site_xpos[site]
                # goal positions into the interleaved slots
                # (reference simulation.py:19-24)
                for i in range(self.s_dim // 2):
                    self.goal[2 * i] = g[i]
        if render:  # pragma: no cover - needs a display
            from mujoco import viewer as mj_viewer

            self._viewer = mj_viewer.launch_passive(self.model, self.data)

    # --- reference Simulation API ----------------------------------------
    def getTime(self) -> float:
        return float(self.data.time)

    def getGoal(self) -> np.ndarray:
        return self.goal

    def getState(self) -> np.ndarray:
        """Interleaved qpos / qvel read. Reference: simulation.py:32-37."""
        x = np.zeros((self.s_dim, 1))
        for i in range(self.s_dim // 2):
            x[2 * i] = self.data.qpos[i]
            x[2 * i + 1] = self.data.qvel[i]
        return x

    def step(self, u, goal=None) -> np.ndarray:
        """Apply ctrl, mj_step once. Reference: simulation.py:39-55."""
        u = np.asarray(u, np.float64).reshape(-1)
        for i in range(self.a_dim):
            self.data.ctrl[i] = u[i]
        mujoco.mj_step(self.model, self.data)
        if self._viewer is not None:  # pragma: no cover
            self._viewer.sync()
        return self.getState()

    def reset(self, x0=None) -> np.ndarray:
        mujoco.mj_resetData(self.model, self.data)
        if x0 is not None:
            x0 = np.asarray(x0, np.float64).reshape(-1)
            for i in range(self.s_dim // 2):
                self.data.qpos[i] = x0[2 * i]
                self.data.qvel[i] = x0[2 * i + 1]
            mujoco.mj_forward(self.model, self.data)
        return self.getState()


def _site_id(model, name: str):
    """The id of site ``name``, or None where the scene has none."""
    sid = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_SITE, name)
    return sid if sid >= 0 else None


def point_mass_xml(n_dof: int = 3, timestep: float = 0.01,
                   goal=(1.0, 0.5, -0.5)) -> str:
    """An MJCF point-mass scene equivalent to the reference's
    envs/point_mass{1,2,3}d.xml: a unit mass on 1-3 slide joints with force
    actuators, RK4 at dt=0.01, and a ``target`` site at the goal."""
    axes = [("x", "1 0 0"), ("y", "0 1 0"), ("z", "0 0 1")][:n_dof]
    joints = "\n        ".join(
        f'<joint name="slide_{n}" type="slide" axis="{ax}" damping="0"/>'
        for n, ax in axes)
    actuators = "\n    ".join(
        f'<motor name="thrust_{n}" joint="slide_{n}" gear="1"/>'
        for n, _ in axes)
    gx, gy, gz = (list(goal) + [0.0, 0.0, 0.0])[:3]
    return f"""<mujoco model="point_mass{n_dof}d">
  <option integrator="RK4" timestep="{timestep}" gravity="0 0 0"/>
  <worldbody>
    <body name="mass" pos="0 0 0">
        {joints}
        <geom name="ball" type="sphere" size="0.05" mass="1"/>
    </body>
    <site name="target" pos="{gx} {gy} {gz}" size="0.03"/>
  </worldbody>
  <actuator>
    {actuators}
  </actuator>
</mujoco>
"""


def make_point_mass_env(n_dof: int = 3, goal=(1.0, 0.5, -0.5),
                        render: bool = False) -> "MujocoEnv":
    """A MuJoCo point-mass env from the generated MJCF (written to a
    temporary file, which MuJoCo reads once)."""
    fd, path = tempfile.mkstemp(suffix=".xml")
    with os.fdopen(fd, "w") as f:
        f.write(point_mass_xml(n_dof=n_dof, goal=goal))
    return MujocoEnv(path, s_dim=2 * n_dof, a_dim=n_dof, render=render)
