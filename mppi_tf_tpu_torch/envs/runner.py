"""Closed-loop experiment runner with sim/control rate decoupling.

Reference: scripts/main.py:94-106 (the intended flow): each control step
reads the state, solves MPPI, then steps the plant at its own (finer)
physics dt until one controller dt has elapsed. The JAX package's learner
hook (``train_every``), observer logging and on-device loop are not ported
yet and raise ``NotImplementedError`` naming their ROADMAP items.
"""

from __future__ import annotations

import numpy as np
import torch


class ClosedLoopRunner:
    """Drives a controller against an env at the control dt."""

    def __init__(self, env, controller, control_dt: float,
                 waypoint_radius: float = 0.0):
        self.env = env
        self.controller = controller
        self.control_dt = float(control_dt)
        # > 0 pops the leading waypoint of a WayPointsCost once the plant
        # is within this distance of it (controller/missions.py; the wiring
        # the reference's waypoint draft never got, cost_base.py:210-284)
        self.waypoint_radius = float(waypoint_radius)

    def run(self, steps: int, x0=None):
        """Run ``steps`` control steps; returns (states, actions) histories,
        states including the last one (main.py:94-106)."""
        if x0 is not None:
            self.env.reset(x0)
        states, actions = [], []
        x = self.env.getState()
        for _ in range(steps):
            u = self.controller.next(x)
            prev = self.env.getTime()
            x_next = x
            # step physics at its own dt until one control period elapsed
            while self.env.getTime() - prev < self.control_dt - 1e-12:
                x_next = self.env.step(np.reshape(u, (1, -1)),
                                       goal=self.env.getGoal())
            states.append(np.reshape(x, (-1,)).copy())
            actions.append(np.reshape(u, (-1,)).copy())
            x = x_next
            if self.waypoint_radius > 0.0:
                self._advance_waypoints(x)
        states.append(np.reshape(x, (-1,)).copy())
        return np.asarray(states), np.asarray(actions)

    def _advance_waypoints(self, x):
        """Pop the leading waypoint once the plant state is inside
        ``waypoint_radius`` of it (Euclidean over the cost's dist vector),
        through the controller's mission surface; decided on the host from
        the plant state, so it adds no device sync."""
        from ..costs.waypoints import WayPointsCost

        if isinstance(getattr(self.controller, "_cost", None),
                      WayPointsCost):
            self.controller.advance_waypoints(np.reshape(x, (-1,)),
                                              self.waypoint_radius)


def build_model_and_cost(env_cfg, task_cfg, model_cfg, dtype=torch.float32,
                         device="cuda"):
    """Model, cost and sigma from the three YAML-family dicts: the
    construction every config-driven entry point shares."""
    from ..costs import get_cost
    from ..models import get_model

    sdim = env_cfg.get("state-dim", 2)
    adim = env_cfg.get("action-dim", 1)
    dt = env_cfg.get("dt", 0.1)
    sigma = np.asarray(env_cfg["noise"], np.float64)
    model = get_model(model_cfg, dt=dt, state_dim=sdim, action_dim=adim,
                      dtype=dtype, device=device)
    cost = get_cost(task_cfg, lam=env_cfg.get("lambda", 1.0),
                    gamma=env_cfg.get("gamma", 1.0),
                    upsilon=env_cfg.get("upsilon", 1.0), sigma=sigma,
                    dtype=dtype, device=device)
    return model, cost, sigma


def run_experiment(env_cfg, task_cfg, model_cfg, steps: int = 100,
                   log: bool = False, render: bool = False, seed: int = 0,
                   train_every: int = 0, dtype=torch.float32,
                   on_device: bool = False, device="cuda"):
    """Config-driven experiment: build env, model, cost and controller from
    the three YAML-family dicts and run the closed loop on ``device``
    (default the card; raises without a GPU, as ``MPPI`` does).

    Returns {"states", "actions", "controller", "env", "observer",
    "learner"} (observer and learner None).
    """
    from ..controller import get_controller
    from . import get_env

    if train_every:
        raise NotImplementedError(
            "train_every: the learner is not ported yet: ROADMAP item 11")
    if on_device:
        raise NotImplementedError(
            "on_device: the on-device closed loop is not ported yet: "
            "ROADMAP item 13")
    if log:
        raise NotImplementedError(
            "log: observers are not ported yet: ROADMAP item 7")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_experiment(device='cuda'): no GPU is present; pass "
            "device='cpu' for the plain CPU path")
    env = get_env(env_cfg, render=render, model_cfg=model_cfg)
    model, cost, _sigma = build_model_and_cost(
        env_cfg, task_cfg, model_cfg, dtype=dtype, device=device)
    controller = get_controller(model, cost, env_cfg, seed=seed,
                                device=device)
    runner = ClosedLoopRunner(env, controller,
                              control_dt=env_cfg.get("dt", 0.1),
                              waypoint_radius=task_cfg.get("radius", 0.0))
    states, actions = runner.run(steps)
    return {"states": states, "actions": actions, "controller": controller,
            "env": env, "observer": None, "learner": None}
