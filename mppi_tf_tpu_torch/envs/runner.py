"""Closed-loop experiment runner with sim/control rate decoupling.

Reference: scripts/main.py:94-106 (the intended flow): each control step
reads the state, solves MPPI, then steps the plant at its own (finer)
physics dt until one controller dt has elapsed, and logs the transition
to the controller's observer; with a learner it stores the transition
and refits the model every ``train_every`` steps, handing the learned
parameters to the controller (the JAX package's learner hook,
``mppi_tf_tpu/envs/runner.py:54-65``). ``run_experiment(on_device=True)``
runs the whole experiment in the on-device loop (``envs/mjx_env.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class ClosedLoopRunner:
    """Drives a controller against an env at the control dt; the
    controller's ``save`` logs each transition to its observer, and an
    optional learner (``learning.Learner``) stores it and, every
    ``train_every`` steps, refreshes its normalisers, trains on its
    buffer and writes its parameters into the controller's model
    (``MPPI.model_params``: in place, no host sync)."""

    def __init__(self, env, controller, control_dt: float,
                 learner=None, train_every: int = 0,
                 waypoint_radius: float = 0.0):
        self.env = env
        self.controller = controller
        self.control_dt = float(control_dt)
        self.learner = learner
        self.train_every = int(train_every)
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
        for step in range(steps):
            u = self.controller.next(x)
            prev = self.env.getTime()
            x_next = x
            # step physics at its own dt until one control period elapsed
            while self.env.getTime() - prev < self.control_dt - 1e-12:
                x_next = self.env.step(np.reshape(u, (1, -1)),
                                       goal=self.env.getGoal())
            if hasattr(self.controller, "save"):
                self.controller.save(x, np.reshape(u, (-1, 1)), x_next)
            if self.learner is not None:
                self.learner.add_rb(np.reshape(x, (-1, 1)),
                                    np.reshape(u, (-1, 1)),
                                    np.reshape(x_next, (-1, 1)))
                if self.train_every and (step + 1) % self.train_every == 0:
                    self.train_step()
            states.append(np.reshape(x, (-1,)).copy())
            actions.append(np.reshape(u, (-1,)).copy())
            x = x_next
            if self.waypoint_radius > 0.0:
                self._advance_waypoints(x)
        states.append(np.reshape(x, (-1,)).copy())
        return np.asarray(states), np.asarray(actions)

    def train_step(self):
        """One refit: normalisers from the grown buffer (a no-op for
        analytic models), ``train_all``, and the learner's parameters
        written into the controller's model."""
        self.learner.stats()
        self.learner.train_all()
        self.controller.model_params = self.learner.params

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
                   log: bool = False, log_path: Optional[str] = None,
                   render: bool = False, seed: int = 0,
                   train_every: int = 0, dtype=torch.float32,
                   on_device: bool = False, device="cuda"):
    """Config-driven experiment: build env, model, cost and controller from
    the three YAML-family dicts and run the closed loop on ``device``
    (default the card; raises without a GPU, as ``MPPI`` does). ``log``
    attaches an ``Observer`` writing under ``log_path`` (default "logs"):
    config snapshots, per-solve metrics and one-step prediction errors.

    ``train_every`` > 0 builds a ``Learner`` over a copy of the model on
    the experiment's observer and refits every ``train_every`` steps.

    ``on_device=True`` runs the whole experiment (solve, plant substeps,
    pops, DMD refits) in the on-device loop (``envs/mjx_env.py``: on the
    card's kernel route one captured CUDA graph a control period): it
    needs a plant with a pure ``step_fn`` (env ``jax:point_mass``, the
    analytic AUV) and no ``train_every``; substeps = round(dt / plant dt);
    a waypoint task pops at its ``radius``; an adaptive DMD controller's
    identified params are written back into it; the observer gets the
    state and action rows after the run. The result then also holds
    ``fitted_model_params`` and ``on_device_ms_per_step`` (host clock
    around the loop, its capture and its one sync included).

    Returns {"states", "actions", "controller", "env", "observer",
    "learner"} (learner None without ``train_every``; observer None
    without ``log``). The caller closes the observer.
    """
    from ..controller import get_controller
    from . import get_env

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_experiment(device='cuda'): no GPU is present; pass "
            "device='cpu' for the plain CPU path")
    env = get_env(env_cfg, render=render, model_cfg=model_cfg)
    model, cost, _sigma = build_model_and_cost(
        env_cfg, task_cfg, model_cfg, dtype=dtype, device=device)
    observer = None
    if log:
        from ..observer import Observer

        observer = Observer(log_path=log_path, env_cfg=env_cfg,
                            task_cfg=task_cfg, model_cfg=model_cfg)
    controller = get_controller(model, cost, env_cfg, observer=observer,
                                seed=seed, device=device)
    if on_device:
        return _run_on_device(env, controller, cost, observer, env_cfg,
                              task_cfg, steps, train_every)
    learner = None
    if train_every:
        from ..learning import Learner

        # the experiment's observer: training curves beside the snapshots
        learner = Learner(model, observer=observer)
    runner = ClosedLoopRunner(env, controller,
                              control_dt=env_cfg.get("dt", 0.1),
                              learner=learner, train_every=train_every,
                              waypoint_radius=task_cfg.get("radius", 0.0))
    states, actions = runner.run(steps)
    return {"states": states, "actions": actions, "controller": controller,
            "env": env, "observer": observer, "learner": learner}


def _run_on_device(env, controller, cost, observer, env_cfg, task_cfg,
                   steps: int, train_every: int) -> dict:
    """``run_experiment``'s on-device branch (the JAX package's
    ``envs/runner.py:149-211``)."""
    import time

    from ..costs.waypoints import WayPointsCost
    from .mjx_env import on_device_closed_loop

    if train_every:
        raise ValueError(
            "on_device=True does not compose with train_every: the "
            "experiment runs on the device with no host loop to train in; "
            "run training experiments host-driven")
    if not hasattr(env, "step_fn"):
        raise ValueError(
            f"{type(env).__name__} has no step_fn; --on-device needs a "
            "device plant (env 'jax:point_mass', or the analytic AUV plant)")
    substeps = max(1, int(round(env_cfg.get("dt", 0.1) / env.dt)))
    x0 = np.reshape(env.getState(), (-1,))
    # a config's waypoint mission pops on the device as the host runner
    # pops it: at the task's 'radius' (0 or absent: no pops)
    radius = (task_cfg.get("radius", 0.0)
              if isinstance(cost, WayPointsCost) else 0.0) or None
    start = time.perf_counter()
    out = on_device_closed_loop(controller, env.step_fn, x0, steps,
                                substeps=substeps, waypoint_radius=radius)
    elapsed = time.perf_counter() - start
    fitted = None
    if len(out) == 3:
        # the identification ran on the device: the identified (A, B)
        # become the controller's, as a host refit's would
        fitted = out[2]
        controller.model_params = fitted
    states = np.concatenate([x0[None, :],
                             out[0].cpu().double().numpy()], axis=0)
    actions = out[1].cpu().double().numpy()
    if observer is not None:
        # the rows the host loop logs, after the run: each action beside
        # the state its solve started from (MPPI.next logs its input)
        for s, a in zip(states[:-1], actions):
            observer.write_control(state=s, action=a)
            observer.advance()
    return {"states": states, "actions": actions, "controller": controller,
            "env": env, "observer": observer, "learner": None,
            "fitted_model_params": fitted,
            "on_device_ms_per_step": 1e3 * elapsed / steps}
