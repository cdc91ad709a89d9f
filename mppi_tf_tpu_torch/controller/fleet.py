"""Fleet MPPI: one call replans N independent vehicles (the JAX package's
``controller/fleet.py``).

The vehicles share one model and one cost family; each has its own state,
nominal sequence, noise stream and cost params (goal or waypoint queue).
The port's costs keep their params as module buffers (``CostBase.params``),
so the fleet holds its own dict of stacked tensors [n, ...] keyed as
``cost.params()`` and binds a vehicle's rows into the cost wherever the
cost's own code has to run on them (a re-goal, a mission, the torch-route
solve). A re-goal writes the stacked rows in place: nothing is rebuilt or
recaptured.

Two routes, as for ``MPPI``:

- the torch route (the counterpart of the JAX package's vmapped XLA
  solve): each vehicle's plain solve over its own ``torch.Generator``,
  seeded from (seed, v);
- the kernel route: the fused solve objects of ``kernels/`` run the whole
  fleet as one launch of each kernel (``TwoPhaseSolve.fleet_axis``: the
  vehicle is a grid axis, ``mppi_common.cuh``); at fleet step s vehicle v
  draws the single-vehicle Philox stream of solve s * n + v (the port's
  counterpart of JAX's disjoint seed blocks seed + (s n + v) n_tiles), so a
  fleet launch equals n one-vehicle launches bit for bit. A solve object
  without the axis (the NN kernels) runs one launch a vehicle, with the
  same solve indices.

Fleets have no observer or log mode (JAX fleet.py:70-72), and
``mesh=`` (the fleet axis sharded over devices) is ROADMAP item 14.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from .mppi import MPPI


def _validated_goals(cost, goals, n: int) -> np.ndarray:
    """Per-vehicle goals [n, goal_dim] as float64, each row through the
    cost's ``validate_waypoint`` (a unit quaternion for the quaternion
    waypoints) before any of them is applied (JAX fleet.py:42-57)."""
    goals = np.asarray(goals, np.float64)
    if goals.ndim != 2 or goals.shape[0] != n:
        raise ValueError(
            f"goals must carry one row per vehicle: got "
            f"{goals.shape[0] if goals.ndim else 0} for n={n}")
    validate = getattr(cost, "validate_waypoint", None)
    if validate is not None:
        goals = np.stack([validate(g) for g in goals])
    return goals


@contextlib.contextmanager
def bound_params(cost, cp: dict):
    """The cost with its params bound to the tensors of ``cp`` (one
    vehicle's rows) for the block; a waypoint cost's host copy of its
    queue is kept as it was."""
    saved = {name: getattr(cost, name) for name in cp}
    host = {a: getattr(cost, a) for a in ("_host", "_host_count")
            if hasattr(cost, a)}
    try:
        for name, t in cp.items():
            setattr(cost, name, t)
        yield cost
    finally:
        for name, t in saved.items():
            setattr(cost, name, t)
        for a, v in host.items():
            setattr(cost, a, v)


def vehicle_seed(seed: int, v: int) -> int:
    """The torch route's generator seed of vehicle ``v``: distinct streams
    from one fleet seed."""
    return int(np.random.SeedSequence([int(seed), int(v)])
               .generate_state(1, np.uint64)[0])


def _fleet_pop(cost):
    """Every vehicle's waypoint pop at once: ``(cp [n, ...], states
    [n, sdim], r2) -> cp``, ``envs/mjx_env.waypoint_pop_arg_fn`` mapped
    over the vehicle axis (no host sync)."""
    from ..envs.mjx_env import waypoint_pop_arg_fn

    return torch.func.vmap(waypoint_pop_arg_fn(cost), in_dims=(0, 0, None))


def _waypoint_cost(cost, what: str):
    from ..costs.waypoints import WayPointsCost

    if not isinstance(cost, WayPointsCost):
        raise TypeError(f"{what} needs a WayPointsCost, the fleet runs "
                        f"{type(cost).__name__}")
    return cost


class FleetMPPI:
    """Batched MPPI over ``n_vehicles`` sharing one model and cost family.

    Same per-vehicle semantics as :class:`MPPI` (the template that carries
    the validated options and resolves the kernel as a single controller
    does: ``kernel="auto"`` keeps NN models on the torch route); the
    options normalize, antithetic, clip, filter and the noise schedule
    hold per vehicle. ``goals``: optional [n, goal_dim] per-vehicle goals
    applied through ``cost.set_goal`` (default: the cost's own goal for
    every vehicle). ``init_seq``: [tau, aDim] (shared) or [n, tau, aDim].
    ``device``: as for ``MPPI`` (the card unless ``"cpu"``).
    """

    def __init__(self, model, cost, n_vehicles: int, k: int, tau: int,
                 lam: float, upsilon: float, sigma=None, goals=None,
                 init_seq=None, normalize_cost: bool = False,
                 filter_seq: bool = False, filter_window: int = 9,
                 filter_polyorder: int = 3, clip_actions: bool = False,
                 antithetic: bool = False, seed: int = 0, mesh=None,
                 kernel: str = "auto", noise_schedule=None,
                 kernel_dtype: str = "float32", device="cuda"):
        n = int(n_vehicles)
        if n < 1:
            raise ValueError(f"n_vehicles must be >= 1, got {n}")
        if mesh is not None:
            raise NotImplementedError(
                "fleet-sharded controllers (FleetMPPI(mesh=)) are not "
                "ported yet: ROADMAP item 14")
        self._tpl = MPPI(model, cost, k=k, tau=tau, lam=lam, upsilon=upsilon,
                         sigma=sigma, normalize_cost=normalize_cost,
                         filter_seq=filter_seq, filter_window=filter_window,
                         filter_polyorder=filter_polyorder,
                         clip_actions=clip_actions, antithetic=antithetic,
                         seed=seed, kernel=kernel,
                         noise_schedule=noise_schedule,
                         kernel_dtype=kernel_dtype, device=device)
        tpl = self._tpl
        self._model, self._cost = tpl._model, tpl._cost
        self._n, self._tau = n, int(tau)
        self._sdim, self._adim = tpl._sdim, tpl._adim
        self._dtype, self._device = tpl._dtype, tpl._device
        self.kernel_path = tpl.kernel_path
        like = {"dtype": self._dtype, "device": self._device}

        if init_seq is None:
            self._useq = torch.zeros((n, self._tau, self._adim), **like)
        else:
            seq = np.asarray(init_seq, np.float64)
            if seq.shape == (self._tau, self._adim):   # a shared warm start
                seq = np.tile(seq[None], (n, 1, 1))
            if seq.shape != (n, self._tau, self._adim):
                raise ValueError(
                    f"init_seq must be [tau, aDim] or [n, tau, aDim], got "
                    f"{seq.shape}")
            self._useq = torch.as_tensor(seq, **like)
        self._gens = []
        for v in range(n):
            g = torch.Generator(device=self._device)
            g.manual_seed(vehicle_seed(seed, v))
            self._gens.append(g)
        # the cost's params at construction: what set_goals starts from
        # (JAX: cost.init_params())
        self._cp0 = {name: t.detach().clone()
                     for name, t in self._cost.params().items()}
        self._cparams = {name: t[None].repeat(n, *([1] * t.dim()))
                         for name, t in self._cp0.items()}
        if goals is not None:
            self.set_goals(goals)
        self._steps = 0
        self._timing = {"total": 0.0, "calls": 0}
        self._last_info = None   # per-vehicle solve info after each next()

    # ------------------------------------------------------------------
    # the whole-fleet solve
    # ------------------------------------------------------------------
    def _row(self, cp: dict, v: int) -> dict:
        return {name: t[v] for name, t in cp.items()}

    @torch.no_grad()
    def _step(self, states, useq, cp, solve=None, gens=None):
        """One fleet solve: states [n, sdim], sequences [n, tau, aDim],
        stacked cost params ``cp`` -> (actions [n, aDim], shifted
        sequences, info with [n]-leading cost_min / cost_mean / cost_max,
        weighted_noise and useq). ``solve``: the fleet step (an int, or a
        one-element int64 tensor on the device, as the on-device loop's
        counter; default the fleet's step count); ``gens``: the torch
        route's generators (default the fleet's)."""
        tpl, n = self._tpl, self._n
        solve = self._steps if solve is None else solve
        fused = tpl._fused
        if fused is not None and fused.fleet_axis:
            wnoise, info = fused.solve(states, useq, seed=tpl._base_seed,
                                       solve=solve,
                                       normalize=tpl._normalize_cost, cp=cp)
            actions, shifted, new_useq = tpl._postprocess(useq, wnoise)
            info = {"cost_min": info["cost_min"],
                    "cost_mean": info["cost_mean"],
                    "cost_max": info["cost_max"],
                    "weighted_noise": wnoise, "useq": new_useq}
            return actions, shifted, info
        gens = self._gens if gens is None else gens
        outs = []
        gen_saved = tpl._gen
        try:
            for v in range(n):
                with bound_params(self._cost, self._row(cp, v)):
                    if fused is not None:   # one launch a vehicle
                        outs.append(tpl._fused_step(
                            states[v], useq[v], solve=solve * n + v))
                    else:
                        tpl._gen = gens[v]
                        outs.append(tpl._solve(states[v], useq[v],
                                               tpl._sched))
        finally:
            tpl._gen = gen_saved
        actions = torch.stack([o[0] for o in outs])
        shifted = torch.stack([o[1] for o in outs])
        info = {key: torch.stack([o[2][key] for o in outs])
                for key in ("cost_min", "cost_mean", "cost_max",
                            "weighted_noise", "useq")}
        return actions, shifted, info

    def _states(self, states) -> torch.Tensor:
        """Host states [n, sDim] on the fleet's device: pinned and
        non-blocking on the card, so that the actions' copy stays the
        step's one sync."""
        x = torch.as_tensor(
            np.asarray(states, np.float64).reshape(self._n, self._sdim),
            dtype=self._dtype)
        if self._device.type == "cuda":
            return x.pin_memory().to(self._device, non_blocking=True)
        return x.to(self._device)

    # ------------------------------------------------------------------
    # user-facing surface
    # ------------------------------------------------------------------
    def next(self, states) -> np.ndarray:
        """Replan the whole fleet: states [n, sDim] -> actions [n, aDim]
        (numpy), with one host sync (the actions' copy); the nominal
        sequences, the noise streams and the step count advance."""
        x = self._states(states)
        start = time.perf_counter()
        actions, self._useq, info = self._step(x, self._useq, self._cparams)
        actions = actions.cpu().numpy()
        self._timing["total"] += time.perf_counter() - start
        self._timing["calls"] += 1
        self._steps += 1
        self._last_info = info
        return actions

    def _goal_rows(self, cp: dict, goal) -> None:
        """Apply ``cost.set_goal(goal)`` to one vehicle's params ``cp``
        (rows written in place)."""
        with bound_params(self._cost, cp):
            self._cost.set_goal(goal)

    def set_goals(self, goals) -> None:
        """Re-task every vehicle: goals [n, goal_dim], each applied to the
        cost's params of construction time. Data only: nothing rebuilt."""
        goals = _validated_goals(self._cost, goals, self._n)
        for v, g in enumerate(goals):
            cp = {name: t.clone() for name, t in self._cp0.items()}
            self._goal_rows(cp, g)
            for name, t in cp.items():
                self._cparams[name][v].copy_(t)

    def _vehicle(self, i) -> int:
        if not 0 <= int(i) < self._n:
            raise IndexError(f"vehicle {i} out of range [0, {self._n})")
        return int(i)

    def set_vehicle_goal(self, i: int, goal) -> None:
        """Re-task vehicle ``i`` only."""
        i = self._vehicle(i)
        cp = {name: t[i].clone() for name, t in self._cparams.items()}
        self._goal_rows(cp, goal)
        for name, t in cp.items():
            self._cparams[name][i].copy_(t)

    def set_vehicle_waypoints(self, i: int, waypoints) -> None:
        """Replace vehicle ``i``'s waypoint queue (a WayPointsCost fleet),
        checked by ``controller/missions.py`` (capacity, dims,
        non-empty)."""
        from .missions import mission_params

        i = self._vehicle(i)
        _waypoint_cost(self._cost, "set_vehicle_waypoints")
        cp = {name: t[i].clone() for name, t in self._cparams.items()}
        with bound_params(self._cost, cp):
            mission_params(self._cost, waypoints)
        for name, t in cp.items():
            self._cparams[name][i].copy_(t)

    def waypoints_remaining(self) -> np.ndarray:
        """Per-vehicle active queue lengths, [n] int array."""
        _waypoint_cost(self._cost, "waypoint missions")
        return self._cparams["count"].cpu().numpy()

    @torch.no_grad()
    def advance_waypoints(self, states, radius: float) -> int:
        """Pop the leading waypoint of every vehicle within ``radius`` of
        it (more than one leg left), all vehicles in one batched pop; one
        host sync. Returns how many queues advanced."""
        cost = _waypoint_cost(self._cost, "advance_waypoints")
        if getattr(self, "_pop", None) is None:
            self._pop = _fleet_pop(cost)
        x = self._states(states)
        old = self._cparams["count"].clone()
        new = self._pop(self._cparams, x, float(radius) ** 2)
        for name, t in new.items():
            self._cparams[name].copy_(t)
        return int((old - self._cparams["count"]).sum())

    # checkpoint / resume (MPPI.save_state's .npz scheme) ---------------
    def save_state(self, path: str) -> None:
        from .state_io import cparams_entries

        np.savez(
            path,
            useq=self._useq.cpu().numpy(),
            gen_states=np.stack([g.get_state().numpy()
                                 for g in self._gens]),
            steps=self._steps,
            timing_total=self._timing["total"],
            timing_calls=self._timing["calls"],
            **cparams_entries(self._cparams))

    def load_state(self, path: str) -> None:
        from .state_io import load_cparams

        d = np.load(path)
        if d["useq"].shape != tuple(self._useq.shape):
            raise ValueError(
                f"checkpoint useq {d['useq'].shape} != fleet "
                f"{tuple(self._useq.shape)}")
        self._useq = torch.as_tensor(d["useq"], dtype=self._dtype,
                                     device=self._device)
        for g, state in zip(self._gens, d["gen_states"]):
            g.set_state(torch.from_numpy(state))
        self._steps = int(d["steps"])
        self._timing = {"total": float(d["timing_total"]),
                        "calls": int(d["timing_calls"])}
        load_cparams(d, self._cparams)

    # on-device fleet experiment -----------------------------------------
    def build_on_device_loop(self, plant_step, steps: int,
                             substeps: int = 10,
                             waypoint_radius: Optional[float] = None):
        """All n vehicles' closed loops (the fleet solve, each vehicle's
        zero-order-hold action, ``substeps`` steps of the batched plant
        and, with a WayPointsCost and ``waypoint_radius``, every vehicle's
        pop) as one control period, on the device: on the kernel route on
        the card one captured CUDA graph, replayed ``steps`` times with one
        host sync a run (``envs/mjx_env.py``'s machinery). Returns
        ``run(states0, generators=None, useq0=None, mparams=None,
        cparams=None, step0=None) -> (states [steps, n, sDim], actions
        [steps, n, aDim])``.

        ``plant_step(x [n, sDim], u [n, aDim]) -> [n, sDim]`` is batched
        over the vehicles (``DevicePointMassEnv.step_fn``,
        ``AUVEnv.step_fn``). Period j of a run is fleet step step0 + j
        (vehicle v draws solve (step0 + j) n + v); ``step0`` defaults to
        the fleet's step count, which the run advances, so host ``next``
        calls and on-device runs share one stream. Model and cost params
        are the fleet's current ones at each call (a re-task between runs
        recaptures nothing); an explicit ``cparams`` ([n, ...], the stacked
        layout) is a what-if run and leaves the mission as it was.
        ``run.eager(...)`` runs the same periods without a graph."""
        from ..envs.mjx_env import FleetLoop

        if waypoint_radius is not None:
            _waypoint_cost(self._cost, "waypoint_radius")
        return FleetLoop(self, plant_step, steps, substeps, waypoint_radius)

    # accessors ----------------------------------------------------------
    @property
    def n_vehicles(self) -> int:
        return self._n

    @property
    def useq(self) -> torch.Tensor:
        return self._useq

    @property
    def cost_params(self) -> dict:
        """The fleet's stacked cost params {name: [n, ...]} (live)."""
        return self._cparams

    @property
    def timing(self) -> dict:
        return dict(self._timing)

    @property
    def model_params(self) -> dict:
        return self._tpl.model_params

    @model_params.setter
    def model_params(self, params) -> None:
        self._tpl.model_params = params

