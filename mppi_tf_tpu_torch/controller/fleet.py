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
- the kernel route: the fused solve objects of ``kernels/`` (point mass,
  AUV, NN) run the whole fleet as one launch of each kernel (the vehicle
  is a grid axis, ``mppi_common.cuh``); at fleet step s vehicle v draws
  the single-vehicle Philox stream of solve s * n + v (the port's
  counterpart of JAX's disjoint seed blocks seed + (s n + v) n_tiles), so a
  fleet launch equals n one-vehicle launches bit for bit.

On the kernel route on the card ``next`` replays one captured CUDA graph
of the whole step (``_StepGraph``): the states' and the step index's
uploads from pinned host buffers, the fleet solve and the update over
static buffers and the live cost params, the shifted sequences kept for
the next step, the actions' copy into a pinned host buffer. The host
writes the inputs, tests the freeze key (``controller/graph.freeze_key``),
replays and synchronises once. The first such step captures the graph
(its warm-up computes that step), and so does the first after something
the graph froze changes: the solve object or its constants, the schedule
tensor, the seed and flags, a model or cost tensor rebound, the AUV's
cached mass matrices (a ``model_params`` write of its mass), or
``load_state``. Goals, missions and parameters written in place are read
live. Every other fleet (the torch route, the CPU, ``mesh=``) steps
eagerly, as ``next_eager`` does. ``fleet_steps`` counts the steps of each
kind.

Fleets have no observer or log mode (JAX fleet.py:70-72).

``mesh=`` (a ``parallel.mesh.Mesh``) splits the fleet axis over the mesh's
shards, n / (mesh size) vehicles a shard, on the torch route (JAX
fleet.py:86-181): each vehicle's solve is local to its shard, so the solve
needs no collective. Across ranks every rank solves its own vehicles and
the ranks exchange the rows (``Mesh.all_gather``: a zeroed [n, ...] buffer
in which each rank writes its rows, summed, which is exact), so ``next``
returns every vehicle's action on every rank.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from .. import tracing
from .graph import add_replays, capture, freeze_key
from .mppi import MPPI

#: ``FleetMPPI.next`` calls by how they ran, in the process (read by
#: ``tracing.counters()``): replayed from a captured graph, eager, or the
#: step that captured one (its warm-up computes it)
fleet_steps = dict.fromkeys(("replayed", "eager", "captures"), 0)


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
    does: ``kernel="auto"`` runs ``NNAUVModel`` on the NN kernels too); the
    options normalize, antithetic, clip, filter and the noise schedule
    hold per vehicle. ``goals``: optional [n, goal_dim] per-vehicle goals
    applied through ``cost.set_goal`` (default: the cost's own goal for
    every vehicle). ``init_seq``: [tau, aDim] (shared) or [n, tau, aDim].
    ``device``: as for ``MPPI`` (the card unless ``"cpu"``). ``mesh``:
    the fleet axis split over the mesh's shards (module docstring), whose
    device it runs on; n must be divisible by the mesh size, and
    ``kernel="cuda"`` raises ``ValueError`` (``"auto"`` takes the torch
    route).
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
        self._mesh = mesh
        if mesh is not None:
            from .mppi import _KERNEL_ALIASES

            if _KERNEL_ALIASES.get(kernel, kernel) == "cuda":
                # an explicit kernel cannot be honoured on a fleet mesh (JAX
                # fleet.py:107-116); "auto" takes the torch route quietly
                raise ValueError(
                    "kernel='cuda' (the JAX package's 'pallas') does not "
                    "compose with mesh=: the mesh splits the fleet over its "
                    "shards on the torch route; use kernel='auto' or "
                    "'torch' with mesh, or drop mesh")
            kernel = "torch"
            device = mesh.one_device("FleetMPPI")
            axis = mesh.axis_names[0]
            if mesh.shape[axis] != mesh.size:
                raise ValueError(f"the fleet axis {axis!r} holds "
                                 f"{mesh.shape[axis]} of the mesh's "
                                 f"{mesh.size} shards")
            if n % mesh.size != 0:
                raise ValueError(f"n_vehicles={n} not divisible by mesh "
                                 f"axis {axis}={mesh.size}")
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
        self._graph = None       # the captured step (_StepGraph)

    # ------------------------------------------------------------------
    # the whole-fleet solve
    # ------------------------------------------------------------------
    def _row(self, cp: dict, v: int) -> dict:
        return {name: t[v] for name, t in cp.items()}

    @torch.no_grad()
    def _step(self, states, useq, cp, solve=None):
        """One fleet solve: states [n, sdim], sequences [n, tau, aDim],
        stacked cost params ``cp`` -> (actions [n, aDim], shifted
        sequences, info with [n]-leading cost_min / cost_mean / cost_max,
        weighted_noise and useq): on the kernel route one launch of each
        kernel for the fleet, else each vehicle's plain solve over its own
        generator. ``solve``: the fleet step (an int, or a one-element
        int64 tensor on the device, as the on-device loop's counter;
        default the fleet's step count)."""
        tpl, n = self._tpl, self._n
        fused = tpl._fused
        if fused is not None:
            solve = self._steps if solve is None else solve
            wnoise, info = fused.solve(states, useq, seed=tpl._base_seed,
                                       solve=solve,
                                       normalize=tpl._normalize_cost, cp=cp)
            actions, shifted, new_useq = tpl._postprocess(useq, wnoise)
            info = {"cost_min": info["cost_min"],
                    "cost_mean": info["cost_mean"],
                    "cost_max": info["cost_max"],
                    "weighted_noise": wnoise, "useq": new_useq}
            return actions, shifted, info
        outs = []
        gen_saved = tpl._gen
        vehicles = self._local_vehicles()
        try:
            for v in vehicles:
                with bound_params(self._cost, self._row(cp, v)):
                    tpl._gen = self._gens[v]
                    outs.append(tpl._solve(states[v], useq[v], tpl._sched))
        finally:
            tpl._gen = gen_saved
        keys = ("cost_min", "cost_mean", "cost_max", "weighted_noise",
                "useq")
        parts = [torch.stack([o[0] for o in outs]),
                 torch.stack([o[1] for o in outs]),
                 *(torch.stack([o[2][key] for o in outs]) for key in keys)]
        if len(vehicles) < n:
            parts = self._gather(parts)
        actions, shifted, *rest = parts
        return actions, shifted, dict(zip(keys, rest))

    def _local_vehicles(self) -> list:
        """The vehicles this process solves: all of them, or over a mesh
        the n / size of each of its local shards."""
        if self._mesh is None:
            return list(range(self._n))
        nl = self._n // self._mesh.size
        return [v for g in self._mesh.local_indices
                for v in range(g * nl, (g + 1) * nl)]

    def _gather(self, parts: list) -> list:
        """Every vehicle's rows of ``parts`` (each [local vehicles, ...])
        from every rank: one ``Mesh.all_gather`` of the packed rows."""
        mesh = self._mesh
        nl = self._n // mesh.size
        shapes = [p.shape[1:] for p in parts]
        rows = torch.cat([p.reshape(p.shape[0], -1) for p in parts], dim=1)
        g = mesh.all_gather(list(rows.split(nl))).reshape(self._n, -1)
        out, start = [], 0
        for shape in shapes:
            width = int(np.prod(shape, dtype=np.int64))
            out.append(g[:, start:start + width].reshape(self._n, *shape))
            start += width
        return out

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
        sequences, the noise streams and the step count advance. On the
        kernel route on the card one replay of the captured step (module
        docstring); ``_last_info`` then holds the graph's outputs, which
        the next step overwrites."""
        return self._next(states, self._graphed())

    def next_eager(self, states) -> np.ndarray:
        """``next`` with the step's operations enqueued one by one, never
        from a graph: the same bits."""
        return self._next(states, False)

    def _graphed(self) -> bool:
        """Whether ``next`` replays a graph: the card, no mesh, and the
        kernel route."""
        return (self._device.type == "cuda" and self._mesh is None
                and self._tpl._fused is not None)

    def _next(self, states, graph: bool) -> np.ndarray:
        with tracing.span("mppi.fleet.next", self._steps):
            if graph:
                if self._graph is None:
                    self._graph = _StepGraph(self)
                actions = self._graph.step(states)
            else:
                with tracing.span("mppi.fleet.upload"):
                    x = self._states(states)
                start = time.perf_counter()
                actions, self._useq, info = self._step(x, self._useq,
                                                       self._cparams)
                with tracing.span("mppi.fleet.actions"):
                    actions = actions.cpu().numpy()
                self._timing["total"] += time.perf_counter() - start
                self._last_info = info
                fleet_steps["eager"] += 1
            self._timing["calls"] += 1
            self._steps += 1
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
        # the captured step's buffers held the state left behind: the next
        # step captures anew from the restored fleet
        self._graph = None

    # on-device fleet experiment -----------------------------------------
    def build_on_device_loop(self, plant_step, steps: int,
                             substeps: int = 10,
                             waypoint_radius: Optional[float] = None):
        """All n vehicles' closed loops (the fleet solve, each vehicle's
        zero-order-hold action, ``substeps`` steps of the batched plant
        and, with a WayPointsCost and ``waypoint_radius``, every vehicle's
        pop) as one control period, on the device: on the kernel route on
        the card one captured CUDA graph, replayed ``steps`` times with one
        host sync a run (``envs/mjx_env.py``'s loop). Returns
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


class _StepGraph:
    """``FleetMPPI.next`` as one captured CUDA graph (module docstring).
    The graph's inputs are the pinned host buffers of the states and the
    step index, and ``useq``, the sequences the step starts from, which
    the graph overwrites with the shifted ones; its outputs are the pinned
    actions and ``info``. ``nodes`` holds the kernel launches of one step
    by entry point, ``graph_nodes`` its graph's nodes by kind and
    ``capture_s`` the last capture's seconds (span ``mppi.fleet.capture``;
    ``controller/graph.capture``)."""

    def __init__(self, fleet: FleetMPPI):
        n, sdim, adim = fleet._n, fleet._sdim, fleet._adim
        self.fleet = fleet
        like = {"dtype": fleet._dtype, "device": fleet._device}
        self.x_host = torch.zeros((n, sdim), dtype=fleet._dtype).pin_memory()
        self.step_host = torch.zeros(1, dtype=torch.int64).pin_memory()
        self.a_host = torch.zeros((n, adim), dtype=fleet._dtype).pin_memory()
        self.x_np, self.step_np, self.a_np = (
            t.numpy() for t in (self.x_host, self.step_host, self.a_host))
        self.state = torch.zeros((n, sdim), **like)
        self.useq = torch.zeros(tuple(fleet._useq.shape), **like)
        self.solve = torch.zeros(1, dtype=torch.int64, device=fleet._device)
        self.graph, self.key, self.info = None, None, None
        self.nodes, self.plant_nodes, self.graph_nodes = {}, {}, {}
        self.capture_s, self.z_held = None, {}
        # the sequence tensor ``useq`` was last loaded from or handed out
        # as, and its version: anything else is copied in before a step
        self.fed = (None, None)

    def _body(self) -> dict:
        """The step on the static buffers; returns its info."""
        fleet = self.fleet
        self.state.copy_(self.x_host, non_blocking=True)
        self.solve.copy_(self.step_host, non_blocking=True)
        actions, shifted, info = fleet._step(self.state, self.useq,
                                             fleet._cparams, solve=self.solve)
        self.useq.copy_(shifted)
        self.a_host.copy_(actions, non_blocking=True)
        return info

    def _capture(self) -> dict:
        """Capture the step (``controller/graph.capture``); returns the
        warm-up's info: the warm-up computes this step."""
        self.graph = self.info = None   # the old graph's pool goes first
        cap = capture("mppi.fleet.capture", self.fleet._device, self._body)
        self.graph, self.info = cap.graph, cap.out
        self.nodes, self.plant_nodes = cap.nodes, cap.plant_nodes
        self.graph_nodes, self.capture_s = cap.graph_nodes, cap.capture_s
        self.z_held = cap.z_held
        return cap.warm

    def step(self, states) -> np.ndarray:
        fleet = self.fleet
        with tracing.span("mppi.fleet.upload"):
            self.x_np[...] = np.asarray(states, np.float64).reshape(
                fleet._n, fleet._sdim)
            self.step_np[0] = fleet._steps
        start = time.perf_counter()
        useq = fleet._useq
        if self.fed[0] is not useq or self.fed[1] != useq._version:
            self.useq.copy_(useq)
        key = freeze_key(fleet._tpl, fleet._cparams.values())
        if key != self.key:
            info = self._capture()
            self.key = key
            fleet_steps["captures"] += 1
        else:
            with tracing.span("mppi.fleet.replay"):
                self.graph.replay()
            add_replays(self.nodes, self.plant_nodes, 1, self.z_held)
            info = self.info
            fleet_steps["replayed"] += 1
        # a tensor of its own a step: no later step writes what was handed
        # out
        out = self.useq.clone()
        with tracing.span("mppi.fleet.actions"):
            torch.cuda.current_stream(fleet._device).synchronize()
            actions = self.a_np.copy()
        fleet._timing["total"] += time.perf_counter() - start
        fleet._useq, fleet._last_info = out, info
        self.fed = (out, out._version)
        return actions
