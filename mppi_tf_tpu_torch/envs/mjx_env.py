"""On-device plant and the on-device closed loop.

Counterpart of ``mppi_tf_tpu/envs/mjx_env.py``. The reference's plant is a
host-side simulator (scripts/src/mujoco/simulation.py:26-55), so every
control step round-trips between the host and the device. Here the plant
is a pure function on tensors, ``step_fn(x, u) -> x_next``, and the whole
control period (the solve, the zero-order-hold action, ``substeps`` plant
steps, the waypoint pop and the DMD window write and refit) runs on the
device:

- on the card, on the kernel route (``kernel="cuda"``), one control period
  is captured as a CUDA graph (``controller/graph.py``) and replayed
  ``steps`` times; the host synchronises once, at the end of ``run``. The
  kernels read the Philox solve index from a device counter that the
  period advances (``_launch.solve_words``), so every replay draws the
  next solve's noise;
- on the card, on the torch route (``kernel="torch"``), the period runs
  eagerly, with no host sync until the end of ``run``: it draws its noise
  from the controller's own ``torch.Generator``, which this loop does not
  register with a graph;
- on the CPU (the tests), the period runs eagerly.

``DevicePointMassEnv`` is the counterpart of the JAX package's
``JaxPointMassEnv``: the frictionless point mass whose exact LTI update is
RK4 at any dt, with the host Simulation API (getState / step / getTime /
getGoal / reset) for the generic runner. The analytic AUV plant
(``envs/analytic.AUVEnv.step_fn``) has the same surface.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from .. import tracing
from ..controller.graph import add_replays, capture, freeze_key
from ..kernels import plant


class DevicePointMassEnv:
    """Point-mass plant whose ``step_fn`` is a pure function on tensors
    (the JAX package's ``JaxPointMassEnv``). State is the interleaved
    [q0, v0, q1, v1, ...] column of the reference state read
    (simulation.py:32-37). The host API keeps its state as a CPU tensor
    in ``dtype``."""

    def __init__(self, n_dof: int = 3, mass: float = 1.0, dt: float = 0.01,
                 goal=None, render: bool = False, dtype=torch.float32):
        self.n_dof = int(n_dof)
        self.mass = float(mass)
        self.dt = float(dt)
        self.render = render  # accepted for API parity; nothing to draw
        if goal is None:
            goal = np.zeros(2 * self.n_dof)
        self.goal = np.asarray(goal, np.float64).reshape(2 * self.n_dof, 1)
        self._t = 0.0
        self._x = torch.zeros(2 * self.n_dof, dtype=dtype)

    # --- on-device surface ----------------------------------------------
    def step_fn(self, x: torch.Tensor, u: torch.Tensor,
                substeps: int = 1) -> torch.Tensor:
        """``substeps`` physics steps under the held force u, pure, on x's
        device: x [2n] interleaved, u [n] -> [2n], or a fleet's [V, 2n] and
        [V, n] -> [V, 2n]. The exact LTI update (RK4 for this plant), in
        the JAX package's order of operations (mjx_env.py:57-70), vehicle
        by vehicle: on the card one launch of the plant kernel
        (``kernels/plant.pm_step``), on the CPU ``substeps`` torch steps."""
        return plant.pm_step(x, u, self.n_dof, self.mass, self.dt, substeps)

    # --- host Simulation API (reference simulation.py:26-55) -------------
    def getTime(self) -> float:
        return self._t

    def getGoal(self) -> np.ndarray:
        return self.goal

    def getState(self) -> np.ndarray:
        return self._x.double().numpy().reshape(-1, 1)

    def setState(self, x) -> None:
        self._x = torch.as_tensor(np.asarray(x, np.float64).reshape(-1),
                                  dtype=self._x.dtype)

    def step(self, u, goal=None) -> np.ndarray:
        u = torch.as_tensor(np.asarray(u, np.float64).reshape(-1),
                            dtype=self._x.dtype)
        self._x = self.step_fn(self._x, u)
        self._t += self.dt
        return self.getState()

    def reset(self, x0=None) -> np.ndarray:
        self._t = 0.0
        if x0 is None:
            self._x = torch.zeros_like(self._x)
        else:
            self.setState(x0)
        return self.getState()


def _dmd_window(ctrl, W: int):
    """The adaptive controller's current replay content as the loop's
    fixed-capacity ring window (obs [W, sDim], act [W, aDim], nxt [W, sDim]
    on the controller's device, newest last, zero rows past the content:
    exact no-ops for the least squares) and its count n0 (an int). Cached
    on the controller under the replay's monotonic add counter, so runs
    with an unchanged replay skip the host work and the upload; the upload
    is pinned and non-blocking (no host sync). The loop copies the window
    into its own buffers: the cached tensors are never written."""
    ver = (getattr(ctrl.replay, "total_added", None), W)
    cached = getattr(ctrl, "_dmd_window_cache", None)
    if cached is not None and ver[0] is not None and cached[0] == ver:
        return cached[1]
    model = ctrl._model
    ms, ma = model.get_state_dim(), model.get_action_dim()
    tr = ctrl.replay.get_all_transitions()
    n0 = min(tr["obs"].shape[0], W)
    rows = []
    for key, dim in (("obs", ms), ("act", ma), ("next_obs", ms)):
        a = np.zeros((W, dim))
        if n0:
            a[:n0] = tr[key][-n0:]
        t = torch.as_tensor(a, dtype=ctrl._dtype)
        if ctrl._device.type == "cuda":
            t = t.pin_memory().to(ctrl._device, non_blocking=True)
        rows.append(t)
    win = (*rows, n0)
    if ver[0] is not None:
        ctrl._dmd_window_cache = (ver, win)
    return win


def waypoint_pop_arg_fn(cost):
    """Device-side waypoint advancement with the squared radius as an
    argument: ``(cp, state [sdim], r2) -> cp`` over the queue's tensors
    cp = {"count", "waypoints"}: pop (``costs/waypoints.pop_queue``) where
    sum(d * d) < r2 for d = cost.dist(state) to the leading waypoint and
    at least two waypoints remain, chosen with ``torch.where`` (no host
    sync). The JAX package's ``waypoint_pop_arg_fn`` (mjx_env.py:140-156).
    """
    from ..costs.waypoints import pop_queue

    def maybe_pop(cp, state, r2):
        d = cost.dist(state, waypoint=cp["waypoints"][0])
        hit = torch.logical_and(torch.sum(d * d) < r2, cp["count"] >= 2)
        popped = pop_queue(cp)
        return {name: torch.where(hit, popped[name], cp[name])
                for name in cp}

    return maybe_pop


def waypoint_pop_fn(cost, radius: float):
    """``(cp, state) -> cp``: ``waypoint_pop_arg_fn`` at the fixed radius
    of one experiment (the JAX package's ``waypoint_pop_fn``)."""
    r2 = float(radius) ** 2
    pop = waypoint_pop_arg_fn(cost)

    def maybe_pop(cp, state):
        return pop(cp, state, r2)

    return maybe_pop


def build_on_device_loop(ctrl, plant_step, steps: int, substeps: int = 10,
                         refit_window: int | None = None,
                         waypoint_radius: float | None = None):
    """``steps`` control periods of [MPPI solve -> zero-order-hold action
    -> ``substeps`` plant steps] on the device (module docstring). Returns
    ``run(x0, generator=None, useq0=None, mparams=None, cparams=None,
    window=None, step0=None) -> (states, actions)``, tensors [steps, sDim]
    and [steps, aDim] on the controller's device: the state after each
    period and the action it applied. ``useq0`` warm-starts the nominal
    sequence (default zeros). Model and cost parameters are read from the
    controller at each call (``mparams`` / ``cparams`` override them for
    that run alone, in the JAX package's layouts), so a learner update, a
    ``set_goal`` or new replay transitions between calls take effect;
    ``generator`` replaces the controller's ``torch.Generator`` for the
    torch route's noise during the run. The solve index of period j is
    ``step0 + j``, with ``step0`` the controller's step count, which the
    run advances by ``steps``: host ``next`` calls and on-device periods
    share one Philox stream (the JAX review's fault, mjx_env.py:333-343).
    ``run.eager(...)`` runs the same periods without a graph.

    ``plant_step`` is a pure (x, u) -> x_next at the physics dt
    (``DevicePointMassEnv.step_fn``, ``AUVEnv.step_fn``). A plant that
    declares a ``substeps`` parameter is called once a period,
    ``plant_step(x, u, substeps=substeps)`` (on the card the two plants
    then step all the substeps in one kernel); any other is called
    ``substeps`` times.

    **Adaptive DMD** (``controller.dmd.DMDAdaptiveMixin``): each period
    also writes its (x, u, x') into a ring window of ``refit_window`` rows
    (default min(replay capacity, 256)), seeded at each call from the
    replay (``_dmd_window``, or ``window=``), and every ``refit_every``
    periods, once ``min_samples`` transitions are in it, (A, B) are
    re-identified from the window in place by ``DMDModel.fit``. Without
    truncation that fit is a QR with no sync, captured as a second graph
    and replayed after the period's; a model with ``rank`` set fits by
    the SVD, run between the replays with one host sync a refit.
    ``run`` then returns ``(states, actions, fitted)``, fitted the
    identified {"A", "B"}; the controller's model is left as it was (the
    runner writes the fitted params back, as the JAX package's does).

    **Missions**: with a ``WayPointsCost`` and ``waypoint_radius`` the
    queue pops inside the period (``waypoint_pop_fn``, after the plant as
    the host runner orders it). After a run the controller's queue is the
    loop's final queue and its host copy is refreshed (``sync_host``); an
    explicit ``cparams`` leaves the mission as it was.

    The graph is captured once for each (controller, plant, steps,
    substeps, radius) and again when something it froze changes: the
    solve object or its constants, the schedule tensor
    (``set_noise_schedule`` replaces it), the seed, the controller's
    flags, a model or cost tensor rebound, or a model's cached derived
    values (``AUVModel.precompute``). Parameters written in place
    (``MPPI.model_params``, ``set_goal``, a mission) are read live.

    **Mesh-sharded controllers** (``ShardedMPPI``, ``ShardedFusedMPPI``
    and their DMD classes; JAX mjx_env.py:233-260) run the same period:
    every shard's launches and the collectives. On a local mesh the
    graph holds every shard's launches and the local reductions; over an
    NCCL group it holds the all-reduces too (the capture's warm-up runs
    the first collective outside it). A gloo group reduces on the host,
    which a graph cannot hold: ``run(...)`` raises ``ValueError`` there
    and ``run.eager(...)`` runs the periods. A torch-route sharded
    controller's ``generator`` is a list, one a local shard.
    """
    from ..controller.mppi import MPPI

    if not isinstance(ctrl, MPPI):
        raise TypeError(
            f"{type(ctrl).__name__}: the on-device loop runs the MPPI "
            "controllers (single-device or mesh-sharded)")
    return OnDeviceLoop(ctrl, plant_step, steps, substeps, refit_window,
                        waypoint_radius)


class _Buffers:
    """The tensors a period reads and writes, owned by the loop, so that
    a captured graph's addresses stay valid across runs: a row a vehicle
    where ``owner`` is a fleet (its sequences lead with [n]), and the DMD
    ring window where ``W`` is given."""

    def __init__(self, owner, steps: int, W=None):
        like = {"dtype": owner._dtype, "device": owner._device}
        lead = tuple(owner.useq.shape[:-2])
        sdim, adim = owner._sdim, owner._adim
        self.state = torch.zeros(*lead, sdim, **like)
        self.useq = torch.zeros(tuple(owner.useq.shape), **like)
        self.states = torch.zeros(steps, *lead, sdim, **like)
        self.actions = torch.zeros(steps, *lead, adim, **like)
        idx = {"dtype": torch.int64, "device": owner._device}
        self.solve = torch.zeros(1, **idx)   # the period's solve index
        self.row = torch.zeros(1, **idx)     # the period's output row
        if W is not None:
            ma = owner._model.get_action_dim()
            self.obs = torch.zeros(W, sdim, **like)
            self.act = torch.zeros(W, ma, **like)
            self.nxt = torch.zeros(W, sdim, **like)
            self.cnt = torch.zeros(1, **idx)


class _FleetBuffers(_Buffers):
    """A fleet loop's tensors, with the loop's own copy of the stacked
    cost params, which the period reads and its pops write."""

    def __init__(self, fleet, steps: int):
        super().__init__(fleet, steps)
        self.cp = {name: torch.zeros_like(t)
                   for name, t in fleet.cost_params.items()}


def _clone(tensors: dict) -> dict:
    return {n: t.detach().clone() for n, t in tensors.items()}


def _copy(dst: dict, src: dict) -> None:
    for n, t in dst.items():
        t.copy_(src[n])


class OnDeviceLoop:
    """The ``run`` of ``build_on_device_loop``. After a captured run,
    ``nodes`` holds the kernel launches of one captured period by entry
    point (the solve's, ``_launch``), ``plant_nodes`` the plant kernel's
    (``kernels/plant.py``), ``graph_nodes`` the period graph's nodes by
    kind (kernel, memcpy, memset, other), ``capture_s`` the warm-up and
    capture time of the last capture on the ``mppi.loop.capture`` span's
    clock (None before one), ``captures`` how many there were; ``useq`` is
    the nominal sequence the last run ended with. ``plant_calls`` is the
    plant calls of one period: 1 where the plant steps every substep in
    one call, else ``substeps``."""

    #: the attribute of ``owner`` (whose step count a run advances) that
    #: holds the torch route's generator, which ``run(generator=)``
    #: replaces for the run
    _GEN = "_gen"

    def __init__(self, ctrl, plant_step, steps: int, substeps: int,
                 refit_window, waypoint_radius):
        from ..controller.dmd import DMDAdaptiveMixin
        from ..costs.waypoints import WayPointsCost

        self.ctrl = self.owner = ctrl
        self._setup(plant_step, steps, substeps)
        self.adaptive = isinstance(ctrl, DMDAdaptiveMixin)
        self.W = None
        if self.adaptive:
            self.W = (min(ctrl.replay.capacity, 256) if refit_window is None
                      else int(refit_window))
        self.pop = None
        if waypoint_radius is not None:
            if not isinstance(ctrl._cost, WayPointsCost):
                raise TypeError(
                    "waypoint_radius needs a WayPointsCost controller, got "
                    f"{type(ctrl._cost).__name__}")
            self.pop = waypoint_pop_fn(ctrl._cost, waypoint_radius)

    def _setup(self, plant_step, steps: int, substeps: int) -> None:
        """The plant, the period's shape and how a period calls the plant
        (``plant_calls``, read once from the plant's signature); no
        buffers or graph yet."""
        self.plant_step = plant_step
        self.steps, self.substeps = int(steps), int(substeps)
        self._fused_plant = (self.substeps > 1 and "substeps" in
                             inspect.signature(plant_step).parameters)
        self.plant_calls = 1 if self._fused_plant else self.substeps
        self._bufs = None
        self._graphs = None      # (period graph, refit graph or None)
        self._frozen = None      # what the graphs froze (freeze_key)
        self.nodes, self.capture_s, self.captures = {}, None, 0
        self.plant_nodes, self.graph_nodes = {}, {}

    @property
    def useq(self) -> torch.Tensor:
        return self._bufs.useq.clone()

    def _plant(self, x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """The period's substeps of the plant under the held action."""
        if self._fused_plant:
            return self.plant_step(x, action, substeps=self.substeps)
        for _ in range(self.substeps):
            x = self.plant_step(x, action)
        return x

    # --- the period -------------------------------------------------------
    @torch.no_grad()
    def _period(self, b: _Buffers) -> None:
        """One control period on the loop's buffers; the state, the
        sequence, the window and the counters are written in place."""
        ctrl = self.ctrl
        if ctrl._fused is not None:
            ctrl._fused.forget_cached_terms()
            action, shifted, _ = ctrl._fused_step(b.state, b.useq,
                                                  solve=b.solve)
        else:
            action, shifted, _ = ctrl._solve(b.state, b.useq, ctrl._sched)
        x = self._plant(b.state, action)
        if self.pop is not None:
            cost = ctrl._cost
            cp = self.pop({"count": cost.count,
                           "waypoints": cost.waypoints}, x)
            cost.count.copy_(cp["count"])
            cost.waypoints.copy_(cp["waypoints"])
        if self.adaptive:
            j = torch.remainder(b.cnt, self.W)
            b.obs.index_copy_(0, j, b.state[None].to(b.obs.dtype))
            b.act.index_copy_(0, j, action[None, :b.act.shape[1]].to(
                b.act.dtype))
            b.nxt.index_copy_(0, j, x[None].to(b.nxt.dtype))
            b.cnt.add_(1)
        b.states.index_copy_(0, b.row, x[None].to(b.states.dtype))
        b.actions.index_copy_(0, b.row, action[None].to(b.actions.dtype))
        b.row.add_(1)
        b.solve.add_(1)
        b.state.copy_(x)
        b.useq.copy_(shifted)

    @torch.no_grad()
    def _fit(self, b: _Buffers) -> None:
        """Re-identify (A, B) from the window, in place in the model."""
        model = self.ctrl._model
        g = model.fit(b.obs, b.act, b.nxt)
        model.A.copy_(g["A"])
        model.B.copy_(g["B"])

    def _refits(self, step0: int, n0: int) -> set:
        """The periods j after which the window is refit (the JAX loop's
        do_fit on the host: the schedule is known before the run)."""
        if not self.adaptive:
            return set()
        ctrl = self.ctrl
        return {j for j in range(self.steps)
                if (step0 + j + 1) % ctrl._refit_every == 0
                and n0 + j + 1 >= ctrl._min_samples}

    # --- capture ----------------------------------------------------------
    def _graphed(self) -> bool:
        return self.ctrl._fused is not None and self.ctrl._device.type == \
            "cuda"

    def _check_capturable(self) -> None:
        """A mesh over a gloo group reduces on the host: no graph."""
        mesh = getattr(self.ctrl, "_mesh", None)
        if mesh is not None and mesh.backend == "gloo":
            raise ValueError(
                "the controller's mesh reduces over a gloo group, on the "
                "host, which a CUDA graph cannot capture: use run.eager(...) "
                "(or an NCCL group, one GPU a rank)")

    def _freeze_key(self) -> tuple:
        return freeze_key(self.ctrl, self.ctrl._cost.params().values())

    def _capture(self, b: _Buffers, with_fit: bool) -> None:
        """Capture one period (and the refit) as graphs
        (``controller/graph.capture``); the warm-up's writes are undone by
        the caller's load."""
        cap = capture("mppi.loop.capture", self.ctrl._device,
                      lambda: self._period(b),
                      (lambda: self._fit(b)) if with_fit else None)
        self._graphs = (cap.graph, cap.second)
        self.nodes, self.plant_nodes = cap.nodes, cap.plant_nodes
        self.graph_nodes, self.capture_s = cap.graph_nodes, cap.capture_s
        self.captures += 1

    # --- run --------------------------------------------------------------
    def __call__(self, x0, generator=None, useq0=None, mparams=None,
                 cparams=None, window=None, step0=None):
        graph = self._graphed()
        if graph:
            self._check_capturable()
        return self._run(x0, generator, useq0, mparams, cparams, window,
                         step0, graph=graph)

    def eager(self, x0, generator=None, useq0=None, mparams=None,
              cparams=None, window=None, step0=None):
        """``run`` with every period executed eagerly (no graph)."""
        return self._run(x0, generator, useq0, mparams, cparams, window,
                         step0, graph=False)

    def _upload(self, a) -> torch.Tensor:
        """Host data as a tensor in the controller's dtype on its device:
        pinned and non-blocking on the card (no host sync)."""
        ctrl = self.ctrl
        t = (a.detach() if isinstance(a, torch.Tensor)
             else torch.as_tensor(np.asarray(a, np.float64)))
        if t.device.type == "cpu" and ctrl._device.type == "cuda":
            t = t.to(ctrl._dtype).pin_memory()
            self._staged.append(t)
        return t.to(device=ctrl._device, dtype=ctrl._dtype,
                    non_blocking=True)

    def _new_buffers(self) -> _Buffers:
        return _Buffers(self.ctrl, self.steps, self.W)

    def _cost_params(self, cparams):
        """The run's cost params, as ``(load, end)``: ``cparams`` written
        over the cost's own for this run alone (``end`` restores them); on
        a mission the queue rewound by each ``load`` (a capture's warm-up
        pops it) and, at ``end``, its copy to the host started. ``end``
        returns what refreshes the cost's host copy of the queue once the
        run has synchronised, or None."""
        cost = self.ctrl._cost
        cost_t = cost.params()
        orig = _clone(cost_t) if cparams is not None else None
        if cparams is not None:
            for name, v in cparams.items():
                cost_t[name].copy_(self._upload(v).to(cost_t[name].dtype)
                                   .reshape(cost_t[name].shape))
        init = _clone(cost_t) if self.pop is not None else None

        def load():
            if init is not None:
                _copy(cost_t, init)

        def end():
            if orig is not None:
                _copy(cost_t, orig)
            if self.pop is None or cparams is not None:
                return None
            queue = (cost.waypoints.to("cpu", non_blocking=True),
                     cost.count.to("cpu", non_blocking=True))
            return lambda: cost.sync_host(*queue)

        return load, end

    @torch.no_grad()
    def _run(self, x0, generator, useq0, mparams, cparams, window, step0,
             graph: bool):
        from ..interop import _model_tensors

        ctrl, owner, steps = self.ctrl, self.owner, self.steps
        if step0 is None:
            step0 = owner._steps
            owner._steps = step0 + steps
        with tracing.span("mppi.loop.run", step0):
            with tracing.span("mppi.loop.load"):
                self._staged = []
                if self._bufs is None:
                    self._bufs = self._new_buffers()
                b = self._bufs
                x0 = self._upload(x0).reshape(b.state.shape)
                useq0 = (torch.zeros_like(b.useq) if useq0 is None
                         else self._upload(useq0).reshape(b.useq.shape))
                model_t = _model_tensors(ctrl._model)
                orig_m = (_clone(model_t)
                          if mparams is not None or self.adaptive else None)
                if mparams is not None:
                    ctrl.model_params = mparams
                load_cost, end_cost = self._cost_params(cparams)
                # what each run starts from, after the overrides: the
                # warm-up of a capture writes the model (a refit)
                init_m = _clone(model_t) if self.adaptive else None
                win = None
                if self.adaptive:
                    win = (_dmd_window(ctrl, self.W) if window is None
                           else window)
                n0 = int(win[3]) if win is not None else 0

            def load():
                with tracing.span("mppi.loop.load"):
                    b.state.copy_(x0)
                    b.useq.copy_(useq0)
                    b.solve.fill_(step0)
                    b.row.zero_()
                    if win is not None:
                        for buf, src in zip((b.obs, b.act, b.nxt), win[:3]):
                            buf.copy_(self._upload(src))
                        b.cnt.fill_(n0)
                    if init_m is not None:
                        _copy(model_t, init_m)
                    load_cost()

            refits = self._refits(step0, n0)
            ridge = self.adaptive and ctrl._model.rank is None
            gen_saved = getattr(owner, self._GEN)
            if generator is not None:
                setattr(owner, self._GEN, generator)
            try:
                if graph:
                    key = self._freeze_key()
                    if key != self._frozen:
                        load()
                        self._capture(b, with_fit=ridge)
                        self._frozen = key
                    load()
                    period, fit = self._graphs
                    with tracing.span("mppi.loop.replay"):
                        for j in range(steps):
                            period.replay()
                            if j in refits:
                                if ridge:
                                    fit.replay()
                                else:
                                    self._fit(b)
                        add_replays(self.nodes, self.plant_nodes, steps)
                else:
                    load()
                    for j in range(steps):
                        self._period(b)
                        if j in refits:
                            self._fit(b)
            finally:
                setattr(owner, self._GEN, gen_saved)
                if ctrl._fused is not None:
                    ctrl._fused.forget_cached_terms()
            with tracing.span("mppi.loop.sync"):
                states, actions = b.states.clone(), b.actions.clone()
                fitted = None
                if self.adaptive:
                    fitted = {"A": ctrl._model.A.detach().clone(),
                              "B": ctrl._model.B.detach().clone()}
                if orig_m is not None:
                    _copy(model_t, orig_m)
                synced = end_cost()
                if ctrl._device.type == "cuda":
                    # the run's one host sync
                    torch.cuda.current_stream(ctrl._device).synchronize()
                self._staged = []
                if synced is not None:
                    synced()
        if self.adaptive:
            return states, actions, fitted
        return states, actions


class FleetLoop(OnDeviceLoop):
    """The ``run`` of ``FleetMPPI.build_on_device_loop``: ``OnDeviceLoop``'s
    run over a fleet's period (the fleet solve, the batched plant, every
    vehicle's pop), the fleet's step count and generators in the
    controller's place. ``nodes``, ``plant_nodes``, ``graph_nodes``,
    ``capture_s``, ``captures`` and ``plant_calls`` as there."""

    _GEN = "_gens"

    def __init__(self, fleet, plant_step, steps: int, substeps: int,
                 waypoint_radius):
        from ..controller.fleet import _fleet_pop

        self.fleet = self.owner = fleet
        self.ctrl = fleet._tpl
        self._setup(plant_step, steps, substeps)
        self.adaptive, self.W = False, None
        self.pop = self.r2 = None
        if waypoint_radius is not None:
            self.pop = _fleet_pop(fleet._cost)
            self.r2 = float(waypoint_radius) ** 2

    @torch.no_grad()
    def _period(self, b) -> None:
        actions, shifted, _ = self.fleet._step(b.state, b.useq, b.cp,
                                               solve=b.solve)
        x = self._plant(b.state, actions)
        if self.pop is not None:
            _copy(b.cp, self.pop(b.cp, x, self.r2))
        b.states.index_copy_(0, b.row, x[None].to(b.states.dtype))
        b.actions.index_copy_(0, b.row, actions[None].to(b.actions.dtype))
        b.row.add_(1)
        b.solve.add_(1)
        b.state.copy_(x)
        b.useq.copy_(shifted)

    def _new_buffers(self) -> _FleetBuffers:
        return _FleetBuffers(self.fleet, self.steps)

    def _cost_params(self, cparams):
        """The loop's own stacked cost params, loaded from the fleet's, or
        from ``cparams`` for a what-if run; at ``end`` a mission goes on
        from the run's final queues."""
        fleet, cp = self.fleet, self._bufs.cp
        src = fleet.cost_params
        if cparams is not None:
            src = {name: self._upload(cparams[name]).to(t.dtype)
                   .reshape(t.shape) for name, t in src.items()}

        def end():
            if self.pop is not None and cparams is None:
                _copy(fleet.cost_params, cp)

        return (lambda: _copy(cp, src)), end

    def __call__(self, states0, generators=None, useq0=None, mparams=None,
                 cparams=None, step0=None):
        return self._run(states0, generators, useq0, mparams, cparams, None,
                         step0, graph=self._graphed())

    def eager(self, states0, generators=None, useq0=None, mparams=None,
              cparams=None, step0=None):
        """``run`` with every period executed eagerly (no graph)."""
        return self._run(states0, generators, useq0, mparams, cparams, None,
                         step0, graph=False)


def on_device_closed_loop(ctrl, plant_step, x0, steps: int,
                          substeps: int = 10,
                          waypoint_radius: float | None = None):
    """One-shot convenience over ``build_on_device_loop``: the loop is
    cached on ``ctrl``, keyed as the JAX package keys it, on the plant's
    function and its bound instance (a bound method is a new object at
    every attribute access), the steps, substeps and radius; it starts
    from the controller's current nominal sequence (a configured
    ``init_seq`` warm start carries in) and draws the torch route's noise
    from the controller's generator."""
    cache = ctrl.__dict__.setdefault("_ondevice_loops", {})
    fn = getattr(plant_step, "__func__", plant_step)
    owner = getattr(plant_step, "__self__", None)
    key = (id(fn), id(owner), steps, substeps, waypoint_radius)
    if key not in cache:
        cache[key] = build_on_device_loop(ctrl, plant_step, steps, substeps,
                                          waypoint_radius=waypoint_radius)
    return cache[key](x0, useq0=ctrl.useq.clone())
