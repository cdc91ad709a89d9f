"""On-device plant and the on-device closed loop.

Counterpart of ``mppi_tf_tpu/envs/mjx_env.py``. The reference's plant is a
host-side simulator (scripts/src/mujoco/simulation.py:26-55), so every
control step round-trips between the host and the device. Here the plant
is a pure function on tensors, ``step_fn(x, u) -> x_next``, and the whole
control period (the solve, the zero-order-hold action, ``substeps`` plant
steps, the waypoint pop and the DMD window write and refit) runs on the
device:

- on the card, on the kernel route (``kernel="cuda"``), one control period
  is captured as a ``torch.cuda.CUDAGraph`` and replayed ``steps`` times;
  the host synchronises once, at the end of ``run``. The kernels read the
  Philox solve index from a device counter that the period advances
  (``_launch.solve_words``), so every replay draws the next solve's noise;
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

import ctypes
import inspect

import numpy as np
import torch

from .. import tracing
from ..kernels import _launch, plant

#: the CUDA graph node types (CUgraphNodeType, cudaGraphNodeType) that
#: ``graph_node_kinds`` names; every other type counts as "other"
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


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
    a captured graph's addresses stay valid across runs."""

    def __init__(self, ctrl, steps: int, W):
        like = {"dtype": ctrl._dtype, "device": ctrl._device}
        sdim, adim = ctrl._sdim, ctrl._adim
        self.state = torch.zeros(sdim, **like)
        self.useq = torch.zeros(tuple(ctrl.useq.shape), **like)
        self.states = torch.zeros(steps, sdim, **like)
        self.actions = torch.zeros(steps, adim, **like)
        idx = {"dtype": torch.int64, "device": ctrl._device}
        self.solve = torch.zeros(1, **idx)   # the period's solve index
        self.row = torch.zeros(1, **idx)     # the period's output row
        if W is not None:
            ma = ctrl._model.get_action_dim()
            self.obs = torch.zeros(W, sdim, **like)
            self.act = torch.zeros(W, ma, **like)
            self.nxt = torch.zeros(W, sdim, **like)
            self.cnt = torch.zeros(1, **idx)


def graph_node_kinds(graph) -> dict:
    """The nodes of a captured ``CUDAGraph(keep_graph=True)``, by kind:
    {kernel, memcpy, memset, other: count}, read from the graph itself
    through ``libcuda`` (``cuGraphGetNodes``, ``cuGraphNodeGetType``: what
    the runtime's ``cudaGraphGetNodes`` and ``cudaGraphNodeGetType`` call
    on the same handle)."""
    drv = ctypes.CDLL("libcuda.so.1")

    def check(rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"reading a CUDA graph's nodes: CUresult {rc}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(drv.cuGraphGetNodes(raw, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(drv.cuGraphGetNodes(raw, nodes, ctypes.byref(n)))
    out = dict.fromkeys(("kernel", "memcpy", "memset", "other"), 0)
    kind = ctypes.c_int(0)
    for node in nodes:
        check(drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)))
        out[_NODE_KINDS.get(kind.value, "other")] += 1
    return out


def freeze_key(ctrl, cost_tensors) -> tuple:
    """What a CUDA graph of ``ctrl``'s fused solve froze: the solve object
    and its constants (by-value kernel arguments), the schedule tensor,
    the seed and flags, the addresses of the model's parameters and
    buffers and of ``cost_tensors`` (the cost params the graph reads), and
    the key of a model's cached derived values (``AUVModel.mats_key``).
    Ints and addresses only, cheap enough to test before every replay: a
    graph is captured again when it changes, while parameters written in
    place are read live."""
    model, fused = ctrl._model, ctrl._fused
    mats_key = getattr(model, "mats_key", None)
    return (id(fused), id(fused.consts),
            None if fused.sched is None else fused.sched.data_ptr(),
            ctrl._base_seed, ctrl._normalize_cost, ctrl._log,
            ctrl._clip_actions, id(ctrl._S), _addresses(model),
            tuple(t.data_ptr() for t in cost_tensors),
            None if mats_key is None else mats_key())


def _addresses(module) -> tuple:
    """The addresses of every parameter and buffer of ``module`` and its
    submodules, read from the modules' own dicts (a fraction of the cost
    of ``named_parameters``)."""
    out, stack = [], [module]
    while stack:
        mod = stack.pop()
        for tensors in (mod._parameters, mod._buffers):
            out += [t.data_ptr() for t in tensors.values() if t is not None]
        stack += [m for m in mod._modules.values() if m is not None]
    return tuple(out)


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

    def __init__(self, ctrl, plant_step, steps: int, substeps: int,
                 refit_window, waypoint_radius):
        from ..controller.dmd import DMDAdaptiveMixin
        from ..costs.waypoints import WayPointsCost

        self.ctrl = ctrl
        self._set_plant(plant_step, steps, substeps)
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
        self._bufs = None
        self._graphs = None      # (period graph, refit graph or None)
        self._frozen = None      # what the graphs froze (_freeze_key)
        self.nodes, self.capture_s, self.captures = {}, None, 0
        self.plant_nodes, self.graph_nodes = {}, {}

    def _set_plant(self, plant_step, steps: int, substeps: int) -> None:
        """The plant, the period's shape and how a period calls the plant
        (``plant_calls``), read once from the plant's signature."""
        self.plant_step = plant_step
        self.steps, self.substeps = int(steps), int(substeps)
        self._fused_plant = (self.substeps > 1 and "substeps" in
                             inspect.signature(plant_step).parameters)
        self.plant_calls = 1 if self._fused_plant else self.substeps

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
        """Warm up one period (and the refit) on a side stream, then
        capture each as a graph; the warm-up's writes are undone by the
        caller's load."""
        with tracing.timed("mppi.loop.capture") as span:
            side = torch.cuda.Stream(device=self.ctrl._device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._period(b)
                if with_fit:
                    self._fit(b)
            torch.cuda.current_stream().wait_stream(side)
            before = dict(_launch.captured_counts)
            before_plant = dict(plant.captured_counts)
            # kept after its capture, so that its nodes can be read, and
            # instantiated here, not at its first replay
            period = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(period):
                self._period(b)
            fit = None
            if with_fit:
                fit = torch.cuda.CUDAGraph()
                with torch.cuda.graph(fit, pool=period.pool()):
                    self._fit(b)
            self.nodes = {n: c - before[n]
                          for n, c in _launch.captured_counts.items()
                          if c > before[n]}
            self.plant_nodes = {n: c - before_plant[n]
                                for n, c in plant.captured_counts.items()
                                if c > before_plant[n]}
            self.graph_nodes = graph_node_kinds(period)
            period.instantiate()
            self._graphs = (period, fit)
            torch.cuda.current_stream().synchronize()
        self.capture_s = span.seconds
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

    @torch.no_grad()
    def _run(self, x0, generator, useq0, mparams, cparams, window, step0,
             graph: bool):
        from ..interop import _model_tensors

        ctrl = self.ctrl
        steps = self.steps
        if step0 is None:
            step0 = ctrl._steps
            ctrl._steps = step0 + steps
        with tracing.span("mppi.loop.run", step0):
            with tracing.span("mppi.loop.load"):
                self._staged = []
                x0 = self._upload(x0).reshape(-1)
                useq0 = (torch.zeros_like(ctrl.useq) if useq0 is None
                         else self._upload(useq0).reshape(ctrl.useq.shape))
                model_t = _model_tensors(ctrl._model)
                cost_t = ctrl._cost.params()
                keep_m = mparams is not None or self.adaptive
                orig_m = ({n: t.detach().clone() for n, t in model_t.items()}
                          if keep_m else None)
                orig_c = ({n: t.detach().clone() for n, t in cost_t.items()}
                          if cparams is not None else None)
                if mparams is not None:
                    ctrl.model_params = mparams
                if cparams is not None:
                    for name, v in cparams.items():
                        cost_t[name].copy_(
                            self._upload(v).to(cost_t[name].dtype)
                            .reshape(cost_t[name].shape))
                # what each run starts from, after the overrides: the
                # warm-up of a capture writes the model (a refit) and the
                # queue (a pop)
                init_m = ({n: t.detach().clone() for n, t in model_t.items()}
                          if self.adaptive else None)
                init_c = ({n: t.detach().clone() for n, t in cost_t.items()}
                          if self.pop is not None else None)
                win = None
                if self.adaptive:
                    win = (_dmd_window(ctrl, self.W) if window is None
                           else window)
                n0 = int(win[3]) if win is not None else 0
                if self._bufs is None:
                    self._bufs = _Buffers(ctrl, steps, self.W)
                b = self._bufs

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
                        for n, t in model_t.items():
                            t.copy_(init_m[n])
                    if init_c is not None:
                        for n, t in cost_t.items():
                            t.copy_(init_c[n])

            refits = self._refits(step0, n0)
            ridge = self.adaptive and ctrl._model.rank is None
            gen_saved = ctrl._gen
            if generator is not None:
                ctrl._gen = generator
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
                        _launch.count_replays(self.nodes, steps)
                        _launch.count_replays(self.plant_nodes, steps,
                                              plant.launch_counts)
                else:
                    load()
                    for j in range(steps):
                        self._period(b)
                        if j in refits:
                            self._fit(b)
            finally:
                ctrl._gen = gen_saved
                if ctrl._fused is not None:
                    ctrl._fused.forget_cached_terms()
            with tracing.span("mppi.loop.sync"):
                states, actions = b.states.clone(), b.actions.clone()
                fitted = None
                if self.adaptive:
                    fitted = {"A": ctrl._model.A.detach().clone(),
                              "B": ctrl._model.B.detach().clone()}
                if orig_m is not None:
                    for n, t in model_t.items():
                        t.copy_(orig_m[n])
                if orig_c is not None:
                    for n, t in cost_t.items():
                        t.copy_(orig_c[n])
                queue = None
                if self.pop is not None and cparams is None:
                    cost = ctrl._cost
                    queue = (cost.waypoints.to("cpu", non_blocking=True),
                             cost.count.to("cpu", non_blocking=True))
                if ctrl._device.type == "cuda":
                    # the run's one host sync
                    torch.cuda.current_stream(ctrl._device).synchronize()
                self._staged = []
                if queue is not None:
                    ctrl._cost.sync_host(*queue)
        if self.adaptive:
            return states, actions, fitted
        return states, actions


class _FleetBuffers:
    """A fleet loop's tensors (``_Buffers``, a row a vehicle), with the
    loop's own copy of the stacked cost params, which the period reads and
    its pops write."""

    def __init__(self, fleet, steps: int):
        like = {"dtype": fleet._dtype, "device": fleet._device}
        n, sdim, adim = fleet._n, fleet._sdim, fleet._adim
        self.state = torch.zeros(n, sdim, **like)
        self.useq = torch.zeros(tuple(fleet.useq.shape), **like)
        self.states = torch.zeros(steps, n, sdim, **like)
        self.actions = torch.zeros(steps, n, adim, **like)
        idx = {"dtype": torch.int64, "device": fleet._device}
        self.solve = torch.zeros(1, **idx)   # the period's fleet step
        self.row = torch.zeros(1, **idx)
        self.cp = {name: torch.zeros_like(t)
                   for name, t in fleet.cost_params.items()}


class FleetLoop(OnDeviceLoop):
    """The ``run`` of ``FleetMPPI.build_on_device_loop``: ``OnDeviceLoop``'s
    capture and replay over a fleet's period (the fleet solve, the
    batched plant, every vehicle's pop). ``nodes``, ``plant_nodes``,
    ``graph_nodes``, ``capture_s``, ``captures`` and ``plant_calls`` as
    there."""

    def __init__(self, fleet, plant_step, steps: int, substeps: int,
                 waypoint_radius):
        from ..controller.fleet import _fleet_pop

        self.fleet, self.ctrl = fleet, fleet._tpl
        self._set_plant(plant_step, steps, substeps)
        self.adaptive, self.W = False, None
        self.pop = self.r2 = None
        if waypoint_radius is not None:
            self.pop = _fleet_pop(fleet._cost)
            self.r2 = float(waypoint_radius) ** 2
        self._bufs = None
        self._graphs = None
        self._frozen = None
        self._gens = None
        self.nodes, self.capture_s, self.captures = {}, None, 0
        self.plant_nodes, self.graph_nodes = {}, {}

    @torch.no_grad()
    def _period(self, b) -> None:
        actions, shifted, _ = self.fleet._step(b.state, b.useq, b.cp,
                                               solve=b.solve, gens=self._gens)
        x = self._plant(b.state, actions)
        if self.pop is not None:
            cp = self.pop(b.cp, x, self.r2)
            for name, t in cp.items():
                b.cp[name].copy_(t)
        b.states.index_copy_(0, b.row, x[None].to(b.states.dtype))
        b.actions.index_copy_(0, b.row, actions[None].to(b.actions.dtype))
        b.row.add_(1)
        b.solve.add_(1)
        b.state.copy_(x)
        b.useq.copy_(shifted)

    def __call__(self, states0, generators=None, useq0=None, mparams=None,
                 cparams=None, step0=None):
        return self._run_fleet(states0, generators, useq0, mparams, cparams,
                               step0, graph=self._graphed())

    def eager(self, states0, generators=None, useq0=None, mparams=None,
              cparams=None, step0=None):
        """``run`` with every period executed eagerly (no graph)."""
        return self._run_fleet(states0, generators, useq0, mparams, cparams,
                               step0, graph=False)

    @torch.no_grad()
    def _run_fleet(self, states0, generators, useq0, mparams, cparams,
                   step0, graph: bool):
        from ..interop import _model_tensors

        fleet, ctrl, steps = self.fleet, self.ctrl, self.steps
        if step0 is None:
            step0 = fleet._steps
            fleet._steps = step0 + steps
        with tracing.span("mppi.loop.run", step0):
            with tracing.span("mppi.loop.load"):
                self._staged = []
                x0 = self._upload(states0).reshape(fleet._n, fleet._sdim)
                useq0 = (torch.zeros_like(fleet.useq) if useq0 is None
                         else self._upload(useq0).reshape(fleet.useq.shape))
                model_t = _model_tensors(ctrl._model)
                orig_m = None
                if mparams is not None:
                    orig_m = {n: t.detach().clone()
                              for n, t in model_t.items()}
                    ctrl.model_params = mparams
                src = fleet.cost_params
                if cparams is not None:
                    src = {name: self._upload(cparams[name]).to(t.dtype)
                           .reshape(t.shape) for name, t in src.items()}
                if self._bufs is None:
                    self._bufs = _FleetBuffers(fleet, steps)
                b = self._bufs

            def load():
                with tracing.span("mppi.loop.load"):
                    b.state.copy_(x0)
                    b.useq.copy_(useq0)
                    b.solve.fill_(step0)
                    b.row.zero_()
                    for name, t in b.cp.items():
                        t.copy_(src[name])

            self._gens = generators
            try:
                if graph:
                    key = self._freeze_key()
                    if key != self._frozen:
                        load()
                        self._capture(b, with_fit=False)
                        self._frozen = key
                    load()
                    period, _ = self._graphs
                    with tracing.span("mppi.loop.replay"):
                        for _ in range(steps):
                            period.replay()
                        _launch.count_replays(self.nodes, steps)
                        _launch.count_replays(self.plant_nodes, steps,
                                              plant.launch_counts)
                else:
                    load()
                    for _ in range(steps):
                        self._period(b)
            finally:
                self._gens = None
            with tracing.span("mppi.loop.sync"):
                states, actions = b.states.clone(), b.actions.clone()
                if orig_m is not None:
                    for n, t in model_t.items():
                        t.copy_(orig_m[n])
                if self.pop is not None and cparams is None:
                    # the mission goes on from the run's final queues
                    for name, t in fleet.cost_params.items():
                        t.copy_(b.cp[name])
                if ctrl._device.type == "cuda":
                    torch.cuda.current_stream(ctrl._device).synchronize()
                self._staged = []
        return states, actions


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
