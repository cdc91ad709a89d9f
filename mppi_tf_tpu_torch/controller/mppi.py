"""MPPI controller (reference: scripts/src/controllers/controller_base.py).

The per-step solve samples noise, rolls out K perturbed sequences, softmax-
weights them, updates the nominal sequence and shifts it. Two paths:

- ``"torch"``: plain PyTorch ops (``ops/``), on any device, every option;
- ``"cuda"``: the fused Hopper kernels, ``kernels/pm_mppi.py`` for the
  point-mass model and the identified linear ``DMDModel`` (runtime (A, B),
  ``FusedLTIMPPI``) with the static, waypoint or (4-dim) ellipse cost,
  ``kernels/auv_mppi.py`` for the AUV with the static quaternion,
  quaternion waypoint or 3D ellipse cost, and ``kernels/nn_mppi.py`` for
  the learned ``NNAUVModel`` with the static quaternion cost (only when
  asked for by name); ``normalize_cost`` runs as the two-phase costs /
  weights solve, ``antithetic`` and ``noise_schedule`` as runtime
  variants of the same kernels, ``kernel_dtype="bfloat16"`` as their bf16
  block-compute build, and the sequence update and shift as torch ops on
  the card.

An observer (``observer/``) gets every solve's info through
``write_control`` and, from ``save(x, u, x_next)``, the one-step
prediction error.

Waypoint missions (``set_waypoints``, ``advance_waypoints``,
``waypoints_remaining``) come from ``controller/missions.py``.

Receding-horizon carry: the reference Python controller loses its update
(the shifted sequence is assigned to a local, controller_base.py:339-341);
the C++ version persists it (controller_base.cpp:144). This controller
stores the returned sequence: the C++ semantics.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..kernels.errors import KernelUnsupportedError
from ..ops import noise as noise_ops
from ..ops import update as upd
from ..ops.rollout import rollout_costs
from .missions import MissionMixin
from .state_io import cparams_entries, load_cparams

#: the JAX package's kernel names, mapped onto the port's two paths
_KERNEL_ALIASES = {"xla": "torch", "pallas": "cuda"}


def savgol_matrix(tau: int, window: int, polyorder: int) -> np.ndarray:
    """Savitzky-Golay smoothing as a linear operator S: filtered = S @ seq
    (scipy's filter applied to the identity; reference
    controller_base.py:281-291)."""
    from scipy.signal import savgol_filter

    return savgol_filter(np.eye(tau), window, polyorder, deriv=0, delta=1.0,
                         axis=0)


class MPPI(MissionMixin):
    """Information-theoretic MPPI controller.

    Args mirror the JAX package's ``MPPI`` (reference constructor
    controller_base.py:19-38), plus:
        device: where the solve runs. Default ``"cuda"``, which raises when
            no GPU is present; pass ``"cpu"`` for the plain CPU path.
        kernel: ``"torch"`` (plain path), ``"cuda"`` (fused kernels) or
            ``"auto"`` (the kernels where eligible, else plain; NN models
            stay on the plain path, as in the JAX package). The JAX
            names ``"xla"`` and ``"pallas"`` mean ``"torch"`` and ``"cuda"``.
            The resolved path is ``kernel_path``.
        kernel_dtype: ``"float32"`` or ``"bfloat16"``, the fused kernels'
            block compute type (the JAX package's): at bf16 the rollout
            state and its FMA chains round to bf16 after every op and the
            kernels read bf16-rounded normals; the cost accumulator, the
            softmax, the stats and Box-Muller stay f32. Kernel path only:
            a controller on the torch path raises ``ValueError``, as one
            with any other value does. The model stays float32.
    """

    def __init__(self, model, cost, k: int = 1, tau: int = 1,
                 lam: float = 1.0, upsilon: float = 1.0, sigma=None,
                 init_seq=None, normalize_cost: bool = False,
                 filter_seq: bool = False, filter_window: int = 9,
                 filter_polyorder: int = 3, clip_actions: bool = False,
                 seed: int = 0, observer=None, log: bool = False,
                 kernel: str = "torch", antithetic: bool = False,
                 noise_schedule=None, kernel_dtype: str = "float32",
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MPPI(device='cuda'): no GPU is present; pass device='cpu' "
                "for the plain CPU path")
        if kernel_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"kernel_dtype must be 'float32' or "
                             f"'bfloat16', got {kernel_dtype!r}")
        self._kernel_dtype = kernel_dtype
        kernel = _KERNEL_ALIASES.get(kernel, kernel)
        if kernel not in ("torch", "cuda", "auto"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if sigma is None:
            raise ValueError("sigma (noise scale matrix) is required")

        self._device = device
        self._model = model.to(device)
        self._cost = cost.to(device)
        self._k, self._tau = int(k), int(tau)
        self._lam, self._upsilon = float(lam), float(upsilon)
        self._sdim = model.get_state_dim()
        self._adim = model.get_action_dim()
        self._normalize_cost = bool(normalize_cost)
        self._clip_actions = bool(clip_actions)
        self._antithetic = bool(antithetic)
        self._observer = observer
        self._log = bool(log)
        dtype = model.dtype
        self._dtype = dtype

        sched_np = noise_ops.resolve_noise_schedule(noise_schedule, self._tau)
        self._sched = (None if sched_np is None else
                       torch.as_tensor(sched_np, dtype=dtype, device=device))
        sigma_np = np.asarray(sigma, np.float64)
        if sigma_np.shape != (self._adim, self._adim):
            raise AssertionError(
                f"sigma must be [{self._adim}, {self._adim}], got "
                f"{sigma_np.shape}")
        self._sigma = torch.as_tensor(sigma_np, dtype=dtype, device=device)
        self._S = (torch.as_tensor(
            savgol_matrix(tau, filter_window, filter_polyorder), dtype=dtype,
            device=device) if filter_seq else None)

        if init_seq is None:
            self._useq = torch.zeros((tau, self._adim), dtype=dtype,
                                     device=device)
        else:
            self._useq = torch.as_tensor(
                np.asarray(init_seq, np.float64), dtype=dtype,
                device=device).reshape(tau, self._adim).clone()
        self._base_seed = int(seed)
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(self._base_seed)
        self._steps = 0
        self._timing = {"total": 0.0, "calls": 0}
        # pinned host sources of model_params uploads still in flight
        self._staged = []

        self._fused = None
        self.kernel_path = "torch"
        if kernel == "cuda" and device.type != "cuda":
            raise ValueError(
                f"kernel='cuda' needs a CUDA device, got device={device}")
        if kernel == "cuda" or (kernel == "auto" and device.type == "cuda"):
            self._resolve_kernel(kernel, sigma_np, sched_np)
        if kernel_dtype != "float32" and self._fused is None:
            raise ValueError(
                f"kernel_dtype={kernel_dtype!r} applies to the fused kernel "
                "path only; this controller resolved to the torch path (as "
                "the JAX package's controller/mppi.py:244-249)")

    def _resolve_kernel(self, kernel: str, sigma_np, sched_np) -> None:
        """The fused solve object, tried in the JAX package's order
        (controller/mppi.py:222), with the antithetic, schedule and
        compute-dtype options passed on as it does (:226-236)."""
        from ..kernels.auv_mppi import FusedAUVMPPI
        from ..kernels.pm_mppi import FusedLTIMPPI, FusedPointMassMPPI

        classes = (FusedPointMassMPPI, FusedLTIMPPI, FusedAUVMPPI)
        if kernel == "cuda":
            # the NN kernel is explicit-only, as in the JAX package
            # (controller/mppi.py:217-224): "auto" keeps NN models on the
            # plain path, whose MLP runs as GEMMs over the K samples
            from ..kernels.nn_mppi import FusedNNMPPI

            classes += (FusedNNMPPI,)
        err = None
        for cls in classes:
            try:
                self._fused = cls(
                    self._model, self._cost, k=self._k, tau=self._tau,
                    lam=self._lam, upsilon=self._upsilon, sigma=sigma_np,
                    antithetic=self._antithetic, schedule=sched_np,
                    compute_dtype=self._kernel_dtype)
                break
            except KernelUnsupportedError as e:
                err = e
        if self._fused is None:
            if kernel == "cuda":
                raise KernelUnsupportedError(
                    f"no fused kernel supports {type(self._model).__name__} "
                    f"+ {type(self._cost).__name__}: {err}") from err
            return
        self.kernel_path = "cuda"

    # ------------------------------------------------------------------
    # pure core
    # ------------------------------------------------------------------
    def _rollout(self, state, useq, eps, sched=None):
        """Per-sample rollout costs. Reference: controller_base.py:371-434."""
        return rollout_costs(
            step_fn=self._model.step,
            state_cost_fn=self._cost.state_cost,
            action_cost_fn=self._cost.action_cost,
            terminal_cost_fn=self._cost.final_cost,
            x0=state, useq=useq, noises=eps, sched=sched)

    def _postprocess(self, useq, wnoise):
        """Sequence update, clip, filter; emit U[0] and the shifted sequence
        (of each vehicle, for a fleet's [n, tau, aDim])."""
        new_useq = useq + wnoise.to(useq.dtype)
        if self._clip_actions:
            new_useq = torch.clamp(new_useq, self._model.min_act(),
                                   self._model.max_act())
        if self._S is not None:
            # S @ new_useq as a product and a sum over the steps: each
            # vehicle of a fleet gets a one-vehicle filter's bits
            new_useq = (self._S[:, :, None] * new_useq[..., None, :, :]).sum(
                dim=-2)
        action = upd.get_next(new_useq, 1)[..., 0, :]
        init = upd.init_zeros(1, self._adim, dtype=new_useq.dtype,
                              device=new_useq.device)
        return action, upd.shift(new_useq, init, 1), new_useq

    def _update_and_shift(self, useq, costs, eps):
        """Softmax update, emit U[0], shift. Reference: controller_base.py:436-462."""
        wnoise = upd.mppi_update(costs, eps, self._lam,
                                 normalize=self._normalize_cost)
        action, shifted, new_useq = self._postprocess(useq, wnoise)
        info = {"cost_min": costs.min(), "cost_mean": costs.mean(),
                "cost_max": costs.max(), "weighted_noise": wnoise,
                "useq": new_useq}
        if self._log:
            b = upd.beta(costs)
            arg = upd.norm_arg(costs, b, normalize=self._normalize_cost)
            e = upd.exp(upd.exp_arg(arg, self._lam))
            n = upd.nabla(e)
            info.update(sample_costs=costs, weights=upd.weights(e, n),
                        nabla=n, arg=arg, noise=eps[:512])
        return action, shifted, info

    @torch.no_grad()
    def _solve_with_noise(self, eps, state, useq, sched=None):
        """Deterministic solve with injected noise: the parity-test surface.
        With a schedule, ``eps`` must already be schedule-scaled."""
        costs = self._rollout(state, useq, eps, sched)
        return self._update_and_shift(useq, costs, eps)

    @torch.no_grad()
    def _solve(self, state, useq, sched=None):
        """Full plain solve: sample noise, rollout, update, shift."""
        sampler = (noise_ops.sample_noise_antithetic if self._antithetic
                   else noise_ops.sample_noise)
        eps = sampler(self._gen, self._k, self._tau, self._adim, self._sigma,
                      self._upsilon, dtype=useq.dtype, schedule=sched)
        costs = self._rollout(state, useq, eps, sched)
        return self._update_and_shift(useq, costs, eps)

    @torch.no_grad()
    def _fused_step(self, state, useq, solve=None):
        """Fused-kernel solve + sequence update. The noise of solve s is
        Philox counter block s under the controller's seed; s is the
        controller's step count, or ``solve`` (an int, or a one-element
        int64 tensor on the device that the kernels read, as the on-device
        loop's counter, envs/mjx_env.py). Log mode adds
        the plain path's info keys (JAX controller/mppi.py:257-318): the
        normalized solve reuses its phase-A costs, the unnormalized one runs
        one extra costs phase, and ``noise`` is the first 512 samples of the
        solve's own noise."""
        fused, seed = self._fused, self._base_seed
        solve = self._steps if solve is None else solve
        wnoise, info = fused.solve(state, useq, seed=seed, solve=solve,
                                   normalize=self._normalize_cost)
        action, shifted, new_useq = self._postprocess(useq, wnoise)
        info = {**info, "useq": new_useq, "weighted_noise": wnoise}
        if self._log:
            costs = info.get("sample_costs")
            if costs is None:
                costs, _ = fused.costs_phase(state, useq, seed, solve)
            b = upd.beta(costs)
            arg = upd.norm_arg(costs, b, normalize=self._normalize_cost)
            e = upd.exp(upd.exp_arg(arg, self._lam))
            n = upd.nabla(e)
            info.update(sample_costs=costs, weights=upd.weights(e, n),
                        nabla=n, arg=arg,
                        noise=fused.noise_sample(seed, solve))
        return action, shifted, info

    # ------------------------------------------------------------------
    # stateful wrapper: the reference's user-facing API
    # ------------------------------------------------------------------
    def next(self, state) -> np.ndarray:
        """Compute the next action and advance the nominal sequence.

        Reference: controller_base.py:251-297. state: [sDim] -> action [aDim].
        """
        state = torch.as_tensor(np.asarray(state, np.float64).reshape(-1),
                                dtype=self._dtype)
        if self._device.type == "cuda":
            # a pageable upload syncs the host; a pinned one does not, so
            # the action's copy below stays the step's one sync
            state = state.pin_memory().to(self._device, non_blocking=True)
        else:
            state = state.to(self._device)
        start = time.perf_counter()
        if self._fused is not None:
            action, self._useq, _info = self._fused_step(state, self._useq)
        else:
            action, self._useq, _info = self._solve(state, self._useq,
                                                    self._sched)
        action_np = action.cpu().numpy()
        self._timing["total"] += time.perf_counter() - start
        self._timing["calls"] += 1
        if self._observer is not None:
            self._observer.write_control(state=state, action=action_np,
                                         info=_info)
        self._steps += 1
        return action_np

    @torch.no_grad()
    def save(self, x, u, x_next) -> None:
        """Log the one-step prediction error of the applied transition to
        the observer, and advance its step. Reference:
        controller_base.py:147-210 (JAX controller/mppi.py:448-462)."""
        if self._observer is None:
            return

        def t_(a):
            return torch.as_tensor(np.asarray(a, np.float64).reshape(-1),
                                   dtype=self._dtype, device=self._device)

        x, u, x_next = t_(x), t_(u), t_(x_next)
        pred = self._model.predict(x, u)
        self._observer.write_predict(x=x, u=u, x_next=x_next, pred=pred,
                                     cost=self._cost)
        self._observer.advance()

    def set_noise_schedule(self, spec) -> None:
        """Swap the per-step noise schedule: data only, on the plain path
        and in the kernels' dyn alike (JAX controller/mppi.py:521-535).
        Only a controller built with a ``noise_schedule`` has one."""
        if self._sched is None:
            raise ValueError(
                "controller was built without a noise_schedule; pass one "
                "at construction to enable scheduling")
        sched_np = noise_ops.resolve_noise_schedule(spec, self._tau)
        self._sched = torch.as_tensor(sched_np, dtype=self._dtype,
                                      device=self._device)
        if self._fused is not None:
            self._fused.set_schedule(sched_np)

    def set_goal(self, goal) -> None:
        """Update the cost goal in place. Reference: controller_base.py:597-598."""
        self._cost.set_goal(goal)

    def _fake_state(self) -> np.ndarray:
        """The warm-up state of ``trace`` and ``profile``: zeros, with a
        unit quaternion (qw = 1) for AUV-style states (JAX
        controller/mppi.py:470-472)."""
        fake = np.zeros(self._sdim)
        if self._sdim >= 7:
            fake[6] = 1.0
        return fake

    def trace(self) -> None:
        """Warm up the solve (kernel build included) with a fake state, then
        restore the controller's state. Reference: controller_base.py:562-585."""
        gen_state = self._gen.get_state()
        useq = self._useq.clone()
        self.next(self._fake_state())
        self._gen.set_state(gen_state)
        self._useq = useq
        self._steps = 0
        self._timing = {"total": 0.0, "calls": 0}

    def profile(self, logdir: Optional[str] = None):
        """Run one solve under ``torch.profiler``; with ``logdir`` (default:
        the observer's), write a Chrome trace there. Returns the profiler.
        Reference: controller_base.py:587-595."""
        if logdir is None and self._observer is not None:
            logdir = self._observer.get_logdir()
        with self._profiler() as prof:
            self.next(self._fake_state())
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        return prof

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def dump_hlo(self) -> str:
        """The text of the program a solve runs, the counterpart of the JAX
        package's compiled-HLO dump (controller/mppi.py:501-519) that the
        observer's ``save_graph`` takes. On the kernel path: the kernels
        one solve launches, with their instantiations' ptxas registers,
        shared memory and spills. On the plain path: the profiler's op
        table of one solve. Neither changes the controller's state."""
        from ..kernels import _launch

        state = torch.as_tensor(self._fake_state(), dtype=self._dtype,
                                device=self._device)
        useq = self._useq.clone()
        if self._fused is None:
            gen_state = self._gen.get_state()
            with self._profiler() as prof:
                self._solve(state, useq, self._sched)
            self._gen.set_state(gen_state)
            return prof.key_averages().table(sort_by="self_cpu_time_total",
                                             row_limit=40)
        from ..kernels import _build

        before = dict(_launch.launch_counts)
        log = self._log
        self._log = False
        try:
            self._fused_step(state, useq)
        finally:
            self._log = log
        launched = {n: c - before[n] for n, c in _launch.launch_counts.items()
                    if c > before[n]}
        for name, count in launched.items():
            _launch.launch_counts[name] -= count
        c = self._fused.consts
        lines = [f"{type(self._fused).__name__}: k={self._k}, "
                 f"tau={self._tau}, cost {getattr(c, 'cost_kind', '')}, "
                 f"scheduled={c.scheduled}, antithetic={c.antithetic}, "
                 f"normalize={self._normalize_cost}"]
        rows = _build.ptxas_report() if launched else []
        for name, count in launched.items():
            syms = _launch.kernel_symbols(name,
                                          self._fused.template_args(name))
            lines.append(f"{name} x{count}: {', '.join(syms)}")
            lines += [f"  {r}" for r in rows
                      if any(s in r["kernel"] for s in syms)]
        return "\n".join(lines)

    def save_state(self, path: str) -> None:
        """Checkpoint the mutable state (nominal sequence, generator state,
        step/timing counters, cost params) to ``path`` (.npz)."""
        np.savez(
            path,
            useq=self._useq.cpu().numpy(),
            gen_state=self._gen.get_state().numpy(),
            steps=self._steps,
            timing_total=self._timing["total"],
            timing_calls=self._timing["calls"],
            **cparams_entries(self._cost.params()),
        )

    def load_state(self, path: str) -> None:
        """Restore state written by :meth:`save_state`."""
        d = np.load(path)
        if d["useq"].shape != tuple(self._useq.shape):
            raise ValueError(
                f"checkpoint useq {d['useq'].shape} != controller "
                f"{tuple(self._useq.shape)}")
        self._useq = torch.as_tensor(d["useq"], dtype=self._dtype,
                                     device=self._device)
        self._gen.set_state(torch.from_numpy(d["gen_state"]))
        self._steps = int(d["steps"])
        self._timing = {"total": float(d["timing_total"]),
                        "calls": int(d["timing_calls"])}
        load_cparams(d, self._cost.params())
        self._cost.sync_host()

    @property
    def useq(self) -> torch.Tensor:
        return self._useq

    @property
    def model_params(self) -> dict:
        """The model's carried tensors in the layout of the JAX package's
        params (``interop.to_jax_params``: ``{"mass"}``, ``{"A", "B"}``,
        an NN's nested dict), as detached copies on the controller's
        device."""
        from ..interop import _model_tensors, _unflatten

        return _unflatten({n: t.detach().clone()
                           for n, t in _model_tensors(self._model).items()})

    @model_params.setter
    def model_params(self, params) -> None:
        """Copy ``params`` (arrays or tensors, the getter's layout) in place
        into the model's tensors, so that a fused solve object holding the
        model reads them in its next solve. Host values go to the card from
        pinned memory without blocking: no host sync. Each pinned source
        stays referenced here until the next call, past its copy."""
        from ..interop import _flatten, _model_tensors

        flat, targets = _flatten(params), _model_tensors(self._model)
        if set(flat) != set(targets):
            raise KeyError(f"model params {sorted(flat)} != the model's "
                           f"parameters {sorted(targets)}")
        staged = []
        with torch.no_grad():
            for name, t in targets.items():
                v = flat[name]
                src = (v.detach() if isinstance(v, torch.Tensor) else
                       torch.as_tensor(np.array(v)))
                src = src.to(t.dtype).reshape(t.shape)
                if t.device.type == "cuda" and src.device.type == "cpu":
                    src = src.pin_memory()
                    staged.append(src)
                t.copy_(src, non_blocking=True)
        self._staged = staged

    @property
    def timing(self) -> dict:
        return dict(self._timing)
