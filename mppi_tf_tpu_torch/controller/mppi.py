"""MPPI controller (reference: scripts/src/controllers/controller_base.py).

The per-step solve samples noise, rolls out K perturbed sequences, softmax-
weights them, updates the nominal sequence and shifts it. Two paths:

- ``"torch"``: plain PyTorch ops (``ops/``), on any device, every option;
- ``"cuda"``: the fused Hopper kernels of ``kernels/pm_mppi.py`` for the
  point-mass model with the static cost, plus the sequence update and shift
  as torch ops on the card.

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


class MPPI:
    """Information-theoretic MPPI controller.

    Args mirror the JAX package's ``MPPI`` (reference constructor
    controller_base.py:19-38), plus:
        device: where the solve runs. Default ``"cuda"``, which raises when
            no GPU is present; pass ``"cpu"`` for the plain CPU path.
        kernel: ``"torch"`` (plain path), ``"cuda"`` (fused kernels) or
            ``"auto"`` (the kernels where eligible, else plain). The JAX
            names ``"xla"`` and ``"pallas"`` mean ``"torch"`` and ``"cuda"``.
            The resolved path is ``kernel_path``.
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
        if observer is not None:
            raise NotImplementedError(
                "observers are not ported yet: ROADMAP item 7")
        if kernel_dtype != "float32":
            raise NotImplementedError(
                f"kernel_dtype={kernel_dtype!r} is not ported yet: ROADMAP "
                "queue-2 item 7")
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

        self._fused = None
        self.kernel_path = "torch"
        if kernel == "cuda" and device.type != "cuda":
            raise ValueError(
                f"kernel='cuda' needs a CUDA device, got device={device}")
        if kernel == "cuda" or (kernel == "auto" and device.type == "cuda"):
            self._resolve_kernel(kernel, sigma_np)

    def _resolve_kernel(self, kernel: str, sigma_np) -> None:
        from ..kernels.pm_mppi import FusedPointMassMPPI

        blockers = []
        if self._normalize_cost:
            blockers.append("normalize_cost (ROADMAP queue-2 item 2)")
        if self._log:
            blockers.append("log (ROADMAP queue-2 items 2 and 3)")
        if self._antithetic:
            blockers.append("antithetic (ROADMAP queue-2 item 4)")
        if self._sched is not None:
            blockers.append("noise_schedule (ROADMAP queue-2 item 4)")
        if blockers:
            if kernel == "cuda":
                raise NotImplementedError(
                    "kernel='cuda' does not support " + ", ".join(blockers)
                    + " yet; use kernel='torch'")
            return
        try:
            self._fused = FusedPointMassMPPI(
                self._model, self._cost, k=self._k, tau=self._tau,
                lam=self._lam, upsilon=self._upsilon, sigma=sigma_np)
        except KernelUnsupportedError:
            if kernel == "cuda":
                raise
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
        """Sequence update, clip, filter; emit U[0] and the shifted sequence."""
        new_useq = useq + wnoise.to(useq.dtype)
        if self._clip_actions:
            new_useq = torch.clamp(new_useq, self._model.min_act(),
                                   self._model.max_act())
        if self._S is not None:
            new_useq = self._S @ new_useq
        action = upd.get_next(new_useq, 1)[0]
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
    def _fused_step(self, state, useq):
        """Fused-kernel solve + sequence update. The noise of solve s is
        Philox counter block s under the controller's seed."""
        wnoise, info = self._fused.solve(state, useq, seed=self._base_seed,
                                         solve=self._steps)
        action, shifted, new_useq = self._postprocess(useq, wnoise)
        return action, shifted, {**info, "useq": new_useq,
                                 "weighted_noise": wnoise}

    # ------------------------------------------------------------------
    # stateful wrapper: the reference's user-facing API
    # ------------------------------------------------------------------
    def next(self, state) -> np.ndarray:
        """Compute the next action and advance the nominal sequence.

        Reference: controller_base.py:251-297. state: [sDim] -> action [aDim].
        """
        state = torch.as_tensor(np.asarray(state, np.float64).reshape(-1),
                                dtype=self._dtype, device=self._device)
        start = time.perf_counter()
        if self._fused is not None:
            action, self._useq, _info = self._fused_step(state, self._useq)
        else:
            action, self._useq, _info = self._solve(state, self._useq,
                                                    self._sched)
        action_np = action.cpu().numpy()
        self._timing["total"] += time.perf_counter() - start
        self._timing["calls"] += 1
        self._steps += 1
        return action_np

    def set_goal(self, goal) -> None:
        """Update the cost goal in place. Reference: controller_base.py:597-598."""
        self._cost.set_goal(goal)

    def trace(self) -> None:
        """Warm up the solve (kernel build included) with a fake state, then
        restore the controller's state. Reference: controller_base.py:562-585."""
        gen_state = self._gen.get_state()
        useq = self._useq.clone()
        self.next(np.zeros(self._sdim))
        self._gen.set_state(gen_state)
        self._useq = useq
        self._steps = 0
        self._timing = {"total": 0.0, "calls": 0}

    def profile(self, logdir: Optional[str] = None):
        """Run one solve under ``torch.profiler``; with ``logdir``, write a
        Chrome trace there. Returns the profiler.
        Reference: controller_base.py:587-595."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            self.next(np.zeros(self._sdim))
        if logdir is not None:
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        return prof

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

    @property
    def useq(self) -> torch.Tensor:
        return self._useq

    @property
    def timing(self) -> dict:
        return dict(self._timing)
