"""Mesh-sharded MPPI solve: the K samples distributed over shards.

Counterpart of ``mppi_tf_tpu/parallel/sharded.py``. Each shard draws its
own noise, rolls out its K/n samples locally and joins the four
collectives of the update law (``ops/update.py`` with ``mesh=``): pmin
beta, pmax normalizer, psum nabla, psum weighted noise. The updated
sequence and the action come out replicated, so the controller's host
logic is the single-device ``MPPI``'s, which the sharded controllers
extend.

Noise: shard g draws from its own ``torch.Generator``, seeded from
(seed, g) (``shard_seed``), the port's counterpart of JAX's
``fold_in(key, g)``; antithetic pairs mirror within each shard, as in
JAX. The streams differ from JAX's, so parity runs on injected noise
(``_solve_with_noise``, eps [K, tau, aDim] split on K).

A mesh of one shard is the single-device solve bit for bit; shards of one
process run one after another on their device (``Mesh.one_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..controller.mppi import MPPI
from ..ops import noise as noise_ops
from ..ops import update as upd
from .mesh import SAMPLE_AXIS


def shard_seed(seed: int, g: int) -> int:
    """The generator seed of global shard ``g``: distinct streams from one
    controller seed."""
    return int(np.random.SeedSequence([int(seed), int(g)])
               .generate_state(1, np.uint64)[0])


def shard_split(mesh, axis: str, k: int) -> tuple:
    """(n, k // n) for ``k`` samples over the mesh axis ``axis``, which
    must hold every shard; ``ValueError`` when n does not divide k."""
    n = mesh.shape.get(axis)
    if n != mesh.size:
        raise ValueError(f"the samples axis {axis!r} holds {n or 0} of the "
                         f"mesh's {mesh.size} shards ({mesh.shape}); shard "
                         "K over a 1-D mesh")
    if k % n != 0:
        raise ValueError(f"k={k} not divisible by mesh axis {axis}={n}")
    return n, k // n


def build_sharded_solve(model, cost, k: int, tau: int, lam: float,
                        upsilon: float, sigma, mesh, normalize_cost=False,
                        clip_actions=False, axis: str = SAMPLE_AXIS,
                        antithetic=False, filter_mat=None, schedule=None,
                        seed: int = 0):
    """``(solve, solve_with_noise)`` over ``mesh`` (the JAX function's
    surface): solve(state, useq) -> (action, next_useq, info) on the
    shards' generators, solve_with_noise(eps [K, tau, aDim], state, useq)
    on injected noise. ``filter_mat`` ([tau, tau]) is the Savitzky-Golay
    operator (``controller.mppi.savgol_matrix``); raises ``ValueError``
    for an indivisible K."""
    ctrl = ShardedMPPI(model, cost, mesh, k=k, tau=tau, lam=lam,
                       upsilon=upsilon, sigma=sigma,
                       normalize_cost=normalize_cost,
                       clip_actions=clip_actions, axis=axis,
                       antithetic=antithetic, seed=seed,
                       noise_schedule=schedule)
    if filter_mat is not None:
        ctrl._S = torch.as_tensor(np.asarray(filter_mat, np.float64),
                                  dtype=ctrl._dtype, device=ctrl._device)

    def solve(state, useq):
        return ctrl._solve(state, useq, ctrl._sched)

    return solve, ctrl._solve_with_noise


class ShardedControllerMixin:
    """What the sharded controllers add to ``MPPI``: the mesh, the
    samples axis and the shard count. ``trace``, ``profile`` and
    ``dump_hlo`` are ``MPPI``'s (the port's counterpart of the JAX
    mixin's), and so are the missions, ``save`` and ``model_params``."""

    def _init_mesh(self, mesh, axis: str, k: int) -> torch.device:
        """Check the mesh and K; returns the shards' device."""
        device = mesh.one_device(type(self).__name__)
        self._n, self._k_local = shard_split(mesh, axis, k)
        self._mesh, self._axis = mesh, axis
        return device


class ShardedMPPI(ShardedControllerMixin, MPPI):
    """``MPPI`` with K sharded over ``mesh`` on the torch route: the same
    surface (next / save / set_goal / missions / trace / profile /
    dump_hlo / save_state / load_state / useq / timing / model_params),
    so a pod-scale K is a one-line change. ``seed`` seeds every shard's
    generator (``shard_seed``)."""

    def __init__(self, model, cost, mesh, k: int = 1, tau: int = 1,
                 lam: float = 1.0, upsilon: float = 1.0, sigma=None,
                 normalize_cost: bool = False, clip_actions: bool = False,
                 seed: int = 0, axis: str = SAMPLE_AXIS,
                 antithetic: bool = False, filter_seq: bool = False,
                 filter_window: int = 9, filter_polyorder: int = 3,
                 observer=None, init_seq=None, noise_schedule=None):
        device = self._init_mesh(mesh, axis, int(k))
        super().__init__(model, cost, k=k, tau=tau, lam=lam, upsilon=upsilon,
                         sigma=sigma, init_seq=init_seq,
                         normalize_cost=normalize_cost, filter_seq=filter_seq,
                         filter_window=filter_window,
                         filter_polyorder=filter_polyorder,
                         clip_actions=clip_actions, seed=seed,
                         observer=observer, kernel="torch",
                         antithetic=antithetic,
                         noise_schedule=noise_schedule, device=device)
        self._gen = []
        for g in mesh.local_indices:
            gen = torch.Generator(device=device)
            gen.manual_seed(shard_seed(seed, g))
            self._gen.append(gen)

    # --- the sharded solve ------------------------------------------------
    def _update_shards(self, state, useq, eps: list, sched):
        """Roll out each shard's noise, then the update law's collectives;
        cost min / mean / max come from one gather."""
        mesh = self._mesh
        costs = [self._rollout(state, useq, e, sched) for e in eps]
        wnoise = upd.mppi_update(costs, eps, self._lam,
                                 normalize=self._normalize_cost, mesh=mesh)
        action, shifted, new_useq = self._postprocess(useq, wnoise)
        st = mesh.all_gather([torch.stack([c.min(), c.mean(), c.max()])
                              for c in costs])
        info = {"cost_min": st[:, 0].min(), "cost_mean": st[:, 1].sum()
                / mesh.size, "cost_max": st[:, 2].max(),
                "weighted_noise": wnoise, "useq": new_useq}
        return action, shifted, info

    @torch.no_grad()
    def _solve(self, state, useq, sched=None):
        """Each shard samples its K/n sequences from its own generator
        (mirrored pairs within the shard when antithetic), then
        ``_update_shards``."""
        sampler = (noise_ops.sample_noise_antithetic if self._antithetic
                   else noise_ops.sample_noise)
        eps = [sampler(g, self._k_local, self._tau, self._adim, self._sigma,
                       self._upsilon, dtype=useq.dtype, schedule=sched)
               for g in self._gen]
        return self._update_shards(state, useq, eps, sched)

    @torch.no_grad()
    def _solve_with_noise(self, eps, state, useq, sched=None):
        """The solve on injected noise eps [K, tau, aDim] (the same global
        array on every rank), split on K: shard g takes rows
        [g K/n, (g+1) K/n). The controller's schedule applies (``eps``
        already scaled by it), as on the JAX sharded path."""
        kl = self._k_local
        eps = torch.as_tensor(eps, dtype=self._dtype, device=self._device)
        parts = [eps[g * kl:(g + 1) * kl] for g in self._mesh.local_indices]
        sched = self._sched if sched is None else sched
        return self._update_shards(state, useq, parts, sched)

    # --- generator state ----------------------------------------------------
    def _rng_state(self):
        return [g.get_state() for g in self._gen]

    def _set_rng_state(self, state) -> None:
        for g, s in zip(self._gen, state):
            g.set_state(s)

    def _rng_entries(self) -> dict:
        """Every local shard's generator state, by global shard index."""
        return {"gen_states": np.stack([g.get_state().numpy()
                                        for g in self._gen]),
                "shards": np.asarray(self._mesh.local_indices)}

    def _load_rng(self, d) -> None:
        if list(d["shards"]) != self._mesh.local_indices:
            raise ValueError(f"checkpoint of shards {list(d['shards'])}, "
                             f"this process drives "
                             f"{self._mesh.local_indices}")
        for g, s in zip(self._gen, d["gen_states"]):
            g.set_state(torch.from_numpy(s))
