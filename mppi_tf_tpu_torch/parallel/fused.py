"""Mesh-sharded fused-kernel MPPI: the Hopper kernels on each shard, then
the shard merge.

Counterpart of ``mppi_tf_tpu/parallel/fused.py``. Every shard runs a fused
solve object (``kernels/``) at K/n samples: the unnormalized solve's
merged rows before the division by l (``TwoPhaseSolve.solve_raw``, JAX's
``return_raw=True``), which the shards combine with the algebra
``pm_merge`` applies across its blocks (JAX ``_shard_reduce``):

    m = max m_i,  f_i = exp(m_i - m),  l = sum f_i l_i,
    zsum = sum f_i zsum_i,  cost min / max / sum over the shards,
    wnoise = scale @ zsum / l.

The normalized solve runs phase A (``costs_phase``) on every shard, takes
the global beta = min and cost max, runs phase B (``weights_phase``) on
every shard with them and sums l and zsum (JAX ``_merge_normalized``).
Each combination is one ``Mesh.all_gather`` of the shards' rows, reduced
in shard order: the same bits on every rank and at any layout of ranks
and local shards.

Noise: at step s shard g draws the Philox stream of solve s n + g under
the controller's seed, the port's counterpart of JAX's disjoint blocks
seed + g n_tiles_local (as the fleet's s n + v). A mesh of one shard is
then the single-device ``MPPI`` fused step bit for bit (exp(m - m) = 1).
A solve index on the device (the on-device loop's counter, a one-element
int64 tensor) becomes every shard's s n + g in one device op, with no
host sync, so a captured graph replays it.

The kernels do not change: each shard launches them once, and the
collectives stay outside every kernel (``torch.distributed``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..controller.mppi import MPPI
from ..kernels.pm_mppi import STATS
from .mesh import SAMPLE_AXIS
from .sharded import ShardedControllerMixin


class ShardedFusedSolve:
    """One fused solve object per local shard, merged over the mesh; the
    surface ``MPPI._fused_step``, ``dump_hlo`` and the on-device loop use
    of a fused solve object: ``solve``, ``forget_cached_terms``,
    ``set_schedule``, ``template_args`` and the lead shard's ``consts``,
    ``sched``, ``antithetic`` and ``compute_dtype``. ``k`` is the global
    sample count."""

    def __init__(self, shards: list, mesh, k: int):
        self.shards, self.mesh = list(shards), mesh
        lead = self.shards[0]
        self.k, self.k_local = int(k), lead.k
        self.tau, self.adim, self.lam = lead.tau, lead.adim, lead.lam
        self._index = torch.tensor(mesh.local_indices, dtype=torch.int64,
                                   device=mesh.device)

    def __getattr__(self, name):
        if name in ("consts", "sched", "antithetic", "compute_dtype"):
            return getattr(self.shards[0], name)
        raise AttributeError(name)

    def forget_cached_terms(self) -> None:
        for f in self.shards:
            f.forget_cached_terms()

    def set_schedule(self, schedule) -> None:
        for f in self.shards:
            f.set_schedule(schedule)

    def template_args(self, entry: str) -> tuple:
        return self.shards[0].template_args(entry)

    def _solves(self, solve):
        """Every local shard's solve index s n + g: ints, or one-element
        views of a device tensor written by one op (kept alive by the
        caller until the launches that read it)."""
        n = self.mesh.size
        if isinstance(solve, torch.Tensor):
            idx = torch.add(self._index, solve.to(self._index.device),
                            alpha=n)
            return [idx[i:i + 1] for i in range(len(self.shards))]
        return [int(solve) * n + g for g in self.mesh.local_indices]

    def _split(self, z):
        """Each local shard's lanes of injected z [tau, adim, K]."""
        if z is None:
            return [None] * len(self.shards)
        kl = self.k_local
        if z.shape[-1] != self.k:
            raise ValueError(f"z has {z.shape[-1]} samples, the solve {self.k}")
        return [z[..., g * kl:(g + 1) * kl].contiguous()
                for g in self.mesh.local_indices]

    def _dyn(self, x0, useq):
        """The solve's packed ``dyn``, the same for every shard (one
        device, one model and cost): packed once."""
        return self.shards[0].pack_dyn(x0, useq)

    def rows(self, x0, useq, seed: int = 0, solve=0, z=None):
        """Every shard's unnormalized solve before the division by l
        (``solve_raw``: its stats row, then zsum), gathered by shard:
        [size, STATS + tau*adim], the layout of ``pm_merge``'s rows."""
        dyn = self._dyn(x0, useq)
        rows = []
        for f, s, zi in zip(self.shards, self._solves(solve),
                            self._split(z)):
            zsum, stats = f.solve_raw(x0, useq, seed, s, zi, dyn=dyn)
            rows.append(torch.cat([stats, zsum]))
        return self.mesh.all_gather(rows)

    @staticmethod
    def merge(g: torch.Tensor):
        """The shard merge of gathered ``rows``: (zsum [tau*adim], stats
        (m, l, cost min, max, sum)), in shard order."""
        m = g[:, 0]
        m_g = m.max()
        f = torch.exp(m - m_g)
        l = (g[:, 1] * f).sum()
        zsum = (g[:, STATS:] * f[:, None]).sum(dim=0)
        return zsum, torch.stack([m_g, l, g[:, 2].min(), g[:, 3].max(),
                                  g[:, 4].sum()])

    def solve(self, x0, useq, seed: int = 0, solve=0, z=None,
              normalize: bool = False, cp=None):
        """One sharded solve -> (wnoise [tau, adim], info with cost_min,
        cost_max, cost_mean and nabla), replicated on every rank."""
        if cp is not None:
            raise ValueError("a sharded solve runs one vehicle (cp=None)")
        if normalize:
            return self._normalized(x0, useq, seed, self._solves(solve),
                                    self._split(z))
        zsum, st = self.merge(self.rows(x0, useq, seed, solve, z))
        info = {"cost_min": st[2], "cost_max": st[3],
                "cost_mean": st[4] / self.k, "nabla": st[1]}
        return self.shards[0]._unfold(zsum) / st[1], info

    def _normalized(self, x0, useq, seed, solves, zs):
        """Phase A on every shard, the global beta and cost max, phase B
        on every shard, the sums of l and zsum."""
        lead, mesh = self.shards[0], self.mesh
        dyn = self._dyn(x0, useq)
        phase_a = [f.costs_phase(x0, useq, seed, s, zi, dyn=dyn)
                   for f, s, zi in zip(self.shards, solves, zs)]
        st = mesh.all_gather([torch.stack([c["cost_min"], c["cost_max"],
                                           c["cost_sum"]])
                              for _, c in phase_a])
        beta, cmax = st[:, 0].min(), st[:, 1].max()
        nrm = lead.weights_nrm(beta, cmax)
        rows = []
        for f, (costs, _), s, zi in zip(self.shards, phase_a, solves, zs):
            zsum, l = f.weights_phase(costs, beta, cmax, seed, s, zi,
                                      nrm=nrm)
            rows.append(torch.cat([l.reshape(1), zsum.reshape(-1)]))
        g = mesh.all_gather(rows)
        l, zsum = g[:, 0].sum(), g[:, 1:].sum(dim=0)
        info = {"cost_min": beta, "cost_max": cmax,
                "cost_mean": st[:, 2].sum() / self.k, "nabla": l}
        return lead._unfold(zsum) / l, info


def build_sharded_fused_solve(ctrl):
    """``(solve, solve_with_noise)`` of a ``ShardedFusedMPPI`` (the JAX
    function's pair): solve(state, useq, solve) -> (action, next_useq,
    info) on the Philox streams, solve_with_noise(z [tau, adim, K], state,
    useq) on injected normals split on K."""
    def solve(state, useq, s=0):
        return ctrl._fused_step(state, useq, solve=s)

    return solve, ctrl._solve_with_noise


class ShardedFusedMPPI(ShardedControllerMixin, MPPI):
    """``ShardedMPPI`` with the fused Hopper kernels on every shard: the
    same surface, over the model and cost pairs of the fused solve
    objects, tried in the JAX package's order (``FusedPointMassMPPI``,
    ``FusedLTIMPPI``, ``FusedAUVMPPI``, ``FusedNNMPPI``), with the
    single-device options (normalize_cost, clip, filter, antithetic,
    noise_schedule, kernel_dtype). On CPU shards the wrappers run their
    plain versions. Raises ``KernelUnsupportedError`` when no fused solve
    supports the pair, ``ValueError`` for an indivisible K."""

    def __init__(self, model, cost, mesh, k: int, tau: int, lam: float,
                 upsilon: float, sigma, seed: int = 0,
                 axis: str = SAMPLE_AXIS, observer=None, init_seq=None,
                 normalize_cost: bool = False, clip_actions: bool = False,
                 filter_seq: bool = False, filter_window: int = 9,
                 filter_polyorder: int = 3, antithetic: bool = False,
                 noise_schedule=None, kernel_dtype: str = "float32"):
        from ..kernels.auv_mppi import FusedAUVMPPI
        from ..kernels.nn_mppi import FusedNNMPPI
        from ..kernels.pm_mppi import (FusedLTIMPPI, FusedPointMassMPPI,
                                       check_compute_dtype)
        from ..ops.noise import resolve_noise_schedule

        check_compute_dtype(kernel_dtype)
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
        self._kernel_dtype = kernel_dtype
        sigma_np = np.asarray(sigma, np.float64)
        sched_np = resolve_noise_schedule(noise_schedule, self._tau)
        classes = (FusedPointMassMPPI, FusedLTIMPPI, FusedAUVMPPI,
                   FusedNNMPPI)
        shards = [self._make_fused(classes, self._k_local, sigma_np,
                                   sched_np) for _ in range(mesh.n_local)]
        self._fused = ShardedFusedSolve(shards, mesh, self._k)
        self.kernel_path = "cuda"

    @torch.no_grad()
    def _solve_with_noise(self, z, state, useq, sched=None):
        """The solve on injected standard normals z [tau, adim, K] (the
        kernels' layout, the same global array on every rank), split on
        K."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self._device)
        wnoise, info = self._fused.solve(state, useq, seed=self._base_seed,
                                         z=z, normalize=self._normalize_cost)
        action, shifted, new_useq = self._postprocess(useq, wnoise)
        return action, shifted, {**info, "useq": new_useq,
                                 "weighted_noise": wnoise}
