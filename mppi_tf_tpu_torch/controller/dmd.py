"""DMD-MPPI: MPPI over an online-identified linear (DMDc) model.

Counterpart of ``mppi_tf_tpu/controller/dmd.py`` (the reference reserves
the capability as an empty ``DMDMPPI`` subclass,
scripts/src/controllers/dmd_controller.py). The controller is a standard
MPPI whose model is a ``models.dmd.DMDModel``, re-identified from the
transitions that arrive through the reference's ``save(x, u, x_next)``
hook. Flow per control step (``envs/runner.ClosedLoopRunner``):

    u = ctrl.next(x)        # MPPI solve under the current (A, B)
    x' = plant.step(u)
    ctrl.save(x, u, x')     # buffer the transition; every ``refit_every``
                            # saves, refit (A, B) by truncated-SVD DMDc

The fit runs on the CPU, where the replay buffer lives, and its (A, B)
reach the model in place through ``MPPI.model_params`` (a pinned,
non-blocking upload on the card): on the kernel path
(``kernels/pm_mppi.FusedLTIMPPI``) the next solve reads them from its
``dyn`` array, with no rebuild and no host sync. The mesh-sharded
counterparts, ``ShardedDMDMPPI`` (torch route) and ``ShardedFusedDMDMPPI``
(``FusedLTIMPPI`` on every shard), refit the same way: every rank holds
the replicated replay buffer, so every rank's refit gives the same (A, B)
bits.
"""

from __future__ import annotations

import numpy as np

from ..learning.replay import ReplayBuffer
from ..models.dmd import DMDModel
from ..parallel.fused import ShardedFusedMPPI
from ..parallel.sharded import ShardedMPPI
from .mppi import MPPI


class DMDAdaptiveMixin:
    """Online DMDc identification riding the ``save()`` hook.

    ``refit_every``: re-identify (A, B) every N saved transitions.
    ``min_samples``: do not fit before this many transitions are buffered
    (default 2*(sDim+aDim); the snapshot matrix needs at least sDim+aDim
    independent rows for a unique operator).
    ``buffer_capacity``: replay window; old transitions roll off, so the
    model tracks a slowly time-varying plant.
    """

    def __init__(self, model: DMDModel, cost, *args, refit_every: int = 10,
                 min_samples: int | None = None,
                 buffer_capacity: int = 4096, **kwargs):
        if not isinstance(model, DMDModel):
            raise TypeError(
                f"{type(self).__name__} needs a models.dmd.DMDModel (got "
                f"{type(model).__name__})")
        super().__init__(model, cost, *args, **kwargs)
        if refit_every < 1:
            raise ValueError(f"refit_every must be >= 1, got {refit_every}")
        sdim, adim = model.get_state_dim(), model.get_action_dim()
        self._rb = ReplayBuffer(buffer_capacity, sdim, adim)
        self._refit_every = int(refit_every)
        self._min_samples = (2 * (sdim + adim) if min_samples is None
                             else int(min_samples))
        self._saves = 0
        self._fits = 0

    def _refit(self) -> None:
        self.model_params = self._model.fit_from_buffer(self._rb)
        self._fits += 1

    def save(self, x, u, x_next) -> None:
        """Buffer the applied transition, refit the model every
        ``refit_every`` saves once ``min_samples`` are buffered, then log
        the prediction error as ``MPPI.save`` does."""
        self._rb.add(x, u, x_next)
        self._saves += 1
        if (self._saves % self._refit_every == 0
                and len(self._rb) >= self._min_samples):
            self._refit()
        super().save(x, u, x_next)

    def fit_now(self) -> None:
        """Refit now (e.g. after seeding the buffer with exploration
        transitions); raises below ``min_samples``."""
        if len(self._rb) < self._min_samples:
            raise ValueError(
                f"{len(self._rb)} transitions buffered; need at least "
                f"min_samples={self._min_samples} to identify the model")
        self._refit()

    def save_state(self, path: str) -> None:
        """The controller's checkpoint (``path``) plus the identification
        state in ``path + '.dmd.npz'``: the identified (A, B), the replay
        window and the save / fit counters, under the JAX package's keys."""
        super().save_state(path)
        tr = self._rb.get_all_transitions()
        mp = self.model_params
        np.savez(path + ".dmd.npz", A=mp["A"].cpu().numpy(),
                 B=mp["B"].cpu().numpy(), obs=tr["obs"], act=tr["act"],
                 next_obs=tr["next_obs"], saves=self._saves,
                 fits=self._fits)

    def load_state(self, path: str) -> None:
        super().load_state(path)
        d = np.load(path + ".dmd.npz")
        self.model_params = {"A": d["A"], "B": d["B"]}
        self._rb = ReplayBuffer(self._rb.capacity, self._rb.s_dim,
                                self._rb.a_dim)
        for o, a, n in zip(d["obs"], d["act"], d["next_obs"]):
            self._rb.add(o, a, n)
        self._saves = int(d["saves"])
        self._fits = int(d["fits"])

    @property
    def replay(self) -> ReplayBuffer:
        return self._rb

    @property
    def n_fits(self) -> int:
        return self._fits


class DMDMPPI(DMDAdaptiveMixin, MPPI):
    """Single-device MPPI with online DMDc identification. On the card
    ``kernel="auto"`` (or ``"cuda"``) runs ``FusedLTIMPPI``: a refit is
    new data for the same kernel."""



class ShardedDMDMPPI(DMDAdaptiveMixin, ShardedMPPI):
    """Mesh-sharded (torch route) MPPI with online DMDc identification: a
    refit writes the new (A, B) in place, the sharded solve is not
    rebuilt."""


class ShardedFusedDMDMPPI(DMDAdaptiveMixin, ShardedFusedMPPI):
    """Mesh-sharded fused-kernel MPPI with online DMDc identification:
    every shard runs the dynamic-(A, B) kernels (``FusedLTIMPPI``) on its
    K/n samples."""
