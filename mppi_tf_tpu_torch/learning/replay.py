"""Transition replay buffer on the host.

Reference: the cpprb ``ReplayBuffer`` of LearnerBase
(scripts/src/learners/learner_base.py:33-64) with obs / act / next_obs,
and the C++ ``DataBase`` CSV transition store (src/data_base.cpp:52-71).
As in the JAX package (``mppi_tf_tpu/learning/replay.py``), storage is the
native C++ datastore (``datastore.py``, built with g++ at first use) with
``use_native=True`` where it builds, else a preallocated numpy ring; the
surface is the same either way and ``backend`` says which it is.
Transitions arrive from the plant on the host, so the buffer imports no
torch.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Fixed-capacity ring buffer of (obs, act, next_obs) transitions."""

    def __init__(self, capacity: int, s_dim: int, a_dim: int,
                 use_native: bool = True):
        self.capacity = int(capacity)
        self.s_dim = int(s_dim)
        self.a_dim = int(a_dim)
        # monotonic adds counter: len() saturates at capacity
        self.total_added = 0
        self._native = None
        if use_native:
            try:   # as the JAX buffer: no compiler, no build -> numpy
                from .datastore import NativeDataStore

                self._native = NativeDataStore(capacity, s_dim, a_dim)
            except Exception:
                self._native = None
        if self._native is None:
            self._obs = np.zeros((self.capacity, self.s_dim))
            self._act = np.zeros((self.capacity, self.a_dim))
            self._next = np.zeros((self.capacity, self.s_dim))
            self._idx = 0
            self._size = 0

    def __len__(self) -> int:
        if self._native is not None:
            return len(self._native)
        return self._size

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "numpy"

    def add(self, obs, act, next_obs) -> None:
        """Append one transition (learner_base.py:57-58, add_rb)."""
        obs = np.asarray(obs, np.float64).reshape(-1)
        act = np.asarray(act, np.float64).reshape(-1)
        next_obs = np.asarray(next_obs, np.float64).reshape(-1)
        self.total_added += 1
        if self._native is not None:
            self._native.add(obs, act, next_obs)
            return
        i = self._idx
        self._obs[i] = obs
        self._act[i] = act
        self._next[i] = next_obs
        self._idx = (i + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)

    def _rows(self, idx) -> Dict[str, np.ndarray]:
        return {"obs": self._obs[idx].copy(), "act": self._act[idx].copy(),
                "next_obs": self._next[idx].copy()}

    def get_all_transitions(self) -> Dict[str, np.ndarray]:
        """All stored transitions, oldest first (learner_base.py:60-61)."""
        if self._native is not None:
            return self._native.get_all()
        if self._size < self.capacity:
            return self._rows(slice(0, self._size))
        return self._rows(np.roll(np.arange(self.capacity), -self._idx))

    def sample(self, batch: int, rng: Optional[np.random.Generator] = None):
        """Uniform random minibatch by index into the ring; raises on an
        empty buffer."""
        rng = rng or np.random.default_rng()
        n = len(self)
        if n == 0:
            raise ValueError(
                "replay buffer is empty — add transitions before sampling")
        idx = rng.integers(0, n, size=batch)
        if self._native is not None:   # the store has no ring view
            return {k: v[idx] for k, v in self.get_all_transitions().items()}
        if self._size >= self.capacity:  # ring full: physical = logical+idx
            idx = (idx + self._idx) % self.capacity
        return self._rows(idx)

    def save_transitions(self, path: str) -> None:
        """npz, or with a .csv extension the C++ DataBase layout (x...,
        u..., x_next... per row)."""
        data = self.get_all_transitions()
        if path.endswith(".csv"):
            rows = np.concatenate(
                [data["obs"], data["act"], data["next_obs"]], axis=1)
            header = ([f"x{i}" for i in range(self.s_dim)]
                      + [f"u{i}" for i in range(self.a_dim)]
                      + [f"x_next{i}" for i in range(self.s_dim)])
            np.savetxt(path, rows, delimiter=",", header=",".join(header),
                       comments="")
        else:
            np.savez(path, **data)

    def load_transitions(self, path: str) -> None:
        """Append the transitions of a file written by
        ``save_transitions``."""
        if path.endswith(".csv"):
            rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
            obs = rows[:, :self.s_dim]
            act = rows[:, self.s_dim:self.s_dim + self.a_dim]
            nxt = rows[:, self.s_dim + self.a_dim:]
        else:
            if not os.path.exists(path) and os.path.exists(path + ".npz"):
                path = path + ".npz"
            data = np.load(path)
            obs, act, nxt = data["obs"], data["act"], data["next_obs"]
        for o, a, n in zip(obs, act, nxt):
            self.add(o, a, n)
