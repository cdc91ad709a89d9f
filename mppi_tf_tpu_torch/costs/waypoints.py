"""Waypoint-tracking costs (the reference's draft, completed).

Reference: scripts/src/costs/cost_base.py:210-284 (``WayPointsCost``: a
weighted quadratic distance to the first two waypoints, a single-goal cost
once one waypoint remains; the factory named an undefined symbol,
cost.py:45-48). The blend is (1 - alpha) d(w0) + alpha d(w1), the JAX
package's sign fix of the reference's (alpha - 1) d(w0) + alpha d(w1).

The queue is two buffers, ``waypoints`` [max_waypoints, dim] and ``count``
(int32), so a pop or an added waypoint changes data and never rebuilds a
solve, and ``params()`` gives the JAX package's pytree leaves in its order.
Every host mutation keeps a host copy of the queue: a host-driven mission's
pop is decided on the host, without reading the device, and the new queue
is uploaded with a pinned, non-blocking copy. The on-device loop
(``envs/mjx_env.py``) pops on the device with ``pop_queue``, the JAX
package's ``WayPointsCost.pop`` on the buffers, and refreshes the host
copy once a run (``sync_host``).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import CostBase


def pop_queue(cp: dict) -> dict:
    """The queue ``cp`` ({"count", "waypoints"} tensors) with its leading
    waypoint dropped: the rows rolled up by one, count = max(count - 1, 1)
    (the JAX package's ``WayPointsCost.pop``, costs/waypoints.py:116-122).
    Torch ops on the buffers' device, no host sync."""
    return {"count": torch.clamp(cp["count"] - 1, min=1),
            "waypoints": torch.roll(cp["waypoints"], -1, dims=0)}


class WayPointsCost(CostBase):
    """Quadratic tracking of a waypoint queue."""

    param_names = ("count", "waypoints")

    def __init__(self, lam, gamma, upsilon, sigma, Q, waypoints=None,
                 alpha: float = 0.2, max_waypoints: int = 32, diag=False,
                 dtype=torch.float32, device=None):
        super().__init__(lam, gamma, upsilon, sigma, dtype=dtype,
                         device=device)
        Qm = np.asarray(Q, dtype=np.float64)
        if diag:
            Qm = np.diag(Qm)
        self.dim = self._waypoint_dim(Qm)
        self.register_buffer("Q", torch.as_tensor(Qm, dtype=dtype,
                                                  device=device))
        self.alpha = float(alpha)
        self.max_waypoints = int(max_waypoints)
        rows = []
        for w in waypoints or ():
            w = np.asarray(w, np.float64).reshape(-1)
            if w.shape[0] != self.dim:
                raise AssertionError(
                    f"waypoint dim {w.shape[0]} != expected {self.dim}")
            rows.append(self.validate_waypoint(w))
        # the host copy of the queue, and its device buffers
        self._host = np.zeros((self.max_waypoints, self.dim))
        self._host[:len(rows)] = rows
        self._host_count = len(rows)
        self.register_buffer("waypoints", torch.as_tensor(
            self._host, dtype=dtype, device=device))
        self.register_buffer("count", torch.tensor(
            self._host_count, dtype=torch.int32, device=device))

    def _waypoint_dim(self, Qm: np.ndarray) -> int:
        """Waypoint row length implied by Q; subclass hook."""
        if Qm.shape[0] == 13:
            # a flat quadratic over the raw quaternion components is no
            # attitude metric (q and -q are one attitude): the 13-dim AUV
            # state needs the quaternion-aware cost
            raise TypeError(
                "a 13-dim state needs WayPointsQuatCost (task type "
                "'waypoints_quat', 10x10 Q over [pos err, 2*acos|q.g_q|, "
                "vel err]); the flat 13-dim quadratic is not a valid "
                "attitude metric")
        return int(Qm.shape[0])

    def validate_waypoint(self, w) -> np.ndarray:
        """Per-waypoint check, run by every queue mutation and by
        controller/missions.validate_mission; returns the row as float64."""
        w = np.asarray(w, np.float64).reshape(-1)
        if w.shape[0] != self.dim:
            raise ValueError(
                f"waypoint dim {w.shape[0]} != state dim {self.dim}")
        return w

    # --- the queue: host copy first, then one upload ---------------------
    def _upload(self) -> None:
        """Copy the host queue into the buffers: pinned and non-blocking
        on the card, so a mutation adds no host sync to the step."""
        wps = torch.as_tensor(self._host, dtype=self.waypoints.dtype)
        cnt = torch.tensor(self._host_count, dtype=torch.int32)
        if self.waypoints.device.type == "cuda":
            wps, cnt = wps.pin_memory(), cnt.pin_memory()
        with torch.no_grad():
            self.waypoints.copy_(wps, non_blocking=True)
            self.count.copy_(cnt, non_blocking=True)

    def sync_host(self, waypoints=None, count=None) -> None:
        """Re-read the host copy from the buffers, after they were written
        directly (a checkpoint, ``interop.from_jax_params``, the on-device
        loop's pops), or take it from ``waypoints`` and ``count``, host
        copies of the buffers the caller already fetched."""
        if waypoints is None:
            waypoints, count = self.waypoints.detach().cpu(), self.count
        self._host = torch.as_tensor(waypoints).double().numpy().copy()
        self._host_count = int(count)

    def queue_key(self) -> tuple:
        """Changes whenever the queue's buffers do (their version counters
        and storage): a solve object's cache key for terms it derives from
        the queue."""
        return tuple((b._version, b.data_ptr(), b.device)
                     for b in (self.waypoints, self.count))

    @property
    def queue_length(self) -> int:
        """Active queue length, from the host copy (no device read)."""
        return self._host_count

    @property
    def leading_waypoint(self) -> np.ndarray:
        """The leading waypoint, from the host copy."""
        return self._host[0].copy()

    def _set_queue(self, rows) -> None:
        """Replace the whole queue with pre-validated float64 rows (the
        missions layer validates once); one upload."""
        rows = np.asarray(rows, np.float64).reshape(-1, self.dim)
        n = min(rows.shape[0], self.max_waypoints)
        self._host = np.zeros((self.max_waypoints, self.dim))
        self._host[:n] = rows[:n]
        self._host_count = max(n, 1)
        self._upload()

    def _append(self, w) -> None:
        idx = min(self._host_count, self.max_waypoints - 1)
        self._host[idx] = self.validate_waypoint(w)
        self._host_count = min(self._host_count + 1, self.max_waypoints)

    def add_waypoint(self, waypoint) -> None:
        """Append a waypoint (the last slot is overwritten once full).
        Reference: cost_base.py:230-238."""
        self._append(waypoint)
        self._upload()

    def add_waypoints(self, waypoints) -> None:
        for w in waypoints:
            self._append(w)
        self._upload()

    def pop(self) -> None:
        """Drop the leading (reached) waypoint; the queue never empties
        below one."""
        self._host = np.roll(self._host, -1, axis=0)
        self._host_count = max(self._host_count - 1, 1)
        self._upload()

    def set_goal(self, goal) -> None:
        """Single-goal override: the queue becomes the one waypoint."""
        w = self.validate_waypoint(goal)
        self._host = np.zeros((self.max_waypoints, self.dim))
        self._host[0] = w
        self._host_count = 1
        self._upload()

    # --- cost --------------------------------------------------------------
    def _dist_waypoint(self, state: torch.Tensor,
                       wp: torch.Tensor) -> torch.Tensor:
        """(x - w)^T Q (x - w). Reference: cost_base.py:273-281."""
        diff = state - wp[None, :]
        return torch.sum((diff @ self.Q.T) * diff, dim=-1)

    def state_cost(self, state: torch.Tensor) -> torch.Tensor:
        """Blend of the quadratics of the first two waypoints; the first
        alone when one remains. Reference: cost_base.py:240-271."""
        d_first = self._dist_waypoint(state, self.waypoints[0])
        d_second = self._dist_waypoint(state, self.waypoints[1])
        blended = (1.0 - self.alpha) * d_first + self.alpha * d_second
        return torch.where(self.count < 2, d_first, blended)

    def dist(self, state, waypoint=None) -> torch.Tensor:
        """x - w to the leading waypoint (or ``waypoint``), one state [dim]."""
        w = self.waypoints[0] if waypoint is None else waypoint
        return torch.as_tensor(state, dtype=w.dtype,
                               device=w.device).reshape(-1) - w


class WayPointsQuatCost(WayPointsCost):
    """Waypoint queue over the 13-dim quaternion AUV state.

    Each waypoint is scored on the 10-dim error [pos err (3), theta (1),
    vel err (6)] against a 10x10 Q, with theta = 2 acos(|<q, w_q>|): the
    geodesic angle, the same for q and -q. This deviates on purpose from
    StaticQuatCost's signed dot (static_cost.py:145-159), which scores
    theta = 2 pi at the goal attitude for a waypoint written in the other
    hemisphere and would stall the mission's pop. Every queue mutation
    checks that the waypoint's attitude is a unit quaternion.
    """

    STATE_DIM = 13

    def _waypoint_dim(self, Qm: np.ndarray) -> int:
        if Qm.shape != (10, 10):
            raise AssertionError(f"Q must be [10, 10], got {Qm.shape}")
        return self.STATE_DIM

    def validate_waypoint(self, w) -> np.ndarray:
        """Reject a waypoint whose attitude block is not a unit quaternion;
        renormalise drift of at most 1e-3 (an f32 round trip)."""
        w = super().validate_waypoint(w)
        n = float(np.linalg.norm(w[3:7]))
        if abs(n - 1.0) > 1e-3:
            raise ValueError(
                f"waypoint attitude |q| = {n:.4f} is not a unit "
                "quaternion (components 3:7 of the 13-dim waypoint)")
        out = w.copy()
        out[3:7] = w[3:7] / n
        return out

    @staticmethod
    def _err10(state: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
        """[n, 13] states, [13] waypoint -> [n, 10] error."""
        dot = torch.clamp(torch.abs(state[:, 3:7] @ wp[3:7]), -1.0, 1.0)
        return torch.cat([state[:, :3] - wp[None, :3],
                          2.0 * torch.acos(dot)[:, None],
                          state[:, 7:13] - wp[None, 7:13]], dim=-1)

    def _dist_waypoint(self, state: torch.Tensor,
                       wp: torch.Tensor) -> torch.Tensor:
        d = self._err10(state, wp)
        return torch.sum((d @ self.Q.T) * d, dim=-1)

    def dist(self, state, waypoint=None) -> torch.Tensor:
        """10-dim error to the leading waypoint (or ``waypoint``) of one
        state [13] (-> [10]) or a batch [n, 13] (-> [n, 10]): the pop radius
        measures attitude as an angle."""
        w = self.waypoints[0] if waypoint is None else waypoint
        x = torch.as_tensor(state, dtype=w.dtype, device=w.device)
        d = self._err10(x.reshape(-1, self.STATE_DIM), w)
        return d[0] if x.ndim == 1 else d
