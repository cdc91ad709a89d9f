"""Waypoint missions on the controller (the JAX package's
``controller/missions.py``; the reference drafted ``WayPointsCost`` but
never advanced its queue, scripts/src/costs/cost_base.py:210-284).

- ``set_waypoints(mission)`` replaces the queue with a multi-leg mission,
  checked against the cost's capacity (an over-long mission would lose its
  middle legs to the clamped queue);
- ``advance_waypoints(state, radius)`` pops the leading waypoint once the
  plant is within ``radius`` of it and more than one leg remains (the pop
  rule of the JAX package's ``envs/mjx_env.waypoint_pop_arg_fn``:
  sum(d*d) < r^2 with d = cost.dist(state)).

The JAX package decides the pop on the device and reads the count back to
the host. Here every queue mutation enters through a host call, so the cost
keeps a host copy of its queue: the pop is decided on the host from the
state the caller already holds, and only a changed queue is uploaded
(pinned, non-blocking). A mission step therefore adds no host sync to
``MPPI.next``'s one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _waypoint_cost(cost):
    from ..costs.waypoints import WayPointsCost

    if not isinstance(cost, WayPointsCost):
        raise TypeError(
            f"waypoint missions need a WayPointsCost, the controller runs "
            f"{type(cost).__name__}")
    return cost


def validate_mission(cost, waypoints: Sequence) -> list:
    """Check a mission against a WayPointsCost; returns float64 rows.

    Raises TypeError unless ``cost`` is a WayPointsCost, ValueError when
    the mission is empty, exceeds the queue's capacity, or a waypoint's
    dimension differs from the cost's."""
    cost = _waypoint_cost(cost)
    wps = [np.asarray(w, np.float64).reshape(-1) for w in waypoints]
    if not wps:
        raise ValueError("waypoints must be non-empty")
    if len(wps) > cost.max_waypoints:
        raise ValueError(
            f"mission has {len(wps)} waypoints but the cost's queue "
            f"capacity is {cost.max_waypoints} (raise max_waypoints on "
            "the WayPointsCost)")
    for w in wps:
        if w.shape[0] != cost.dim:
            raise ValueError(
                f"waypoint dim {w.shape[0]} != Q dim {cost.dim}")
    return [cost.validate_waypoint(w) for w in wps]


def mission_params(cost, waypoints: Sequence) -> dict:
    """Replace the cost's queue with ``waypoints`` (validated once, one
    upload); returns the cost's params."""
    rows = validate_mission(cost, waypoints)
    cost._set_queue(rows)
    return cost.params()


def pop_if_reached(cost, state, radius: float) -> bool:
    """Pop the leading waypoint when sum(d*d) < radius^2 for
    d = cost.dist(state) and at least two legs remain; returns whether it
    popped. Decided on the host, in the cost's dtype, from the host copy
    of the queue."""
    cost = _waypoint_cost(cost)
    if cost.queue_length < 2:
        return False
    dtype = cost.waypoints.dtype
    x = torch.tensor(np.asarray(state, np.float64).reshape(-1), dtype=dtype)
    d = cost.dist(x, waypoint=torch.as_tensor(cost.leading_waypoint,
                                              dtype=dtype))
    r2 = torch.tensor(float(radius) ** 2, dtype=dtype)
    if not bool(torch.sum(d * d) < r2):
        return False
    cost.pop()
    return True


class MissionMixin:
    """Mission surface for a controller holding its cost as ``_cost``."""

    def set_waypoints(self, waypoints) -> None:
        """Replace the mission queue (data only: no solve is rebuilt)."""
        mission_params(self._cost, waypoints)

    def waypoints_remaining(self) -> int:
        """Active queue length (1 once the final leg is the goal)."""
        return _waypoint_cost(self._cost).queue_length

    def advance_waypoints(self, state, radius: float) -> bool:
        """Pop the leading waypoint when ``state`` is within ``radius`` of
        it and more than one leg remains; returns whether the queue
        advanced."""
        return pop_if_reached(self._cost, state, radius)
