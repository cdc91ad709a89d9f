"""The port's spans and counters: which stage of a step the host is in,
on the profiler's clock.

``span(name, id=None)`` marks a stage of the port (a fleet step and its
graph's capture and replay, the two-phase solve's pack (and in it the NN weight segment's,
``mppi.solve.pack.weights``), rollout, merge, weights and unfold, the on-device
loop's load, capture, replay and sync, the library's load and build).
Tracing is on after ``enable()`` (until ``disable()``) or while a
``torch.profiler`` records; otherwise ``span`` returns one shared no-op
context and costs a flag test. While on, a span

- opens a ``torch.profiler.record_function`` range under its name when a
  profiler records, so that it lands in the profiler's Chrome trace,
  nested under the caller's ranges, and the device's idle time can be put
  down to the stage the host was in;
- appends ``Span(name, start_ns, end_ns, parent, id)`` to a ring of the
  last ``CAPACITY`` spans. Times are Unix-epoch nanoseconds
  (``time.time_ns``), the clock of the profiler's trace (its ``ts`` plus
  ``baseTimeNanoseconds``); the start is stamped after the range opens and
  the end before it closes, so each span lies inside its range.
  ``parent`` is the name of the span open around it on the same thread;
  ``id`` is the step it belongs to (a fleet's or a controller's step
  count, a loop run's first step), inherited from the parent when not
  given.

``summary()`` gives per span name the count, total and self time (the
total less that of its direct children) and the median and 95th
percentile; ``export(path)`` writes the ring as a Chrome trace to lay over
the profiler's. ``counters(*loops)`` reads the port's counters where they
are kept: the kernel launches by entry point, the launches recorded into
CUDA graphs, the plant kernels' own two counts, the NN solves' weight
segments packed, the library builds of this process, ``FleetMPPI.next``'s
steps by how they ran (replayed, eager, capturing) and, for each
on-device loop given, its captured period's kernel launches (``nodes``,
the plant's ``plant_nodes``), its graph's nodes by kind
(``graph_nodes``), its captures, the last one's seconds and its plant
calls a period.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler

#: spans the ring keeps, the oldest dropped first
CAPACITY = 1 << 16

_enabled = False
_ring = collections.deque(maxlen=CAPACITY)
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    id: Optional[int]


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler records."""
    global _enabled
    _enabled = False


def clear() -> None:
    """Empty the ring."""
    _ring.clear()


def spans() -> list:
    """The ring's spans, oldest first."""
    return [Span(*s) for s in _ring]


class _Off:
    """The context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """An open span: a profiler range (while one records) and, while
    tracing is on, an entry of the ring. ``seconds`` is its length on the
    span's clock."""

    __slots__ = ("name", "id", "start_ns", "end_ns", "_record", "_range")

    def __init__(self, name: str, id, record: bool):
        self.name, self.id, self._record = name, id, record

    def __enter__(self):
        self._range = None
        if self._record:
            stack = _stack()
            if self.id is None and stack:
                self.id = stack[-1].id
            stack.append(self)
            if _profiler._is_profiler_enabled:
                self._range = _profiler.record_function(self.name)
                self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._record:
            stack = _stack()
            stack.pop()
            # a plain tuple of atomic values, which the collector stops
            # tracking: a full ring of named tuples slows every full
            # collection
            _ring.append((self.name, self.start_ns, self.end_ns,
                          stack[-1].name if stack else None, self.id))
            if self._range is not None:
                self._range.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, id: Optional[int] = None):
    """A context marking stage ``name`` (``mppi.*``) of step ``id``: a
    shared no-op unless tracing is on."""
    if _enabled or _profiler._is_profiler_enabled:
        return _On(name, id, True)
    return _OFF


def timed(name: str, id: Optional[int] = None) -> _On:
    """``span`` that times its block whether or not tracing is on: its
    ``seconds`` is the port's one clock of that stage (the loop's
    ``capture_s``)."""
    return _On(name, id, _enabled or _profiler._is_profiler_enabled)


def _quantile(sorted_ns: list, q: float) -> float:
    """The q-quantile of sorted durations, linearly interpolated, in ms."""
    pos = q * (len(sorted_ns) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_ns) - 1)
    return (sorted_ns[lo] + (sorted_ns[hi] - sorted_ns[lo]) * (pos - lo)) \
        * 1e-6


def summary() -> dict:
    """{name: {count, total_ms, self_ms, p50_ms, p95_ms}} over the ring;
    self time is the total less that of the spans whose parent has the
    name."""
    durations = collections.defaultdict(list)
    children = collections.defaultdict(int)
    for s in spans():
        d = s.end_ns - s.start_ns
        durations[s.name].append(d)
        if s.parent is not None:
            children[s.parent] += d
    out = {}
    for name, ds in durations.items():
        ds.sort()
        total = sum(ds)
        out[name] = {"count": len(ds), "total_ms": total * 1e-6,
                     "self_ms": (total - children[name]) * 1e-6,
                     "p50_ms": _quantile(ds, 0.5),
                     "p95_ms": _quantile(ds, 0.95)}
    return out


def export(path) -> None:
    """Write the ring as a Chrome trace (complete events, microseconds
    from ``baseTimeNanoseconds``, as the profiler writes its own)."""
    ring = spans()
    base = (min(s.start_ns for s in ring) // 10**9 * 10**9 if ring
            else 0)
    events = [{"name": s.name, "cat": "mppi_span", "ph": "X",
               "ts": (s.start_ns - base) / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3,
               "pid": os.getpid(), "tid": "mppi spans",
               "args": {"parent": s.parent, "id": s.id}} for s in ring]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base,
                   "displayTimeUnit": "ms"}, f)


def counters(*loops) -> dict:
    """The port's counters as they stand: the solve's kernel launches by
    entry point (``launch_counts``), its launches recorded into CUDA
    graphs (``captured_counts``), the plant kernels' two counts
    (``plant_counts``: ``kernels/plant.py``), the NN solves' weight
    segments packed (``nn_weight_packs``: ``kernels/nn_mppi.py``), nvcc
    builds in this process (``library_builds``), the fleet steps by how
    they ran (``fleet_steps``: ``controller/fleet.py``), the normals the
    unnormalised point-mass solve held in shared memory and drew again
    (``pm_z_held``: ``kernels/_launch.py`` ``z_held``; its engage share is
    held / (held + redrawn)) and, for each loop
    of ``loops``, its ``nodes``,
    ``plant_nodes``, ``graph_nodes``, ``captures``, ``capture_s`` and
    ``plant_calls``."""
    from .controller import fleet
    from .kernels import _build, _launch, nn_mppi, plant

    out = {"launch_counts": dict(_launch.launch_counts),
           "captured_counts": dict(_launch.captured_counts),
           "plant_counts": {"launch_counts": dict(plant.launch_counts),
                            "captured_counts": dict(plant.captured_counts)},
           "nn_weight_packs": nn_mppi.weight_packs,
           "library_builds": _build.library_builds,
           "fleet_steps": dict(fleet.fleet_steps),
           "pm_z_held": dict(_launch.z_held)}
    if loops:
        out["loops"] = [{"nodes": dict(lp.nodes),
                         "plant_nodes": dict(lp.plant_nodes),
                         "graph_nodes": dict(lp.graph_nodes),
                         "captures": lp.captures,
                         "capture_s": lp.capture_s,
                         "plant_calls": lp.plant_calls} for lp in loops]
    return out
