"""The port's spans and counters (``mppi_tf_tpu_torch/tracing.py``).

On the CPU: with tracing off no span is recorded and no profiler range is
entered; with tracing on, ``FleetMPPI.next``, ``MPPI.next`` and an
on-device loop's eager run record their span trees, with parents and step
ids; under ``torch.profiler`` each span is a range of the profiler's trace,
nested under its caller's, and the in-memory span lies inside its range on
the same clock; ``summary``'s self time is the total less the children's.

On the card (marker ``cuda``; skipped without one): ``next`` syncs the host
once, at the actions' copy, and a loop's ``graph_nodes`` equal the device
operations the profiler records in a replayed period, kind by kind (the
kernels: ``graph_nodes["kernel"]``), for both on-device cells of the
benchmark. This file imports neither JAX nor the JAX package:
python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import json
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from mppi_tf_tpu_torch import tracing
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.controller.fleet import FleetMPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.envs import DevicePointMassEnv, build_on_device_loop
from mppi_tf_tpu_torch.models import get_model

SIGMA = np.diag([0.4, 0.4])
LAM = 0.6
TASK = {"type": "static", "diag": True, "goal": [1.0, 0.0, -0.5, 0.0],
        "Q": [8.0, 1.5, 8.0, 1.5]}
#: how far an in-memory span may lie outside its profiler range (the
#: profiler's clock against ``time.time_ns``)
CLOCK_TOL_NS = 50_000
ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 12_345


@pytest.fixture(autouse=True)
def _tracing_off():
    """Each test starts and ends with tracing off and the ring empty."""
    tracing.disable()
    tracing.clear()
    try:
        yield
    finally:
        tracing.disable()
        tracing.clear()


def _family():
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=4, action_dim=2, dtype=torch.float32)
    cost = get_cost(TASK, lam=LAM, gamma=0.2, upsilon=1.0, sigma=SIGMA,
                    dtype=torch.float32)
    return model, cost


def _fleet(normalize=False, n=3):
    """A CPU fleet on the kernel route (the fused solve's plain
    versions)."""
    fleet = FleetMPPI(*_family(), n_vehicles=n, k=64, tau=5, lam=LAM,
                      upsilon=1.0, sigma=SIGMA, normalize_cost=normalize,
                      device="cpu")
    fleet._tpl._resolve_kernel("auto", SIGMA, None)
    return fleet


def _controller(normalize=False):
    ctrl = MPPI(*_family(), k=64, tau=5, lam=LAM, upsilon=1.0, sigma=SIGMA,
                normalize_cost=normalize, device="cpu")
    ctrl._resolve_kernel("auto", SIGMA, None)
    return ctrl


def _tree():
    """The ring as (name, parent, id), in the order the spans ended."""
    return [(s.name, s.parent, s.id) for s in tracing.spans()]


def _solve(parent, step, normalize):
    """The two-phase solve's spans under ``parent`` at step ``step``."""
    phase_b = ([("mppi.solve.weights", parent, step),
                ("mppi.solve.merge", parent, step)] if normalize else [])
    return [("mppi.solve.pack", parent, step),
            ("mppi.solve.rollout", parent, step),
            ("mppi.solve.merge", parent, step), *phase_b,
            ("mppi.solve.unfold", parent, step),
            ("mppi.post", parent, step)]


# ---- off ----

def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    fleet, ctrl = _fleet(normalize=True), _controller()
    fleet.next(np.zeros((3, 4)))
    ctrl.next(np.zeros(4))
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    build_on_device_loop(ctrl, env.step_fn, 2, 2).eager(np.zeros(4))
    assert tracing.spans() == []
    assert tracing.span("mppi.a") is tracing.span("mppi.b")


def test_timed_times_its_block_with_tracing_off():
    with tracing.timed("mppi.loop.capture") as span:
        time.sleep(0.002)
    assert span.seconds >= 0.002
    assert tracing.spans() == []


# ---- the span trees ----

@pytest.mark.parametrize("normalize", [False, True],
                         ids=["one_phase", "two_phase"])
def test_fleet_next_records_its_span_tree(normalize):
    fleet = _fleet(normalize)
    tracing.enable()
    for _ in range(2):
        fleet.next(np.zeros((3, 4)))
    want = []
    for step in (0, 1):
        root = "mppi.fleet.next"
        want += [("mppi.fleet.upload", root, step),
                 *_solve(root, step, normalize),
                 ("mppi.fleet.actions", root, step), (root, None, step)]
    assert _tree() == want


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["one_phase", "two_phase"])
def test_controller_next_records_its_span_tree(normalize):
    ctrl = _controller(normalize)
    tracing.enable()
    for _ in range(2):
        ctrl.next(np.zeros(4))
    want = []
    for step in (0, 1):
        want += [("mppi.upload", "mppi.next", step),
                 *_solve("mppi.next", step, normalize),
                 ("mppi.actions", "mppi.next", step),
                 ("mppi.next", None, step)]
    assert _tree() == want


def test_loop_eager_run_records_its_span_tree():
    ctrl = _controller()
    ctrl.next(np.zeros(4))                    # the loop's step0 is then 1
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    loop = build_on_device_loop(ctrl, env.step_fn, 2, 2)
    tracing.enable()
    loop.eager(np.zeros(4))
    root = "mppi.loop.run"
    assert _tree() == [("mppi.loop.load", root, 1),
                       ("mppi.loop.load", root, 1),
                       *_solve(root, 1, False), *_solve(root, 1, False),
                       ("mppi.loop.sync", root, 1), (root, None, 1)]
    assert loop.capture_s is None and loop.graph_nodes == {}


def test_fleet_loop_eager_run_records_its_span_tree():
    fleet = _fleet()
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    run = fleet.build_on_device_loop(env.step_fn, 2, substeps=2)
    tracing.enable()
    run.eager(np.zeros((3, 4)), step0=7)
    root = "mppi.loop.run"
    assert _tree() == [("mppi.loop.load", root, 7),
                       ("mppi.loop.load", root, 7),
                       *_solve(root, 7, False), *_solve(root, 7, False),
                       ("mppi.loop.sync", root, 7), (root, None, 7)]


# ---- the profiler's trace ----

def _profiled_fleet_step(tmp_path):
    """One fleet step under the CPU profiler inside a caller's range, after
    a warm-up span: (the trace's events, its base in ns)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fleet = _fleet(normalize=True)
    fleet.next(np.zeros((3, 4)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("mppi.warmup"):
            pass
        tracing.clear()
        with record_function("caller"):
            fleet.next(np.zeros((3, 4)))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    return doc["traceEvents"], int(doc.get("baseTimeNanoseconds", 0))


def _ranges(events, name):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("name") == name
                  and e.get("cat") == "user_annotation")


def test_each_span_is_a_range_nested_under_its_caller(tmp_path):
    events, _ = _profiled_fleet_step(tmp_path)
    (c0, c1), = _ranges(events, "caller")
    (r0, r1), = _ranges(events, "mppi.fleet.next")
    assert c0 <= r0 and r1 <= c1
    names = {s.name for s in tracing.spans()}
    assert len(names) == 9
    for s in tracing.spans():
        got = _ranges(events, s.name)
        assert got, s.name
        if s.parent is not None:
            (p0, p1), = _ranges(events, s.parent)
            assert all(p0 <= a and b <= p1 for a, b in got), s.name


def test_spans_lie_inside_their_ranges_on_the_trace_clock(tmp_path):
    events, base = _profiled_fleet_step(tmp_path)
    by_name = {}
    for s in tracing.spans():
        by_name.setdefault(s.name, []).append(s)
    for name, spans in by_name.items():
        ranges = _ranges(events, name)
        assert len(ranges) == len(spans), name
        for s, (a, b) in zip(sorted(spans, key=lambda s: s.start_ns),
                             ranges):
            start_us = (s.start_ns - base) / 1e3
            end_us = (s.end_ns - base) / 1e3
            assert start_us >= a - CLOCK_TOL_NS / 1e3, name
            assert end_us <= b + CLOCK_TOL_NS / 1e3, name


# ---- summary, export, counters ----

def test_summary_self_time_is_total_less_children():
    tracing.enable()
    for _ in range(3):
        with tracing.span("mppi.a", 1):
            time.sleep(0.001)
            for _ in range(2):
                with tracing.span("mppi.b"):
                    time.sleep(0.0005)
    spans = tracing.spans()
    assert {(s.name, s.parent, s.id) for s in spans} == {
        ("mppi.a", None, 1), ("mppi.b", "mppi.a", 1)}
    dur = {name: [s.end_ns - s.start_ns for s in spans if s.name == name]
           for name in ("mppi.a", "mppi.b")}
    got = tracing.summary()
    assert got["mppi.a"]["count"] == 3 and got["mppi.b"]["count"] == 6
    assert got["mppi.a"]["total_ms"] == pytest.approx(sum(dur["mppi.a"]) / 1e6)
    assert got["mppi.a"]["self_ms"] == pytest.approx(
        (sum(dur["mppi.a"]) - sum(dur["mppi.b"])) / 1e6)
    assert got["mppi.b"]["self_ms"] == pytest.approx(
        got["mppi.b"]["total_ms"])
    for name in dur:
        for q, key in ((50, "p50_ms"), (95, "p95_ms")):
            assert got[name][key] == pytest.approx(
                np.percentile(dur[name], q) / 1e6)


def test_summary_of_a_fleet_step_adds_up():
    fleet = _fleet(normalize=True)
    tracing.enable()
    fleet.next(np.zeros((3, 4)))
    got = tracing.summary()
    children = sum(v["total_ms"] for k, v in got.items()
                   if k != "mppi.fleet.next")
    root = got["mppi.fleet.next"]
    assert root["self_ms"] == pytest.approx(root["total_ms"] - children)
    assert 0 < root["self_ms"] < root["total_ms"]


def test_export_writes_the_ring_as_a_chrome_trace(tmp_path):
    fleet = _fleet()
    tracing.enable()
    fleet.next(np.zeros((3, 4)))
    path = tmp_path / "spans.json"
    tracing.export(path)
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    spans = tracing.spans()
    assert [e["name"] for e in doc["traceEvents"]] == [s.name for s in spans]
    for e, s in zip(doc["traceEvents"], spans):
        assert e["ph"] == "X"
        assert base + e["ts"] * 1e3 == pytest.approx(s.start_ns, abs=1e3)
        assert e["dur"] * 1e3 == pytest.approx(s.end_ns - s.start_ns,
                                               abs=1.0)
        assert e["args"] == {"parent": s.parent, "id": s.id}


def test_the_ring_keeps_the_last_capacity_spans():
    tracing.enable()
    for i in range(tracing.CAPACITY + 5):
        with tracing.span("mppi.x", i):
            pass
    spans = tracing.spans()
    assert len(spans) == tracing.CAPACITY
    assert spans[0].id == 5 and spans[-1].id == tracing.CAPACITY + 4


def test_counters_read_the_ports_counters_in_place():
    from mppi_tf_tpu_torch.kernels import _build, _launch, plant

    ctrl = _controller()
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    loop = build_on_device_loop(ctrl, env.step_fn, 2, 2)
    loop.eager(np.zeros(4))
    got = tracing.counters(loop)
    assert got["launch_counts"] == _launch.launch_counts
    assert got["captured_counts"] == _launch.captured_counts
    assert got["plant_counts"] == {"launch_counts": plant.launch_counts,
                                   "captured_counts": plant.captured_counts}
    assert got["library_builds"] == _build.library_builds
    assert got["loops"] == [{"nodes": {}, "plant_nodes": {},
                             "graph_nodes": {}, "captures": 0,
                             "capture_s": None, "plant_calls": 1}]
    assert "loops" not in tracing.counters()


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cell(name: str, **override):
    """(program, configuration, traffic) of a cell of the benchmark, its
    traffic with ``override``."""
    from portbench import program

    bench = ROOT / "portbench"
    cell = json.loads((bench / "workloads" / f"{name}.json").read_text())
    config = json.loads((bench / "configs" / f"{cell['config']}.json")
                        .read_text())
    return program, config, {**cell["params"], **override}


def _host_syncs(fn) -> list:
    """The synchronizing CUDA calls ``fn()`` makes, as the sync debug mode
    reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rexrov2.fleet16", "point_mass3d.fleet32"])
def test_fleet_next_syncs_once(cuda_device, cell):
    program, config, traffic = _cell(cell, k=8192)
    n = traffic["vehicles"]
    goals = np.tile(np.asarray(traffic["goal_base"], np.float64), (n, 1))
    fleet = program.fleet(config, traffic, SEED, "cuda", goals)
    x = np.tile(np.asarray(traffic["start"], np.float64), (n, 1))
    for _ in range(2):
        fleet.next(x)
    syncs = _host_syncs(lambda: fleet.next(x))
    assert len(syncs) == 1, syncs


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rexrov2.on_device_mission",
                                  "point_mass3d.on_device_loop"])
def test_controller_next_syncs_once(cuda_device, cell):
    program, config, traffic = _cell(cell)
    ctrl = program.controller(config, traffic, SEED, "cuda")
    x = np.asarray(traffic["start"], np.float64)
    for _ in range(2):
        ctrl.next(x)
    syncs = _host_syncs(lambda: ctrl.next(x))
    assert len(syncs) == 1, syncs


def _profiled_ops(loop) -> dict:
    """The device operations the profiler records over ``loop.steps``
    replays of the loop's period graph (its output rows rewound first), by
    the kind of graph node each runs: {kernel, memcpy, memset}. CUDA may
    run a memcpy node as a kernel of its own (``memcpy32_post``), which
    the profiler lists among the kernels."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    loop._bufs.row.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(loop.steps):
            loop._graphs[0].replay()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    ops = dict.fromkeys(("kernel", "memcpy", "memset"), 0)
    for e in events:
        cat = e.get("cat")
        if cat == "kernel":
            ops["memcpy" if e["name"].startswith("memcpy") else "kernel"] += 1
        elif cat == "gpu_memcpy":
            ops["memcpy"] += 1
        elif cat == "gpu_memset":
            ops["memset"] += 1
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rexrov2.on_device_mission",
                                  "point_mass3d.on_device_loop"])
def test_graph_nodes_are_the_device_ops_of_a_period(cuda_device, cell):
    """``graph_nodes`` against the profiler's operations of the replayed
    periods, kind by kind (``graph_nodes["kernel"]``: the kernels). The
    profiler loses records of replayed graphs now and then, so the fullest
    of up to 3 profiles is compared."""
    program, config, traffic = _cell(cell, periods=3)
    ctrl = program.controller(config, traffic, SEED, "cuda")
    plant = program.device_plant(config, traffic)
    loop = program.on_device_loop(ctrl, plant, traffic)
    tracing.enable()
    loop(np.asarray(traffic["start"], np.float64), step0=0)
    capture, = [s for s in tracing.spans() if s.name == "mppi.loop.capture"]
    assert loop.capture_s == (capture.end_ns - capture.start_ns) * 1e-9
    assert loop.captures == 1
    nodes = loop.graph_nodes
    assert nodes["other"] == 0
    assert nodes["kernel"] >= sum(loop.nodes.values()) > 0
    want = {kind: loop.steps * nodes[kind]
            for kind in ("kernel", "memcpy", "memset")}
    best = {}
    for _ in range(3):
        got = _profiled_ops(loop)
        if sum(got.values()) > sum(best.values()):
            best = got
        if best == want:
            break
    assert best == want, (best, nodes)
