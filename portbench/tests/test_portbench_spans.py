"""``glue_idle_ms.fleet``: the reader on a synthetic traced window, and on
the CPU the port's spans under the benchmark's own ranges, read by
``trace.read`` as the card's traced window is."""

from __future__ import annotations

import json
import re
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import ROOT, SEED
from portbench import harness, program, trace

READ = harness.reader(ROOT / "portbench", "glue_idle_ms.fleet")


def _run(idle_gaps, units=4):
    return SimpleNamespace(trace={"idle_gaps": idle_gaps, "units": units})


def test_reader_sums_the_ports_stages_a_step():
    run = _run([["portbench.plant", 0.010],
                ["portbench.next/mppi.fleet.next", 0.003],
                ["portbench.next", 0.001],
                ["portbench.next/aten::mm", 0.004],
                ["portbench.next/mppi.solve.pack", 0.002],
                ["portbench.window/mppi.loop.run", 0.050]])
    assert READ(run) == pytest.approx((0.003 + 0.002) * 1e3 / 4)


@pytest.mark.parametrize("run", [
    SimpleNamespace(trace=None),
    _run([["portbench.next", 0.066], ["portbench.next/aten::mm", 0.01]]),
    _run([["portbench.next/mppi.fleet.next", 0.003]], units=0),
], ids=["untraced", "no_spans", "no_steps"])
def test_reader_reports_nothing_without_the_spans(run):
    assert READ(run) is None


def test_fleet_next_on_the_cpu_is_put_down_to_its_stages(tmp_path):
    """No device operation runs on the CPU, so the whole window is idle,
    each part labelled by the innermost range open: the pack's own Python
    under ``portbench.next/mppi.solve.pack``, which a fleet this small
    keeps among the ten largest labels beside the plain rollout's ops."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cell = json.loads((ROOT / "portbench" / "workloads" /
                       "point_mass3d.fleet32.json").read_text())
    config = json.loads((ROOT / "portbench" / "configs" /
                         "point_mass3d.json").read_text())
    traffic = {**cell["params"], "vehicles": 2, "k": 32, "tau": 2}
    n = traffic["vehicles"]
    goals = np.tile(np.asarray(traffic["goal_base"], np.float64), (n, 1))
    fleet = program.fleet(config, traffic, SEED, "cpu", goals)
    x = np.tile(np.asarray(traffic["start"], np.float64), (n, 1))
    fleet.next(x)
    steps = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.window"):
            for _ in range(steps):
                with record_function("portbench.next"):
                    fleet.next(x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = trace.read(events, re.compile(r"\bpm_fused_solve_kernel\b"))
    got["units"] = steps
    idle = dict(got["idle_gaps"])
    assert got["busy_s"] == 0.0
    assert idle.get("portbench.next/mppi.solve.pack", 0.0) > 0.0
    assert READ(SimpleNamespace(trace=got)) > 0.0
