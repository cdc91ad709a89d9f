"""The manifest against the benchmark's contract, and every name in it
found as a file: configurations, cells, drivers, references, counts and
metric readers."""

from __future__ import annotations

import ast
import importlib
import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "portbench"
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"][:2] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_names_units_sources(group):
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if group == "end_to_end":
            assert set(m) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
            assert m["moves"] in e2e and _one_line(m["layer"])
            if "roofline" in m["name"] or "mfu" in m["name"]:
                assert m["unit"] == "%"
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS


def test_setup_s_everywhere():
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_its_metrics(cell):
    def reported(group):
        return {m["name"] for m in MANIFEST[group]
                if cell in m.get("workloads", CELLS)}

    e2e, layer = reported("end_to_end"), reported("per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in MANIFEST["per_layer"]:
        if cell in m.get("workloads", CELLS):
            assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_found_by_name(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1 and _one_line(entry["why"])
    spec = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    for key in ("name", "config", "traffic", "chips", "why"):
        assert spec[key] == entry[key]
    config = json.loads(
        (BENCH / "configs" / f"{spec['config']}.json").read_text())
    assert config["name"] == spec["config"]
    assert (BENCH / "drivers" / f"{spec['driver']}.py").is_file()
    assert (BENCH / "reference" / f"{config['reference']}.py").is_file()
    assert (BENCH / "counts" / f"{config['counts']}.py").is_file()
    assert set(spec["limits"]) >= {"start", "shift_fill"} or \
        set(spec["limits"]) >= {"action_gap", "state_gap"}


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_each_metric_has_a_reader(group):
    from portbench import harness

    for m in MANIFEST[group]:
        assert callable(harness.reader(BENCH, m["name"]))


def test_configs_found_and_uncut():
    seen = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["file"] not in seen
        seen.add(c["file"])
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] == []
        assert _one_line(c["source"]) and config["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_in_the_benchmark_and_no_port_in_the_reference():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    for p in files:
        tops = set(_imports(p))
        assert not tops & {"jax", "jaxlib", "flax", "mppi_tf_tpu"}, p
        if "reference" in p.parts:
            assert "mppi_tf_tpu_torch" not in tops, p
    # only program.py imports the port
    users = [p.name for p in files if "mppi_tf_tpu_torch" in _imports(p)]
    assert users == ["program.py"]


def test_frozen_counts_give_the_kernel_tables_bounds():
    from portbench.counts import auv, mppi, point_mass

    pm = json.loads((BENCH / "configs" / "point_mass3d.json").read_text())
    rx = json.loads((BENCH / "configs" / "rexrov2.json").read_text())
    w = point_mass.solve_work(pm, {"k": 100_000, "tau": 50,
                                   "normalize": False})
    ms, by = mppi.bound_ms(w["ops"], w["bytes"])
    assert round(ms, 4) == 0.0135 and by == "operations"
    step, q_ops = auv.step_ops(rx, "static_quat")
    costs = mppi.rollout(262_144, 25, 6, step, q_ops, True)
    assert round(mppi.bound_ms(costs, 0.0)[0], 4) == 0.1026
    weights = mppi.weights_ops(262_144, 150)
    assert round(mppi.bound_ms(weights, 0.0)[0], 4) == 0.0200
    w = auv.solve_work(rx, {"k": 262_144, "tau": 25, "normalize": True,
                            "task": "static_quat"})
    assert w["ops"] == costs + weights


def test_drivers_and_references_import_by_name():
    for cell in CELLS:
        spec = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
        mod = importlib.import_module(f"portbench.drivers.{spec['driver']}")
        assert hasattr(mod, "Cell") and hasattr(mod, "judge")
