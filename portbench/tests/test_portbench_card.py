"""Each cell's command on the card, briefly: one JSON line as the last
line of standard output with the contract's keys, judged correct, its
metrics named by the manifest; the bf16 control judged not correct at
the cell's own size. Skips without a card (decided in the fixture).

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _run(*args):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=900, cwd=ROOT)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell, trace):
    out = _run("portbench/run.py", "--workload", cell, "--seed",
               str(2 ** 31 + 77), "--seconds", "2", "--trace", str(trace))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    group = MANIFEST["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group if cell in m.get("workloads", CELLS)}
    assert set(r["metrics"]) == want
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        for name, m in r["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_fails_at_the_cells_size(card, cell):
    out = _run("portbench/control.py", "--workload", cell, "--seconds", "1",
               "--seeds", str(2 ** 31 + 78), "--kernel-dtype", "bfloat16")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    spec = json.loads((ROOT / "portbench" / "workloads" /
                       f"{cell}.json").read_text())
    assert any(v > spec["limits"][k] for k, v in line["checks"].items())
