"""Fixtures of the benchmark's tests: a copy of the benchmark at test
sizes, in which a cell runs its CPU path (the port's fused solves in their
plain versions, the same Philox stream as the kernels), and the card's
presence, decided when a test asks."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: each cell's parameters at a size a test run holds (widths kept)
SMALL = {
    "rexrov2.fleet16": {"vehicles": 3, "k": 512, "tau": 6,
                        "judge_solves": 4, "warmup_steps": 1},
    "point_mass3d.fleet32": {"vehicles": 4, "k": 700, "tau": 7,
                             "judge_solves": 4, "warmup_steps": 1},
    "rexrov2.on_device_mission": {"k": 512, "tau": 5, "periods": 40,
                                  "warmup_runs": 1},
    "point_mass3d.on_device_loop": {"k": 700, "tau": 7, "periods": 30,
                                    "warmup_runs": 1},
}
SEED = 2 ** 31 + 12_345


def small_copy(dest: Path, extra_cells: dict | None = None) -> Path:
    """A checkout root at ``dest`` holding BENCHMARK.json and the
    benchmark's files with every cell at its test size, and
    ``extra_cells`` ({name: cell dict}) added as files and entries."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, params in SMALL.items():
        p = dest / "portbench" / "workloads" / f"{name}.json"
        cell = json.loads(p.read_text())
        cell["params"].update(params)
        p.write_text(json.dumps(cell))
    for name, cell in (extra_cells or {}).items():
        (dest / "portbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(cell))
        manifest["workloads"].append(
            {k: cell[k] for k in ("name", "config", "traffic", "chips",
                                  "why")})
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


@pytest.fixture
def small_root(tmp_path):
    return small_copy(tmp_path)


def run_cpu(root: Path, cell: str, kernel_dtype: str = "float32",
            seconds: float = 0.5, seed: int = SEED) -> dict:
    from portbench import harness

    ctx = harness.Context(root, cell, seed, "cpu", kernel_dtype=kernel_dtype)
    return harness.run(ctx, seconds, False)


@pytest.fixture
def card():
    """Skips unless a CUDA device is present (decided when asked)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
