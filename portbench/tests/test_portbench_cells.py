"""Every cell's CPU path at a test size: judged correct as it is, and not
correct with its timed path broken underneath (the faults a cell can
have on one chip) or with the port's bf16 block compute in its place
(the control, the nearest precision below the configurations' f32). A
cell added from files alone runs too. The chip check is skipped here:
the run is driven through ``harness.run`` on the CPU."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, SMALL, run_cpu, small_copy

CELLS = sorted(SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(small_root, cell):
    r = run_cpu(small_root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(small_root, cell):
    r = run_cpu(small_root, cell, kernel_dtype="bfloat16")
    assert not r["correct"], r["checks"]


def _unchanged(self, useq, wnoise):
    """A step that returns its state unchanged: the sequence is not
    updated (nor shifted), its first row applied."""
    return useq[..., 0, :], useq, useq


def _altered(orig):
    def post(self, useq, wnoise):
        action, shifted, new = orig(self, useq, wnoise)
        return action + 0.1 * self._sigma.diagonal(), shifted, new
    return post


def _half_batch(orig):
    """Half of the samples left out, the weighted mean over the rest."""
    def solve(self, *args, **kwargs):
        k = self.k
        self.k = k // 2
        try:
            return orig(self, *args, **kwargs)
        finally:
            self.k = k
    return solve


FAULTS = ["unchanged", "half_batch", "altered_action"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(small_root, monkeypatch, cell,
                                            fault):
    from mppi_tf_tpu_torch.controller.mppi import MPPI
    from mppi_tf_tpu_torch.kernels.pm_mppi import TwoPhaseSolve

    if fault == "unchanged":
        monkeypatch.setattr(MPPI, "_postprocess", _unchanged)
    elif fault == "altered_action":
        monkeypatch.setattr(MPPI, "_postprocess",
                            _altered(MPPI._postprocess))
    else:
        monkeypatch.setattr(TwoPhaseSolve, "solve",
                            _half_batch(TwoPhaseSolve.solve))
    r = run_cpu(small_root, cell)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("cell", ["rexrov2.on_device_mission",
                                  "point_mass3d.on_device_loop"])
def test_an_altered_plant_state_is_not_correct(small_root, monkeypatch,
                                               cell):
    from mppi_tf_tpu_torch.envs import AUVEnv, DevicePointMassEnv

    for cls in (AUVEnv, DevicePointMassEnv):
        orig = cls.step_fn

        def step_fn(self, x, u, orig=orig):
            return orig(self, x, u) * (1.0 + 1e-3)

        monkeypatch.setattr(cls, "step_fn", step_fn)
    r = run_cpu(small_root, cell)
    assert not r["correct"], r["checks"]


def test_a_cell_added_from_files_alone(tmp_path):
    """A new cell (here the point mass's fleet at 2 vehicles, normalised)
    needs a workload file and a manifest entry, nothing else."""
    spec = json.loads((ROOT / "portbench" / "workloads" /
                       "point_mass3d.fleet32.json").read_text())
    spec.update(name="point_mass3d.fake", traffic="fake",
                why="a test's cell: 2 point masses, normalised")
    spec["params"].update(SMALL["point_mass3d.fleet32"], vehicles=2,
                          normalize=True)
    root = small_copy(tmp_path, {"point_mass3d.fake": spec})
    r = run_cpu(root, "point_mass3d.fake")
    assert r["correct"], r["checks"]
    assert r["attempted"] % 2 == 0


def test_no_jax_is_loaded_by_a_run(small_root):
    """A fresh interpreter runs a cell's CPU path; neither JAX nor the JAX
    package is loaded once its window has closed."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from conftest import run_cpu; from pathlib import Path;"
        "from portbench import harness;"
        "r = run_cpu(Path(sys.argv[2]), 'point_mass3d.fleet32');"
        "assert r['correct'];"
        "print(harness.forbidden_modules())")
    out = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "portbench" / "tests"),
         str(small_root)], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """Without a CUDA device the command prints no result and fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "point_mass3d.fleet32", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
