"""The ``nn_auv`` configuration and its cell ``nn_auv.fleet16`` on the CPU:
the plain reference against the port's ``NNAUVModel`` and its NN kernel's
plain costs, the cell judged correct at a test size (3 vehicles, K = 256,
H = 5, the published 3 x 32 widths) and not correct under the timed
path's faults or the bf16 control, no JAX loaded by a run, and the
counts' floor below the port's own tensor-core bound at the cell's
shape."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, run_cpu, small_copy
from test_portbench_cells import FAULTS, _altered, _half_batch, _unchanged

CELL = "nn_auv.fleet16"
SPEC = json.loads((ROOT / "portbench" / "workloads" / f"{CELL}.json")
                  .read_text())
CONFIG = json.loads((ROOT / "portbench" / "configs" / "nn_auv.json")
                    .read_text())
SMALL = {"vehicles": 3, "k": 256, "tau": 5, "judge_solves": 4,
         "warmup_steps": 1}
#: the reference against the port's f64 model and plain kernel costs: the
#: same arithmetic in another order
F64_RTOL = 1e-12


@pytest.fixture
def nn_root(tmp_path):
    cell = json.loads(json.dumps(SPEC))
    cell["params"].update(SMALL)
    return small_copy(tmp_path, {CELL: cell})


def _reference(device="cpu"):
    from portbench.reference import nn_auv

    return nn_auv.Reference(CONFIG, device)


def _port_f64():
    """The port's model at f64 holding the f32 weights it draws."""
    from mppi_tf_tpu_torch.models import get_model

    kw = dict(dt=CONFIG["dt"], state_dim=13, action_dim=6)
    m32 = get_model(CONFIG["model"], **kw)
    m64 = get_model(CONFIG["model"], dtype=torch.float64, **kw)
    return m64.with_trainable(m32.net)


def _inputs(k=64, tau=4, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((k, 13))
    x[:, :3] = rng.normal(size=(k, 3))
    q = rng.normal(size=(k, 4)) * 0.2
    q[:, 3] += 1.0
    x[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 7:] = 0.2 * rng.normal(size=(k, 6))
    u = rng.normal(size=(k, 6)) * np.array([2000.0] * 3 + [200.0] * 3)
    return (torch.as_tensor(x), torch.as_tensor(u),
            torch.as_tensor(rng.standard_normal((tau, 6, k))),
            torch.as_tensor(300.0 * rng.normal(size=(tau, 6))))


def test_reference_step_is_the_ports_model():
    ref, model = _reference(), _port_f64()
    x, u, _, _ = _inputs()
    want = model.step(x, u)
    got = ref.step(x, u)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               rtol=F64_RTOL, atol=F64_RTOL)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(got[:, 3:7], dim=1).numpy(), 1.0,
        rtol=1e-14)


def test_reference_costs_are_the_plain_kernel_costs():
    """The reference's per-sample rollout costs (mppi.py) == the port's
    plain ``nn_fused_costs`` on the same normals, both at f64."""
    from mppi_tf_tpu_torch.controller import MPPI
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.kernels import nn_mppi
    from portbench import program
    from portbench.reference import mppi as ref_mppi

    ref, model = _reference(), _port_f64()
    c = CONFIG["controller"]
    goal = [0.0, 0.0, -1.5, 0.0, 0.0, 0.0, 1.0] + [0.0] * 6
    sigma = np.diag(c["sigma_diag"])
    cost = get_cost(program.task(CONFIG, SPEC["params"], goal),
                    lam=c["lam"], gamma=c["gamma"], upsilon=c["upsilon"],
                    sigma=sigma, dtype=torch.float64)
    k, tau = 64, 4
    ctrl = MPPI(model, cost, k=k, tau=tau, lam=c["lam"],
                upsilon=c["upsilon"], sigma=sigma, device="cpu")
    ctrl._resolve_kernel("auto", sigma, None)
    x, _, z, useq = _inputs(k, tau)
    fused = ctrl._fused
    dyn = fused.pack_dyn(x[0], useq)
    costs, _ = nn_mppi.fused_costs_plain(fused.consts, dyn, k, tau, z=z)
    eps = z.permute(2, 0, 1) @ ref.scale.T
    want = ref_mppi._costs(ref, x[0], useq, eps, ref.static_params(goal))
    np.testing.assert_allclose(costs.numpy(), want.numpy(), rtol=F64_RTOL)


def test_reference_weights_are_drawn_as_the_port_draws_them():
    model = _port_f64()
    for (w, b), layer in zip(_reference().layers, model.net):
        assert torch.equal(w, layer.w.detach()) and torch.equal(
            b, layer.b.detach())


def test_the_files_normalisers_are_recomputed_from_their_definition():
    """The configuration's normalisers are what its ``assumed`` says: the
    mean and the population std + 1e-8 of the features [x[3:], u] and the
    deltas x' - x over 16 episodes of 256 rexrov2 transitions from rest at
    dt 0.1, u ~ N(0, sigma^2) from numpy's default_rng(0), stepped by the
    plain rexrov2 plant; f32 in the file."""
    from portbench.reference import rexrov2

    plant_cfg = json.loads((ROOT / "portbench" / "configs" / "rexrov2.json")
                           .read_text())
    plant = rexrov2.Reference(plant_cfg, "cpu")
    sigma = np.asarray(CONFIG["controller"]["sigma_diag"])
    rng = np.random.default_rng(0)
    X, Y = [], []
    for _ in range(16):
        x = np.zeros((1, 13))
        x[0, 6] = 1.0
        for _ in range(256):
            u = rng.standard_normal((1, 6)) * sigma
            nxt = plant.host_plant(x, u, CONFIG["dt"], 1)
            X.append(np.concatenate([x[0, 3:], u[0]]))
            Y.append(nxt[0] - x[0])
            x = nxt
    X, Y = np.array(X), np.array(Y)
    want = {"x_mean": X.mean(0), "x_std": X.std(0) + 1e-8,
            "y_mean": Y.mean(0), "y_std": Y.std(0) + 1e-8}
    norm = CONFIG["model"]["normalisers"]
    for key, value in want.items():
        np.testing.assert_array_equal(np.float32(norm[key]),
                                      value.astype(np.float32), err_msg=key)


def test_cell_runs_correct_on_the_cpu(nn_root):
    r = run_cpu(nn_root, CELL)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] % SMALL["vehicles"] == 0
    assert {"setup_s", "vehicle_solves_per_s", "replan_p95_ms"} <= set(
        r["metrics"])


def test_the_bf16_control_is_not_correct(nn_root):
    r = run_cpu(nn_root, CELL, kernel_dtype="bfloat16")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(nn_root, monkeypatch, fault):
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
    r = run_cpu(nn_root, CELL)
    assert not r["correct"], (fault, r["checks"])


def test_no_jax_is_loaded_by_a_run_of_the_cell(nn_root):
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from conftest import run_cpu; from pathlib import Path;"
        "from portbench import harness;"
        f"r = run_cpu(Path(sys.argv[2]), {CELL!r});"
        "assert r['correct'];"
        "print(harness.forbidden_modules())")
    out = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "portbench" / "tests"),
         str(nn_root)], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("normalize", [True, False])
def test_the_floor_lies_below_the_ports_tensor_core_bound(normalize):
    """The counts' rollout floor at the cell's K and H is at most the
    port's ``roofline.nn_tc_bound`` (the kernel's own form: padded 3xTF32
    products added to the CUDA cores' time), on the same bytes."""
    from mppi_tf_tpu_torch import roofline
    from mppi_tf_tpu_torch.kernels.nn_mppi import NnConsts
    from portbench.counts import nn_auv

    traffic = {**SPEC["params"], "normalize": normalize}
    k, tau = traffic["k"], traffic["tau"]
    c = CONFIG["controller"]
    scale = np.diag(c["sigma_diag"])
    consts = NnConsts(sizes=tuple(nn_auv.sizes(CONFIG)), lam=c["lam"],
                      nc_half=0.0, renorm=True, scale=scale,
                      Mz=scale.T @ np.linalg.inv(scale) @ scale,
                      Q=np.diag(CONFIG["cost"]["Q"]))
    floor_ms = nn_auv.rollout_floor_s(CONFIG, traffic) * 1e3
    bound_ms, _ = roofline.nn_tc_bound(consts, 0.0, k, tau, prng=True,
                                       costs_only=normalize)
    assert 0 < floor_ms <= bound_ms
    work = nn_auv.solve_work(CONFIG, traffic)
    assert work["ops"] >= k * tau * nn_auv.mlp_flops(CONFIG) / 495e12 * 67e12
