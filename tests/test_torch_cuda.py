"""The port's CUDA kernels on the card, each against its plain version,
and the controller's kernel path. Every test here needs a GPU and skips
without one.

This file imports neither JAX nor the JAX package, so that it runs on a
machine without JAX:  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import _build
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.models import get_model

pytestmark = pytest.mark.cuda

SIGMA = np.diag([0.25, 0.3, 0.2])
LAM, GAMMA, UPS = 0.8, 0.2, 1.2
TASK = {"type": "static", "diag": True,
        "goal": [1.0, 0.0, 0.5, 0.0, -0.5, 0.0],
        "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _modules(device, mass=1.3, ups=UPS, sdim=6, adim=3):
    model = get_model({"type": "point_mass", "mass": mass}, dt=0.1,
                      state_dim=sdim, action_dim=adim, device=device)
    task = {"type": "static", "goal": [0.5] * sdim, "Q": [1.0] * sdim,
            "diag": True} if sdim != 6 else TASK
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=ups,
                    sigma=SIGMA[:adim, :adim], device=device)
    return model, cost


def _fused(k, tau, device, **kw):
    model, cost = _modules(device, **kw)
    adim = model.get_action_dim()
    return pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                 upsilon=kw.get("ups", UPS),
                                 sigma=SIGMA[:adim, :adim])


def test_build_reports_every_kernel(cuda_device):
    names = " ".join(r["kernel"] for r in _build.ptxas_report())
    for kernel in ("pm_fused_solve_kernel", "pm_merge_kernel",
                   "pm_noise_dump_kernel"):
        assert kernel in names


@pytest.mark.parametrize("k,tau", [(700, 7), (5000, 20)])
def test_noise_dump_matches_plain(cuda_device, k, tau):
    z = pm.pm_noise_dump(123, 7, k, tau, 3, cuda_device)
    ref = pm.noise_plain(123, 7, k, tau, 3, device=cuda_device)
    torch.testing.assert_close(z, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,tau,sdim,adim", [
    (700, 7, 6, 3), (4096, 25, 6, 3), (1000, 9, 2, 1), (1000, 9, 4, 2)])
def test_fused_solve_and_merge_match_plain(cuda_device, k, tau, sdim, adim):
    fused = _fused(k, tau, cuda_device, sdim=sdim, adim=adim)
    rng = np.random.default_rng(6)
    z = torch.as_tensor(rng.standard_normal((tau, adim, k), np.float32),
                        device=cuda_device)
    x0 = torch.as_tensor(rng.normal(size=sdim) * 0.2, dtype=torch.float32,
                         device=cuda_device)
    useq = torch.as_tensor(rng.normal(size=(tau, adim)) * 0.1,
                           dtype=torch.float32, device=cuda_device)
    dyn = fused.pack_dyn(x0, useq)
    part_k = pm.pm_fused_solve(fused.consts, dyn, k, tau, z=z)
    part_p = pm.fused_solve_plain(fused.consts, dyn, k, tau, z=z)
    zs_k, st_k = pm.merge_plain(part_k)
    zs_p, st_p = pm.merge_plain(part_p)
    torch.testing.assert_close(zs_k / st_k[1], zs_p / st_p[1], rtol=1e-3,
                               atol=1e-5)
    torch.testing.assert_close(st_k[2:5], st_p[2:5], rtol=1e-4, atol=0)
    zs_m, st_m = pm.pm_merge(part_p)
    torch.testing.assert_close(zs_m / st_m[1], zs_p / st_p[1], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(st_m, st_p, rtol=1e-5, atol=0)


def test_prng_solve_consumes_dump(cuda_device):
    k, tau = 3000, 12
    fused = _fused(k, tau, cuda_device)
    x0 = torch.zeros(6, device=cuda_device)
    useq = torch.zeros(tau, 3, device=cuda_device)
    wn_a, _ = fused.solve(x0, useq, seed=5, solve=9)
    z = pm.pm_noise_dump(5, 9, k, tau, 3, cuda_device)
    wn_b, _ = fused.solve(x0, useq, z=z)
    torch.testing.assert_close(wn_a, wn_b, rtol=1e-6, atol=0)


def test_wrappers_count_launches_and_check_inputs(cuda_device):
    fused = _fused(700, 7, cuda_device)
    before = dict(pm.launch_counts)
    fused.solve(torch.zeros(6, device=cuda_device),
                torch.zeros(7, 3, device=cuda_device), seed=1, solve=2)
    torch.cuda.synchronize()
    assert pm.launch_counts["pm_fused_solve"] == before["pm_fused_solve"] + 1
    assert pm.launch_counts["pm_merge"] == before["pm_merge"] + 1
    dyn = torch.zeros(pm.Dyn(7, 6, 3).size, device=cuda_device)
    with pytest.raises(TypeError):
        pm.pm_fused_solve(fused.consts, dyn.double(), 700, 7)
    with pytest.raises(ValueError):
        pm.pm_fused_solve(fused.consts, dyn[:-1], 700, 7)
    with pytest.raises(ValueError):
        pm.pm_fused_solve(fused.consts, dyn, 700, 7,
                          z=torch.zeros(7, 3, 699, device=cuda_device))
    with pytest.raises(ValueError):
        pm.pm_fused_solve(fused.consts, dyn.cpu(), 700, 7,
                          z=torch.zeros(7, 3, 700, device=cuda_device))


@pytest.mark.parametrize("opt,item", [
    ({"normalize_cost": True}, "item 2"), ({"log": True}, "items 2 and 3"),
    ({"antithetic": True}, "item 4"),
    ({"noise_schedule": {"type": "exp", "start": 1.0, "end": 0.25}},
     "item 4")])
def test_cuda_path_unported_options(cuda_device, opt, item):
    model, cost = _modules(cuda_device)
    with pytest.raises(NotImplementedError, match=item):
        MPPI(model, cost, k=300, tau=8, sigma=SIGMA, kernel="cuda",
             device=cuda_device, **opt)
    ctrl = MPPI(model, cost, k=300, tau=8, sigma=SIGMA, kernel="auto",
                device=cuda_device, **opt)
    assert ctrl.kernel_path == "torch"


def test_cuda_path_unbuilt_dims(cuda_device):
    from mppi_tf_tpu_torch.kernels.errors import KernelUnsupportedError

    model = get_model({"type": "point_mass"}, state_dim=8, action_dim=4)
    cost = get_cost({"type": "static", "goal": [0.0] * 8, "Q": [1.0] * 8,
                     "diag": True}, lam=LAM, gamma=GAMMA, upsilon=1.0,
                    sigma=np.eye(4))
    with pytest.raises(KernelUnsupportedError):
        MPPI(model, cost, k=100, tau=4, sigma=np.eye(4), kernel="cuda",
             device=cuda_device)
    ctrl = MPPI(model, cost, k=100, tau=4, sigma=np.eye(4), kernel="auto",
                device=cuda_device)
    assert ctrl.kernel_path == "torch"


def test_cuda_closed_loop_reaches_goal(cuda_device):
    """The fused kernels drive the point mass to the goal on the card."""
    model, cost = _modules(cuda_device, mass=1.0, ups=1.0)
    ctrl = MPPI(model, cost, k=4096, tau=25, lam=LAM, upsilon=1.0,
                sigma=SIGMA, kernel="auto", device=cuda_device)
    assert ctrl.kernel_path == "cuda"
    before = pm.launch_counts["pm_fused_solve"]
    x = torch.zeros(6, device=cuda_device)
    for _ in range(80):
        u = ctrl.next(x.cpu().numpy())
        x = model.predict(x, torch.as_tensor(u, device=cuda_device)).detach()
    assert pm.launch_counts["pm_fused_solve"] - before == 80
    err = (x - cost.goal).norm().item()
    assert err < 0.2, f"did not reach goal: {x.cpu().numpy()}"
