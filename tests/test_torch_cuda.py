"""The port's CUDA kernels on the card, each against its plain version,
and the controller's kernel path. Every test here needs a GPU and skips
without one.

This file imports neither JAX nor the JAX package, so that it runs on a
machine without JAX:  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mppi_tf_tpu_torch import flagship
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import _build
from mppi_tf_tpu_torch.kernels import auv_mppi as auv
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
    rows = _build.ptxas_report()
    names = " ".join(r["kernel"] for r in rows)
    for kernel in ("pm_fused_solve_kernel", "pm_merge_kernel",
                   "pm_noise_dump_kernel", "mppi_weights_kernel",
                   "auv_fused_solve_kernel"):
        assert kernel in names
    # RK 1, 2, 4 x (fused, costs) x (static_quat, waypoints_quat, elipse3d)
    assert sum("auv_fused_solve_kernel" in r["kernel"] for r in rows) == 18
    # (fused, costs) x (three quadratic dims + the (4, 2) ellipse) x
    # (constant, dynamic (A, B))
    assert sum("pm_fused_solve_kernel" in r["kernel"] for r in rows) == 16
    assert not [r for r in rows if r.get("spill_stores")
                or r.get("spill_loads")]


@pytest.mark.parametrize("k,tau,adim", [(700, 7, 3), (5000, 20, 3),
                                        (700, 7, 6)])
def test_noise_dump_matches_plain(cuda_device, k, tau, adim):
    z = pm.pm_noise_dump(123, 7, k, tau, adim, cuda_device)
    ref = pm.noise_plain(123, 7, k, tau, adim, device=cuda_device)
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
    ({"normalize_cost": True}, None), ({"log": True}, None),
    ({"normalize_cost": True, "log": True}, None),
    ({"antithetic": True}, None),
    ({"noise_schedule": {"type": "exp", "start": 1.0, "end": 0.25}},
     None),
    ({"kernel_dtype": "bfloat16"}, "queue-2 item 7")])
def test_cuda_path_unported_options(cuda_device, opt, item):
    """normalize_cost, log, antithetic and the noise schedule run on the
    kernel path; bf16 blocks still raise."""
    model, cost = _modules(cuda_device)
    if item is None:
        ctrl = MPPI(model, cost, k=300, tau=8, sigma=SIGMA, kernel="cuda",
                    device=cuda_device, **opt)
        assert ctrl.kernel_path == "cuda"
        state = torch.zeros(6, device=cuda_device)
        _, _, info = ctrl._fused_step(state, ctrl.useq)
        if opt.get("log"):
            assert info["sample_costs"].shape == (300,)
            assert info["noise"].shape == (300, 8, 3)
        assert np.all(np.isfinite(ctrl.next(np.zeros(6))))
        return
    for kernel in ("cuda", "auto"):
        with pytest.raises(NotImplementedError, match=item):
            MPPI(model, cost, k=300, tau=8, sigma=SIGMA, kernel=kernel,
                 device=cuda_device, **opt)


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


# ---------------------------------------------------------------------------
# phase A / phase B and the AUV kernels
# ---------------------------------------------------------------------------

AUV_SIGMA = np.diag([40.0, 40.0, 40.0, 5.0, 5.0, 5.0])


def _auv_fused(k, tau, device, rk=2, sigma=AUV_SIGMA):
    model = get_model({**flagship.auv_params(), "rk": rk}, dt=0.1,
                      device=device)
    cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.2,
                    sigma=sigma, device=device)
    return auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=0.5, upsilon=1.2,
                            sigma=sigma)


def _auv_inputs(fused, device, seed=0):
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.standard_normal((fused.tau, 6, fused.k),
                                            np.float32), device=device)
    x0 = torch.zeros(13, device=device)
    x0[2], x0[6] = -1.0, 1.0
    useq = torch.as_tensor(5.0 * rng.standard_normal((fused.tau, 6)),
                           dtype=torch.float32, device=device)
    with torch.no_grad():
        dyn = fused.pack_dyn(x0, useq)
    return z, x0, useq, dyn


# per-sample costs of O(1e3-1e4) in f32, summed in another order: rtol
# 1e-4; the theta term 2 acos(dot) carries ~3e-4 rad of rounding near
# dot = 1, where acos is steep, hence a small absolute floor
COST_RTOL, COST_ATOL = 1e-4, 1e-2


@pytest.mark.parametrize("rk", [1, 2, 4])
@pytest.mark.parametrize("k,tau", [(700, 7), (4096, 25)])
def test_auv_kernels_match_plain(cuda_device, rk, k, tau):
    fused = _auv_fused(k, tau, cuda_device, rk)
    z, _, _, dyn = _auv_inputs(fused, cuda_device, seed=rk)
    c = fused.consts
    costs_k, rows_k = auv.auv_fused_costs(c, dyn, k, tau, z=z)
    costs_p = auv.sample_costs_plain(c, dyn, z)
    torch.testing.assert_close(costs_k, costs_p, rtol=COST_RTOL,
                               atol=COST_ATOL)
    _, st = pm.merge_plain(rows_k)
    torch.testing.assert_close(
        st[2:5], torch.stack([costs_k.min(), costs_k.max(), costs_k.sum()]),
        rtol=1e-5, atol=0)
    # fused partials against block_partials of the kernel's own costs:
    # the softmax apart from the rollout
    part_k = auv.auv_fused_solve(c, dyn, k, tau, z=z)
    part_p = pm.block_partials(costs_k, z.reshape(tau * 6, k), c.lam)
    torch.testing.assert_close(part_k[:, :5], part_p[:, :5], rtol=1e-5,
                               atol=1e-6)
    zs_k, st_k = pm.merge_plain(part_k)
    zs_p, st_p = pm.merge_plain(part_p)
    torch.testing.assert_close(zs_k / st_k[1], zs_p / st_p[1], rtol=1e-3,
                               atol=1e-5)
    # end to end at this (test) noise scale
    zs_e, st_e = pm.merge_plain(auv.fused_solve_plain(c, dyn, k, tau, z=z))
    torch.testing.assert_close(zs_k / st_k[1], zs_e / st_e[1], rtol=1e-2,
                               atol=1e-3)


@pytest.mark.parametrize("adim,k,tau", [(3, 5000, 20), (6, 4097, 25)])
def test_mppi_weights_matches_plain(cuda_device, adim, k, tau):
    rng = np.random.default_rng(adim)
    costs = torch.as_tensor(rng.uniform(1e3, 6e4, size=k), dtype=torch.float32,
                            device=cuda_device)
    beta, cmax = costs.min(), costs.max()
    nrm = torch.stack([beta, 1.0 / ((cmax - beta) * 0.5)])
    for z in (None, torch.as_tensor(rng.standard_normal((tau, adim, k),
                                                        np.float32),
                                    device=cuda_device)):
        part_k = pm.mppi_weights(nrm, costs, tau, adim, seed=3, solve=4, z=z)
        part_p = pm.weights_plain(nrm, costs, tau, adim, seed=3, solve=4,
                                  z=z)
        torch.testing.assert_close(part_k, part_p, rtol=1e-4, atol=1e-4)
        zs_k, st_k = pm.pm_merge(part_k)
        zs_p, st_p = pm.merge_plain(part_p)
        torch.testing.assert_close(zs_k / st_k[1], zs_p / st_p[1],
                                   rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(st_k, st_p, rtol=1e-5, atol=0)


def test_pm_fused_costs_matches_plain(cuda_device):
    k, tau = 5000, 20
    fused = _fused(k, tau, cuda_device)
    rng = np.random.default_rng(8)
    z = torch.as_tensor(rng.standard_normal((tau, 3, k), np.float32),
                        device=cuda_device)
    dyn = fused.pack_dyn(torch.zeros(6, device=cuda_device),
                         torch.zeros(tau, 3, device=cuda_device))
    costs_k, rows_k = pm.pm_fused_costs(fused.consts, dyn, k, tau, z=z)
    costs_p, rows_p = pm.fused_costs_plain(fused.consts, dyn, k, tau, z=z)
    torch.testing.assert_close(costs_k, costs_p, rtol=1e-4, atol=1e-4)
    zs, st = pm.pm_merge(rows_k)
    assert zs.numel() == 0
    torch.testing.assert_close(st, pm.merge_plain(rows_p)[1], rtol=1e-4,
                               atol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_auv_prng_solve_consumes_dump(cuda_device, normalize):
    k, tau = 3000, 12
    fused = _auv_fused(k, tau, cuda_device)
    _, x0, useq, _ = _auv_inputs(fused, cuda_device)
    wn_a, st_a = fused.solve(x0, useq, seed=5, solve=9, normalize=normalize)
    z = pm.pm_noise_dump(5, 9, k, tau, 6, cuda_device)
    wn_b, st_b = fused.solve(x0, useq, z=z, normalize=normalize)
    torch.testing.assert_close(wn_a, wn_b, rtol=1e-6, atol=0)
    torch.testing.assert_close(st_a["cost_min"], st_b["cost_min"], rtol=1e-6,
                               atol=0)


def test_auv_wrappers_count_launches_and_check_inputs(cuda_device):
    fused = _auv_fused(700, 7, cuda_device)
    _, x0, useq, dyn = _auv_inputs(fused, cuda_device)
    before = dict(pm.launch_counts)
    fused.solve(x0, useq, seed=1, solve=2)
    fused.solve(x0, useq, seed=1, solve=2, normalize=True)
    torch.cuda.synchronize()
    delta = {n: pm.launch_counts[n] - before[n] for n in before}
    assert delta == {**{n: 0 for n in before}, "auv_fused_solve": 1,
                     "auv_fused_costs": 1, "mppi_weights": 1, "pm_merge": 3}
    c = fused.consts
    with pytest.raises(TypeError):
        auv.auv_fused_solve(c, dyn.double(), 700, 7)
    with pytest.raises(ValueError):
        auv.auv_fused_costs(c, dyn[:-1], 700, 7)
    with pytest.raises(ValueError):
        auv.auv_fused_solve(c, dyn, 700, 7,
                            z=torch.zeros(7, 6, 699, device=cuda_device))
    with pytest.raises(ValueError):
        pm.mppi_weights(torch.zeros(3, device=cuda_device),
                        torch.zeros(700, device=cuda_device), 7, 6)
    with pytest.raises(ValueError):
        pm.mppi_weights(torch.zeros(2, device=cuda_device),
                        torch.zeros(700), 7, 6)


def test_auv_normalized_closed_loop_on_the_kernel_path(cuda_device):
    """A short normalized dive through MPPI.next on the kernels: one launch
    each of auv_fused_costs and mppi_weights a step, two merges."""
    from mppi_tf_tpu_torch.envs import AUVEnv

    goal = np.zeros(13)
    goal[[2, 6]] = [-1.0, 1.0]
    sigma = np.diag([2000.0] * 3 + [200.0] * 3)
    model = get_model(flagship.auv_params(), dt=0.1, device=cuda_device)
    cost = get_cost({"type": "static_quat", "diag": True,
                     "goal": goal.tolist(),
                     "Q": [60.0, 60.0, 60.0, 10.0] + [1.0] * 6},
                    lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma,
                    device=cuda_device)
    ctrl = MPPI(model, cost, k=8192, tau=15, lam=0.5, upsilon=1.0,
                sigma=sigma, seed=3, normalize_cost=True, kernel="auto",
                device=cuda_device)
    assert ctrl.kernel_path == "cuda"
    env = AUVEnv(flagship.auv_params(), dt=0.02)
    x = env.reset()
    before = dict(pm.launch_counts)
    for _ in range(100):
        u = ctrl.next(x)
        for _ in range(5):
            x = env.step(u)
    delta = {n: pm.launch_counts[n] - before[n] for n in before}
    assert delta["auv_fused_costs"] == delta["mppi_weights"] == 100
    assert delta["pm_merge"] == 200 and delta["auv_fused_solve"] == 0
    assert abs(np.linalg.norm(x[3:7]) - 1.0) < 1e-3
    assert abs(x[2, 0] + 1.0) < 0.2, x.ravel()


# ---------------------------------------------------------------------------
# the learned-dynamics (NNAUVModel) kernels
# ---------------------------------------------------------------------------

NN_SIGMA = np.diag([50.0, 50.0, 50.0, 20.0, 20.0, 20.0])


def _nn_fused(k, tau, device, hidden):
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    model = NNAUVModel(hidden=hidden, seed=4, device=device)
    n_in, n_out = model.input_dim(), model.output_dim()
    model.set_normalization(0.1 * np.arange(n_in), 1.0 + 0.05 * np.arange(
        n_in), 0.01 * np.arange(n_out), 0.05 + 0.002 * np.arange(n_out))
    cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.2,
                    sigma=NN_SIGMA, device=device)
    return nnk.FusedNNMPPI(model, cost, k=k, tau=tau, lam=0.5, upsilon=1.2,
                           sigma=NN_SIGMA)


@pytest.mark.parametrize("hidden", [(8, 8), (32, 32, 32)])
@pytest.mark.parametrize("k,tau", [(700, 7), (4097, 25)])
def test_nn_kernels_match_plain(cuda_device, hidden, k, tau):
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk

    fused = _nn_fused(k, tau, cuda_device, hidden)
    z, _, _, dyn = _auv_inputs(fused, cuda_device, seed=len(hidden))
    c = fused.consts
    costs_k, rows_k = nnk.nn_fused_costs(c, dyn, k, tau, z=z)
    costs_p = nnk.sample_costs_plain(c, dyn, z)
    torch.testing.assert_close(costs_k, costs_p, rtol=COST_RTOL,
                               atol=COST_ATOL)
    _, st = pm.merge_plain(rows_k)
    torch.testing.assert_close(
        st[2:5], torch.stack([costs_k.min(), costs_k.max(), costs_k.sum()]),
        rtol=1e-5, atol=0)
    part_k = nnk.nn_fused_solve(c, dyn, k, tau, z=z)
    part_p = pm.block_partials(costs_k, z.reshape(tau * 6, k), c.lam)
    torch.testing.assert_close(part_k[:, :5], part_p[:, :5], rtol=1e-5,
                               atol=1e-6)
    zs_k, st_k = pm.merge_plain(part_k)
    zs_p, st_p = pm.merge_plain(part_p)
    torch.testing.assert_close(zs_k / st_k[1], zs_p / st_p[1], rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_nn_prng_solve_consumes_dump(cuda_device, normalize):
    k, tau = 3000, 12
    fused = _nn_fused(k, tau, cuda_device, (32, 32, 32))
    _, x0, useq, _ = _auv_inputs(fused, cuda_device)
    wn_a, st_a = fused.solve(x0, useq, seed=5, solve=9, normalize=normalize)
    z = pm.pm_noise_dump(5, 9, k, tau, 6, cuda_device)
    wn_b, st_b = fused.solve(x0, useq, z=z, normalize=normalize)
    torch.testing.assert_close(wn_a, wn_b, rtol=1e-6, atol=0)
    torch.testing.assert_close(st_a["cost_min"], st_b["cost_min"], rtol=1e-6,
                               atol=0)


def test_nn_controller_resolves_the_kernel(cuda_device):
    from mppi_tf_tpu_torch.kernels.errors import KernelUnsupportedError
    from mppi_tf_tpu_torch.kernels.nn_mppi import FusedNNMPPI
    from mppi_tf_tpu_torch.models.nn import NNAUVModel, NNAUVModelSpeed

    cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.0,
                    sigma=NN_SIGMA, device=cuda_device)
    kw = dict(k=1000, tau=6, lam=0.5, sigma=NN_SIGMA, device=cuda_device)
    ctrl = MPPI(NNAUVModel(), cost, kernel="cuda", **kw)
    assert ctrl.kernel_path == "cuda" and type(ctrl._fused) is FusedNNMPPI
    before = dict(pm.launch_counts)
    x = np.zeros(13)
    x[6] = 1.0
    assert np.all(np.isfinite(ctrl.next(x)))
    assert pm.launch_counts["nn_fused_solve"] == before["nn_fused_solve"] + 1
    assert MPPI(NNAUVModel(), cost, kernel="auto", **kw).kernel_path == \
        "torch"
    with pytest.raises(KernelUnsupportedError):
        MPPI(NNAUVModelSpeed(), cost, kernel="cuda", **kw)
    with pytest.raises(KernelUnsupportedError):
        MPPI(NNAUVModel(hidden=(16, 16, 16)), cost, kernel="cuda", **kw)
    ctrl = MPPI(NNAUVModel(), cost, kernel="cuda", antithetic=True,
                noise_schedule={"type": "exp", "start": 1.0, "end": 0.25},
                **kw)
    assert ctrl.kernel_path == "cuda" and ctrl._fused.consts.antithetic


# ---------------------------------------------------------------------------
# the tracking costs: point-mass waypoints and ellipse, AUV waypoints_quat
# and elipse3d
# ---------------------------------------------------------------------------

PM_WAYPOINTS = {"type": "waypoints", "diag": True,
                "Q": [6.0, 0.6, 6.0, 0.6, 6.0, 0.6], "alpha": 0.2,
                "waypoints": [[0.8, 0, 0, 0, 0, 0], [0.8, 0, -0.7, 0, 0, 0],
                              [0.0, 0, -0.7, 0, 0.4, 0]]}
PM_ELIPSE = {"type": "elipse", "a": 4.0, "b": 2.0, "center_x": 0.0,
             "center_y": 0.0, "speed": 5.0, "m_state": 1.0, "m_vel": 0.1}


def _auv_tracking_task(kind):
    if kind == "elipse3d":
        return {"type": "elipse3d", "normal": [0.0, 0.0, 1.0],
                "aVec": [1.0, 0.0, 0.0], "axis": [4.0, 2.0],
                "center": [0.0, 0.0, -3.0], "speed": 0.5, "m_state": 1.0,
                "m_vel": 0.1}
    w0, w1 = np.zeros(13), np.zeros(13)
    w0[2], w0[6] = -1.0, 1.0
    w1[0], w1[2] = 1.0, -2.0
    w1[3], w1[6] = np.sin(0.3), np.cos(0.3)
    return {"type": "waypoints_quat", "diag": True,
            "Q": [60.0, 60.0, 60.0, 10.0] + [1.0] * 6, "alpha": 0.3,
            "waypoints": [w0.tolist(), w1.tolist()]}


@pytest.mark.parametrize("kind", ["waypoints", "elipse"])
@pytest.mark.parametrize("k,tau", [(700, 7), (5000, 20)])
def test_pm_tracking_kernels_match_plain(cuda_device, kind, k, tau):
    sdim, task = (6, PM_WAYPOINTS) if kind == "waypoints" else (4, PM_ELIPSE)
    adim = sdim // 2
    model = get_model({"type": "point_mass"}, dt=0.1, state_dim=sdim,
                      action_dim=adim, device=cuda_device)
    sigma = SIGMA[:adim, :adim]
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=sigma,
                    device=cuda_device)
    fused = pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                  upsilon=UPS, sigma=sigma)
    rng = np.random.default_rng(9)
    z = torch.as_tensor(rng.standard_normal((tau, adim, k), np.float32),
                        device=cuda_device)
    x0 = torch.as_tensor(rng.normal(size=sdim) * 0.5 + ([3.0, 1.0, 0.5, 1.0]
                         if kind == "elipse" else 0.0), dtype=torch.float32,
                         device=cuda_device)
    useq = torch.as_tensor(rng.normal(size=(tau, adim)) * 0.1,
                           dtype=torch.float32, device=cuda_device)
    for _ in range(2):            # then after a pop (waypoints)
        dyn = fused.pack_dyn(x0, useq)
        costs_k, rows = pm.pm_fused_costs(fused.consts, dyn, k, tau, z=z)
        costs_p = pm.sample_costs_plain(fused.consts, dyn, z)
        torch.testing.assert_close(costs_k, costs_p, rtol=1e-4, atol=1e-4)
        part_k = pm.pm_fused_solve(fused.consts, dyn, k, tau, z=z)
        part_p = pm.block_partials(costs_k, z.reshape(tau * adim, k), LAM)
        torch.testing.assert_close(part_k[:, :5], part_p[:, :5], rtol=1e-5,
                                   atol=1e-6)
        wn_k, st_k = fused.solve(x0, useq, z=z)
        wn_p, st_p = pm.merge_plain(pm.fused_solve_plain(
            fused.consts, dyn, k, tau, z=z))
        off = fused._cost_offset()
        off = 0.0 if off is None else off
        torch.testing.assert_close(st_k["cost_min"], st_p[2] + off,
                                   rtol=1e-4, atol=0)
        torch.testing.assert_close(st_k["cost_mean"], st_p[4] / k + off,
                                   rtol=1e-4, atol=0)
        if kind == "waypoints":
            cost.pop()


@pytest.mark.parametrize("kind", ["waypoints_quat", "elipse3d"])
@pytest.mark.parametrize("rk", [1, 2, 4])
def test_auv_tracking_kernels_match_plain(cuda_device, kind, rk):
    k, tau = 4096, 25
    model = get_model({**flagship.auv_params(), "rk": rk}, dt=0.1,
                      device=cuda_device)
    cost = get_cost(_auv_tracking_task(kind), lam=0.5, gamma=0.2,
                    upsilon=1.2, sigma=AUV_SIGMA, device=cuda_device)
    fused = auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=0.5, upsilon=1.2,
                             sigma=AUV_SIGMA)
    z, x0, useq, dyn = _auv_inputs(fused, cuda_device, seed=rk)
    if kind == "elipse3d":
        # start on the ellipse: near the plane normal through its center
        # the tangent's direction, and so the orientation error, turns on
        # the last bits of the position
        x0[[0, 2]] = torch.tensor([4.0, -3.0], device=cuda_device)
        with torch.no_grad():
            dyn = fused.pack_dyn(x0, useq)
    c = fused.consts
    for _ in range(2):            # then after a pop (waypoints_quat)
        costs_k, rows_k = auv.auv_fused_costs(c, dyn, k, tau, z=z)
        costs_p = auv.sample_costs_plain(c, dyn, z)
        torch.testing.assert_close(costs_k, costs_p, rtol=COST_RTOL,
                                   atol=COST_ATOL)
        part_k = auv.auv_fused_solve(c, dyn, k, tau, z=z)
        part_p = pm.block_partials(costs_k, z.reshape(tau * 6, k), c.lam)
        torch.testing.assert_close(part_k[:, :5], part_p[:, :5], rtol=1e-5,
                                   atol=1e-6)
        if kind == "elipse3d":
            break
        cost.pop()
        _, _, _, dyn = _auv_inputs(fused, cuda_device, seed=rk)


def test_auv_dyn_size_is_the_kernels(cuda_device):
    for tau in (1, 7, 25, 50):
        assert auv.kernel_dyn_size(tau) == auv.Dyn(tau).size


@pytest.mark.parametrize("kind", ["waypoints", "elipse", "waypoints_quat",
                                  "elipse3d"])
def test_tracking_costs_resolve_the_kernels(cuda_device, kind):
    """kernel='cuda' runs each tracking cost on its kernel; an ellipse on
    a 6-dim point mass raises under 'cuda' and stays plain under 'auto'."""
    from mppi_tf_tpu_torch.kernels.errors import KernelUnsupportedError

    if kind in ("waypoints", "elipse"):
        sdim = 6 if kind == "waypoints" else 4
        task = PM_WAYPOINTS if kind == "waypoints" else PM_ELIPSE
        model = get_model({"type": "point_mass"}, dt=0.1, state_dim=sdim,
                          action_dim=sdim // 2, device=cuda_device)
        sigma = SIGMA[:sdim // 2, :sdim // 2]
        x, want = np.zeros(sdim), "pm_fused_solve"
    else:
        model = get_model(flagship.auv_params(), dt=0.1, device=cuda_device)
        task, sigma = _auv_tracking_task(kind), AUV_SIGMA
        x, want = np.zeros(13), "auv_fused_solve"
        x[6] = 1.0
    cost = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma,
                    device=cuda_device)
    ctrl = MPPI(model, cost, k=1000, tau=6, lam=0.5, sigma=sigma,
                kernel="cuda", device=cuda_device)
    assert ctrl.kernel_path == "cuda"
    before = pm.launch_counts[want]
    assert np.all(np.isfinite(ctrl.next(x)))
    assert pm.launch_counts[want] == before + 1
    if kind == "elipse":
        six = get_model({"type": "point_mass"}, dt=0.1, state_dim=6,
                        action_dim=3, device=cuda_device)
        with pytest.raises(KernelUnsupportedError):
            MPPI(six, cost, k=100, tau=4, sigma=SIGMA, kernel="cuda",
                 device=cuda_device)
        assert MPPI(six, cost, k=100, tau=4, sigma=SIGMA, kernel="auto",
                    device=cuda_device).kernel_path == "torch"


def test_pm_mission_flies_on_the_kernels(cuda_device):
    """A 3-leg point-mass mission through MPPI.next on the kernels: two
    pops, then the last leg."""
    model = get_model({"type": "point_mass"}, dt=0.1, state_dim=6,
                      action_dim=3, device=cuda_device)
    sigma = np.diag([0.25] * 3)
    cost = get_cost(PM_WAYPOINTS, lam=0.8, gamma=0.2, upsilon=1.0,
                    sigma=sigma, device=cuda_device)
    ctrl = MPPI(model, cost, k=8192, tau=30, lam=0.8, sigma=sigma,
                kernel="auto", device=cuda_device)
    assert ctrl.kernel_path == "cuda"
    from mppi_tf_tpu_torch.envs import PointMassEnv

    env = PointMassEnv(n_dof=3, dt=0.1)
    x = env.reset()
    pops = 0
    for _ in range(200):
        x = env.step(ctrl.next(x))
        pops += ctrl.advance_waypoints(x, 0.3)
    assert pops == 2
    assert np.linalg.norm(x.ravel() - np.asarray(
        PM_WAYPOINTS["waypoints"][2])) < 0.25


# ---------------------------------------------------------------------------
# the scheduled and antithetic variants
# ---------------------------------------------------------------------------

SCHED = {"type": "exp", "start": 1.0, "end": 0.25}


@pytest.mark.parametrize("k", [5000, 5001])
def test_antithetic_dump_mirrors_exactly(cuda_device, k):
    half = pm.antithetic_half(k)
    z = pm.pm_noise_dump(3, 2, k, 9, 3, cuda_device, half=half)
    assert torch.equal(z[..., half:], -z[..., :k - half])
    torch.testing.assert_close(
        z, pm.noise_plain(3, 2, k, 9, 3, device=cuda_device, half=half),
        rtol=0, atol=1e-5)
    # the first samples of a larger antithetic solve: its own half
    head = pm.pm_noise_dump(3, 2, 512, 9, 3, cuda_device, half=half)
    assert torch.equal(head, z[..., :512])


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("k,tau", [(701, 7), (4096, 25)])
def test_pm_variants_match_plain(cuda_device, k, tau, scheduled, antithetic):
    model, cost = _modules(cuda_device)
    fused = pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                  upsilon=UPS, sigma=SIGMA,
                                  antithetic=antithetic,
                                  schedule=SCHED if scheduled else None)
    rng = np.random.default_rng(k)
    x0 = torch.as_tensor(rng.normal(size=6) * 0.2, dtype=torch.float32,
                         device=cuda_device)
    useq = torch.as_tensor(rng.normal(size=(tau, 3)) * 0.1,
                           dtype=torch.float32, device=cuda_device)
    dyn = fused.pack_dyn(x0, useq)
    c = fused.consts
    costs_k, _ = pm.pm_fused_costs(c, dyn, k, tau, seed=4, solve=3)
    costs_p, _ = pm.fused_costs_plain(c, dyn, k, tau, seed=4, solve=3)
    torch.testing.assert_close(costs_k, costs_p, rtol=1e-4, atol=1e-4)
    zs_k, st_k = pm.merge_plain(pm.pm_fused_solve(c, dyn, k, tau, seed=4,
                                                  solve=3))
    zs_p, st_p = pm.merge_plain(pm.fused_solve_plain(c, dyn, k, tau, seed=4,
                                                     solve=3))
    torch.testing.assert_close(zs_k / st_k[1], zs_p / st_p[1], rtol=1e-3,
                               atol=1e-5)
    wn_k, _ = fused.solve(x0, useq, seed=4, solve=3, normalize=True)
    nrm = torch.stack([costs_k.min(), 1.0 / ((costs_k.max() - costs_k.min())
                                             * LAM)])
    zs_w, st_w = pm.merge_plain(pm.weights_plain(
        nrm, costs_k, tau, 3, seed=4, solve=3, antithetic=antithetic))
    torch.testing.assert_close(wn_k, fused.unfold_wnoise(zs_w) / st_w[1],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("rk", [1, 2, 4])
def test_auv_variants_match_plain(cuda_device, rk):
    k, tau = 1001, 9
    model = get_model({**flagship.auv_params(), "rk": rk}, dt=0.1,
                      device=cuda_device)
    cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.2,
                    sigma=AUV_SIGMA, device=cuda_device)
    fused = auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=0.5, upsilon=1.2,
                             sigma=AUV_SIGMA, antithetic=True,
                             schedule=SCHED)
    _, x0, useq, dyn = _auv_inputs(fused, cuda_device, seed=rk)
    c = fused.consts
    costs_k, _ = auv.auv_fused_costs(c, dyn, k, tau, seed=2, solve=1)
    costs_p, _ = auv.fused_costs_plain(c, dyn, k, tau, seed=2, solve=1)
    torch.testing.assert_close(costs_k, costs_p, rtol=COST_RTOL,
                               atol=COST_ATOL)
    part_k = auv.auv_fused_solve(c, dyn, k, tau, seed=2, solve=1)
    z = pm.pm_noise_dump(2, 1, k, tau, 6, cuda_device,
                         half=pm.antithetic_half(k))
    part_o = pm.block_partials(costs_k, z.reshape(tau * 6, k), c.lam)
    torch.testing.assert_close(part_k[:, :5], part_o[:, :5], rtol=1e-5,
                               atol=1e-6)


def test_nn_variants_match_plain(cuda_device):
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk

    k, tau = 1001, 9
    base = _nn_fused(k, tau, cuda_device, (32, 32, 32))
    fused = nnk.FusedNNMPPI(base.model, base.cost, k=k, tau=tau, lam=0.5,
                            upsilon=1.2, sigma=NN_SIGMA, antithetic=True,
                            schedule=SCHED)
    _, x0, useq, dyn = _auv_inputs(fused, cuda_device, seed=5)
    c = fused.consts
    costs_k, _ = nnk.nn_fused_costs(c, dyn, k, tau, seed=2, solve=1)
    costs_p, _ = nnk.fused_costs_plain(c, dyn, k, tau, seed=2, solve=1)
    torch.testing.assert_close(costs_k, costs_p, rtol=COST_RTOL,
                               atol=COST_ATOL)
    part_k = nnk.nn_fused_solve(c, dyn, k, tau, seed=2, solve=1)
    z = pm.pm_noise_dump(2, 1, k, tau, 6, cuda_device,
                         half=pm.antithetic_half(k))
    part_o = pm.block_partials(costs_k, z.reshape(tau * 6, k), c.lam)
    torch.testing.assert_close(part_k[:, :5], part_o[:, :5], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("model_kind", ["point_mass", "auv1", "auv2",
                                        "auv4", "nn"])
def test_variants_resolve_the_kernels(cuda_device, model_kind):
    """MPPI(kernel='cuda'|'auto', antithetic=True, noise_schedule=...)
    runs on the kernels (NN under 'cuda' only) and steps finitely."""
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    if model_kind == "point_mass":
        model, cost = _modules(cuda_device)
        sigma, x = SIGMA, np.zeros(6)
    else:
        model = (NNAUVModel(device=cuda_device) if model_kind == "nn" else
                 get_model({**flagship.auv_params(), "rk": int(
                     model_kind[-1])}, dt=0.1, device=cuda_device))
        cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.0,
                        sigma=AUV_SIGMA, device=cuda_device)
        sigma, x = AUV_SIGMA, np.zeros(13)
        x[6] = 1.0
    for kernel in ("cuda", "auto"):
        ctrl = MPPI(model, cost, k=1000, tau=6, lam=0.5, sigma=sigma,
                    kernel=kernel, antithetic=True, noise_schedule=SCHED,
                    device=cuda_device)
        want = "torch" if (model_kind, kernel) == ("nn", "auto") else "cuda"
        assert ctrl.kernel_path == want
        assert np.all(np.isfinite(ctrl.next(x)))
        ctrl.set_noise_schedule({"type": "linear", "start": 1.0, "end": 0.5})
        assert np.all(np.isfinite(ctrl.next(x)))


# ---------------------------------------------------------------------------
# the dynamic_ab variant (FusedLTIMPPI, the DMD family)
# ---------------------------------------------------------------------------

def _lti(k, tau, device, dims=(6, 3), elipse=False, seed=5):
    """FusedLTIMPPI over a dense random (A, B) DMD model (the JAX
    package's _setup_lti), with the static or the 2D ellipse cost."""
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    sdim, adim = dims
    rng = np.random.RandomState(seed)
    model = DMDModel(sdim, adim, init_A=np.eye(sdim) + 0.05 * rng.randn(
        sdim, sdim), init_B=0.1 * rng.randn(sdim, adim), device=device)
    task = PM_ELIPSE if elipse else (TASK if sdim == 6 else {
        "type": "static", "goal": [0.5] * sdim, "Q": [1.0] * sdim,
        "diag": True})
    sigma = SIGMA[:adim, :adim]
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=sigma,
                    device=device)
    return pm.FusedLTIMPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                           sigma=sigma), model


@pytest.mark.parametrize("dims,elipse", [((6, 3), False), ((4, 2), False),
                                         ((4, 2), True)])
def test_lti_kernels_match_plain(cuda_device, dims, elipse):
    """pm_fused_solve and pm_fused_costs with dynamic (A, B) against their
    plain versions on injected z and on the Philox stream, before and
    after new (A, B) are written into the model."""
    from mppi_tf_tpu_torch.interop import from_jax_params

    k, tau = 4097, 20
    fused, model = _lti(k, tau, cuda_device, dims, elipse)
    sdim, adim = dims
    rng = np.random.default_rng(8)
    z = torch.as_tensor(rng.standard_normal((tau, adim, k), np.float32),
                        device=cuda_device)
    x0 = torch.as_tensor(rng.normal(size=sdim) * 0.3 + (
        [3.0, 1.0, 0.5, 1.0] if elipse else 0.0), dtype=torch.float32,
        device=cuda_device)
    useq = torch.as_tensor(rng.normal(size=(tau, adim)) * 0.1,
                           dtype=torch.float32, device=cuda_device)
    c = fused.consts
    for refit in (False, True):
        if refit:
            from_jax_params({"A": np.eye(sdim) + 0.02 * rng.normal(
                size=(sdim, sdim)), "B": 0.15 * rng.normal(
                size=(sdim, adim))}, None, model)
        dyn = fused.pack_dyn(x0, useq)
        for kw in ({"z": z}, {"seed": 4, "solve": 3}):
            costs_k, _ = pm.pm_fused_costs(c, dyn, k, tau, **kw)
            costs_p, _ = pm.fused_costs_plain(c, dyn, k, tau, **kw)
            torch.testing.assert_close(costs_k, costs_p, rtol=1e-4,
                                       atol=1e-4)
            zs_k, st_k = pm.merge_plain(pm.pm_fused_solve(c, dyn, k, tau,
                                                          **kw))
            zs_p, st_p = pm.merge_plain(pm.fused_solve_plain(c, dyn, k, tau,
                                                             **kw))
            torch.testing.assert_close(zs_k / st_k[1], zs_p / st_p[1],
                                       rtol=1e-3, atol=1e-5)
            torch.testing.assert_close(st_k[2:5], st_p[2:5], rtol=1e-4,
                                       atol=0)


def test_lti_refit_builds_nothing_and_launches_the_same_symbol(
        cuda_device):
    """DMDMPPI(kernel='auto') resolves to FusedLTIMPPI; a refit changes the
    next solve's result, loads no new library and launches the same kDynAB
    instantiation (dump_hlo names it)."""
    from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
    from mppi_tf_tpu_torch.kernels import _launch
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    pmod = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                     state_dim=6, action_dim=3)
    model = DMDModel(6, 3, init_A=pmod.A.numpy(), init_B=pmod.B.numpy(),
                     reg=1e-8)
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=1.0,
                    sigma=SIGMA, device=cuda_device)
    ctrl = DMDMPPI(model, cost, k=4096, tau=20, lam=LAM, sigma=SIGMA,
                   kernel="auto", refit_every=5, device=cuda_device)
    assert ctrl.kernel_path == "cuda"
    assert type(ctrl._fused) is pm.FusedLTIMPPI
    sym = _launch.kernel_symbol("pm_fused_solve",
                                ctrl._fused.template_args("pm_fused_solve"))
    assert sym == "pm_fused_solve_kernelILi6ELi3ELi0ELi0ELi1E"
    hlo = ctrl.dump_hlo()
    assert f"pm_fused_solve x1: {sym}" in hlo and "registers" in hlo
    lib = _build.load_library()
    x = np.full(6, 0.1)
    state = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    wn0, _ = ctrl._fused.solve(state, ctrl.useq, seed=1, solve=1)
    A, B = pmod.A.numpy(), pmod.B.numpy() / 3.0
    rng = np.random.default_rng(0)
    xs = np.zeros(6)
    before = pm.launch_counts["pm_fused_solve"]
    for _ in range(20):
        u = rng.uniform(-1.0, 1.0, 3)
        ctrl.save(xs, u, A @ xs + B @ u)
        xs = A @ xs + B @ u
    assert ctrl.n_fits >= 1
    wn1, _ = ctrl._fused.solve(state, ctrl.useq, seed=1, solve=1)
    torch.cuda.synchronize()
    assert pm.launch_counts["pm_fused_solve"] == before + 1
    assert _build.load_library() is lib
    assert (wn1 - wn0).abs().max().item() > 1e-4
    torch.testing.assert_close(ctrl.model_params["B"].cpu(),
                               torch.as_tensor(B, dtype=torch.float32),
                               rtol=0, atol=1e-4)
    assert f"pm_fused_solve x1: {sym}" in ctrl.dump_hlo()
    assert np.all(np.isfinite(ctrl.next(x)))
