"""The port's CUDA kernels on the card, each against its plain version,
and the controller's kernel path. Every test here needs a GPU and skips
without one.

This file imports neither JAX nor the JAX package, so that it runs on a
machine without JAX:  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

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
                   "pm_merge_stats_kernel",
                   "pm_noise_dump_kernel", "mppi_weights_kernel",
                   "auv_fused_solve_kernel"):
        assert kernel in names
    # RK 1, 2, 4 x (fused, costs) x (static_quat, waypoints_quat, elipse3d)
    # x (dense, diagonal constants)
    assert sum("auv_fused_solve_kernel" in r["kernel"] for r in rows) == 36
    # (fused, costs) x (three quadratic dims + the (4, 2) ellipse) x
    # (integrator, dense, dense with dynamic (A, B))
    assert sum("pm_fused_solve_kernel" in r["kernel"] for r in rows) == 24
    assert not [r for r in rows if r.get("spill_stores")
                or r.get("spill_loads")]


@pytest.mark.parametrize("sfx,lanes", [("", 1), ("_bf16", 2)])
def test_pm_occupancy_entry_point(cuda_device, sfx, lanes):
    """pm_occupancy reports the samples a thread of its build and at least
    one block an SM for every point-mass solve instantiation (the f32
    build in both structures, the integrator with constant (A, B) alone;
    the bf16 build dense alone), three for every f32 one (the 391 blocks
    of K=100,000 in one wave), and refuses dims the kernel is not built
    for and the structures it does not hold."""
    import ctypes

    fn = getattr(_build.load_library(), f"pm_occupancy{sfx}")
    combos = ((0, 0), (0, 1), (1, 0)) if sfx == "" else ((0, 0), (0, 1))
    for sdim, adim, cost in ((6, 3, 0), (2, 1, 0), (4, 2, 0), (4, 2, 1)):
        for mode in (0, 1):
            for st, dyn_ab in combos:
                out = (ctypes.c_int * 2)()
                assert fn(sdim, adim, cost, st, mode, dyn_ab, 50, out) == 0
                assert out[1] == lanes and out[0] >= (3 if sfx == "" else 1)
    out = (ctypes.c_int * 2)()
    assert fn(5, 3, 0, 0, 0, 0, 50, out) != 0
    assert fn(6, 3, 0, 1, 0, 1, 50, out) != 0      # integrator, dynamic_ab
    if sfx:
        assert fn(6, 3, 0, 1, 0, 0, 50, out) != 0  # integrator at bf16


@pytest.mark.parametrize("k,tau,adim", [(700, 7, 3), (5000, 20, 3),
                                        (700, 7, 6)])
def test_noise_dump_matches_plain(cuda_device, k, tau, adim):
    z = pm.pm_noise_dump(123, 7, k, tau, adim, cuda_device)
    ref = pm.noise_plain(123, 7, k, tau, adim, device=cuda_device)
    torch.testing.assert_close(z, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,k_short,tau,adim", [(4097, 4096, 7, 3),
                                                (100_000, 512, 50, 3),
                                                (701, 3, 7, 6)])
def test_noise_dump_prefix_equals_narrower_dump(cuda_device, k, k_short,
                                                tau, adim):
    """The first k_short columns of a dump of k are the dump of k_short, bit
    for bit: rows of k = 4,097 start off the 16-byte grid (the shifted
    vector stores and their head and tail), those of 4,096 on it."""
    wide = pm.pm_noise_dump(31, 4, k, tau, adim, cuda_device)
    assert torch.equal(wide[..., :k_short], pm.pm_noise_dump(
        31, 4, k_short, tau, adim, cuda_device))


@pytest.mark.parametrize("k,half,adim", [(4097, 2049, 6), (701, 351, 3),
                                         (5, 3, 3), (100_000, 50_000, 3)])
def test_noise_dump_mirrored_columns_are_exact_negatives(cuda_device, k,
                                                         half, adim):
    """From an odd (or even) ``half`` on each column is the exact negative
    of column k - half, and the columns before it are the plain dump's."""
    z = pm.pm_noise_dump(5, 8, k, 7, adim, cuda_device, half=half)
    plain = pm.pm_noise_dump(5, 8, k, 7, adim, cuda_device)
    assert torch.equal(z[..., :half], plain[..., :half])
    assert torch.equal(z[..., half:], -plain[..., :k - half])


@pytest.mark.parametrize("k,tau,adim", [(700, 7, 3), (4097, 5, 1),
                                        (513, 3, 2), (3, 1, 6)])
def test_noise_dump_ragged_philox_block(cuda_device, k, tau, adim):
    """n_z = tau adim not a multiple of 4: the rows are the first n_z rows of
    a dump whose n_z is the next multiple of 4, and equal the plain
    version's within its 1e-5."""
    n_z = tau * adim
    z = pm.pm_noise_dump(2, 11, k, tau, adim, cuda_device)
    full = pm.pm_noise_dump(2, 11, k, -(-n_z // 4) * 4, 1, cuda_device)
    assert torch.equal(z.reshape(n_z, k), full.reshape(-1, k)[:n_z])
    torch.testing.assert_close(z, pm.noise_plain(
        2, 11, k, tau, adim, device=cuda_device), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,tau,adim,half", [(100_000, 50, 3, 0),
                                             (4097, 7, 6, 2049),
                                             (512, 50, 3, 0)])
def test_noise_dump_bf16_is_the_f32_dump_rounded(cuda_device, k, tau, adim,
                                                 half):
    """The bf16 build's dump is round_bf16 of the f32 build's, bit for bit,
    held in f32."""
    f32 = pm.pm_noise_dump(7, 3, k, tau, adim, cuda_device, half=half)
    bf = pm.pm_noise_dump(7, 3, k, tau, adim, cuda_device, half=half,
                          compute_dtype="bfloat16")
    assert bf.dtype == torch.float32
    assert torch.equal(bf, pm.round_bf16(f32))


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


def _pm_case(k, tau, device, sdim, adim, elipse, dense, **opts):
    """A point-mass solve object at (sdim, adim) under the static cost or
    the ellipse; with ``dense`` sigma and Q get off-diagonal terms (as
    tests/test_torch_pm_kernel.py DENSE_SIGMA, DENSE_TASK), so that it
    runs the dense kernels."""
    sigma = SIGMA[:adim, :adim] + (0.01 * (1.0 - np.eye(adim)) if dense
                                   else 0.0)
    if elipse:
        task = PM_ELIPSE
    else:
        q = np.diag([5.0, 1.0] * adim) + (0.1 * (1.0 - np.eye(sdim))
                                           if dense else 0.0)
        task = {"type": "static", "diag": False, "goal": [0.5] * sdim,
                "Q": q.tolist()}
    model = get_model({"type": "point_mass", "mass": 1.3}, dt=0.1,
                      state_dim=sdim, action_dim=adim, device=device)
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=sigma,
                    device=device)
    fused = pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                  upsilon=UPS, sigma=sigma, **opts)
    # the ellipse reads no Q: a full sigma makes it dense
    assert fused.consts.structure == ("dense" if dense else "integrator")
    return fused


@pytest.mark.parametrize("structure", ["integrator", "dense"])
@pytest.mark.parametrize("dims,elipse", [((6, 3), False), ((2, 1), False),
                                         ((4, 2), False), ((4, 2), True)])
@pytest.mark.parametrize("k,tau", [(701, 7), (4096, 9)])
def test_pm_structures_match_plain(cuda_device, dims, elipse, structure, k,
                                   tau):
    """Both structures of the f32 solve and costs against their plain
    versions at every (S, A) and cost kind, on injected z and on the
    Philox stream, scheduled + antithetic too: H = 7 and 9 leave a tail of
    steps past the last whole noise group at every adim (groups of 4, 2,
    4 steps at adim 3, 2, 1), K = 701 a ragged block."""
    sdim, adim = dims
    rng = np.random.default_rng(k + sdim)
    x0 = torch.as_tensor(rng.normal(size=sdim) * 0.3 + (
        [3.0, 1.0, 0.5, 1.0] if elipse else 0.0), dtype=torch.float32,
        device=cuda_device)
    useq = torch.as_tensor(rng.normal(size=(tau, adim)) * 0.1,
                           dtype=torch.float32, device=cuda_device)
    z = torch.as_tensor(rng.standard_normal((tau, adim, k), np.float32),
                        device=cuda_device)
    for opts in ({}, {"schedule": SCHED, "antithetic": True}):
        fused = _pm_case(k, tau, cuda_device, sdim, adim, elipse,
                         structure == "dense", **opts)
        c = fused.consts
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


def test_pm_structure_picks_the_instantiation(cuda_device):
    """The diagonal task launches the integrator instantiation and the
    dense-constant point mass the dense one (the ptxas report names the
    template arguments ``template_args`` gives), and the two give the
    same per-sample costs bit for bit on the same map: the dense chains'
    zeros add +-0 and their ones multiply exactly."""
    from mppi_tf_tpu_torch.kernels import _launch

    names = " ".join(r["kernel"] for r in _build.ptxas_report())
    k, tau = 4097, 9
    rng = np.random.default_rng(2)
    z = torch.as_tensor(rng.standard_normal((tau, 3, k), np.float32),
                        device=cuda_device)
    x0 = torch.as_tensor(rng.normal(size=6) * 0.3, dtype=torch.float32,
                         device=cuda_device)
    useq = torch.as_tensor(rng.normal(size=(tau, 3)) * 0.1,
                           dtype=torch.float32, device=cuda_device)
    costs = {}
    for structure in ("integrator", "dense"):
        fused = _pm_case(k, tau, cuda_device, 6, 3, False,
                         structure == "dense")
        args = fused.template_args("pm_fused_costs")
        assert args == (6, 3, 1, 0, 0, pm.STRUCTURES[structure])
        assert _launch.kernel_symbol("pm_fused_costs", args) in names
        before = pm.launch_counts["pm_fused_costs"]
        costs[structure], _ = pm.pm_fused_costs(fused.consts,
                                                fused.pack_dyn(x0, useq), k,
                                                tau, z=z)
        assert pm.launch_counts["pm_fused_costs"] == before + 1
    # the same constants run through the dense body: equal bits
    integ = _pm_case(k, tau, cuda_device, 6, 3, False, False)
    forced = dataclasses.replace(integ.consts)
    forced.__dict__["structure"] = "dense"
    dyn = integ.pack_dyn(x0, useq)
    a, _ = pm.pm_fused_costs(integ.consts, dyn, k, tau, z=z)
    b, _ = pm.pm_fused_costs(forced, dyn, k, tau, z=z)
    assert torch.equal(a, b)


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
    ({"kernel_dtype": "bfloat16"}, None)])
def test_cuda_path_unported_options(cuda_device, opt, item):
    """normalize_cost, log, antithetic, the noise schedule and bf16 blocks
    run on the kernel path."""
    assert item is None
    model, cost = _modules(cuda_device)
    ctrl = MPPI(model, cost, k=300, tau=8, sigma=SIGMA, kernel="cuda",
                device=cuda_device, **opt)
    assert ctrl.kernel_path == "cuda"
    assert ctrl._fused.compute_dtype == opt.get("kernel_dtype", "float32")
    state = torch.zeros(6, device=cuda_device)
    _, _, info = ctrl._fused_step(state, ctrl.useq)
    if opt.get("log"):
        assert info["sample_costs"].shape == (300,)
        assert info["noise"].shape == (300, 8, 3)
    assert np.all(np.isfinite(ctrl.next(np.zeros(6))))


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


def _dense_constants(params, sigma, task):
    """The vehicle of tests/test_torch_auv_kernel.py's dense case, whose
    solves run the kDense kernels: 6x6 linear damping (the diagonal plus
    off-diagonal terms), 6x6 forward-speed damping, a nonzero cog, sigma
    and a quaternion task's Q with off-diagonal terms."""
    rng = np.random.RandomState(7)
    params = {**params, "cog": [0.01, -0.02, 0.05],
              "linear_damping": (np.diag(params["linear_damping"])
                                 + 5.0 * rng.randn(6, 6)).tolist(),
              "linear_damping_forward_speed": (20.0 * rng.randn(6, 6)
                                               ).tolist()}
    sigma = sigma + 0.5 * (np.ones((6, 6)) - np.eye(6))
    if task["type"] != "elipse3d":
        task = {**task, "diag": False, "Q": (np.diag(task["Q"]) + 0.2 * (
            np.ones((10, 10)) - np.eye(10))).tolist()}
    return params, sigma, task


def _auv_fused(k, tau, device, rk=2, sigma=AUV_SIGMA, structure="diagonal",
               task=None):
    params, task = flagship.auv_params(), task or flagship.auv_task()
    if structure == "dense":
        params, sigma, task = _dense_constants(params, sigma, task)
    model = get_model({**params, "rk": rk}, dt=0.1, device=device)
    cost = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.2, sigma=sigma,
                    device=device)
    fused = auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=0.5, upsilon=1.2,
                             sigma=sigma)
    assert fused.consts.structure == structure
    return fused


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


@pytest.mark.parametrize("structure", ["diagonal", "dense"])
@pytest.mark.parametrize("rk", [1, 2, 4])
@pytest.mark.parametrize("k,tau", [(700, 7), (4096, 25)])
def test_auv_kernels_match_plain(cuda_device, rk, k, tau, structure):
    fused = _auv_fused(k, tau, cuda_device, rk, structure=structure)
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


#: the flagship shapes of phase B (k, tau, adim): the NN and AUV dives,
#: the point mass at H=50 and H=100
WEIGHT_SHAPES = [(65_536, 25, 6), (100_000, 50, 3), (100_000, 100, 3),
                 (262_144, 25, 6)]


@pytest.mark.parametrize("k,tau,adim", WEIGHT_SHAPES)
def test_mppi_weights_rule_matches_plain(cuda_device, k, tau, adim):
    """Phase B at each flagship shape, at the groups the host rule picks
    (mppi_weights_occupancy: 1 to the shape's 16-normal chunks), on the
    antithetic Philox stream against weights_plain: the f32 rows within
    the plain version's tolerance, the bf16 build's merged weighted noise
    within the f32 tolerance of the plain bf16 version's."""
    import ctypes

    rng = np.random.default_rng(k + tau)
    costs = torch.as_tensor(rng.uniform(1e3, 6e4, size=k),
                            dtype=torch.float32, device=cuda_device)
    nrm = torch.stack([costs.min(), 1.0 / ((costs.max() - costs.min())
                                           * 0.5)])
    out = (ctypes.c_int * 2)()
    assert _build.load_library().mppi_weights_occupancy(tau * adim, out) == 0
    chunks = -(-(-(-(tau * adim) // 4)) // 4)
    assert out[0] >= 1 and 1 <= out[1] <= chunks
    kw = {"seed": 3, "solve": 4, "antithetic": True}
    rows = pm.mppi_weights(nrm, costs, tau, adim, **kw)
    plain = pm.weights_plain(nrm, costs, tau, adim, **kw)
    torch.testing.assert_close(rows, plain, rtol=1e-4, atol=1e-4)
    rows = pm.mppi_weights(nrm, costs, tau, adim, compute_dtype="bfloat16",
                           **kw)
    plain = pm.weights_plain(nrm, costs, tau, adim, compute_dtype="bfloat16",
                             **kw)
    torch.testing.assert_close(_wnoise(rows, pm.pm_merge),
                               _wnoise(plain, pm.merge_plain),
                               rtol=WNOISE_RTOL, atol=WNOISE_ATOL)


def _merge_rows(nb, n_z, device, seed):
    """Partial rows with spread maxima, positive l_b and zsum_b of both
    signs (f32)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((nb, pm.STATS + n_z), np.float32)
    rows[:, 0] = -np.abs(rng.normal(0.0, 3.0, nb))
    rows[:, 1] = rng.uniform(1.0, 256.0, nb)
    c = rng.uniform(1e3, 5e4, (nb, 2))
    rows[:, 2], rows[:, 3] = c.min(axis=1), c.max(axis=1)
    rows[:, 4] = rng.uniform(1e5, 1e7, nb)
    rows[:, pm.STATS:] = rng.normal(0.0, 30.0, (nb, n_z))
    return torch.as_tensor(rows, device=device)


@pytest.mark.parametrize("n_z", [0, 150, 300, 600])
@pytest.mark.parametrize("nb", [1, 12, 391, 1024, 5000, 40_000])
def test_pm_merge_matches_f64_merge(cuda_device, nb, n_z):
    """pm_merge against merge_plain in f64 on the same rows: m, cost min
    and cost max equal bit for bit (no order moves a max or min); l, the
    cost sum and every zsum[n] within 1e-5 of that column's l1 mass
    sum_b f_b |x_b| (zsum entries cancel towards 0); two merges of the
    same rows give the same bits. One block a tile below 640 rows, a
    cluster of 8 from there; at 40,000 rows each rank's 5,000 walk f_b
    in two chunks of shared memory (4,096 rows a chunk)."""
    rows = _merge_rows(nb, n_z, cuda_device, seed=nb + n_z)
    zs, st = pm.pm_merge(rows)
    zs2, st2 = pm.pm_merge(rows)
    assert torch.equal(zs, zs2) and torch.equal(st, st2)
    r = rows.double()
    ref_z, ref_st = pm.merge_plain(r)
    f = torch.exp(r[:, 0] - ref_st[0])
    assert zs.shape == (n_z,) and st.shape == (pm.STATS,)
    for i in (0, 2, 3):
        assert st[i].double() == ref_st[i]
    l1 = torch.cat([torch.stack([(f * r[:, 1]).sum(), r[:, 4].abs().sum()]),
                    f @ r[:, pm.STATS:].abs()])
    err = (torch.cat([st[[1, 4]], zs]).double()
           - torch.cat([ref_st[[1, 4]], ref_z])).abs()
    assert torch.all(err <= 1e-5 * l1), (err / l1).max().item()


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


def _nn_fused(k, tau, device, hidden, model_compute_dtype=None):
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    model = NNAUVModel(hidden=hidden, seed=4, device=device,
                       compute_dtype=model_compute_dtype)
    n_in, n_out = model.input_dim(), model.output_dim()
    model.set_normalization(0.1 * np.arange(n_in), 1.0 + 0.05 * np.arange(
        n_in), 0.01 * np.arange(n_out), 0.05 + 0.002 * np.arange(n_out))
    cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.2,
                    sigma=NN_SIGMA, device=device)
    return nnk.FusedNNMPPI(model, cost, k=k, tau=tau, lam=0.5, upsilon=1.2,
                           sigma=NN_SIGMA)


@pytest.mark.parametrize("build", ["f32", "bfp"])
@pytest.mark.parametrize("hidden", [(8, 8), (32, 32, 32)])
@pytest.mark.parametrize("k,tau", [(700, 7), (4097, 25), (17, 7), (33, 7)])
def test_nn_kernels_match_plain(cuda_device, hidden, k, tau, build):
    """The f32 NN kernels (``build`` "f32") and the bf16-products build
    ("bfp", a bf16-compute model) against their plain versions: K=17 and
    33 leave a warp and an m16 tile of its MLP partly filled, 4,097 a last
    block of one sample. The f32 costs within COST_RTOL / COST_ATOL; the
    bf16-products costs within BF16_GAP_SHARE of the f32 products'
    distance from that plain version (its gate in
    test_bf16_kernels_match_plain: rounding each hidden output to bf16
    turns an f32 ulp of another summation order into a bf16 step now and
    then); the fused rows against the softmax of each kernel's own
    costs."""
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk

    fused = _nn_fused(k, tau, cuda_device, hidden)
    z, x0, useq, dyn = _auv_inputs(fused, cuda_device, seed=len(hidden))
    f32, dyn32 = fused.consts, dyn
    if build == "bfp":   # the same weights, products at bf16
        weights = fused.model.state_dict()
        fused = _nn_fused(k, tau, cuda_device, hidden, torch.bfloat16)
        fused.model.load_state_dict(weights)
        with torch.no_grad():
            dyn = fused.pack_dyn(x0, useq)
        assert fused.consts.bf16_products
    c = fused.consts
    costs_k, rows_k = nnk.nn_fused_costs(c, dyn, k, tau, z=z)
    costs_p = nnk.sample_costs_plain(c, dyn, z)
    if build == "f32":
        torch.testing.assert_close(costs_k, costs_p, rtol=COST_RTOL,
                                   atol=COST_ATOL)
    else:
        err = (costs_k - costs_p).abs().mean().item()
        gap = (nnk.nn_fused_costs(f32, dyn32, k, tau, z=z)[0]
               - costs_p).abs().mean().item()
        assert gap > 0 and err <= BF16_GAP_SHARE * gap, (err, gap)
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


@pytest.mark.parametrize("sfx,lanes,blocks", [("", 1, 2), ("_bfp", 1, 2),
                                               ("_bf16", 2, 1)])
def test_nn_occupancy_entry_point(cuda_device, sfx, lanes, blocks):
    """nn_occupancy of each build: the tensor-core bodies (f32 and bf16
    products) hold two blocks of 256 an SM at both topologies and modes
    (K=65,536 in one wave), the bf16 pair build at least one; other
    topologies are refused."""
    import ctypes

    fn = getattr(_build.load_library(), f"nn_occupancy{sfx}")
    for hid in ((32, 32, 32), (8, 8, 0)):
        for mode in (0, 1):
            out = (ctypes.c_int * 2)()
            assert fn(*hid, mode, 25, out) == 0
            assert out[1] == lanes and out[0] >= blocks
    assert fn(16, 16, 16, 0, 25, (ctypes.c_int * 2)()) != 0


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
    auto = MPPI(NNAUVModel(), cost, kernel="auto", **kw)
    assert auto.kernel_path == "cuda" and type(auto._fused) is FusedNNMPPI
    assert MPPI(NNAUVModelSpeed(), cost, kernel="auto", **kw).kernel_path \
        == "torch"
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


@pytest.mark.parametrize("structure", ["diagonal", "dense"])
@pytest.mark.parametrize("kind", ["waypoints_quat", "elipse3d"])
@pytest.mark.parametrize("rk", [1, 2, 4])
def test_auv_tracking_kernels_match_plain(cuda_device, kind, rk, structure):
    k, tau = 4096, 25
    fused = _auv_fused(k, tau, cuda_device, rk, structure=structure,
                       task=_auv_tracking_task(kind))
    cost = fused.cost
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


def test_auv_structure_picks_the_instantiation(cuda_device):
    """The rexrov2 flagship launches the kDiag instantiation and the dense
    vehicle the kDense one (the ptxas report names the template arguments
    ``_template_args`` gives, and their costs agree with the plain
    version), the bf16 build kDense alone; auv_occupancy takes the
    structure and refuses kDiag at bf16."""
    import ctypes

    from mppi_tf_tpu_torch.kernels import _launch

    names = " ".join(r["kernel"] for r in _build.ptxas_report())
    for structure in ("diagonal", "dense"):
        fused = _auv_fused(700, 7, cuda_device, structure=structure)
        args = fused.template_args("auv_fused_costs")
        assert args == (2, 1, 0, auv.STRUCTURES[structure])
        assert _launch.kernel_symbol("auv_fused_costs", args) in names
        z, _, _, dyn = _auv_inputs(fused, cuda_device)
        before = pm.launch_counts["auv_fused_costs"]
        costs_k, _ = auv.auv_fused_costs(fused.consts, dyn, 700, 7, z=z)
        assert pm.launch_counts["auv_fused_costs"] == before + 1
        torch.testing.assert_close(
            costs_k, auv.sample_costs_plain(fused.consts, dyn, z),
            rtol=COST_RTOL, atol=COST_ATOL)
    lib = _build.load_library()
    for sfx, lanes, structures in (("", 1, (0, 1)), ("_bf16", 2, (0,))):
        fn = getattr(lib, f"auv_occupancy{sfx}")
        for rk in (1, 2, 4):
            for cost in (0, 1, 2):
                for st in structures:
                    for mode in (0, 1):
                        out = (ctypes.c_int * 2)()
                        assert fn(rk, cost, st, mode, 25, out) == 0
                        assert out[1] == lanes and out[0] >= 1
    assert lib.auv_occupancy_bf16(2, 0, 1, 0, 25,
                                  (ctypes.c_int * 2)()) != 0
    assert lib.auv_occupancy(2, 0, 2, 0, 25, (ctypes.c_int * 2)()) != 0


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
    runs on the kernels and steps finitely."""
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
        assert ctrl.kernel_path == "cuda"
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
    assert sym == "pm_fused_solve_kernelILi6ELi3ELi0ELi0ELi1ELi0E"
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


def test_dump_hlo_names_both_merge_kernels(cuda_device):
    """A normalized point-mass step merges twice through pm_merge: the
    stats-only rows of phase A (pm_merge_stats_kernel) and phase B's rows
    (pm_merge_kernel). dump_hlo names both and prints each one's ptxas
    row."""
    model, cost = _modules(cuda_device)
    ctrl = MPPI(model, cost, k=4096, tau=20, lam=LAM, sigma=SIGMA,
                normalize_cost=True, kernel="cuda", device=cuda_device)
    hlo = ctrl.dump_hlo()
    assert "pm_merge x2: pm_merge_kernel, pm_merge_stats_kernel" in hlo
    for sym in ("pm_merge_kernel", "pm_merge_stats_kernel"):
        assert any(line.startswith("  ") and sym in line and "registers"
                   in line for line in hlo.splitlines()), sym


# ---- the bf16 block compute (compute_dtype="bfloat16") --------------------

# a bf16 kernel against its plain bf16 version: mean |kernel - plain| over
# the per-sample costs at most this share of the f32 build's distance from
# that plain version (the kernel is the bf16 arithmetic, not f32
# relabelled); the same share bounds the weighted noise against the effect
# of rounding the normals, and phase B's block rows
BF16_GAP_SHARE = 1e-2
WNOISE_RTOL, WNOISE_ATOL = 1e-3, 1e-5

BF16_KINDS = ["pm", "pm21", "pm42", "pm_elipse", "pm_sched_anti",
              "pm_elipse_sched_anti", "pm_waypoints", "lti", "lti21",
              "lti42", "lti_elipse", "lti_sched_anti", "auv1", "auv2",
              "auv4", "auv_waypoints_quat", "auv_elipse3d", "auv_sched_anti",
              "nn8", "nn32", "nn_sched_anti", "nn_bfp"]
#: the point mass's dims of a kind
PM_KIND_DIMS = {"pm21": (2, 1), "lti21": (2, 1), "pm42": (4, 2),
                "lti42": (4, 2), "pm_elipse": (4, 2), "lti_elipse": (4, 2),
                "pm_elipse_sched_anti": (4, 2)}


def _bf16_pair(kind, k, tau, device):
    """(f32 solve object, its dyn, bf16 solve object, its dyn, the module
    of its wrappers) of one kind; for nn_bfp the f32 object runs the same
    weights with f32 products."""
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk

    rng = np.random.default_rng(len(kind))
    both = ({"schedule": SCHED, "antithetic": True}
            if kind.endswith("sched_anti") else {})
    if kind.startswith(("pm", "lti")):
        dims = PM_KIND_DIMS.get(kind, (6, 3))
        elipse = "elipse" in kind
        sigma = SIGMA[:dims[1], :dims[1]]
        if kind.startswith("lti"):
            f32 = _lti(k, tau, device, dims, elipse)[0]
            model, cost = f32.model, f32.cost
            cls = pm.FusedLTIMPPI
        else:
            model, cost = _modules(device, sdim=dims[0], adim=dims[1])
            cls = pm.FusedPointMassMPPI
            if elipse or kind == "pm_waypoints":
                cost = get_cost(PM_ELIPSE if elipse else PM_WAYPOINTS,
                                lam=LAM, gamma=GAMMA, upsilon=UPS,
                                sigma=sigma, device=device)
        make = (lambda cd: cls(model, cost, k=k, tau=tau, lam=LAM,
                               upsilon=UPS, sigma=sigma, compute_dtype=cd,
                               **both))
        f32, b16 = make("float32"), make("bfloat16")
        x0 = torch.as_tensor(rng.normal(size=f32.sdim) * 0.3 + (
            3.0 if elipse else 0.0), dtype=torch.float32, device=device)
        useq = torch.as_tensor(rng.normal(size=(tau, f32.adim)) * 0.1,
                               dtype=torch.float32, device=device)
        mod = pm
    elif kind.startswith("auv"):
        rk = int(kind[3:]) if kind[3:].isdigit() else 2
        model = get_model({**flagship.auv_params(), "rk": rk}, dt=0.1,
                          device=device)
        task = (_auv_tracking_task(kind[4:]) if kind in (
            "auv_waypoints_quat", "auv_elipse3d") else flagship.auv_task())
        cost = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.2,
                        sigma=AUV_SIGMA, device=device)
        f32, b16 = [auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=0.5,
                                     upsilon=1.2, sigma=AUV_SIGMA,
                                     compute_dtype=cd, **both)
                    for cd in ("float32", "bfloat16")]
        _, x0, useq, _ = _auv_inputs(f32, device)
        if kind == "auv_elipse3d":
            # from a point of the ellipse, heading +x: at its center the
            # tangent is ~1e-6 long and the orientation term 2 acos(dot)
            # sits at dot ~ 1, where the kernel's closed form and the
            # plain version's quaternion ops, both f32, part on bf16
            # states (PERF.md)
            x0 = torch.zeros(13, device=device)
            x0[0], x0[2], x0[6] = 4.0, -3.0, 1.0
            useq = torch.as_tensor(20.0 * rng.standard_normal((tau, 6)),
                                   dtype=torch.float32, device=device)
        mod = auv
    else:
        f32 = _nn_fused(k, tau, device, (8, 8) if kind == "nn8" else
                        (32, 32, 32))
        if kind == "nn_bfp":
            model = type(f32.model)(hidden=(32, 32, 32), seed=4,
                                    device=device,
                                    compute_dtype=torch.bfloat16)
            model.load_state_dict(f32.model.state_dict())
            b16 = nnk.FusedNNMPPI(model, f32.cost, k=k, tau=tau, lam=0.5,
                                  upsilon=1.2, sigma=NN_SIGMA)
        else:
            f32, b16 = [nnk.FusedNNMPPI(f32.model, f32.cost, k=k, tau=tau,
                                        lam=0.5, upsilon=1.2, sigma=NN_SIGMA,
                                        compute_dtype=cd, **both)
                        for cd in ("float32", "bfloat16")]
        _, x0, useq, _ = _auv_inputs(f32, device)
        mod = nnk
    with torch.no_grad():
        return f32, f32.pack_dyn(x0, useq), b16, b16.pack_dyn(x0, useq), mod


def _wnoise(rows, merge):
    zsum, st = merge(rows)
    return zsum / st[1]


def _philox_pair(seed, solve, k, tau, adim, device, half=0):
    """Keywords of a kernel on the Philox stream of (seed, solve) and of
    its plain version fed the f32 normals the kernel draws (the noise
    dump): the plain Box-Muller differs in the last bit, which rounding
    to bf16 turns into a rare one-step flip of a normal."""
    return ({"seed": seed, "solve": solve},
            {"z": pm.pm_noise_dump(seed, solve, k, tau, adim, device,
                                   half=half)})


@pytest.mark.parametrize("kind", BF16_KINDS)
def test_bf16_kernels_match_plain(cuda_device, kind):
    """Each bf16 kernel against its plain bf16 version on injected z and
    on the Philox stream (the plain version fed the kernel's own normals,
    _philox_pair): the per-sample costs (costs mode) within BF16_GAP_SHARE
    of the same kernel's f32 build's distance from that plain version;
    the fused mode's merged weighted noise against the softmax of the
    kernel's own costs over the normals rounded to bf16 (the f32 kernels'
    softmax tolerance; BF16_GAP_SHARE of the rounding's effect) and end to
    end against the plain bf16 solve (the f32 end-to-end tolerance of the
    model); the f32 build still matches its own plain version."""
    k, tau = 4097, 20
    f32, d32, b16, d16, mod = _bf16_pair(kind, k, tau, cuda_device)
    prefix = {pm: "pm", auv: "auv"}.get(mod, "nn")
    kern = getattr(mod, f"{prefix}_fused_costs")
    solve = getattr(mod, f"{prefix}_fused_solve")
    assert b16.consts.compute_dtype == (
        "float32" if kind == "nn_bfp" else "bfloat16")
    z = torch.randn(tau, f32.adim, k, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))
    half = pm.antithetic_half(k, b16.consts.antithetic)
    for kw, kw_p in (({"z": z}, {"z": z}),
                     _philox_pair(4, 2, k, tau, f32.adim, cuda_device, half)):
        ck, rows = kern(b16.consts, d16, k, tau, **kw)
        cp, _ = mod.fused_costs_plain(b16.consts, d16, k, tau, **kw_p)
        cf, _ = kern(f32.consts, d32, k, tau, **kw)
        err = (ck - cp).abs().mean().item()
        gap = (cf - cp).abs().mean().item()
        assert gap > 0 and err <= BF16_GAP_SHARE * gap, (err, gap)
        _, st = pm.merge_plain(rows)
        torch.testing.assert_close(st[2], ck.min(), rtol=0, atol=0)
        wk = _wnoise(solve(b16.consts, d16, k, tau, **kw), pm.pm_merge)
        zf = kw_p["z"].reshape(-1, k)
        zr = zf if kind == "nn_bfp" else pm.round_bf16(zf)
        ws = _wnoise(pm.block_partials(ck, zr, b16.consts.lam),
                     pm.merge_plain)
        torch.testing.assert_close(wk, ws, rtol=WNOISE_RTOL,
                                   atol=WNOISE_ATOL)
        if kind != "nn_bfp":   # its normals are not rounded: f32 kernel
            wu = _wnoise(pm.block_partials(ck, zf, b16.consts.lam),
                         pm.merge_plain)
            err_w = (wk - ws).abs().max().item()
            gap_w = (wu - ws).abs().max().item()
            assert err_w <= BF16_GAP_SHARE * gap_w, (err_w, gap_w)
        wp = _wnoise(mod.fused_solve_plain(b16.consts, d16, k, tau, **kw_p),
                     pm.merge_plain)
        torch.testing.assert_close(wk, wp, **(
            {"rtol": 1e-3, "atol": 1e-5} if mod is pm else
            {"rtol": 1e-2, "atol": 1e-3}))
    cf_plain, _ = mod.fused_costs_plain(f32.consts, d32, k, tau, 4, 2, z)
    torch.testing.assert_close(kern(f32.consts, d32, k, tau, z=z)[0],
                               cf_plain, rtol=COST_RTOL, atol=COST_ATOL)


# the bf16 builds hold two samples a thread (csrc/mppi_common.cuh,
# MPPI_BF16_PAIRS): block b of 128 threads is partial row b, thread t
# holds samples 256 b + t and 256 b + 128 + t
PAIR_CASES = [("auv", rk, cost) for rk in (2, 4)
              for cost in ("static_quat", "waypoints_quat", "elipse3d")] + [
    ("nn", (32, 32, 32), None), ("nn", (8, 8), None)] + [
    ("pm", kind, None) for kind in ("pm", "pm21", "pm42", "pm_elipse",
                                    "pm_sched_anti", "lti", "lti21", "lti42",
                                    "lti_elipse", "lti_sched_anti")]


@pytest.mark.parametrize("k", [700, 4097])
@pytest.mark.parametrize("case", PAIR_CASES, ids=str)
def test_bf16_pairs_lanes_and_tail(cuda_device, case, k):
    """A bf16 point-mass, AUV or NN kernel's costs for samples 0..K-1
    equal, bit for bit, the same samples' costs at K + 256 with z extended
    (and on the Philox stream, not antithetic, whose mirror moves with K):
    a lane's sample does not depend on the other lane of its thread, nor
    on where the tail falls (at K = 700 the last row's second lane is all
    padding, at K = 4,097 its first lane holds one sample). The partials
    have ceil(K / 256) rows, and every full row equals the longer
    solve's."""
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk

    model_kind, arg, cost_kind = case
    tau = 7
    if model_kind == "pm":
        _, _, b16, dyn, mod = _bf16_pair(arg, k, tau, cuda_device)
        prefix = "pm"
    elif model_kind == "auv":
        model = get_model({**flagship.auv_params(), "rk": arg}, dt=0.1,
                          device=cuda_device)
        task = (flagship.auv_task() if cost_kind == "static_quat"
                else _auv_tracking_task(cost_kind))
        cost = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.2,
                        sigma=AUV_SIGMA, device=cuda_device)
        b16 = auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=0.5,
                               upsilon=1.2, sigma=AUV_SIGMA,
                               compute_dtype="bfloat16")
        assert (b16.consts.rk, b16.consts.cost_kind) == (arg, cost_kind)
        mod, prefix = auv, "auv"
    else:
        f32 = _nn_fused(k, tau, cuda_device, arg)
        b16 = nnk.FusedNNMPPI(f32.model, f32.cost, k=k, tau=tau, lam=0.5,
                              upsilon=1.2, sigma=NN_SIGMA,
                              compute_dtype="bfloat16")
        mod, prefix = nnk, "nn"
    if model_kind != "pm":
        _, x0, useq, _ = _auv_inputs(b16, cuda_device, seed=k)
        with torch.no_grad():
            dyn = b16.pack_dyn(x0, useq)
    costs = getattr(mod, f"{prefix}_fused_costs")
    solve = getattr(mod, f"{prefix}_fused_solve")
    consts = dataclasses.replace(b16.consts, antithetic=False)
    z_long = torch.randn(tau, b16.adim, k + 256, device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(k))
    rows_n, full = -(-k // 256), k // 256
    for kw, kw_long in (({"z": z_long[..., :k].contiguous()},
                         {"z": z_long}),
                        ({"seed": 5, "solve": 3}, {"seed": 5, "solve": 3})):
        c, srows = costs(consts, dyn, k, tau, **kw)
        c2, srows2 = costs(consts, dyn, k + 256, tau, **kw_long)
        rows = solve(consts, dyn, k, tau, **kw)
        rows2 = solve(consts, dyn, k + 256, tau, **kw_long)
        torch.cuda.synchronize()
        assert torch.isfinite(c).all()
        assert torch.equal(c, c2[:k])
        assert rows.shape[0] == srows.shape[0] == rows_n
        assert rows2.shape[0] == -(-(k + 256) // 256)
        assert torch.equal(rows[:full], rows2[:full])
        assert torch.equal(srows[:full], srows2[:full])


@pytest.mark.parametrize("adim,half", [(3, 0), (6, 0), (6, 50_000)])
def test_bf16_noise_dump_is_the_rounded_f32_dump(cuda_device, adim, half):
    """Bit for bit, on the card: the bf16 dump is the f32 dump rounded;
    the mirrored half negates exactly; phase B at bf16 weighs those
    normals."""
    k, tau = 100_000, 20
    z32 = pm.pm_noise_dump(9, 4, k, tau, adim, cuda_device, half=half)
    z16 = pm.pm_noise_dump(9, 4, k, tau, adim, cuda_device, half=half,
                           compute_dtype="bfloat16")
    assert torch.equal(z16, z32.to(torch.bfloat16).float())
    if half:
        assert torch.equal(z16[..., half:], -z16[..., :k - half])
    costs = torch.rand(k, device=cuda_device) * 10.0
    nrm = torch.tensor([0.0, 0.1], device=cuda_device)
    wk = pm.mppi_weights(nrm, costs, tau, adim, z=z16,
                         compute_dtype="bfloat16")
    wz = pm.mppi_weights(nrm, costs, tau, adim, z=z32,
                         compute_dtype="bfloat16")
    torch.testing.assert_close(wk, wz, rtol=0, atol=0)


@pytest.mark.parametrize("adim,antithetic", [(3, False), (6, False),
                                             (6, True)])
def test_bf16_weights_match_plain(cuda_device, adim, antithetic):
    """Phase B at bf16 against weights_plain at bf16 on the same costs, on
    the Philox stream (_philox_pair) and on injected z: the merged
    weighted noise within the f32 tolerance, and each block's row (before
    the merge averages the roundings away) within BF16_GAP_SHARE of the
    f32 kernel's distance from the plain bf16 version."""
    k, tau = 50_000, 20
    gen = torch.Generator(cuda_device).manual_seed(adim)
    costs = torch.rand(k, device=cuda_device, generator=gen) * 50.0
    nrm = torch.stack([costs.min(), 1.0 / ((costs.max() - costs.min())
                                           * 0.5)])
    z = torch.randn(tau, adim, k, device=cuda_device, generator=gen)
    half = pm.antithetic_half(k, antithetic)
    for kw, kw_p in (({"z": z}, {"z": z}),
                     _philox_pair(6, 1, k, tau, adim, cuda_device, half)):
        rows = {cd: pm.mppi_weights(nrm, costs, tau, adim, compute_dtype=cd,
                                    antithetic=antithetic, **kw)
                for cd in ("bfloat16", "float32")}
        plain = pm.weights_plain(nrm, costs, tau, adim,
                                 compute_dtype="bfloat16", **kw_p)
        torch.testing.assert_close(_wnoise(rows["bfloat16"], pm.pm_merge),
                                   _wnoise(plain, pm.merge_plain),
                                   rtol=WNOISE_RTOL, atol=WNOISE_ATOL)
        zs = pm.STATS
        err = (rows["bfloat16"][:, zs:] - plain[:, zs:]).abs().max().item()
        gap = (rows["float32"][:, zs:] - plain[:, zs:]).abs().max().item()
        assert gap > 0 and err <= BF16_GAP_SHARE * gap, (err, gap)


@pytest.mark.parametrize("kind", ["point_mass", "dmd", "auv", "nn"])
def test_bf16_controllers_run_the_bf16_kernels(cuda_device, kind):
    """MPPI(kernel_dtype="bfloat16") on the kernel path launches the
    *_bf16 kernels and no f32 solve; the torch path refuses it."""
    from mppi_tf_tpu_torch.controller import DMDMPPI
    from mppi_tf_tpu_torch.models.dmd import DMDModel
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    if kind in ("point_mass", "dmd"):
        model, cost = _modules(cuda_device)
        sigma, x, cls = SIGMA, np.zeros(6), MPPI
        if kind == "dmd":
            model = DMDModel(6, 3, init_A=model.A.cpu().numpy(),
                             init_B=model.B.cpu().numpy(),
                             device=cuda_device)
            cls = DMDMPPI
    else:
        sigma, cls = (AUV_SIGMA if kind == "auv" else NN_SIGMA), MPPI
        model = (get_model(flagship.auv_params(), dt=0.1, device=cuda_device)
                 if kind == "auv" else NNAUVModel(device=cuda_device))
        cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2,
                        upsilon=1.0, sigma=sigma, device=cuda_device)
        x = np.zeros(13)
        x[6] = 1.0
    pm.reset_launch_counts()
    for normalize in (False, True):
        ctrl = cls(model, cost, k=1000, tau=6, lam=0.5, sigma=sigma,
                   kernel="cuda", kernel_dtype="bfloat16",
                   normalize_cost=normalize, device=cuda_device)
        assert ctrl._fused.compute_dtype == "bfloat16"
        assert np.all(np.isfinite(ctrl.next(x)))
    counts = {n: c for n, c in pm.launch_counts.items() if c}
    assert counts and all(n.endswith("_bf16") or n == "pm_merge"
                          for n in counts), counts
    with pytest.raises(ValueError, match="fused kernel path only"):
        cls(model, cost, k=100, tau=6, sigma=sigma, kernel="torch",
            kernel_dtype="bfloat16", device=cuda_device)


# ---------------------------------------------------------------------------
# the learner (learning/learner.py) and its hand-over to the NN kernels
# ---------------------------------------------------------------------------
def _learner_rows(n=96, seed=21):
    """(x, u, x') of a 13-state linear map from numpy: rest at a random
    attitude, random velocities and actions."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        x = np.zeros(13)
        q = np.append(0.2 * rng.standard_normal(3), 1.0)
        x[3:7] = q / np.linalg.norm(q)
        x[7:] = 0.5 * rng.standard_normal(6)
        u = 5.0 * rng.standard_normal(6)
        x1 = x.copy()
        x1[:3] += 0.1 * x[7:10]
        x1[7:] += 0.01 * u
        rows.append((x, u, x1))
    return rows


def _filled_learner(device, rows):
    from mppi_tf_tpu_torch.learning import Learner
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    learner = Learner(NNAUVModel(seed=6), device=device, learning_rate=1e-2)
    for x, u, x1 in rows:
        learner.add_rb(x, u, x1)
    learner.stats()
    return learner


def test_learner_trains_on_the_card(cuda_device):
    """A Learner on the card trains its own copy of the model there: the
    loss falls, and 20 epochs without augmentation stay within f32
    rounding of the same learner on the CPU."""
    rows = _learner_rows()
    learner, cpu = _filled_learner(cuda_device, rows), _filled_learner(
        "cpu", rows)
    assert learner.model.device.type == "cuda"
    assert learner.rb.backend == "native"
    X, Y = learner._prepare(learner.rb_trans())
    with torch.no_grad():
        l0 = float(learner._loss(X, Y))
    learner.train_all(epoch=20, augment=False)
    cpu.train_all(epoch=20, augment=False)
    for name, t in learner.params["net"][0].items():
        assert t.device.type == "cuda"
        torch.testing.assert_close(t.cpu(), cpu.params["net"][0][name],
                                   rtol=1e-4, atol=1e-5)
    learner.train_all(epoch=200)
    with torch.no_grad():
        assert float(learner._loss(X, Y)) < 0.1 * l0


def test_model_params_write_reaches_nn_fused_solve(cuda_device):
    """controller.model_params = learner.params writes the learned weights
    in place: the next dyn packs them, the kernels match their plain
    versions on them, and their costs move from the pre-write ones."""
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    learner = _filled_learner(cuda_device, _learner_rows())
    learner.train_all(epoch=100)
    cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.0,
                    sigma=NN_SIGMA, device=cuda_device)
    ctrl = MPPI(NNAUVModel(device=cuda_device), cost, k=4097, tau=12,
                lam=0.5, upsilon=1.0, sigma=NN_SIGMA, kernel="cuda",
                device=cuda_device)
    fused = ctrl._fused
    z, x0, useq, dyn0 = _auv_inputs(fused, cuda_device, seed=5)
    ctrl.model_params = learner.params
    assert fused.model is ctrl._model
    for name, t in ctrl.model_params["net"][1].items():
        torch.testing.assert_close(t, learner.params["net"][1][name],
                                   rtol=0, atol=0)
    with torch.no_grad():
        dyn = fused.pack_dyn(x0, useq)
    c, k, tau = fused.consts, fused.k, fused.tau
    before = pm.launch_counts["nn_fused_costs"]
    costs_k, _ = nnk.nn_fused_costs(c, dyn, k, tau, z=z)
    assert pm.launch_counts["nn_fused_costs"] == before + 1
    costs_p = nnk.sample_costs_plain(c, dyn, z)
    torch.testing.assert_close(costs_k, costs_p, rtol=COST_RTOL,
                               atol=COST_ATOL)
    stale = nnk.nn_fused_costs(c, dyn0, k, tau, z=z)[0]
    assert not torch.allclose(costs_k, stale, rtol=COST_RTOL,
                              atol=COST_ATOL)
    zs_k, st_k = pm.merge_plain(nnk.nn_fused_solve(c, dyn, k, tau, z=z))
    zs_p, st_p = pm.merge_plain(nnk.fused_solve_plain(c, dyn, k, tau, z=z))
    torch.testing.assert_close(zs_k / st_k[1], zs_p / st_p[1], rtol=1e-2,
                               atol=1e-3)


def test_native_replay_buffer_on_the_card_machine(cuda_device, tmp_path):
    """g++ builds the port's datastore on the card's machine: the replay
    buffer's backend is native, its ring and CSV as the numpy ring's."""
    from mppi_tf_tpu_torch.learning import ReplayBuffer, datastore

    rb = ReplayBuffer(4, 2, 1)
    ring = ReplayBuffer(4, 2, 1, use_native=False)
    assert rb.backend == "native" and ring.backend == "numpy"
    assert datastore.library_path().exists()
    for i in range(6):
        for b in (rb, ring):
            b.add([i, i], [i], [i + 1, i + 1])
    for key, v in ring.get_all_transitions().items():
        np.testing.assert_array_equal(rb.get_all_transitions()[key], v)
    rb._native.to_csv(str(tmp_path / "native.csv"))
    loaded = np.loadtxt(tmp_path / "native.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(loaded[:, :2],
                                  ring.get_all_transitions()["obs"])


@pytest.mark.parametrize("kind", ["pm", "pm_sched_anti", "lti", "auv2",
                                  "auv_sched_anti", "nn", "nn_bfp"])
@pytest.mark.parametrize("solve", [5, 2 ** 32 + 7], ids=["low", "high"])
def test_device_solve_index_equals_host_index(cuda_device, kind, solve):
    """Every entry point that takes (seed, solve) reads the solve index
    from a one-element int64 tensor on the card (what a replayed graph
    needs) and then writes the bits it writes for the int: the solve and
    costs kernels of the f32 and bf16 (or bf16-products) builds, phase B
    and the noise dump, below and above 2^32."""
    k, tau = 700, 7
    f32, dyn32, b16, dyn16, _ = _bf16_pair(kind, k, tau, cuda_device)
    dev = torch.tensor([solve], dtype=torch.int64, device=cuda_device)
    for obj, dyn in ((f32, dyn32), (b16, dyn16)):
        for fn in (obj._fused, obj._costs):
            a, b = fn(dyn, 11, solve, None), fn(dyn, 11, dev, None)
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            assert all(torch.equal(x, y) for x, y in zip(a, b)), fn
        costs = obj._costs(dyn, 11, solve, None)[0]
        nrm = torch.stack([costs.min(), 1.0 / (costs.max() - costs.min())
                           / obj.lam]).float()
        kw = dict(antithetic=obj.antithetic,
                  compute_dtype=obj.compute_dtype)
        assert torch.equal(
            pm.mppi_weights(nrm, costs, tau, obj.adim, 11, solve, **kw),
            pm.mppi_weights(nrm, costs, tau, obj.adim, 11, dev, **kw))
        half = pm.antithetic_half(k, obj.antithetic)
        assert torch.equal(
            pm.pm_noise_dump(11, solve, k, tau, obj.adim, cuda_device,
                             half=half, compute_dtype=obj.compute_dtype),
            pm.pm_noise_dump(11, dev, k, tau, obj.adim, cuda_device,
                             half=half, compute_dtype=obj.compute_dtype))
    with pytest.raises(ValueError, match="int64"):
        f32._fused(dyn32, 11, dev.int(), None)


@pytest.mark.parametrize("case", ["point_mass", "dmd", "dmd_svd",
                                  "mission", "torch_route"])
def test_on_device_loop_replay_equals_eager(cuda_device, case):
    """One period captured as a CUDA graph and replayed equals the eager
    periods bit for bit (states, actions, the final sequence, the fitted
    (A, B), the final queue); the capture is reused across runs; the
    launches are the captured ones times the replays. A model with rank
    set refits by the SVD between the replays; the torch route runs its
    periods eagerly on the card, its noise from the generator given."""
    from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
    from mppi_tf_tpu_torch.envs import (DevicePointMassEnv,
                                        build_on_device_loop)
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    steps, sigma = 12, SIGMA
    model, cost = _modules(cuda_device, mass=1.0, ups=1.0)
    kw = dict(k=1000, tau=10, lam=LAM, upsilon=1.0, sigma=sigma, seed=3,
              kernel="cuda", device=cuda_device)
    radius = None
    if case.startswith("dmd"):
        ctrl = DMDMPPI(DMDModel(6, 3, init_A=model.A.cpu().numpy(),
                                init_B=model.B.cpu().numpy(),
                                rank=8 if case == "dmd_svd" else None,
                                device=cuda_device), cost, refit_every=4,
                       min_samples=4, **kw)
    elif case == "torch_route":
        ctrl = MPPI(model, cost, **dict(kw, kernel="torch"))
    else:
        if case == "mission":
            cost = get_cost(PM_WAYPOINTS, lam=LAM, gamma=GAMMA, upsilon=1.0,
                            sigma=sigma, device=cuda_device)
            radius = 0.5
        ctrl = MPPI(model, cost, **kw)
    env = DevicePointMassEnv(n_dof=3, mass=2.0, dt=0.01)
    loop = build_on_device_loop(ctrl, env.step_fn, steps, substeps=3,
                                waypoint_radius=radius)
    x0 = np.array([0.7, 0.0, 0.0, 0.0, 0.0, 0.0])
    outs = []
    for run in (loop, loop.eager, loop):
        if case == "mission":
            ctrl.set_waypoints(PM_WAYPOINTS["waypoints"])
        pm.reset_launch_counts()
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        out = run(x0, step0=40, generator=gen)
        assert out[0].device.type == "cuda"
        counts = dict(pm.launch_counts)
        queue = (ctrl._cost.count.clone(), ctrl._cost.waypoints.clone()) \
            if case == "mission" else ()
        outs.append((out, loop.useq, queue, counts))
    (g, ug, qg, cg), (e, ue, qe, ce), (g2, _, _, cg2) = outs
    if case == "torch_route":
        assert loop.captures == 0 and not any(cg.values())
        assert all(torch.equal(a, b) for a, b in zip(g, e))
        assert torch.isfinite(g[0]).all()
        return
    assert loop.captures == 1 and loop.capture_s > 0
    for a, b in zip((*g[:2], ug, *qg), (*e[:2], ue, *qe)):
        assert torch.equal(a, b)
    if case.startswith("dmd"):
        for name in ("A", "B"):
            assert torch.equal(g[2][name], e[2][name])
            assert torch.equal(g2[2][name], g[2][name])
    assert torch.equal(g2[0], g[0])
    # the capturing run also launched its warm-up period eagerly
    assert cg2["pm_fused_solve"] == ce["pm_fused_solve"] == steps
    assert cg["pm_fused_solve"] == steps + 1
    assert cg2 == ce


# ---- the fleet: a vehicle axis in one launch --------------------------------

FLEET_KINDS = ["pm", "pm_waypoints", "pm_sched_anti", "lti", "auv2",
               "auv_waypoints_quat", "auv_sched_anti"]


def _fleet_rows(obj, dyn, n):
    """n vehicles' dyn rows: ``dyn`` with each vehicle's first three state
    entries moved by 0.05 v."""
    x0 = auv.Dyn(obj.tau).x0 if obj.sdim == 13 else pm.Dyn(
        obj.tau, obj.sdim, obj.adim).x0
    rows = dyn.repeat(n, 1)
    rows[:, x0:x0 + 3] += 0.05 * torch.arange(
        n, dtype=rows.dtype, device=rows.device)[:, None]
    return rows


def _fleet_outputs(obj, rows, z, solve):
    """Every kernel with a vehicle axis of one solve object on ``rows``
    ([n, size], or [size] for one vehicle): fused partials, costs, their
    rows, phase B's rows and the merges."""
    part = obj._fused(rows, 11, solve, z)
    costs, crows = obj._costs(rows, 11, solve, z)
    lo, hi = costs.min(-1).values, costs.max(-1).values
    nrm = torch.stack([lo, 1.0 / ((hi - lo) * obj.lam)], dim=-1)
    wrows = pm.mppi_weights(nrm, costs, obj.tau, obj.adim, 11, solve, z,
                            antithetic=obj.antithetic,
                            compute_dtype=obj.compute_dtype)
    return (part, costs, crows, wrows, *pm.pm_merge(part),
            *pm.pm_merge(crows), *pm.pm_merge(wrows))


@pytest.mark.parametrize("build", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", FLEET_KINDS)
def test_fleet_launch_equals_vehicle_launches(cuda_device, kind, build):
    """A fleet launch of each kernel with a vehicle axis (the solve and
    costs of the point mass, LTI and AUV, phase B, the merge) == n
    one-vehicle launches with solve s n + v, bit for bit, on the Philox
    stream (by value and on the device) and on injected z; one launch an
    entry point for the whole fleet; at n = 1 the one-vehicle entry's
    bits."""
    n, k, tau, s = 5, 700, 7, 3
    f32, dyn32, b16, dyn16, _ = _bf16_pair(kind, k, tau, cuda_device)
    obj, dyn = (f32, dyn32) if build == "float32" else (b16, dyn16)
    rows = _fleet_rows(obj, dyn, n)
    z = torch.as_tensor(np.random.default_rng(n).standard_normal(
        (n, tau, obj.adim, k), np.float32), device=cuda_device)
    dev = torch.tensor([s], dtype=torch.int64, device=cuda_device)
    for zz in (None, z):
        pm.reset_launch_counts()
        fleet = _fleet_outputs(obj, rows, zz, s)
        launched = {e: c for e, c in pm.launch_counts.items() if c}
        # solve, costs, phase B once each; the three merges
        assert len(launched) == 4 and launched.pop("pm_merge") == 3
        assert set(launched.values()) == {1}, launched
        for v in range(n):
            one = _fleet_outputs(obj, rows[v], None if zz is None else zz[v],
                                 s * n + v)
            for a, b in zip(fleet, one):
                assert torch.equal(a[v], b)
        if zz is None:
            for a, b in zip(fleet, _fleet_outputs(obj, rows, None, dev)):
                assert torch.equal(a, b)
    for a, b in zip(_fleet_outputs(obj, rows[:1], None, s),
                    _fleet_outputs(obj, rows[0], None, s)):
        assert torch.equal(a[0], b)


def _nn_fleet(n, k, tau, device, build, normalize, seed=3):
    """A fleet of ``n`` NN AUVs on the kernels (``build``: "f32", the bf16
    block compute "bf16", or a bf16-products model "bfp"), the learned
    model and normalisers of ``_nn_fused``, depth goals apart."""
    from mppi_tf_tpu_torch.controller import FleetMPPI

    fused = _nn_fused(k, tau, device, (32, 32, 32),
                      torch.bfloat16 if build == "bfp" else None)
    goals = np.tile(np.asarray(fused.cost.goal.cpu(), np.float64), (n, 1))
    goals[:, 2] = -np.linspace(0.2, 2.0, n)
    return FleetMPPI(fused.model, fused.cost, n, k=k, tau=tau, lam=0.5,
                     upsilon=1.2, sigma=NN_SIGMA, goals=goals, seed=seed,
                     normalize_cost=normalize, kernel="cuda",
                     kernel_dtype="bfloat16" if build == "bf16"
                     else "float32", device=device)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("build", ["f32", "bf16", "bfp"])
def test_nn_fleet_launch_equals_vehicle_launches(cuda_device, build,
                                                 normalize):
    """A 16-vehicle NN fleet on the kernels: each NN kernel's fleet launch
    over one weight segment and a row a vehicle == 16 one-vehicle launches
    on the segment and that row, with solve s n + v, bit for bit (Philox
    and injected z); a fleet step launches each phase once for all
    vehicles and equals 16 one-vehicle controllers' steps bit for bit."""
    from mppi_tf_tpu_torch.kernels import nn_mppi as nnk

    n, k, tau, s = 16, 4096, 10, 3
    fleet = _nn_fleet(n, k, tau, cuda_device, build, normalize)
    fused = fleet._tpl._fused
    assert type(fused) is nnk.FusedNNMPPI
    assert fleet._tpl.kernel_path == "cuda"
    rng = np.random.default_rng(7)
    x = np.zeros((n, 13))
    x[:, 6] = 1.0
    x[:, :3] = 0.3 * rng.standard_normal((n, 3))
    x[:, 7:] = 0.1 * rng.standard_normal((n, 6))
    xs = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    us = torch.as_tensor(30.0 * rng.standard_normal((n, tau, 6)),
                         dtype=torch.float32, device=cuda_device)
    with torch.no_grad():
        weights, rows = fused.pack_dyn(xs, us, fleet.cost_params)
    z = torch.as_tensor(rng.standard_normal((n, tau, 6, k), np.float32),
                        device=cuda_device)
    for zz in (None, z):
        pm.reset_launch_counts()
        part = fused._fused((weights, rows), 11, s, zz)
        costs, crows = fused._costs((weights, rows), 11, s, zz)
        assert set(c for c in pm.launch_counts.values() if c) == {1}
        for v in range(n):
            one = torch.cat([weights, rows[v]])
            zv = None if zz is None else zz[v]
            assert torch.equal(part[v], fused._fused(one, 11, s * n + v, zv))
            c1, r1 = fused._costs(one, 11, s * n + v, zv)
            assert torch.equal(costs[v], c1) and torch.equal(crows[v], r1)
    singles = []
    for v in range(n):
        one = _nn_fleet(1, k, tau, cuda_device, build, normalize)._tpl
        one.set_goal(fleet.cost_params["goal"][v].cpu().numpy())
        singles.append(one)
    useq = [c.useq for c in singles]
    for step in range(2):
        pm.reset_launch_counts()
        actions = fleet.next(x)
        launched = {e: c for e, c in pm.launch_counts.items() if c}
        assert launched.pop("pm_merge") == (2 if normalize else 1)
        assert sorted(launched) == sorted(
            (fused.consts.entry("nn_fused_costs"),
             pm.entry("mppi_weights", fused.compute_dtype)) if normalize
            else (fused.consts.entry("nn_fused_solve"),))
        assert set(launched.values()) == {1}
        for v, c in enumerate(singles):
            act, useq[v], _ = c._fused_step(xs[v], useq[v],
                                            solve=step * n + v)
            assert torch.equal(torch.as_tensor(actions[v]), act.cpu())
            assert torch.equal(fleet.useq[v], useq[v])


@pytest.mark.parametrize("n_z", [0, 150])
@pytest.mark.parametrize("nb", [12, 391, 1024])
def test_pm_merge_fleet_rows(cuda_device, nb, n_z):
    """pm_merge over [n, nb, w] in one launch (a cluster of 8 a tile from
    640 rows, one block below) == n merges of one vehicle's rows, bit for
    bit, and each within the f64 merge's gate."""
    n = 4
    rows = torch.stack([_merge_rows(nb, n_z, cuda_device, seed=nb + v)
                        for v in range(n)])
    zs, st = pm.pm_merge(rows)
    assert zs.shape == (n, n_z) and st.shape == (n, pm.STATS)
    for v in range(n):
        zv, sv = pm.pm_merge(rows[v])
        assert torch.equal(zs[v], zv) and torch.equal(st[v], sv)
        _, ref_st = pm.merge_plain(rows[v].double())
        assert st[v, 0].double() == ref_st[0]


@pytest.mark.parametrize("case", ["static", "mission"])
def test_fleet_on_device_loop_replay_equals_eager(cuda_device, case):
    """The fleet's period captured as one CUDA graph and replayed == the
    eager periods bit for bit (states, actions, the final queues); a
    re-goal between runs recaptures nothing; each period launches the
    solve and the merge once for the whole fleet."""
    from mppi_tf_tpu_torch.controller import FleetMPPI
    from mppi_tf_tpu_torch.envs import DevicePointMassEnv

    n, steps = 4, 12
    model, cost = _modules(cuda_device, mass=1.0, ups=1.0)
    radius = None
    if case == "mission":
        cost = get_cost(PM_WAYPOINTS, lam=LAM, gamma=GAMMA, upsilon=1.0,
                        sigma=SIGMA, device=cuda_device)
        radius = 0.5
    fleet = FleetMPPI(model, cost, n, k=1000, tau=10, lam=LAM, upsilon=1.0,
                      sigma=SIGMA, seed=3, kernel="cuda",
                      device=cuda_device)
    env = DevicePointMassEnv(n_dof=3, mass=2.0, dt=0.01)
    loop = fleet.build_on_device_loop(env.step_fn, steps, substeps=3,
                                      waypoint_radius=radius)
    x0 = np.zeros((n, 6))
    x0[:, 0] = 0.7 - 0.2 * np.arange(n)
    outs = []
    for run in (loop, loop.eager, loop):
        if case == "mission":
            for v in range(n):
                fleet.set_vehicle_waypoints(v, PM_WAYPOINTS["waypoints"])
        else:   # the third run re-tasks vehicle 1
            fleet.set_vehicle_goal(1, [0.4 if len(outs) == 2 else 0.0] * 6)
        pm.reset_launch_counts()
        out = run(x0, step0=40)
        outs.append((out, {k: t.clone() for k, t in
                           fleet.cost_params.items()},
                     dict(pm.launch_counts)))
    (g, qg, cg), (e, qe, ce), (g2, _, cg2) = outs
    assert loop.captures == 1
    for a, b in zip((*g, *qg.values()), (*e, *qe.values())):
        assert torch.equal(a, b)
    if case == "static":   # the re-goal reached the replay
        assert not torch.equal(g2[0][:, 1], g[0][:, 1])
        assert torch.equal(g2[0][:, 0], g[0][:, 0])
    assert cg2 == ce and ce["pm_fused_solve"] == ce["pm_merge"] == steps


# ---------------------------------------------------------------------------
# the mesh-sharded fused solve on the card (parallel/fused.py)
# ---------------------------------------------------------------------------
def _sharded(device, n, k, tau, **kw):
    from mppi_tf_tpu_torch.parallel import make_mesh
    from mppi_tf_tpu_torch.parallel.fused import ShardedFusedMPPI

    model, cost = _modules(device)
    return ShardedFusedMPPI(model, cost, make_mesh(devices=[device] * n),
                            k=k, tau=tau, lam=LAM, upsilon=UPS, sigma=SIGMA,
                            **kw)


@pytest.mark.parametrize("normalize", [False, True])
def test_one_shard_mesh_is_the_fused_step_on_the_card(cuda_device,
                                                      normalize):
    """A mesh of one shard launches the kernels of the single-device
    solve with the same solve index: the same bits, int or device
    index."""
    k, tau = 4096, 12
    ctrl = _sharded(cuda_device, 1, k, tau, normalize_cost=normalize, seed=5)
    single = _fused(k, tau, cuda_device)
    x0 = torch.zeros(6, device=cuda_device)
    useq = 0.1 * torch.ones(tau, 3, device=cuda_device)
    want, _ = single.solve(x0, useq, seed=5, solve=7, normalize=normalize)
    for solve in (7, torch.tensor([7], device=cuda_device)):
        got, _ = ctrl._fused.solve(x0, useq, seed=5, solve=solve,
                                   normalize=normalize)
        assert torch.equal(got, want)


@pytest.mark.parametrize("normalize", [False, True])
def test_four_shards_hold_the_single_device_solve(cuda_device, normalize):
    """Four shards on one card, injected z: within the f32 merge tolerance
    of the single-device solve; the kernels launch once a shard."""
    k, tau = 8192, 12
    ctrl = _sharded(cuda_device, 4, k, tau, normalize_cost=normalize)
    single = _fused(k, tau, cuda_device)
    z = torch.randn(tau, 3, k, generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device)
    x0 = torch.zeros(6, device=cuda_device)
    useq = 0.1 * torch.ones(tau, 3, device=cuda_device)
    want, _ = single.solve(x0, useq, z=z, normalize=normalize)
    pm.reset_launch_counts()
    got, _ = ctrl._fused.solve(x0, useq, z=z, normalize=normalize)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    entry = "pm_fused_costs" if normalize else "pm_fused_solve"
    assert pm.launch_counts[entry] == 4


def test_sharded_loop_graph_replays_its_eager_periods(cuda_device):
    """The on-device loop over a local mesh of 4 shards: one captured
    graph holding every shard's launches, replayed == eager."""
    from mppi_tf_tpu_torch.envs import DevicePointMassEnv
    from mppi_tf_tpu_torch.envs.mjx_env import build_on_device_loop

    ctrl = _sharded(cuda_device, 4, 4096, 12, seed=3)
    run = build_on_device_loop(ctrl, DevicePointMassEnv(n_dof=3,
                                                        dt=0.01).step_fn,
                               steps=20, substeps=5)
    s_g, a_g = run(np.zeros(6), step0=0)
    s_e, a_e = run.eager(np.zeros(6), step0=0)
    assert run.nodes["pm_fused_solve"] == 4 and run.nodes["pm_merge"] == 4
    assert torch.equal(s_g, s_e) and torch.equal(a_g, a_e)


def test_roofline_microbenchmarks_within_the_peaks(cuda_device):
    """The ceilings' microbenchmarks (csrc/roofline.cu) build without a
    spill, launch, and read rates no higher than 1.05 x the datasheet
    peaks (above that the microbenchmark is broken)."""
    from mppi_tf_tpu_torch import roofline

    ceil = roofline.measure_ceilings(cuda_device, reps=1)
    assert ceil["backend"] == "cuda"
    for key in ("vpu_flops", "transcendental_per_s", "bm_pairs_per_s",
                "hbm_bytes_per_s"):
        assert np.isfinite(ceil[key]) and ceil[key] > 0, key
    assert ceil["vpu_flops"] <= 1.05 * roofline.PEAK_OPS
    assert ceil["hbm_bytes_per_s"] <= 1.05 * roofline.PEAK_BYTES
    rows = [r for r in _build.ptxas_report() if "roofline" in r["kernel"]]
    assert len(rows) == 4
    assert not any(r.get("spill_stores") or r.get("spill_loads")
                   for r in rows)


def test_served_loop_on_the_card(cuda_device):
    """Five steps of a served point mass on the kernels: info names the
    kernel path, each request launches the solve and the merge once, and
    the m-step reply advances the stored plan by m."""
    from mppi_tf_tpu_torch.serve import ControlClient, ControlServer

    model, cost = _modules(cuda_device)
    ctrl = MPPI(model, cost, k=4096, tau=20, lam=LAM, upsilon=UPS,
                sigma=SIGMA, kernel="cuda", device=cuda_device)
    server = ControlServer(ctrl)
    host, port = server.serve_background()
    client = ControlClient(host, port)
    try:
        assert client.info()["kernel"] == "cuda"
        pm.reset_launch_counts()
        x = np.zeros(6)
        for _ in range(5):
            u = client.next(x)
            assert u.shape == (3,) and np.all(np.isfinite(u))
            x = model.predict(torch.as_tensor(x, dtype=torch.float32,
                                              device=cuda_device),
                              torch.as_tensor(u, dtype=torch.float32,
                                              device=cuda_device)
                              ).detach().cpu().numpy()
        assert pm.launch_counts["pm_fused_solve"] == 5
        assert pm.launch_counts["pm_merge"] == 5
        plan = client.next_plan(x, m=4)
        assert plan.shape == (4, 3)
        assert torch.equal(ctrl.useq[-4:], torch.zeros_like(ctrl.useq[-4:]))
    finally:
        client.close()
        server.close()
