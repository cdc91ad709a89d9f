"""The fused AUV solve of the port (kernels/auv_mppi.py) and the shared
phase-B weights: their plain versions against the JAX package's XLA path
(``MPPI._solve_with_noise`` / ``_rollout``) at f64 on the same injected
normals, for rk 1, 2 and 4. The XLA path is the yardstick because the JAX
AUV Pallas kernel runs every rk != 1 as rk2 and its interpret mode is
minutes long. The CUDA kernels are held against these plain versions on
the card by tests/test_torch_cuda.py. Besides the diagonal vehicle of the
JAX kernel tests, a vehicle whose constants are dense (6x6 linear and
forward-speed damping, nonzero cog, full sigma and Q) holds the reference
of the dense kernel instantiation, and upsilon = 1 the dropped
z-quadratic; ``AuvConsts.structure`` picks the instantiation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu_torch import flagship
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import auv_mppi as auv
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.kernels.errors import KernelUnsupportedError
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.ops import update as upd
from tests.test_auv_kernel import _auv_cfg, _task

SIGMA = np.diag([40.0, 40.0, 40.0, 5.0, 5.0, 5.0])
LAM, GAMMA, UPS = 0.5, 0.2, 1.2
# a full sigma and Q (each positive definite: the off-diagonal part moves
# no eigenvalue by more than its 0.5 / 0.2)
DENSE_SIGMA = SIGMA + 0.5 * (np.ones((6, 6)) - np.eye(6))
DENSE_Q = np.diag(_task()["Q"]) + 0.2 * (np.ones((10, 10)) - np.eye(10))


def _dense_cfg():
    """The test vehicle with dense constants: 6x6 linear damping (the
    diagonal plus off-diagonal terms), 6x6 forward-speed damping, a
    nonzero cog."""
    rng = np.random.RandomState(7)
    cfg = _auv_cfg()
    cfg.update(
        linear_damping=(np.diag(cfg["linear_damping"])
                        + 5.0 * rng.randn(6, 6)).tolist(),
        linear_damping_forward_speed=(20.0 * rng.randn(6, 6)).tolist(),
        cog=[0.01, -0.02, 0.05])
    return cfg


def _case(case):
    """(vehicle, task, sigma, upsilon) of a constants case: "rexrov2" the
    JAX kernel tests' diagonal vehicle, "dense" every constant dense,
    "upsilon1" the diagonal vehicle at upsilon 1 (nc_half = 0)."""
    if case == "dense":
        task = {**_task(), "diag": False, "Q": DENSE_Q.tolist()}
        return _dense_cfg(), task, DENSE_SIGMA, UPS
    return _auv_cfg(), _task(), SIGMA, 1.0 if case == "upsilon1" else UPS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port(k, tau, rk=2, dtype=torch.float64, case="rexrov2"):
    cfg, task, sigma, ups = _case(case)
    model = get_model({**cfg, "rk": rk}, dt=0.1, action_dim=6, dtype=dtype)
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=ups, sigma=sigma,
                    dtype=dtype)
    return auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=ups,
                            sigma=sigma)


def _jax(k, tau, rk=2, normalize=False, case="rexrov2"):
    cfg, task, sigma, ups = _case(case)
    model = jget_model({**cfg, "rk": rk}, dt=0.1, action_dim=6,
                       dtype=jnp.float64)
    cost = jget_cost(task, lam=LAM, gamma=GAMMA, upsilon=ups, sigma=sigma,
                     dtype=jnp.float64)
    return JMPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=ups,
                 sigma=sigma, normalize_cost=normalize)


def _inputs(k, tau, seed=0, case="rexrov2"):
    """Normals z [tau, 6, k], eps = scale z as [k, tau, 6], x0, useq (the
    regime of tests/test_auv_kernel.py: z = -1, qw = 1, useq ~ 5 N(0, 1))."""
    _, _, sigma, ups = _case(case)
    rng = np.random.RandomState(seed)
    z = rng.randn(tau, 6, k)
    eps = np.einsum("ij,tjk->kti", ups * sigma, z)
    x0 = np.zeros(13)
    x0[[2, 6]] = [-1.0, 1.0]
    return z, eps, x0, 5.0 * rng.randn(tau, 6)


def _jax_solve(ctrl, eps, x0, useq):
    mp, cp = ctrl.model_params, ctrl._cparams
    _, _, info = ctrl._solve_with_noise_jit(
        jnp.asarray(eps), jnp.asarray(x0), jnp.asarray(useq), mp, cp)
    costs = ctrl._rollout(jnp.asarray(x0), jnp.asarray(useq),
                          jnp.asarray(eps), ctrl._model.precompute(mp), cp)
    return np.asarray(info["weighted_noise"]), np.asarray(costs)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


# f64 on both sides: the kernel's algebra (matrix-free dynamics, Sigma^-1
# and u folded into dyn) against the XLA rollout, agreeing to rounding
RTOL = 1e-9


def _cases(base, extra):
    """pytest params of (*base, case): the rexrov2 case under the ids the
    tests had before the constants cases, then ``extra`` (case, base)."""
    return ([pytest.param(*b, "rexrov2", id="-".join(map(str, b)))
             for b in base]
            + [pytest.param(*b, case, id="-".join(map(str, (*b, case))))
               for case, bs in extra for b in bs])


@pytest.mark.parametrize("k,rk,case", _cases(
    [(k, rk) for k in (80, 333) for rk in (1, 2, 4)],
    [("dense", [(333, rk) for rk in (1, 2, 4)]),
     ("upsilon1", [(80, 2)])]))
def test_plain_costs_match_jax_rollout(rk, k, case):
    tau = 3
    z, eps, x0, useq = _inputs(k, tau, seed=rk, case=case)
    _, costs_j = _jax_solve(_jax(k, tau, rk, case=case), eps, x0, useq)
    fused = _port(k, tau, rk, case=case)
    assert fused.consts.structure == (
        "dense" if case == "dense" else "diagonal")
    dyn = fused.pack_dyn(_t(x0), _t(useq))
    np.testing.assert_allclose(
        auv.sample_costs_plain(fused.consts, dyn, _t(z)).numpy(), costs_j,
        rtol=RTOL)
    costs, rows = auv.fused_costs_plain(fused.consts, dyn, k, tau, z=_t(z),
                                        block=32)
    _, stats = pm.merge_plain(rows)
    assert rows.shape == (-(-k // 32), pm.STATS)
    np.testing.assert_allclose(
        stats[:5].numpy(), [0.0, 0.0, costs_j.min(), costs_j.max(),
                            costs_j.sum()], rtol=RTOL)


@pytest.mark.parametrize("k,block,rk,case", _cases(
    [(k, block, rk) for k, block in ((80, 32), (333, 256))
     for rk in (1, 2, 4)],
    [("dense", [(333, 256, rk) for rk in (1, 2, 4)]),
     ("upsilon1", [(80, 32, 2)])]))
def test_plain_fused_solve_matches_jax_xla(rk, k, block, case):
    """Block partials + merge == the XLA solve; k=80 over blocks of 32 and
    k=333 over 256 leave a ragged last block."""
    tau = 3
    z, eps, x0, useq = _inputs(k, tau, seed=10 + rk, case=case)
    wn_j, costs_j = _jax_solve(_jax(k, tau, rk, case=case), eps, x0, useq)
    fused = _port(k, tau, rk, case=case)
    dyn = fused.pack_dyn(_t(x0), _t(useq))
    zsum, stats = pm.merge_plain(auv.fused_solve_plain(
        fused.consts, dyn, k, tau, z=_t(z), block=block))
    np.testing.assert_allclose((fused.unfold_wnoise(zsum) / stats[1]).numpy(),
                               wn_j, rtol=1e-7, atol=1e-9 * np.abs(wn_j).max())
    np.testing.assert_allclose(
        stats[2:5].numpy(), [costs_j.min(), costs_j.max(), costs_j.sum()],
        rtol=RTOL)
    wn, info = fused.solve(_t(x0), _t(useq), z=_t(z))
    np.testing.assert_allclose(wn.numpy(), wn_j, rtol=1e-7,
                               atol=1e-9 * np.abs(wn_j).max())
    np.testing.assert_allclose(info["cost_mean"].item(), costs_j.mean(),
                               rtol=RTOL)


@pytest.mark.parametrize("rk", [2, 4])
@pytest.mark.parametrize("k", [80, 333])
def test_plain_normalized_solve_matches_jax_xla(rk, k):
    """Two-phase normalized solve (costs -> weights -> merge) == the XLA
    ``normalize_cost=True`` path."""
    tau = 3
    z, eps, x0, useq = _inputs(k, tau, seed=20 + rk)
    wn_j, costs_j = _jax_solve(_jax(k, tau, rk, normalize=True), eps, x0,
                               useq)
    fused = _port(k, tau, rk)
    wn, info = fused.solve(_t(x0), _t(useq), z=_t(z), normalize=True)
    # bounded exponent: the normalized weights are not near one-hot
    np.testing.assert_allclose(wn.numpy(), wn_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        [info["cost_min"].item(), info["cost_max"].item(),
         info["cost_mean"].item()],
        [costs_j.min(), costs_j.max(), costs_j.mean()], rtol=RTOL)
    arg = upd.norm_arg(_t(costs_j), _t(costs_j.min()), normalize=True)
    np.testing.assert_allclose(info["nabla"].item(),
                               torch.exp(-arg / LAM).sum().item(), rtol=1e-9)
    # the phases one by one
    costs, cst = fused.costs_phase(_t(x0), _t(useq), z=_t(z))
    np.testing.assert_allclose(costs.numpy(), costs_j, rtol=RTOL)
    zsum, l = fused.weights_phase(costs, cst["cost_min"], cst["cost_max"],
                                  z=_t(z))
    assert zsum.shape == (tau, 6)
    np.testing.assert_allclose((fused.unfold_wnoise(zsum) / l).numpy(), wn_j,
                               rtol=1e-9, atol=1e-12)


def test_weights_phase_all_equal_costs_is_uniform():
    """max - beta == 0: denom 1 (ops/update.norm_arg), uniform weights."""
    fused = _port(50, 2)
    z = _t(np.random.default_rng(3).normal(size=(2, 6, 50)))
    costs = torch.full((50,), 7.0, dtype=torch.float64)
    zsum, l = fused.weights_phase(costs, costs[0], costs[0], z=z)
    assert l.item() == pytest.approx(50.0)
    np.testing.assert_allclose((zsum / l).numpy(), z.mean(dim=2).numpy(),
                               rtol=1e-12)


def test_prng_mode_equals_injected_dump_on_cpu():
    """The AUV solve reads pm_mppi's Philox stream at adim 6: solving with
    (seed, solve) == solving with pm_noise_dump(seed, solve, k, tau, 6)."""
    k, tau = 300, 5
    fused = _port(k, tau, dtype=torch.float32)
    x0 = torch.zeros(13)
    x0[6] = 1.0
    useq = torch.as_tensor(50.0 * np.random.default_rng(4).normal(
        size=(tau, 6)), dtype=torch.float32)
    z = pm.pm_noise_dump(9, 4, k, tau, 6, "cpu")
    for normalize in (False, True):
        wn_a, st_a = fused.solve(x0, useq, seed=9, solve=4,
                                 normalize=normalize)
        wn_b, st_b = fused.solve(x0, useq, z=z, normalize=normalize)
        torch.testing.assert_close(wn_a, wn_b, rtol=0, atol=0)
        torch.testing.assert_close(st_a["nabla"], st_b["nabla"], rtol=0,
                                   atol=0)


def test_noise_sample_is_the_solve_noise():
    k, tau = 700, 4
    fused = _port(k, tau, dtype=torch.float32)
    eps = fused.noise_sample(seed=3, solve=8)
    z = pm.noise_plain(3, 8, k, tau, 6)
    assert eps.shape == (512, tau, 6)
    torch.testing.assert_close(
        eps, torch.einsum("ij,tjk->kti", fused._scale, z)[:512], rtol=1e-6,
        atol=1e-4)
    assert _port(100, tau, dtype=torch.float32).noise_sample(
        3, 8).shape == (100, tau, 6)


def test_pack_dyn_layout():
    k, tau = 40, 4
    fused = _port(k, tau)
    lay = auv.Dyn(tau)
    _, _, x0, useq = _inputs(k, tau)
    dyn = fused.pack_dyn(_t(x0), _t(useq))
    # ... then the waypoint blocks goal2 (13) and wblend (2), zero for the
    # static cost
    assert dyn.shape == (lay.size,) == (115 + 12 * tau,)
    np.testing.assert_array_equal(dyn[lay.goal2:].numpy(), np.zeros(15))
    with torch.no_grad():
        m_tot, inv_m = fused.model.precompute()
    np.testing.assert_array_equal(dyn[:36].numpy(), m_tot.reshape(-1))
    np.testing.assert_array_equal(dyn[36:72].numpy(), inv_m.reshape(-1))
    assert dyn[lay.mass].item() == _auv_cfg()["mass"]
    np.testing.assert_array_equal(dyn[lay.goal:lay.x0].numpy(),
                                  _task()["goal"])
    np.testing.assert_array_equal(dyn[lay.x0:lay.useq].numpy(), x0)
    np.testing.assert_array_equal(dyn[lay.useq:lay.rhs_z].numpy(),
                                  useq.ravel())
    inv_s = np.linalg.inv(SIGMA)
    np.testing.assert_allclose(
        dyn[lay.rhs_z:lay.u_half].numpy(),
        (GAMMA * useq @ inv_s.T @ (UPS * SIGMA)).ravel(), rtol=1e-12)
    np.testing.assert_allclose(
        dyn[lay.u_half].item(),
        0.5 * GAMMA * np.einsum("ti,ij,tj->", useq, inv_s, useq), rtol=1e-12)


def test_consts_packing_order():
    c = _port(10, 3, rk=4, dtype=torch.float32).consts
    p = c.packed
    assert p.dtype == np.float32 and p.shape == (260,)
    assert c.rk == 4
    np.testing.assert_allclose(p[:4], [0.1, LAM, 0.5 * LAM * (1 - 1 / UPS),
                                       c.buoyancy], rtol=1e-7)
    np.testing.assert_allclose(p[4:40], c.lin_damp.ravel())
    np.testing.assert_allclose(p[76:82], _auv_cfg()["quad_damping"],
                               rtol=1e-7)
    np.testing.assert_allclose(p[82:85], [0, 0, 0])
    np.testing.assert_allclose(p[85:88], [0, 0, 0.3], rtol=1e-7)
    np.testing.assert_allclose(p[88:124], (UPS * SIGMA).ravel(), rtol=1e-7)
    np.testing.assert_allclose(p[-100:], np.diag(_task()["Q"]).ravel())


@pytest.mark.parametrize("change,structure", [
    ("none", "diagonal"), ("linear_damping", "dense"),
    ("forward_speed_damping", "dense"), ("sigma", "dense"), ("Q", "dense"),
    ("cog", "dense"), ("bfloat16", "dense")])
def test_structure_is_diagonal_only_when_left_out_entries_are_zero(
        change, structure):
    """The rexrov2 flagship (vehicle, task, sigma 1500 I) runs the kDiag
    kernels; one nonzero entry that kDiag leaves out (an off-diagonal linear
    damping term, a forward-speed damping term, an off-diagonal sigma or Q
    term, a cog component), or the bf16 build, makes the solve dense."""
    params, task = flagship.auv_params(), flagship.auv_task()
    sigma, dtype = 1500.0 * np.eye(6), "float32"
    if change == "linear_damping":
        lin = np.diag(params["linear_damping"])
        lin[1, 0] = 1e-3
        params["linear_damping"] = lin.tolist()
    elif change == "forward_speed_damping":
        params["linear_damping_forward_speed"] = [0.0] * 5 + [1e-3]
    elif change == "sigma":
        sigma[0, 1] = sigma[1, 0] = 1.0
    elif change == "Q":
        q = np.diag(task["Q"])
        q[3, 4] = q[4, 3] = 0.5
        task = {**task, "diag": False, "Q": q.tolist()}
    elif change == "cog":
        params["cog"] = [0.0, 0.0, 0.01]
    elif change == "bfloat16":
        dtype = "bfloat16"
    model = get_model(params, dt=0.1, dtype=torch.float32)
    cost = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma,
                    dtype=torch.float32)
    fused = auv.FusedAUVMPPI(model, cost, k=10, tau=3, lam=0.5, upsilon=1.0,
                             sigma=sigma, compute_dtype=dtype)
    assert fused.consts.structure == structure
    assert fused.template_args("auv_fused_costs") == (
        2, 1, auv.COST_KINDS["static_quat"], auv.STRUCTURES[structure])


def test_cpu_wrappers_run_plain_and_count_nothing():
    before = dict(pm.launch_counts)
    fused = _port(300, 5, dtype=torch.float32)
    x0 = torch.zeros(13)
    x0[6] = 1.0
    fused.solve(x0, torch.zeros(5, 6), seed=1, solve=1)
    fused.solve(x0, torch.zeros(5, 6), seed=1, solve=1, normalize=True)
    assert pm.launch_counts == before


def test_wrappers_reject_other_devices():
    fused = _port(300, 5, dtype=torch.float32)
    c = fused.consts
    dyn = torch.empty(auv.Dyn(5).size, device="meta")
    with pytest.raises(ValueError):
        auv.auv_fused_solve(c, dyn, 300, 5)
    with pytest.raises(ValueError):
        auv.auv_fused_costs(c, dyn, 300, 5)
    with pytest.raises(ValueError):
        auv.auv_fused_solve(c, torch.zeros(auv.Dyn(5).size), 300, 5,
                            z=torch.empty(5, 6, 300, device="meta"))
    with pytest.raises(ValueError):
        pm.mppi_weights(torch.zeros(2), torch.empty(300, device="meta"),
                        5, 6)


def test_fused_rejects_ineligible():
    from mppi_tf_tpu_torch.costs import CostBase

    class OtherCost(CostBase):
        def state_cost(self, state):
            return state.sum(-1)

    model = get_model(_auv_cfg(), dt=0.1)
    cost = get_cost(_task(), lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    kw = dict(k=10, tau=3, lam=LAM, upsilon=UPS, sigma=SIGMA)
    with pytest.raises(KernelUnsupportedError):
        auv.FusedAUVMPPI(model, OtherCost(LAM, GAMMA, UPS, SIGMA), **kw)
    pm_model = get_model({"type": "point_mass"}, state_dim=6, action_dim=3)
    with pytest.raises(KernelUnsupportedError):
        auv.FusedAUVMPPI(pm_model, cost, **kw)
    with pytest.raises(KernelUnsupportedError):
        auv.FusedAUVMPPI(get_model(_auv_cfg(), action_dim=4), cost, **kw)
    pm_cost = get_cost({"type": "static", "goal": [0.0] * 13,
                        "Q": [1.0] * 13, "diag": True}, lam=LAM,
                       gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    with pytest.raises(KernelUnsupportedError):
        auv.FusedAUVMPPI(model, pm_cost, **kw)
    with pytest.raises(KernelUnsupportedError):
        pm.FusedPointMassMPPI(model, cost, **kw)


@pytest.mark.parametrize("block", [1, 32, 256])
def test_weight_partials_merge_equal_normalized_update(block):
    """Phase-B rows merged == the normalized update chain (ops/update.py)
    in f64: beta = min, denom = max - beta, w = softmax(-(c - beta) /
    (denom lam))."""
    rng = np.random.default_rng(block)
    k, n_z, lam = 700, 12, 0.7
    costs = torch.as_tensor(rng.uniform(1e3, 5e4, size=k))
    z = torch.as_tensor(rng.normal(size=(n_z, k)))
    beta, cmax = costs.min(), costs.max()
    nrm = torch.stack([beta, 1.0 / ((cmax - beta) * lam)])
    zsum, stats = pm.merge_plain(pm.weight_partials(costs, nrm, z, block))
    np.testing.assert_allclose(
        (zsum / stats[1]).numpy(),
        upd.mppi_update(costs, z.T[:, :, None], lam,
                        normalize=True)[:, 0].numpy(), rtol=1e-10,
        atol=1e-13)
    assert stats[0].item() == 0.0
    np.testing.assert_allclose(
        stats[2:5].numpy(), [costs.min(), costs.max(), costs.sum()],
        rtol=1e-12)


def test_cost_partials_merge_to_cost_stats():
    rng = np.random.default_rng(5)
    costs = torch.as_tensor(rng.uniform(-10.0, 10.0, size=513))
    rows = pm.cost_partials(costs, block=64)
    assert rows.shape == (9, pm.STATS)
    zsum, stats = pm.merge_plain(rows)
    assert zsum.shape == (0,)
    np.testing.assert_allclose(
        stats.numpy(), [0, 0, costs.min(), costs.max(), costs.sum(), 0, 0, 0],
        rtol=1e-12)
