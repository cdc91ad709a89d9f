"""The fused solves of the port with the tracking costs: the point mass
with ``WayPointsCost`` (the effective goal in ``dyn`` plus the constant
offset added back on the host) and ``ElipseCost`` (cost kind "elipse"),
the AUV with ``WayPointsQuatCost`` (two exact quadratics, blend weights in
``dyn``) and ``ElipseCost3D``. Their plain versions are held against the
JAX package's XLA path (``MPPI._solve_with_noise`` / ``_rollout``) on the
same injected normals, in both solve modes and after a pop; the JAX Pallas
kernel (interpret mode) is checked once for the waypoint offset. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

The point-mass solve object is float32 only (the kernel's type), so its
parity runs at f32 against the XLA path at f64 on f32-exact inputs; the
AUV's runs at f64 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.kernels.pm_mppi import FusedPointMassMPPI as JFused
from mppi_tf_tpu.kernels.pm_mppi import chunk_noise
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import auv_mppi as auv
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.kernels.errors import KernelUnsupportedError
from mppi_tf_tpu_torch.models import get_model
from tests.test_auv_kernel import _auv_cfg

PM_SIGMA = np.diag([0.25, 0.375, 0.25])
LAM, GAMMA, UPS = 0.8, 0.2, 1.25
# f32-exact waypoints of the 3-DoF point mass [x, vx, y, vy, z, vz]
WPS = [[0.75, 0.0, 0.0, 0.0, 0.0, 0.0],
       [0.75, 0.0, -0.625, 0.0, 0.0, 0.0],
       [0.0, 0.0, -0.625, 0.0, 0.375, 0.0]]
WP_Q = [6.0, 0.5, 6.0, 0.5, 6.0, 0.5]
ELIPSE = {"type": "elipse", "a": 2.0, "b": 1.5, "center_x": 0.25,
          "center_y": -0.25, "speed": 1.25, "m_state": 4.0, "m_vel": 0.5}
AUV_SIGMA = np.diag([40.0, 40.0, 40.0, 5.0, 5.0, 5.0])
AUV_LAM, AUV_UPS = 0.5, 1.2
Q10 = [100.0, 100.0, 100.0, 10.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
ELIPSE3D = {"type": "elipse3d", "normal": [0.0, 0.0, 1.0],
            "aVec": [1.0, 0.0, 0.0], "axis": [3.0, 2.0],
            "center": [0.5, -0.5, -4.0], "speed": 0.8, "m_state": 10.0,
            "m_vel": 1.0}

# per-sample costs: the f32 plain solve against the f64 XLA rollout on the
# same (f32-exact) inputs, rounding only; the AUV at f64 on both sides
PM_COST_RTOL, AUV_COST_RTOL = 1e-5, 1e-6
# weighted noise and stats: the JAX tests' f32 tolerance
WN_RTOL, WN_ATOL, STATS_RTOL = 2e-3, 2e-4, 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _f32(a):
    return np.asarray(a, np.float32).astype(np.float64)


def _wp_task(n):
    return {"type": "waypoints", "diag": True, "Q": WP_Q,
            "waypoints": WPS[:n], "alpha": 0.2}


def _quat_wps():
    w0 = np.zeros(13)
    w0[2], w0[6] = -5.0, 1.0
    w1 = np.zeros(13)
    w1[0], w1[2] = 3.0, -4.0
    w1[3], w1[6] = np.sin(0.3), np.cos(0.3)     # a yawed leg
    return [w0, w1]


def _quat_task():
    return {"type": "waypoints_quat", "diag": True, "Q": Q10,
            "waypoints": [w.tolist() for w in _quat_wps()], "alpha": 0.3}


def _pm(task, sdim, k, tau):
    adim = sdim // 2
    sigma = PM_SIGMA[:adim, :adim]
    mcfg = {"type": "point_mass", "mass": 1.25}
    model = get_model(mcfg, dt=0.1, state_dim=sdim, action_dim=adim)
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=sigma)
    fused = pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                  upsilon=UPS, sigma=sigma)
    jmodel = jget_model(mcfg, dt=0.1, state_dim=sdim, action_dim=adim,
                        dtype=jnp.float64)
    jcost = jget_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=sigma,
                      dtype=jnp.float64)
    return fused, cost, jmodel, jcost, sigma


def _auv(task, k, tau, dtype=torch.float64, rk=2):
    cfg = {**_auv_cfg(), "rk": rk}
    model = get_model(cfg, dt=0.1, action_dim=6, dtype=dtype)
    cost = get_cost(task, lam=AUV_LAM, gamma=GAMMA, upsilon=AUV_UPS,
                    sigma=AUV_SIGMA, dtype=dtype)
    fused = auv.FusedAUVMPPI(model, cost, k=k, tau=tau, lam=AUV_LAM,
                             upsilon=AUV_UPS, sigma=AUV_SIGMA)
    jmodel = jget_model(cfg, dt=0.1, action_dim=6, dtype=jnp.float64)
    jcost = jget_cost(task, lam=AUV_LAM, gamma=GAMMA, upsilon=AUV_UPS,
                      sigma=AUV_SIGMA, dtype=jnp.float64)
    return fused, cost, jmodel, jcost


def _inputs(k, tau, adim, x0, useq_scale, seed):
    rng = np.random.RandomState(seed)
    return (_f32(rng.randn(tau, adim, k)), _f32(x0),
            _f32(useq_scale * rng.randn(tau, adim)))


def _jax_ref(jmodel, jcost, cp, sigma, ups, lam, k, tau, z, x0, useq,
             normalize, precompute=False):
    """(weighted noise, per-sample costs) of the JAX XLA path at f64."""
    ctrl = JMPPI(jmodel, jcost, k=k, tau=tau, lam=lam, upsilon=ups,
                 sigma=sigma, normalize_cost=normalize)
    mp = ctrl.model_params
    eps = jnp.asarray(np.einsum("ij,tjk->kti", ups * sigma, z))
    _, _, info = ctrl._solve_with_noise_jit(eps, jnp.asarray(x0),
                                            jnp.asarray(useq), mp, cp)
    mp_r = jmodel.precompute(mp) if precompute else mp
    costs = ctrl._rollout(jnp.asarray(x0), jnp.asarray(useq), eps, mp_r, cp)
    return np.asarray(info["weighted_noise"]), np.asarray(costs)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float64), dtype=dtype)


def _check(fused, z, x0, useq, normalize, wn_j, costs_j, cost_rtol,
           dtype=torch.float32):
    """Port plain solve (and its phase A) against the XLA references."""
    z_t, x0_t, useq_t = _t(z, dtype), _t(x0, dtype), _t(useq, dtype)
    costs, cst = fused.costs_phase(x0_t, useq_t, z=z_t)
    np.testing.assert_allclose(costs.double().numpy(), costs_j,
                               rtol=cost_rtol)
    np.testing.assert_allclose(
        [cst["cost_min"].item(), cst["cost_max"].item(),
         cst["cost_sum"].item()],
        [costs_j.min(), costs_j.max(), costs_j.sum()], rtol=cost_rtol)
    wn, info = fused.solve(x0_t, useq_t, z=z_t, normalize=normalize)
    np.testing.assert_allclose(wn.double().numpy(), wn_j, rtol=WN_RTOL,
                               atol=WN_ATOL * max(np.abs(wn_j).max(), 1.0))
    np.testing.assert_allclose(
        [info["cost_min"].item(), info["cost_max"].item(),
         info["cost_mean"].item()],
        [costs_j.min(), costs_j.max(), costs_j.mean()], rtol=STATS_RTOL)


# ---------------------------------------------------------------------------
# point mass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_wps,normalize", [(1, False), (3, False),
                                             (1, True), (3, True)])
def test_pm_waypoints_plain_matches_jax_xla(n_wps, normalize):
    """Effective goal + offset == the XLA waypoint blend: per-sample costs,
    their stats, and the weighted noise; again after a pop."""
    k, tau = 300, 7
    fused, cost, jmodel, jcost, sigma = _pm(_wp_task(n_wps), 6, k, tau)
    z, x0, useq = _inputs(k, tau, 3, [0.25, 0.0, -0.125, 0.0, 0.375, 0.0],
                          0.1, seed=n_wps)
    cp = jcost.init_params()
    for _ in range(2):      # the queue as given, then after a pop
        wn_j, costs_j = _jax_ref(jmodel, jcost, cp, sigma, UPS, LAM, k, tau,
                                 z, x0, useq, normalize)
        _check(fused, z, x0, useq, normalize, wn_j, costs_j, PM_COST_RTOL)
        cost.pop()
        cp = jcost.pop(cp)
    assert cost.queue_length == max(n_wps - 2, 1)


def test_pm_waypoint_offset_matches_pallas_interpret():
    """The JAX Pallas kernel's own effective-goal route (interpret mode,
    tile 256) gives the same stats and weighted noise as the port's plain
    one on the same normals: the offset enters both the same way."""
    k, tau = 700, 5
    fused, _, jmodel, jcost, sigma = _pm(_wp_task(3), 6, k, tau)
    jf = JFused(jmodel, jcost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                sigma=sigma, tile=256, interpret=True)
    z, x0, useq = _inputs(k, tau, 3, np.zeros(6), 0.1, seed=9)
    zc = jnp.asarray(chunk_noise(z.astype(np.float32), 256))
    mp, cp = jmodel.init_params(), jcost.init_params()
    for normalize in (False, True):
        wn_j, st_j = jf.solve(0, x0.astype(np.float32),
                              useq.astype(np.float32), mp, cp, z=zc,
                              use_prng=False, normalize=normalize)
        wn, st = fused.solve(_t(x0), _t(useq), z=_t(z), normalize=normalize)
        np.testing.assert_allclose(wn.numpy(), np.asarray(wn_j),
                                   rtol=WN_RTOL, atol=WN_ATOL)
        for key in ("cost_min", "cost_max", "cost_mean"):
            np.testing.assert_allclose(st[key].item(), float(st_j[key]),
                                       rtol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_pm_elipse_plain_matches_jax_xla(normalize):
    k, tau = 512, 8
    fused, _, jmodel, jcost, sigma = _pm(ELIPSE, 4, k, tau)
    assert fused.consts.cost_kind == "elipse"
    z, x0, useq = _inputs(k, tau, 2, [1.75, 0.125, 0.25, 0.375], 0.1,
                          seed=7)
    wn_j, costs_j = _jax_ref(jmodel, jcost, jcost.init_params(), sigma, UPS,
                             LAM, k, tau, z, x0, useq, normalize)
    _check(fused, z, x0, useq, normalize, wn_j, costs_j, PM_COST_RTOL)


def test_pm_pack_dyn_goal_and_offset():
    """dyn's goal is (1-a) w0 + a w1 with a full queue, w0 alone with one
    waypoint; the offset is (tau+1)((1-a) q(w0) + a q(w1) - q(g)), then 0;
    the ellipse packs no goal and its seven constants."""
    tau = 4
    fused, cost, _, _, _ = _pm(_wp_task(3), 6, 10, tau)
    lay = pm.Dyn(tau, 6, 3)
    dyn = fused.pack_dyn(torch.zeros(6), torch.zeros(tau, 3))
    w0, w1 = np.asarray(WPS[0]), np.asarray(WPS[1])
    g = 0.8 * w0 + 0.2 * w1
    np.testing.assert_allclose(dyn[lay.goal:lay.bu].numpy(), g, rtol=1e-6)
    Q = np.diag(WP_Q)
    q = (lambda w: w @ Q @ w)
    np.testing.assert_allclose(fused._cost_offset().item(),
                               (tau + 1) * (0.8 * q(w0) + 0.2 * q(w1)
                                            - q(g)), rtol=1e-5)
    # derived once per queue: reused until a mutation changes the buffers
    assert fused._waypoint_terms() is fused._waypoint_terms()
    cost.set_goal(WPS[2])
    dyn = fused.pack_dyn(torch.zeros(6), torch.zeros(tau, 3))
    np.testing.assert_array_equal(dyn[lay.goal:lay.bu].numpy(),
                                  np.float32(WPS[2]))
    assert fused._cost_offset().item() == 0.0
    el, _, _, _, _ = _pm(ELIPSE, 4, 10, tau)
    dyn = el.pack_dyn(torch.zeros(4), torch.zeros(tau, 2))
    lay = pm.Dyn(tau, 4, 2)
    np.testing.assert_array_equal(dyn[lay.goal:lay.bu].numpy(), np.zeros(4))
    assert el._cost_offset() is None
    np.testing.assert_allclose(el.consts.packed[-7:],
                               [2.0, 1.5, 0.25, -0.25, 1.25, 4.0, 0.5])
    np.testing.assert_array_equal(el.consts.Q, np.zeros((4, 4)))


def test_pm_fused_accepts_and_refuses():
    kw = dict(k=10, tau=3, lam=LAM, upsilon=UPS, sigma=PM_SIGMA)
    model = get_model({"type": "point_mass"}, state_dim=6, action_dim=3)
    bad = get_cost(ELIPSE, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=PM_SIGMA)
    with pytest.raises(KernelUnsupportedError, match="4-dim"):
        pm.FusedPointMassMPPI(model, bad, **kw)
    quat = get_cost(_quat_task(), lam=LAM, gamma=GAMMA, upsilon=UPS,
                    sigma=PM_SIGMA)
    with pytest.raises(KernelUnsupportedError):
        pm.FusedPointMassMPPI(model, quat, **kw)
    # the CUDA wrapper refuses the ellipse kind at other dims
    consts = pm.PmConsts(A=np.eye(6), Bs=np.zeros((6, 3)), Q=np.eye(6),
                         Mz=np.eye(3), lam=1.0, nc_half=0.0,
                         cost_kind="elipse")
    with pytest.raises(KernelUnsupportedError, match="ellipse"):
        pm._check_solve_inputs("pm_fused_solve", consts, None, None, 10, 3)


# ---------------------------------------------------------------------------
# AUV
# ---------------------------------------------------------------------------

def _auv_x0():
    x0 = np.zeros(13)
    x0[0], x0[2], x0[6] = 2.5, -4.0, 1.0
    return x0


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("rk", [2, 4])
def test_auv_waypoints_quat_plain_matches_jax_xla(normalize, rk):
    """Two exact |dot| quadratics with blend weights (0.7, 0.3), then
    (1, 0) after a pop, against the XLA path at f64."""
    k, tau = 80, 3
    fused, cost, jmodel, jcost = _auv(_quat_task(), k, tau, rk=rk)
    z, x0, useq = _inputs(k, tau, 6, _auv_x0(), 5.0, seed=11 + rk)
    cp = jcost.init_params()
    for wb in ((0.7, 0.3), (1.0, 0.0)):
        wn_j, costs_j = _jax_ref(jmodel, jcost, cp, AUV_SIGMA, AUV_UPS,
                                 AUV_LAM, k, tau, z, x0, useq, normalize,
                                 precompute=True)
        lay = auv.Dyn(tau)
        dyn = fused.pack_dyn(_t(x0, torch.float64), _t(useq, torch.float64))
        np.testing.assert_allclose(dyn[lay.wblend:].numpy(), wb, rtol=1e-15)
        _check(fused, z, x0, useq, normalize, wn_j, costs_j, AUV_COST_RTOL,
               torch.float64)
        cost.pop()
        cp = jcost.pop(cp)


@pytest.mark.parametrize("normalize", [False, True])
def test_auv_elipse3d_plain_matches_jax_xla(normalize):
    k, tau = 64, 3
    fused, _, jmodel, jcost = _auv(ELIPSE3D, k, tau)
    assert fused.consts.cost_kind == "elipse3d"
    z, x0, useq = _inputs(k, tau, 6, _auv_x0(), 5.0, seed=4)
    wn_j, costs_j = _jax_ref(jmodel, jcost, jcost.init_params(), AUV_SIGMA,
                             AUV_UPS, AUV_LAM, k, tau, z, x0, useq,
                             normalize, precompute=True)
    _check(fused, z, x0, useq, normalize, wn_j, costs_j, AUV_COST_RTOL,
           torch.float64)


def test_auv_elipse3d_tilted_plane_state_cost():
    """The plain version's plane-frame cost (R_plane) == ElipseCost3D's
    (quaternion rotation) in a tilted plane, away from the antiparallel
    tangent."""
    task = dict(ELIPSE3D, normal=[0.0, 0.6, 0.8], aVec=[1.0, 0.0, 0.0])
    fused, cost, _, _ = _auv(task, 8, 2)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, 13))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    # near the plane normal through the center the tangent is tiny
    el = fused.consts.elipse3d
    x[0, :3] = el["center"] + el["R_plane"].T @ [0.0, 0.0, 1.5]
    e = {n: torch.tensor(np.asarray(v, np.float64))
         for n, v in fused.consts.elipse3d.items()}
    np.testing.assert_allclose(auv._elipse3d_cost(e, torch.tensor(x)).numpy(),
                               cost.state_cost(torch.tensor(x)).numpy(),
                               rtol=1e-9)
    # on the normal itself the tangent is zero: the orientation error is pi
    # (the zero quaternion's relative angle), in the plain version too
    flat, flat_cost, _, _ = _auv(ELIPSE3D, 8, 2)
    e = {n: torch.tensor(np.asarray(v, np.float64))
         for n, v in flat.consts.elipse3d.items()}
    x0 = torch.tensor(_auv_x0())[None, :]
    x0[0, :3] = torch.tensor([0.5, -0.5, -2.5])
    pos_pf = flat_cost._plane_pos(x0[:, :3])
    assert torch.all(pos_pf[0, :2] == 0.0)
    np.testing.assert_allclose(flat_cost.orientation_error(
        pos_pf, x0[:, 3:7]).item(), np.pi, rtol=1e-12)
    np.testing.assert_allclose(auv._elipse3d_cost(e, x0).item(),
                               flat_cost.state_cost(x0).item(), rtol=1e-12)


def test_auv_consts_and_dyn_for_the_new_kinds():
    tau = 4
    fused, _, _, _ = _auv(ELIPSE3D, 10, tau, torch.float32)
    p = fused.consts.packed
    assert p.shape == (260,)
    el = fused.consts.elipse3d
    np.testing.assert_allclose(p[160:169], el["R_plane"].ravel(), rtol=1e-7)
    np.testing.assert_allclose(p[169:173], el["q_plane"], rtol=1e-7)
    np.testing.assert_allclose(p[173:182], np.concatenate(
        [[0.5, -0.5, -4.0], [3.0, 2.0, 1.0], el["mapping"]]), rtol=1e-7)
    np.testing.assert_allclose(p[182:185], [0.8, 10.0, 1.0], rtol=1e-7)
    np.testing.assert_array_equal(p[185:], np.zeros(75))
    x0 = torch.zeros(13)
    x0[6] = 1.0
    dyn = fused.pack_dyn(x0, torch.zeros(tau, 6))
    lay = auv.Dyn(tau)
    np.testing.assert_array_equal(dyn[lay.goal:lay.x0].numpy(), np.zeros(13))
    np.testing.assert_array_equal(dyn[lay.goal2:].numpy(), np.zeros(15))
    wf, _, _, _ = _auv(_quat_task(), 10, tau, torch.float32)
    dyn = wf.pack_dyn(x0, torch.zeros(tau, 6))
    w0, w1 = _quat_wps()
    np.testing.assert_allclose(dyn[lay.goal:lay.x0].numpy(), w0, atol=1e-7)
    np.testing.assert_allclose(dyn[lay.goal2:lay.wblend].numpy(), w1,
                               atol=1e-7)
    np.testing.assert_allclose(dyn[lay.wblend:].numpy(), [0.7, 0.3],
                               rtol=1e-6)
    np.testing.assert_array_equal(wf.consts.packed[-100:],
                                  np.diag(Q10).ravel().astype(np.float32))


def test_auv_fused_refuses_other_costs():
    from mppi_tf_tpu_torch.kernels.nn_mppi import FusedNNMPPI
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    kw = dict(k=10, tau=3, lam=AUV_LAM, upsilon=AUV_UPS, sigma=AUV_SIGMA)
    model = get_model(_auv_cfg(), dt=0.1, action_dim=6)
    for task in (_wp_task(2), ELIPSE):
        cost = get_cost(task, lam=AUV_LAM, gamma=GAMMA, upsilon=AUV_UPS,
                        sigma=AUV_SIGMA)
        with pytest.raises(KernelUnsupportedError):
            auv.FusedAUVMPPI(model, cost, **kw)
    # the NN kernel stays StaticQuatCost-only, as in the JAX package
    for task in (_quat_task(), ELIPSE3D):
        cost = get_cost(task, lam=AUV_LAM, gamma=GAMMA, upsilon=AUV_UPS,
                        sigma=AUV_SIGMA)
        with pytest.raises(KernelUnsupportedError, match="StaticQuatCost"):
            FusedNNMPPI(NNAUVModel(hidden=(8, 8)), cost, **kw)


@pytest.mark.parametrize("task", ["waypoints", "elipse"])
def test_prng_mode_equals_injected_dump_on_cpu(task):
    """The new kinds read the same Philox stream: (seed, solve) == the
    dumped normals, in both modes; the CPU wrappers launch nothing."""
    k, tau = 300, 5
    if task == "waypoints":
        fused, _, _, _, _ = _pm(_wp_task(3), 6, k, tau)
        x0, adim = torch.zeros(6), 3
    else:
        fused, _, _, _ = _auv(ELIPSE3D, k, tau, torch.float32)
        x0, adim = torch.as_tensor(_auv_x0(), dtype=torch.float32), 6
    useq = 0.1 * torch.ones(tau, adim)
    z = pm.pm_noise_dump(9, 4, k, tau, adim, "cpu")
    before = dict(pm.launch_counts)
    for normalize in (False, True):
        wn_a, st_a = fused.solve(x0, useq, seed=9, solve=4,
                                 normalize=normalize)
        wn_b, st_b = fused.solve(x0, useq, z=z, normalize=normalize)
        torch.testing.assert_close(wn_a, wn_b, rtol=0, atol=0)
        torch.testing.assert_close(st_a["cost_min"], st_b["cost_min"],
                                   rtol=0, atol=0)
    assert pm.launch_counts == before
