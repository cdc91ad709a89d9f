"""The port's fleet (controller/fleet.py ``FleetMPPI``) against the JAX
package's (mppi_tf_tpu/controller/fleet.py), on the CPU, at small sizes
(n = 2-4 vehicles, K = 64-256, tau = 4-15), f64 unless stated; every
normal is made from a seed with numpy and injected. The tests mirror
tests/test_fleet.py: the torch route against JAX's per-vehicle solve, the
kernel route (its plain versions here) against n one-vehicle fused solves
with solve s n + v and against JAX's XLA solve on the same normals over
the option matrix, closed loops to distinct goals, re-tasking and
checkpoints, the factory, missions, validation, the on-device fleet loop
and an AUV fleet. The sharded fleet (tests/test_fleet.py:86, 246) is
held by tests/test_torch_sharded_loop.py. The kernels' vehicle axis on
the card is held by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller import FleetMPPI as JFleetMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu_torch import interop
from mppi_tf_tpu_torch.controller import MPPI, FleetMPPI, get_controller
from mppi_tf_tpu_torch.controller.fleet import vehicle_seed
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.envs import AUVEnv, DevicePointMassEnv
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.ops import noise as noise_ops

F64 = torch.float64
SIGMA = np.diag([0.4, 0.4])
LAM, GAMMA = 0.6, 0.2
Q4 = [8.0, 1.5, 8.0, 1.5]
STATIC = {"type": "static", "diag": True, "goal": [1.0, 0.0, -0.5, 0.0],
          "Q": Q4}
WAYPOINTS = {"type": "waypoints", "diag": True, "alpha": 0.2,
             "waypoints": [[0.0, 0.0, 0.0, 0.0]], "Q": Q4}
GOALS3 = np.array([[1.0, 0.0, -0.5, 0.0],
                   [-0.8, 0.0, 0.3, 0.0],
                   [0.2, 0.0, 1.1, 0.0]])
GOALS4 = np.array([[1.0, 0.0, -0.5, 0.0],
                   [-1.0, 0.0, 0.5, 0.0],
                   [0.5, 0.0, 1.0, 0.0],
                   [-0.5, 0.0, -1.0, 0.0]])
#: the torch route against JAX's XLA solve at f64 on the same normals:
#: the same ops but for each package's own reductions
F64_TOL = 1e-10
#: the kernel route's plain versions (f32 dyn, the kernels' folded algebra)
#: against JAX's XLA solve at f64 on the same normals: unnormalized, the
#: softmax exponents reach (c - c_min) / lam ~ 1e2, so an f32 cost's
#: rounding moves a weight by ~1e-5 of itself and a sequence entry by up
#: to ~3e-6 of the 0.4-scale noise it averages
F32_RTOL, F32_ATOL = 1e-4, 1e-5
#: the AUV vehicles' quaternion waypoints and Q (tests/test_fleet.py)
AUV_Q = [60.0, 60.0, 60.0, 10.0] + [1.0] * 6
AUV_SIGMA = np.diag([2000.0] * 3 + [200.0] * 3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _family(task=STATIC, dtype=F64):
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=4, action_dim=2, dtype=dtype)
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=SIGMA,
                    dtype=dtype)
    return model, cost


def _jfamily(task=STATIC, dtype=jnp.float64):
    model = jget_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                       state_dim=4, action_dim=2, dtype=dtype)
    cost = jget_cost(task, lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=SIGMA,
                     dtype=dtype)
    return model, cost


def _fleet(n, k, tau, task=STATIC, dtype=F64, kernel=False, **kw):
    """A CPU fleet; ``kernel``: on the kernel route (the fused solve
    objects, whose wrappers run their plain versions on the CPU)."""
    model, cost = _family(task, dtype)
    fleet = FleetMPPI(model, cost, n_vehicles=n, k=k, tau=tau, lam=LAM,
                      upsilon=1.0, sigma=SIGMA, device="cpu", **kw)
    if kernel:
        fleet._tpl._resolve_kernel("auto", SIGMA, None)
        assert (fleet._tpl.kernel_path == "cuda"
                and fleet._tpl._fused is not None)
    return fleet


def _jcp(jfleet, v):
    return jax.tree.map(lambda x: x[v], jfleet._cparams)


# ---- the torch route against JAX's per-vehicle solve --------------------------

def test_torch_route_matches_jax_per_vehicle_solve(monkeypatch):
    """fleet.next on the torch route, each vehicle's noise injected in
    the order the route draws it, == JAX's template solve of each vehicle
    with its own cparams, 3 steps in lockstep (actions and sequences)."""
    n, k, tau = 3, 64, 6
    fleet = _fleet(n, k, tau, goals=GOALS3, seed=4)
    jm, jc = _jfamily()
    jfleet = JFleetMPPI(jm, jc, n_vehicles=n, k=k, tau=tau, lam=LAM,
                        upsilon=1.0, sigma=SIGMA, goals=GOALS3, seed=4,
                        kernel="xla")
    steps = 3
    eps = np.random.default_rng(0).standard_normal((steps, n, k, tau, 2)) \
        @ SIGMA.T
    draws = iter(torch.as_tensor(eps.reshape(steps * n, k, tau, 2)))
    monkeypatch.setattr(noise_ops, "sample_noise",
                        lambda *a, **kw: next(draws))
    states = np.random.default_rng(1).normal(size=(n, 4))
    useq = [jnp.zeros((tau, 2), jnp.float64)] * n
    for s in range(steps):
        actions = fleet.next(states)
        outs = [jfleet._tpl._solve_with_noise(
            jnp.asarray(eps[s, v]), jnp.asarray(states[v]), useq[v],
            jfleet._mparams, _jcp(jfleet, v)) for v in range(n)]
        useq = [o[1] for o in outs]
        np.testing.assert_allclose(actions, np.stack([o[0] for o in outs]),
                                   rtol=0, atol=F64_TOL)
        np.testing.assert_allclose(fleet.useq.numpy(), np.stack(useq),
                                   rtol=0, atol=F64_TOL)


def test_torch_route_matches_independent_controllers():
    """The torch-route fleet == n independent port controllers drawing
    from generators seeded as the fleet's vehicles (vehicle_seed)."""
    n, k, tau = 3, 64, 6
    fleet = _fleet(n, k, tau, goals=GOALS3, seed=4)
    singles = []
    for v in range(n):
        model, cost = _family()
        c = MPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=1.0,
                 sigma=SIGMA, device="cpu")
        c._gen.manual_seed(vehicle_seed(4, v))
        c.set_goal(GOALS3[v])
        singles.append(c)
    states = np.random.default_rng(0).normal(size=(n, 4))
    for _ in range(3):
        a = fleet.next(states)
        np.testing.assert_array_equal(
            a, np.stack([c.next(states[v]) for v, c in enumerate(singles)]))
        for v, c in enumerate(singles):
            assert torch.equal(fleet.useq[v], c.useq)


# ---- the kernel route ---------------------------------------------------------

OPTIONS = [{}, {"normalize_cost": True}, {"antithetic": True},
           {"normalize_cost": True, "clip_actions": True, "filter_seq": True,
            "filter_window": 5}]


@pytest.mark.parametrize("options", OPTIONS,
                         ids=["plain", "normalize", "antithetic", "all"])
def test_kernel_route_matches_single_fused_solves(options):
    """Fleet step s of the kernel route (one launch a kernel for the whole
    fleet; here the plain versions) == n one-vehicle fused solves with the
    solve index s n + v, bit for bit, over JAX's option matrix; the info
    is [n]-leading with the keys tests/test_fleet.py:187 pins."""
    n, k, tau = 3, 64, 5
    fleet = _fleet(n, k, tau, dtype=torch.float32, kernel=True,
                   goals=GOALS3, seed=11, **options)
    singles = []
    for v in range(n):
        model, cost = _family(dtype=torch.float32)
        c = MPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=1.0,
                 sigma=SIGMA, seed=11, device="cpu", **options)
        c._resolve_kernel("auto", SIGMA, None)
        c.set_goal(GOALS3[v])
        singles.append(c)
    states = np.random.default_rng(2).normal(size=(n, 4))
    useq = [c.useq for c in singles]
    for s in range(2):
        a = fleet.next(states)
        for v, c in enumerate(singles):
            act, useq[v], _ = c._fused_step(
                torch.as_tensor(states[v], dtype=torch.float32), useq[v],
                solve=s * n + v)
            np.testing.assert_array_equal(a[v], act.numpy())
            assert torch.equal(fleet.useq[v], useq[v])
    info = fleet._last_info
    for key in ("cost_min", "cost_mean", "cost_max"):
        assert info[key].shape == (n,)
    assert info["weighted_noise"].shape == (n, tau, 2)
    assert info["useq"].shape == (n, tau, 2)


@pytest.mark.parametrize("options", OPTIONS,
                         ids=["plain", "normalize", "antithetic", "all"])
def test_kernel_route_matches_jax_xla_on_injected_normals(options):
    """The kernel route's fleet solve (plain versions, f32) on injected
    normals z [n, tau, 2, k] == JAX's XLA template solve of each vehicle
    on eps = scale z (f64, on the same f32 inputs), within f32
    tolerance."""
    n, k, tau = 3, 128, 5
    fleet = _fleet(n, k, tau, dtype=torch.float32, kernel=True,
                   goals=GOALS3, seed=11, **options)
    jm, jc = _jfamily()
    jfleet = JFleetMPPI(jm, jc, n_vehicles=n, k=k, tau=tau, lam=LAM,
                        upsilon=1.0, sigma=SIGMA, goals=GOALS3, seed=11,
                        kernel="xla", **options)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((n, tau, 2, k)).astype(np.float32)
    states = rng.normal(size=(n, 4)).astype(np.float32)
    useq = (0.1 * rng.normal(size=(n, tau, 2))).astype(np.float32)
    tpl = fleet._tpl
    wnoise, info = tpl._fused.solve(
        torch.as_tensor(states), torch.as_tensor(useq), z=torch.as_tensor(z),
        normalize=tpl._normalize_cost, cp=fleet.cost_params)
    actions, shifted, _ = tpl._postprocess(torch.as_tensor(useq), wnoise)
    for v in range(n):
        eps = jnp.asarray(np.einsum("ij,tjk->kti", SIGMA, z[v]))
        ja, jshift, jinfo = jfleet._tpl._solve_with_noise(
            eps, jnp.asarray(states[v], jnp.float64),
            jnp.asarray(useq[v], jnp.float64), jfleet._mparams,
            _jcp(jfleet, v))
        np.testing.assert_allclose(actions[v].numpy(), np.asarray(ja),
                                   rtol=F32_RTOL, atol=F32_ATOL)
        np.testing.assert_allclose(shifted[v].numpy(), np.asarray(jshift),
                                   rtol=F32_RTOL, atol=F32_ATOL)
        np.testing.assert_allclose(info["cost_min"][v].item(),
                                   float(jinfo["cost_min"]), rtol=F32_RTOL)


def test_wrappers_take_the_vehicle_axis():
    """Each wrapper with a vehicle axis (plain versions): a fleet call ==
    n one-vehicle calls with solve s n + v, bit for bit, for the solve,
    the costs, phase B and the merge, injected z and Philox."""
    n, k, tau, s = 3, 300, 4, 5
    fleet = _fleet(n, k, tau, dtype=torch.float32, kernel=True,
                   goals=GOALS3)
    fused = fleet._tpl._fused
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32)
    u = torch.as_tensor(0.1 * rng.normal(size=(n, tau, 2)),
                        dtype=torch.float32)
    dyn = fused.pack_dyn(x, u, fleet.cost_params)
    assert dyn.shape == (n, pm.Dyn(tau, 4, 2).size)
    z = torch.as_tensor(rng.standard_normal((n, tau, 2, k)),
                        dtype=torch.float32)
    for zz in (None, z):
        part = pm.pm_fused_solve(fused.consts, dyn, k, tau, seed=9, solve=s,
                                 z=zz)
        costs, rows = pm.pm_fused_costs(fused.consts, dyn, k, tau, seed=9,
                                        solve=s, z=zz)
        nrm = torch.stack([costs.min(1).values,
                           1.0 / (costs.max(1).values - costs.min(1).values)],
                          dim=-1)
        wrows = pm.mppi_weights(nrm, costs, tau, 2, seed=9, solve=s, z=zz)
        zsum, stats = pm.pm_merge(part)
        for v in range(n):
            kw = dict(seed=9, solve=s * n + v,
                      z=None if zz is None else zz[v])
            assert torch.equal(part[v], pm.pm_fused_solve(
                fused.consts, dyn[v], k, tau, **kw))
            c1, r1 = pm.pm_fused_costs(fused.consts, dyn[v], k, tau, **kw)
            assert torch.equal(costs[v], c1) and torch.equal(rows[v], r1)
            assert torch.equal(wrows[v], pm.mppi_weights(nrm[v], costs[v],
                                                         tau, 2, **kw))
            zs1, st1 = pm.pm_merge(part[v])
            assert torch.equal(zsum[v], zs1) and torch.equal(stats[v], st1)


def test_fleet_pack_equals_single_packs():
    """The fleet's dyn rows (stacked cost params) == each vehicle's own
    pack_dyn, bit for bit, for a goal and for a waypoint blend."""
    n, tau = 3, 6
    for task in (STATIC, WAYPOINTS):
        fleet = _fleet(n, 64, tau, task=task, dtype=torch.float32,
                       kernel=True, goals=GOALS3)
        if task is WAYPOINTS:
            fleet.set_vehicle_waypoints(1, [[0.8, 0.0, 0.0, 0.0],
                                            [0.8, 0.0, 0.8, 0.0]])
        fused = fleet._tpl._fused
        rng = np.random.default_rng(5)
        x = torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32)
        u = torch.as_tensor(rng.normal(size=(n, tau, 2)),
                            dtype=torch.float32)
        dyn = fused.pack_dyn(x, u, fleet.cost_params)
        off = fused._cost_offset(fleet.cost_params)
        for v in range(n):
            model, cost = _family(task, torch.float32)
            c = MPPI(model, cost, k=64, tau=tau, lam=LAM, upsilon=1.0,
                     sigma=SIGMA, device="cpu")
            c._resolve_kernel("auto", SIGMA, None)
            interop.from_jax_params(
                {"mass": 1.0}, {name: t[v].numpy() for name, t in
                                fleet.cost_params.items()}, model, cost)
            assert torch.equal(dyn[v], c._fused.pack_dyn(x[v], u[v]))
            if off is not None:
                assert torch.equal(off[v], c._fused._cost_offset())


# ---- closed loops -------------------------------------------------------------

@pytest.mark.parametrize("kernel", [False, True], ids=["torch", "kernel"])
def test_closed_loop_distinct_goals(kernel):
    """Every vehicle converges to its own goal (tests/test_fleet.py:63)."""
    n = 4
    fleet = _fleet(n, 256, 15, dtype=torch.float32 if kernel else F64,
                   kernel=kernel, goals=GOALS4, seed=2)
    model = fleet._model
    states = torch.zeros(n, 4, dtype=model.dtype)
    for _ in range(60):
        actions = fleet.next(states.numpy())
        with torch.no_grad():
            states = model.step(states, torch.as_tensor(actions,
                                                        dtype=model.dtype))
    err = np.linalg.norm(states.numpy()[:, 0::2] - GOALS4[:, 0::2], axis=1)
    assert np.all(err < 0.25), err
    assert fleet._last_info["cost_min"].shape == (n,)


def test_retasking_and_checkpoint(tmp_path):
    """set_goals / set_vehicle_goal write the stacked params in place;
    save_state / load_state resume the whole fleet bit for bit
    (tests/test_fleet.py:118)."""
    n = 3
    fleet = _fleet(n, 64, 5, seed=7)
    states = np.zeros((n, 4))
    fleet.next(states)
    goal_t = fleet.cost_params["goal"]
    new_goals = np.array([[0.3, 0.0, 0.3, 0.0]] * n)
    fleet.set_goals(new_goals)
    fleet.set_vehicle_goal(1, [0.9, 0.0, -0.9, 0.0])
    assert fleet.cost_params["goal"] is goal_t      # in place
    np.testing.assert_allclose(goal_t[1].numpy(), [0.9, 0.0, -0.9, 0.0])
    np.testing.assert_allclose(goal_t[0].numpy(), [0.3, 0.0, 0.3, 0.0])
    # the cost's own goal is untouched by the fleet's rows
    np.testing.assert_allclose(fleet._cost.goal.numpy(), STATIC["goal"])
    fleet.next(states)

    path = str(tmp_path / "fleet_state.npz")
    fleet.save_state(path)
    expected = fleet.next(states)
    resumed = _fleet(n, 64, 5, seed=0)
    resumed.load_state(path)
    np.testing.assert_array_equal(resumed.next(states), expected)
    assert resumed.timing["calls"] == 3

    with pytest.raises(IndexError):
        fleet.set_vehicle_goal(99, [0.0] * 4)
    with pytest.raises(ValueError, match="one row per vehicle"):
        fleet.set_goals(np.zeros((n + 1, 4)))


def test_model_params_and_interop_with_jax_fleet():
    """model_params get / set, and the JAX fleet's stacked cparams and
    model params through interop, in both directions."""
    n = 3
    fleet = _fleet(n, 32, 4, goals=GOALS3)
    jm, jc = _jfamily()
    jfleet = JFleetMPPI(jm, jc, n_vehicles=n, k=32, tau=4, lam=LAM,
                        upsilon=1.0, sigma=SIGMA, goals=GOALS3[::-1].copy(),
                        kernel="xla")
    mp = {"mass": np.asarray(2.0)}
    interop.from_jax_params(mp, jax.tree.map(np.asarray, jfleet._cparams),
                            fleet._model, fleet)
    np.testing.assert_array_equal(fleet.cost_params["goal"].numpy(),
                                  GOALS3[::-1])
    assert float(fleet.model_params["mass"]) == 2.0
    fleet.model_params = {"mass": 1.5}
    assert float(fleet._model.mass) == 1.5
    _, cp = interop.to_jax_params(fleet._model, fleet)
    np.testing.assert_array_equal(cp["goal"], GOALS3[::-1])


def test_factory_dispatch():
    """get_controller builds a FleetMPPI from the 'fleet' key with the
    per-vehicle 'goals'; DMD models and observers are refused
    (tests/test_fleet.py:311)."""
    from mppi_tf_tpu_torch.models.dmd import DMDModel

    model, cost = _family()
    cfg = {"samples": 64, "horizon": 5, "lambda": LAM, "upsilon": 1.0,
           "noise": SIGMA.tolist(), "fleet": 3, "goals": GOALS3.tolist()}
    fleet = get_controller(model, cost, cfg, device="cpu")
    assert isinstance(fleet, FleetMPPI) and fleet.n_vehicles == 3
    a = fleet.next(np.zeros((3, 4)))
    assert a.shape == (3, 2) and np.all(np.isfinite(a))
    np.testing.assert_allclose(fleet.cost_params["goal"][1].numpy(),
                               GOALS3[1])
    with pytest.raises(ValueError, match="DMD"):
        get_controller(DMDModel(4, 2), cost, cfg, device="cpu")
    with pytest.raises(ValueError, match="observer"):
        get_controller(model, cost, cfg, observer=object(), device="cpu")
    # a mesh (ROADMAP item 14) splits the fleet over its shards
    from mppi_tf_tpu_torch.parallel import make_mesh

    sharded = get_controller(model, cost, cfg,
                             mesh=make_mesh(devices=["cpu"] * 3))
    assert isinstance(sharded, FleetMPPI) and sharded.kernel_path == "torch"
    np.testing.assert_array_equal(sharded.next(np.zeros((3, 4))), a)


def test_validates_construction():
    """tests/test_fleet.py:442."""
    model, cost = _family()
    kw = dict(k=8, tau=3, lam=LAM, upsilon=1.0, sigma=SIGMA, device="cpu")
    with pytest.raises(ValueError, match="n_vehicles"):
        FleetMPPI(model, cost, n_vehicles=0, **kw)
    with pytest.raises(ValueError, match="one row per vehicle"):
        FleetMPPI(model, cost, n_vehicles=2, goals=np.zeros((3, 4)), **kw)
    with pytest.raises(ValueError, match="init_seq"):
        FleetMPPI(model, cost, n_vehicles=2, init_seq=np.zeros((5, 2, 7)),
                  **kw)
    shared = FleetMPPI(model, cost, n_vehicles=2,
                       init_seq=np.ones((3, 2)), **kw)
    assert shared.useq.shape == (2, 3, 2)
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="GPU"):
            FleetMPPI(model, cost, n_vehicles=2, k=8, tau=3, lam=LAM,
                      upsilon=1.0, sigma=SIGMA)


# ---- missions -----------------------------------------------------------------

MISSIONS = [[[0.8, 0.0, 0.0, 0.0], [0.8, 0.0, 0.8, 0.0]],
            [[-0.8, 0.0, 0.0, 0.0], [-0.8, 0.0, -0.8, 0.0]]]


@pytest.mark.parametrize("kernel", [False, True], ids=["torch", "kernel"])
def test_waypoint_missions(kernel):
    """Each vehicle flies its own queue; advance_waypoints pops queues
    independently (tests/test_fleet.py:341)."""
    n = 2
    fleet = _fleet(n, 256, 15, task=WAYPOINTS, kernel=kernel,
                   dtype=torch.float32 if kernel else F64, seed=2)
    for v, m in enumerate(MISSIONS):
        fleet.set_vehicle_waypoints(v, m)
    np.testing.assert_array_equal(fleet.waypoints_remaining(), [2, 2])
    model = fleet._model
    states = np.zeros((n, 4))
    popped_at = [None] * n
    for t in range(100):
        actions = fleet.next(states)
        with torch.no_grad():
            states = model.step(torch.as_tensor(states, dtype=model.dtype),
                                torch.as_tensor(actions, dtype=model.dtype)
                                ).double().numpy()
        if fleet.advance_waypoints(states, radius=0.35):
            for v in range(n):
                if popped_at[v] is None and \
                        fleet.waypoints_remaining()[v] == 1:
                    popped_at[v] = t
    assert all(p is not None for p in popped_at), popped_at
    finals = np.array([m[-1] for m in MISSIONS])
    err = np.linalg.norm(states[:, 0::2] - finals[:, 0::2], axis=1)
    assert np.all(err < 0.3), (err, states)

    with pytest.raises(IndexError):
        fleet.set_vehicle_waypoints(9, MISSIONS[0])
    with pytest.raises(ValueError, match="non-empty"):
        fleet.set_vehicle_waypoints(0, [])
    plain = _fleet(2, 16, 3)
    with pytest.raises(TypeError, match="WayPointsCost"):
        plain.advance_waypoints(np.zeros((2, 4)), 0.1)
    with pytest.raises(TypeError, match="WayPointsCost"):
        plain.set_vehicle_waypoints(0, MISSIONS[0])
    with pytest.raises(TypeError, match="WayPointsCost"):
        plain.waypoints_remaining()


def test_advance_waypoints_matches_jax():
    """One batched pop over the fleet == the JAX fleet's on the same
    queues and states."""
    n = 3
    fleet = _fleet(n, 16, 3, task=WAYPOINTS)
    jm, jc = _jfamily(WAYPOINTS)
    jfleet = JFleetMPPI(jm, jc, n_vehicles=n, k=16, tau=3, lam=LAM,
                        upsilon=1.0, sigma=SIGMA, kernel="xla")
    for v, m in enumerate(MISSIONS + [[[0.1, 0.0, 0.1, 0.0]]]):
        fleet.set_vehicle_waypoints(v, m)
        jfleet.set_vehicle_waypoints(v, m)
    states = np.array([[0.75, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                       [0.1, 0.0, 0.1, 0.0]])
    assert fleet.advance_waypoints(states, 0.2) == \
        jfleet.advance_waypoints(states, 0.2) == 1
    for name, t in fleet.cost_params.items():
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(jfleet._cparams[name]))


def _auv(task):
    from tests.test_auv_kernel import _auv_cfg

    model = get_model(_auv_cfg(), dt=0.1, action_dim=6, dtype=F64)
    cost = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.0, sigma=AUV_SIGMA,
                    dtype=F64)
    return model, cost


def _quat_task(alpha=0.2):
    wp = np.zeros(13)
    wp[2], wp[6] = -1.0, 1.0
    return wp, {"type": "waypoints_quat", "diag": True, "alpha": alpha,
                "waypoints": [wp.tolist()], "Q": AUV_Q}


def test_quat_waypoint_missions():
    """13-dim AUVs with per-vehicle quaternion queues; the pop measures
    attitude (a vehicle rotated 180 deg on its waypoint does not pop;
    tests/test_fleet.py:455)."""
    wp, task = _quat_task()
    model, cost = _auv(task)
    fleet = FleetMPPI(model, cost, n_vehicles=2, k=64, tau=4, lam=0.5,
                      upsilon=1.0, sigma=AUV_SIGMA, seed=2, device="cpu")
    wp_b, deeper = wp.copy(), wp.copy()
    wp_b[0], deeper[2] = 2.0, -2.0
    fleet.set_vehicle_waypoints(0, [wp, deeper])
    fleet.set_vehicle_waypoints(1, [wp_b, deeper])
    np.testing.assert_array_equal(fleet.waypoints_remaining(), [2, 2])
    states = np.zeros((2, 13))
    states[:, 6] = 1.0
    actions = fleet.next(states)
    assert actions.shape == (2, 6) and np.all(np.isfinite(actions))
    states[0], states[1] = wp, wp_b
    states[1, 3:7] = [0.0, 0.0, 1.0, 0.0]
    assert fleet.advance_waypoints(states, radius=0.5) == 1
    np.testing.assert_array_equal(fleet.waypoints_remaining(), [1, 2])


def test_goal_surfaces_validate_quat_waypoints():
    """Every goal row is validated before any is applied
    (tests/test_fleet.py:498)."""
    wp, task = _quat_task()
    model, cost = _auv(task)
    kw = dict(k=16, tau=3, lam=0.5, upsilon=1.0, sigma=AUV_SIGMA,
              device="cpu")
    bad = np.zeros((2, 13))
    with pytest.raises(ValueError, match="unit"):
        FleetMPPI(model, cost, n_vehicles=2, goals=bad, **kw)
    fleet = FleetMPPI(model, cost, n_vehicles=2, **kw)
    with pytest.raises(ValueError, match="unit"):
        fleet.set_goals(bad)
    good = np.stack([wp, wp])
    good[:, 3:7] *= 1.0 + 5e-4
    fleet.set_goals(good)
    q = fleet.cost_params["waypoints"][:, 0, 3:7].numpy()
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-12)


def test_fused_quat_missions_match_single_fused_solves():
    """The AUV kernel route over per-vehicle quaternion queues (plain
    versions, f32) == one-vehicle fused solves with solve s n + v and the
    same missions, before and after a pop (tests/test_fleet.py:533)."""
    from tests.test_auv_kernel import _auv_cfg

    sigma = np.diag([40.0] * 3 + [5.0] * 3)
    wp_a1, _ = _quat_task(0.25)
    wp_a2 = wp_a1.copy()
    wp_a2[2] = -2.0
    wp_b1 = np.zeros(13)
    wp_b1[0], wp_b1[2] = 2.0, -1.0
    wp_b1[3], wp_b1[6] = np.sin(0.3), np.cos(0.3)
    missions = [[wp_a1, wp_a2], [wp_b1, wp_a2]]
    _, task = _quat_task(0.25)

    def build(**kw):
        model = get_model(_auv_cfg(), dt=0.1, action_dim=6)
        cost = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma)
        return model, cost

    n, k, tau = 2, 32, 2
    fleet = FleetMPPI(*build(), n_vehicles=n, k=k, tau=tau, lam=0.5,
                      upsilon=1.0, sigma=sigma, seed=7, device="cpu")
    fleet._tpl._resolve_kernel("auto", sigma, None)
    assert (fleet._tpl.kernel_path == "cuda"
            and fleet._tpl._fused is not None)
    for v, m in enumerate(missions):
        fleet.set_vehicle_waypoints(v, m)
    singles = []
    for v in range(n):
        s = MPPI(*build(), k=k, tau=tau, lam=0.5, upsilon=1.0, sigma=sigma,
                 seed=7, device="cpu")
        s._resolve_kernel("auto", sigma, None)
        s.set_waypoints(missions[v])
        singles.append(s)
    states = np.zeros((n, 13))
    states[:, 6] = 1.0
    for step in range(2):
        if step:
            states[0] = wp_a1
            assert fleet.advance_waypoints(states, radius=0.5) == 1
            assert singles[0].advance_waypoints(states[0], radius=0.5)
        a = fleet.next(states)
        for v, s in enumerate(singles):
            act, s._useq, _ = s._fused_step(
                torch.as_tensor(states[v], dtype=torch.float32), s._useq,
                solve=step * n + v)
            np.testing.assert_array_equal(a[v], act.numpy())


# ---- the on-device fleet loop -------------------------------------------------

@pytest.mark.parametrize("kernel", [False, True], ids=["torch", "kernel"])
def test_on_device_loop_with_retask(kernel):
    """N closed loops with distinct goals as one period a step; re-task
    one vehicle and run again: it reaches the new goal
    (tests/test_fleet.py:216); the run's periods continue the fleet's step
    count, and eager equals the run on the CPU."""
    n = 4
    fleet = _fleet(n, 256, 15, kernel=kernel, goals=GOALS4, seed=3,
                   dtype=torch.float32 if kernel else F64)
    env = DevicePointMassEnv(n_dof=2, dt=0.01,
                             dtype=torch.float32 if kernel else F64)
    run = fleet.build_on_device_loop(env.step_fn, steps=60, substeps=10)
    states, actions = run(np.zeros((n, 4)))
    assert states.shape == (60, n, 4) and actions.shape == (60, n, 2)
    err = np.linalg.norm(states[-1, :, 0::2].numpy() - GOALS4[:, 0::2],
                         axis=1)
    assert np.all(err < 0.25), err
    assert fleet._steps == 60
    fleet.set_vehicle_goal(0, [-0.7, 0.0, 0.7, 0.0])
    states2, _ = run(np.zeros((n, 4)))
    err0 = np.linalg.norm(states2[-1, 0, 0::2].numpy() - [-0.7, 0.7])
    assert err0 < 0.25, err0
    if kernel:   # the kernel route's noise is the solve index's alone
        again, _ = run.eager(np.zeros((n, 4)), step0=60)
        assert torch.equal(again, states2)


def test_on_device_loop_matches_host_steps():
    """Period j of the loop == host next() at step j with the plant
    stepped on the host (kernel route, plain versions: the noise is the
    solve index's)."""
    n, steps = 3, 5
    env = DevicePointMassEnv(n_dof=2, dt=0.01, dtype=torch.float32)
    a = _fleet(n, 64, 6, dtype=torch.float32, kernel=True, goals=GOALS3)
    b = _fleet(n, 64, 6, dtype=torch.float32, kernel=True, goals=GOALS3)
    states, actions = a.build_on_device_loop(env.step_fn, steps, 3)(
        np.zeros((n, 4)))
    x = torch.zeros(n, 4)
    for j in range(steps):
        u = torch.as_tensor(b.next(x.numpy()))
        assert torch.equal(u, actions[j])
        for _ in range(3):
            x = env.step_fn(x, u)
        assert torch.equal(x, states[j])


def test_on_device_waypoint_missions():
    """Per-vehicle pops inside the period; the final queues sync back to
    the fleet, an explicit cparams run leaves them (JAX
    tests/test_fleet.py:398)."""
    n = 2
    fleet = _fleet(n, 256, 15, task=WAYPOINTS, seed=2)
    for v, m in enumerate(MISSIONS):
        fleet.set_vehicle_waypoints(v, m)
    env = DevicePointMassEnv(n_dof=2, dt=0.01, dtype=F64)
    run = fleet.build_on_device_loop(env.step_fn, steps=100, substeps=10,
                                     waypoint_radius=0.35)
    before = {name: t.clone() for name, t in fleet.cost_params.items()}
    run(np.zeros((n, 4)), cparams=before)
    for name, t in fleet.cost_params.items():
        assert torch.equal(t, before[name])
    states, _ = run(np.zeros((n, 4)))
    np.testing.assert_array_equal(fleet.waypoints_remaining(), [1, 1])
    finals = np.array([m[-1] for m in MISSIONS])
    err = np.linalg.norm(states[-1, :, 0::2].numpy() - finals[:, 0::2],
                         axis=1)
    assert np.all(err < 0.3), err
    plain = _fleet(2, 16, 3)
    with pytest.raises(TypeError, match="WayPointsCost"):
        plain.build_on_device_loop(env.step_fn, steps=2,
                                   waypoint_radius=0.1)


def test_batched_plants_equal_single_steps():
    """The plants' step_fn over a fleet [n, sdim] == n single steps, bit
    for bit (the point mass; the AUV to f64 rounding of its batched
    products)."""
    from tests.test_auv_kernel import _auv_cfg

    rng = np.random.default_rng(6)
    env = DevicePointMassEnv(n_dof=2, dt=0.01, dtype=F64)
    x, u = torch.as_tensor(rng.normal(size=(3, 4))), torch.as_tensor(
        rng.normal(size=(3, 2)))
    xb = env.step_fn(x, u)
    for v in range(3):
        assert torch.equal(xb[v], env.step_fn(x[v], u[v]))
    auv = AUVEnv(_auv_cfg(), dt=0.02)
    x = torch.as_tensor(rng.normal(size=(3, 13)))
    x[:, 3:7] /= torch.linalg.vector_norm(x[:, 3:7], dim=1, keepdim=True)
    u = torch.as_tensor(100.0 * rng.normal(size=(3, 6)))
    xb = auv.step_fn(x, u)
    for v in range(3):
        np.testing.assert_allclose(xb[v].numpy(),
                                   auv.step_fn(x[v], u[v]).numpy(),
                                   rtol=1e-14, atol=1e-14)


def test_auv_fleet_dives_and_rises():
    """A fleet of full-Fossen AUVs with opposite depth setpoints
    (tests/test_fleet.py:260): host-driven it equals two independent
    controllers; through the on-device loop each heads for its own goal,
    |q| = 1 within 1e-3. Normalized, as the port's one-vehicle AUV loop
    (tests/test_torch_on_device.py): unnormalized, this untuned setup ends
    anywhere from -0.3 to 2 in both packages, stream by stream."""
    from tests.test_auv_kernel import _auv_cfg

    goal = np.zeros(13)
    goal[6] = 1.0
    task = {"type": "static_quat", "diag": True, "goal": goal.tolist(),
            "Q": AUV_Q}
    goals = np.tile(goal, (2, 1))
    goals[0, 2], goals[1, 2] = -1.0, 1.0
    kw = dict(k=256, tau=15, lam=0.5, upsilon=1.0, sigma=AUV_SIGMA,
              normalize_cost=True, device="cpu")
    env = AUVEnv(_auv_cfg(), dt=0.02)
    x0 = np.zeros((2, 13))
    x0[:, 6] = 1.0

    fleet = FleetMPPI(*_auv(task), n_vehicles=2, goals=goals, seed=3, **kw)
    singles = []
    for v in range(2):
        c = MPPI(*_auv(task), **kw)
        c._gen.manual_seed(vehicle_seed(3, v))
        c.set_goal(goals[v])
        singles.append(c)
    for _ in range(2):
        np.testing.assert_array_equal(
            fleet.next(x0), np.stack([c.next(x0[v])
                                      for v, c in enumerate(singles)]))

    fleet = FleetMPPI(*_auv(task), n_vehicles=2, goals=goals, seed=3, **kw)
    run = fleet.build_on_device_loop(env.step_fn, steps=80, substeps=5)
    states, _ = run(x0)
    states = states.numpy()
    np.testing.assert_allclose(np.linalg.norm(states[:, :, 3:7], axis=-1),
                               1.0, atol=1e-3)
    assert states[-1, 0, 2] < -0.3, states[::10, 0, 2]
    assert states[-1, 1, 2] > 0.3, states[::10, 1, 2]
