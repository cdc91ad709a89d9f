"""The port's mission surface (controller/missions.py on MPPI, the runner's
waypoint advancement) against the JAX package's: set / advance / remaining,
the attitude-aware pop, a partly flown mission through a checkpoint and
through ``interop``, a 3-leg mission flown by both packages on the same
injected noise, and the config-driven runner."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller import MPPI as JMPPI
from mppi_tf_tpu.costs.waypoints import WayPointsCost as JWayPointsCost
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.controller.missions import (mission_params,
                                                   validate_mission)
from mppi_tf_tpu_torch.costs import WayPointsCost, get_cost
from mppi_tf_tpu_torch.envs import run_experiment
from mppi_tf_tpu_torch.interop import from_jax_params, to_jax_params
from mppi_tf_tpu_torch.models import get_model
from tests.test_auv_kernel import _auv_cfg

WP1 = [0.8, 0.0, 0.0, 0.0]    # interleaved [x, vx, y, vy]
WP2 = [0.8, 0.0, -0.7, 0.0]
WP3 = [0.0, 0.0, -0.7, 0.0]
SIGMA = np.diag([0.4, 0.4])
Q4 = np.array([6.0, 0.6, 6.0, 0.6])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _controller(max_waypoints=8, k=300, tau=12, dtype=torch.float32):
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=4, action_dim=2, dtype=dtype)
    cost = WayPointsCost(0.4, 0.1, 1.0, SIGMA, Q=Q4, diag=True,
                         waypoints=[WP1], max_waypoints=max_waypoints,
                         dtype=dtype)
    ctrl = MPPI(model, cost, k=k, tau=tau, lam=0.4, upsilon=1.0,
                sigma=SIGMA, seed=5, device="cpu")
    return model, ctrl


def test_set_waypoints_replaces_the_queue():
    _, ctrl = _controller()
    ctrl.set_waypoints([WP1, WP2, WP3])
    assert ctrl.waypoints_remaining() == 3
    np.testing.assert_allclose(ctrl._cost.waypoints[:3].numpy(),
                               [WP1, WP2, WP3], atol=1e-6)
    ctrl.set_waypoints([WP3])
    assert ctrl.waypoints_remaining() == 1
    np.testing.assert_allclose(ctrl._cost.waypoints[0].numpy(), WP3,
                               atol=1e-6)
    assert ctrl._cost.count.item() == 1


def test_advance_pops_only_inside_radius():
    _, ctrl = _controller()
    ctrl.set_waypoints([WP1, WP2])
    assert ctrl.advance_waypoints(np.zeros(4), radius=0.25) is False
    assert ctrl.waypoints_remaining() == 2
    assert ctrl.advance_waypoints(np.asarray(WP1) + 0.05, radius=0.25) is True
    assert ctrl.waypoints_remaining() == 1
    assert ctrl._cost.count.item() == 1
    np.testing.assert_allclose(ctrl._cost.waypoints[0].numpy(), WP2,
                               atol=1e-6)
    # the last leg is the single goal: never pops below 1
    assert ctrl.advance_waypoints(np.asarray(WP2), radius=9.0) is False
    assert ctrl.waypoints_remaining() == 1


def test_validation_and_non_waypoint_cost():
    _, ctrl = _controller(max_waypoints=2)
    with pytest.raises(ValueError, match="non-empty"):
        ctrl.set_waypoints([])
    with pytest.raises(ValueError, match="capacity"):
        ctrl.set_waypoints([WP1, WP2, WP3])
    with pytest.raises(ValueError, match="dim"):
        ctrl.set_waypoints([[1.0, 2.0]])
    params = mission_params(ctrl._cost, [WP2, WP1])
    assert sorted(params) == ["count", "waypoints"]
    assert validate_mission(ctrl._cost, [WP1])[0].dtype == np.float64
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=4, action_dim=2)
    cost = get_cost({"type": "static", "diag": True,
                     "goal": [1.0, 0.0, 0.0, 0.0], "Q": Q4.tolist()},
                    lam=0.4, gamma=0.1, upsilon=1.0, sigma=SIGMA)
    static = MPPI(model, cost, k=64, tau=5, lam=0.4, sigma=SIGMA,
                  device="cpu")
    for call in (lambda: static.set_waypoints([WP1]),
                 lambda: static.advance_waypoints(np.zeros(4), 0.1),
                 static.waypoints_remaining):
        with pytest.raises(TypeError, match="WayPointsCost"):
            call()


def _quat_controller():
    sigma = np.diag([2000.0] * 3 + [200.0] * 3)
    wp1, wp2 = np.zeros(13), np.zeros(13)
    wp1[2], wp1[6] = -1.0, 1.0
    wp2[2], wp2[6] = -2.0, 1.0
    cost = get_cost({"type": "waypoints_quat", "diag": True,
                     "Q": [60.0, 60.0, 60.0, 10.0] + [1.0] * 6,
                     "waypoints": [wp1.tolist()], "alpha": 0.2},
                    lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma)
    model = get_model(_auv_cfg(), dt=0.1, action_dim=6)
    ctrl = MPPI(model, cost, k=64, tau=5, lam=0.5, sigma=sigma, seed=3,
                normalize_cost=True, device="cpu")
    return ctrl, wp1, wp2


def test_quat_mission_pop_is_attitude_aware():
    """A state at the waypoint's position but yawed 180 degrees does not
    pop (theta = pi dominates the 10-dim error); the aligned one does; a
    waypoint written as -q pops at +q (test_missions.py:189-199 and
    test_costs.py's double-cover case)."""
    ctrl, wp1, wp2 = _quat_controller()
    ctrl.set_waypoints([wp1, wp2])
    flipped = wp1.copy()
    flipped[3:7] = [0.0, 0.0, 1.0, 0.0]
    assert ctrl.advance_waypoints(flipped, radius=0.5) is False
    assert ctrl.advance_waypoints(wp1, radius=0.5) is True
    neg = wp2.copy()
    neg[3:7] *= -1.0
    ctrl.set_waypoints([neg, wp1])
    assert ctrl.advance_waypoints(wp2, radius=0.5) is True


def test_partly_flown_mission_survives_a_checkpoint(tmp_path):
    _, ctrl = _controller()
    ctrl.set_waypoints([WP1, WP2, WP3])
    ctrl.next(np.zeros(4))
    assert ctrl.advance_waypoints(np.asarray(WP1), radius=0.25)
    path = str(tmp_path / "ckpt.npz")
    ctrl.save_state(path)
    d = np.load(path)
    # cost params in the JAX pytree's leaf order: count, then waypoints
    assert d["cp_0"].shape == () and d["cp_1"].shape == (8, 4)
    _, fresh = _controller()
    assert fresh.waypoints_remaining() == 1
    fresh.load_state(path)
    assert fresh.waypoints_remaining() == 2
    np.testing.assert_allclose(fresh._cost.leading_waypoint, WP2, atol=1e-6)
    x = np.asarray(WP1)
    np.testing.assert_array_equal(fresh.next(x), ctrl.next(x))
    assert fresh.advance_waypoints(np.asarray(WP2), 0.25)
    assert fresh.waypoints_remaining() == 1


def test_interop_carries_the_queue_both_ways():
    jcost = JWayPointsCost(0.4, 0.1, 1.0, SIGMA, Q=Q4, diag=True,
                           waypoints=[WP1, WP2, WP3], max_waypoints=8)
    cp = jcost.pop(jcost.init_params())
    model, ctrl = _controller()
    from_jax_params({"mass": 1.0}, {k: np.asarray(v) for k, v in cp.items()},
                    model, ctrl._cost)
    assert ctrl.waypoints_remaining() == 2
    np.testing.assert_allclose(ctrl._cost.leading_waypoint, WP2, atol=1e-6)
    _, back = to_jax_params(model, ctrl._cost)
    assert int(back["count"]) == 2 and back["count"].dtype == np.int32
    np.testing.assert_allclose(back["waypoints"], np.asarray(cp["waypoints"]),
                               atol=1e-6)


def test_three_leg_mission_pops_at_the_same_steps_in_both():
    """Both packages fly WP1 -> WP2 -> WP3 at f64 on the same injected eps
    each step, each against its own copy of the exact plant: the queue pops
    at the same steps and the trajectories agree."""
    k, tau, steps, radius = 200, 12, 110, 0.25
    _, port = _controller(k=k, tau=tau, dtype=torch.float64)
    port.set_waypoints([WP1, WP2, WP3])
    jmodel = jget_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                        state_dim=4, action_dim=2, dtype=jnp.float64)
    jcost = JWayPointsCost(0.4, 0.1, 1.0, SIGMA, Q=Q4, diag=True,
                           waypoints=[WP1], max_waypoints=8,
                           dtype=jnp.float64)
    ref = JMPPI(jmodel, jcost, k=k, tau=tau, lam=0.4, upsilon=1.0,
                sigma=SIGMA, seed=5)
    ref.set_waypoints([WP1, WP2, WP3])
    mp = ref.model_params
    rng = np.random.default_rng(0)
    x_p = x_j = np.zeros(4)
    useq_p = torch.zeros(tau, 2, dtype=torch.float64)
    useq_j = jnp.zeros((tau, 2))
    pops_p, pops_j = [], []
    for step in range(steps):
        eps = rng.normal(size=(k, tau, 2)) @ SIGMA.T
        a_p, useq_p, _ = port._solve_with_noise(
            torch.tensor(eps), torch.tensor(x_p), useq_p)
        a_j, useq_j, _ = ref._solve_with_noise_jit(
            jnp.asarray(eps), jnp.asarray(x_j), useq_j, mp, ref._cparams)
        x_p = np.asarray(jmodel.predict(mp, jnp.asarray(x_p),
                                        jnp.asarray(a_p.numpy()))).ravel()
        x_j = np.asarray(jmodel.predict(mp, jnp.asarray(x_j),
                                        a_j)).ravel()
        if port.advance_waypoints(x_p, radius):
            pops_p.append(step)
        if ref.advance_waypoints(x_j, radius):
            pops_j.append(step)
    assert len(pops_p) == 2 and pops_p == pops_j, (pops_p, pops_j)
    np.testing.assert_allclose(x_p, x_j, atol=1e-8)
    assert np.linalg.norm(x_p - np.asarray(WP3)) < 0.2


def test_runner_advances_the_waypoint_queue():
    """test_costs.py's closed loop through the port's run_experiment on the
    CPU: the plant reaches WP1, the runner pops it (task 'radius'), and the
    loop converges on WP2."""
    env_cfg = {"env": "analytic:point_mass", "state-dim": 4,
               "action-dim": 2, "dt": 0.1, "noise": SIGMA.tolist(),
               "lambda": 0.4, "gamma": 0.1, "upsilon": 1.0,
               "samples": 500, "horizon": 15}
    task_cfg = {"type": "waypoints", "diag": True, "Q": Q4.tolist(),
                "waypoints": [WP1, WP2], "alpha": 0.2, "radius": 0.25}
    res = run_experiment(env_cfg, task_cfg, {"type": "point_mass",
                                             "mass": 1.0},
                         steps=80, seed=3, device="cpu")
    ctrl, states = res["controller"], res["states"]
    assert ctrl.waypoints_remaining() == 1
    np.testing.assert_allclose(ctrl._cost.waypoints[0].numpy(), WP2,
                               atol=1e-6)
    assert np.linalg.norm(states - np.asarray(WP1), axis=1).min() < 0.25
    assert np.linalg.norm(states[-1] - np.asarray(WP2)) < 0.2
