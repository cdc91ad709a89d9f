"""The port's tracking costs (costs/elipse.py, costs/waypoints.py) against
the JAX package's at f64: state costs, ``dist``, the waypoint queue's
operations and its validation errors, with the hand-computed values of
tests/test_elipse_costs.py and tests/test_costs.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu_torch.cfg import default_config
from mppi_tf_tpu_torch.costs import (ElipseCost, ElipseCost3D, WayPointsCost,
                                     WayPointsQuatCost, get_cost)

# f64 on both sides: the same formulas, agreeing to rounding
RTOL = 1e-12
SIGMA2, SIGMA6 = np.eye(2), np.diag([40.0] * 3 + [5.0] * 3)
Q10 = [100.0, 100.0, 100.0, 10.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]


def _both(task, sigma):
    kw = dict(lam=0.5, gamma=0.2, upsilon=1.2, sigma=sigma)
    return (get_cost(task, dtype=torch.float64, **kw),
            jget_cost(task, dtype=jnp.float64, **kw))


def _states(n, sdim, seed):
    x = np.random.default_rng(seed).normal(size=(n, sdim))
    if sdim == 13:
        x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    return x


def _wp(x=0.0, z=0.0, yaw=0.0):
    w = np.zeros(13)
    w[0], w[2] = x, z
    w[3], w[6] = np.sin(yaw / 2), np.cos(yaw / 2)
    return w


@pytest.mark.parametrize("name,sdim,sigma", [
    ("tasks/elipse_task", 4, SIGMA2), ("tasks/elipse3d_task", 13, SIGMA6),
    ("tasks/waypoints_task", 6, np.eye(3)),
    ("tasks/waypoints_quat_task", 13, SIGMA6)])
def test_bundled_task_state_cost_matches_jax(name, sdim, sigma):
    port, ref = _both(default_config(name), sigma)
    x = _states(40, sdim, seed=sdim)
    cp = ref.init_params()
    np.testing.assert_allclose(
        port.state_cost(torch.tensor(x)).numpy(),
        np.asarray(ref.state_cost(cp, jnp.asarray(x))), rtol=RTOL)
    assert sorted(port.params()) == sorted(cp)
    for key, value in port.params().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(cp[key]))
    # the action cost is CostBase's, shared with the static costs
    u, eps = x[0, :sigma.shape[0]], x[1:, :sigma.shape[0]]
    np.testing.assert_allclose(
        port.action_cost(torch.tensor(u), torch.tensor(eps)).numpy(),
        np.asarray(ref.action_cost(jnp.asarray(u), jnp.asarray(eps))),
        rtol=RTOL)


def test_elipse_hand_values_and_dist():
    cost = ElipseCost(1.0, 1.0, 1.0, SIGMA2, a=2.0, b=1.0, center_x=1.0,
                      center_y=-1.0, speed=2.0, m_state=3.0, m_vel=0.5,
                      dtype=torch.float64)
    d = abs(((2.0 - 1.0) / 2.0) ** 2 + ((0.5 + 1.0) / 1.0) ** 2 - 1.0)
    expect = 3.0 * d + 0.5 * (np.sqrt(5.0) - 2.0) ** 2
    got = cost.state_cost(torch.tensor([[2.0, 1.0, 0.5, 2.0]],
                                       dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), [expect], rtol=RTOL)
    on = ElipseCost(1.0, 1.0, 1.0, SIGMA2, 4.0, 2.0, 0.0, 0.0, 5.0, 1.0,
                    0.1, dtype=torch.float64)
    out = on.dist(np.array([4.0, 5.0, 0.0, 0.0]))
    assert abs(out["x_dist"].item()) < 1e-12 and abs(
        out["v_dist"].item()) < 1e-12
    _, ref = _both(default_config("tasks/elipse_task"), SIGMA2)
    port, _ = _both(default_config("tasks/elipse_task"), SIGMA2)
    s = np.array([1.0, 0.3, -1.5, 2.0])
    jd = ref.dist({}, jnp.asarray(s))
    for key, value in port.dist(s).items():
        np.testing.assert_allclose(value.item(), float(jd[key]), rtol=RTOL)
    x, y = ElipseCost(1.0, 1.0, 1.0, SIGMA2, 3.0, 1.5, 2.0, -1.0, 1.0, 1.0,
                      1.0).draw_goal()
    np.testing.assert_allclose(((x - 2.0) / 3.0) ** 2
                               + ((y + 1.0) / 1.5) ** 2, 1.0, rtol=RTOL)


def _mk3d(**kw):
    args = dict(normal=[0, 0, 1], aVec=[1, 0, 0], axis=[4.0, 2.0],
                center=[0, 0, 0], speed=5.0, m_state=1.0, m_vel=0.1)
    args.update(kw)
    return ElipseCost3D(1.0, 1.0, 1.0, SIGMA6, **args, dtype=torch.float64)


def _auv_state(pos, q, vel):
    s = np.zeros(13)
    s[0:3], s[3:7], s[7:13] = pos, q, vel
    return torch.tensor(s[None, :])


def test_elipse3d_hand_values():
    """On the ellipse, along its tangent, at speed: zero cost, with or
    without a center (the translation the reference forgot); the per-term
    errors by hand; the plane-frame quaternion against the JAX cost's."""
    q = Rotation.from_euler("z", 90, degrees=True).as_quat()
    assert _mk3d().state_cost(
        _auv_state([4.0, 0, 0], q, [5.0, 0, 0, 0, 0, 0])).item() < 1e-8
    assert _mk3d(center=[10.0, -5.0, 2.0]).state_cost(
        _auv_state([14.0, -5.0, 2.0], q, [5.0, 0, 0, 0, 0, 0])).item() < 1e-8
    cost = _mk3d(speed=2.0)
    np.testing.assert_allclose(
        cost.position_error(torch.tensor([[4.0, 0.0, 1.0]])).item(), 1.0,
        rtol=RTOL)
    np.testing.assert_allclose(cost.velocity_error(torch.tensor(
        [[3.0, 0.0, 0.0, 0.0, 0.0, 0.0]])).item(), 5.0, rtol=RTOL)
    tilted = dict(normal=[0.0, 1.0, 0.0], aVec=[1.0, 0.0, 0.0], axis=[4.0,
                  2.0], center=[0.0, 0.0, 0.0], speed=1.0, m_state=1.0,
                  m_vel=1.0)
    port, ref = _both({"type": "elipse3d", **tilted}, SIGMA6)
    np.testing.assert_allclose(port.q_plane.numpy(), np.asarray(ref.q_plane),
                               rtol=RTOL, atol=1e-15)
    out = port.dist(np.array([4.0, 0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 0, 0]))
    assert abs(out["x_dist"].item()) < 1e-9
    s = _states(1, 13, seed=5)[0]
    jd = ref.dist({}, jnp.asarray(s))
    for key, value in port.dist(s).items():
        np.testing.assert_allclose(value.item(), float(jd[key]), rtol=RTOL)


@pytest.mark.parametrize("ctype", ["waypoints", "waypoints_quat"])
def test_queue_operations_match_jax(ctype):
    """add_waypoint(s), pop, set_goal and _set_queue give the JAX
    functional queue's params, leaf by leaf, with the state cost after
    each; the queue clamps at its capacity and never empties below one."""
    if ctype == "waypoints":
        rows = [np.array([1.0, 0.0, 0.5, 0.0]) * (i + 1) for i in range(5)]
        task = {"type": ctype, "diag": True, "Q": [1.0, 0.5, 2.0, 0.5],
                "waypoints": [rows[0].tolist()], "alpha": 0.3,
                "max_waypoints": 3}
        sigma, sdim = SIGMA2, 4
    else:
        rows = [_wp(x=i, z=-i, yaw=0.2 * i) for i in range(5)]
        task = {"type": ctype, "diag": True, "Q": Q10,
                "waypoints": [rows[0].tolist()], "alpha": 0.3,
                "max_waypoints": 3}
        sigma, sdim = SIGMA6, 13
    port, ref = _both(task, sigma)
    cp = ref.init_params()
    x = _states(9, sdim, seed=3)

    def same(cp):
        for key, value in port.params().items():
            np.testing.assert_allclose(value.numpy(), np.asarray(cp[key]),
                                       rtol=RTOL, atol=1e-15)
        assert port.queue_length == int(cp["count"])
        np.testing.assert_allclose(port.leading_waypoint,
                                   np.asarray(cp["waypoints"][0]), rtol=RTOL)
        np.testing.assert_allclose(
            port.state_cost(torch.tensor(x)).numpy(),
            np.asarray(ref.state_cost(cp, jnp.asarray(x))), rtol=RTOL)

    same(cp)
    port.add_waypoint(rows[1])
    cp = ref.add_waypoint(cp, rows[1])
    same(cp)
    port.add_waypoints(rows[2:5])     # past the capacity of 3
    cp = ref.add_waypoints(cp, rows[2:5])
    same(cp)
    assert port.queue_length == 3
    for _ in range(3):
        port.pop()
        cp = ref.pop(cp)
        same(cp)
    assert port.queue_length == 1
    port.set_goal(rows[2])
    cp = ref.set_goal(cp, rows[2])
    same(cp)
    port._set_queue(rows[:2])
    cp = ref._set_queue(cp, rows[:2])
    same(cp)


def test_waypoint_dist_matches_jax():
    port, ref = _both({"type": "waypoints", "diag": True,
                       "Q": [1.0, 1.0, 1.0, 1.0],
                       "waypoints": [[1.0, 0.0, -2.0, 0.5]]}, SIGMA2)
    s = np.array([0.5, 0.1, 0.2, 0.3])
    np.testing.assert_allclose(
        port.dist(s).numpy(), np.asarray(ref.dist(ref.init_params(),
                                                  jnp.asarray(s))),
        rtol=RTOL)
    w0 = _wp(z=-2.0)
    qport, qref = _both({"type": "waypoints_quat", "diag": True, "Q": Q10,
                         "waypoints": [w0.tolist()]}, SIGMA6)
    x = _states(5, 13, seed=8)
    cp = qref.init_params()
    for arg in (x[0], x):     # one state -> [10], a batch -> [n, 10]
        got = qport.dist(arg).numpy()
        want = np.asarray(qref.dist(cp, jnp.asarray(arg)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)


def test_quat_metric_is_double_cover_safe():
    """q and -q are one attitude: zero error at the goal in both
    hemispheres (the |dot| geodesic), unlike StaticQuatCost's signed dot."""
    w0 = _wp(yaw=0.8)
    cost = WayPointsQuatCost(0.5, 0.2, 1.2, SIGMA6, Q=Q10, diag=True,
                             waypoints=[w0], dtype=torch.float64)
    for sign in (1.0, -1.0):
        x = w0.copy()
        x[3:7] *= sign
        np.testing.assert_allclose(cost.dist(x).numpy(), 0.0, atol=1e-7)


def test_validation_errors_match_jax():
    with pytest.raises(TypeError, match="WayPointsQuatCost"):
        get_cost({"type": "waypoints", "diag": True, "Q": [1.0] * 13},
                 lam=0.5, gamma=0.2, upsilon=1.2, sigma=SIGMA6)
    with pytest.raises(AssertionError, match="10, 10"):
        WayPointsQuatCost(0.5, 0.2, 1.2, SIGMA6, Q=np.eye(13))
    with pytest.raises(AssertionError, match="dim"):
        WayPointsCost(1.0, 1.0, 1.0, SIGMA2, Q=np.eye(4),
                      waypoints=[[1.0, 2.0]])
    task = {"type": "waypoints_quat", "diag": True, "Q": Q10,
            "waypoints": [np.zeros(13).tolist()]}
    for factory in (get_cost, jget_cost):
        with pytest.raises(ValueError, match="unit"):
            factory(task, lam=0.5, gamma=0.2, upsilon=1.2, sigma=SIGMA6)
    cost = WayPointsQuatCost(0.5, 0.2, 1.2, SIGMA6, Q=Q10, diag=True,
                             waypoints=[_wp(z=-1.0)], dtype=torch.float64)
    with pytest.raises(ValueError, match="unit"):
        cost.set_goal(np.zeros(13))
    with pytest.raises(ValueError, match="unit"):
        cost.add_waypoint(np.zeros(13))
    with pytest.raises(ValueError, match="dim"):
        cost.set_goal(np.zeros(4))
    # drift within 1e-3 is renormalised, as in the JAX cost
    w = _wp(yaw=0.4)
    w[3:7] *= 1.0 + 5e-4
    cost.set_goal(w)
    np.testing.assert_allclose(np.linalg.norm(cost.waypoints[0, 3:7]), 1.0,
                               atol=1e-12)
    assert cost.queue_length == 1


def test_buffers_move_with_the_module_and_host_copy_stays():
    cost = get_cost(default_config("tasks/waypoints_task"), lam=1.0,
                    gamma=1.0, upsilon=1.0, sigma=np.eye(3))
    assert cost.count.dtype == torch.int32 and cost.waypoints.shape == (32, 6)
    cost.to(torch.device("cpu"))
    assert cost.queue_length == 3
    with torch.no_grad():
        cost.count.fill_(2)
        cost.waypoints[0].fill_(7.0)
    assert cost.queue_length == 3           # the host copy is not read back
    cost.sync_host()
    assert cost.queue_length == 2
    np.testing.assert_array_equal(cost.leading_waypoint, np.full(6, 7.0))


def _elipse_loop_errors(states):
    """(mean radial error |(x/a)^2 + (y/b)^2 - 1|, mean speed error
    ||v| - 5|) over the last 100 states, and the angle travelled around the
    bundled elipse_task's ellipse (a 4, b 2, speed 5)."""
    tail = states[-100:]
    rad = np.abs((tail[:, 0] / 4.0) ** 2 + (tail[:, 2] / 2.0) ** 2 - 1.0)
    speed = np.abs(np.hypot(tail[:, 1], tail[:, 3]) - 5.0)
    ang = np.unwrap(np.arctan2(states[:, 2] / 2.0, states[:, 0] / 4.0))
    return rad.mean(), speed.mean(), abs(ang[-1] - ang[0])


def test_elipse_loop_tracks_in_both():
    """The 2-DoF point mass on the bundled elipse_task (the env config's
    lambda, gamma and noise 0.25 I, H=50, K=1,024) from (4, 0, 0, 0): 300
    steps in each package, held to the gate chip_smoke.py holds the
    K=100,000 loop to (radial < 0.4, speed error < 4.5 over the last 100
    steps, half a lap or more). The cost of the action keeps the speed far
    below the task's 5 in both packages."""
    from mppi_tf_tpu.controller import get_controller as jget_controller
    from mppi_tf_tpu.envs.analytic import PointMassEnv as JPointMassEnv
    from mppi_tf_tpu.models import get_model as jget_model
    from mppi_tf_tpu_torch.controller import get_controller
    from mppi_tf_tpu_torch.envs import PointMassEnv
    from mppi_tf_tpu_torch.models import get_model

    env_cfg = dict(default_config("envs/point_mass"), samples=1024,
                   horizon=50, **{"state-dim": 4, "action-dim": 2,
                                  "init-act": [0.0, 0.0],
                                  "noise": [[0.25, 0.0], [0.0, 0.25]]})
    task = default_config("tasks/elipse_task")
    mcfg = default_config("models/point_mass_model")
    kw = dict(lam=env_cfg["lambda"], gamma=env_cfg["gamma"], upsilon=1.0,
              sigma=np.asarray(env_cfg["noise"]))
    port = get_controller(
        get_model(mcfg, dt=0.1, state_dim=4, action_dim=2, device="cpu"),
        get_cost(task, device="cpu", **kw), env_cfg, seed=0, device="cpu")
    ref = jget_controller(
        jget_model(mcfg, dt=0.1, state_dim=4, action_dim=2),
        jget_cost(task, **kw), env_cfg, seed=0)
    for ctrl, env in ((port, PointMassEnv(n_dof=2, dt=0.1)),
                      (ref, JPointMassEnv(n_dof=2, dt=0.1))):
        x = env.reset(np.array([4.0, 0.0, 0.0, 0.0]))
        states = []
        for _ in range(300):
            x = env.step(ctrl.next(x))
            states.append(np.ravel(x))
        rad, speed, angle = _elipse_loop_errors(np.asarray(states))
        assert rad < 0.4 and speed < 4.5 and angle > np.pi, (
            type(ctrl).__module__, rad, speed, angle)
