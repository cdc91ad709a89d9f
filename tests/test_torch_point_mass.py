"""Port's point-mass model and static cost against the JAX package at f64,
the parameter carry between the two, and the factories' dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu_torch.costs import StaticCost, get_cost
from mppi_tf_tpu_torch.interop import from_jax_params, to_jax_params
from mppi_tf_tpu_torch.models import PointMassModel, get_model

RTOL = 1e-10
SIGMA = np.array([[0.3, 0.05, 0.0], [0.05, 0.2, 0.01], [0.0, 0.01, 0.4]])
TASK = {"type": "static", "diag": True,
        "goal": [1.0, 0.0, 0.5, 0.0, -0.5, 0.0],
        "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _pair(mass=1.3, dt=0.1, sdim=6, adim=3):
    cfg = {"type": "point_mass", "mass": mass}
    port = get_model(cfg, dt=dt, state_dim=sdim, action_dim=adim,
                     dtype=torch.float64)
    ref = jget_model(cfg, dt=dt, state_dim=sdim, action_dim=adim,
                     dtype=jnp.float64)
    return port, ref


def _costs(ups=1.4):
    port = get_cost(TASK, lam=0.8, gamma=0.3, upsilon=ups, sigma=SIGMA,
                    dtype=torch.float64)
    ref = jget_cost(TASK, lam=0.8, gamma=0.3, upsilon=ups, sigma=SIGMA,
                    dtype=jnp.float64)
    return port, ref


@pytest.mark.parametrize("sdim,adim", [(2, 1), (4, 2), (6, 3)])
def test_step_matches_jax(sdim, adim):
    port, ref = _pair(sdim=sdim, adim=adim)
    rng = np.random.default_rng(sdim)
    x = rng.normal(size=(17, sdim))
    u = rng.normal(size=(17, adim))
    with torch.no_grad():
        out = port.step(_t(x), _t(u))
    np.testing.assert_allclose(
        out.numpy(), ref.step(ref.init_params(), jnp.asarray(x),
                              jnp.asarray(u)), rtol=RTOL)
    np.testing.assert_allclose(
        port.predict(_t(x[0]), _t(u[0])).detach().numpy(),
        ref.predict(ref.init_params(), jnp.asarray(x[0]),
                    jnp.asarray(u[0])), rtol=RTOL)


@pytest.mark.parametrize("batched", [False, True])
def test_run_model_matches_jax(batched):
    port, ref = _pair()
    rng = np.random.default_rng(11)
    x0 = rng.normal(size=(4, 6) if batched else 6)
    useq = rng.normal(size=(9, 3))
    with torch.no_grad():
        out = port.run_model(_t(x0), _t(useq))
    exp = ref.run_model(ref.init_params(), jnp.asarray(x0),
                        jnp.asarray(useq))
    assert tuple(out.shape) == tuple(exp.shape)
    np.testing.assert_allclose(out.numpy(), exp, rtol=RTOL, atol=1e-14)


def test_model_metadata():
    port, ref = _pair()
    assert port.get_state_dim() == ref.get_state_dim() == 6
    assert port.get_action_dim() == ref.get_action_dim() == 3
    assert port.dt == ref.dt
    np.testing.assert_array_equal(port.max_act().numpy(), ref.max_act())
    np.testing.assert_array_equal(port.min_act().numpy(), ref.min_act())
    limited = get_model({"type": "point_mass", "limMax": 2.0,
                         "limMin": [-1.0, -2.0, -3.0]}, state_dim=6,
                        action_dim=3)
    np.testing.assert_array_equal(limited.max_act().numpy(), [2.0] * 3)
    np.testing.assert_array_equal(limited.min_act().numpy(),
                                  [-1.0, -2.0, -3.0])
    with pytest.raises(ValueError):
        PointMassModel(state_dim=5, action_dim=3)


def test_state_cost_matches_jax():
    port, ref = _costs()
    x = np.random.default_rng(12).normal(size=(23, 6))
    np.testing.assert_allclose(
        port.state_cost(_t(x)).numpy(),
        ref.state_cost(ref.init_params(), jnp.asarray(x)), rtol=RTOL)
    np.testing.assert_allclose(
        port.final_cost(_t(x)).numpy(),
        ref.final_cost(ref.init_params(), jnp.asarray(x)), rtol=RTOL)


@pytest.mark.parametrize("sched_scale", [None, 0.6])
@pytest.mark.parametrize("ups", [1.0, 1.4])
def test_action_cost_matches_jax(sched_scale, ups):
    port, ref = _costs(ups)
    rng = np.random.default_rng(13)
    u = rng.normal(size=3)
    eps = rng.normal(size=(19, 3))
    np.testing.assert_allclose(
        port.action_cost(_t(u), _t(eps), sched_scale).numpy(),
        ref.action_cost(jnp.asarray(u), jnp.asarray(eps), sched_scale),
        rtol=RTOL)
    x = rng.normal(size=(19, 6))
    np.testing.assert_allclose(
        port.step_cost(_t(x), _t(u), _t(eps)).numpy(),
        ref.step_cost(ref.init_params(), jnp.asarray(x), jnp.asarray(u),
                      jnp.asarray(eps)), rtol=RTOL)


def test_set_goal_in_place():
    port, ref = _costs()
    goal = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]
    buf = port.goal
    port.set_goal(goal)
    assert port.goal is buf
    cp = ref.set_goal(ref.init_params(), goal)
    x = np.random.default_rng(14).normal(size=(5, 6))
    np.testing.assert_allclose(port.state_cost(_t(x)).numpy(),
                               ref.state_cost(cp, jnp.asarray(x)), rtol=RTOL)
    with pytest.raises(ValueError):
        port.set_goal([1.0, 2.0])


def test_from_jax_params_round_trip():
    port_m, ref_m = _pair(mass=1.0)
    port_c, ref_c = _costs()
    mp = {"mass": np.asarray(ref_m.init_params()["mass"]) * 2.5}
    cp = {"goal": np.arange(6, dtype=np.float64) / 7.0}
    from_jax_params(mp, cp, port_m, port_c)
    back_m, back_c = to_jax_params(port_m, port_c)
    np.testing.assert_array_equal(back_m["mass"], mp["mass"])
    np.testing.assert_array_equal(back_c["goal"], cp["goal"])
    # both packages now compute the same step and cost
    rng = np.random.default_rng(15)
    x, u = rng.normal(size=(8, 6)), rng.normal(size=(8, 3))
    with torch.no_grad():
        np.testing.assert_allclose(
            port_m.step(_t(x), _t(u)).numpy(),
            ref_m.step({"mass": jnp.asarray(mp["mass"])}, jnp.asarray(x),
                       jnp.asarray(u)), rtol=RTOL)
    np.testing.assert_allclose(
        port_c.state_cost(_t(x)).numpy(),
        ref_c.state_cost({"goal": jnp.asarray(cp["goal"])}, jnp.asarray(x)),
        rtol=RTOL)
    with pytest.raises(KeyError):
        from_jax_params({"m": 1.0}, cp, port_m, port_c)
    with pytest.raises(KeyError):
        from_jax_params(mp, {"goals": cp["goal"]}, port_m, port_c)


def test_get_model_dispatch():
    m = get_model({"type": "point_mass", "mass": 2.0}, dt=0.05, state_dim=4,
                  action_dim=2)
    assert isinstance(m, PointMassModel)
    assert m.dtype == torch.float32 and m.mass.detach().item() == 2.0
    assert m.dt == 0.05


@pytest.mark.parametrize("mtype,item", [("dmd", "item 9")])
def test_get_model_not_ported(mtype, item):
    with pytest.raises(NotImplementedError, match=item):
        get_model({"type": mtype})


def test_get_model_unknown():
    with pytest.raises(ValueError):
        get_model({"type": "bogus"})


def test_get_cost_dispatch():
    c = get_cost(TASK, lam=0.8, gamma=0.2, upsilon=1.0, sigma=SIGMA)
    assert type(c) is StaticCost
    np.testing.assert_array_equal(c.Q.numpy(), np.diag(TASK["Q"]))
    with pytest.raises(AssertionError):
        get_cost({**TASK, "goal": [1.0, 2.0]}, lam=0.8, gamma=0.2,
                 upsilon=1.0, sigma=SIGMA)
    with pytest.raises(AssertionError):
        get_cost(TASK, lam=0.8, gamma=0.2, upsilon=1.0, sigma=[1.0, 2.0])


@pytest.mark.parametrize("ctype,item", [
    ("elipse", "item 8"), ("elipse3d", "item 10"),
    ("waypoints", "item 8"), ("waypoints_quat", "item 10")])
def test_get_cost_not_ported(ctype, item):
    """The families ROADMAP items 8 and 10 left unported until their slice:
    each now builds from its bundled task as the JAX factory's class, and
    a task without the family's keys is refused."""
    from mppi_tf_tpu_torch.cfg import default_config

    task = default_config(f"tasks/{ctype}_task")
    port = get_cost(task, lam=1.0, gamma=0.1, upsilon=1.0, sigma=SIGMA)
    ref = jget_cost(task, lam=1.0, gamma=0.1, upsilon=1.0, sigma=SIGMA)
    assert type(port).__name__ == type(ref).__name__
    with pytest.raises(KeyError):
        get_cost({"type": ctype}, lam=1.0, gamma=0.1, upsilon=1.0,
                 sigma=SIGMA)


def test_get_cost_unknown():
    with pytest.raises(ValueError):
        get_cost({"type": "bogus"}, lam=1.0, gamma=0.1, upsilon=1.0,
                 sigma=SIGMA)
