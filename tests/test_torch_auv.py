"""Port's AUV slice against the JAX package at f64: quaternion ops, the
Fossen model (rk 1, 2 and 4), the static quaternion cost, the flagship
table, the analytic AUV plant and the parameter carry between the two."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.ops import quaternion as jquat
from mppi_tf_tpu_torch import flagship
from mppi_tf_tpu_torch.costs import StaticQuatCost, get_cost
from mppi_tf_tpu_torch.envs import AUVEnv
from mppi_tf_tpu_torch.interop import from_jax_params, to_jax_params
from mppi_tf_tpu_torch.models import AUVModel, get_model
from mppi_tf_tpu_torch.ops import quaternion as quat
from tests.test_auv_kernel import _auv_cfg

# f64 on both sides, the same algebra in another order: agreement to a few
# ulps of the largest term (the damping and mass terms reach ~1e4)
RTOL, ATOL = 1e-10, 1e-12
SIGMA = np.diag([40.0, 40.0, 40.0, 5.0, 5.0, 5.0])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _configs():
    """The rexrov2 table (full added-mass matrix) and the JAX kernel tests'
    config (diagonal + 0.5 off-diagonal added mass)."""
    return {"rexrov2": flagship.auv_params(), "auv_cfg": _auv_cfg()}


def _pair(name="rexrov2", rk=2, dt=0.1):
    cfg = {**_configs()[name], "rk": rk}
    port = get_model(cfg, dt=dt, dtype=torch.float64)
    ref = jget_model(cfg, dt=dt, dtype=jnp.float64)
    return port, ref, ref.init_params()


def _states(rng, n):
    x = rng.normal(size=(n, 13))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    x[:, 7:10] *= 0.5
    x[:, 10:13] *= 0.2
    return x


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# quaternion ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "normalize", "conjugate", "to_rotation_matrix", "attitude_jacobian",
    "to_euler"])
def test_quaternion_unary_matches_jax(name):
    q = np.random.default_rng(1).normal(size=(3, 7, 4))
    np.testing.assert_allclose(getattr(quat, name)(_t(q)).numpy(),
                               getattr(jquat, name)(jnp.asarray(q)),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", ["multiply", "relative_angle"])
def test_quaternion_binary_matches_jax(name):
    rng = np.random.default_rng(2)
    q1, q2 = _quats(rng, 40), _quats(rng, 40)
    q2[0] = q1[0]                         # relative angle 0: the clamp
    np.testing.assert_allclose(
        getattr(quat, name)(_t(q1), _t(q2)).numpy(),
        getattr(jquat, name)(jnp.asarray(q1), jnp.asarray(q2)),
        rtol=1e-12, atol=1e-7 if name == "relative_angle" else 1e-14)


def test_rotate_skew_match_jax():
    rng = np.random.default_rng(3)
    p, q = rng.normal(size=(25, 3)), _quats(rng, 25)
    np.testing.assert_allclose(quat.rotate(_t(p), _t(q)).numpy(),
                               jquat.rotate(jnp.asarray(p), jnp.asarray(q)),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(quat.skew(_t(p)).numpy(),
                               jquat.skew(jnp.asarray(p)), rtol=0, atol=0)
    # skew(v) u == v x u
    np.testing.assert_allclose(
        (quat.skew(_t(p)) @ _t(p[::-1].copy())[..., None])[..., 0].numpy(),
        np.cross(p, p[::-1]), rtol=1e-12, atol=1e-14)


def test_from_rotation_matrix_matches_jax_on_every_branch():
    rng = np.random.default_rng(4)
    q = _quats(rng, 64)
    # trace <= 0 cases for the x, y and z branches: rotations by ~pi
    q[:3] = [[1.0, 0.01, 0.02, 0.0], [0.01, 1.0, 0.02, 0.0],
             [0.02, 0.01, 1.0, 0.0]]
    R = jquat.to_rotation_matrix(jnp.asarray(q))
    np.testing.assert_allclose(
        quat.from_rotation_matrix(_t(np.asarray(R))).numpy(),
        jquat.from_rotation_matrix(R), rtol=1e-10, atol=1e-12)


def test_between_two_vectors_matches_jax():
    rng = np.random.default_rng(5)
    v1, v2 = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    v2[0] = -v1[0]                        # antiparallel fallback
    v1[1] = [0.0, 0.0, 1.0]
    v2[1] = [0.0, 0.0, -1.0]              # fallback on the second axis
    np.testing.assert_allclose(
        quat.between_two_vectors(_t(v1), _t(v2)).numpy(),
        jquat.between_two_vectors(jnp.asarray(v1), jnp.asarray(v2)),
        rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# the Fossen model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rexrov2", "auv_cfg"])
@pytest.mark.parametrize("rk", [1, 2, 4])
def test_step_matches_jax(name, rk):
    port, ref, mp = _pair(name, rk)
    rng = np.random.default_rng(10 + rk)
    x, u = _states(rng, 17), 300.0 * rng.normal(size=(17, 6))
    with torch.no_grad():
        out = port.step(_t(x), _t(u)).numpy()
    np.testing.assert_allclose(out, ref.step(ref.precompute(mp),
                                             jnp.asarray(x), jnp.asarray(u)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(out[:, 3:7], axis=1), 1.0,
                               rtol=1e-14)


def test_rk4_is_not_rk2():
    """The port's rk4 is the standard RK4 (JAX models/auv.py:316-320), not
    the TPU kernel's rk2 fall-through: the two orders differ at dt 0.1."""
    x = _states(np.random.default_rng(12), 8)
    u = 300.0 * np.random.default_rng(13).normal(size=(8, 6))
    with torch.no_grad():
        out4 = _pair(rk=4)[0].step(_t(x), _t(u))
        out2 = _pair(rk=2)[0].step(_t(x), _t(u))
    assert (out4 - out2).abs().max().item() > 1e-6


def test_run_model_matches_jax():
    port, ref, mp = _pair("auv_cfg", 2)
    rng = np.random.default_rng(14)
    x0 = _states(rng, 1)[0]
    useq = 200.0 * rng.normal(size=(6, 6))
    with torch.no_grad():
        out = port.run_model(_t(x0), _t(useq)).numpy()
    np.testing.assert_allclose(
        out, ref.run_model(ref.precompute(mp), jnp.asarray(x0),
                           jnp.asarray(useq)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["rexrov2", "auv_cfg"])
def test_dynamics_terms_match_jax(name):
    port, ref, mp = _pair(name)
    rng = np.random.default_rng(15)
    x = _states(rng, 9)
    vel, u = x[:, 7:13], 100.0 * rng.normal(size=(9, 6))
    rot = np.asarray(jquat.to_rotation_matrix(jnp.asarray(x[:, 3:7])))
    with torch.no_grad():
        m_tot, inv_m = port.precompute()
    jm, jinv = ref._mass_matrices(mp)
    np.testing.assert_allclose(m_tot.numpy(), jm, rtol=1e-12)
    np.testing.assert_allclose(inv_m.numpy(), jinv, rtol=1e-9, atol=1e-15)
    with torch.no_grad():
        pairs = [
            (port.damping_matrix(_t(vel)), ref.damping_matrix(
                jnp.asarray(vel))),
            (port.coriolis_matrix(m_tot, _t(vel)), ref.coriolis_matrix(
                jm, jnp.asarray(vel))),
            (port.restoring_forces(_t(rot)), ref.restoring_forces(
                mp, jnp.asarray(rot))),
            (port.acc(_t(vel), _t(u), _t(rot)), ref.acc(
                ref.precompute(mp), jnp.asarray(vel), jnp.asarray(u),
                jnp.asarray(rot))),
            (port.state_dot(_t(x), _t(u)), ref.state_dot(
                ref.precompute(mp), jnp.asarray(x), jnp.asarray(u))),
            (port.get_jacobian(_t(x)), ref.get_jacobian(jnp.asarray(x))),
        ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_acc_matches_matrix_forms():
    """The matrix-free D nu and C nu of ``acc`` == the matrix forms
    M^-1 (tau - C(nu) nu - D(nu) nu - g) (as tests/test_auv.py holds the
    JAX model)."""
    port, _, _ = _pair()
    rng = np.random.default_rng(16)
    x = _states(rng, 11)
    vel, u = _t(x[:, 7:13]), _t(100.0 * rng.normal(size=(11, 6)))
    rot = quat.to_rotation_matrix(_t(x[:, 3:7]))
    with torch.no_grad():
        m_tot, inv_m = port.precompute()
        D = port.damping_matrix(vel)
        C = port.coriolis_matrix(m_tot, vel)
        rhs = (u - (C @ vel[..., None])[..., 0] - (D @ vel[..., None])[..., 0]
               - port.restoring_forces(rot))
        np.testing.assert_allclose(port.acc(vel, u, rot).numpy(),
                                   (rhs @ inv_m.T).numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_neutral_buoyancy_at_rest():
    """rexrov2 is neutrally buoyant to 0.1 N: at rest with qw = 1 the
    vehicle barely moves in a second (the cob above the cog keeps it
    upright)."""
    port, _, _ = _pair(rk=4, dt=0.05)
    x = torch.zeros(1, 13, dtype=torch.float64)
    x[0, 6] = 1.0
    with torch.no_grad():
        for _ in range(20):
            x = port.step(x, torch.zeros(1, 6, dtype=torch.float64))
    assert abs(x[0, 2].item()) < 1e-4
    np.testing.assert_allclose(x[0, 3:7].numpy(), [0, 0, 0, 1], atol=1e-9)


def test_precompute_tracks_parameter_changes():
    port, _, _ = _pair()
    with torch.no_grad():
        m1, inv1 = port.precompute()
        assert port.precompute()[0] is m1            # cached
        port.mass.mul_(2.0)
        m2, inv2 = port.precompute()
    assert m2 is not m1
    np.testing.assert_allclose((m2 @ inv2).numpy(), np.eye(6), atol=1e-12)
    assert m2[0, 0].item() == pytest.approx(m1[0, 0].item()
                                            + port.mass.item() / 2.0)
    # with autograd on, the matrices carry the graph to the parameters
    m3, _ = port.precompute()
    m3[0, 0].backward()
    assert port.mass.grad.item() == 1.0


def test_model_validation():
    base = flagship.auv_params()
    with pytest.raises(NotImplementedError, match="world_ned"):
        AUVModel(base, inertial_frame_id="world_ned")
    with pytest.raises(AssertionError):
        AUVModel(base, inertial_frame_id="map")
    with pytest.raises(AssertionError):
        AUVModel({**base, "rk": 3})
    for key in ("cog", "cob", "inertial"):
        with pytest.raises(AssertionError):
            AUVModel({k: v for k, v in base.items() if k != key})
    for key, bad in (("mass", 0.0), ("volume", -1.0), ("density", 0.0),
                     ("cog", [0.0, 0.0]), ("Ma", np.eye(5)),
                     ("quad_damping", [1.0] * 5),
                     ("linear_damping", [1.0] * 5)):
        with pytest.raises(AssertionError):
            AUVModel({**base, key: bad})


def test_get_model_auv():
    m = get_model(flagship.auv_params(), dt=0.05)
    assert isinstance(m, AUVModel)
    assert (m.get_state_dim(), m.get_action_dim(), m.rk) == (13, 6, 2)
    assert m.dtype == torch.float32 and m.dt == 0.05
    assert m.get_name() == "rexrov2"
    np.testing.assert_array_equal(m.max_act().numpy(), [500.0] * 6)
    assert {n for n, _ in m.named_parameters()} == {"mass", "inertial"}


# ---------------------------------------------------------------------------
# the static quaternion cost
# ---------------------------------------------------------------------------

def _costs(goal=None):
    task = flagship.auv_task()
    if goal is not None:
        task["goal"] = list(goal)
    port = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.2, sigma=SIGMA,
                    dtype=torch.float64)
    ref = jget_cost(task, lam=0.5, gamma=0.2, upsilon=1.2, sigma=SIGMA,
                    dtype=jnp.float64)
    return port, ref


def test_static_quat_cost_matches_jax():
    port, ref = _costs()
    assert type(port) is StaticQuatCost
    rng = np.random.default_rng(20)
    x = _states(rng, 31)
    x[0, 3:7] = [0.0, 0.0, 0.0, 1.0]     # dot = +1: theta 0 at the clamp
    x[1, 3:7] = [0.0, 0.0, 0.0, -1.0]    # signed dot -1: theta 2 pi
    cp = ref.init_params()
    for fn in ("dist", "state_cost", "final_cost"):
        np.testing.assert_allclose(
            getattr(port, fn)(_t(x)).numpy(),
            getattr(ref, fn)(cp, jnp.asarray(x)), rtol=1e-12, atol=1e-12)
    assert port.dist(_t(x))[1, 3].item() == pytest.approx(2 * np.pi)
    u, eps = rng.normal(size=6), rng.normal(size=(31, 6))
    np.testing.assert_allclose(
        port.step_cost(_t(x), _t(u), _t(eps)).numpy(),
        ref.step_cost(cp, jnp.asarray(x), jnp.asarray(u), jnp.asarray(eps)),
        rtol=1e-12)


def test_static_quat_cost_set_goal_and_validation():
    port, ref = _costs()
    buf = port.goal
    goal = np.zeros(13)
    goal[[0, 2, 6]] = [1.0, -2.0, 1.0]
    port.set_goal(goal)
    assert port.goal is buf
    x = _states(np.random.default_rng(21), 5)
    np.testing.assert_allclose(
        port.state_cost(_t(x)).numpy(),
        ref.state_cost(ref.set_goal(ref.init_params(), goal),
                       jnp.asarray(x)), rtol=1e-12)
    with pytest.raises(ValueError):
        port.set_goal(np.zeros(6))
    with pytest.raises(AssertionError):
        StaticQuatCost(0.5, 0.2, 1.0, SIGMA, goal=np.zeros(13),
                       Q=np.eye(13))
    with pytest.raises(AssertionError):
        StaticQuatCost(0.5, 0.2, 1.0, SIGMA, goal=np.zeros(10),
                       Q=np.eye(10))


# ---------------------------------------------------------------------------
# flagship table, plant, parameter carry
# ---------------------------------------------------------------------------

def test_auv_params_equal_the_bundled_yaml():
    from mppi_tf_tpu import flagship as jflagship
    from mppi_tf_tpu.cfg.config import default_config

    assert flagship.auv_params() == default_config("models/rexrov2")
    assert flagship.auv_params() == jflagship.auv_params()
    assert flagship.auv_task() == jflagship.auv_task()
    p = flagship.auv_params()
    p["Ma"][0][0] = 0.0                   # a copy: the table stays intact
    assert flagship.auv_params()["Ma"][0][0] == 779.79


@pytest.mark.parametrize("name", ["rexrov2", "auv_cfg"])
def test_auv_env_matches_jax(name):
    from mppi_tf_tpu.envs.analytic import AUVEnv as JAUVEnv

    cfg = _configs()[name]
    x0 = np.zeros(13)
    x0[[2, 6, 7, 12]] = [-0.5, 1.0, 0.3, 0.1]
    env, jenv = AUVEnv(cfg, dt=0.02, x0=x0), JAUVEnv(cfg, dt=0.02, x0=x0)
    rng = np.random.default_rng(22)
    # the JAX plant integrates at its default float32, the port's at
    # float64: agreement to f32 rounding over the 15 steps
    for _ in range(15):
        u = 800.0 * rng.normal(size=6)
        np.testing.assert_allclose(env.step(u), jenv.step(u), rtol=1e-5,
                                   atol=1e-6)
    assert env.getTime() == pytest.approx(jenv.getTime())
    np.testing.assert_array_equal(env.getGoal(), jenv.getGoal())
    np.testing.assert_array_equal(env.reset(), jenv.reset())
    assert env.getState().shape == (13, 1)
    np.testing.assert_allclose(env.step_fn(torch.as_tensor(x0),
                                           torch.zeros(6)).numpy(),
                               jenv.step_fn(jnp.asarray(x0), jnp.zeros(6)),
                               rtol=1e-5, atol=1e-6)


def test_from_jax_params_carries_auv_params():
    port, ref, mp = _pair("auv_cfg")
    cost, jcost = _costs()
    new_mp = {"mass": np.asarray(mp["mass"]) * 1.1,
              "inertial": np.asarray(mp["inertial"]) * [1.2, 0.9, 1.0, 2.0,
                                                        0.5, 1.0]}
    goal = np.zeros(13)
    goal[[2, 6]] = [-3.0, 1.0]
    from_jax_params(new_mp, {"goal": goal}, port, cost)
    back_m, back_c = to_jax_params(port, cost)
    np.testing.assert_array_equal(back_m["mass"], new_mp["mass"])
    np.testing.assert_array_equal(back_m["inertial"], new_mp["inertial"])
    np.testing.assert_array_equal(back_c["goal"], goal)
    rng = np.random.default_rng(23)
    x, u = _states(rng, 7), 100.0 * rng.normal(size=(7, 6))
    jmp = {k: jnp.asarray(v) for k, v in new_mp.items()}
    with torch.no_grad():
        np.testing.assert_allclose(
            port.step(_t(x), _t(u)).numpy(),
            ref.step(ref.precompute(jmp), jnp.asarray(x), jnp.asarray(u)),
            rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        cost.state_cost(_t(x)).numpy(),
        jcost.state_cost({"goal": jnp.asarray(goal)}, jnp.asarray(x)),
        rtol=1e-12)
