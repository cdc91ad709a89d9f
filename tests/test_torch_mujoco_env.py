"""The port's MuJoCo plant (``mppi_tf_tpu_torch/envs/mujoco_env.py``)
against the JAX package's (``mppi_tf_tpu/envs/mujoco_env.py``): the same
generated MJCF, the same steps bit for bit, the goal from the ``target``
site, ``get_env``'s ``.xml`` branch, and the model-based RL loop of
tests/test_mbrl_e2e.py:102-142 on the MuJoCo plant with the port's
learner and controller, at that test's sizes and gate."""

import numpy as np
import pytest
import torch

pytest.importorskip("mujoco")

from mppi_tf_tpu.envs import get_env as jget_env  # noqa: E402
from mppi_tf_tpu.envs import mujoco_env as jmujoco  # noqa: E402
from mppi_tf_tpu_torch.collect import collect_transitions  # noqa: E402
from mppi_tf_tpu_torch.controller import MPPI  # noqa: E402
from mppi_tf_tpu_torch.costs import get_cost  # noqa: E402
from mppi_tf_tpu_torch.envs import get_env  # noqa: E402
from mppi_tf_tpu_torch.envs import mujoco_env  # noqa: E402
from mppi_tf_tpu_torch.learning import Learner, ReplayBuffer  # noqa: E402
from mppi_tf_tpu_torch.models.nn import NNModel  # noqa: E402


@pytest.mark.parametrize("n_dof,goal", [(1, (1.0,)), (2, (0.3, -0.6)),
                                        (3, (1.0, 0.5, -0.5))])
def test_generated_scene_equals_jax(n_dof, goal):
    assert mujoco_env.point_mass_xml(n_dof, goal=goal) == \
        jmujoco.point_mass_xml(n_dof, goal=goal)


@pytest.mark.parametrize("n_dof", [1, 2, 3])
def test_steps_equal_jax_bit_for_bit(n_dof):
    """Both envs from the same generated MJCF, reset to the same state,
    driven by the same actions: every state equal, and the clocks."""
    goal = (0.7, -0.4, 0.2)[:n_dof]
    port = mujoco_env.make_point_mass_env(n_dof, goal=goal)
    ref = jmujoco.make_point_mass_env(n_dof, goal=goal)
    rng = np.random.default_rng(n_dof)
    x0 = rng.normal(size=2 * n_dof)
    np.testing.assert_array_equal(port.reset(x0), ref.reset(x0))
    for _ in range(50):
        u = rng.uniform(-1, 1, size=(1, n_dof))
        np.testing.assert_array_equal(port.step(u), ref.step(u))
    assert port.getTime() == ref.getTime() == pytest.approx(0.5)
    np.testing.assert_array_equal(port.getGoal(), ref.getGoal())


def test_goal_comes_from_the_target_site(tmp_path):
    env = mujoco_env.make_point_mass_env(3, goal=(1.0, 0.5, -0.5))
    np.testing.assert_array_equal(env.getGoal().ravel(),
                                  [1.0, 0.0, 0.5, 0.0, -0.5, 0.0])
    given = np.arange(6.0).reshape(6, 1)
    scene = tmp_path / "pm.xml"
    scene.write_text(mujoco_env.point_mass_xml(3))
    assert mujoco_env.MujocoEnv(str(scene), 6, 3, goal=given).getGoal() \
        is given
    # a scene without a target site: the zero goal
    scene.write_text(mujoco_env.point_mass_xml(1).replace(
        '<site name="target"', '<site name="other"'))
    np.testing.assert_array_equal(
        mujoco_env.MujocoEnv(str(scene), 2, 1).getGoal(), np.zeros((2, 1)))


def test_get_env_builds_an_xml_scene_as_jax(tmp_path):
    scene = tmp_path / "point_mass2d.xml"
    scene.write_text(mujoco_env.point_mass_xml(2, goal=(0.3, 0.9)))
    cfg = {"env": str(scene), "state-dim": 4, "action-dim": 2}
    port, ref = get_env(cfg), jget_env(cfg)
    assert isinstance(port, mujoco_env.MujocoEnv)
    assert (port.s_dim, port.a_dim) == (ref.s_dim, ref.a_dim) == (4, 2)
    np.testing.assert_array_equal(port.getGoal(), ref.getGoal())
    np.testing.assert_array_equal(port.step([[0.5, -0.5]]),
                                  ref.step([[0.5, -0.5]]))


def test_mbrl_loop_on_mujoco_env():
    """collect -> train -> control on the MuJoCo 1-DoF slide-joint point
    mass (tests/test_mbrl_e2e.py:102-142 with the port's collector,
    learner and controller, f64 on the CPU): the learned model drives the
    MuJoCo plant to the target site within 0.3."""
    torch.manual_seed(0)
    env = mujoco_env.make_point_mass_env(n_dof=1, goal=(1.0,))
    buf = ReplayBuffer(512, 2, 1)
    collect_transitions(env, buf, 400, 1, -1.0, 1.0, seed=2, control_dt=0.1)

    model = NNModel(state_dim=2, action_dim=1, dt=0.1, hidden=(16, 16),
                    dtype=torch.float64, seed=3)
    learner = Learner(model, device="cpu")
    data = buf.get_all_transitions()
    for x, u, xn in zip(data["obs"], data["act"], data["next_obs"]):
        learner.add_rb(x.reshape(-1, 1), u.reshape(-1, 1), xn.reshape(-1, 1))
    learner.stats()
    learner.train_all(epoch=300, learning_rate=1e-2)

    sigma = np.asarray([[0.4]])
    cost = get_cost({"type": "static", "diag": True, "goal": [1.0, 0.0],
                     "Q": [8.0, 1.5]}, lam=0.6, gamma=0.2, upsilon=1.0,
                    sigma=sigma, dtype=torch.float64)
    ctrl = MPPI(model, cost, k=256, tau=20, lam=0.6, upsilon=1.0,
                sigma=sigma, seed=5, device="cpu")
    ctrl.model_params = learner.params

    env.reset(np.zeros(2))
    x = env.getState()
    for _ in range(60):
        u = ctrl.next(x)
        prev = env.getTime()
        while env.getTime() - prev < 0.1 - 1e-12:
            x = env.step(np.reshape(u, (1, -1)))
    err = abs(float(np.reshape(x, (-1,))[0]) - 1.0)
    assert err < 0.3, f"mujoco MBRL control missed the goal: pos err {err}"
