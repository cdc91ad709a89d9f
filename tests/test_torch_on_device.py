"""The port's on-device closed loop (envs/mjx_env.py, ROADMAP item 13)
against the JAX package's (mppi_tf_tpu/envs/mjx_env.py) on the CPU, at f64
unless stated: the plant, the waypoint pops, the DMD window and the
graph-safe refit, and the loop itself on step-indexed injected normals
(both sides read one numpy table of normals by the period's solve index:
the JAX loop through a stand-in ``_fused`` with tile = K, so that its seed
is base + i, and a ``_fused_step`` on that table; the port's through the
same kind of stand-in reading its device counter); then the JAX tests'
gates (tests/test_envs.py:150-540) on the port's own noise, and the
runner's and the CLI's on-device branches. On the CPU the loop runs its
period eagerly; the card's captured graph is held to this eager loop bit
for bit by chip_smoke.py's on_device phase and tests/test_torch_cuda.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller.dmd import DMDMPPI as JDMDMPPI
from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.envs import mjx_env as jmjx
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.models.dmd import DMDModel as JDMDModel
from mppi_tf_tpu_torch import cli
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.envs import (AUVEnv, DevicePointMassEnv, PointMassEnv,
                                    build_on_device_loop, get_env,
                                    on_device_closed_loop, run_experiment)
from mppi_tf_tpu_torch.envs import mjx_env
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.dmd import DMDModel

F64 = torch.float64
SIGMA = np.diag([0.4, 0.4])
LAM, GAMMA = 0.6, 0.2
GOAL = [1.0, 0.0, -0.5, 0.0]
Q4 = [8.0, 1.5, 8.0, 1.5]
STATIC = {"type": "static", "diag": True, "goal": GOAL, "Q": Q4}
MISSION = {"type": "waypoints", "diag": True, "alpha": 0.2,
           "waypoints": [[0.8, 0.0, 0.0, 0.0], [0.8, 0.0, 0.8, 0.0]],
           "Q": Q4}
# the loops against JAX's on the same normals, f64: both sides compute the
# same ops in the same order but for XLA's and torch's own reductions
# (the softmax sums, the matrix products) and, adaptive, the refit (JAX
# SVD, the port's QR: 1e-15 apart on these windows)
LOOP_TOL = 1e-10
FIT_TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(task=STATIC, dmd=None, k=64, tau=8, seed=2, dtype=F64):
    """(port controller, JAX controller) of one point-mass problem on the
    CPU; ``dmd`` = {reg, rank, refit_every, mass} builds the adaptive DMD
    pair from a point-mass prior of that mass."""
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=SIGMA,
                    dtype=dtype)
    jcost = jget_cost(task, lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=SIGMA,
                      dtype=jnp.float64)
    kw = dict(k=k, tau=tau, lam=LAM, upsilon=1.0, sigma=SIGMA, seed=seed)
    if dmd is None:
        model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                          state_dim=4, action_dim=2, dtype=dtype)
        jmodel = jget_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                            state_dim=4, action_dim=2, dtype=jnp.float64)
        return MPPI(model, cost, device="cpu", **kw), JMPPI(jmodel, jcost,
                                                           **kw)
    prior = get_model({"type": "point_mass", "mass": dmd["mass"]}, dt=0.1,
                      state_dim=4, action_dim=2, dtype=F64)
    A, B = prior.A.numpy(), prior.B.numpy()
    model = DMDModel(4, 2, reg=dmd["reg"], rank=dmd.get("rank"),
                     init_A=A, init_B=B, dtype=dtype)
    jmodel = JDMDModel(4, 2, reg=dmd["reg"], rank=dmd.get("rank"),
                       init_A=A, init_B=B, dtype=jnp.float64)
    return (DMDMPPI(model, cost, device="cpu",
                    refit_every=dmd["refit_every"], **kw),
            JDMDMPPI(jmodel, jcost, refit_every=dmd["refit_every"], **kw))


def _normals(periods, k, tau, seed=5):
    """eps [periods, k, tau, 2] in action units, the solve-indexed table."""
    z = np.random.default_rng(seed).standard_normal((periods, k, tau, 2))
    return z @ SIGMA.T


def _inject(ctrl, jctrl, table):
    """Make both controllers solve period i with table[i]: the JAX loop
    reads its seed base + i (stand-in tile = K), the port's its device
    counter (a one-element int64 tensor)."""
    base = jctrl._base_seed
    jtab = jnp.asarray(table)
    jctrl._fused = type("Tile", (), {"tile": jctrl._k})()
    jctrl._fused_step = (
        lambda seed, state, useq, mp, cp, sched=None:
        jctrl._solve_with_noise(jtab[seed - base], state, useq, mp, cp,
                                sched))
    ttab = torch.as_tensor(table)
    ctrl._fused = type("Stand", (), {"forget_cached_terms": lambda s: None})()
    ctrl._fused_step = (lambda state, useq, solve=None:
                        ctrl._solve_with_noise(ttab[int(solve)], state, useq))


def _x0():
    return np.array([0.1, -0.2, 0.3, 0.05])


# ---- the plant --------------------------------------------------------------

def test_plant_step_fn_matches_jax():
    env = DevicePointMassEnv(n_dof=3, dt=0.01, mass=2.5)
    jenv = jmjx.JaxPointMassEnv(n_dof=3, dt=0.01, mass=2.5)
    rng = np.random.default_rng(50)
    for _ in range(20):
        x, u = rng.normal(size=6), rng.normal(size=3)
        got = env.step_fn(torch.as_tensor(x), torch.as_tensor(u)).numpy()
        want = np.asarray(jenv.step_fn(jnp.asarray(x), jnp.asarray(u)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_plant_host_api_matches_analytic():
    ref = PointMassEnv(n_dof=3, dt=0.01)
    dev = DevicePointMassEnv(n_dof=3, dt=0.01, dtype=F64)
    rng = np.random.default_rng(50)
    x0 = rng.normal(size=6)
    ref.reset(x0)
    dev.reset(x0)
    for _ in range(40):
        u = rng.normal(size=3)
        xr = ref.step(u.reshape(1, -1))
        xd = dev.step(u.reshape(1, -1))
    np.testing.assert_allclose(xd, xr, rtol=1e-12, atol=1e-12)
    assert dev.getTime() == pytest.approx(ref.getTime())
    assert dev.getState().shape == (6, 1)


def test_get_env_builds_the_device_plant():
    env = get_env({"env": "jax:point_mass", "state-dim": 4,
                   "action-dim": 2})
    assert isinstance(env, DevicePointMassEnv) and env.n_dof == 2
    with pytest.raises(ValueError, match="jax:point_mass"):
        get_env({"env": "mjx:point_mass"})


# ---- the pops, the window, the fit ------------------------------------------

@pytest.mark.parametrize("case", ["hit", "miss", "last"])
@pytest.mark.parametrize("quat", [False, True], ids=["pm", "quat"])
def test_waypoint_pop_matches_jax(case, quat):
    if quat:
        wps = np.zeros((3, 13))
        wps[:, 6] = 1.0
        wps[:, 2] = [-1.0, -2.0, -3.0]
        task = {"type": "waypoints_quat", "diag": True, "alpha": 0.2,
                "waypoints": wps.tolist(), "Q": [1.0] * 10,
                "max_waypoints": 4}
        state = wps[0].copy()
        state[2] += 0.3 if case != "miss" else 2.0
        sig = np.eye(6)
    else:
        task = dict(MISSION, max_waypoints=4)
        state = np.array([0.7, 0.1, 0.05, 0.0])
        if case == "miss":
            state[0] = 2.0
        sig = SIGMA
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=sig,
                    dtype=F64)
    jcost = jget_cost(task, lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=sig,
                      dtype=jnp.float64)
    jcp = jcost.init_params()
    if case == "last":
        rows = [np.asarray(jcp["waypoints"])[0]]
        cost._set_queue(rows)
        jcp = jcost._set_queue(jcp, rows)
    cp = {"count": cost.count, "waypoints": cost.waypoints}
    got = mjx_env.waypoint_pop_fn(cost, 0.5)(cp, torch.as_tensor(state))
    want = jmjx.waypoint_pop_fn(jcost, 0.5)(jcp, jnp.asarray(state))
    assert int(got["count"]) == int(want["count"])
    np.testing.assert_array_equal(got["waypoints"].numpy(),
                                  np.asarray(want["waypoints"]))
    popped = int(got["count"]) < int(cost.count)
    assert popped == (case == "hit")
    arg = mjx_env.waypoint_pop_arg_fn(cost)(cp, torch.as_tensor(state), 0.25)
    assert int(arg["count"]) == int(got["count"])


@pytest.mark.parametrize("n,W", [(0, 16), (10, 16), (40, 16)])
def test_dmd_window_matches_jax(n, W):
    ctrl, jctrl = _pair(dmd={"reg": 1e-8, "refit_every": 5, "mass": 1.0})
    rng = np.random.default_rng(n)
    for _ in range(n):
        o, a, nx = rng.normal(size=4), rng.normal(size=2), rng.normal(size=4)
        ctrl.replay.add(o, a, nx)
        jctrl.replay.add(o, a, nx)
    win = mjx_env._dmd_window(ctrl, W)
    jwin = jmjx._dmd_window(jctrl, W)
    for got, want in zip(win[:3], jwin[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert win[3] == int(jwin[3]) == min(n, W)
    assert mjx_env._dmd_window(ctrl, W) is win        # cached on total_added
    ctrl.replay.add(np.ones(4), np.ones(2), np.ones(4))
    assert mjx_env._dmd_window(ctrl, W) is not win


@pytest.mark.parametrize("reg", [1e-8, 1e-11])
@pytest.mark.parametrize("pad", [0, 24], ids=["full", "zero_padded"])
def test_ridge_fit_matches_jax(reg, pad):
    """``DMDModel.fit`` (the QR at full rank, the SVD at rank 3) against
    JAX's SVD fit within FIT_TOL at f64."""
    rng = np.random.default_rng(7)
    n = 40
    X, U = rng.normal(size=(n, 4)), 3.0 * rng.normal(size=(n, 2))
    A, B = 0.3 * rng.normal(size=(4, 4)), rng.normal(size=(4, 2))
    Xn = X @ A.T + U @ B.T + 1e-3 * rng.normal(size=(n, 4))
    X, U, Xn = (np.pad(a, ((0, pad), (0, 0))) for a in (X, U, Xn))
    for rank in (None, 3):
        got = DMDModel(4, 2, rank=rank, reg=reg, dtype=F64).fit(
            torch.as_tensor(X), torch.as_tensor(U), torch.as_tensor(Xn))
        want = JDMDModel(4, 2, rank=rank, reg=reg,
                         dtype=jnp.float64).fit(X, U, Xn)
        for name in ("A", "B"):
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]),
                                       rtol=0, atol=FIT_TOL)


def test_solve_index_tensor_is_the_int_stream():
    """A wrapper's solve index as a one-element int64 tensor reads the
    same Philox stream as the int (the plain versions on the CPU; the
    kernels on the card: tests/test_torch_cuda.py)."""
    for s in (3, 2 ** 32 + 5):
        a = pm.pm_noise_dump(7, s, 40, 3, 2, "cpu")
        b = pm.pm_noise_dump(7, torch.tensor([s]), 40, 3, 2, "cpu")
        assert torch.equal(a, b)


# ---- the loop against JAX's on injected normals -------------------------------

def _assert_loop(out, jout, tol=LOOP_TOL):
    for got, want in zip(out[:2], jout[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)


def test_loop_matches_jax_point_mass():
    steps = 30
    ctrl, jctrl = _pair()
    _inject(ctrl, jctrl, _normals(steps, 64, 8))
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    jenv = jmjx.JaxPointMassEnv(n_dof=2, dt=0.01)
    out = build_on_device_loop(ctrl, env.step_fn, steps, substeps=10)(_x0())
    jout = jmjx.build_on_device_loop(jctrl, jenv.step_fn, steps,
                                     substeps=10)(_x0(),
                                                  jax.random.PRNGKey(0))
    assert out[0].shape == (steps, 4) and out[1].shape == (steps, 2)
    _assert_loop(out, jout)
    assert ctrl._steps == jctrl._steps == steps


@pytest.mark.parametrize("rank", [None, 5], ids=["ridge", "svd_rank5"])
def test_loop_matches_jax_adaptive_dmd(rank):
    """Refits inside the loop: the ridge refit (graph-safe) and, with rank
    set, the truncated SVD run between periods; the fitted (A, B) too."""
    steps = 30
    ctrl, jctrl = _pair(dmd={"reg": 1e-8, "refit_every": 5, "mass": 1.0,
                             "rank": rank})
    _inject(ctrl, jctrl, _normals(steps, 64, 8))
    env = DevicePointMassEnv(n_dof=2, mass=3.0, dt=0.01)
    jenv = jmjx.JaxPointMassEnv(n_dof=2, mass=3.0, dt=0.01)
    A0 = ctrl._model.A.detach().clone()
    out = build_on_device_loop(ctrl, env.step_fn, steps, substeps=10)(_x0())
    jout = jmjx.build_on_device_loop(jctrl, jenv.step_fn, steps,
                                     substeps=10)(_x0(),
                                                  jax.random.PRNGKey(0))
    _assert_loop(out, jout)
    for name in ("A", "B"):
        np.testing.assert_allclose(out[2][name].numpy(),
                                   np.asarray(jout[2][name]), rtol=0,
                                   atol=FIT_TOL)
    # the controller's model is as it was (the runner writes fitted back)
    assert torch.equal(ctrl._model.A, A0)


def test_loop_matches_jax_mission():
    steps = 40
    ctrl, jctrl = _pair(task=MISSION)
    _inject(ctrl, jctrl, _normals(steps, 64, 8))
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    jenv = jmjx.JaxPointMassEnv(n_dof=2, dt=0.01)
    out = build_on_device_loop(ctrl, env.step_fn, steps, substeps=10,
                               waypoint_radius=0.35)(np.zeros(4))
    jout = jmjx.build_on_device_loop(jctrl, jenv.step_fn, steps,
                                     substeps=10, waypoint_radius=0.35)(
        np.zeros(4), jax.random.PRNGKey(0))
    _assert_loop(out, jout)
    assert int(ctrl._cost.count) == int(jctrl._cparams["count"]) == 1
    np.testing.assert_array_equal(ctrl._cost.waypoints.numpy(),
                                  np.asarray(jctrl._cparams["waypoints"]))
    assert ctrl.waypoints_remaining() == 1     # the host copy, refreshed


# ---- the JAX tests' gates on the port's own noise -------------------------------

def _ctrl(task=STATIC, k=256, tau=15, **kw):
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=4, action_dim=2)
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=SIGMA)
    return MPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=1.0,
                sigma=SIGMA, seed=2, device="cpu", **kw)


def test_on_device_closed_loop_reaches_goal():
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    states, actions = on_device_closed_loop(_ctrl(), env.step_fn,
                                            np.zeros(4), steps=60,
                                            substeps=10)
    assert states.shape == (60, 4) and actions.shape == (60, 2)
    err = np.linalg.norm(states[-1, 0::2].numpy() - np.array([1.0, -0.5]))
    assert err < 0.25, err


def test_on_device_loop_cache_and_warm_start():
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    init = np.tile([[0.7, -0.7]], (8, 1))
    ctrl = _ctrl(k=64, tau=8, init_seq=init)
    _, warm = on_device_closed_loop(ctrl, env.step_fn, np.zeros(4), steps=3,
                                    substeps=2)
    on_device_closed_loop(ctrl, env.step_fn, np.zeros(4), steps=3,
                          substeps=2)
    assert len(ctrl._ondevice_loops) == 1        # bound-method cache hit
    _, cold = on_device_closed_loop(_ctrl(k=64, tau=8), env.step_fn,
                                    np.zeros(4), steps=3, substeps=2)
    assert not np.allclose(warm[0].numpy(), cold[0].numpy(), atol=0.2)


def test_on_device_loop_params_fresh_across_calls():
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    ctrl = _ctrl()
    states, _ = on_device_closed_loop(ctrl, env.step_fn, np.zeros(4),
                                      steps=60, substeps=10)
    err1 = np.linalg.norm(states[-1, 0::2].numpy() - np.array([1.0, -0.5]))
    assert err1 < 0.25, err1
    ctrl.set_goal(np.array([-0.6, 0.0, 0.8, 0.0]))
    states, _ = on_device_closed_loop(ctrl, env.step_fn, np.zeros(4),
                                      steps=60, substeps=10)
    assert len(ctrl._ondevice_loops) == 1
    err2 = np.linalg.norm(states[-1, 0::2].numpy() - np.array([-0.6, 0.8]))
    assert err2 < 0.25, err2
    a_before = on_device_closed_loop(ctrl, env.step_fn, np.zeros(4),
                                     steps=60, substeps=10)[1]
    ctrl.model_params = {"mass": np.asarray(4.0)}
    a_after = on_device_closed_loop(ctrl, env.step_fn, np.zeros(4),
                                    steps=60, substeps=10)[1]
    assert len(ctrl._ondevice_loops) == 1
    assert not torch.allclose(a_before, a_after, atol=1e-6)


def test_on_device_loop_shares_the_noise_stream():
    """A run advances the controller's step count by its periods, so the
    next host solve draws solve step0 + steps; explicit overrides leave
    the controller's params as they were."""
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    ctrl = _ctrl(k=32, tau=5)
    ctrl._steps = 7
    run = build_on_device_loop(ctrl, env.step_fn, 4, substeps=2)
    run(np.zeros(4))
    assert ctrl._steps == 11
    run(np.zeros(4), step0=100, mparams={"mass": np.asarray(2.0)},
        cparams={"goal": np.array([0.0, 0.0, 1.0, 0.0])})
    assert ctrl._steps == 11
    assert ctrl._model.mass.item() == 1.0
    assert ctrl._cost.goal.tolist() == GOAL
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    a = run.eager(np.zeros(4), step0=3, generator=g1)
    b = run(np.zeros(4), step0=3, generator=g2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_on_device_waypoint_mission():
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    ctrl = _ctrl(task=MISSION)
    run = build_on_device_loop(ctrl, env.step_fn, steps=100, substeps=10,
                               waypoint_radius=0.35)
    states, _ = run(np.zeros(4))
    assert ctrl.waypoints_remaining() == 1 and int(ctrl._cost.count) == 1
    err = np.linalg.norm(states[-1, 0::2].numpy() - np.array([0.8, 0.8]))
    assert err < 0.3, (err, states[-1])
    # an explicit cparams is a what-if run: the mission stays as it is
    ctrl.set_waypoints(MISSION["waypoints"])
    run(np.zeros(4), cparams={"count": np.asarray(2, np.int32),
                              "waypoints": ctrl._cost.waypoints.clone()})
    assert ctrl.waypoints_remaining() == 2 and int(ctrl._cost.count) == 2
    with pytest.raises(TypeError, match="WayPointsCost"):
        build_on_device_loop(_ctrl(k=16, tau=3), env.step_fn, steps=2,
                             waypoint_radius=0.1)


def _run_cfgs(**env_over):
    env_cfg = {"env": "jax:point_mass", "state-dim": 4, "action-dim": 2,
               "dt": 0.1, "noise": (0.4 * np.eye(2)).tolist(),
               "lambda": 0.6, "gamma": 0.2, "upsilon": 1.0,
               "samples": 256, "horizon": 15, **env_over}
    return env_cfg, dict(STATIC), {"type": "point_mass", "mass": 1.0}


def test_run_experiment_on_device():
    env_cfg, task_cfg, model_cfg = _run_cfgs()
    res = run_experiment(env_cfg, task_cfg, model_cfg, steps=50,
                         on_device=True, device="cpu")
    states = res["states"]
    assert states.shape == (51, 4)
    err = np.linalg.norm(states[-1, 0::2] - np.array([1.0, -0.5]))
    assert err < 0.25, err
    assert res["on_device_ms_per_step"] > 0
    assert res["fitted_model_params"] is None
    with pytest.raises(ValueError, match="train_every"):
        run_experiment(env_cfg, task_cfg, model_cfg, steps=5,
                       on_device=True, train_every=5, device="cpu")
    with pytest.raises(ValueError, match="step_fn"):
        run_experiment(dict(env_cfg, env="analytic:point_mass"), task_cfg,
                       model_cfg, steps=5, on_device=True, device="cpu")


def test_run_experiment_on_device_logs_rows(tmp_path):
    env_cfg, task_cfg, model_cfg = _run_cfgs(samples=32, horizon=5)
    res = run_experiment(env_cfg, task_cfg, model_cfg, steps=6,
                         on_device=True, device="cpu", log=True,
                         log_path=str(tmp_path))
    obs = res["observer"]
    obs.close()
    assert obs.step == 6
    rows = [json.loads(ln) for p in tmp_path.glob("**/metrics.jsonl")
            for ln in p.read_text().splitlines() if "Input/axis_0" in ln]
    np.testing.assert_allclose([r["Input/axis_0"] for r in rows],
                               res["actions"][:, 0], rtol=1e-6)
    assert [r["step"] for r in rows] == list(range(6))


def test_on_device_auv_closed_loop():
    """The AUV flagship's dive through the analytic plant's step_fn,
    normalized, at the JAX test's K = 256, H = 15: |z + 1| < 0.2, |q| = 1
    within 1e-3."""
    from tests.test_auv_kernel import _auv_cfg

    goal = np.zeros(13)
    goal[2], goal[6] = -1.0, 1.0
    sigma = np.diag([2000.0] * 3 + [200.0] * 3)
    model = get_model(_auv_cfg(), dt=0.1, action_dim=6)
    cost = get_cost({"type": "static_quat", "diag": True,
                     "goal": goal.tolist(),
                     "Q": [60.0, 60.0, 60.0, 10.0] + [1.0] * 6},
                    lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma)
    ctrl = MPPI(model, cost, k=256, tau=15, lam=0.5, upsilon=1.0,
                sigma=sigma, seed=3, normalize_cost=True, device="cpu")
    env = AUVEnv(_auv_cfg(), dt=0.02)
    x0 = np.zeros(13)
    x0[6] = 1.0
    states, actions = on_device_closed_loop(ctrl, env.step_fn, x0,
                                            steps=160, substeps=5)
    states = states.numpy()
    assert states.shape == (160, 13) and actions.shape == (160, 6)
    np.testing.assert_allclose(np.linalg.norm(states[:, 3:7], axis=1), 1.0,
                               atol=1e-3)
    assert abs(states[-1, 2] - goal[2]) < 0.2, states[-1, 2]


class TestOnDeviceAdaptiveDMD:
    """The JAX package's pair (tests/test_envs.py:483-537) on the port."""

    def test_identification_inside_the_loop_converges(self):
        cost = get_cost(STATIC, lam=LAM, gamma=GAMMA, upsilon=1.0,
                        sigma=SIGMA, dtype=F64)
        prior = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                          state_dim=4, action_dim=2, dtype=F64)
        truth = get_model({"type": "point_mass", "mass": 3.0}, dt=0.1,
                          state_dim=4, action_dim=2, dtype=F64)
        dmd = DMDModel(4, 2, reg=1e-11, dtype=F64, init_A=prior.A.numpy(),
                       init_B=prior.B.numpy())
        ctrl = DMDMPPI(dmd, cost, k=256, tau=15, lam=LAM, upsilon=1.0,
                       sigma=SIGMA, seed=2, refit_every=5, device="cpu")
        env = DevicePointMassEnv(n_dof=2, mass=3.0, dt=0.01)
        states, _, fitted = on_device_closed_loop(ctrl, env.step_fn,
                                                  np.zeros(4), steps=60,
                                                  substeps=10)
        assert states.shape == (60, 4)
        np.testing.assert_allclose(fitted["A"].numpy(), truth.A.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(fitted["B"].numpy(),
                                   truth.B.numpy() / 3.0, atol=1e-5)
        err = np.linalg.norm(states[-1, 0::2].numpy()
                             - np.array([1.0, -0.5]))
        assert err < 0.25, err

    def test_run_experiment_on_device_dmd_syncs_params(self):
        env_cfg, task_cfg, _ = _run_cfgs(samples=128, horizon=10)
        env_cfg["refit-every"] = 5
        res = run_experiment(env_cfg, task_cfg, {"type": "dmd", "reg": 1e-8},
                             steps=40, on_device=True, device="cpu")
        fitted = res["fitted_model_params"]
        assert fitted is not None and np.all(np.isfinite(res["states"]))
        ctrl = res["controller"]
        assert torch.equal(ctrl.model_params["A"], fitted["A"])
        truth = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                          state_dim=4, action_dim=2)
        np.testing.assert_allclose(fitted["A"].numpy(), truth.A.numpy(),
                                   atol=1e-3)


def test_sharded_controllers_name_their_item():
    """A non-controller is refused; a mesh-sharded controller (ROADMAP item
    14) builds the loop and runs it (tests/test_torch_sharded_loop.py
    holds its gates)."""
    from mppi_tf_tpu_torch.parallel import ShardedMPPI, make_mesh

    with pytest.raises(TypeError, match="MPPI controllers"):
        build_on_device_loop(object(), lambda x, u: x, steps=2)
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=4, action_dim=2)
    cost = get_cost(STATIC, lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=SIGMA)
    ctrl = ShardedMPPI(model, cost, make_mesh(devices=["cpu"] * 2), k=32,
                       tau=5, lam=LAM, upsilon=1.0, sigma=SIGMA)
    states, actions = build_on_device_loop(
        ctrl, DevicePointMassEnv(n_dof=2, dt=0.01).step_fn, steps=2)(
            np.zeros(4))
    assert states.shape == (2, 4) and actions.shape == (2, 2)
    assert torch.all(torch.isfinite(states))


def test_cli_on_device_runs(tmp_path, capsys):
    from mppi_tf_tpu_torch.cfg import config

    env_cfg, task_cfg, _ = _run_cfgs(samples=64, horizon=8)
    path = config.write_config(env_cfg, str(tmp_path / "env.yaml"))
    task = config.write_config(task_cfg, str(tmp_path / "task.yaml"))
    assert cli.main(["--config", path, "--task", task,
                     "--model", "models/point_mass_model", "-s", "5",
                     "--on-device", "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 5 and out["on_device_ms_per_step"] > 0
    assert "avg_solve_ms" not in out and len(out["final_state"]) == 4
