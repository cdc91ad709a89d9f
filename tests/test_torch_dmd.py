"""DMD adaptive control in the port (learning/replay.py, models/dmd.py,
controller/dmd.py) against the JAX package on the same numpy-made
transitions and noise: the replay ring, the DMDc fits at f64, the factory
and runner routes, checkpoints, a 30-step f64 closed loop with refits in
both packages, and the adaptive loop of the JAX bench
(run_adaptive_dmd_loop_workload) at a CPU size in both packages, whose
readings set chip_smoke.py's dmd_adaptive gates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller.dmd import DMDMPPI as JDMDMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.learning.replay import ReplayBuffer as JReplayBuffer
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.models.dmd import DMDModel as JDMDModel
from mppi_tf_tpu_torch.controller import MPPI, get_controller
from mppi_tf_tpu_torch.controller.dmd import DMDMPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.envs import PointMassEnv, run_experiment
from mppi_tf_tpu_torch.envs.runner import ClosedLoopRunner
from mppi_tf_tpu_torch.learning import ReplayBuffer
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.dmd import DMDModel

SIGMA2 = np.diag([0.4, 0.4])
TASK2 = {"type": "static", "diag": True, "goal": [1.0, 0.0, -0.5, 0.0],
         "Q": [6.0, 0.4, 6.0, 0.4]}
# the JAX bench's point-mass row (mppi_tf_tpu/bench.py:95-106)
SIGMA3 = np.diag([0.25, 0.25, 0.25])
GOAL3 = [1.0, 0.0, 0.5, 0.0, -0.5, 0.0]
TASK3 = {"type": "static", "diag": True, "goal": GOAL3,
         "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}
# chip_smoke.py's dmd_adaptive gates: both packages end this loop within
# ~3e-3 of the goal with max |B - B_true/3| ~ 6e-7 at f32 (K=2,000, H=20)
ADAPT_GOAL_TOL, ADAPT_B_TOL = 0.05, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _truth(mass=1.3, sdim=4, adim=2):
    """The point mass's exact (A, B) (B with the mass) as f64 numpy."""
    pm = jget_model({"type": "point_mass", "mass": mass}, dt=0.1,
                    state_dim=sdim, action_dim=adim, dtype=jnp.float64)
    return np.asarray(pm._A), np.asarray(pm._B) / mass


def _transitions(A, B, n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, A.shape[0])
    U = rng.randn(n, B.shape[1])
    return X, U, X @ A.T + U @ B.T


def _pair(sdim=4, adim=2, dtype64=True, **kw):
    """The port's and the JAX package's DMDModel with the same options."""
    return (DMDModel(sdim, adim, dtype=torch.float64 if dtype64
                     else torch.float32, **kw),
            JDMDModel(sdim, adim, dtype=jnp.float64 if dtype64
                      else jnp.float32, **kw))


def _close_params(port: dict, ref: dict, **tol):
    for key in ("A", "B"):
        np.testing.assert_allclose(np.asarray(port[key]),
                                   np.asarray(ref[key]), **tol)


# ---------------------------------------------------------------------------
# the replay buffer
# ---------------------------------------------------------------------------

def _fill(rb, n, seed=0):
    rng = np.random.default_rng(seed)
    rows = [(rng.normal(size=3), rng.normal(size=2), rng.normal(size=3))
            for _ in range(n)]
    for o, a, n_ in rows:
        rb.add(o, a.reshape(-1, 1), n_)
    return rows


@pytest.mark.parametrize("n", [3, 5, 12])
def test_replay_ring_order_matches_jax(n):
    """Oldest first before the ring fills, at exactly full and after it
    wraps (capacity 5), equal to the JAX package's buffer."""
    rb, jrb = ReplayBuffer(5, 3, 2), JReplayBuffer(5, 3, 2, use_native=False)
    rows = _fill(rb, n)
    _fill(jrb, n)
    tr, jtr = rb.get_all_transitions(), jrb.get_all_transitions()
    keep = rows[-5:]
    assert len(rb) == len(jrb) == min(n, 5) and rb.total_added == n
    assert rb.backend == "native"
    for i, key in enumerate(("obs", "act", "next_obs")):
        np.testing.assert_array_equal(tr[key], jtr[key])
        np.testing.assert_array_equal(tr[key],
                                      np.stack([r[i].ravel() for r in keep]))


def test_replay_sample_over_a_full_ring():
    rb = ReplayBuffer(4, 3, 2, use_native=True)
    with pytest.raises(ValueError, match="empty"):
        rb.sample(2)
    _fill(rb, 7)
    live = {tuple(o) for o in rb.get_all_transitions()["obs"]}
    batch = rb.sample(64, np.random.default_rng(1))
    assert batch["obs"].shape == (64, 3) and batch["act"].shape == (64, 2)
    assert {tuple(o) for o in batch["obs"]} <= live
    # a sampled row keeps its transition together
    tr = rb.get_all_transitions()
    i = int(np.argmax([np.array_equal(o, batch["obs"][0])
                       for o in tr["obs"]]))
    np.testing.assert_array_equal(batch["next_obs"][0], tr["next_obs"][i])


@pytest.mark.parametrize("ext", [".npz", ".csv"])
def test_replay_save_load_round_trip(tmp_path, ext):
    """npz and the C++ DataBase CSV layout round-trip, and the JAX
    package's buffer reads the port's file."""
    rb = ReplayBuffer(8, 3, 2)
    _fill(rb, 11)
    path = str(tmp_path / f"tr{ext}")
    rb.save_transitions(path)
    back, jback = ReplayBuffer(8, 3, 2), JReplayBuffer(8, 3, 2,
                                                       use_native=False)
    back.load_transitions(path)
    jback.load_transitions(path)
    for key, v in rb.get_all_transitions().items():
        np.testing.assert_allclose(back.get_all_transitions()[key], v,
                                   rtol=1e-15)
        np.testing.assert_allclose(jback.get_all_transitions()[key], v,
                                   rtol=1e-15)
    if ext == ".csv":
        with open(path) as f:
            assert f.readline().strip() == ("x0,x1,x2,u0,u1,x_next0,"
                                            "x_next1,x_next2")


# ---------------------------------------------------------------------------
# the DMDc fit at f64
# ---------------------------------------------------------------------------

def test_fit_recovers_lti_exactly_as_jax():
    """Noiseless LTI data: the port's fit equals JAX's to 1e-9 and both
    recover the plant (tests/test_dmd.py:38-55)."""
    A, B = _truth()
    X, U, Xn = _transitions(A, B, 50)
    port, ref = _pair(reg=0.0)
    p = port.fit(X, U, Xn)
    _close_params(p, ref.fit(X, U, Xn), atol=1e-9)
    np.testing.assert_allclose(p["A"].numpy(), A, atol=1e-9)
    np.testing.assert_allclose(p["B"].numpy(), B, atol=1e-9)
    X2, U2, Xn2 = _transitions(A, B, 10, seed=1)
    with torch.no_grad():
        port.A.copy_(p["A"])
        port.B.copy_(p["B"])
        pred = port.step(torch.as_tensor(X2), torch.as_tensor(U2))
    np.testing.assert_allclose(pred.numpy(), Xn2, atol=1e-8)


def test_fit_rank_truncation_with_noise_as_jax():
    """Noisy data, rank s+a and damping 1e-8 (tests/test_dmd.py:57-71)."""
    A, B = _truth()
    X, U, Xn = _transitions(A, B, 400)
    Xn = Xn + 1e-3 * np.random.RandomState(3).randn(*Xn.shape)
    port, ref = _pair(rank=6, reg=1e-8)
    p = port.fit(X, U, Xn)
    _close_params(p, ref.fit(X, U, Xn), atol=1e-9)
    assert np.abs(p["A"].numpy() - A).max() < 1e-3
    assert np.abs(p["B"].numpy() - B).max() < 1e-3
    # a lower rank truncates both packages alike
    port3, ref3 = _pair(rank=3, reg=1e-8)
    _close_params(port3.fit(X, U, Xn), ref3.fit(X, U, Xn), atol=1e-9)


def test_fit_from_buffer_pads_as_jax():
    """The zero-padded buffer fit equals the raw fit and JAX's padded fit
    (tests/test_dmd.py:135-158)."""
    A, B = _truth()
    X, U, Xn = _transitions(A, B, 37)
    rb, jrb = ReplayBuffer(128, 4, 2), JReplayBuffer(128, 4, 2,
                                                     use_native=False)
    for i in range(37):
        rb.add(X[i], U[i], Xn[i])
        jrb.add(X[i], U[i], Xn[i])
    port, ref = _pair(reg=1e-12)
    p_pad = port.fit_from_buffer(rb)
    _close_params(p_pad, port.fit(X, U, Xn), atol=1e-9)
    _close_params(p_pad, ref.fit_from_buffer(jrb), atol=1e-9)
    np.testing.assert_allclose(p_pad["A"].numpy(), A, atol=1e-7)
    assert p_pad["A"].device.type == "cpu"


def test_fit_leaves_the_model_and_keeps_its_dtype():
    A, B = _truth()
    X, U, Xn = _transitions(A, B, 30)
    model = DMDModel(4, 2)
    p = model.fit(X, U, Xn)
    assert p["A"].dtype == torch.float32 and p["B"].shape == (4, 2)
    np.testing.assert_array_equal(model.A.detach().numpy(), np.eye(4))
    np.testing.assert_array_equal(model.B.detach().numpy(), 0.0)


def test_model_validation_errors():
    """The same errors as JAX (tests/test_dmd.py:81-86)."""
    dmd = DMDModel(4, 2)
    with pytest.raises(ValueError, match="rank"):
        DMDModel(4, 2, rank=7)
    with pytest.raises(ValueError, match="rank"):
        DMDModel(4, 2, rank=0)
    with pytest.raises(ValueError, match="init_A"):
        DMDModel(4, 2, init_A=np.eye(3))
    with pytest.raises(ValueError, match="init_B"):
        DMDModel(4, 2, init_B=np.zeros((4, 3)))
    with pytest.raises(ValueError, match="X must be"):
        dmd.fit(np.zeros((5, 3)), np.zeros((5, 2)), np.zeros((5, 3)))
    with pytest.raises(ValueError, match="U must be"):
        dmd.fit(np.zeros((5, 4)), np.zeros((5, 3)), np.zeros((5, 4)))
    with pytest.raises(ValueError, match="Xn"):
        dmd.fit(np.zeros((5, 4)), np.zeros((5, 2)), np.zeros((6, 4)))


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def _cost2(dtype=torch.float64):
    return get_cost(TASK2, lam=0.4, gamma=0.1, upsilon=1.0, sigma=SIGMA2,
                    dtype=dtype)


def _explore(ctrl, A, B, n=30, seed=7):
    """Random actions on the true plant, fed through save(); returns the
    last state."""
    rng = np.random.RandomState(seed)
    x = np.zeros(A.shape[0])
    for _ in range(n):
        u = rng.uniform(-1.0, 1.0, size=B.shape[1])
        xn = A @ x + B @ u
        ctrl.save(x, u, xn)
        x = xn
    return x


def test_guards_and_fit_now():
    """TypeError for another model, fit_now below min_samples, and
    fit_now on a seeded buffer (tests/test_dmd.py:307-320)."""
    pm = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1, state_dim=4,
                   action_dim=2, dtype=torch.float64)
    with pytest.raises(TypeError, match="DMDModel"):
        DMDMPPI(pm, _cost2(), k=8, tau=3, lam=0.4, sigma=SIGMA2,
                device="cpu")
    with pytest.raises(ValueError, match="refit_every"):
        DMDMPPI(DMDModel(4, 2, dtype=torch.float64), _cost2(), k=8, tau=3,
                lam=0.4, sigma=SIGMA2, device="cpu", refit_every=0)
    ctrl = DMDMPPI(DMDModel(4, 2, dtype=torch.float64, reg=1e-12),
                   _cost2(), k=8, tau=3, lam=0.4, sigma=SIGMA2,
                   device="cpu", refit_every=1000)
    assert ctrl._min_samples == 12 and ctrl.n_fits == 0
    with pytest.raises(ValueError, match="min_samples"):
        ctrl.fit_now()
    A, B = _truth()
    _explore(ctrl, A, B, n=12)
    assert ctrl.n_fits == 0 and len(ctrl.replay) == 12
    ctrl.fit_now()
    assert ctrl.n_fits == 1
    np.testing.assert_allclose(ctrl.model_params["A"].numpy(), A, atol=1e-6)


def test_online_adaptation_reaches_goal():
    """From the identity prior, 30 exploration transitions identify the
    plant; the identified model then drives it to the goal with refits
    mid-run (tests/test_dmd.py:89-133, the same gates)."""
    A, B = _truth()
    ctrl = DMDMPPI(DMDModel(4, 2, dtype=torch.float64, reg=1e-10),
                   _cost2(), k=600, tau=20, lam=0.4, upsilon=1.0,
                   sigma=SIGMA2, seed=4, refit_every=5, device="cpu")
    _explore(ctrl, A, B)
    assert ctrl.n_fits >= 1
    np.testing.assert_allclose(ctrl.model_params["A"].numpy(), A, atol=1e-6)
    goal = np.asarray(TASK2["goal"])
    x = np.zeros(4)
    d0 = np.linalg.norm(x[[0, 2]] - goal[[0, 2]])
    for _ in range(60):
        u = ctrl.next(x)
        xn = A @ x + B @ u
        ctrl.save(x, u, xn)
        x = xn
    d = np.linalg.norm(x[[0, 2]] - goal[[0, 2]])
    assert d < 0.15 and d < 0.25 * d0, (d, d0)


def test_checkpoint_resume_with_jax_keys(tmp_path):
    """save_state / load_state carry (A, B), the replay window and the
    counters; the side file has the JAX package's keys, and a resumed
    controller refits at the same save (tests/test_dmd.py:182-227)."""
    A, B = _truth()

    def mk():
        return DMDMPPI(DMDModel(4, 2, dtype=torch.float64, reg=1e-10),
                       _cost2(), k=64, tau=8, lam=0.4, upsilon=1.0,
                       sigma=SIGMA2, seed=4, refit_every=5, device="cpu")

    a = mk()
    x = _explore(a, A, B, n=17)
    path = str(tmp_path / "dmd_ckpt.npz")
    a.save_state(path)
    side = np.load(path + ".dmd.npz")
    assert set(side.files) == {"A", "B", "obs", "act", "next_obs", "saves",
                               "fits"}
    b = mk()
    b.load_state(path)
    assert (b.n_fits, b._saves, len(b.replay)) == (a.n_fits, 17, 17) == (
        1, 17, 17)
    np.testing.assert_array_equal(b.model_params["A"].numpy(),
                                  a.model_params["A"].numpy())
    u = np.array([0.1, -0.2])
    for ctrl in (a, b):
        for _ in range(3):
            ctrl.save(x, u, A @ x + B @ u)
    assert b.n_fits == a.n_fits == 2
    np.testing.assert_allclose(b.model_params["A"].numpy(),
                               a.model_params["A"].numpy())
    np.testing.assert_allclose(b.next(x), a.next(x))


def _env_cfg():
    return {"env": "analytic:point_mass", "state-dim": 4, "action-dim": 2,
            "dt": 0.1, "noise": SIGMA2.tolist(), "lambda": 0.4,
            "gamma": 0.1, "upsilon": 1.0, "samples": 400, "horizon": 15,
            "refit-every": 5}


def test_factory_and_runner_route():
    """get_controller gives a DMDMPPI for a DMD model with the config's
    refit-every (overrides win), and run_experiment on analytic:point_mass
    identifies the plant on the fly and converges (tests/test_dmd.py:
    230-273 without the mesh part)."""
    env_cfg, model_cfg = _env_cfg(), {"type": "dmd", "reg": 1e-9}
    cost = get_cost(TASK2, lam=0.4, gamma=0.1, upsilon=1.0, sigma=SIGMA2)
    dmd = get_model(model_cfg, dt=0.1, state_dim=4, action_dim=2)
    ctrl = get_controller(dmd, cost, dict(env_cfg, **{
        "min-samples": 20, "buffer-capacity": 64}), device="cpu")
    assert isinstance(ctrl, DMDMPPI)
    assert (ctrl._refit_every, ctrl._min_samples,
            ctrl.replay.capacity) == (5, 20, 64)
    assert get_controller(dmd, cost, env_cfg, refit_every=2,
                          device="cpu")._refit_every == 2
    res = run_experiment(env_cfg, TASK2, model_cfg, steps=80, seed=3,
                         device="cpu")
    assert isinstance(res["controller"], DMDMPPI)
    assert res["controller"].n_fits >= 1
    err = np.linalg.norm(res["states"][-1][[0, 2]] - np.array([1.0, -0.5]))
    assert err < 0.3, err


def test_cli_dmd_model_in_both_packages(capsys):
    """--model models/dmd_model on the bundled envs/point_mass (K=3,000,
    H=50), 100 steps on the CPU: both packages' runners refit through
    save() and end within 0.3 of the goal (0.10 and 0.11 when measured),
    the gate of chip_smoke.py's CLI run on the card."""
    import json

    from mppi_tf_tpu import cli as jcli
    from mppi_tf_tpu_torch import cli
    from mppi_tf_tpu_torch.cfg import default_config

    argv = ["--cpu", "--config", "envs/point_mass", "--task",
            "tasks/static_cost", "--model", "models/dmd_model", "-s", "100"]
    goal = np.asarray(default_config("tasks/static_cost")["goal"])
    outs = []
    for main in (cli.main, jcli.main):
        assert main(argv) == 0
        outs.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    assert outs[0]["kernel_path"] == "torch" and outs[0]["n_fits"] == 9
    for out in outs:
        err = np.linalg.norm(np.asarray(out["final_state"]) - goal)
        assert err < 0.3, out


def _f64_pair(normalize):
    """The bench configuration at a small K in both packages at f64: a
    mass-1 prior against a mass-3 plant, refit every 5 saves."""
    pm1 = jget_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                     state_dim=6, action_dim=3, dtype=jnp.float64)
    A, B1 = np.asarray(pm1._A), np.asarray(pm1._B)
    kw = dict(k=64, tau=8, lam=0.8, upsilon=1.0, sigma=SIGMA3,
              refit_every=5, normalize_cost=normalize)
    port = DMDMPPI(
        DMDModel(6, 3, init_A=A, init_B=B1, reg=1e-10, dtype=torch.float64),
        get_cost(TASK3, lam=0.8, gamma=0.2, upsilon=1.0, sigma=SIGMA3,
                 dtype=torch.float64), device="cpu", **kw)
    ref = JDMDMPPI(
        JDMDModel(6, 3, init_A=A, init_B=B1, reg=1e-10, dtype=jnp.float64),
        jget_cost(TASK3, lam=0.8, gamma=0.2, upsilon=1.0, sigma=SIGMA3,
                  dtype=jnp.float64), **kw)
    return port, ref, A, B1 / 3.0


@pytest.mark.parametrize("normalize", [False, True])
def test_closed_loop_with_refits_matches_jax_f64(normalize):
    """30 steps on the same injected eps, save() after every step
    (refits at saves 20, 25, 30): actions, the carried sequence and the
    identified (A, B) equal JAX's at rtol 1e-10."""
    port, ref, A, B = _f64_pair(normalize)
    rng = np.random.default_rng(11)
    x_p = x_j = np.zeros(6)
    fits = []
    for step in range(30):
        eps = rng.normal(size=(64, 8, 3)) * 0.25
        a_p, port._useq, _ = port._solve_with_noise(
            torch.as_tensor(eps), torch.as_tensor(x_p), port._useq)
        a_j, ref._useq, _ = ref._solve_with_noise(
            jnp.asarray(eps), jnp.asarray(x_j), ref._useq,
            ref.model_params, ref._cparams)
        a_p, a_j = a_p.numpy(), np.asarray(a_j)
        np.testing.assert_allclose(a_p, a_j, rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(port.useq.numpy(), np.asarray(ref._useq),
                                   rtol=1e-10, atol=1e-13)
        xn_p, xn_j = A @ x_p + B @ a_p, A @ x_j + B @ a_j
        port.save(x_p, a_p, xn_p)
        ref.save(x_j, a_j, xn_j)
        x_p, x_j = xn_p, xn_j
        fits.append(port.n_fits)
        assert port.n_fits == ref.n_fits
        # entries near 0 carry the fit's absolute rounding (~1e-13)
        _close_params(port.model_params, ref.model_params, rtol=1e-10,
                      atol=1e-11)
    assert fits[18] == 0 and fits[19] == 1 and port.n_fits == 3
    assert np.abs(port.model_params["B"].numpy() - B).max() < 1e-6


def _adaptive_run(package, k=2000, tau=20, steps=200):
    """The JAX bench's adaptive loop (bench.py:722-763) through each
    package's own ClosedLoopRunner at a CPU size: (final states, the
    identified B, B_true / 3, refits)."""
    if package == "port":
        prior = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                          state_dim=6, action_dim=3)
        A1, B1 = prior.A.numpy(), prior.B.numpy()
        ctrl = DMDMPPI(DMDModel(6, 3, init_A=A1, init_B=B1, reg=1e-8),
                       get_cost(TASK3, lam=0.8, gamma=0.2, upsilon=1.0,
                                sigma=SIGMA3),
                       k=k, tau=tau, lam=0.8, upsilon=1.0, sigma=SIGMA3,
                       refit_every=10, device="cpu")
        env = PointMassEnv(n_dof=3, mass=3.0, dt=0.01)
        states, _ = ClosedLoopRunner(env, ctrl, 0.1).run(steps)
        return states, ctrl.model_params["B"].numpy(), B1 / 3.0, ctrl.n_fits
    from mppi_tf_tpu.envs.analytic import PointMassEnv as JEnv
    from mppi_tf_tpu.envs.runner import ClosedLoopRunner as JRunner

    prior = jget_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                       state_dim=6, action_dim=3)
    B1 = np.asarray(prior._B)
    ctrl = JDMDMPPI(JDMDModel(6, 3, init_A=np.asarray(prior._A), init_B=B1,
                              reg=1e-8),
                    jget_cost(TASK3, lam=0.8, gamma=0.2, upsilon=1.0,
                              sigma=SIGMA3),
                    k=k, tau=tau, lam=0.8, upsilon=1.0, sigma=SIGMA3,
                    refit_every=10)
    states, _ = JRunner(JEnv(n_dof=3, mass=3.0, dt=0.01), ctrl, 0.1).run(
        steps)
    return states, np.asarray(ctrl.model_params["B"]), B1 / 3.0, ctrl.n_fits


@pytest.mark.parametrize("package", ["port", "jax"])
def test_adaptive_loop_in_both_packages(package):
    """A mass-1 prior against the mass-3 plant at control dt 0.1 (plant dt
    0.01), refit every 10 saves, reg 1e-8, 200 steps: both packages end
    within ADAPT_GOAL_TOL of the goal with the identified B within
    ADAPT_B_TOL of B_true / 3, the gates chip_smoke.py's dmd_adaptive
    holds the card to at K=100,000, H=50."""
    states, B, B_true, n_fits = _adaptive_run(package)
    assert n_fits == 19   # saves 20, 30, ..., 200 (min_samples 18)
    err = np.linalg.norm(states[-1] - np.asarray(GOAL3))
    b_err = np.abs(B - B_true).max()
    assert err < ADAPT_GOAL_TOL and b_err < ADAPT_B_TOL, (err, b_err)


# ---------------------------------------------------------------------------
# the repairs: the factories dispatch on the model, as JAX does
# ---------------------------------------------------------------------------

def test_dmd_keys_are_ignored_for_other_models():
    """A point-mass model with refit-every gets a plain MPPI in both
    packages, and one solve on the same injected eps gives the same
    action."""
    from mppi_tf_tpu.controller import get_controller as jget_controller

    cfg = {"samples": 32, "horizon": 5, "lambda": 0.8, "noise":
           SIGMA3.tolist(), "refit-every": 10, "min-samples": 4,
           "buffer-capacity": 16}
    mcfg = {"type": "point_mass", "mass": 1.5}
    port = get_controller(
        get_model(mcfg, dt=0.1, state_dim=6, action_dim=3,
                  dtype=torch.float64),
        get_cost(TASK3, lam=0.8, gamma=0.2, upsilon=1.0, sigma=SIGMA3,
                 dtype=torch.float64), cfg, device="cpu")
    ref = jget_controller(
        jget_model(mcfg, dt=0.1, state_dim=6, action_dim=3,
                   dtype=jnp.float64),
        jget_cost(TASK3, lam=0.8, gamma=0.2, upsilon=1.0, sigma=SIGMA3,
                  dtype=jnp.float64), cfg)
    assert type(port) is MPPI and type(ref).__name__ == "MPPI"
    eps = np.random.default_rng(3).normal(size=(32, 5, 3)) * 0.25
    x = np.full(6, 0.1)
    a_p, _, _ = port._solve_with_noise(torch.as_tensor(eps),
                                       torch.as_tensor(x), port.useq)
    a_j, _, _ = ref._solve_with_noise(jnp.asarray(eps), jnp.asarray(x),
                                      ref.useq, ref.model_params,
                                      ref._cparams)
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=1e-10)


def test_model_params_round_trip_in_place():
    """The getter gives detached copies in the JAX layout; the setter
    writes arrays or tensors into the model's own tensors."""
    model = DMDModel(4, 2, dtype=torch.float64)
    ctrl = DMDMPPI(model, _cost2(), k=8, tau=3, lam=0.4, sigma=SIGMA2,
                   device="cpu")
    a_ref = model.A
    mp = ctrl.model_params
    assert set(mp) == {"A", "B"} and mp["A"] is not model.A
    A, B = _truth()
    ctrl.model_params = {"A": A, "B": torch.as_tensor(B)}
    assert model.A is a_ref
    np.testing.assert_array_equal(model.A.detach().numpy(), A)
    np.testing.assert_array_equal(model.B.detach().numpy(), B)
    with pytest.raises(KeyError):
        ctrl.model_params = {"A": A}
    # the point mass carries {"mass"}
    pm = MPPI(get_model({"type": "point_mass", "mass": 2.0}, dt=0.1,
                        state_dim=4, action_dim=2),
              _cost2(torch.float32), k=8, tau=3, lam=0.4, sigma=SIGMA2,
              device="cpu")
    assert set(pm.model_params) == {"mass"}
    pm.model_params = {"mass": 3.0}
    assert pm._model.mass.item() == 3.0
