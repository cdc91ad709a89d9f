"""The port's native f64 MPPI core (``mppi_tf_tpu_torch/native/core.py``,
its own copy of ``mppi_core.cpp``) against the JAX package's binding of
the same source, and the port's plain f64 point-mass solve against it.

The two bindings compile one source at -O3 (the JAX package's with
-fopenmp, the port's without: its one parallel loop computes each sample
alone), so they agree bit for bit on the cases of
tests/test_native_core.py (the shared problem, the update with and
without normalisation, the fuzzed instances). The port's torch solve is a
different implementation of the same law: 1e-10.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from mppi_tf_tpu.native import core as jcore
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.native import core

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64


def _instance(rng, k, tau, adim, dt, mass, lam, gamma, upsilon, sigma,
              normalize):
    """A point-mass problem in both forms: the native arguments and the
    port's f64 controller."""
    sdim = 2 * adim
    model = get_model({"type": "point_mass", "mass": mass}, dt=dt,
                      state_dim=sdim, action_dim=adim, dtype=F64)
    goal = rng.standard_normal(sdim)
    qd = rng.uniform(0.1, 10.0, size=sdim)
    cost = get_cost({"type": "static", "diag": True, "goal": goal.tolist(),
                     "Q": qd.tolist()}, lam=lam, gamma=gamma,
                    upsilon=upsilon, sigma=sigma, dtype=F64)
    ctrl = MPPI(model, cost, k=k, tau=tau, lam=lam, upsilon=upsilon,
                sigma=sigma, normalize_cost=normalize, device="cpu")
    eps = np.einsum("ij,ktj->kti", upsilon * sigma,
                    rng.standard_normal((k, tau, adim)))
    x0 = rng.standard_normal(sdim)
    useq = 0.3 * rng.standard_normal((tau, adim))
    A = model.A.detach().numpy()
    Bm = model.B.detach().numpy() / mass
    args = (A, Bm, x0, useq, eps, np.diag(qd), goal, np.linalg.inv(sigma))
    return ctrl, args, dict(lam=lam, gamma=gamma, upsilon=upsilon)


@pytest.fixture(scope="module")
def problem():
    """tests/test_native_core.py's problem."""
    rng = np.random.RandomState(7)
    k, tau, adim = 257, 12, 3
    sigma = np.diag([0.25, 0.3, 0.2])
    eps = np.einsum("ij,ktj->kti", 1.3 * sigma, rng.randn(k, tau, adim))
    x0 = np.array([0.2, 0.0, -0.1, 0.0, 0.3, 0.0])
    useq = 0.1 * rng.randn(tau, adim)
    model = get_model({"type": "point_mass", "mass": 1.7}, dt=0.1,
                      state_dim=6, action_dim=3, dtype=F64)
    args = (model.A.numpy(), model.B.numpy() / 1.7, x0, useq, eps,
            np.diag([5.0, 1.0, 5.0, 1.0, 5.0, 1.0]),
            np.array([1.0, 0.0, 0.5, 0.0, -0.5, 0.0]), np.linalg.inv(sigma))
    return args


def test_source_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(REPO / "mppi_tf_tpu_torch/native/src/mppi_core.cpp",
                       REPO / "mppi_tf_tpu/native/src/mppi_core.cpp",
                       shallow=False)
    assert core.library_path().parent == (REPO / "mppi_tf_tpu_torch"
                                          / "_build")


def test_rollout_costs_equal_the_jax_binding(problem):
    kw = dict(lam=0.8, gamma=0.2, upsilon=1.3)
    np.testing.assert_array_equal(core.pm_rollout(*problem, **kw),
                                  jcore.pm_rollout(*problem, **kw))


@pytest.mark.parametrize("normalize", [False, True])
def test_update_equals_the_jax_binding(problem, normalize):
    costs = 10.0 + 5.0 * np.random.RandomState(1).rand(problem[4].shape[0])
    wn, st = core.update(costs, problem[4], lam=0.8, normalize=normalize)
    jwn, jst = jcore.update(costs, problem[4], lam=0.8, normalize=normalize)
    np.testing.assert_array_equal(wn, jwn)
    assert st == jst and st["beta"] == costs.min()


@pytest.mark.parametrize("normalize", [False, True])
def test_solve_equals_the_jax_binding(problem, normalize):
    kw = dict(lam=0.8, gamma=0.2, upsilon=1.3, normalize=normalize)
    a, u, st = core.pm_solve(*problem, **kw)
    ja, ju, jst = jcore.pm_solve(*problem, **kw)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(u, ju)
    assert st == jst


def _fuzz(trial):
    """tests/test_native_core.py's fuzzed instance ``trial``."""
    rng = np.random.RandomState(100 + trial)
    adim = int(rng.randint(1, 5))
    k = int(rng.randint(2, 400))
    tau = int(rng.randint(1, 30))
    dt = float(rng.uniform(0.01, 0.5))
    mass = float(rng.uniform(0.3, 20.0))
    lam = float(rng.uniform(0.05, 5.0))
    gamma = float(rng.uniform(0.0, 2.0))
    upsilon = float(rng.uniform(1.0, 3.0))
    normalize = bool(rng.randint(2))
    z = rng.randn(adim, adim)
    sigma = z @ z.T + adim * np.eye(adim)
    return _instance(rng, k, tau, adim, dt, mass, lam, gamma, upsilon,
                     sigma, normalize), normalize


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_native_bits_and_port_solve(trial):
    """Each fuzzed instance: the port's binding equals JAX's bit for bit,
    and the port's plain f64 solve (MPPI._solve_with_noise) is within
    1e-10 of the golden model (action and next sequence)."""
    (ctrl, args, kw), normalize = _fuzz(trial)
    a, u, st = core.pm_solve(*args, **kw, normalize=normalize)
    ja, ju, jst = jcore.pm_solve(*args, **kw, normalize=normalize)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(u, ju)
    assert st == jst and np.isfinite(st["nabla"]) and st["nabla"] > 0
    _A, _Bm, x0, useq, eps = args[:5]
    pa, pu, info = ctrl._solve_with_noise(torch.as_tensor(eps),
                                          torch.as_tensor(x0),
                                          torch.as_tensor(useq))
    np.testing.assert_allclose(pa.numpy(), a, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(pu.numpy(), u, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(info["cost_mean"].item(), st["cost_mean"],
                               rtol=1e-10)


def test_port_rollout_costs_match_the_golden_model():
    """The port's plain rollout costs (the solve's first half) against
    pm_rollout, 1e-10 relative."""
    rng = np.random.default_rng(3)
    ctrl, args, kw = _instance(rng, 300, 20, 3, 0.1, 2.0, 0.8, 0.4, 1.2,
                               np.diag([0.3, 0.2, 0.4]), False)
    _A, _Bm, x0, useq, eps = args[:5]
    costs = ctrl._rollout(torch.as_tensor(x0), torch.as_tensor(useq),
                          torch.as_tensor(eps))
    np.testing.assert_allclose(costs.detach().numpy(),
                               core.pm_rollout(*args, **kw),
                               rtol=1e-10)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises: no older library stands in
    for it."""
    bad = tmp_path / "mppi_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(core, "SOURCE", bad)
    monkeypatch.setattr(core, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(core, "_lib", None)
    with pytest.raises(OSError, match="g\\+\\+ failed"):
        core.load_library()
    assert not core.available()
    assert not any((tmp_path / "build").glob("*.so"))


def test_shapes_are_checked(problem):
    A, Bm, x0, useq, eps, Q, goal, inv_sigma = problem
    with pytest.raises(ValueError, match="useq"):
        core.pm_solve(A, Bm, x0, useq[:-1], eps, Q, goal, inv_sigma,
                      lam=0.8, gamma=0.2, upsilon=1.3)
    with pytest.raises(ValueError, match="costs"):
        core.update(np.zeros(3), eps, lam=0.8)
