"""Port's MPPI controller against the JAX package's, plus its own surface.

The closed-loop parity injects the same eps into both packages every
step (the two PRNG streams differ by design) and compares actions and
the carried sequence at f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu_torch.controller import MPPI, get_controller, savgol_matrix
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.models import get_model

SIGMA = np.diag([0.25, 0.3, 0.2])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _modules(lim=None, goal=(1.0, 0.0, 0.0, 0.0, 0.0, 0.0), lam=1.2,
             gamma=1.1, ups=2.0, mass=1.5):
    mcfg = {"type": "point_mass", "mass": mass}
    if lim is not None:
        mcfg.update(limMax=lim, limMin=-lim)
    task = {"type": "static", "goal": list(goal), "Q": np.eye(6).tolist()}
    port = (get_model(mcfg, dt=0.1, state_dim=6, action_dim=3,
                      dtype=torch.float64),
            get_cost(task, lam=lam, gamma=gamma, upsilon=ups, sigma=SIGMA,
                     dtype=torch.float64))
    ref = (jget_model(mcfg, dt=0.1, state_dim=6, action_dim=3,
                      dtype=jnp.float64),
           jget_cost(task, lam=lam, gamma=gamma, upsilon=ups, sigma=SIGMA,
                     dtype=jnp.float64))
    return port, ref


@pytest.mark.parametrize("opts", [
    {}, {"normalize_cost": True}, {"clip_actions": True},
    {"filter_seq": True},
    {"normalize_cost": True, "clip_actions": True, "filter_seq": True}],
    ids=["plain", "normalize", "clip", "filter", "all"])
def test_closed_loop_parity_injected_noise(opts):
    k, tau = 60, 10
    (pm, pc), (jm, jc) = _modules(lim=0.6)
    port = MPPI(pm, pc, k=k, tau=tau, lam=1.2, upsilon=2.0, sigma=SIGMA,
                device="cpu", **opts)
    ref = JMPPI(jm, jc, k=k, tau=tau, lam=1.2, upsilon=2.0, sigma=SIGMA,
                **opts)
    mp, cp = ref.model_params, ref._cparams
    rng = np.random.default_rng(21)
    eps = rng.normal(size=(k, tau, 3)) * 0.4
    x_p = x_j = rng.normal(size=6)
    useq_p = torch.zeros(tau, 3, dtype=torch.float64)
    useq_j = jnp.zeros((tau, 3), jnp.float64)
    for _ in range(10):
        a_p, useq_p, info_p = port._solve_with_noise(
            torch.as_tensor(eps), torch.as_tensor(x_p), useq_p)
        a_j, useq_j, info_j = ref._solve_with_noise_jit(
            jnp.asarray(eps), jnp.asarray(x_j), useq_j, mp, cp)
        np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(useq_p.numpy(), np.asarray(useq_j),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(info_p["cost_mean"].item(),
                                   float(info_j["cost_mean"]), rtol=1e-9)
        x_p = pm.predict(torch.as_tensor(x_p), a_p).detach().numpy()
        x_j = np.asarray(jm.predict(mp, jnp.asarray(x_j), a_j))
    np.testing.assert_allclose(x_p, x_j, rtol=1e-9, atol=1e-12)


def test_log_mode_info_matches_jax():
    k, tau = 30, 5
    (pm, pc), (jm, jc) = _modules()
    port = MPPI(pm, pc, k=k, tau=tau, lam=1.2, upsilon=2.0, sigma=SIGMA,
                device="cpu", log=True)
    ref = JMPPI(jm, jc, k=k, tau=tau, lam=1.2, upsilon=2.0, sigma=SIGMA,
                log=True)
    rng = np.random.default_rng(22)
    eps, x0 = rng.normal(size=(k, tau, 3)), rng.normal(size=6)
    _, _, info_p = port._solve_with_noise(
        torch.as_tensor(eps), torch.as_tensor(x0),
        torch.zeros(tau, 3, dtype=torch.float64))
    _, _, info_j = ref._solve_with_noise_jit(
        jnp.asarray(eps), jnp.asarray(x0), jnp.zeros((tau, 3)),
        ref.model_params, ref._cparams)
    for key in ("sample_costs", "weights", "nabla", "arg", "noise"):
        np.testing.assert_allclose(info_p[key].numpy(),
                                   np.asarray(info_j[key]), rtol=1e-9,
                                   atol=1e-14)


def test_savgol_matrix_matches_jax():
    from mppi_tf_tpu.controller.mppi import savgol_matrix as jsavgol

    np.testing.assert_allclose(savgol_matrix(12, 9, 3), jsavgol(12, 9, 3),
                               rtol=1e-12, atol=1e-14)


def _pm_controller(**kw):
    (pm, pc), _ = _modules(lam=0.8, gamma=0.2, ups=1.0, mass=1.0)
    return MPPI(pm, pc, k=kw.pop("k", 500), tau=kw.pop("tau", 25), lam=0.8,
                upsilon=1.0, sigma=SIGMA, device="cpu", **kw)


@pytest.mark.parametrize("kernel", ["torch", "auto"])
def test_next_reaches_goal_on_cpu(kernel):
    """End-to-end: the plain CPU path drives the point mass to the goal
    (as tests/test_controller.py does for the JAX package)."""
    ctrl = _pm_controller(kernel=kernel)
    assert ctrl.kernel_path == "torch"
    model = ctrl._model
    x = torch.zeros(6, dtype=torch.float64)
    for _ in range(60):
        u = ctrl.next(x.numpy())
        x = model.predict(x, torch.as_tensor(u)).detach()
    final = x.numpy()
    assert abs(final[0] - 1.0) < 0.2, f"did not reach goal: {final}"
    assert np.all(np.abs(final[1::2]) < 0.5), f"velocities too large: {final}"
    assert ctrl.timing["calls"] == 60


def test_save_load_state_resume(tmp_path):
    ctrl = _pm_controller(k=100, tau=8)
    ctrl.set_goal([0.5, 0.0, 0.2, 0.0, 0.1, 0.0])
    x = np.zeros(6)
    for _ in range(3):
        ctrl.next(x)
    path = str(tmp_path / "ctrl.npz")
    ctrl.save_state(path)
    expected = [ctrl.next(x) for _ in range(3)]

    fresh = _pm_controller(k=100, tau=8)
    fresh.load_state(path)
    np.testing.assert_array_equal(fresh._cost.goal.numpy(),
                                  [0.5, 0.0, 0.2, 0.0, 0.1, 0.0])
    assert fresh.timing["calls"] == 3
    got = [fresh.next(x) for _ in range(3)]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))

    wrong = _pm_controller(k=100, tau=5)
    with pytest.raises(ValueError):
        wrong.load_state(path)


def test_trace_restores_state():
    traced, plain = _pm_controller(k=50, tau=6), _pm_controller(k=50, tau=6)
    traced.trace()
    x = np.full(6, 0.1)
    np.testing.assert_array_equal(traced.next(x), plain.next(x))
    assert traced.timing["calls"] == 1


def test_profile_runs_on_cpu(tmp_path):
    ctrl = _pm_controller(k=50, tau=6)
    prof = ctrl.profile(str(tmp_path))
    assert (tmp_path / "trace.json").exists()
    assert len(prof.key_averages()) > 0


def test_default_device_raises_without_gpu(monkeypatch):
    (pm, pc), _ = _modules()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        MPPI(pm, pc, k=10, tau=4, sigma=SIGMA)


def test_cuda_kernel_on_cpu_raises():
    (pm, pc), _ = _modules()
    for kernel in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="CUDA device"):
            MPPI(pm, pc, k=10, tau=4, sigma=SIGMA, kernel=kernel,
                 device="cpu")


def test_constructor_rejects():
    (pm, pc), _ = _modules()
    with pytest.raises(ValueError):
        MPPI(pm, pc, k=10, tau=4, sigma=SIGMA, kernel="bogus", device="cpu")
    with pytest.raises(ValueError):
        MPPI(pm, pc, k=10, tau=4, sigma=None, device="cpu")
    with pytest.raises(AssertionError):
        MPPI(pm, pc, k=10, tau=4, sigma=np.eye(2), device="cpu")
    # bf16 blocks are a kernel-path option: the torch path refuses them
    with pytest.raises(ValueError, match="fused kernel path only"):
        MPPI(pm, pc, k=10, tau=4, sigma=SIGMA, device="cpu",
             kernel_dtype="bfloat16")
    ctrl = MPPI(pm, pc, k=10, tau=4, sigma=SIGMA, kernel="xla",
                device="cpu")
    assert ctrl.kernel_path == "torch"


def test_get_controller_single():
    (pm, pc), _ = _modules()
    cfg = {"samples": 40, "horizon": 6, "lambda": 0.9, "upsilon": 1.5,
           "noise": SIGMA.tolist(), "init-act": [0.1, 0.2, 0.3],
           "normalize": True}
    ctrl = get_controller(pm, pc, cfg, device="cpu")
    assert (ctrl._k, ctrl._tau, ctrl._lam, ctrl._upsilon) == (40, 6, 0.9,
                                                              1.5)
    assert ctrl._normalize_cost and ctrl.kernel_path == "torch"
    np.testing.assert_allclose(ctrl.useq.numpy(),
                               np.tile([0.1, 0.2, 0.3], (6, 1)))


@pytest.mark.parametrize("cfg,kw,item", [
    ({"fleet": 4}, {"mesh": object()}, "item 14"),
    ({}, {"mesh": object()}, "item 14"),
    ({"kernel-dtype": "bfloat16"}, {}, "fused kernel path only")])
def test_get_controller_not_ported(cfg, kw, item):
    """Meshes (a fleet's too) are not ported; fleets are
    (tests/test_torch_fleet.py); kernel-dtype is, and reaches the
    controller, which refuses bf16 on the torch path as JAX does."""
    (pm, pc), _ = _modules()
    base = {"samples": 10, "horizon": 4, "noise": SIGMA.tolist()}
    err = ValueError if "kernel-dtype" in cfg else NotImplementedError
    with pytest.raises(err, match=item):
        get_controller(pm, pc, {**base, **cfg}, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the AUV flagship on the plain path, and the fused step's glue on the CPU
# ---------------------------------------------------------------------------

AUV_SIGMA = np.diag([40.0, 40.0, 40.0, 5.0, 5.0, 5.0])


def _auv_modules(dtype=torch.float64):
    from mppi_tf_tpu_torch import flagship

    model = get_model(flagship.auv_params(), dt=0.1, dtype=dtype)
    cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.2,
                    sigma=AUV_SIGMA, dtype=dtype)
    return model, cost


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["plain", "normalize"])
def test_auv_closed_loop_parity_injected_noise(normalize):
    """Ten AUV steps (rexrov2, rk2, static_quat) with the same eps on both
    sides: actions, sequences and states agree at f64."""
    from mppi_tf_tpu import flagship as jflagship

    k, tau = 64, 6
    pm_, pc = _auv_modules()
    jm = jget_model(jflagship.auv_params(), dt=0.1, dtype=jnp.float64)
    jc = jget_cost(jflagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.2,
                   sigma=AUV_SIGMA, dtype=jnp.float64)
    kw = dict(k=k, tau=tau, lam=0.5, upsilon=1.2, sigma=AUV_SIGMA,
              normalize_cost=normalize)
    port = MPPI(pm_, pc, device="cpu", **kw)
    ref = JMPPI(jm, jc, **kw)
    mp, cp = ref.model_params, ref._cparams
    rng = np.random.default_rng(31)
    x_p = np.zeros(13)
    x_p[[2, 6]] = [-1.0, 1.0]
    x_j = x_p
    useq_p = torch.zeros(tau, 6, dtype=torch.float64)
    useq_j = jnp.zeros((tau, 6), jnp.float64)
    for _ in range(10):
        eps = np.einsum("ij,ktj->kti", 1.2 * AUV_SIGMA,
                        rng.normal(size=(k, tau, 6)))
        a_p, useq_p, info_p = port._solve_with_noise(
            torch.as_tensor(eps), torch.as_tensor(x_p), useq_p)
        a_j, useq_j, info_j = ref._solve_with_noise_jit(
            jnp.asarray(eps), jnp.asarray(x_j), useq_j, mp, cp)
        scale = np.abs(np.asarray(useq_j)).max()
        np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=1e-8,
                                   atol=1e-10 * scale)
        np.testing.assert_allclose(useq_p.numpy(), np.asarray(useq_j),
                                   rtol=1e-8, atol=1e-10 * scale)
        np.testing.assert_allclose(info_p["cost_mean"].item(),
                                   float(info_j["cost_mean"]), rtol=1e-9)
        with torch.no_grad():
            x_p = pm_.predict(torch.as_tensor(x_p), a_p).numpy()
        x_j = np.asarray(jm.predict(jm.precompute(mp), jnp.asarray(x_j),
                                    a_j))
    np.testing.assert_allclose(x_p, x_j, rtol=1e-8, atol=1e-10)


def test_auv_dive_reaches_depth_on_cpu():
    """The tests/test_envs.py:416-455 regime on the plain path: a 160-step
    normalized dive to z = -1 with the analytic plant (5 substeps of 0.02 s
    a step); the plant keeps |q| = 1."""
    from mppi_tf_tpu_torch.envs import AUVEnv
    from tests.test_auv_kernel import _auv_cfg

    goal = np.zeros(13)
    goal[[2, 6]] = [-1.0, 1.0]
    sigma = np.diag([2000.0] * 3 + [200.0] * 3)
    model = get_model(_auv_cfg(), dt=0.1, action_dim=6)
    cost = get_cost({"type": "static_quat", "diag": True,
                     "goal": goal.tolist(),
                     "Q": [60.0, 60.0, 60.0, 10.0] + [1.0] * 6},
                    lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma)
    ctrl = MPPI(model, cost, k=256, tau=15, lam=0.5, upsilon=1.0,
                sigma=sigma, seed=3, normalize_cost=True, kernel="auto",
                device="cpu")
    assert ctrl.kernel_path == "torch"
    env = AUVEnv(_auv_cfg(), dt=0.02)
    x = env.reset()
    qn = []
    for _ in range(160):
        u = ctrl.next(x)
        for _ in range(5):
            x = env.step(u)
        qn.append(np.linalg.norm(x[3:7]))
    np.testing.assert_allclose(qn, 1.0, atol=1e-3)
    assert abs(x[2, 0] - goal[2]) < 0.2, x.ravel()


def _with_fused(ctrl, fused_cls):
    """Attach a fused solve object to a CPU controller: its wrappers then
    run their plain versions, which exercises the kernel path's glue."""
    ctrl._fused = fused_cls(ctrl._model, ctrl._cost, k=ctrl._k,
                            tau=ctrl._tau, lam=ctrl._lam,
                            upsilon=ctrl._upsilon,
                            sigma=ctrl._sigma.numpy())
    return ctrl


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["plain", "normalize"])
@pytest.mark.parametrize("model_kind", ["point_mass", "auv"])
def test_fused_step_log_info_matches_plain_path(model_kind, normalize):
    """The kernel path's step (plain versions on the CPU) == the plain
    solve on the same Philox noise: action, sequence, and the log-mode
    keys (sample_costs, weights, nabla, arg, noise)."""
    from mppi_tf_tpu_torch.kernels.auv_mppi import FusedAUVMPPI
    from mppi_tf_tpu_torch.kernels.pm_mppi import (FusedPointMassMPPI,
                                                   noise_plain)

    k, tau = 300, 5
    if model_kind == "auv":
        (m, c), cls, sdim = _auv_modules(), FusedAUVMPPI, 13
        x0 = np.zeros(13)
        x0[[2, 6]] = [-1.0, 1.0]
    else:
        (m, c), _ = _modules()
        cls, sdim, x0 = FusedPointMassMPPI, 6, np.full(6, 0.2)
        m, c = m.float(), c.float()
    kw = dict(k=k, tau=tau, lam=0.5 if model_kind == "auv" else 1.2,
              upsilon=1.2 if model_kind == "auv" else 2.0,
              sigma=AUV_SIGMA if model_kind == "auv" else SIGMA,
              normalize_cost=normalize, log=True, seed=7, device="cpu")
    fused = _with_fused(MPPI(m, c, **kw), cls)
    plain = MPPI(m, c, **kw)
    state = torch.as_tensor(x0, dtype=m.dtype)
    useq = torch.zeros(tau, m.get_action_dim(), dtype=m.dtype)
    a_f, seq_f, info_f = fused._fused_step(state, useq)
    z = noise_plain(7, 0, k, tau, m.get_action_dim()).to(m.dtype)
    eps = torch.einsum("ij,tjk->kti", fused._fused._scale, z)
    a_p, seq_p, info_p = plain._solve_with_noise(eps, state, useq)
    assert set(info_p) <= set(info_f)
    tol = dict(rtol=1e-9, atol=1e-12) if m.dtype == torch.float64 else \
        dict(rtol=2e-4, atol=1e-5)
    for key in ("sample_costs", "weights", "nabla", "arg", "noise"):
        torch.testing.assert_close(info_f[key], info_p[key], **tol)
    torch.testing.assert_close(seq_f, seq_p, **tol)
    torch.testing.assert_close(a_f, a_p, **tol)
    assert sdim == m.get_state_dim()
