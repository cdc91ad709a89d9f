"""The port's MPPI over the learned NNAUVModel against the JAX package's:
a closed loop with injected noise at f64, the log mode of the fused NN
route (plain versions on the CPU), and the known-plant closed loop that
chip_smoke.py runs on the card, here at a small K in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (NN_LOOP_SIGMA, NN_LOOP_STEPS, NN_LOOP_TOL,
                        known_plant_params, known_plant_task)
from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.models.nn import NNAUVModel as JNNAUVModel
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.interop import from_jax_params
from mppi_tf_tpu_torch.kernels import nn_mppi as nnk
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.models import nn as pnn
from tests.test_nn_kernel import _mp_with_stats
from tests.test_torch_nn_kernel import LAM, SIGMA, TASK, UPS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(hidden=(32, 32, 32), dtype=torch.float64):
    jm = JNNAUVModel(hidden=hidden, seed=4, dtype=jnp.float64)
    mp = _mp_with_stats(jm)
    model = pnn.NNAUVModel(hidden=hidden, dtype=dtype)
    from_jax_params(jax.tree.map(np.asarray, mp), None, model)
    return jm, mp, model


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["plain", "normalize"])
def test_closed_loop_parity_injected_noise(normalize):
    """Ten steps of MPPI(kernel="torch") over NNAUVModel + StaticQuatCost
    with the same eps on both sides: actions, sequences and states agree
    at f64 (the plant is the model itself)."""
    k, tau = 64, 6
    jm, mp, model = _pair()
    kw = dict(k=k, tau=tau, lam=LAM, upsilon=UPS, sigma=SIGMA,
              normalize_cost=normalize)
    port = MPPI(model, get_cost(TASK, lam=LAM, gamma=0.2, upsilon=UPS,
                                sigma=SIGMA, dtype=torch.float64),
                kernel="torch", device="cpu", **kw)
    ref = JMPPI(jm, jget_cost(TASK, lam=LAM, gamma=0.2, upsilon=UPS,
                              sigma=SIGMA, dtype=jnp.float64), **kw)
    cp = ref._cparams
    rng = np.random.default_rng(41)
    x_p = np.zeros(13)
    x_p[6] = 1.0
    x_j = x_p
    useq_p = torch.zeros(tau, 6, dtype=torch.float64)
    useq_j = jnp.zeros((tau, 6), jnp.float64)
    for _ in range(10):
        eps = np.einsum("ij,ktj->kti", UPS * SIGMA,
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
            x_p = model.predict(torch.as_tensor(x_p), a_p).numpy()
        x_j = np.asarray(jm.predict(mp, jnp.asarray(x_j), a_j))
    np.testing.assert_allclose(x_p, x_j, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["plain", "normalize"])
def test_log_mode_noise_is_the_solve_noise(normalize):
    """Log mode on the fused NN route returns the noise its own solve
    consumed: the same action as the plain solve fed that noise, and
    ``noise`` == its first samples."""
    k, tau = 700, 5
    _, _, model = _pair(hidden=(8, 8), dtype=torch.float32)
    cost = get_cost(TASK, lam=LAM, gamma=0.2, upsilon=UPS, sigma=SIGMA)
    kw = dict(k=k, tau=tau, lam=LAM, upsilon=UPS, sigma=SIGMA, seed=7,
              normalize_cost=normalize, log=True, device="cpu")
    fused = MPPI(model, cost, **kw)
    fused._fused = nnk.FusedNNMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                   upsilon=UPS, sigma=SIGMA)
    plain = MPPI(model, cost, **kw)
    state = torch.zeros(13)
    state[6] = 1.0
    useq = torch.zeros(tau, 6)
    a_f, seq_f, info_f = fused._fused_step(state, useq)
    z = pm.noise_plain(7, 0, k, tau, 6)
    eps = torch.einsum("ij,tjk->kti", fused._fused._scale, z)
    a_p, seq_p, info_p = plain._solve_with_noise(eps, state, useq)
    assert info_f["noise"].shape == (512, tau, 6)
    torch.testing.assert_close(info_f["noise"], eps[:512], rtol=0, atol=0)
    tol = dict(rtol=2e-4, atol=1e-3)
    for key in ("sample_costs", "weights", "nabla"):
        torch.testing.assert_close(info_f[key], info_p[key], **tol)
    torch.testing.assert_close(a_f, a_p, **tol)
    torch.testing.assert_close(seq_f, seq_p, **tol)


def test_jax_log_noise_is_not_the_nn_stream():
    """The JAX package's fault that the port does not copy: its log mode
    dumps every fused kernel's noise with the point-mass fill
    (pm_mppi._fill_noise: Box-Muller cos half = step 2c, sin half = step
    2c + 1), but the NN kernel fills per step (nn_mppi._fill_noise_steps:
    cos half = dims 0-2, sin half = dims 3-5 of one step). Emulated here
    on the same uniform draws with the two fills' arithmetic and the JAX
    layouts, the noise logged is not the noise the NN solve consumed."""
    from mppi_tf_tpu.kernels.pm_mppi import unchunk_noise

    tau, k, tile = 4, 64, 64
    lanes = tile // 8
    rng = np.random.default_rng(8)
    u1, u2 = rng.uniform(size=(2, tau * 24, lanes))   # rows_all = tau*24
    r = np.sqrt(-2.0 * np.log(u1))
    rc, rs = r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)
    pm_buf = np.concatenate([rc.reshape(tau // 2, 48, lanes),
                             rs.reshape(tau // 2, 48, lanes)], axis=1)
    logged = np.asarray(unchunk_noise(pm_buf, tau, 6, k, tile))
    nn_buf = np.concatenate([rc.reshape(tau, 24, lanes),
                             rs.reshape(tau, 24, lanes)], axis=1)
    consumed = nn_buf.reshape(tau, 6, 8 * lanes)      # rows 8j..8j+8: dim j
    assert logged.shape == consumed.shape == (tau, 6, k)
    assert not np.allclose(logged, consumed)
    # the port's noise sample is the stream its kernels read
    _, _, model = _pair(hidden=(8, 8), dtype=torch.float32)
    fused = nnk.FusedNNMPPI(model, get_cost(TASK, lam=LAM, gamma=0.2,
                                            upsilon=UPS, sigma=SIGMA),
                            k=k, tau=tau, lam=LAM, upsilon=UPS, sigma=SIGMA)
    torch.testing.assert_close(
        fused.noise_sample(3, 2),
        torch.einsum("ij,tjk->kti", fused._scale,
                     pm.pm_noise_dump(3, 2, k, tau, 6, "cpu")))


def _known_task_and_sigma():
    return known_plant_task(), NN_LOOP_SIGMA


@pytest.mark.parametrize("normalize", [False, True],
                         ids=["plain", "normalize"])
@pytest.mark.parametrize("package", ["port", "jax"])
def test_known_plant_dive_reaches_depth(package, normalize):
    """chip_smoke.py's known-plant loop at K=1,024: the 3x32 network that
    computes a body-frame double integrator is both the model and (at f64)
    the plant; the dive ends within its gate of z = -1 with |q| = 1."""
    task, sigma = _known_task_and_sigma()
    params = known_plant_params()
    kw = dict(k=1024, tau=25, lam=0.5, upsilon=1.0, sigma=sigma, seed=3,
              normalize_cost=normalize)
    x = np.zeros(13)
    x[6] = 1.0
    if package == "port":
        model = pnn.NNAUVModel()
        plant = pnn.NNAUVModel(dtype=torch.float64)
        for m in (model, plant):
            from_jax_params(params, None, m)
        cost = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma)
        ctrl = MPPI(model, cost, device="cpu", **kw)
        for _ in range(NN_LOOP_STEPS):
            u = ctrl.next(x)
            with torch.no_grad():
                x = plant.predict(torch.tensor(x), torch.tensor(
                    u, dtype=torch.float64)).numpy()
    else:
        model = JNNAUVModel(dtype=jnp.float32)
        cost = jget_cost(task, lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma)
        ctrl = JMPPI(model, cost, **kw)
        ctrl.model_params = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float32), params)
        plant = JNNAUVModel(dtype=jnp.float64)
        pp = jax.tree.map(jnp.asarray, params)
        for _ in range(NN_LOOP_STEPS):
            u = ctrl.next(x)
            x = np.asarray(plant.predict(pp, jnp.asarray(x),
                                         jnp.asarray(u, jnp.float64)))
    assert abs(x[2] + 1.0) < NN_LOOP_TOL, x
    assert abs(np.linalg.norm(x[3:7]) - 1.0) < 1e-3


def test_auto_keeps_nn_on_the_plain_path():
    _, _, model = _pair(hidden=(8, 8), dtype=torch.float32)
    cost = get_cost(TASK, lam=LAM, gamma=0.2, upsilon=UPS, sigma=SIGMA)
    ctrl = MPPI(model, cost, k=16, tau=3, sigma=SIGMA, kernel="auto",
                device="cpu")
    assert ctrl.kernel_path == "torch" and ctrl._fused is None
    with pytest.raises(ValueError, match="CUDA device"):
        MPPI(model, cost, k=16, tau=3, sigma=SIGMA, kernel="cuda",
             device="cpu")
