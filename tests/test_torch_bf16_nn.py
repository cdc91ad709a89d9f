"""The NN kernels' bf16 builds: the bf16 block compute (compute_dtype=
"bfloat16") against the JAX package's Pallas NN kernel at bf16
(interpret mode, compiled without XLA's excess precision as tests/
test_torch_bf16_pm.py says, injected normals), and the bf16-products build
that runs a model whose compute_dtype is bf16 at compute_dtype="float32",
against the JAX XLA path's rollout of that model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.kernels import nn_mppi as jnn
from mppi_tf_tpu.models.nn import NNAUVModel as JNNAUVModel
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.interop import from_jax_params
from mppi_tf_tpu_torch.kernels import nn_mppi as nnk
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.models import nn as pnn
from tests.test_nn_kernel import _mp_with_stats
from tests.test_torch_bf16_pm import assert_bf16_side, exact_jax  # noqa

SIGMA = np.diag([50.0, 50.0, 50.0, 20.0, 20.0, 20.0])
LAM, GAMMA, UPS = 0.5, 0.2, 1.2
TASK = {"type": "static_quat", "diag": True,
        "goal": [0.0, 0.0, -2.0, 0.0, 0.0, 0.0, 1.0] + [0.0] * 6,
        "Q": [10.0, 10.0, 10.0, 5.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]}
TILE = 32
# f32 costs summed in another order (the state cost's quadratic): the
# bf16 rollouts themselves agree bit for bit
COST_RTOL = 1e-6
# the bf16-products build against the XLA rollout: f32 sums in another
# order; the f32-products version sits ~4e-3 away
BFP_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(k, tau, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(tau, 6, k).astype(np.float32)
    x0 = np.zeros(13)
    x0[6] = 1.0
    return z, x0, (0.5 * rng.randn(tau, 6)).astype(np.float32)


def _port_model(mp, hidden, compute_dtype=None):
    model = pnn.NNAUVModel(hidden=hidden, compute_dtype=compute_dtype)
    from_jax_params(jax.tree.map(np.asarray, mp), None, model)
    return model


def test_plain_bf16_costs_match_pallas_bf16(exact_jax):
    """(8, 8) MLP at K=64, H=3: the criterion, agreement to f32 rounding
    of the cost, and the f32 version failing the criterion. The port's
    kernels normalise the features in f32 where the JAX kernel folds the
    normalisers into the weights (ROADMAP §3), so the two compute the same
    bf16 rollout at unit normalisers, where the fold is exact; non-trivial
    normalisers are held against the XLA route by
    test_bf16_normalisers_track_the_f32_rollout."""
    hidden, k, tau = (8, 8), 64, 3
    z, x0, useq = _inputs(k, tau)
    jmodel = JNNAUVModel(action_dim=6, dt=0.1, hidden=hidden, seed=4)
    jcost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    mp = jmodel.init_params()
    model = _port_model(mp, hidden)
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    out = {}
    for cd in ("float32", "bfloat16"):
        jf = jnn.FusedNNMPPI(jmodel, jcost, k=k, tau=tau, lam=LAM,
                             upsilon=UPS, sigma=SIGMA, tile=TILE,
                             interpret=True, compute_dtype=cd)
        c, _ = jf.costs_phase(0, x0, useq, mp, jcost.init_params(),
                              z=jnp.asarray(jnn.chunk_noise_nn(z, TILE)),
                              use_prng=False)
        out["jax", cd] = np.asarray(c).reshape(-1)[:k]
        f = nnk.FusedNNMPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                            sigma=SIGMA, compute_dtype=cd)
        assert f.consts.entry("nn_fused_costs") == pm.entry("nn_fused_costs",
                                                            cd)
        c, _ = f.costs_phase(torch.tensor(x0, dtype=torch.float32),
                             torch.as_tensor(useq), z=torch.as_tensor(z))
        out["port", cd] = c.numpy()
    assert_bf16_side(out["port", "bfloat16"], out["port", "float32"],
                     out["jax", "bfloat16"], out["jax", "float32"])
    np.testing.assert_allclose(out["port", "bfloat16"],
                               out["jax", "bfloat16"], rtol=COST_RTOL)


def test_bf16_normalisers_track_the_f32_rollout(exact_jax):
    """With non-trivial normalisers the port's bf16 costs (features
    normalised in f32, then rounded) stand no farther from the f32 XLA
    rollout of the same model than the JAX bf16 kernel's (normalisers
    folded into the weights) do, within a factor of 2, and differ from
    it by bf16 rounding alone."""
    hidden, k, tau = (8, 8), 64, 3
    z, x0, useq = _inputs(k, tau)
    jmodel = JNNAUVModel(action_dim=6, dt=0.1, hidden=hidden, seed=4)
    jcost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    mp = _mp_with_stats(jmodel)
    ctrl = JMPPI(jmodel, jcost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                 sigma=SIGMA)
    eps = np.einsum("ij,tjk->kti", UPS * SIGMA, z).astype(np.float32)
    xla = np.asarray(ctrl._rollout(
        jnp.asarray(x0, jnp.float32), jnp.asarray(useq), jnp.asarray(eps),
        mp, ctrl._cparams), np.float64)
    jf = jnn.FusedNNMPPI(jmodel, jcost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                         sigma=SIGMA, tile=TILE, interpret=True,
                         compute_dtype="bfloat16")
    c, _ = jf.costs_phase(0, x0, useq, mp, jcost.init_params(),
                          z=jnp.asarray(jnn.chunk_noise_nn(z, TILE)),
                          use_prng=False)
    jax16 = np.asarray(c, np.float64).reshape(-1)[:k]
    f = nnk.FusedNNMPPI(_port_model(mp, hidden),
                        get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS,
                                 sigma=SIGMA),
                        k=k, tau=tau, lam=LAM, upsilon=UPS, sigma=SIGMA,
                        compute_dtype="bfloat16")
    c, _ = f.costs_phase(torch.tensor(x0, dtype=torch.float32),
                         torch.as_tensor(useq), z=torch.as_tensor(z))
    port16 = c.double().numpy()
    gap_port = np.abs(port16 - xla).mean()
    gap_jax = np.abs(jax16 - xla).mean()
    print(f"mean |bf16 - f32 XLA|: port {gap_port:.4g}, JAX kernel "
          f"{gap_jax:.4g}")
    assert 0.0 < gap_port <= 2.0 * gap_jax
    np.testing.assert_allclose(port16, xla, rtol=5e-2)


@pytest.mark.parametrize("hidden", [(8, 8), (32, 32, 32)])
def test_bf16_products_model_matches_jax_xla(hidden):
    """A model with compute_dtype bf16 on the f32 kernel runs the JAX XLA
    path's arithmetic (bf16 operands, f32 accumulation, the normalisers
    unfolded), not the JAX kernel's f32 products (ROADMAP §3): its plain
    version against the XLA rollout of the bf16 model at f32 tolerance,
    while the f32-products version misses it."""
    k, tau = 333, 5
    z, x0, useq = _inputs(k, tau, seed=1)
    eps = np.einsum("ij,tjk->kti", UPS * SIGMA, z).astype(np.float32)
    costs = {}
    for cdt in (None, jnp.bfloat16):
        jmodel = JNNAUVModel(action_dim=6, dt=0.1, hidden=hidden, seed=4,
                             compute_dtype=cdt)
        jcost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS,
                          sigma=SIGMA)
        ctrl = JMPPI(jmodel, jcost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                     sigma=SIGMA)
        ctrl.model_params = _mp_with_stats(jmodel)
        costs["jax", cdt] = np.asarray(ctrl._rollout(
            jnp.asarray(x0, jnp.float32), jnp.asarray(useq),
            jnp.asarray(eps), ctrl.model_params, ctrl._cparams))
        model = _port_model(ctrl.model_params, hidden,
                            None if cdt is None else torch.bfloat16)
        f = nnk.FusedNNMPPI(model, get_cost(TASK, lam=LAM, gamma=GAMMA,
                                            upsilon=UPS, sigma=SIGMA),
                            k=k, tau=tau, lam=LAM, upsilon=UPS, sigma=SIGMA)
        assert f.consts.bf16_products == (cdt is not None)
        assert f.consts.entry("nn_fused_solve") == (
            "nn_fused_solve" if cdt is None else "nn_fused_solve_bfp")
        dyn = f.pack_dyn(torch.tensor(x0, dtype=torch.float32),
                         torch.as_tensor(useq))
        assert dyn.shape == (f.consts.layout(tau).size,)
        costs["port", cdt] = nnk.sample_costs_plain(
            f.consts, dyn, torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(costs["port", jnp.bfloat16],
                               costs["jax", jnp.bfloat16], rtol=BFP_RTOL)
    np.testing.assert_allclose(costs["port", None], costs["jax", None],
                               rtol=BFP_RTOL)
    assert np.abs(costs["port", None] / costs["jax", jnp.bfloat16]
                  - 1.0).max() > 10 * BFP_RTOL


def test_bf16_products_layout_and_weights():
    """The bf16-products dyn: the unfolded weights rounded to bf16, the f32
    biases, then x_mean, x_std, y_mean, y_std padded to 4 floats before
    x0; the bf16 build has the same layout with its weights unrounded."""
    model = pnn.NNAUVModel(hidden=(8, 8), compute_dtype=torch.bfloat16)
    model.set_normalization(0.1, 2.0, 0.05, 0.5)
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    kw = dict(k=16, tau=2, lam=LAM, upsilon=UPS, sigma=SIGMA)
    f = nnk.FusedNNMPPI(model, cost, **kw)
    lay = f.consts.layout(2)
    dyn = f.pack_dyn(torch.zeros(13), torch.zeros(2, 6))
    w_at, b_at, fan_in, fan_out = lay.layers[0]
    w = model.net[0].w.detach()
    assert torch.equal(dyn[w_at:b_at].reshape(fan_out, fan_in).T,
                       pm.round_bf16(w))
    assert torch.equal(dyn[b_at:b_at + fan_out], model.net[0].b.detach())
    norm = dyn[lay.norm:lay.x0]
    assert lay.x0 - lay.norm == 60 and torch.equal(norm[58:], torch.zeros(2))
    torch.testing.assert_close(norm[:58], torch.cat([
        model.x_mean, model.x_std, model.y_mean, model.y_std]))
    b16 = nnk.FusedNNMPPI(model, cost, compute_dtype="bfloat16", **kw)
    assert not b16.consts.bf16_products and b16.consts.layout(2).norm == \
        lay.norm
    dyn16 = b16.pack_dyn(torch.zeros(13), torch.zeros(2, 6))
    assert torch.equal(dyn16[w_at:b_at].reshape(fan_out, fan_in).T, w)
    assert torch.equal(dyn16[lay.norm:], dyn[lay.norm:])
    assert b16.consts.entry("nn_fused_solve") == "nn_fused_solve_bf16"


def test_kernel_dtype_on_nn_controllers():
    """kernel_dtype validation on an NN model: the torch route refuses
    bf16 and any other dtype raises; the solve object validates too."""
    model = pnn.NNAUVModel(hidden=(8, 8))
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    for cd in ("bfloat16", "float16"):
        with pytest.raises(ValueError, match="kernel_dtype"):
            MPPI(model, cost, k=16, tau=3, sigma=SIGMA, device="cpu",
                 kernel_dtype=cd)
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        nnk.FusedNNMPPI(model, cost, k=16, tau=3, lam=LAM, upsilon=UPS,
                        sigma=SIGMA, compute_dtype="float16")
