"""The port's learned-dynamics models (models/nn.py) against the JAX
package's at f64 on carried-over weights: the MLP, the three model
families' steps and training data, the factory, the bf16 product path and
the interop of the nested params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.models import nn as jnn
from mppi_tf_tpu_torch.interop import from_jax_params, to_jax_params
from mppi_tf_tpu_torch.models import copy_model, get_model
from mppi_tf_tpu_torch.models import nn as pnn

# f64 on both sides, the same algebra in another summation order
RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _stats(model):
    """Non-trivial normalisers for ``model``: (x_mean, x_std, y_mean,
    y_std)."""
    n_in, n_out = model.input_dim(), model.output_dim()
    return (0.1 * np.arange(n_in), 1.0 + 0.05 * np.arange(n_in),
            0.01 * np.arange(n_out), 0.5 + 0.02 * np.arange(n_out))


def _pair(jcls, pcls, norm=True, **kw):
    """(JAX model, its params, port model loaded with them) at f64."""
    jm = jcls(dtype=jnp.float64, **kw)
    mp = jm.init_params()
    pm = pcls(dtype=torch.float64, **kw)
    if norm:
        mp = jm.set_normalization(mp, *_stats(jm))
    from_jax_params(jax.tree.map(np.asarray, mp), None, pm)
    return jm, mp, pm


def _auv_states(rng, k):
    x = rng.normal(size=(k, 13))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=-1, keepdims=True)
    return x


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("sizes", [[7, 32, 32, 32, 4], [16, 8, 8, 13]])
def test_mlp_apply_matches_jax(sizes):
    params = jnn.mlp_init(jax.random.PRNGKey(3), sizes, dtype=jnp.float64)
    layers = torch.nn.ModuleList(
        [pnn.Dense(_t(p["w"]), _t(p["b"]) + 0.1 * i)
         for i, p in enumerate(params)])
    jparams = [{"w": p["w"], "b": p["b"] + 0.1 * i}
               for i, p in enumerate(params)]
    x = np.random.default_rng(0).normal(size=(9, sizes[0]))
    np.testing.assert_allclose(
        pnn.mlp_apply(layers, _t(x)).detach().numpy(),
        np.asarray(jnn.mlp_apply(jparams, jnp.asarray(x))), rtol=RTOL,
        atol=ATOL)


def test_mlp_init_is_he():
    gen = torch.Generator().manual_seed(0)
    layers = pnn.mlp_init(gen, [64, 256, 1], dtype=torch.float64)
    w = layers[0].w.detach()
    assert w.shape == (64, 256) and layers[0].b.abs().sum() == 0
    # var 2 / fan_in, to 5% over 16k draws
    assert abs(w.var().item() * 64 / 2.0 - 1.0) < 0.05
    again = pnn.mlp_init(torch.Generator().manual_seed(0), [64, 256, 1])
    torch.testing.assert_close(again[0].w, w.float())


@pytest.mark.parametrize("norm", [False, True])
def test_nn_model_step_matches_jax(norm):
    jm, mp, pm = _pair(jnn.NNModel, pnn.NNModel, norm=norm, state_dim=4,
                       action_dim=2)
    rng = np.random.default_rng(1)
    x, u = rng.normal(size=(11, 4)), rng.normal(size=(11, 2))
    np.testing.assert_allclose(
        pm.step(_t(x), _t(u)).detach().numpy(),
        np.asarray(jm.step(mp, jnp.asarray(x), jnp.asarray(u))), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("hidden", [(32, 32, 32), (8, 8)])
def test_nn_auv_model_step_matches_jax(renorm, hidden, monkeypatch):
    monkeypatch.setattr(jnn.NNAUVModel, "renormalize_quat", renorm)
    monkeypatch.setattr(pnn.NNAUVModel, "renormalize_quat", renorm)
    jm, mp, pm = _pair(jnn.NNAUVModel, pnn.NNAUVModel, hidden=hidden,
                       seed=5)
    rng = np.random.default_rng(2)
    x, u = _auv_states(rng, 13), 30.0 * rng.normal(size=(13, 6))
    got = pm.step(_t(x), _t(u)).detach().numpy()
    np.testing.assert_allclose(
        got, np.asarray(jm.step(mp, jnp.asarray(x), jnp.asarray(u))),
        rtol=RTOL, atol=ATOL)
    qn = np.linalg.norm(got[:, 3:7], axis=-1)
    assert np.allclose(qn, 1.0) == renorm


def test_nn_auv_speed_step_matches_jax():
    jm, mp, pm = _pair(jnn.NNAUVModelSpeed, pnn.NNAUVModelSpeed, seed=2)
    rng = np.random.default_rng(3)
    x, u = _auv_states(rng, 10), rng.normal(size=(10, 6))
    np.testing.assert_allclose(
        pm.step(_t(x), _t(u)).detach().numpy(),
        np.asarray(jm.step(mp, jnp.asarray(x), jnp.asarray(u))), rtol=RTOL,
        atol=ATOL)
    assert pm.input_dim() == 15 and pm.output_dim() == 6


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("family", ["nn", "auv_nn", "auv_nn_speed"])
def test_prepare_training_data_matches_jax(family, norm):
    rng = np.random.default_rng(4)
    if family == "nn":
        jm, mp, pm = _pair(jnn.NNModel, pnn.NNModel, state_dim=4,
                           action_dim=2)
        x0, x1 = rng.normal(size=(8, 4)), rng.normal(size=(8, 4))
        u = rng.normal(size=(8, 2))
    else:
        jcls, pcls = {"auv_nn": (jnn.NNAUVModel, pnn.NNAUVModel),
                      "auv_nn_speed": (jnn.NNAUVModelSpeed,
                                       pnn.NNAUVModelSpeed)}[family]
        jm, mp, pm = _pair(jcls, pcls)
        x0, x1, u = _auv_states(rng, 8), _auv_states(rng, 8), rng.normal(
            size=(8, 6))
    X, Y = pm.prepare_training_data(_t(x0), _t(x1), _t(u), norm=norm)
    jX, jY = jm.prepare_training_data(mp, jnp.asarray(x0), jnp.asarray(x1),
                                      jnp.asarray(u), norm=norm)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(Y.numpy(), np.asarray(jY), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mtype,adim,cls", [
    ("neural_net", 1, pnn.NNModel), ("auv_nn", 6, pnn.NNAUVModel),
    ("auv_nn_speed", 6, pnn.NNAUVModelSpeed)])
def test_get_model_nn_families(mtype, adim, cls):
    cfg = {"type": mtype, "limMax": 2.5, "limMin": -1.5}
    state_dim = 4 if mtype == "neural_net" else 13
    pm = get_model(cfg, dt=0.05, state_dim=state_dim, dtype=torch.float64)
    jm = jget_model(cfg, dt=0.05, state_dim=state_dim, dtype=jnp.float64)
    assert type(pm) is cls and type(pm).__name__ == type(jm).__name__
    assert pm.get_action_dim() == jm.get_action_dim() == adim
    assert pm.get_state_dim() == jm.get_state_dim() == state_dim
    assert pm.get_name() == jm.get_name() and pm.dt == 0.05
    assert pm.sizes() == [jm.input_dim(), *jm._hidden, jm.output_dim()]
    np.testing.assert_array_equal(pm.max_act().numpy(), jm.max_act())
    np.testing.assert_array_equal(pm.min_act().numpy(), jm.min_act())
    wide = get_model({"type": mtype}, state_dim=state_dim, action_dim=3,
                     hidden=(8, 8), seed=1)
    assert wide.get_action_dim() == 3 and wide.hidden == (8, 8)


def test_compute_dtype_bf16_matches_jax():
    """bf16 products with f32 accumulation on both sides, at f32: the
    operands round to bf16 identically, the sums differ in order only
    (rtol 1e-5); and the bf16 path is not the f32 one."""
    jm = jnn.NNAUVModel(dtype=jnp.float32, compute_dtype=jnp.bfloat16)
    mp = jm.set_normalization(jm.init_params(), *_stats(jm))
    pm = pnn.NNAUVModel(compute_dtype=torch.bfloat16)
    from_jax_params(jax.tree.map(np.asarray, mp), None, pm)
    rng = np.random.default_rng(6)
    x = _auv_states(rng, 64).astype(np.float32)
    u = (20.0 * rng.normal(size=(64, 6))).astype(np.float32)
    got = pm.step(torch.as_tensor(x), torch.as_tensor(u)).detach().numpy()
    ref = np.asarray(jm.step(mp, jnp.asarray(x), jnp.asarray(u)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    pm.compute_dtype = None
    full = pm.step(torch.as_tensor(x), torch.as_tensor(u)).detach().numpy()
    assert np.abs(full - got).max() > 1e-4


def test_interop_round_trip_nested_params():
    jm = jnn.NNAUVModel(hidden=(8, 8), dtype=jnp.float64, seed=9)
    mp = jax.tree.map(np.asarray,
                      jm.set_normalization(jm.init_params(), *_stats(jm)))
    pm = pnn.NNAUVModel(hidden=(8, 8), dtype=torch.float64)
    from_jax_params(mp, None, pm)
    back, cp = to_jax_params(pm)
    assert cp == {} and len(back["net"]) == 3
    for a, b in zip(jax.tree.leaves(mp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(mp) == jax.tree.structure(back)
    with pytest.raises(KeyError):
        from_jax_params({**mp, "net": mp["net"][:2]}, None, pm)


def test_trainable_update_and_copy_model():
    pm = pnn.NNAUVModel(hidden=(8, 8), seed=3, dtype=torch.float64)
    init = [l.w.detach().clone() for l in pm.trainable()]
    fresh = pm.trainable_init(torch.Generator().manual_seed(11))
    pm.with_trainable(fresh)
    assert not torch.equal(pm.net[0].w, init[0])
    pm.with_trainable([{"w": l.w.detach().numpy(), "b": l.b.detach().numpy()}
                       for l in fresh])
    pm.set_normalization(*_stats(pm))
    clone = copy_model(pm)
    # the clone restarts from the seed's init and identity normalisers, as
    # JAX copy_model (model.init_params()) does
    ref = pnn.NNAUVModel(hidden=(8, 8), seed=3, dtype=torch.float64)
    for a, b in zip(clone.state_dict().values(), ref.state_dict().values()):
        torch.testing.assert_close(a, b)
    assert not torch.equal(clone.net[0].w, pm.net[0].w)
    assert clone.x_std[1].item() == 1.0 and pm.x_std[1].item() != 1.0
