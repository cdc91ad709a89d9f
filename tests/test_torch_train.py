"""The port's dp x tp train step (parallel/train.py) against the JAX
package's ``make_sharded_train_step`` (mppi_tf_tpu/parallel/train.py) on a
(dp, tp) mesh of its 8 virtual CPU devices: an NNAUVModel at f64, the same
initial weights (interop) and the same normalized training pairs, made
from a seed with numpy; three Adam steps, the losses and the weights held
within 1e-10. The port runs on a local mesh of CPU shards and on 2 x 2
gloo ranks (parallel/cluster.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from mppi_tf_tpu.models.nn import NNAUVModel as JNNAUVModel
from mppi_tf_tpu.parallel.train import make_sharded_train_step as jmake
from mppi_tf_tpu.parallel.train import mlp_param_specs as jspecs
from mppi_tf_tpu_torch.interop import from_jax_params
from mppi_tf_tpu_torch.models.nn import NNAUVModel
from mppi_tf_tpu_torch.parallel.cluster import run_cluster
from mppi_tf_tpu_torch.parallel.mesh import Mesh
from mppi_tf_tpu_torch.parallel.train import (make_sharded_train_step,
                                              mlp_param_specs,
                                              model_param_specs)

#: the same f64 arithmetic but for each side's own sums
TOL = 1e-10
STEPS = 3
#: the mbrl phase's transitions (chip_smoke.py)
BATCH = 264


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(hidden, seed=0):
    jm = JNNAUVModel(action_dim=6, dt=0.1, hidden=hidden, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(BATCH, jm.input_dim()))
    Y = rng.normal(size=(BATCH, jm.output_dim()))
    return jm, X, Y


def _jax_run(jm, X, Y, dp, tp):
    mesh = JMesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                 ("dp", "tp"))
    init, jit_step, place = jmake(jm, mesh, learning_rate=1e-3)
    params = jm.init_params()
    params, opt = init(params)
    step = jit_step(params)
    Xj, Yj = place(jnp.asarray(X), jnp.asarray(Y))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, Xj, Yj)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params["net"])


def _port_model(jm, hidden):
    model = NNAUVModel(action_dim=6, dt=0.1, hidden=hidden,
                       dtype=torch.float64)
    from_jax_params(jax.tree.map(np.asarray, jm.init_params()), None, model)
    return model


def _assert_net(net, jnet):
    assert len(net) == len(jnet)
    for p, jp in zip(net, jnet):
        for a in ("w", "b"):
            np.testing.assert_allclose(np.asarray(p[a]), jp[a], rtol=TOL,
                                       atol=TOL)


def test_specs_mirror_jax():
    net = [{"w": None, "b": None}] * 4
    ours = mlp_param_specs(net)
    theirs = jspecs(net)
    for o, t in zip(ours, theirs):
        assert o["w"] == tuple(t["w"]) and o["b"] == tuple(t["b"])
    specs = model_param_specs({"net": net, "x_mean": 0, "y_std": 1})
    assert specs["x_mean"] == () and specs["net"] == ours


@pytest.mark.parametrize("hidden,dp,tp", [((32, 32, 32), 4, 2),
                                          ((64, 32, 16), 4, 2),
                                          ((32, 32, 32), 2, 4)])
def test_local_mesh_step_matches_jax(hidden, dp, tp):
    """Three steps on a local (dp, tp) mesh of CPU shards == JAX's
    sharded step, at uneven widths and at tp = 4."""
    jm, X, Y = _data(hidden)
    jlosses, jnet = _jax_run(jm, X, Y, dp, tp)
    model = _port_model(jm, hidden)
    mesh = Mesh(["cpu"] * (dp * tp), ("dp", "tp"), (dp, tp))
    init, step_fn, place_batch = make_sharded_train_step(model, mesh, 1e-3)
    params, opt = init()
    Xs, Ys = place_batch(X, Y)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step_fn(params, opt, Xs, Ys)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    _assert_net(params.full(), jnet)
    # the dp replicas of each piece stay bit for bit equal
    for i in range(1, dp):
        for a, b in zip(params.tensors(0), params.tensors(i * tp)):
            assert torch.equal(a, b)


def test_gloo_ranks_step_matches_jax_and_the_local_mesh():
    """2 x 2 gloo ranks, one shard a rank: every rank ends with the same
    weights, equal to a local 2 x 2 mesh bit for bit and to JAX's (2, 2)
    step within 1e-10."""
    hidden = (32, 32, 32)
    jm, X, Y = _data(hidden, seed=1)
    jlosses, jnet = _jax_run(jm, X, Y, 2, 2)
    model = _port_model(jm, hidden)
    data = {"X": X, "Y": Y, "hidden": np.asarray(hidden), "lr": 1e-3,
            "steps": STEPS, "dp": 2, "tp": 2, "dtype": "float64"}
    for i, layer in enumerate(model.net):
        data[f"w{i}"] = layer.w.detach().numpy()
        data[f"b{i}"] = layer.b.detach().numpy()
    results = run_cluster(nproc=4, devices_per_proc=1, timeout=240,
                          device="cpu", workloads=("train",), train=data)
    for r in results[1:]:
        assert r["train_net"] == results[0]["train_net"]
        assert r["train_losses"] == results[0]["train_losses"]
    mesh = Mesh(["cpu"] * 4, ("dp", "tp"), (2, 2))
    init, step_fn, place_batch = make_sharded_train_step(model, mesh, 1e-3)
    params, opt = init()
    Xs, Ys = place_batch(X, Y)
    for _ in range(STEPS):
        params, opt, _loss = step_fn(params, opt, Xs, Ys)
    local = [{"w": p["w"].numpy().tolist(), "b": p["b"].numpy().tolist()}
             for p in params.full()]
    assert results[0]["train_net"] == local
    np.testing.assert_allclose(results[0]["train_losses"], jlosses, rtol=TOL)
    _assert_net(results[0]["train_net"], jnet)


def test_rejects_what_does_not_split():
    jm, X, Y = _data((32, 32, 32))
    model = _port_model(jm, (32, 32, 32))
    with pytest.raises(ValueError, match="dp"):
        make_sharded_train_step(model, Mesh(["cpu"] * 4), 1e-3)
    with pytest.raises(ValueError, match="divide"):
        make_sharded_train_step(model, Mesh(["cpu"] * 3, ("dp", "tp"),
                                            (1, 3)), 1e-3)
    init, _, place_batch = make_sharded_train_step(
        model, Mesh(["cpu"] * 8, ("dp", "tp"), (4, 2)), 1e-3)
    with pytest.raises(ValueError, match="batch"):
        place_batch(X[:10], Y[:10])
