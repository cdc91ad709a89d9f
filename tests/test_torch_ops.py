"""The port's ops (mppi_tf_tpu_torch/ops) against the JAX package's, at f64.

Inputs come from numpy seeds; both packages get the same arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.ops import noise as jnoise
from mppi_tf_tpu.ops import rollout as jroll
from mppi_tf_tpu.ops import update as jupd
from mppi_tf_tpu_torch.ops import noise as tnoise
from mppi_tf_tpu_torch.ops import rollout as troll
from mppi_tf_tpu_torch.ops import update as tupd

RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL,
                               atol=1e-13)


def _inputs(seed=0, k=64, tau=9, adim=3):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(1.0, 40.0, size=k)
    noises = rng.normal(size=(k, tau, adim)) * 0.3
    return costs, noises


@pytest.mark.parametrize("normalize", [False, True])
def test_norm_arg_beta(normalize):
    costs, _ = _inputs(1)
    b_t = tupd.beta(_t(costs))
    b_j = jupd.beta(jnp.asarray(costs))
    _close(b_t, b_j)
    _close(tupd.norm_arg(_t(costs), b_t, normalize),
           jupd.norm_arg(jnp.asarray(costs), b_j, normalize))


def test_norm_arg_all_equal_costs():
    costs = np.full(10, 3.0)
    out = tupd.norm_arg(_t(costs), tupd.beta(_t(costs)), normalize=True)
    _close(out, jupd.norm_arg(jnp.asarray(costs), 3.0, normalize=True))
    assert torch.all(torch.isfinite(out))


@pytest.mark.parametrize("lam", [0.1, 0.8, 5.0])
def test_exp_chain(lam):
    costs, _ = _inputs(2)
    arg = costs - costs.min()
    e_t = tupd.exp(tupd.exp_arg(_t(arg), lam))
    e_j = jupd.exp(jupd.exp_arg(jnp.asarray(arg), lam))
    _close(e_t, e_j)
    n_t, n_j = tupd.nabla(e_t), jupd.nabla(e_j)
    _close(n_t, n_j)
    _close(tupd.weights(e_t, n_t), jupd.weights(e_j, n_j))


def test_weighted_noise():
    costs, noises = _inputs(3)
    w = np.exp(-costs / 7.0)
    w /= w.sum()
    _close(tupd.weighted_noise(_t(w), _t(noises)),
           jupd.weighted_noise(jnp.asarray(w), jnp.asarray(noises)))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("lam", [0.5, 2.0])
def test_mppi_update(normalize, lam):
    costs, noises = _inputs(4)
    _close(tupd.mppi_update(_t(costs), _t(noises), lam, normalize),
           jupd.mppi_update(jnp.asarray(costs), jnp.asarray(noises), lam,
                            normalize))


@pytest.mark.parametrize("length", [1, 3])
def test_shift_get_next_init_zeros(length):
    rng = np.random.default_rng(5)
    useq = rng.normal(size=(8, 3))
    init_t = tupd.init_zeros(length, 3, dtype=torch.float64)
    init_j = jupd.init_zeros(length, 3, dtype=jnp.float64)
    _close(init_t, init_j)
    assert init_t.dtype == torch.float64
    _close(tupd.shift(_t(useq), init_t, length),
           jupd.shift(jnp.asarray(useq), init_j, length))
    _close(tupd.get_next(_t(useq), length),
           jupd.get_next(jnp.asarray(useq), length))


@pytest.mark.parametrize("spec", [
    None,
    [1.0, 0.9, 0.8, 0.7, 0.6],
    {"type": "constant", "value": 0.5},
    {"type": "linear", "start": 1.0, "end": 0.2},
    {"type": "exp", "start": 1.0, "end": 0.25},
    {"type": "cosine", "start": 1.5, "end": 0.5},
])
def test_resolve_noise_schedule(spec):
    port = tnoise.resolve_noise_schedule(spec, 5)
    ref = jnoise.resolve_noise_schedule(spec, 5)
    if ref is None:
        assert port is None
    else:
        _close(port, ref)


@pytest.mark.parametrize("spec", [
    {"type": "bogus"}, [1.0, 2.0], [1.0, -1.0, 1.0, 1.0, 1.0]])
def test_resolve_noise_schedule_rejects(spec):
    with pytest.raises(ValueError):
        tnoise.resolve_noise_schedule(spec, 5)
    with pytest.raises(ValueError):
        jnoise.resolve_noise_schedule(spec, 5)


@pytest.mark.parametrize("scheduled", [False, True])
def test_scale_noise(scheduled):
    rng = np.random.default_rng(6)
    z = rng.normal(size=(20, 5, 3))
    sigma = np.array([[0.3, 0.05, 0.0], [0.05, 0.2, 0.01],
                      [0.0, 0.01, 0.4]])
    sched = np.linspace(1.0, 0.3, 5) if scheduled else None
    _close(tnoise.scale_noise(_t(z), _t(sigma), 1.3, schedule=sched),
           jnoise.scale_noise(jnp.asarray(z), jnp.asarray(sigma), 1.3,
                              schedule=sched))


@pytest.mark.parametrize("antithetic", [False, True])
def test_sample_noise_shape_and_generator(antithetic):
    """Same generator seed, same draw; antithetic halves mirror exactly."""
    sigma = _t(np.diag([0.25, 0.3, 0.2]))
    sampler = (tnoise.sample_noise_antithetic if antithetic
               else tnoise.sample_noise)
    draws = [sampler(torch.Generator().manual_seed(3), 11, 4, 3, sigma,
                     1.0, dtype=torch.float64) for _ in range(2)]
    assert draws[0].shape == (11, 4, 3)
    assert torch.equal(draws[0], draws[1])
    if antithetic:
        torch.testing.assert_close(draws[0][6:], -draws[0][:5], rtol=0,
                                   atol=0)


def _pm_matrices(sdim=6, adim=3, dt=0.1):
    A = np.zeros((sdim, sdim))
    B = np.zeros((sdim, adim))
    for i in range(adim):
        A[2 * i:2 * i + 2, 2 * i:2 * i + 2] = [[1.0, dt], [0.0, 1.0]]
        B[2 * i:2 * i + 2, i] = [dt * dt / 2.0, dt]
    return A, B


@pytest.mark.parametrize("scheduled", [False, True])
def test_rollout_costs(scheduled):
    rng = np.random.default_rng(7)
    k, tau = 40, 6
    A, B = _pm_matrices()
    goal = rng.normal(size=6)
    inv_sig = np.diag([4.0, 3.0, 5.0])
    x0 = rng.normal(size=6)
    useq = rng.normal(size=(tau, 3)) * 0.2
    eps = rng.normal(size=(k, tau, 3)) * 0.3
    sched = np.linspace(1.0, 0.5, tau) if scheduled else None

    def fns(xp, mat):
        a, b, g, s = mat(A), mat(B), mat(goal), mat(inv_sig)

        def act(u, e, c=None):
            si = s if c is None else s / c
            return 0.5 * (0.2 * (u @ si @ u) + 0.4 * (e @ (si @ u))
                          + 0.1 * xp.sum(e * (e @ si.T), axis=-1))

        def q(x):
            d = x - g
            return xp.sum(d * d, axis=-1)

        return (lambda x, u: x @ a.T + u @ b.T), q, act, q

    port = troll.rollout_costs(*fns(torch, _t), _t(x0), _t(useq), _t(eps),
                               sched=None if sched is None else _t(sched))
    ref = jroll.rollout_costs(*fns(jnp, jnp.asarray), jnp.asarray(x0),
                              jnp.asarray(useq), jnp.asarray(eps),
                              sched=sched)
    _close(port, ref)


@pytest.mark.parametrize("batched", [False, True])
def test_rollout_trajectory(batched):
    rng = np.random.default_rng(8)
    A, B = _pm_matrices()
    x0 = rng.normal(size=(5, 6) if batched else 6)
    useq = rng.normal(size=(5, 7, 3) if batched else (7, 3))
    port = troll.rollout_trajectory(
        lambda x, u: x @ _t(A).T + u @ _t(B).T, _t(x0), _t(useq))
    ref = jroll.rollout_trajectory(
        lambda x, u: x @ jnp.asarray(A).T + u @ jnp.asarray(B).T,
        jnp.asarray(x0), jnp.asarray(useq))
    assert tuple(port.shape) == tuple(ref.shape)
    _close(port, ref)


@pytest.mark.parametrize("h,w,count", [(2, 2, 3), (2, 1, 3), (1, 1, 1)])
def test_block_diag_matches_jax_package(h, w, count):
    from mppi_tf_tpu.utils.blockdiag import block_diag as jblock
    from mppi_tf_tpu_torch.utils import block_diag

    block = np.arange(h * w, dtype=np.float64).reshape(h, w) + 1.0
    np.testing.assert_array_equal(block_diag(block, count),
                                  jblock(block, count))


@pytest.mark.parametrize("shape,want,ok", [
    ((4, 13, 1), (-1, 13, 1), True), ((4, 13), (-1, 13, 1), False),
    ((4, 12, 1), (-1, 13, 1), False), ((2, 3), (2, 3), True)])
def test_shapes_match_jax_package(shape, want, ok):
    from mppi_tf_tpu.utils import shapes as jshapes
    from mppi_tf_tpu_torch.utils import assert_shape, check_shape

    arr = torch.zeros(shape)
    assert assert_shape(arr, want) is ok
    assert jshapes.assert_shape(np.zeros(shape), want) is ok
    if ok:
        check_shape(arr, want)
    else:
        with pytest.raises(AssertionError):
            check_shape(arr, want, "x")
    assert assert_shape(None, want) is False
