"""The learned AUV (``NNAUVModel``) on the fleet's normal path, on the CPU
(the kernel route's plain versions, the kernels' Philox stream): the NN
solve's vehicle axis (one weight segment, a row a vehicle) against n
one-vehicle solves bit for bit, a weight update reaching the next fleet
solve, the weight segment's span and counter, ``get_model`` reading an NN
family's ``hidden``, ``seed`` and ``normalisers``, and ``kernel="auto"``
trying the NN kernel last. Sizes: 3 vehicles, K = 256, tau = 5, the
published 3 x 32 widths. The vehicle axis on the card is held by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from mppi_tf_tpu_torch import tracing
from mppi_tf_tpu_torch.controller import MPPI, FleetMPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import nn_mppi
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.nn import NNAUVModel, NNAUVModelSpeed, NNModel

N, K, TAU = 3, 256, 5
SIGMA = np.diag([2000.0] * 3 + [200.0] * 3)
LAM, GAMMA = 0.5, 0.2
Q = [60.0, 60.0, 60.0, 10.0] + [1.0] * 6
GOALS = np.array([[0.0, 0.0, z, 0.0, 0.0, 0.0, 1.0] + [0.0] * 6
                  for z in (-0.5, -1.2, -1.9)])
NORM = {"x_mean": np.linspace(-0.2, 0.3, 16),
        "x_std": np.linspace(0.5, 2.0, 16),
        "y_mean": np.linspace(-1e-3, 1e-3, 13),
        "y_std": np.linspace(0.01, 0.05, 13)}
NORM["x_mean"][10:] = 30.0
NORM["x_std"][10:] = [2000.0] * 3 + [200.0] * 3
OPTIONS = [{}, {"normalize_cost": True}, {"antithetic": True},
           {"normalize_cost": True, "kernel_dtype": "bfloat16"}]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _model():
    return get_model({"type": "auv_nn", "hidden": [32, 32, 32], "seed": 3,
                      "normalisers": NORM}, dt=0.1, state_dim=13,
                     action_dim=6, device="cpu")


def _cost(goal=GOALS[0]):
    return get_cost({"type": "static_quat", "diag": True, "Q": Q,
                     "goal": list(goal)}, lam=LAM, gamma=GAMMA, upsilon=1.0,
                    sigma=SIGMA, device="cpu")


def _kernel_route(ctrl, kernel_dtype="float32"):
    """The controller (or a fleet's template) on the fused solve's plain
    versions at ``kernel_dtype``."""
    ctrl._kernel_dtype = kernel_dtype
    ctrl._resolve_kernel("auto", SIGMA, None)
    assert isinstance(ctrl._fused, nn_mppi.FusedNNMPPI)
    return ctrl


def _fleet(kernel_dtype="float32", **options):
    fleet = FleetMPPI(_model(), _cost(), n_vehicles=N, k=K, tau=TAU, lam=LAM,
                      upsilon=1.0, sigma=SIGMA, goals=GOALS, seed=11,
                      device="cpu", **options)
    _kernel_route(fleet._tpl, kernel_dtype)
    assert fleet._tpl._fused.fleet_axis
    return fleet


def _states(seed=2):
    rng = np.random.default_rng(seed)
    x = np.zeros((N, 13))
    x[:, :3] = rng.normal(size=(N, 3))
    q = rng.normal(size=(N, 4)) * 0.1
    q[:, 3] += 1.0
    x[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    x[:, 7:] = 0.1 * rng.normal(size=(N, 6))
    return x


@pytest.mark.parametrize("options", OPTIONS,
                         ids=["plain", "normalize", "antithetic", "bf16"])
def test_fleet_step_equals_one_vehicle_solves(options):
    """Fleet step s (one launch of each phase for all vehicles; here the
    plain versions) == n one-vehicle NN solves with solve s n + v, bit for
    bit, at f32 and in the bf16 block compute."""
    options = dict(options)
    dtype = options.pop("kernel_dtype", "float32")
    fleet = _fleet(dtype, **options)
    singles = []
    for v in range(N):
        c = MPPI(_model(), _cost(GOALS[v]), k=K, tau=TAU, lam=LAM,
                 upsilon=1.0, sigma=SIGMA, seed=11, device="cpu", **options)
        singles.append(_kernel_route(c, dtype))
    states = _states()
    useq = [c.useq for c in singles]
    for s in range(2):
        a = fleet.next(states)
        for v, c in enumerate(singles):
            act, useq[v], _ = c._fused_step(
                torch.as_tensor(states[v], dtype=torch.float32), useq[v],
                solve=s * N + v)
            np.testing.assert_array_equal(a[v], act.numpy())
            assert torch.equal(fleet.useq[v], useq[v])
    assert fleet._last_info["weighted_noise"].shape == (N, TAU, 6)


def test_wrappers_take_one_segment_and_a_row_a_vehicle():
    """The fleet pack is (weight segment, rows [n, NNDyn.row]); the segment
    followed by row v is vehicle v's own dyn; each wrapper on the fleet's
    rows == n one-vehicle calls on those dyn arrays, injected z and
    Philox."""
    fleet = _fleet()
    fused = fleet._tpl._fused
    lay = fused.consts.layout(TAU)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(_states(4), dtype=torch.float32)
    u = torch.as_tensor(300.0 * rng.normal(size=(N, TAU, 6)),
                        dtype=torch.float32)
    weights, rows = fused.pack_dyn(x, u, fleet.cost_params)
    assert weights.shape == (lay.weights,) and rows.shape == (N, lay.row)
    z = torch.as_tensor(rng.standard_normal((N, TAU, 6, K)),
                        dtype=torch.float32)
    c = fused.consts
    for zz in (None, z):
        part = nn_mppi.nn_fused_solve(c, rows, K, TAU, seed=9, solve=5, z=zz,
                                      weights=weights)
        costs, srows = nn_mppi.nn_fused_costs(c, rows, K, TAU, seed=9,
                                              solve=5, z=zz, weights=weights)
        for v in range(N):
            one = fused.pack_dyn(x[v], u[v], {"goal": torch.as_tensor(
                GOALS[v], dtype=torch.float32)})
            assert torch.equal(one, torch.cat([weights, rows[v]]))
            kw = dict(seed=9, solve=5 * N + v,
                      z=None if zz is None else zz[v])
            assert torch.equal(part[v], nn_mppi.nn_fused_solve(
                c, one, K, TAU, **kw))
            c1, r1 = nn_mppi.nn_fused_costs(c, one, K, TAU, **kw)
            assert torch.equal(costs[v], c1) and torch.equal(srows[v], r1)


def test_the_segment_is_the_models_weights_and_normalisers():
    """The gathered segment holds each layer's W^T rows and biases, the
    four normalisers and zeros in the pads, as NNDyn lays them out."""
    fused = _fleet()._tpl._fused
    m, lay = fused.model, fused.consts.layout(TAU)
    seg = fused.pack_weights()
    want = torch.zeros(lay.weights)
    for (w_at, b_at, fan_in, fan_out), layer in zip(lay.layers, m.net):
        want[w_at:b_at] = layer.w.detach().T.reshape(-1)
        want[b_at:b_at + fan_out] = layer.b.detach()
    norm = torch.cat([m.x_mean, m.x_std, m.y_mean, m.y_std])
    want[lay.norm:lay.norm + norm.numel()] = norm
    assert torch.equal(seg, want)


def test_a_weight_update_reaches_the_next_fleet_solve():
    """New weights and normalisers written through ``model_params`` (the
    learner's hand-over) are in the next fleet solve: its actions equal
    those of a fleet whose model holds the new weights, and differ from
    the old weights' next step (normalised: every sample's cost moves the
    sequence, where an unnormalised softmax at these costs is one
    sample's)."""
    from mppi_tf_tpu_torch.interop import (_flatten, _model_tensors,
                                           _unflatten)

    states = _states()
    fleet, twin, stale = (_fleet(normalize_cost=True) for _ in range(3))
    gen = torch.Generator().manual_seed(5)
    new = {name: t + 0.05 * torch.randn(t.shape, generator=gen,
                                        dtype=t.dtype)
           for name, t in _flatten(fleet.model_params).items()}
    for f in (fleet, twin, stale):
        f.next(states)
    fleet.model_params = _unflatten(new)
    with torch.no_grad():
        for name, t in _model_tensors(twin._model).items():
            t.copy_(new[name])
    before = nn_mppi.weight_packs
    got = fleet.next(states)
    assert nn_mppi.weight_packs == before + 1
    np.testing.assert_array_equal(got, twin.next(states))
    assert not np.array_equal(got, stale.next(states))


def test_the_segment_pack_is_a_span_and_a_counter():
    """A fleet solve packs the weight segment once, inside the pack span
    (``mppi.solve.pack.weights`` under ``mppi.solve.pack``), and
    ``tracing.counters()`` reads the packs."""
    fleet = _fleet(normalize_cost=True)
    tracing.clear()
    tracing.enable()
    try:
        before = tracing.counters()["nn_weight_packs"]
        fleet.next(_states())
        spans = tracing.spans()
    finally:
        tracing.disable()
        tracing.clear()
    assert tracing.counters()["nn_weight_packs"] == before + 1
    packs = [s for s in spans if s.name == "mppi.solve.pack.weights"]
    assert len(packs) == 1 and packs[0].parent == "mppi.solve.pack"


def test_get_model_reads_hidden_seed_and_normalisers():
    """An NN family's dict states its network; explicit kwargs win."""
    m = get_model({"type": "auv_nn", "hidden": [8, 8], "seed": 7,
                   "normalisers": NORM}, dt=0.1, state_dim=13,
                  action_dim=6)
    assert m.hidden == (8, 8)
    ref = NNAUVModel(hidden=(8, 8), seed=7)
    for a, b in zip(m.net, ref.net):
        assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)
    for name, v in NORM.items():
        np.testing.assert_array_equal(getattr(m, name).numpy(),
                                      np.float32(v))
    m2 = get_model({"type": "auv_nn", "hidden": [8, 8], "seed": 7},
                   dt=0.1, hidden=(32, 32, 32), seed=1)
    assert m2.hidden == (32, 32, 32)
    assert torch.equal(m2.net[0].w, NNAUVModel(seed=1).net[0].w)
    assert torch.equal(m2.x_std, torch.ones(16))
    speed = get_model({"type": "auv_nn_speed", "hidden": [16, 16],
                       "normalisers": {"x_mean": 0.5, "x_std": 2.0,
                                       "y_mean": 0.0, "y_std": 1.0}})
    assert isinstance(speed, NNAUVModelSpeed) and speed.hidden == (16, 16)
    assert torch.equal(speed.x_std, torch.full((15,), 2.0))
    plain = get_model({"type": "neural_net", "hidden": [8]}, state_dim=4,
                      action_dim=2)
    assert isinstance(plain, NNModel) and plain.hidden == (8,)


@pytest.mark.parametrize("model", ["auv_nn", "auv_nn_speed", "neural_net"])
def test_auto_tries_the_nn_kernel_last(model):
    """``_resolve_kernel("auto")`` gives FusedNNMPPI for NNAUVModel and
    leaves NNAUVModelSpeed and NNModel on the torch route."""
    sdim = 13 if model != "neural_net" else 4
    m = get_model({"type": model, "hidden": [32, 32, 32]}, dt=0.1,
                  state_dim=sdim, action_dim=6)
    cost = (_cost() if sdim == 13 else
            get_cost({"type": "static", "diag": True, "Q": [1.0] * 4,
                      "goal": [0.0] * 4}, lam=LAM, gamma=GAMMA,
                     upsilon=1.0, sigma=SIGMA))
    ctrl = MPPI(m, cost, k=64, tau=3, lam=LAM, sigma=SIGMA, device="cpu")
    ctrl._resolve_kernel("auto", SIGMA, None)
    if model == "auv_nn":
        assert isinstance(ctrl._fused, nn_mppi.FusedNNMPPI)
        assert ctrl.kernel_path == "cuda"
    else:
        assert ctrl._fused is None and ctrl.kernel_path == "torch"
