"""The port's mesh-sharded fused solve (parallel/fused.py
``ShardedFusedMPPI``: a fused solve object a shard, then the shard merge)
against the JAX package's (mppi_tf_tpu/parallel/fused.py), on a local mesh
of 8 CPU shards, where the fused wrappers run their plain versions; the
JAX side runs its Pallas kernels in interpret mode on its 8 virtual
devices, as tests/test_sharded_fused.py does. Every normal is made from a
seed with numpy and injected. Mirrors tests/test_sharded_fused.py: the
merge against the single-device solve and JAX's sharded solve, the option
matrix, the factory, trace / profile / dump_hlo, an indivisible K, the
AUV and its waypoint pops, DMD; and a mesh of one shard equal to the
single-device fused step bit for bit. The kernels themselves on the card
are held by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.kernels.pm_mppi import FusedPointMassMPPI as JFused
from mppi_tf_tpu.kernels.pm_mppi import chunk_noise
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.parallel import make_mesh as jmake_mesh
from mppi_tf_tpu.parallel.fused import build_sharded_fused_solve as jbuild
from mppi_tf_tpu_torch.controller import (ShardedFusedDMDMPPI,
                                          get_controller, savgol_matrix)
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.kernels import pm_mppi as pm
from mppi_tf_tpu_torch.kernels.auv_mppi import FusedAUVMPPI
from mppi_tf_tpu_torch.kernels.errors import KernelUnsupportedError
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.dmd import DMDModel
from mppi_tf_tpu_torch.parallel import ShardedMPPI, make_mesh
from mppi_tf_tpu_torch.parallel.fused import (ShardedFusedMPPI,
                                              build_sharded_fused_solve)
from tests.test_auv_kernel import _auv_cfg, _task

SIGMA = np.diag([0.25, 0.3, 0.2])
LAM, GAMMA, UPS = 0.8, 0.2, 1.2
TASK = {"type": "static", "diag": True,
        "goal": [1.0, 0.0, 0.5, 0.0, -0.5, 0.0],
        "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}
MODEL = {"type": "point_mass", "mass": 1.3}
X0 = [0.2, 0.0, -0.1, 0.0, 0.3, 0.0]
#: the f32 merge of 8 shards against one merge of the same samples (and
#: against JAX's f32 sharded kernels): the tolerance of
#: tests/test_sharded_fused.py
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


def _modules(task=TASK):
    model = get_model(MODEL, dt=0.1, state_dim=6, action_dim=3,
                      device="cpu")
    cost = get_cost(task, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA,
                    device="cpu")
    return model, cost


def _ctrl(k, tau, n=8, **kw):
    model, cost = _modules()
    return ShardedFusedMPPI(model, cost, _mesh(n), k=k, tau=tau, lam=LAM,
                            upsilon=UPS, sigma=SIGMA, **kw)


def _inputs(k, tau, seed=5):
    rng = np.random.RandomState(seed)
    z = rng.randn(tau, 3, k).astype(np.float32)
    useq = (0.1 * rng.randn(tau, 3)).astype(np.float32)
    return z, useq


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("normalize", [False, True])
def test_sharded_fused_matches_single_device(normalize):
    """tests/test_sharded_fused.py:39: the 8-shard merge == the
    single-device fused solve on the same normals."""
    k, tau = 1024, 10
    ctrl = _ctrl(k, tau, normalize_cost=normalize)
    model, cost = _modules()
    single = pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                   upsilon=UPS, sigma=SIGMA)
    z, useq = _inputs(k, tau)
    wn, info_s = single.solve(_t(X0), _t(useq), z=_t(z), normalize=normalize)
    a, new_useq, info = ctrl._solve_with_noise(_t(z), _t(X0), _t(useq))
    expected = _t(useq) + wn
    np.testing.assert_allclose(a.numpy(), expected[0].numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(new_useq[:-1].numpy(), expected[1:].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.all(new_useq[-1] == 0)
    for key, rtol in (("cost_min", 1e-6), ("cost_max", 1e-6),
                      ("cost_mean", 1e-5), ("nabla", RTOL)):
        np.testing.assert_allclose(float(info[key]), float(info_s[key]),
                                   rtol=rtol)


@pytest.mark.parametrize("normalize", [False, True])
def test_sharded_fused_matches_jax_sharded_fused(normalize):
    """The port's shard merge against JAX's sharded fused solve
    (build_sharded_fused_solve over 8 devices, interpret mode) on the
    same normals."""
    k, tau, tile = 512, 6, 64
    z, useq = _inputs(k, tau, seed=11)
    jmodel = jget_model(MODEL, dt=0.1, state_dim=6, action_dim=3)
    jcost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    local = JFused(jmodel, jcost, k=k // 8, tau=tau, lam=LAM, upsilon=UPS,
                   sigma=SIGMA, tile=tile, interpret=True)
    _, jswn = jbuild(local, jmake_mesh(8, ("k",)), k,
                     normalize_cost=normalize)
    a_j, u_j, info_j = jswn(jnp.asarray(chunk_noise(z, tile)),
                            jnp.asarray(X0, jmodel.dtype),
                            jnp.asarray(useq, jmodel.dtype),
                            jmodel.init_params(), jcost.init_params())
    ctrl = _ctrl(k, tau, normalize_cost=normalize)
    _, swn = build_sharded_fused_solve(ctrl)
    a, u, info = swn(_t(z), _t(X0), _t(useq))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=RTOL,
                               atol=ATOL)
    for key in ("cost_min", "cost_max", "cost_mean", "nabla"):
        np.testing.assert_allclose(float(info[key]), float(info_j[key]),
                                   rtol=RTOL)


@pytest.mark.parametrize("normalize,clip,filt", [
    (True, False, False),
    (False, True, False),
    (False, False, True),
    (True, True, True),
])
def test_sharded_fused_options_match_single_device(normalize, clip, filt):
    """tests/test_sharded_fused.py:77: normalize / clip / filter on the
    sharded fused path == JAX's single-device XLA controller with the same
    options on the same normals."""
    k, tau = 1024, 15
    jmodel = jget_model(MODEL, dt=0.1, state_dim=6, action_dim=3)
    jcost = jget_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA)
    jctrl = JMPPI(jmodel, jcost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                  sigma=SIGMA, normalize_cost=normalize, clip_actions=clip,
                  filter_seq=filt)
    z, useq = _inputs(k, tau, seed=17)
    eps = np.einsum("ij,tjk->kti", (UPS * SIGMA).astype(np.float32), z)
    a_ref, u_ref, _ = jctrl._solve_with_noise_jit(
        jnp.asarray(eps, jmodel.dtype), jnp.asarray(X0, jmodel.dtype),
        jnp.asarray(useq, jmodel.dtype), jmodel.init_params(),
        jcost.init_params())
    ctrl = _ctrl(k, tau, normalize_cost=normalize, clip_actions=clip,
                 filter_seq=filt)
    a, u, _ = ctrl._solve_with_noise(_t(z), _t(X0), _t(useq))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=2e-3,
                               atol=2e-4)
    if filt:
        S = torch.as_tensor(savgol_matrix(tau, 9, 3), dtype=torch.float32)
        assert torch.equal(ctrl._S, S)


@pytest.mark.parametrize("normalize", [False, True])
def test_one_shard_mesh_is_the_fused_step(normalize):
    """A mesh of one shard: the single-device fused solve and sequence
    update bit for bit, on injected normals and on the Philox stream of
    the step (solve s n + g = s), with an int or a device index."""
    k, tau = 700, 7
    ctrl = _ctrl(k, tau, n=1, normalize_cost=normalize, seed=9)
    model, cost = ctrl._model, ctrl._cost
    single = pm.FusedPointMassMPPI(model, cost, k=k, tau=tau, lam=LAM,
                                   upsilon=UPS, sigma=SIGMA)
    z, useq = _inputs(k, tau, seed=2)
    a, u, _ = ctrl._solve_with_noise(_t(z), _t(X0), _t(useq))
    wn, _ = single.solve(_t(X0), _t(useq), seed=9, z=_t(z),
                         normalize=normalize)
    want = ctrl._postprocess(_t(useq), wn)
    assert torch.equal(a, want[0]) and torch.equal(u, want[1])
    for solve in (3, torch.tensor([3])):
        a, u, info = ctrl._fused_step(_t(X0), _t(useq), solve=solve)
        wn, info_s = single.solve(_t(X0), _t(useq), seed=9, solve=3,
                                  normalize=normalize)
        want = ctrl._postprocess(_t(useq), wn)
        assert torch.equal(a, want[0]) and torch.equal(u, want[1])
        for key in ("cost_min", "cost_max", "cost_mean", "nabla"):
            assert torch.equal(info[key], info_s[key]), key


def test_shards_draw_solve_s_n_plus_g():
    """Shard g of n draws the Philox stream of solve s n + g: the 4-shard
    merge of step s equals merging the four one-shard solves' rows."""
    k, tau, n, s = 400, 5, 4, 2
    ctrl = _ctrl(k, tau, n=n, seed=4)
    shard = ctrl._fused.shards[0]
    rows = [torch.cat([st, zs]) for zs, st in (
        shard.solve_raw(_t(X0), torch.zeros(tau, 3), seed=4, solve=s * n + g)
        for g in range(n))]
    g_rows = torch.stack(rows)
    f = torch.exp(g_rows[:, 0] - g_rows[:, 0].max())
    zsum = (g_rows[:, pm.STATS:] * f[:, None]).sum(0)
    want = shard._unfold(zsum) / (g_rows[:, 1] * f).sum()
    wn, _ = ctrl._fused.solve(_t(X0), torch.zeros(tau, 3), seed=4, solve=s)
    assert torch.equal(wn, want)
    by_tensor, _ = ctrl._fused.solve(_t(X0), torch.zeros(tau, 3), seed=4,
                                     solve=torch.tensor([s]))
    assert torch.equal(by_tensor, wn)


def test_factory_forwards_antithetic():
    """tests/test_sharded_fused.py:126: get_controller(mesh=,
    kernel="cuda") builds the fused class with antithetic on every
    shard; kernel="torch" the torch-route class."""
    model, cost = _modules()
    cfg = {"samples": 1024, "horizon": 10, "lambda": LAM, "upsilon": UPS,
           "noise": SIGMA}
    ctrl = get_controller(model, cost, cfg, mesh=_mesh(), kernel="cuda",
                          antithetic=True)
    assert type(ctrl) is ShardedFusedMPPI and ctrl.kernel_path == "cuda"
    assert all(f.antithetic for f in ctrl._fused.shards)
    assert len(ctrl._fused.shards) == 8 and ctrl._fused.k_local == 128
    a = ctrl.next(np.asarray(X0))
    assert a.shape == (3,) and np.all(np.isfinite(a))
    xctrl = get_controller(model, cost, cfg, mesh=_mesh(), kernel="xla")
    assert type(xctrl) is ShardedMPPI
    assert np.all(np.isfinite(xctrl.next(np.asarray(X0))))
    auto = get_controller(model, cost, cfg, mesh=_mesh())
    assert type(auto) is ShardedMPPI   # CPU shards: "auto" is the torch route
    with pytest.raises(TypeError, match="kernel_tile"):
        get_controller(model, cost, cfg, mesh=_mesh(), kernel="cuda",
                       kernel_tile=64)
    bf = get_controller(model, cost, dict(cfg, **{"kernel-dtype":
                                                  "bfloat16"}),
                        mesh=_mesh(), kernel="cuda")
    assert all(f.compute_dtype == "bfloat16" for f in bf._fused.shards)


def test_sharded_controllers_trace_profile_dump_hlo(tmp_path):
    """tests/test_sharded_fused.py:148: trace, profile and dump_hlo on both
    sharded controllers; trace keeps a configured init_seq."""
    model, cost = _modules()
    k, tau = 1024, 10
    sx = ShardedMPPI(model, cost, _mesh(), k=k, tau=tau, lam=LAM,
                     upsilon=UPS, sigma=SIGMA)
    sf = _ctrl(k, tau)
    for ctrl in (sx, sf):
        ctrl.trace()
        assert ctrl.timing["calls"] == 0
        assert np.allclose(ctrl.useq.numpy(), 0.0)
        text = ctrl.dump_hlo()
        assert isinstance(text, str) and len(text) > 100
        ctrl.profile(logdir=str(tmp_path))
    init = np.tile([[0.2, -0.1, 0.3]], (tau, 1))
    for cls in (ShardedMPPI, ShardedFusedMPPI):
        ctrl = cls(model, cost, _mesh(), k=k, tau=tau, lam=LAM, upsilon=UPS,
                   sigma=SIGMA, init_seq=init)
        ctrl.trace()
        np.testing.assert_allclose(ctrl.useq.numpy(), init, rtol=1e-6)


def test_sharded_fused_rejects_indivisible_k():
    with pytest.raises(ValueError, match="divisible"):
        _ctrl(1001, 10)
    model = get_model(MODEL, dt=0.1, state_dim=6, action_dim=3,
                      dtype=torch.float64, device="cpu")
    cost = get_cost(TASK, lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=SIGMA,
                    dtype=torch.float64, device="cpu")
    with pytest.raises(KernelUnsupportedError):
        ShardedFusedMPPI(model, cost, _mesh(), k=64, tau=4, lam=LAM,
                         upsilon=UPS, sigma=SIGMA)


def _auv(task):
    sigma = np.diag([40.0, 40.0, 40.0, 5.0, 5.0, 5.0])
    model = get_model(_auv_cfg(), dt=0.1, action_dim=6, device="cpu")
    cost = get_cost(task, lam=0.5, gamma=0.2, upsilon=1.0, sigma=sigma,
                    device="cpu")
    return ShardedFusedMPPI(model, cost, _mesh(), k=8 * 32, tau=2, lam=0.5,
                            upsilon=1.0, sigma=sigma)


def test_sharded_fused_auv_runs():
    """tests/test_sharded_fused.py:188: the AUV's fused solve on every
    shard and the merge give finite actions."""
    ctrl = _auv(_task())
    assert all(isinstance(f, FusedAUVMPPI) for f in ctrl._fused.shards)
    x0 = np.zeros(13)
    x0[6] = 1.0
    a = ctrl.next(x0)
    assert a.shape == (6,) and np.all(np.isfinite(a))


def test_sharded_fused_auv_waypoints_runs_and_pops():
    """tests/test_sharded_fused.py:208: the quaternion waypoint mission on
    the sharded fused solve, attitude-aware pops, no rebuild."""
    wp1 = np.zeros(13)
    wp1[2], wp1[6] = -1.0, 1.0
    wp2 = np.zeros(13)
    wp2[2], wp2[6] = -2.0, 1.0
    ctrl = _auv({"type": "waypoints_quat", "diag": True,
                 "waypoints": [wp1.tolist()],
                 "Q": [100.0, 100.0, 100.0, 10.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                       1.0]})
    shards = list(ctrl._fused.shards)
    ctrl.set_waypoints([wp1, wp2])
    assert ctrl.waypoints_remaining() == 2
    x0 = np.zeros(13)
    x0[6] = 1.0
    assert np.all(np.isfinite(ctrl.next(x0)))
    flipped = wp1.copy()
    flipped[3:7] = [0.0, 0.0, 1.0, 0.0]
    assert ctrl.advance_waypoints(flipped, radius=0.5) is False
    assert ctrl.advance_waypoints(wp1, radius=0.5) is True
    assert ctrl.waypoints_remaining() == 1
    assert np.all(np.isfinite(ctrl.next(x0)))
    assert ctrl._fused.shards == shards


def test_sharded_fused_dmd_matches_single_device():
    """tests/test_sharded_fused.py:255: the dynamic-(A, B) solve composes
    with the shard merge, and the factory builds the adaptive sharded
    fused controller for a DMD model."""
    k, tau = 1024, 8
    rng = np.random.RandomState(9)
    A = np.eye(6) + 0.05 * rng.randn(6, 6)
    B = 0.1 * rng.randn(6, 3)
    model = DMDModel(6, 3, init_A=A, init_B=B, device="cpu")
    _, cost = _modules()
    cfg = {"samples": k, "horizon": tau, "lambda": LAM, "upsilon": UPS,
           "noise": SIGMA.tolist(), "kernel": "cuda", "refit-every": 5}
    ctrl = get_controller(model, cost, cfg, mesh=_mesh())
    assert type(ctrl) is ShardedFusedDMDMPPI
    assert all(isinstance(f, pm.FusedLTIMPPI) for f in ctrl._fused.shards)
    assert ctrl._refit_every == 5
    single = pm.FusedLTIMPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                             sigma=SIGMA)
    z = rng.randn(tau, 3, k).astype(np.float32)
    useq = (0.1 * rng.randn(tau, 3)).astype(np.float32)
    wn, _ = single.solve(_t(X0), _t(useq), z=_t(z))
    a, new_useq, _ = ctrl._solve_with_noise(_t(z), _t(X0), _t(useq))
    expected = _t(useq) + wn
    np.testing.assert_allclose(a.numpy(), expected[0].numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(new_useq[:-1].numpy(), expected[1:].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_sharded_adaptive_dmd_refits_from_save():
    """The adaptive mixin over both sharded classes: save() buffers, every
    refit_every saves once min_samples are in, (A, B) are refit in place
    and every shard's solve reads them."""
    from mppi_tf_tpu_torch.controller import ShardedDMDMPPI

    truth = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=4, action_dim=2, dtype=torch.float64)
    sigma = np.diag([0.4, 0.4])
    cost = get_cost({"type": "static", "diag": True,
                     "goal": [1.0, 0.0, -0.5, 0.0], "Q": [8.0, 1.5, 8.0, 1.5]},
                    lam=0.6, gamma=0.2, upsilon=1.0, sigma=sigma,
                    dtype=torch.float64)
    rng = np.random.default_rng(0)
    for cls, dtype in ((ShardedDMDMPPI, torch.float64),
                       (ShardedFusedDMDMPPI, torch.float32)):
        model = DMDModel(4, 2, reg=1e-11, dtype=dtype, device="cpu")
        c = cost.to(dtype)
        ctrl = cls(model, c, _mesh(), k=256, tau=10, lam=0.6, upsilon=1.0,
                   sigma=sigma, refit_every=5)
        x = np.zeros(4)
        for _ in range(20):
            u = ctrl.next(x) + 0.3 * rng.normal(size=2)
            with torch.no_grad():
                x_next = truth.step(torch.as_tensor(x)[None],
                                    torch.as_tensor(u)[None])[0].numpy()
            ctrl.save(x, u, x_next)
            x = x_next
        assert ctrl.n_fits == 2   # at saves 15 and 20 (min_samples 12)
        np.testing.assert_allclose(ctrl.model_params["A"].double().numpy(),
                                   truth.A.numpy(), atol=1e-3)


@pytest.mark.parametrize("normalize", [False, True])
def test_sharded_fused_nn_matches_single_device(normalize):
    """ShardedFusedMPPI over an NNAUVModel (kernel="cuda"; the JAX
    class's order reaches FusedNNMPPI): the 4-shard merge against the
    single-device NN solve on the same normals."""
    from mppi_tf_tpu_torch.kernels.nn_mppi import FusedNNMPPI
    from mppi_tf_tpu_torch.models.nn import NNAUVModel

    sigma = np.diag([5.0] * 3 + [2.0] * 3)
    model = NNAUVModel(hidden=(8, 8), seed=4, device="cpu")
    goal = np.zeros(13)
    goal[[2, 6]] = [-1.0, 1.0]
    cost = get_cost({"type": "static_quat", "diag": True,
                     "goal": goal.tolist(), "Q": [60.0] * 4 + [1.0] * 6},
                    lam=LAM, gamma=GAMMA, upsilon=UPS, sigma=sigma,
                    device="cpu")
    k, tau = 256, 4
    ctrl = get_controller(model, cost, {
        "samples": k, "horizon": tau, "lambda": LAM, "upsilon": UPS,
        "noise": sigma, "normalize": normalize}, mesh=_mesh(4),
        kernel="cuda")
    assert all(isinstance(f, FusedNNMPPI) for f in ctrl._fused.shards)
    single = FusedNNMPPI(model, cost, k=k, tau=tau, lam=LAM, upsilon=UPS,
                         sigma=sigma)
    rng = np.random.RandomState(3)
    z = _t(rng.randn(tau, 6, k))
    x0 = np.zeros(13)
    x0[6] = 1.0
    useq = _t(rng.randn(tau, 6))
    wn, _ = single.solve(_t(x0), useq, z=z, normalize=normalize)
    got, _ = ctrl._fused.solve(_t(x0), useq, z=z, normalize=normalize)
    np.testing.assert_allclose(got.numpy(), wn.numpy(), rtol=RTOL,
                               atol=ATOL * float(wn.abs().max()))
