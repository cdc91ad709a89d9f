"""The port's mesh-sharded torch-route solve (parallel/mesh.py,
parallel/sharded.py, ops/update.py ``mesh=``) against the JAX package's
(mppi_tf_tpu/parallel/), on a local mesh of 8 CPU shards beside JAX's 8
virtual XLA CPU devices (tests/conftest.py), f64, the same noise injected
as data into both. Mirrors tests/test_sharded.py: the sharded solve equals
the single-device one, closed loops (antithetic, filter), an indivisible
K, distinct shard noise, the factory's mesh branch, checkpoints and the
launch helpers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller.mppi import MPPI as JMPPI
from mppi_tf_tpu.costs.static import StaticCost as JStaticCost
from mppi_tf_tpu.models.point_mass import PointMassModel as JPointMass
from mppi_tf_tpu.parallel import build_sharded_solve as jbuild
from mppi_tf_tpu.parallel import make_mesh as jmake_mesh
from mppi_tf_tpu_torch.controller import MPPI, get_controller, savgol_matrix
from mppi_tf_tpu_torch.costs.static import StaticCost
from mppi_tf_tpu_torch.models.point_mass import PointMassModel
from mppi_tf_tpu_torch.ops import update as upd
from mppi_tf_tpu_torch.parallel import (Mesh, ShardedMPPI,
                                        build_sharded_solve, launch,
                                        make_mesh)
from mppi_tf_tpu_torch.parallel.sharded import shard_seed

F64 = torch.float64
SIGMA = np.diag([0.25, 0.3, 0.2])
#: the sharded torch route against JAX's sharded XLA solve, both f64 on
#: the same noise: the same algebra, each package's own reductions
RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cpu_mesh(n=8, axes=("k",)):
    return make_mesh(devices=["cpu"] * n, axis_names=axes)


def _setup(lam=1.2, gamma=1.1, ups=2.0):
    goal = np.zeros(6)
    goal[0] = 1.0
    model = PointMassModel(mass=1.5, dt=0.1, state_dim=6, action_dim=3,
                           dtype=F64)
    cost = StaticCost(lam, gamma, ups, SIGMA, goal, np.eye(6), dtype=F64)
    return model, cost, lam, ups


def _jax_setup(lam=1.2, gamma=1.1, ups=2.0):
    goal = np.zeros(6)
    goal[0] = 1.0
    model = JPointMass(mass=1.5, dt=0.1, state_dim=6, action_dim=3,
                       dtype=jnp.float64)
    cost = JStaticCost(lam, gamma, ups, SIGMA, goal, np.eye(6),
                       dtype=jnp.float64)
    return model, cost


def _inputs(k, tau, seed=20):
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(k, tau, 3)) * 0.3
    x0 = rng.normal(size=6)
    useq = rng.normal(size=(tau, 3)) * 0.1
    return eps, x0, useq


def _jax_sharded(k, tau, normalize=False, filter_mat=None):
    jm, jc = _jax_setup()
    ctrl = JMPPI(jm, jc, k=k, tau=tau, lam=1.2, upsilon=2.0, sigma=SIGMA)
    _, swn = jbuild(jm, jc, k, tau, 1.2, 2.0, SIGMA, jmake_mesh(),
                    normalize_cost=normalize, filter_mat=filter_mat)
    return lambda eps, x0, useq: swn(
        jnp.asarray(eps), jnp.asarray(x0), jnp.asarray(useq),
        ctrl.model_params, ctrl._cparams)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_mesh_has_8_shards():
    mesh = _cpu_mesh()
    assert mesh.shape["k"] == 8 and mesh.size == 8
    assert mesh.local_indices == list(range(8))
    grid = _cpu_mesh(8, ("dp", "tp"))
    assert grid.shape == {"dp": 4, "tp": 2}
    assert [grid.axis_index(i, "tp") for i in range(4)] == [0, 1, 0, 1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            make_mesh()
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 4, ("dp", "tp"), (3, 2))


def test_mesh_collectives_reduce_in_shard_order():
    mesh = _cpu_mesh(4)
    xs = [torch.tensor([1.0, -2.0]) * (i + 1) for i in range(4)]
    assert torch.equal(mesh.all_gather(xs), torch.stack(xs))
    assert torch.equal(mesh.psum(xs), torch.stack(xs).sum(0))
    assert torch.equal(mesh.pmean(xs), torch.stack(xs).sum(0) / 4)
    assert torch.equal(mesh.pmin(xs), torch.tensor([1.0, -8.0]))
    assert torch.equal(mesh.pmax(xs), torch.tensor([4.0, -2.0]))


@pytest.mark.parametrize("normalize", [False, True])
def test_update_law_over_shards_equals_single_device(normalize):
    """ops/update.py with mesh= (per-shard lists) == the single-device
    chain on the concatenated samples."""
    rng = np.random.default_rng(3)
    costs = torch.as_tensor(rng.normal(size=64) * 5.0 + 20.0)
    eps = torch.as_tensor(rng.normal(size=(64, 6, 3)))
    mesh = _cpu_mesh()
    got = upd.mppi_update(list(costs.split(8)), list(eps.split(8)), 0.7,
                          normalize=normalize, mesh=mesh)
    want = upd.mppi_update(costs, eps, 0.7, normalize=normalize)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-15)
    b = upd.beta(list(costs.split(8)), mesh)
    assert torch.equal(b, upd.beta(costs))


@pytest.mark.parametrize("normalize", [False, True])
def test_sharded_equals_single_device(normalize):
    """tests/test_sharded.py::test_sharded_equals_single_device: the port's
    sharded solve == JAX's sharded solve == the single-device solve, on
    the same injected noise."""
    model, cost, lam, ups = _setup()
    k, tau = 64, 8
    eps, x0, useq = _inputs(k, tau)
    a_j, u_j, info_j = _jax_sharded(k, tau, normalize)(eps, x0, useq)
    ctrl = ShardedMPPI(model, cost, _cpu_mesh(), k=k, tau=tau, lam=lam,
                       upsilon=ups, sigma=SIGMA, normalize_cost=normalize)
    a, u, info = ctrl._solve_with_noise(_t(eps), _t(x0), _t(useq))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=RTOL)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=RTOL,
                               atol=1e-14)
    for key in ("cost_min", "cost_mean", "cost_max"):
        np.testing.assert_allclose(float(info[key]), float(info_j[key]),
                                   rtol=1e-12)
    single = MPPI(model, cost, k=k, tau=tau, lam=lam, upsilon=ups,
                  sigma=SIGMA, normalize_cost=normalize, device="cpu")
    a1, u1, _ = single._solve_with_noise(_t(eps), _t(x0), _t(useq))
    np.testing.assert_allclose(a.numpy(), a1.numpy(), rtol=RTOL)
    np.testing.assert_allclose(u.numpy(), u1.numpy(), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("normalize", [False, True])
def test_one_shard_is_the_single_device_solve(normalize):
    """A mesh of one shard: the single-device solve bit for bit."""
    model, cost, lam, ups = _setup()
    eps, x0, useq = _inputs(48, 6, seed=4)
    one = ShardedMPPI(model, cost, _cpu_mesh(1), k=48, tau=6, lam=lam,
                      upsilon=ups, sigma=SIGMA, normalize_cost=normalize)
    single = MPPI(model, cost, k=48, tau=6, lam=lam, upsilon=ups,
                  sigma=SIGMA, normalize_cost=normalize, device="cpu")
    got = one._solve_with_noise(_t(eps), _t(x0), _t(useq))
    want = single._solve_with_noise(_t(eps), _t(x0), _t(useq))
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    for key in ("cost_min", "cost_mean", "cost_max", "weighted_noise"):
        assert torch.equal(got[2][key], want[2][key]), key


def _closed_loop(ctrl, model, steps=40):
    x = torch.zeros(6, dtype=F64)
    for _ in range(steps):
        u = ctrl.next(x.numpy())
        with torch.no_grad():
            x = model.step(x[None], torch.as_tensor(u)[None])[0]
    return x.numpy()


@pytest.mark.parametrize("antithetic", [False, True])
def test_sharded_controller_closed_loop(antithetic):
    """tests/test_sharded.py:63-90: 40 steps at K=512 over 8 shards reach
    the goal, with and without antithetic pairs."""
    model, cost, _, _ = _setup()
    ctrl = ShardedMPPI(model, cost, _cpu_mesh(), k=512, tau=20, lam=0.8,
                       upsilon=1.0, sigma=SIGMA, antithetic=antithetic)
    final = _closed_loop(ctrl, model)
    assert abs(final[0] - 1.0) < 0.25, final


def test_k_not_divisible_raises():
    model, cost, lam, ups = _setup()
    with pytest.raises(ValueError, match="divisible"):
        build_sharded_solve(model, cost, 13, 4, lam, ups, SIGMA, _cpu_mesh())
    with pytest.raises(ValueError, match="1-D"):
        ShardedMPPI(model, cost, _cpu_mesh(8, ("dp", "tp")), k=64, tau=4,
                    sigma=SIGMA)


def test_sharded_noise_shards_differ():
    """Each shard draws its own stream (a generator seeded from (seed,
    g)); antithetic pairs mirror within each shard."""
    model, cost, lam, ups = _setup()
    seen = []
    for antithetic in (False, True):
        ctrl = ShardedMPPI(model, cost, _cpu_mesh(), k=64, tau=4, lam=lam,
                           upsilon=ups, sigma=SIGMA, antithetic=antithetic)
        eps = []
        orig = ctrl._update_shards
        ctrl._update_shards = lambda s, u, e, sc: eps.extend(e) or orig(
            s, u, e, sc)
        ctrl.next(np.zeros(6))
        for i in range(7):
            assert not torch.allclose(eps[i], eps[i + 1])
        if antithetic:
            for e in eps:
                assert torch.equal(e[4:], -e[:4])
        seen.append(eps)
    assert len({shard_seed(0, g) for g in range(8)}) == 8


def test_launch_helpers_single_host(monkeypatch):
    """Alone, with no cluster environment, initialize() is a no-op and the
    global mesh is this process's shards (tests/test_sharded.py:129)."""
    import torch.distributed as dist

    for var in launch.CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    launch.initialize()
    assert not dist.is_initialized()
    mesh = launch.global_mesh(("k",), devices=["cpu"] * 8)
    assert mesh.shape["k"] == 8 and mesh.group is None
    mesh2 = launch.global_mesh(("dp", "tp"), (4, 2), devices=["cpu"] * 8)
    assert mesh2.shape["dp"] * mesh2.shape["tp"] == 8
    info = launch.process_info(mesh)
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] == len(jax.devices()) == 8
    assert info["local_devices"] == 8
    assert launch.process_info(mesh2)["global_devices"] == 8
    assert "global_devices" not in launch.process_info()
    with pytest.raises(ValueError):
        launch.global_mesh(("k",), (3,), devices=["cpu"] * 8)


def test_launch_entry_points_raise_without_a_gpu(monkeypatch):
    """The mesh and cluster entry points default to the card and raise
    without a GPU: CPU shards are asked for by name."""
    from mppi_tf_tpu_torch.parallel.cluster import run_cluster

    for var in launch.CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        launch.rank_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        launch.global_mesh()
    with pytest.raises(RuntimeError, match="no GPU"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no GPU"):
        run_cluster(nproc=1, devices_per_proc=1, timeout=10)
    assert launch.global_mesh(devices=["cpu"]).device.type == "cpu"


def test_launch_reraises_when_a_cluster_is_evident(monkeypatch):
    """With the cluster environment set, a failed join raises instead of
    running single-process (JAX launch.py:49-67)."""
    import torch.distributed as dist

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError):
        launch.initialize()
    assert not dist.is_initialized()
    assert launch.default_backend(1) == (
        "nccl" if torch.cuda.is_available() else "gloo")


def test_sharded_filter_seq_equals_single_device():
    """tests/test_sharded.py:149: Savitzky-Golay on the sharded path ==
    the JAX sharded path == the single-device controller."""
    model, cost, lam, ups = _setup()
    k, tau = 64, 12
    S = savgol_matrix(tau, 9, 3)
    eps, x0, useq = _inputs(k, tau, seed=7)
    a_j, u_j, _ = _jax_sharded(k, tau, filter_mat=S)(eps, x0, useq)
    _, swn = build_sharded_solve(model, cost, k, tau, lam, ups, SIGMA,
                                 _cpu_mesh(), filter_mat=S)
    a, u, _ = swn(_t(eps), _t(x0), _t(useq))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=RTOL,
                               atol=1e-14)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=RTOL,
                               atol=1e-14)
    ctrl = ShardedMPPI(model, cost, _cpu_mesh(), k=k, tau=tau, lam=lam,
                       upsilon=ups, sigma=SIGMA, filter_seq=True,
                       filter_window=9, filter_polyorder=3)
    a2, u2, _ = ctrl._solve_with_noise(_t(eps), _t(x0), _t(useq))
    assert torch.equal(a2, a) and torch.equal(u2, u)


def test_sharded_controller_filter_seq_closed_loop():
    model, cost, lam, ups = _setup()
    ctrl = ShardedMPPI(model, cost, _cpu_mesh(), k=64, tau=12, lam=lam,
                       upsilon=ups, sigma=SIGMA, filter_seq=True,
                       filter_window=9, filter_polyorder=3)
    assert np.isfinite(_closed_loop(ctrl, model, steps=10)).all()


def test_get_controller_mesh_dispatch():
    """tests/test_sharded.py:192: the factory returns the sharded
    controller on a mesh (CPU shards: the torch route), with the filter,
    antithetic and normalize options passed on."""
    model, cost, lam, ups = _setup()
    cfg = {"samples": 64, "horizon": 8, "lambda": lam, "upsilon": ups,
           "noise": SIGMA.tolist()}
    ctrl = get_controller(model, cost, cfg, mesh=_cpu_mesh())
    assert type(ctrl) is ShardedMPPI and ctrl.kernel_path == "torch"
    assert ctrl.next(np.zeros(6)).shape == (3,)
    cfg2 = dict(cfg, filter=True, antithetic=True, normalize=True,
                horizon=12)
    ctrl2 = get_controller(model, cost, cfg2, mesh=_cpu_mesh())
    assert type(ctrl2) is ShardedMPPI
    assert ctrl2._antithetic and ctrl2._normalize_cost and ctrl2._S is not None
    assert np.isfinite(ctrl2.next(np.zeros(6))).all()
    with pytest.raises(ValueError, match="fused kernel path only"):
        get_controller(model, cost, dict(cfg, **{"kernel-dtype":
                                                 "bfloat16"}),
                       mesh=_cpu_mesh())


def test_get_controller_mesh_forwards_options(tmp_path):
    """tests/test_sharded.py:216: observer, seed and init-act reach the
    sharded controller; an explicit kernel on an f64 model fails loudly."""
    from mppi_tf_tpu_torch.observer import Observer

    model, cost, lam, ups = _setup()
    cfg = {"samples": 64, "horizon": 8, "lambda": lam, "upsilon": ups,
           "noise": SIGMA.tolist(), "init-act": [0.5, 0.0, -0.5]}
    obs = Observer(log_path=str(tmp_path), use_tensorboard=False)
    ctrl = get_controller(model, cost, cfg, observer=obs, mesh=_cpu_mesh(),
                          seed=7)
    assert ctrl._base_seed == 7
    np.testing.assert_allclose(ctrl.useq.numpy(),
                               np.tile([0.5, 0.0, -0.5], (8, 1)))
    x = np.zeros(6)
    u = ctrl.next(x)
    ctrl.save(x, u, x)
    obs.close()
    text = open(os.path.join(obs.get_logdir(), "metrics.jsonl")).read()
    assert "Cost/cost_min" in text and "Predict/" in text
    with pytest.raises(TypeError, match="cuda"):
        get_controller(model, cost, dict(cfg, kernel="pallas",
                                         normalize=True), mesh=_cpu_mesh())


def test_sharded_save_load_resume_bit_exact(tmp_path):
    """tests/test_sharded.py:262: a resumed controller continues the
    uninterrupted run bit for bit (every shard's generator state)."""
    model, cost, lam, ups = _setup()

    def make(tau=8):
        return ShardedMPPI(model, cost, _cpu_mesh(), k=64, tau=tau, lam=lam,
                           upsilon=ups, sigma=SIGMA, seed=3)

    a = make()
    for _ in range(4):
        a.next(np.zeros(6))
    ckpt = str(tmp_path / "sharded.npz")
    a.save_state(ckpt)
    cont_a = [a.next(np.zeros(6)) for _ in range(3)]
    b = make()
    b.load_state(ckpt)
    cont_b = [b.next(np.zeros(6)) for _ in range(3)]
    np.testing.assert_array_equal(np.asarray(cont_a), np.asarray(cont_b))
    with pytest.raises(ValueError):
        make(tau=12).load_state(ckpt)


def test_trace_keeps_the_state_and_dump_names_the_ops():
    model, cost, lam, ups = _setup()
    init = np.tile([[0.2, -0.1, 0.3]], (8, 1))
    ctrl = ShardedMPPI(model, cost, _cpu_mesh(), k=64, tau=8, lam=lam,
                       upsilon=ups, sigma=SIGMA, init_seq=init)
    state = ctrl._rng_state()
    ctrl.trace()
    assert ctrl.timing["calls"] == 0 and ctrl._steps == 0
    np.testing.assert_allclose(ctrl.useq.numpy(), init)
    assert all(torch.equal(s, g.get_state())
               for s, g in zip(state, ctrl._gen))
    text = ctrl.dump_hlo()
    assert isinstance(text, str) and len(text) > 100


def test_one_rank_group_gives_the_local_bits(tmp_path):
    """A process group of one rank (gloo, a file store) runs the gathers
    through dist.all_reduce: the bits of the local mesh."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        grouped = launch.global_mesh(devices=["cpu"] * 8)
        assert grouped.group is not None and grouped.backend == "gloo"
        model, cost, lam, ups = _setup()
        eps, x0, useq = _inputs(64, 8)
        outs = []
        for mesh in (grouped, _cpu_mesh()):
            ctrl = ShardedMPPI(model, cost, mesh, k=64, tau=8, lam=lam,
                               upsilon=ups, sigma=SIGMA, normalize_cost=True)
            outs.append(ctrl._solve_with_noise(_t(eps), _t(x0), _t(useq)))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
    finally:
        dist.destroy_process_group()
