"""The on-device closed loop over the port's mesh-sharded controllers
(envs/mjx_env.py) and the fleet split over a mesh (controller/fleet.py
``FleetMPPI(mesh=)``), on local meshes of CPU shards, where every period
runs eagerly. Mirrors tests/test_envs.py:377-415 and 539-564 (the JAX
package's sharded on-device loops, their gates) and tests/test_fleet.py:
86-115 and 246-251 (the fleet mesh); the fleet is also held against the
JAX package's sharded fleet on the same normals. The captured graph of a
sharded period on the card is held by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.controller import FleetMPPI as JFleetMPPI
from mppi_tf_tpu.costs import get_cost as jget_cost
from mppi_tf_tpu.models import get_model as jget_model
from mppi_tf_tpu.parallel import make_mesh as jmake_mesh
from mppi_tf_tpu_torch.controller import (FleetMPPI, ShardedDMDMPPI,
                                          ShardedFusedDMDMPPI)
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.envs import DevicePointMassEnv
from mppi_tf_tpu_torch.envs.mjx_env import (build_on_device_loop,
                                            on_device_closed_loop)
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.dmd import DMDModel
from mppi_tf_tpu_torch.parallel import ShardedMPPI, launch, make_mesh
from mppi_tf_tpu_torch.parallel.fused import ShardedFusedMPPI

F64 = torch.float64
SIGMA = np.diag([0.4, 0.4])
LAM, GAMMA = 0.6, 0.2
GOAL = [1.0, 0.0, -0.5, 0.0]
STATIC = {"type": "static", "diag": True, "goal": GOAL,
          "Q": [8.0, 1.5, 8.0, 1.5]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _mesh(n=8, axes=("k",)):
    return make_mesh(devices=["cpu"] * n, axis_names=axes)


def _modules(dtype=torch.float32, mass=1.0):
    model = get_model({"type": "point_mass", "mass": mass}, dt=0.1,
                      state_dim=4, action_dim=2, dtype=dtype)
    cost = get_cost(STATIC, lam=LAM, gamma=GAMMA, upsilon=1.0, sigma=SIGMA,
                    dtype=dtype)
    return model, cost


def _err(states) -> float:
    return float(np.linalg.norm(np.asarray(states)[-1, 0::2]
                                - np.array([1.0, -0.5])))


@pytest.mark.parametrize("cls", [ShardedMPPI, ShardedFusedMPPI])
def test_on_device_loop_with_sharded_controllers(cls):
    """tests/test_envs.py:377: the sharded solves (torch route and fused
    shards) run inside the on-device period; the closed loop converges
    over 8 shards. (The JAX fused case only checks finiteness: its
    interpret-mode noise is stubbed; the port's plain Philox is the
    kernels' stream.)"""
    model, cost = _modules(F64 if cls is ShardedMPPI else torch.float32)
    ctrl = cls(model, cost, _mesh(), k=256, tau=15, lam=LAM, upsilon=1.0,
               sigma=SIGMA, seed=2)
    env = DevicePointMassEnv(n_dof=2, dt=0.01, dtype=model.dtype)
    states, actions = on_device_closed_loop(ctrl, env.step_fn, np.zeros(4),
                                            steps=50, substeps=10)
    assert states.shape == (50, 4) and actions.shape == (50, 2)
    assert _err(states) < 0.25, _err(states)
    assert ctrl._steps == 50


def test_sharded_fused_loop_is_the_host_loop():
    """The loop's periods (device solve index s, shard g drawing solve
    s n + g) are the host-driven steps' bits: MPPI.next and the same plant
    substeps."""
    model, cost = _modules()
    env = DevicePointMassEnv(n_dof=2, dt=0.01)
    mk = dict(k=128, tau=10, lam=LAM, upsilon=1.0, sigma=SIGMA, seed=4,
              normalize_cost=True)
    loop_ctrl = ShardedFusedMPPI(model, cost, _mesh(4), **mk)
    states, actions = build_on_device_loop(loop_ctrl, env.step_fn, steps=6,
                                           substeps=5)(np.zeros(4))
    host = ShardedFusedMPPI(model, cost, _mesh(4), **mk)
    x = torch.zeros(4)
    for j in range(6):
        u = torch.as_tensor(host.next(x.numpy()))
        for _ in range(5):
            x = env.step_fn(x, u)
        assert torch.equal(actions[j], u) and torch.equal(states[j], x), j


@pytest.mark.parametrize("cls", [ShardedDMDMPPI, ShardedFusedDMDMPPI])
def test_sharded_adaptive_dmd_on_device(cls):
    """tests/test_envs.py:539: the adaptive window and refits inside the
    sharded loop: (A, B) identified from a mass-1 prior against the
    mass-3 plant, and the goal reached."""
    dtype = F64 if cls is ShardedDMDMPPI else torch.float32
    _, cost = _modules(dtype)
    prior, _ = _modules(F64)
    truth, _ = _modules(F64, mass=3.0)
    dmd = DMDModel(4, 2, reg=1e-11, dtype=dtype, init_A=prior.A.numpy(),
                   init_B=prior.B.numpy())
    ctrl = cls(dmd, cost, _mesh(), k=256, tau=15, lam=LAM, upsilon=1.0,
               sigma=SIGMA, seed=2, refit_every=5)
    env = DevicePointMassEnv(n_dof=2, mass=3.0, dt=0.01, dtype=dtype)
    states, _, fitted = on_device_closed_loop(ctrl, env.step_fn, np.zeros(4),
                                              steps=60, substeps=10)
    atol = 1e-5 if dtype == F64 else 1e-4
    np.testing.assert_allclose(fitted["A"].double().numpy(),
                               truth.A.numpy(), atol=atol)
    np.testing.assert_allclose(fitted["B"].double().numpy(),
                               truth.B.numpy() / 3.0, atol=atol)
    assert _err(states) < 0.25, _err(states)


def test_gloo_mesh_refuses_the_graph(tmp_path):
    """A mesh over a gloo group reduces on the host: the captured run
    raises ValueError and says so; eager periods run."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        model, cost = _modules()
        ctrl = ShardedFusedMPPI(model, cost, launch.global_mesh(
            devices=["cpu"] * 2), k=64, tau=5, lam=LAM, upsilon=1.0,
            sigma=SIGMA)
        run = build_on_device_loop(ctrl, DevicePointMassEnv(
            n_dof=2, dt=0.01).step_fn, steps=3, substeps=2)
        with pytest.raises(ValueError, match="gloo"):
            run._check_capturable()
        states, _ = run.eager(np.zeros(4))
        assert torch.all(torch.isfinite(states))
    finally:
        dist.destroy_process_group()


def _fleet_goals(n=8):
    goals = np.tile(np.array([GOAL]), (n, 1))
    goals[:, 0] = np.linspace(-1, 1, n)
    return goals


def test_fleet_sharded_matches_unsharded():
    """tests/test_fleet.py:86: mesh= splits the fleet axis (no collective);
    the results are the unsharded fleet's bits with the same seeds. n must
    divide by the mesh; an explicit kernel raises ("auto" is the torch
    route)."""
    model, cost = _modules(F64)
    n, k, tau = 8, 64, 5
    kw = dict(k=k, tau=tau, lam=LAM, upsilon=1.0, sigma=SIGMA,
              goals=_fleet_goals(), seed=9)
    ref = FleetMPPI(model, cost, n_vehicles=n, device="cpu", **kw)
    sh = FleetMPPI(model, cost, n_vehicles=n, mesh=_mesh(8, ("fleet",)),
                   **kw)
    assert sh.kernel_path == "torch"
    states = np.random.default_rng(1).normal(size=(n, 4))
    for _ in range(2):
        np.testing.assert_array_equal(sh.next(states), ref.next(states))
    with pytest.raises(ValueError, match="divisible"):
        FleetMPPI(model, cost, n_vehicles=6, k=k, tau=tau, lam=LAM,
                  upsilon=1.0, sigma=SIGMA, mesh=_mesh(8, ("fleet",)))
    for kernel in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="pallas"):
            FleetMPPI(model, cost, n_vehicles=8, k=k, tau=tau, lam=LAM,
                      upsilon=1.0, sigma=SIGMA, mesh=_mesh(8, ("fleet",)),
                      kernel=kernel)


def test_fleet_sharded_matches_jax_sharded_fleet():
    """The fleet over 4 shards against the JAX package's fleet over its 4
    devices, on the same per-vehicle normals (f64)."""
    model, cost = _modules(F64)
    jmodel = jget_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                        state_dim=4, action_dim=2, dtype=jnp.float64)
    jcost = jget_cost(STATIC, lam=LAM, gamma=GAMMA, upsilon=1.0,
                      sigma=SIGMA, dtype=jnp.float64)
    n, k, tau = 4, 64, 5
    goals = _fleet_goals(n)
    jf = JFleetMPPI(jmodel, jcost, n_vehicles=n, k=k, tau=tau, lam=LAM,
                    upsilon=1.0, sigma=SIGMA, goals=goals,
                    mesh=jmake_mesh(4, ("fleet",)))
    fleet = FleetMPPI(model, cost, n_vehicles=n, k=k, tau=tau, lam=LAM,
                      upsilon=1.0, sigma=SIGMA, goals=goals,
                      mesh=_mesh(4, ("fleet",)))
    rng = np.random.default_rng(3)
    z = rng.normal(size=(n, k, tau, 2))
    # the same normals on both sides: the port's generators and JAX's keys
    # replaced by the table
    scale = torch.as_tensor(SIGMA)
    eps = torch.as_tensor(z) @ scale.T
    tpl = fleet._tpl
    draws = iter(eps)
    tpl._solve = (lambda s, u, sc, f=tpl._solve_with_noise:
                  f(next(draws), s, u, sc))
    states = rng.normal(size=(n, 4))
    got = fleet.next(states)
    sol = jax.vmap(jf._tpl._solve_with_noise_jit, in_axes=(0, 0, 0, None, 0))
    a, _, _ = sol(jnp.asarray(eps.numpy()), jnp.asarray(states),
                  jf._useq, jf._mparams, jf._cparams)
    np.testing.assert_allclose(got, np.asarray(a), rtol=1e-10, atol=1e-12)


def test_sharded_fleet_on_device_loop():
    """tests/test_fleet.py:246: the fleet's on-device loop over a mesh of
    8 shards (eager periods on the torch route): the unsharded loop's
    bits, finite, [steps, n, aDim] actions."""
    model, cost = _modules(F64)
    env = DevicePointMassEnv(n_dof=2, dt=0.01, dtype=F64)
    kw = dict(n_vehicles=8, k=64, tau=8, lam=LAM, upsilon=1.0, sigma=SIGMA,
              seed=3)
    sh = FleetMPPI(model, cost, mesh=_mesh(8, ("fleet",)), **kw)
    ref = FleetMPPI(model, cost, device="cpu", **kw)
    s_sh, a_sh = sh.build_on_device_loop(env.step_fn, steps=5,
                                         substeps=2)(np.zeros((8, 4)))
    s_ref, a_ref = ref.build_on_device_loop(env.step_fn, steps=5,
                                            substeps=2)(np.zeros((8, 4)))
    assert a_sh.shape == (5, 8, 2) and torch.all(torch.isfinite(s_sh))
    assert torch.equal(s_sh, s_ref) and torch.equal(a_sh, a_ref)
