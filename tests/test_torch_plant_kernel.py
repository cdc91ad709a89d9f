"""The on-device plants' steps (``kernels/plant.py``, ``csrc/plant.cu``)
and the loops that call them once a period.

On the CPU: ``step_fn(x, u, substeps=n)`` of both plants is n calls of
``step_fn(x, u)`` bit for bit; a loop calls a plant that declares
``substeps`` once a period and any other ``substeps`` times, with the same
states; the AUV's packed constants are the model's.

On the card (marker ``cuda``; skipped without one): the AUV kernel against
the torch step (f32 within 1e-6 relative to 1 + |x|, f64 within 1e-12:
its sums run in another order than cuBLAS's), the point-mass kernel bit
for bit, and a captured period of the rexrov2 mission and of the
point-mass loop at full width holding one plant node. Everything is built
from the port's own API. This file imports neither JAX nor the JAX package:
python -m pytest --noconftest -m cuda tests/test_torch_plant_kernel.py
"""

import numpy as np
import pytest
import torch

from mppi_tf_tpu_torch import flagship, tracing
from mppi_tf_tpu_torch.controller import MPPI
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.envs import (AUVEnv, DevicePointMassEnv,
                                    build_on_device_loop)
from mppi_tf_tpu_torch.kernels import plant
from mppi_tf_tpu_torch.models import get_model

SEED = 2 ** 31 + 4_321
#: the point-mass loop: the 3-DoF point mass, its static task, its plant
#: at 10 substeps of 0.01 s a control period of 0.1 s
PM_GOAL = [1.0, 0.0, 0.5, 0.0, -0.5, 0.0]
PM_Q = [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]
#: the rexrov2 mission: the normalised dive's forces and weights, two legs
#: at z = -1 and -2 (radius 0.5), its plant at 5 substeps of 0.02 s
AUV_SIGMA = np.diag([2000.0] * 3 + [200.0] * 3)
AUV_Q = [60.0, 60.0, 60.0, 10.0] + [1.0] * 6
MISSION_RADIUS = 0.5


def _rest(z=0.0):
    """The AUV at rest at depth z, unit quaternion qw = 1."""
    x = np.zeros(13)
    x[2], x[6] = z, 1.0
    return x


MISSION = [_rest(-1.0).tolist(), _rest(-2.0).tolist()]


def _auv_env(rk=2, dense=False, dt=0.02):
    """The rexrov2 plant at ``rk``; ``dense`` adds a cog and forward-speed
    damping, so that every term of the state derivative is nonzero."""
    cfg = dict(flagship.auv_params(), rk=rk)
    if dense:
        cfg.update(cog=[0.01, -0.02, 0.03],
                   linear_damping_forward_speed=[-1.0, -2.0, -3.0, -4.0,
                                                 -5.0, -6.0])
    return AUVEnv(cfg, dt=dt)


def _auv_inputs(n, seed, dtype=torch.float64, device="cpu"):
    """n states and forces in the dive's range: positions within 3 m,
    unit quaternions, velocities up to 1 m/s and 0.5 rad/s, forces of
    σ = 2000 N and moments of 200 N m."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = np.concatenate([rng.uniform(-3, 3, (n, 3)), q,
                        rng.uniform(-1, 1, (n, 3)),
                        rng.uniform(-0.5, 0.5, (n, 3))], axis=1)
    u = np.concatenate([rng.normal(0, 2000, (n, 3)),
                        rng.normal(0, 200, (n, 3))], axis=1)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(u, dtype=dtype, device=device))


def _pm_inputs(shape, seed, dtype=torch.float64, device="cpu", n_dof=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, 2 * n_dof))
    u = rng.standard_normal((*shape, n_dof))
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(u, dtype=dtype, device=device))


def _repeated(step_fn, x, u, n):
    for _ in range(n):
        x = step_fn(x, u)
    return x


# ---- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("vehicles", [None, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["auv", "point_mass"])
def test_substeps_are_repeated_steps(kind, dtype, vehicles):
    """``step_fn(x, u, substeps=n)`` == n calls of ``step_fn(x, u)``, bit
    for bit, for one vehicle ([sdim]) and a fleet ([n, sdim])."""
    n = 7
    if kind == "auv":
        env = _auv_env(rk=4)
        x, u = _auv_inputs(vehicles or 1, 1, dtype)
    else:
        env = DevicePointMassEnv(n_dof=3, mass=1.3, dt=0.01)
        x, u = _pm_inputs((vehicles or 1,), 1, dtype)
    if vehicles is None:
        x, u = x[0], u[0]
    got = env.step_fn(x, u, substeps=n)
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(got, _repeated(env.step_fn, x, u, n))
    assert torch.equal(env.step_fn(x, u, substeps=1), env.step_fn(x, u))


@pytest.mark.parametrize("kind", ["auv", "point_mass"])
def test_fewer_than_one_substep_raises(kind):
    env = (_auv_env() if kind == "auv"
           else DevicePointMassEnv(n_dof=3, dt=0.01))
    x, u = (_auv_inputs(1, 2) if kind == "auv" else _pm_inputs((1,), 2))
    with pytest.raises(ValueError, match="substeps"):
        env.step_fn(x, u, substeps=0)


def _plant_and_inputs(kind, n, dtype, device):
    if kind == "auv":
        return (_auv_env(rk=2),) + _auv_inputs(n, 7, dtype, device)
    return (DevicePointMassEnv(n_dof=3, mass=1.3, dt=0.01),) + _pm_inputs(
        (n,), 7, dtype, device)


@pytest.mark.parametrize("kind", ["auv", "point_mass"])
def test_an_action_in_another_dtype_raises(kind):
    """The point mass takes the action in the state's dtype on the CPU as
    on the card (the AUV casts it to the state's dtype before its step)."""
    env, x, u = _plant_and_inputs(kind, 2, torch.float32, "cpu")
    if kind == "auv":
        assert torch.equal(env.step_fn(x, u.double(), substeps=2),
                           env.step_fn(x, u, substeps=2))
        model, _ = env._model_on("cpu", torch.float32)
        with pytest.raises(TypeError, match="dtype"):
            plant.auv_step_plain(model, x, u.double(), 2)
    else:
        with pytest.raises(TypeError, match="dtype"):
            env.step_fn(x, u.double(), substeps=2)


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("kind", ["auv", "point_mass"])
def test_a_held_action_broadcasts_over_a_fleet(kind, device):
    """One action held by a fleet of 5 steps each vehicle as the action
    repeated a row a vehicle does, bit for bit, on the CPU and on the card
    (where the kernel is launched once either way)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env, x, u = _plant_and_inputs(kind, 5, torch.float32, device)
    shared = u[2]
    before = dict(plant.launch_counts)
    got = env.step_fn(x, shared, substeps=3)
    want = env.step_fn(x, shared.expand(5, -1).contiguous(), substeps=3)
    assert got.shape == x.shape and torch.equal(got, want)
    if device == "cuda":
        entry = "auv_plant" if kind == "auv" else "pm_plant"
        assert plant.launch_counts[entry] == before[entry] + 2


def test_auv_constants_are_the_models():
    """The packed buffer holds, at ``AUV_CONSTS``' offsets, the tensors the
    torch step reads, and the weight and buoyancy as ``restoring_forces``
    computes them."""
    env = _auv_env(dense=True)
    model, consts = env._model_on("cpu", torch.float32)
    assert consts is None    # packed for the card alone
    c = plant.auv_constants(model)
    assert c.dtype == torch.float32 and c.numel() == plant.AUV_CONSTS_SIZE
    m_tot, inv_m = model.precompute()
    at = plant.AUV_CONSTS
    for name, t in (("m_tot", m_tot), ("inv_m", inv_m),
                    ("lin_damp", model.lin_damp),
                    ("lin_damp_fwd", model.lin_damp_fwd),
                    ("quad_damp", model.quad_damp), ("cog", model.cog),
                    ("cob", model.cob)):
        assert torch.equal(c[at[name]:at[name] + t.numel()], t.reshape(-1))
    weight, buoyancy = c[at["weight"]], c[at["buoyancy"]]
    assert torch.equal(weight, -model.mass * 9.81)
    assert buoyancy.item() == float(np.float32(model.buoyancy))
    # upright, the restoring force's z entry is -(weight + buoyancy)
    g = model.restoring_forces(torch.eye(3)[None])[0]
    assert torch.equal(-g[2], weight + buoyancy)


def _pm_controller(k=64, tau=5, sigma=(0.25, 0.3, 0.2), device="cpu"):
    """The point mass's controller: at its defaults a small one on the CPU,
    on the card the kernels' fused solve."""
    model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                      state_dim=6, action_dim=3, device=device)
    sigma = np.diag(sigma)
    cost = get_cost({"type": "static", "diag": True, "goal": PM_GOAL,
                     "Q": PM_Q}, lam=0.8, gamma=0.2, upsilon=1.0,
                    sigma=sigma, device=device)
    return MPPI(model, cost, k=k, tau=tau, lam=0.8, upsilon=1.0, sigma=sigma,
                seed=3, kernel="cuda" if device == "cuda" else "torch",
                device=device)


def _auv_mission(k=64, tau=3, device="cpu"):
    """The rexrov2 mission's controller (its legs set) and plant."""
    model = get_model(flagship.auv_params(), dt=0.1, state_dim=13,
                      action_dim=6, device=device)
    cost = get_cost({"type": "waypoints_quat", "diag": True, "Q": AUV_Q,
                     "waypoints": MISSION, "alpha": 0.2}, lam=0.5,
                    gamma=0.2, upsilon=1.0, sigma=AUV_SIGMA, device=device)
    ctrl = MPPI(model, cost, k=k, tau=tau, lam=0.5, upsilon=1.0,
                sigma=AUV_SIGMA, normalize_cost=True, seed=SEED,
                kernel="cuda" if device == "cuda" else "torch",
                device=device)
    ctrl.set_waypoints(MISSION)
    return ctrl, AUVEnv(flagship.auv_params(), dt=0.02)


def _counting(step_fn):
    """``step_fn`` behind a plant without a ``substeps`` parameter that
    counts its calls."""
    calls = []

    def plant_step(x, u):
        calls.append(1)
        return step_fn(x, u)

    return plant_step, calls


@pytest.mark.parametrize("kind", ["point_mass", "auv_mission", "fleet"])
def test_a_fused_plant_loop_equals_the_per_substep_loop(kind):
    """A loop over ``step_fn`` (called once a period, ``plant_calls`` 1)
    and the same loop over a plant without ``substeps`` (called
    ``substeps`` times a period) give the same states and actions, bit for
    bit, and the same final queue on a mission."""
    steps, substeps = 6, 4
    runs = []
    for fused in (True, False):
        if kind == "auv_mission":
            ctrl, env = _auv_mission()
            x0, radius = _rest(), 5.0    # a pop within these periods
        else:
            ctrl, radius = _pm_controller(), None
            env = DevicePointMassEnv(n_dof=3, mass=1.3, dt=0.01)
            x0 = [0.7, 0.0, 0.0, 0.1, 0.0, 0.0]
        step, calls = ((env.step_fn, None) if fused
                       else _counting(env.step_fn))
        if kind == "fleet":
            from mppi_tf_tpu_torch.controller import FleetMPPI

            fleet = FleetMPPI(ctrl._model, ctrl._cost, 3, k=64, tau=5,
                              lam=0.8, upsilon=1.0,
                              sigma=np.diag([0.25, 0.3, 0.2]), seed=3,
                              device="cpu")
            loop = fleet.build_on_device_loop(step, steps, substeps)
            out = loop(np.tile(x0, (3, 1)), generators=[
                torch.Generator().manual_seed(v) for v in range(3)])
        else:
            loop = build_on_device_loop(ctrl, step, steps, substeps,
                                        waypoint_radius=radius)
            out = loop(x0, generator=torch.Generator().manual_seed(5))
        assert loop.plant_calls == (1 if fused else substeps)
        if not fused:
            assert len(calls) == steps * substeps
        queue = (ctrl.waypoints_remaining(),) if kind == "auv_mission" \
            else ()
        runs.append((*out, *queue))
    fused, per_substep = runs
    assert torch.equal(fused[0], per_substep[0])
    assert torch.equal(fused[1], per_substep[1])
    assert fused[2:] == per_substep[2:]
    if kind == "auv_mission":
        assert fused[2] < 2   # a leg popped


def test_a_loop_steps_a_plant_without_substeps_substeps_times():
    """A lambda plant, and a ``step_fn`` patched to ``(self, x, u)`` as the
    benchmark's fault test patches it, are called ``substeps`` times a
    period (``plant_calls``); one substep is one call either way."""
    env = DevicePointMassEnv(n_dof=3, dt=0.01)
    calls = []

    class Patched(DevicePointMassEnv):
        def step_fn(self, x, u):
            calls.append(1)
            return DevicePointMassEnv.step_fn(self, x, u) * (1.0 + 1e-3)

    for step_fn in (lambda x, u: calls.append(1) or env.step_fn(x, u),
                    Patched(n_dof=3, dt=0.01).step_fn):
        calls.clear()
        loop = build_on_device_loop(_pm_controller(), step_fn, 3, 4)
        assert loop.plant_calls == 4
        loop.eager(np.zeros(6))
        assert len(calls) == 3 * 4
    for substeps in (1, 4):
        loop = build_on_device_loop(_pm_controller(), env.step_fn, 3,
                                    substeps)
        assert loop.plant_calls == 1
    got = tracing.counters(loop)
    assert got["loops"][0]["plant_calls"] == 1
    assert set(got["plant_counts"]) == {"launch_counts", "captured_counts"}
    assert set(got["plant_counts"]["launch_counts"]) == set(plant.ENTRIES)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_library_exports_the_plant_kernels(cuda_device):
    from mppi_tf_tpu_torch.kernels import _build

    lib = _build.load_library()
    assert all(hasattr(lib, name) for name in plant.ENTRIES)
    names = " ".join(r["kernel"] for r in _build.ptxas_report())
    assert "auv_plant_kernel" in names and "pm_plant_kernel" in names


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 5])
@pytest.mark.parametrize("vehicles", [1, 16])
@pytest.mark.parametrize("rk", [1, 2, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
def test_auv_kernel_matches_the_torch_step(cuda_device, dtype, tol, rk,
                                           vehicles, substeps):
    """One launch of ``auv_plant_kernel`` against ``substeps`` torch steps
    of the same model on the card, relative to 1 + |x|; one launch, counted
    in ``plant_counts``."""
    env = _auv_env(rk=rk, dense=rk == 4)
    x, u = _auv_inputs(vehicles, rk * 100 + vehicles, dtype, cuda_device)
    model, _ = env._model_on(x.device, dtype)
    before = dict(plant.launch_counts)
    got = env.step_fn(x, u, substeps=substeps)
    assert plant.launch_counts["auv_plant"] == before["auv_plant"] + 1
    want = plant.auv_step_plain(model, x, u, substeps)
    gap = ((got - want).abs() / (1.0 + want.abs())).max().item()
    assert gap <= tol, gap
    assert torch.equal(got[0], env.step_fn(x[0], u[0], substeps=substeps))


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [1, 10])
@pytest.mark.parametrize("vehicles", [1, 16])
@pytest.mark.parametrize("mass", [1.0, 1.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pm_kernel_is_the_torch_step(cuda_device, dtype, mass, vehicles,
                                     substeps):
    """One launch of ``pm_plant_kernel`` == ``substeps`` torch steps on the
    card, bit for bit (at mass 1.3 the reciprocal is inexact)."""
    env = DevicePointMassEnv(n_dof=3, mass=mass, dt=0.01)
    x, u = _pm_inputs((vehicles,), vehicles + substeps, dtype, cuda_device)
    before = dict(plant.launch_counts)
    got = env.step_fn(x, u, substeps=substeps)
    assert plant.launch_counts["pm_plant"] == before["pm_plant"] + 1
    want = plant.pm_step_plain(x, u, 3, mass, 0.01, substeps)
    assert torch.equal(got, want)
    assert torch.equal(env.step_fn(x[0], u[0], substeps=substeps), want[0])


@pytest.mark.cuda
def test_the_kernels_take_f32_and_f64_alone(cuda_device):
    env = DevicePointMassEnv(n_dof=3, dt=0.01)
    x, u = _pm_inputs((2,), 0, torch.float16, cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        env.step_fn(x, u, substeps=2)
    x, u = _pm_inputs((2,), 0, torch.float32, cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        env.step_fn(x, u.double(), substeps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,entry,most", [
    ("rexrov2_mission", "auv_plant", 100),
    ("point_mass_loop", "pm_plant", 32)])
def test_a_captured_period_holds_one_plant_node(cuda_device, cell, entry,
                                                most):
    """The rexrov2 mission (K=65,536, H=15, 5 substeps) and the point-mass
    loop (K=100,000, H=50, 10 substeps) capture their plant's substeps as
    one kernel node (``plant_nodes``, ``plant_counts``), ``plant_calls`` 1,
    and at most ``most`` kernel nodes a period."""
    if cell == "rexrov2_mission":
        ctrl, env = _auv_mission(65_536, 15, "cuda")
        x0, substeps, radius = _rest(), 5, MISSION_RADIUS
    else:
        ctrl = _pm_controller(100_000, 50, (0.25, 0.25, 0.25), "cuda")
        env = DevicePointMassEnv(n_dof=3, mass=1.0, dt=0.01)
        x0, substeps, radius = np.zeros(6), 10, None
    loop = build_on_device_loop(ctrl, env.step_fn, 3, substeps,
                                waypoint_radius=radius)
    before = tracing.counters()["plant_counts"]
    states, _ = loop(x0, step0=0)
    after = tracing.counters(loop)
    assert loop.plant_calls == 1 and after["loops"][0]["plant_calls"] == 1
    assert loop.plant_nodes == {entry: 1}
    pc = after["plant_counts"]
    assert (pc["captured_counts"][entry]
            == before["captured_counts"][entry] + 1)
    # the eager warm-up period and the three replays
    assert pc["launch_counts"][entry] == before["launch_counts"][entry] + 4
    assert loop.graph_nodes["kernel"] <= most, loop.graph_nodes
    assert torch.isfinite(states).all()
