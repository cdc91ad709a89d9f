"""``FleetMPPI.next`` as one captured CUDA graph (controller/fleet.py
``_StepGraph``) and the freeze key it shares with the on-device loop
(controller/graph.py ``freeze_key``).

On the CPU: the key changes under each mutation that makes a graph
capture again (a new schedule, a model or cost tensor rebound, a write of
the AUV's mass, a new solve object) and under no live write (goals,
waypoints, the point mass's, the NN's and the LTI model's parameters
written in place); the CPU's kernel route, the torch route and a mesh
fleet step eagerly; ``fleet_steps`` is among ``tracing.counters()``.

On the card (marker ``cuda``; skipped without one): graphed ``next``
against ``next_eager`` bit for bit over 7 steps with a re-goal between
them, for the point mass (f32 and bf16, normalised and not), rexrov2
(normalised, ``static_quat``), the NN AUV (normalised) and an LTI fleet;
one capture again after a write of the AUV's mass, ``set_noise_schedule``
and ``load_state``; an on-device fleet loop between steps; the sequences
handed out; the launch counts of the replays. This file imports neither
JAX nor the JAX package:
python -m pytest --noconftest -m cuda tests/test_torch_fleet_graph.py
"""

import numpy as np
import pytest
import torch

from mppi_tf_tpu_torch import flagship, tracing
from mppi_tf_tpu_torch.controller import FleetMPPI
from mppi_tf_tpu_torch.controller import fleet as fleet_mod
from mppi_tf_tpu_torch.controller.graph import freeze_key
from mppi_tf_tpu_torch.costs import get_cost
from mppi_tf_tpu_torch.envs import DevicePointMassEnv
from mppi_tf_tpu_torch.kernels import _launch
from mppi_tf_tpu_torch.models import get_model
from mppi_tf_tpu_torch.models.dmd import DMDModel

N, TAU = 4, 10
PM_SIGMA = 0.25 * np.eye(3)
AUV_SIGMA = np.diag([2000.0] * 3 + [200.0] * 3)
PM_TASK = {"type": "static", "diag": True, "goal": [1.0, 0.0, 0.5, 0.0,
                                                    -0.5, 0.0],
           "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}
PM_WAYPOINTS = {"type": "waypoints", "diag": True, "alpha": 0.2,
                "waypoints": [[0.5, 0.0, 0.0, 0.0, 0.0, 0.0],
                              [1.0, 0.0, 0.5, 0.0, 0.0, 0.0]],
                "Q": [5.0, 1.0, 5.0, 1.0, 5.0, 1.0]}
NN_NORM = {"x_mean": np.linspace(-0.2, 0.3, 16),
           "x_std": np.linspace(0.5, 2.0, 16),
           "y_mean": np.linspace(-1e-3, 1e-3, 13),
           "y_std": np.linspace(0.01, 0.05, 13)}
NN_NORM["x_mean"][10:] = 30.0
NN_NORM["x_std"][10:] = [2000.0] * 3 + [200.0] * 3
SCHEDULE = {"type": "exp", "start": 1.0, "end": 0.25}
SEED = 2 ** 31 + 4_321


def _family(kind: str, device):
    """(model, cost, sigma, lam, sdim) of a fleet of ``kind``."""
    if kind in ("pm", "pm_waypoints", "lti"):
        if kind == "lti":   # a double integrator per axis, dt 0.1
            a = np.eye(6)
            a[0::2, 1::2] += 0.1 * np.eye(3)
            b = np.zeros((6, 3))
            b[1::2] = 0.1 * np.eye(3)
            model = DMDModel(6, 3, init_A=a, init_B=b, device=device)
        else:
            model = get_model({"type": "point_mass", "mass": 1.0}, dt=0.1,
                              state_dim=6, action_dim=3, device=device)
        task = PM_WAYPOINTS if kind == "pm_waypoints" else PM_TASK
        return (model, get_cost(task, lam=0.8, gamma=0.2, upsilon=1.0,
                                sigma=PM_SIGMA, device=device),
                PM_SIGMA, 0.8, 6)
    if kind == "rexrov2":
        model = get_model(flagship.auv_params(), dt=0.1, action_dim=6,
                          device=device)
    else:
        model = get_model({"type": "auv_nn", "hidden": [32, 32, 32],
                           "seed": 3, "normalisers": NN_NORM}, dt=0.1,
                          state_dim=13, action_dim=6, device=device)
    cost = get_cost(flagship.auv_task(), lam=0.5, gamma=0.2, upsilon=1.0,
                    sigma=AUV_SIGMA, device=device)
    return model, cost, AUV_SIGMA, 0.5, 13


def _goals(kind: str, sdim: int) -> np.ndarray:
    rng = np.random.default_rng(5)
    if sdim == 6:
        goals = np.zeros((N, 6))
        goals[:, 0::2] = rng.uniform(-1.0, 1.0, (N, 3))
        return goals
    goals = np.tile(np.asarray(flagship.auv_task()["goal"]), (N, 1))
    goals[:, 2] = rng.uniform(-2.0, 0.0, N)
    return goals


def _fleet(kind: str, device, k: int = 256, kernel_dtype="float32",
           schedule=None, **options) -> FleetMPPI:
    """A fleet of N vehicles of ``kind`` on the kernel route: the kernels
    on the card, their plain versions on the CPU."""
    model, cost, sigma, lam, sdim = _family(kind, device)
    cpu = torch.device(device).type == "cpu"
    fleet = FleetMPPI(model, cost, N, k=k, tau=TAU, lam=lam, upsilon=1.0,
                      sigma=sigma, seed=SEED,
                      goals=None if kind == "pm_waypoints"
                      else _goals(kind, sdim),
                      noise_schedule=schedule,
                      kernel="torch" if cpu else "cuda",
                      kernel_dtype="float32" if cpu else kernel_dtype,
                      device=device, **options)
    if cpu:
        tpl = fleet._tpl
        tpl._kernel_dtype = kernel_dtype
        tpl._resolve_kernel("auto", sigma, None if tpl._sched is None
                            else tpl._sched.cpu().numpy())
    assert (fleet._tpl.kernel_path == "cuda"
            and fleet._tpl._fused is not None)
    return fleet


def _states(sdim: int, step: int = 0) -> np.ndarray:
    rng = np.random.default_rng([11, step])
    if sdim == 6:
        return 0.3 * rng.standard_normal((N, 6))
    x = np.zeros((N, 13))
    x[:, 6] = 1.0
    x[:, :3] = 0.3 * rng.standard_normal((N, 3))
    x[:, 7:] = 0.1 * rng.standard_normal((N, 6))
    return x


def _key(fleet) -> tuple:
    return freeze_key(fleet._tpl, fleet.cost_params.values())


# ---- on the CPU ----

def _new_schedule(fleet):
    fleet._tpl.set_noise_schedule({"type": "exp", "start": 1.0,
                                   "end": 0.5})


def _rebind_mass(fleet):
    fleet._model.mass = torch.nn.Parameter(fleet._model.mass.detach() * 2)


def _write_auv_mass(fleet):
    params = fleet.model_params
    params["mass"] = params["mass"] * 1.01
    fleet.model_params = params


def _rebind_goals(fleet):
    fleet.cost_params["goal"] = fleet.cost_params["goal"].clone()


def _new_solve_object(fleet):
    tpl = fleet._tpl
    tpl._resolve_kernel("auto", tpl._sigma.cpu().numpy(), None)


RECAPTURING = {
    "set_noise_schedule": ("pm", {"schedule": SCHEDULE}, _new_schedule),
    "model_tensor_rebound": ("pm", {}, _rebind_mass),
    "auv_mass_written": ("rexrov2", {}, _write_auv_mass),
    "cost_tensor_rebound": ("pm", {}, _rebind_goals),
    "new_solve_object": ("pm", {}, _new_solve_object),
}


@pytest.mark.parametrize("mutation", sorted(RECAPTURING))
def test_freeze_key_changes_under_a_recapturing_mutation(mutation):
    kind, options, mutate = RECAPTURING[mutation]
    fleet = _fleet(kind, "cpu", **options)
    fleet.next(_states(fleet._sdim))
    before = _key(fleet)
    assert _key(fleet) == before
    mutate(fleet)
    assert _key(fleet) != before


def _scaled_params(fleet):
    params = fleet.model_params

    def scale(p):
        if isinstance(p, dict):
            return {n: scale(v) for n, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [scale(v) for v in p]
        return p * 1.01

    fleet.model_params = scale(params)


def _retask(fleet):
    fleet.set_goals(_goals("pm", 6)[::-1].copy())


def _retask_one(fleet):
    fleet.set_vehicle_goal(2, [0.3, 0.0, -0.2, 0.0, 0.1, 0.0])


def _mission(fleet):
    fleet.set_vehicle_waypoints(1, PM_WAYPOINTS["waypoints"][::-1])
    fleet.advance_waypoints(np.zeros((N, 6)), radius=10.0)


LIVE = {
    "set_goals": ("pm", _retask),
    "set_vehicle_goal": ("pm", _retask_one),
    "waypoints": ("pm_waypoints", _mission),
    "point_mass_params": ("pm", _scaled_params),
    "nn_params": ("nn_auv", _scaled_params),
    "lti_params": ("lti", _scaled_params),
}


@pytest.mark.parametrize("write", sorted(LIVE))
def test_freeze_key_stands_under_a_live_write(write):
    kind, mutate = LIVE[write]
    fleet = _fleet(kind, "cpu")
    fleet.next(_states(fleet._sdim))
    before = _key(fleet)
    mutate(fleet)
    assert _key(fleet) == before


@pytest.mark.parametrize("route", ["cpu_kernels", "torch", "mesh"])
def test_fleets_off_the_card_step_eagerly(route):
    """The CPU's kernel route, the torch route and a mesh fleet: no graph,
    every step counted eager."""
    if route == "cpu_kernels":
        fleet = _fleet("pm", "cpu")
    else:
        model, cost, sigma, lam, _ = _family("pm", "cpu")
        mesh = None
        if route == "mesh":
            from mppi_tf_tpu_torch.parallel import make_mesh

            mesh = make_mesh(devices=["cpu"] * 2)
        fleet = FleetMPPI(model, cost, N, k=64, tau=TAU, lam=lam,
                          upsilon=1.0, sigma=sigma, kernel="auto",
                          mesh=mesh, device="cpu")
        assert fleet.kernel_path == "torch"
    before = dict(fleet_mod.fleet_steps)
    for step in range(3):
        fleet.next(_states(6, step))
    after = fleet_mod.fleet_steps
    assert after["replayed"] == before["replayed"]
    assert after["captures"] == before["captures"]
    assert after["eager"] == before["eager"] + 3
    assert fleet._graph is None and fleet.timing["calls"] == 3


def test_next_eager_is_next_on_the_cpu():
    a, b = _fleet("pm", "cpu"), _fleet("pm", "cpu")
    for step in range(3):
        x = _states(6, step)
        np.testing.assert_array_equal(a.next(x), b.next_eager(x))
        assert torch.equal(a.useq, b.useq)


def test_fleet_steps_are_among_the_counters():
    fleet = _fleet("pm", "cpu")
    fleet.next(_states(6))
    got = tracing.counters()["fleet_steps"]
    assert got == fleet_mod.fleet_steps and got is not fleet_mod.fleet_steps
    assert set(got) == {"replayed", "eager", "captures"}
    assert got["eager"] >= 1


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts() -> dict:
    return dict(fleet_mod.fleet_steps)


def _same_step(a, b, x) -> None:
    """a's graphed ``next`` and b's ``next_eager`` on x: the same bits in
    the actions, the sequences and the info."""
    np.testing.assert_array_equal(a.next(x), b.next_eager(x))
    assert torch.equal(a.useq, b.useq)
    assert a._last_info.keys() == b._last_info.keys()
    for key, t in b._last_info.items():
        assert torch.equal(a._last_info[key], t), key


CASES = {
    "pm": ("pm", "float32", {}),
    "pm_normalized": ("pm", "float32", {"normalize_cost": True}),
    "pm_bf16": ("pm", "bfloat16", {}),
    "pm_bf16_normalized": ("pm", "bfloat16", {"normalize_cost": True}),
    "rexrov2_normalized": ("rexrov2", "float32", {"normalize_cost": True}),
    "nn_auv_normalized": ("nn_auv", "float32", {"normalize_cost": True}),
    "lti": ("lti", "float32", {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_next_equals_next_eager(cuda_device, case):
    """7 steps, the goals re-set after the third (read live, no capture
    again); one capture, then replays."""
    kind, dtype, options = CASES[case]
    a = _fleet(kind, cuda_device, k=4096, kernel_dtype=dtype, **options)
    b = _fleet(kind, cuda_device, k=4096, kernel_dtype=dtype, **options)
    before = _counts()
    for step in range(7):
        if step == 3:
            goals = _goals(kind, a._sdim)[::-1].copy()
            a.set_goals(goals)
            b.set_goals(goals)
        _same_step(a, b, _states(a._sdim, step))
    after = _counts()
    assert after["captures"] == before["captures"] + 1
    assert after["replayed"] == before["replayed"] + 6
    assert after["eager"] == before["eager"] + 7


@pytest.mark.cuda
@pytest.mark.parametrize("mutation", ["model_params", "set_noise_schedule",
                                      "load_state"])
def test_one_capture_again_after(cuda_device, mutation, tmp_path):
    kind = "rexrov2" if mutation == "model_params" else "pm"
    options = ({"schedule": SCHEDULE} if mutation == "set_noise_schedule"
               else {})
    a = _fleet(kind, cuda_device, k=4096, **options)
    b = _fleet(kind, cuda_device, k=4096, **options)
    sdim = a._sdim
    for step in range(2):
        _same_step(a, b, _states(sdim, step))
    path = str(tmp_path / "fleet.npz")
    if mutation == "load_state":
        a.save_state(path)
        for step in range(2, 4):
            _same_step(a, b, _states(sdim, step))
    before = _counts()
    for f in (a, b):
        if mutation == "model_params":
            _write_auv_mass(f)
        elif mutation == "set_noise_schedule":
            _new_schedule(f)
        else:
            f.load_state(path)
    for step in range(4, 8):
        _same_step(a, b, _states(sdim, step))
    after = _counts()
    assert after["captures"] == before["captures"] + 1
    assert after["replayed"] == before["replayed"] + 3


@pytest.mark.cuda
def test_a_fleet_loop_between_steps_keeps_one_stream(cuda_device):
    """A captured on-device fleet loop run between graphed steps advances
    the step count; the steps after it draw the solves the eager path
    draws."""
    a, b = _fleet("pm", cuda_device, k=4096), _fleet("pm", cuda_device,
                                                     k=4096)
    env = DevicePointMassEnv(n_dof=3, mass=1.0, dt=0.01)
    loops = [f.build_on_device_loop(env.step_fn, 3, substeps=2)
             for f in (a, b)]
    for step in range(2):
        _same_step(a, b, _states(6, step))
    ga, gb = loops[0](_states(6, 2)), loops[1].eager(_states(6, 2))
    for ta, tb in zip(ga, gb):
        assert torch.equal(ta, tb)
    assert a._steps == b._steps == 5
    for step in range(3, 6):
        _same_step(a, b, _states(6, step))


@pytest.mark.cuda
def test_a_handed_out_sequence_is_never_written(cuda_device):
    fleet = _fleet("rexrov2", cuda_device, k=4096, normalize_cost=True)
    held = []
    for step in range(4):
        fleet.next(_states(13, step))
        held.append((fleet.useq, fleet.useq.clone()))
    for t, copy in held:
        assert torch.equal(t, copy)
    assert len({t.data_ptr() for t, _ in held}) == len(held)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pm", "nn_auv"])
def test_replays_count_the_launches_of_eager_steps(cuda_device, kind):
    a = _fleet(kind, cuda_device, k=4096, normalize_cost=True)
    b = _fleet(kind, cuda_device, k=4096, normalize_cost=True)
    _same_step(a, b, _states(a._sdim))
    counts = []
    for step_fn in (a.next, b.next_eager):
        _launch.reset_launch_counts()
        for step in range(1, 5):
            step_fn(_states(a._sdim, step))
        counts.append(dict(_launch.launch_counts))
    assert counts[0] == counts[1] and sum(counts[0].values()) > 0
