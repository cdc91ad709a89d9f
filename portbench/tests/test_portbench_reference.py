"""The plain reference against the port's own plain code at a tiny size:
the normals, the models' steps, the plants and a whole solve. (The tests
may import the port; the reference itself does not.)"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT

BENCH = ROOT / "portbench"


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("adim,seed,solve", [(3, 7, 0), (6, 2 ** 31 + 9,
                                                        2 ** 32 + 5)])
def test_noise_is_the_kernels_stream(adim, seed, solve):
    from mppi_tf_tpu_torch.kernels.pm_mppi import noise_plain

    from portbench.reference import noise

    k, tau = 300, 5
    ours = noise.normals(seed, solve, k, tau, adim)
    theirs = noise_plain(seed, solve, k, tau, adim).permute(2, 0, 1)
    assert ours.dtype == torch.float64
    # the port rounds each normal to f32 once
    assert torch.allclose(ours.float(), theirs, rtol=0, atol=0)


def test_point_mass_step_and_plant():
    from mppi_tf_tpu_torch.envs import DevicePointMassEnv
    from mppi_tf_tpu_torch.models import get_model

    from portbench.reference.point_mass3d import Reference

    cfg = config("point_mass3d")
    ref = Reference(cfg, "cpu")
    model = get_model(cfg["model"], dt=cfg["dt"], state_dim=6,
                      action_dim=3, dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(50, 6, generator=g, dtype=torch.float64)
    u = torch.randn(50, 3, generator=g, dtype=torch.float64)
    assert torch.allclose(ref.step(x, u), model.step(x, u), atol=1e-13)
    env = DevicePointMassEnv(n_dof=3, dt=0.01, dtype=torch.float64)
    y = x[0]
    for _ in range(10):
        y = env.step_fn(y, u[0])
    assert torch.allclose(ref.plant(x[0], u[0], 0.01, 10), y, atol=1e-13)


def test_rexrov2_step_and_plant():
    from mppi_tf_tpu_torch.envs import AUVEnv
    from mppi_tf_tpu_torch.models import get_model

    from portbench.reference.rexrov2 import Reference

    cfg = config("rexrov2")
    ref = Reference(cfg, "cpu")
    model = get_model(cfg["model"], dt=cfg["dt"], dtype=torch.float64,
                      device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(40, 13, generator=g, dtype=torch.float64)
    x[:, 3:7] /= x[:, 3:7].norm(dim=1, keepdim=True)
    u = 500.0 * torch.randn(40, 6, generator=g, dtype=torch.float64)
    with torch.no_grad():
        want = model.step(x, u)
    assert torch.allclose(ref.step(x, u), want, rtol=1e-12, atol=1e-12)
    env = AUVEnv(cfg["model"], dt=0.02)
    y = x[0]
    for _ in range(5):
        y = env.step_fn(y, u[0])
    assert torch.allclose(ref.plant(x[0], u[0], 0.02, 5), y, rtol=1e-12,
                          atol=1e-12)


REST = [0.0] * 6 + [1.0] + [0.0] * 6
MISSION = [REST[:2] + [-1.0] + REST[3:], REST[:2] + [-2.0] + REST[3:]]
GOAL = REST[:2] + [-1.5] + REST[3:]


@pytest.mark.parametrize("name,task,normalize", [
    ("point_mass3d", "static", False), ("rexrov2", "static_quat", True),
    ("rexrov2", "waypoints_quat", True)])
def test_a_solve_agrees_with_the_ports_plain_fused_solve(name, task,
                                                         normalize):
    """The reference's plan against the port's fused solve on the CPU
    (its plain versions) at f32: within f32 rounding, in units of each
    action's noise scale."""
    from portbench import program
    from portbench.reference import mppi as ref_mppi
    from portbench.reference.point_mass3d import Reference as PM
    from portbench.reference.rexrov2 import Reference as RX

    cfg = config(name)
    traffic = {"k": 600, "tau": 6, "normalize": normalize, "task": task}
    if name == "point_mass3d":
        ref = PM(cfg, "cpu")
        x, cp = np.array([0.2, 0.1, -0.3, 0.0, 0.4, -0.1]), \
            ref.static_params()
    else:
        ref = RX(cfg, "cpu")
        x = np.array(REST)
        traffic.update(mission=MISSION, goal_base=GOAL)
        cp = (ref.static_params(GOAL) if task == "static_quat"
              else ref.mission_params(MISSION))
    ctrl = program.controller(cfg, traffic, seed=11, device="cpu")
    useq = 0.1 * torch.ones(6, cfg["action_dim"], dtype=torch.float64) \
        * ref.action_scale
    for solve in (0, 3):
        state = torch.as_tensor(x, dtype=torch.float32)
        _, _, info = ctrl._fused_step(state, useq.float(), solve=solve)
        new = ref_mppi.plan(ref, x, useq, cp, 11, solve, 600, normalize)
        gap = ((info["useq"].double() - new).abs() / ref.action_scale).max()
        assert gap < 1e-5, gap


@pytest.mark.parametrize("name", ["point_mass3d", "rexrov2"])
def test_the_host_plant_is_the_plant(name):
    """The fleets' numpy plant on the host against the torch plant."""
    from portbench.reference import point_mass3d, rexrov2

    cfg = config(name)
    mod = point_mass3d if name == "point_mass3d" else rexrov2
    ref = mod.Reference(cfg, "cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, cfg["state_dim"]))
    if name == "rexrov2":
        x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    u = 300.0 * rng.normal(size=(5, cfg["action_dim"]))
    want = ref.plant(torch.from_numpy(x), torch.from_numpy(u), 0.05, 3)
    got = ref.host_plant(x, u, 0.05, 3)
    assert np.allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)
