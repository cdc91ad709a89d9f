"""The system under test: the PyTorch and CUDA port, built from a
configuration and a cell's traffic.

This is the one module of the benchmark that imports the port
(``mppi_tf_tpu_torch``). It builds the port's model, cost, controller or
fleet and on-device plant through the port's public factories, and reads
the port's counters (kernel launches by entry point, the graph's nodes).
On the CPU (the benchmark's own tests) a controller takes the fused
solve's path, whose wrappers then run their plain versions over the same
Philox stream as the kernels.
"""

from __future__ import annotations

import numpy as np


def task(config: dict, traffic: dict, goal=None) -> dict:
    """The port's task (cost) dict for the cell's ``task``: a mission's
    legs, or ``goal`` (default the traffic's ``goal_base``, else the
    configuration's goal)."""
    cost = config["cost"]
    kind = traffic["task"]
    out = {"type": kind, "diag": cost.get("diag", False), "Q": cost["Q"]}
    if kind == "waypoints_quat":
        out.update(waypoints=traffic["mission"], alpha=cost["alpha"])
    else:
        if goal is None:
            goal = traffic.get("goal_base", cost.get("goal"))
        out["goal"] = list(goal)
    return out


def model_and_cost(config: dict, traffic: dict, device, goal=None):
    from mppi_tf_tpu_torch.costs import get_cost
    from mppi_tf_tpu_torch.models import get_model

    c = config["controller"]
    sigma = np.diag(c["sigma_diag"])
    model = get_model(config["model"], dt=config["dt"],
                      state_dim=config["state_dim"],
                      action_dim=config["action_dim"], device=device)
    cost = get_cost(task(config, traffic, goal), lam=c["lam"],
                    gamma=c["gamma"], upsilon=c["upsilon"], sigma=sigma,
                    device=device)
    return model, cost, sigma


def _kernel(device) -> str:
    return "cuda" if str(device).startswith("cuda") else "torch"


def _dtype(device, kernel_dtype: str) -> str:
    """The kernels' compute type at construction: on the CPU float32, and
    ``_fused_on_cpu`` sets the asked one on the fused solve."""
    return kernel_dtype if _kernel(device) == "cuda" else "float32"


def _fused_on_cpu(ctrl, device, sigma, kernel_dtype: str) -> None:
    """On the CPU, the fused solve's path (its plain versions) at
    ``kernel_dtype``."""
    if _kernel(device) == "torch":
        ctrl._kernel_dtype = kernel_dtype
        ctrl._resolve_kernel("auto", sigma, None)
        if ctrl._fused is None:
            raise RuntimeError("no fused solve supports this configuration")


def fleet(config: dict, traffic: dict, seed: int, device, goals,
          kernel_dtype: str = "float32"):
    """The port's ``FleetMPPI`` over the cell's vehicles, K, H and goals."""
    from mppi_tf_tpu_torch.controller.fleet import FleetMPPI

    model, cost, sigma = model_and_cost(config, traffic, device,
                                        goal=goals[0])
    c = config["controller"]
    f = FleetMPPI(model, cost, n_vehicles=traffic["vehicles"],
                  k=traffic["k"], tau=traffic["tau"], lam=c["lam"],
                  upsilon=c["upsilon"], sigma=sigma, goals=goals,
                  normalize_cost=traffic["normalize"], seed=seed,
                  kernel=_kernel(device),
                  kernel_dtype=_dtype(device, kernel_dtype), device=device)
    _fused_on_cpu(f._tpl, device, sigma, kernel_dtype)
    return f


def controller(config: dict, traffic: dict, seed: int, device,
               kernel_dtype: str = "float32"):
    """The port's ``MPPI`` at the cell's K, H and options."""
    from mppi_tf_tpu_torch.controller import MPPI

    model, cost, sigma = model_and_cost(config, traffic, device)
    c = config["controller"]
    ctrl = MPPI(model, cost, k=traffic["k"], tau=traffic["tau"],
                lam=c["lam"], upsilon=c["upsilon"], sigma=sigma,
                normalize_cost=traffic["normalize"], seed=seed,
                kernel=_kernel(device),
                kernel_dtype=_dtype(device, kernel_dtype), device=device)
    _fused_on_cpu(ctrl, device, sigma, kernel_dtype)
    return ctrl


def device_plant(config: dict, traffic: dict):
    """The port's on-device plant at the cell's plant dt: its pure
    ``step_fn(x, u)``."""
    from mppi_tf_tpu_torch.envs import AUVEnv, DevicePointMassEnv

    dt = float(traffic["plant_dt"])
    if config["model"]["type"] == "point_mass":
        return DevicePointMassEnv(n_dof=config["action_dim"],
                                  mass=config["model"]["mass"], dt=dt)
    return AUVEnv(config["model"], dt=dt)


def on_device_loop(ctrl, plant, traffic: dict):
    """The port's on-device closed loop: runs of ``periods`` control
    periods, replayed as one captured CUDA graph a period on the card."""
    from mppi_tf_tpu_torch.envs import build_on_device_loop

    return build_on_device_loop(ctrl, plant.step_fn, traffic["periods"],
                                traffic["plant_substeps"],
                                waypoint_radius=traffic.get("radius"))


def launch_counts() -> dict:
    """The port's kernel launches so far, by entry point."""
    from mppi_tf_tpu_torch.kernels import _launch

    return dict(_launch.launch_counts)
