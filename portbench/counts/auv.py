"""Counts of the Fossen AUV family (rexrov2): a sample-step is the force
u + eps, an rk 2 step of the Fossen state derivative, the quaternion's
renormalisation, the quaternion state cost and the action cost's terms."""

from __future__ import annotations

import numpy as np

from .mppi import diag, nnz, scale, two_phase, z_quadratic

#: the solve's parameters beyond the sequence's: M and M^-1 (72), the
#: mass, the goal, x0 (13 each), u_half, the second waypoint (13) and the
#: blend (2); the sequence and its cost terms take 12 a step
DYN_FIXED = 115


def state_dot_ops(config: dict) -> int:
    """Operations of one state derivative: the rotation (36), pose rates
    (18), quaternion rates (24), damping, M nu, three cross products and
    their sums (36), the restoring forces, the force sum (6) and
    M^-1 rhs."""
    p = config["model"]
    i = p["inertial"]
    inertia = np.array([[i["ixx"], i["ixy"], i["ixz"]],
                        [i["ixy"], i["iyy"], i["iyz"]],
                        [i["ixz"], i["iyz"], i["izz"]]])
    cog = np.asarray(p["cog"], np.float64)
    sg = p["mass"] * np.array([[0, -cog[2], cog[1]], [cog[2], 0, -cog[0]],
                               [-cog[1], cog[0], 0]])
    m = np.block([[p["mass"] * np.eye(3), -sg], [sg, inertia]]) \
        + np.asarray(p["Ma"], np.float64)
    return (36 + 18 + 24 + 2 * nnz(diag(p["linear_damping"]))
            + 2 * nnz(diag(p["linear_damping_forward_speed"])) + 36
            + 2 * nnz(m) + 36 + 24 + 2 * nnz(cog) + 2 * nnz(p["cob"]) + 6
            + 2 * nnz(np.linalg.inv(m)))


def model_step_ops(config: dict) -> int:
    """Operations of one rk 2 step (two derivatives, the stages) and the
    quaternion's renormalisation."""
    if int(config["model"]["rk"]) != 2:
        raise ValueError("counted for rk 2")
    return 2 * state_dot_ops(config) + 26 + 39 + 13


def step_ops(config: dict, cost: str) -> tuple:
    """(operations of one sample-step, of one state cost) under the
    ``static_quat`` or the ``waypoints_quat`` cost (two errors, |dot|,
    the blend)."""
    one = 3 + 7 + 2 + 10 + 2 + 6 + 2 * nnz(diag(config["cost"]["Q"])) + 20
    q_ops = {"static_quat": one, "waypoints_quat": 2 * (one + 1) + 3}[cost]
    step = (6 + 2 * nnz(scale(config)) + model_step_ops(config) + q_ops
            + 12 + z_quadratic(config, 6))
    return step, q_ops


def solve_work(config: dict, traffic: dict) -> dict:
    """{"ops", "bytes"} of one solve at the cell's K, H, cost and
    options."""
    k, tau = int(traffic["k"]), int(traffic["tau"])
    step, q_ops = step_ops(config, traffic["task"])
    return two_phase(k, tau, 6, step, q_ops, DYN_FIXED + 12 * tau,
                     bool(traffic["normalize"]))


def plant_ops(config: dict, traffic: dict) -> float:
    """Operations of one control period's plant steps."""
    return float(int(traffic["plant_substeps"]) * model_step_ops(config))
