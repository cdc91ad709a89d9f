"""Counts of the point-mass family (NicolayP/mppi-tf's point mass): a
sample-step is x' = A x + B (u + eps) / m with the double integrator's A
and B, the quadratic state cost and the action cost's terms."""

from __future__ import annotations

import numpy as np

from .mppi import diag, nnz, scale, two_phase, z_quadratic


def step_ops(config: dict) -> tuple:
    """(operations of one sample-step, of one state cost)."""
    s, a = int(config["state_dim"]), int(config["action_dim"])
    dt = float(config["dt"])
    A = np.eye(s)
    B = np.zeros((s, a))
    for d in range(a):
        A[2 * d, 2 * d + 1] = dt
        B[2 * d, d], B[2 * d + 1, d] = dt * dt / 2.0, dt
    q_ops = s + 2 * nnz(diag(config["cost"]["Q"])) + 2 * s
    ab = nnz(A) + nnz(B @ scale(config))
    step = 2 * ab + 2 * s + q_ops + 2 * a + z_quadratic(config, a)
    return step, q_ops


def solve_work(config: dict, traffic: dict) -> dict:
    """{"ops", "bytes"} of one solve at the cell's K, H and options."""
    k, tau = int(traffic["k"]), int(traffic["tau"])
    s, a = int(config["state_dim"]), int(config["action_dim"])
    step, q_ops = step_ops(config)
    dyn = 2 + 2 * s + tau * s + tau * a
    return two_phase(k, tau, a, step, q_ops, dyn, bool(traffic["normalize"]))


def plant_ops(config: dict, traffic: dict) -> float:
    """Operations of one control period's plant steps: a / m, q + v dt +
    0.5 a dt^2 and v + a dt on each axis, ``plant_substeps`` times."""
    return float(int(traffic["plant_substeps"]) * 9
                 * int(config["action_dim"]))
