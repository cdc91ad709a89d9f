"""Batched rollout: score K noise-perturbed control sequences.

A Python loop over the horizon takes the place of the JAX package's
``lax.scan``. Semantics preserved from the reference loop
(scripts/src/controllers/controller_base.py:371-434):
- the applied control at step t is ``U_t + eps_t``;
- the step cost is evaluated on the *next* state with the *unperturbed*
  action and the noise;
- the terminal cost phi(x_tau) is added on top of the last step's cost.
"""

from __future__ import annotations

from typing import Callable

import torch


def rollout_costs(step_fn: Callable, state_cost_fn: Callable,
                  action_cost_fn: Callable, terminal_cost_fn: Callable,
                  x0: torch.Tensor, useq: torch.Tensor, noises: torch.Tensor,
                  sched=None) -> torch.Tensor:
    """Compute per-sample rollout costs.

    Args:
        step_fn: ``(x[k, sDim], u[k, aDim]) -> x_next[k, sDim]``.
        state_cost_fn: ``x[k, sDim] -> [k]`` running state cost q(x).
        action_cost_fn: ``(u[aDim], eps[k, aDim]) -> [k]``; with ``sched``
            it is called as ``(u, eps, c_t)``.
        terminal_cost_fn: ``x[k, sDim] -> [k]`` terminal cost phi(x).
        x0: [sDim] or [k, sDim] initial state.
        useq: [tau, aDim] nominal action sequence.
        noises: [k, tau, aDim] noise (already schedule-scaled).
        sched: optional [tau] per-step noise-schedule factors c_t.

    Returns:
        costs: [k] total rollout cost per sample.
    """
    k = noises.shape[0]
    x = x0.expand(k, x0.shape[-1]) if x0.ndim == 1 else x0
    cost = torch.zeros(k, dtype=x.dtype, device=x.device)
    for t in range(useq.shape[0]):
        u_t, eps_t = useq[t], noises[:, t]
        x = step_fn(x, u_t[None, :] + eps_t)
        if sched is None:
            act = action_cost_fn(u_t, eps_t)
        else:
            act = action_cost_fn(u_t, eps_t, sched[t])
        cost = cost + state_cost_fn(x) + act
    return cost + terminal_cost_fn(x)


def rollout_trajectory(step_fn: Callable, x0: torch.Tensor,
                       useq: torch.Tensor) -> torch.Tensor:
    """Open-loop rollout returning the full trajectory.

    x0: [k, sDim] (or [sDim]); useq: [tau, aDim] or [k, tau, aDim].
    Returns [k, tau+1, sDim] including the initial state ([tau+1, sDim]
    for a single [sDim] x0). Reference: scripts/src/models/model_base.py:75-100.
    """
    squeeze = x0.ndim == 1
    x = x0[None, :] if squeeze else x0
    k = x.shape[0]
    if useq.ndim == 2:
        useq = useq[None].expand(k, *useq.shape)
    traj = [x]
    for t in range(useq.shape[1]):
        x = step_fn(x, useq[:, t])
        traj.append(x)
    out = torch.stack(traj, dim=1)
    return out[0] if squeeze else out
