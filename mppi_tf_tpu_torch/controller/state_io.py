"""Cost-params (goal) checkpointing for ``MPPI.save_state``/``load_state``.

The cost's mutable parameters are controller state: without them in the
checkpoint a resumed run silently reverts to the cost's initial goal.
They are stored as ``cp_<i>`` arrays in the same .npz, in sorted name
order (the order of the JAX package's pytree leaves); loading validates
count and shapes against the live cost.
"""

from __future__ import annotations

import torch


def cparams_entries(params: dict) -> dict:
    """npz entries for the cost params (``CostBase.params()``)."""
    return {f"cp_{i}": v.detach().cpu().numpy()
            for i, v in enumerate(params.values())}


def load_cparams(d, params: dict) -> None:
    """Copy the ``cp_<i>`` entries of npz ``d`` into the live cost params."""
    keys = sorted((k for k in d.files if k.startswith("cp_")),
                  key=lambda s: int(s[3:]))
    if not keys:  # checkpoint without cost params
        return
    if len(keys) != len(params):
        raise ValueError(
            f"checkpoint cost params carry {len(keys)} leaves but the "
            f"controller's cost has {len(params)}: different cost family?")
    for i, leaf in enumerate(params.values()):
        arr = d[f"cp_{i}"]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint cost-param leaf {i} has shape {arr.shape}, "
                f"the controller's cost expects {tuple(leaf.shape)}")
        leaf.copy_(torch.as_tensor(arr, dtype=leaf.dtype))
