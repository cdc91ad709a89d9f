import torch

from .base import CostBase
from .static import StaticCost, StaticQuatCost

__all__ = ["CostBase", "StaticCost", "StaticQuatCost", "get_cost"]

# cost families of the JAX package that this port does not carry yet,
# with the ROADMAP item that ports each
_NOT_PORTED = {
    "elipse": "ROADMAP item 8 (other point-mass costs and missions)",
    "elipse3d": "ROADMAP item 10 (AUV flagship)",
    "waypoints": "ROADMAP item 8 (other point-mass costs and missions)",
    "waypoints_quat": "ROADMAP item 10 (AUV flagship)",
}


def get_cost(task_dict, lam, gamma, upsilon, sigma, dtype=torch.float32,
             device=None):
    """Type-dispatch cost factory (reference: scripts/src/cost.py:51-64).

    The ``static`` and ``static_quat`` families are ported; the other
    families of the JAX package raise ``NotImplementedError`` naming their
    ROADMAP item.
    """
    ctype = task_dict["type"]
    if ctype in ("static", "static_quat"):
        cls = StaticCost if ctype == "static" else StaticQuatCost
        return cls(
            lam, gamma, upsilon, sigma,
            goal=task_dict["goal"], Q=task_dict["Q"],
            diag=task_dict.get("diag", False), dtype=dtype, device=device,
        )
    if ctype in _NOT_PORTED:
        raise NotImplementedError(
            f"cost type {ctype!r} is not ported yet: {_NOT_PORTED[ctype]}")
    raise ValueError(f"unknown cost type: {ctype!r}")
