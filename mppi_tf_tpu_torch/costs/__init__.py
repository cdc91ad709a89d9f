import torch

from .base import CostBase
from .elipse import ElipseCost, ElipseCost3D
from .static import StaticCost, StaticQuatCost
from .waypoints import WayPointsCost, WayPointsQuatCost

__all__ = ["CostBase", "ElipseCost", "ElipseCost3D", "StaticCost",
           "StaticQuatCost", "WayPointsCost", "WayPointsQuatCost",
           "get_cost"]


def get_cost(task_dict, lam, gamma, upsilon, sigma, dtype=torch.float32,
             device=None):
    """Type-dispatch cost factory over static / static_quat / elipse /
    elipse3d / waypoints / waypoints_quat, with the JAX package's argument
    names (reference: scripts/src/cost.py:51-64, whose waypoints and
    elipse3d branches are broken at HEAD and completed here)."""
    ctype = task_dict["type"]
    kw = dict(dtype=dtype, device=device)
    if ctype in ("static", "static_quat"):
        cls = StaticCost if ctype == "static" else StaticQuatCost
        return cls(lam, gamma, upsilon, sigma, goal=task_dict["goal"],
                   Q=task_dict["Q"], diag=task_dict.get("diag", False), **kw)
    if ctype == "elipse":
        return ElipseCost(
            lam, gamma, upsilon, sigma, a=task_dict["a"], b=task_dict["b"],
            center_x=task_dict["center_x"], center_y=task_dict["center_y"],
            speed=task_dict["speed"], m_state=task_dict["m_state"],
            m_vel=task_dict["m_vel"], **kw)
    if ctype == "elipse3d":
        return ElipseCost3D(
            lam, gamma, upsilon, sigma, normal=task_dict["normal"],
            aVec=task_dict["aVec"], axis=task_dict["axis"],
            center=task_dict["center"], speed=task_dict["speed"],
            m_state=task_dict["m_state"], m_vel=task_dict["m_vel"], **kw)
    if ctype in ("waypoints", "waypoints_quat"):
        cls = WayPointsQuatCost if ctype == "waypoints_quat" \
            else WayPointsCost
        return cls(lam, gamma, upsilon, sigma, Q=task_dict["Q"],
                   waypoints=task_dict.get("waypoints"),
                   alpha=task_dict.get("alpha", 0.2),
                   max_waypoints=task_dict.get("max_waypoints", 32),
                   diag=task_dict.get("diag", False), **kw)
    raise ValueError(f"unknown cost type: {ctype!r}")
