import torch

from .base import ModelBase
from .point_mass import PointMassModel

__all__ = ["ModelBase", "PointMassModel", "get_model"]

# model families of the JAX package that this port does not carry yet,
# with the ROADMAP item that ports each
_NOT_PORTED = {
    "auv": "ROADMAP item 10 (AUV flagship)",
    "neural_net": "ROADMAP item 11 (NN models and learning)",
    "auv_nn": "ROADMAP item 11 (NN models and learning)",
    "auv_nn_speed": "ROADMAP item 11 (NN models and learning)",
    "dmd": "ROADMAP item 9 (DMD adaptive control)",
}


def get_model(model_dict, dt=0.1, state_dim=2, action_dim=None, name=None,
              dtype=torch.float32, device=None):
    """Type-dispatch model factory (reference: scripts/src/model.py:53-67).

    Only the ``point_mass`` family is ported; the other families of the
    JAX package raise ``NotImplementedError`` naming their ROADMAP item.
    """
    mtype = model_dict.get("type", "point_mass")
    if mtype == "point_mass":
        return PointMassModel(
            mass=model_dict.get("mass", 1.0),
            dt=dt,
            state_dim=state_dim,
            action_dim=action_dim if action_dim else 1,
            act_max=model_dict.get("limMax"),
            act_min=model_dict.get("limMin"),
            name=name or "point_mass",
            dtype=dtype,
            device=device,
        )
    if mtype in _NOT_PORTED:
        raise NotImplementedError(
            f"model type {mtype!r} is not ported yet: {_NOT_PORTED[mtype]}")
    raise ValueError(f"unknown model type: {mtype!r}")
