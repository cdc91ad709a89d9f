import copy

import torch

from .auv import AUVModel
from .base import ModelBase
from .nn import NNAUVModel, NNAUVModelSpeed, NNModel
from .point_mass import PointMassModel

__all__ = ["AUVModel", "ModelBase", "NNAUVModel", "NNAUVModelSpeed",
           "NNModel", "PointMassModel", "copy_model", "get_model"]

# model families of the JAX package that this port does not carry yet,
# with the ROADMAP item that ports each
_NOT_PORTED = {
    "dmd": "ROADMAP item 9 (DMD adaptive control)",
}

_NN_FAMILIES = {
    "neural_net": (NNModel, 1, "nn_model"),
    "auv_nn": (NNAUVModel, 6, "auv_nn_model"),
    "auv_nn_speed": (NNAUVModelSpeed, 6, "auv_nn_speed_model"),
}


def get_model(model_dict, dt=0.1, state_dim=2, action_dim=None, name=None,
              dtype=torch.float32, device=None, **kwargs):
    """Type-dispatch model factory (reference: scripts/src/model.py:53-67).

    The ``point_mass``, ``auv``, ``neural_net``, ``auv_nn`` and
    ``auv_nn_speed`` families are ported; ``dmd`` raises
    ``NotImplementedError`` naming its ROADMAP item. ``action_dim=None``
    keeps each family's default (1 for the point mass and the generic NN,
    6 for the AUV families). ``kwargs`` (``hidden``, ``seed``,
    ``compute_dtype``) go to the NN families.
    """
    mtype = model_dict.get("type", "point_mass")
    limits = dict(act_max=model_dict.get("limMax"),
                  act_min=model_dict.get("limMin"))
    if mtype == "point_mass":
        return PointMassModel(
            mass=model_dict.get("mass", 1.0),
            dt=dt,
            state_dim=state_dim,
            action_dim=action_dim if action_dim else 1,
            name=name or "point_mass",
            dtype=dtype,
            device=device,
            **limits,
        )
    if mtype == "auv":
        return AUVModel(
            parameters=model_dict,
            dt=dt,
            action_dim=action_dim if action_dim else 6,
            name=name or model_dict.get("model", "auv"),
            dtype=dtype,
            device=device,
            **limits,
        )
    if mtype in _NN_FAMILIES:
        cls, default_adim, default_name = _NN_FAMILIES[mtype]
        if cls is NNModel:
            kwargs["state_dim"] = state_dim
        return cls(action_dim=action_dim if action_dim else default_adim,
                   dt=dt, name=name or default_name, dtype=dtype,
                   device=device, **limits, **kwargs)
    if mtype in _NOT_PORTED:
        raise NotImplementedError(
            f"model type {mtype!r} is not ported yet: {_NOT_PORTED[mtype]}")
    raise ValueError(f"unknown model type: {mtype!r}")


def copy_model(model):
    """Structural clone of a model for k-fold validation (reference:
    scripts/src/model.py:70-78). The port's models hold their parameters,
    so the clone is a deep copy; an NN clone restarts from its seed's He
    init and identity normalisers, as the JAX package's ``copy_model``
    (``model.init_params()``) does."""
    clone = copy.deepcopy(model)
    if isinstance(clone, NNModel):
        clone.reset_parameters()
    return clone
