import copy

import torch

from .auv import AUVModel
from .base import ModelBase
from .dmd import DMDModel
from .nn import NNAUVModel, NNAUVModelSpeed, NNModel
from .point_mass import PointMassModel

__all__ = ["AUVModel", "DMDModel", "ModelBase", "NNAUVModel",
           "NNAUVModelSpeed", "NNModel", "PointMassModel", "copy_model",
           "get_model"]

_NN_FAMILIES = {
    "neural_net": (NNModel, 1, "nn_model"),
    "auv_nn": (NNAUVModel, 6, "auv_nn_model"),
    "auv_nn_speed": (NNAUVModelSpeed, 6, "auv_nn_speed_model"),
}


def get_model(model_dict, dt=0.1, state_dim=2, action_dim=None, name=None,
              dtype=torch.float32, device=None, **kwargs):
    """Type-dispatch model factory (reference: scripts/src/model.py:53-67).

    Families: ``point_mass``, ``auv``, ``neural_net``, ``auv_nn``,
    ``auv_nn_speed`` and ``dmd`` (``rank``, ``reg``). ``action_dim=None``
    keeps each family's default (1 for the point mass, the generic NN and
    DMD, 6 for the AUV families). ``kwargs`` (``hidden``, ``seed``,
    ``compute_dtype``) go to the NN families, which also read ``hidden``,
    ``seed`` and ``normalisers`` ({``x_mean``, ``x_std``, ``y_mean``,
    ``y_std``}: vectors or scalars, ``NNModel.set_normalization``) from
    ``model_dict``; an explicit kwarg wins over the dict's key.
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
        for key in ("hidden", "seed"):
            if key in model_dict:
                kwargs.setdefault(key, model_dict[key])
        model = cls(action_dim=action_dim if action_dim else default_adim,
                    dt=dt, name=name or default_name, dtype=dtype,
                    device=device, **limits, **kwargs)
        norm = model_dict.get("normalisers")
        if norm is not None:
            model.set_normalization(**{k: norm[k] for k in (
                "x_mean", "x_std", "y_mean", "y_std")})
        return model
    if mtype == "dmd":
        return DMDModel(
            state_dim=state_dim,
            action_dim=action_dim if action_dim else 1,
            dt=dt,
            rank=model_dict.get("rank"),
            reg=model_dict.get("reg", 1e-9),
            name=name or "dmd_model",
            dtype=dtype,
            device=device,
            **limits,
        )
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
