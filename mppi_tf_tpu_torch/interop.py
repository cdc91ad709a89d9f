"""Carry parameters between the JAX package and this port (numpy only).

The JAX package threads model and cost parameters as dicts
(``model_params``, e.g. ``{"mass"}``, and the cost params, e.g.
``{"goal"}``); this port holds them in its modules. These helpers move
them across as numpy arrays, so that both packages compute the same thing.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_params(mparams: dict, cparams: dict, model, cost):
    """Load the JAX package's model and cost params (numpy arrays, or
    anything ``np.asarray`` takes) into ``model`` and ``cost`` in place.
    Returns ``(model, cost)``."""
    names = {n for n, _ in model.named_parameters()}
    if set(mparams) != names:
        raise KeyError(f"model params {sorted(mparams)} != the model's "
                       f"parameters {sorted(names)}")
    if set(cparams) != set(cost.param_names):
        raise KeyError(f"cost params {sorted(cparams)} != the cost's "
                       f"params {sorted(cost.param_names)}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            value = np.asarray(mparams[name], np.float64).reshape(p.shape)
            p.copy_(torch.as_tensor(value, dtype=p.dtype))
        for name, buf in cost.params().items():
            value = np.asarray(cparams[name], np.float64).reshape(buf.shape)
            buf.copy_(torch.as_tensor(value, dtype=buf.dtype))
    return model, cost


def to_jax_params(model, cost):
    """The port's params as the JAX package's dicts of numpy arrays."""
    mparams = {n: p.detach().cpu().numpy()
               for n, p in model.named_parameters()}
    cparams = {n: b.detach().cpu().numpy() for n, b in cost.params().items()}
    return mparams, cparams
