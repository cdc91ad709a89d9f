"""Carry parameters between the JAX package and this port (numpy only).

The JAX package threads model and cost parameters as pytrees
(``model_params``, e.g. ``{"mass"}``, or an NN's
``{"net": [{"w", "b"}, ...], "x_mean", "x_std", "y_mean", "y_std"}``, and
the cost params, e.g. ``{"goal"}`` or a waypoint queue's
``{"count", "waypoints"}``); this port holds them in its modules
(an NN's layer i as ``net.{i}.w`` / ``net.{i}.b``, its normalisers as the
buffers named in ``param_buffers``). These helpers move them across as
numpy arrays, so that both packages compute the same thing.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    """{"net": [{"w": a}], "x": b} -> {"net.0.w": a, "x": b}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(_flatten(value, f"{prefix}{key}."))
    return {k.rstrip("."): v for k, v in out.items()}


def _unflatten(flat: dict):
    """Inverse of ``_flatten``: digit keys become list indices."""
    tree: dict = {}
    for name, value in flat.items():
        node, parts = tree, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def _model_tensors(model) -> dict:
    """The model's carried tensors by name: its parameters and the buffers
    it names in ``param_buffers``."""
    out = dict(model.named_parameters())
    for name in getattr(model, "param_buffers", ()):
        out[name] = getattr(model, name)
    return out


def _cost_tensors(cost) -> dict:
    """The cost params a cost carries, or a ``FleetMPPI``'s stacked ones
    ([n, ...], the JAX fleet's ``_cparams`` layout)."""
    if cost is None:
        return {}
    stacked = getattr(cost, "cost_params", None)
    return cost.params() if stacked is None else stacked


def from_jax_params(mparams: dict, cparams, model, cost=None):
    """Load the JAX package's model and cost params (numpy arrays, or
    anything ``np.asarray`` takes) into ``model`` and ``cost`` in place;
    ``cost=None`` (with ``cparams=None``) loads the model alone. ``cost``
    may be a ``FleetMPPI``: ``cparams`` is then the JAX fleet's stacked
    pytree ([n, ...] leaves). Returns ``(model, cost)``."""
    cparams = {} if cost is None else cparams
    flat = _flatten(mparams)
    targets = _model_tensors(model)
    if set(flat) != set(targets):
        raise KeyError(f"model params {sorted(flat)} != the model's "
                       f"parameters {sorted(targets)}")
    bufs = _cost_tensors(cost)
    if cost is not None and set(cparams) != set(bufs):
        raise KeyError(f"cost params {sorted(cparams)} != the cost's "
                       f"params {sorted(bufs)}")
    with torch.no_grad():
        for name, t in targets.items():
            value = np.asarray(flat[name], np.float64).reshape(t.shape)
            t.copy_(torch.tensor(value, dtype=t.dtype))
        for name, buf in bufs.items():
            value = np.asarray(cparams[name], np.float64).reshape(buf.shape)
            buf.copy_(torch.tensor(value, dtype=buf.dtype))
    if cost is not None and bufs is not getattr(cost, "cost_params", None):
        cost.sync_host()
    return model, cost


def to_jax_params(model, cost=None):
    """The port's params as the JAX package's pytrees of numpy arrays
    (cparams {} without a cost; a ``FleetMPPI``'s stacked [n, ...])."""
    mparams = _unflatten({n: t.detach().cpu().numpy()
                          for n, t in _model_tensors(model).items()})
    cparams = {n: b.detach().cpu().numpy()
               for n, b in _cost_tensors(cost).items()}
    return mparams, cparams
