"""Parameter checkpoints.

Reference mechanisms (SURVEY.md §5.4): Keras SavedModel at
``weights_step{n}`` (nn_model.py:137-142) and the latest-checkpoint scan
of verify_models.py:55-64. The JAX package saves an Orbax directory where
orbax is installed and an npz otherwise (``mppi_tf_tpu/learning/
checkpoint.py``); the port has one format, an npz keyed by the parameters'
flattened names in the JAX package's layout (``interop._flatten``:
``net.0.w``, ``x_mean``, ``mass``), so a checkpoint reads back without a
template and names what it holds.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from ..interop import _flatten, _unflatten


def save_checkpoint(path: str, params: Any) -> str:
    """Write a params tree (tensors on any device, or arrays) to
    ``path + ".npz"``; returns the file's path."""
    flat = {name: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v))
            for name, v in _flatten(params).items()}
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez(path, **flat)
    return path


def load_checkpoint(path: str, like: Optional[Any] = None) -> Any:
    """The params tree saved by :func:`save_checkpoint` at ``path`` (with
    or without ``.npz``), as numpy arrays; with ``like`` (a tree of the
    same names) each leaf takes the dtype and device of ``like``'s leaf,
    as tensors where ``like`` holds tensors."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz_path) as data:
        flat = {name: data[name] for name in data.files}
    if like is None:
        return _unflatten(flat)
    ref = _flatten(like)
    if set(ref) != set(flat):
        raise KeyError(f"checkpoint holds {sorted(flat)}, expected "
                       f"{sorted(ref)}")
    out = {}
    for name, r in ref.items():
        if isinstance(r, torch.Tensor):
            out[name] = torch.as_tensor(flat[name], dtype=r.dtype,
                                        device=r.device).reshape(r.shape)
        else:
            out[name] = np.asarray(flat[name], dtype=np.asarray(r).dtype)
    return _unflatten(out)


def latest_checkpoint(logdir: str) -> Optional[str]:
    """The ``weights_step{n}`` (or ``weights_step{n}.npz``) in ``logdir``
    with the largest n, or None (reference verify_models.py:55-64)."""
    best, best_step = None, -1
    if not os.path.isdir(logdir):
        return None
    for name in os.listdir(logdir):
        m = re.match(r"weights_step(\d+)(\.npz)?$", name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(logdir, name)
    return best
