"""YAML config system: env / task / model families and experiment replay.

Reference: scripts/src/misc/utile.py:41-59 (``parse_config`` /
``parse_dir``) and the three YAML families under config/:

- env configs: dt, noise covariance, horizon, samples, lambda, state and
  action dims (``defaults/envs/``);
- task configs: cost ``type`` and its parameters (``defaults/tasks/``);
- model configs: model ``type`` and its physical parameters
  (``defaults/models/``).

The port carries its own copy of the bundled defaults. ``parse_dir``
reloads the config / task / model snapshots of an experiment directory,
for ``--replay``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import yaml

_DEFAULTS_DIR = os.path.join(os.path.dirname(__file__), "defaults")


def parse_config(path: str) -> Dict[str, Any]:
    """Load one YAML config file. Reference: utile.py:41-44."""
    with open(path) as f:
        return yaml.safe_load(f)


def load_config(name_or_path: Optional[str]) -> Optional[Dict[str, Any]]:
    """A config from a YAML path or a bundled default name (e.g.
    ``envs/point_mass``); None for None."""
    if name_or_path is None:
        return None
    if os.path.exists(name_or_path):
        return parse_config(name_or_path)
    return default_config(name_or_path)


def parse_dir(logdir: str) -> Tuple[dict, Optional[dict], Optional[dict]]:
    """The (config, task, model) snapshots of an experiment directory:
    config.yaml, and task.yaml / model.yaml where present (utile.py:53-59)."""
    cfg = parse_config(os.path.join(logdir, "config.yaml"))
    task = model = None
    task_path = os.path.join(logdir, "task.yaml")
    if os.path.exists(task_path):
        task = parse_config(task_path)
    model_path = os.path.join(logdir, "model.yaml")
    if os.path.exists(model_path):
        model = parse_config(model_path)
    return cfg, task, model


def default_config(name: str) -> Dict[str, Any]:
    """A bundled default config by name, e.g. ``envs/point_mass``,
    ``tasks/static_cost`` or ``models/rexrov2``."""
    path = os.path.join(_DEFAULTS_DIR, name + ".yaml")
    if not os.path.exists(path):
        available = []
        for root, _dirs, files in os.walk(_DEFAULTS_DIR):
            rel = os.path.relpath(root, _DEFAULTS_DIR)
            available += [os.path.normpath(os.path.join(rel, f[:-5]))
                          for f in files if f.endswith(".yaml")]
        raise FileNotFoundError(
            f"no default config {name!r}; available: {sorted(available)}")
    return parse_config(path)


def patch_config(cfg: Dict[str, Any], **overrides) -> Dict[str, Any]:
    """A copy of ``cfg`` with hyperparameters overridden (the sweep
    primitive; reference scripts/src/mujoco/gen_config.py). Keys use the
    YAML spelling (``lambda``); ``init_act`` means ``init-act``. A scalar
    ``noise`` scales the existing noise matrix (or 1-D diagonal)."""
    out = copy.deepcopy(cfg)
    for key, value in overrides.items():
        key = key.replace("_", "-") if key in ("init_act",) else key
        if key == "noise" and not hasattr(value, "__len__"):
            base_raw = out.get("noise")
            base = (np.asarray(base_raw, dtype=float)
                    if base_raw is not None else None)
            if base is None or base.ndim == 0:
                raise ValueError(
                    "scalar 'noise' override scales an existing noise "
                    "matrix; this config has none: pass a full matrix "
                    "(or a 1-D diagonal) instead")
            if base.ndim == 1:
                out["noise"] = np.diag(value * base).tolist()
            else:
                out["noise"] = (value * base).tolist()
        elif value is not None:
            out[key] = value
    return out


def write_config(cfg: Dict[str, Any], path: str) -> str:
    """Write a config dict to YAML (gen_config.py:61-97); returns path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path
