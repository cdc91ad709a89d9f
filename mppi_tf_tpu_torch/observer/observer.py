"""Metrics observer: TensorBoard scalars and histograms, a JSONL record and
config snapshots.

Reference: scripts/src/observer/observer_base.py: per-step scalars and
histograms of the sample costs, weights, nabla (as % of K), exp argument,
noise, applied input and state; the one-step prediction error split into
position, rotation and velocity; YAML config snapshots into the logdir for
replay (observer_base.py:46-59); a step counter (``advance``).

The port's copy of the JAX package's observer (mppi_tf_tpu/observer):
the same tags, values and files. Tensors go through ``.cpu()`` before
numpy. ``torch.utils.tensorboard`` is imported only when an observer is
built with ``use_tensorboard``; where it cannot be imported (a machine
without the ``tensorboard`` package) the JSONL stream ``metrics.jsonl`` is
the record, histograms included as mean / std / min / max.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Optional

import numpy as np
import torch


def _np(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _summary_writer():
    """torch.utils.tensorboard's SummaryWriter, or None where the
    tensorboard package is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return None
    return SummaryWriter


class Observer:
    """Writes control and prediction metrics and snapshots configs for
    replay."""

    def __init__(self, log_path: Optional[str] = None, env_cfg=None,
                 task_cfg=None, model_cfg=None, use_tensorboard: bool = True,
                 log: bool = True):
        self.log = log
        self._step = 0
        stamp = datetime.now().strftime("%Y.%m.%d-%H.%M.%S")
        self.logdir = os.path.join(log_path or "logs", stamp)
        os.makedirs(self.logdir, exist_ok=True)
        self._writer = None
        writer = _summary_writer() if use_tensorboard else None
        if writer is not None:
            self._writer = writer(self.logdir)
        self._jsonl = open(os.path.join(self.logdir, "metrics.jsonl"), "a")
        self._snapshot_configs(env_cfg, task_cfg, model_cfg)

    # --- config snapshots (observer_base.py:46-59) ---------------------
    def _snapshot_configs(self, env_cfg, task_cfg, model_cfg):
        import yaml

        for name, cfg in (("config", env_cfg), ("task", task_cfg),
                          ("model", model_cfg)):
            if cfg is not None:
                with open(os.path.join(self.logdir, f"{name}.yaml"), "w") as f:
                    yaml.safe_dump(cfg, f)

    def get_logdir(self) -> str:
        return self.logdir

    # --- step counter (observer_base.py:95-99) --------------------------
    def advance(self):
        self._step += 1

    @property
    def step(self) -> int:
        return self._step

    # --- writers ---------------------------------------------------------
    def scalar(self, tag: str, value, step: Optional[int] = None):
        """Scalars go to both sinks: metrics.jsonl is the machine-readable
        record, TensorBoard the optional human view. Histograms go to
        TensorBoard, or to the JSONL as summary statistics without it."""
        if not self.log:
            return
        step = self._step if step is None else step
        value = float(_np(value))
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"step": step, tag: value}) + "\n")

    def histogram(self, tag: str, values, step: Optional[int] = None):
        if not self.log:
            return
        step = self._step if step is None else step
        values = _np(values)
        if self._writer is not None:
            self._writer.add_histogram(tag, values, step)
        else:
            self._jsonl.write(json.dumps({
                "step": step, tag + "/mean": float(values.mean()),
                tag + "/std": float(values.std()),
                tag + "/min": float(values.min()),
                tag + "/max": float(values.max()),
            }) + "\n")

    # --- controller hooks ----------------------------------------------
    def write_control(self, state=None, action=None, info=None):
        """Per-solve metrics; the catalogue of observer_base.py:101-187."""
        if not self.log:
            return
        if info is not None:
            for key in ("cost_min", "cost_mean", "cost_max"):
                if key in info:
                    self.scalar(f"Cost/{key}", info[key])
            if "nabla" in info:
                self.scalar("Controller/nabla", info["nabla"])
                if "sample_costs" in info:
                    k = _np(info["sample_costs"]).shape[0]
                    self.scalar("Controller/nabla_percent",
                                100.0 * float(_np(info["nabla"])) / k)
            for key in ("sample_costs", "weights", "arg", "noise"):
                if key in info:
                    self.histogram(f"Controller/{key}", info[key])
            if "weighted_noise" in info:
                self.histogram("Controller/weighted_noise",
                               info["weighted_noise"])
        if action is not None:
            for i, a in enumerate(_np(action).reshape(-1)):
                self.scalar(f"Input/axis_{i}", a)
        if state is not None:
            self.histogram("State/state", state)

    @torch.no_grad()
    def write_predict(self, x=None, u=None, x_next=None, pred=None,
                      cost=None):
        """One-step prediction-error metrics.

        The error split follows controller_base.py:162-210: position (L2
        on [:3]), rotation (1 - <q, q_pred>), velocity (L2 on [-6:]) for
        quaternion states; plain L2 otherwise. With a ``cost`` module, the
        state's step cost and its distance to the goal."""
        if not self.log or pred is None or x_next is None:
            return
        gt = _np(x_next).reshape(-1)
        pr = _np(pred).reshape(-1)
        if gt.shape[0] >= 13:  # quaternion state
            self.scalar("Predict/error_position",
                        np.linalg.norm(gt[:3] - pr[:3]))
            self.scalar("Predict/error_rotation",
                        1.0 - float(gt[3:7] @ pr[3:7]))
            self.scalar("Predict/error_velocity",
                        np.linalg.norm(gt[-6:] - pr[-6:]))
        else:
            self.scalar("Predict/error", np.linalg.norm(gt - pr))
        if cost is not None and x is not None:
            state_b = torch.as_tensor(_np(x).reshape(1, -1),
                                      dtype=cost.dtype,
                                      device=cost.inv_sigma.device)
            self.scalar("Predict/step_cost", cost.state_cost(state_b)[0])
            if hasattr(cost, "dist"):
                dist = cost.dist(state_b)
                if isinstance(dist, dict):
                    for k, v in dist.items():
                        self.scalar(f"Predict/dist_{k}", v)
                else:
                    self.scalar("Predict/dist", np.linalg.norm(_np(dist)))

    def save_graph(self, text: str):
        """Keep the text of the program a solve runs (``MPPI.dump_hlo``):
        the graph-dump analogue of observer_base.py:84-93."""
        with open(os.path.join(self.logdir, "solve_hlo.txt"), "w") as f:
            f.write(text)

    def close(self):
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
        self._jsonl.flush()
        self._jsonl.close()
