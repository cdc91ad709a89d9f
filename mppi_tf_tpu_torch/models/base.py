"""Dynamics-model protocol (reference: scripts/src/models/model_base.py).

A model is an ``nn.Module`` that holds its own parameters; ``step`` is
batched over the leading axis. The controller only needs ``step``;
``predict`` and ``run_model`` are the reference's parity wrappers
(model_base.py:59-100). ``trainable`` / ``with_trainable`` /
``trainable_init`` are the surface the learner trains through (the JAX
package's ``models/base.py:72-88``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.rollout import rollout_trajectory


class ModelBase(nn.Module):
    """Abstract batched one-step dynamics model."""

    def __init__(self, state_dim: int, action_dim: int, dt: float = 0.1,
                 name: str = "model", act_max=None, act_min=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self._state_dim = int(state_dim)
        self._action_dim = int(action_dim)
        self._dt = float(dt)
        self._name = name
        one = torch.ones(action_dim, dtype=dtype, device=device)

        def limit(v, default):
            if v is None:
                return default
            return torch.as_tensor(v, dtype=dtype, device=device).reshape(
                -1) * one

        self.register_buffer("act_max_", limit(act_max, one))
        self.register_buffer("act_min_", limit(act_min, -one))

        # the configured values of the parameters (``trainable_init``),
        # set by each model that has parameters
        self._configured = {}

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One-step prediction f(x, u). x: [k, sDim], u: [k, aDim] -> [k, sDim].

        Reference: model_base.py:41-57.
        """
        raise NotImplementedError

    # --- trainable surface ------------------------------------------------
    # The reference gives every model an Adam handle and trains whatever
    # variables it holds (model_base.py:30-39; the point-mass mass fit is
    # scripts/test.py:220). For an analytic model the trainable parameters
    # are its physical ones (the point mass's mass, the AUV's mass and
    # inertial, DMD's A and B); NN models override these to expose the
    # network alone (models/nn.py).
    def trainable(self) -> dict:
        """The parameters gradients flow through, by name: every
        ``nn.Parameter`` of the model."""
        return dict(self.named_parameters())

    def with_trainable(self, tr) -> "ModelBase":
        """Copy ``tr`` (tensors or arrays under the names of
        ``trainable()``) into the parameters in place. Returns the model."""
        params = self.trainable()
        if set(tr) != set(params):
            raise KeyError(f"trainable values {sorted(tr)} != the model's "
                           f"{sorted(params)}")
        with torch.no_grad():
            for name, p in params.items():
                v = tr[name]
                src = (v.detach() if isinstance(v, torch.Tensor)
                       else torch.as_tensor(np.asarray(v, np.float64)))
                p.copy_(src.to(p.dtype).reshape(p.shape))
        return self

    def trainable_init(self, generator=None) -> dict:
        """A fresh trainable init for k-fold clones (reference
        ``copy_model``, scripts/src/model.py:70-78): an analytic model is
        deterministic, so the configured values of its parameters (NN
        models draw fresh weights from ``generator``)."""
        del generator
        return {name: torch.as_tensor(v, dtype=self.dtype,
                                      device=self.device)
                for name, v in self._configured.items()}

    def predict(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Single-sample prediction. x: [sDim], u: [aDim] -> [sDim]."""
        return self.step(x[None, :], u[None, :])[0]

    def run_model(self, x0: torch.Tensor, useq: torch.Tensor) -> torch.Tensor:
        """Sequential open-loop rollout, trajectory including x0.

        x0: [sDim] or [k, sDim]; useq: [tau, aDim] or [k, tau, aDim].
        """
        return rollout_trajectory(self.step, x0, useq)

    def get_name(self) -> str:
        return self._name

    def get_state_dim(self) -> int:
        return self._state_dim

    def get_action_dim(self) -> int:
        return self._action_dim

    @property
    def dt(self) -> float:
        return self._dt

    @property
    def dtype(self) -> torch.dtype:
        return self.act_max_.dtype

    @property
    def device(self) -> torch.device:
        return self.act_max_.device

    def max_act(self) -> torch.Tensor:
        return self.act_max_

    def min_act(self) -> torch.Tensor:
        return self.act_min_
