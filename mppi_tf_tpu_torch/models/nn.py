"""Learned neural-network dynamics models.

Reference: scripts/src/models/nn_model.py, three families:

- ``NNModel`` (:20-175): a ReLU MLP (3x32 hidden by default) predicting the
  normalized next-state delta from the normalized [state features, action];
- ``NNAUVModel`` (:179-304): the 13-dim quaternion AUV state; the network
  sees [state[3:], action] (position dropped for translation invariance)
  and predicts the full 13-dim delta;
- ``NNAUVModelSpeed`` (:307-588): predicts the 6 velocity deltas only; the
  pose is advanced analytically through the quaternion Jacobian, and the
  inputs use the euler-angle encoding.

The network weights are ``nn.Parameter``s: layer i holds ``w``
[fan_in, fan_out] and ``b`` [fan_out] (the JAX package's layout, so weights
carry across as they are, ``interop.py``); the X/Y normalisers ``x_mean``,
``x_std``, ``y_mean``, ``y_std`` are buffers. Every method updates the
model in place where the JAX package returns a new params pytree.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import quaternion as quat
from .base import ModelBase


class Dense(nn.Module):
    """One layer: y = x @ w + b, w [fan_in, fan_out]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float32, device=None) -> nn.ModuleList:
    """He-initialised ReLU MLP over the layer sizes ``sizes``: w ~ N(0, 1)
    sqrt(2 / fan_in), b = 0, drawn on the CPU from ``generator``."""
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(fan_in, fan_out, generator=generator,
                        dtype=torch.float64) * math.sqrt(2.0 / fan_in)
        layers.append(Dense(w.to(dtype=dtype, device=device),
                            torch.zeros(fan_out, dtype=dtype, device=device)))
    return nn.ModuleList(layers)


def mlp_apply(layers, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """ReLU MLP forward pass, final layer linear. x: [k, in] -> [k, out].

    ``compute_dtype=torch.bfloat16`` rounds each product's operands to
    bf16 and accumulates at x's dtype (the JAX package's
    ``preferred_element_type``; a product of two bf16 values is exact in
    f32). Reference topology: nn_model.py:54-60.
    """
    acc = x.dtype

    def dot(h, w):
        if compute_dtype is None:
            return h @ w
        return h.to(compute_dtype).to(acc) @ w.to(compute_dtype).to(acc)

    h = x
    for layer in layers[:-1]:
        h = torch.relu(dot(h, layer.w) + layer.b)
    return dot(h, layers[-1].w) + layers[-1].b


class NNModel(ModelBase):
    """Generic learned dynamics: an MLP predicting the normalized delta.

    Reference: nn_model.py:20-175. The features are [state, action]; the
    denormalized network output is added to the state.
    """

    #: buffers that carry across with the weights (interop.py)
    param_buffers = ("x_mean", "x_std", "y_mean", "y_std")

    def __init__(self, state_dim: int = 2, action_dim: int = 1,
                 dt: float = 0.1, hidden: Sequence[int] = (32, 32, 32),
                 name: str = "nn_model", act_max=None, act_min=None,
                 seed: int = 0, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__(state_dim, action_dim, dt=dt, name=name,
                         act_max=act_max, act_min=act_min, dtype=dtype,
                         device=device)
        self._hidden = tuple(int(h) for h in hidden)
        self._seed = int(seed)
        # bf16 products on the rollout path (f32 accumulation)
        self.compute_dtype = compute_dtype
        self.net = self.trainable_init(self._seed_generator())
        for name_, fill in (("x_mean", 0.0), ("x_std", 1.0)):
            self.register_buffer(name_, torch.full(
                (self.input_dim(),), fill, dtype=dtype, device=device))
        for name_, fill in (("y_mean", 0.0), ("y_std", 1.0)):
            self.register_buffer(name_, torch.full(
                (self.output_dim(),), fill, dtype=dtype, device=device))

    def _seed_generator(self) -> torch.Generator:
        gen = torch.Generator()
        gen.manual_seed(self._seed)
        return gen

    @property
    def hidden(self) -> tuple:
        return self._hidden

    def sizes(self) -> list:
        """The layer-size chain [in, *hidden, out]."""
        return [self.input_dim(), *self._hidden, self.output_dim()]

    # --- feature/topology hooks (overridden by the AUV variants) --------
    def input_dim(self) -> int:
        return self._state_dim + self._action_dim

    def output_dim(self) -> int:
        return self._state_dim

    def features(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Raw (un-normalized) network input. [k, sDim], [k, aDim] -> [k, in]."""
        return torch.cat([x, u], dim=-1)

    def apply_delta(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """The next state from the denormalized delta (nn_model.py:303-304)."""
        return x + delta

    # --- params ----------------------------------------------------------
    def set_normalization(self, x_mean, x_std, y_mean, y_std) -> None:
        """Write the normalisers in place (the learner's ``stats()``):
        arrays, scalars or tensors on any device."""
        with torch.no_grad():
            for name_, value in (("x_mean", x_mean), ("x_std", x_std),
                                 ("y_mean", y_mean), ("y_std", y_std)):
                buf = getattr(self, name_)
                src = (value.detach() if isinstance(value, torch.Tensor)
                       else torch.as_tensor(np.asarray(value, np.float64)))
                buf.copy_(src.to(buf.dtype).reshape(-1).expand(buf.shape))

    def reset_parameters(self) -> None:
        """The weights of the model's seed and identity normalisers: the
        JAX package's ``init_params``."""
        self.with_trainable(self.trainable_init(self._seed_generator()))
        self.set_normalization(0.0, 1.0, 0.0, 1.0)

    def trainable(self) -> nn.ModuleList:
        """The modules gradients flow through (the network only)."""
        return self.net

    def with_trainable(self, net) -> "NNModel":
        """Copy weights into the network in place: ``net`` is a sequence of
        layers with ``w`` and ``b`` (modules, or mappings of arrays).
        Returns the model."""
        if len(net) != len(self.net):
            raise ValueError(f"{len(net)} layers for a {len(self.net)}-layer "
                             f"network")
        with torch.no_grad():
            for layer, new in zip(self.net, net):
                for attr in ("w", "b"):
                    value = new[attr] if isinstance(new, dict) else getattr(
                        new, attr)
                    p = getattr(layer, attr)
                    p.copy_(torch.as_tensor(value).reshape(p.shape))
        return self

    def trainable_init(self, generator: torch.Generator) -> nn.ModuleList:
        """Fresh He-initialised weights from ``generator`` (reference
        ``copy_model``, scripts/src/model.py:70-78)."""
        return mlp_init(generator, self.sizes(), dtype=self.dtype,
                        device=self.device)

    # --- forward ----------------------------------------------------------
    def normalize_x(self, feats: torch.Tensor) -> torch.Tensor:
        return (feats - self.x_mean) / self.x_std

    def denormalize_x(self, feats_norm: torch.Tensor) -> torch.Tensor:
        """Reference: nn_model.py:299-301."""
        return feats_norm * self.x_std + self.x_mean

    def denormalize_y(self, y_norm: torch.Tensor) -> torch.Tensor:
        """Reference: nn_model.py:295-297."""
        return y_norm * self.y_std + self.y_mean

    def predict_nn(self, feats_norm: torch.Tensor,
                   training: bool = False) -> torch.Tensor:
        """Normalized-space forward pass (nn_model.py:174-175); training
        runs at full precision whatever ``compute_dtype`` says."""
        cd = None if training else self.compute_dtype
        return mlp_apply(self.net, feats_norm, compute_dtype=cd)

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """x_next = apply_delta(x, denorm(net(norm(features(x, u))))).
        Reference: nn_model.py:215-239."""
        feats = self.normalize_x(self.features(x, u))
        delta = self.denormalize_y(self.predict_nn(feats))
        return self.apply_delta(x, delta)

    # --- training-data preparation ----------------------------------------
    def _targets(self, x_t: torch.Tensor, x_t1: torch.Tensor) -> torch.Tensor:
        return x_t1 - x_t

    def prepare_training_data(self, x_t, x_t1, u_t, norm: bool = True):
        """(X, Y) pairs for supervised learning: features and delta targets,
        normalized with ``norm``. Reference: nn_model.py:241-287."""
        X = self.features(x_t, u_t)
        Y = self._targets(x_t, x_t1)
        if norm:
            X = self.normalize_x(X)
            Y = (Y - self.y_mean) / self.y_std
        return X, Y


class NNAUVModel(NNModel):
    """AUV NN model: the 13-dim quaternion state, features [state[3:],
    action] (position dropped), the full 13-dim delta predicted.
    Reference: nn_model.py:179-304.

    Its ``prepare_training_data`` is the base rule: the reference's
    body-frame anchoring (``tFrom = mask * stateT``) cancels in the
    difference, so the target is the plain delta.
    """

    STATE_DIM = 13

    #: renormalise the quaternion block after adding the delta: a
    #: documented deviation from the reference's raw sum (nn_model.py:
    #: 303-304; PARITY.md deviation 6b); False restores the raw algebra
    renormalize_quat: bool = True

    def __init__(self, action_dim: int = 6, dt: float = 0.1,
                 hidden: Sequence[int] = (32, 32, 32),
                 name: str = "auv_nn_model", seed: int = 0, act_max=None,
                 act_min=None, dtype=torch.float32, compute_dtype=None,
                 device=None):
        super().__init__(state_dim=self.STATE_DIM, action_dim=action_dim,
                         dt=dt, hidden=hidden, name=name, seed=seed,
                         act_max=act_max, act_min=act_min, dtype=dtype,
                         compute_dtype=compute_dtype, device=device)

    def input_dim(self) -> int:
        return self.STATE_DIM - 3 + self._action_dim

    def output_dim(self) -> int:
        return self.STATE_DIM

    def features(self, x, u):
        """[state[3:], action]. Reference: nn_model.py:289-293."""
        return torch.cat([x[:, 3:], u], dim=-1)

    def apply_delta(self, x, delta):
        """x + delta, the quaternion renormalised under renormalize_quat."""
        out = x + delta
        if not self.renormalize_quat:
            return out
        return torch.cat([out[:, :3], quat.normalize(out[:, 3:7]),
                          out[:, 7:]], dim=-1)


class NNAUVModelSpeed(NNAUVModel):
    """AUV NN model predicting the velocity deltas only; the pose advances
    analytically through the quaternion Jacobian. Inputs use the euler
    state (12-dim) minus position. Reference: nn_model.py:307-588; the
    pose rates follow AUVModel's convention (PARITY.md deviation 7)."""

    def __init__(self, action_dim: int = 6, dt: float = 0.1,
                 hidden: Sequence[int] = (16, 16, 16),
                 name: str = "auv_nn_speed_model", seed: int = 0,
                 act_max=None, act_min=None, dtype=torch.float32,
                 compute_dtype=None, device=None):
        super().__init__(action_dim=action_dim, dt=dt, hidden=hidden,
                         name=name, seed=seed, act_max=act_max,
                         act_min=act_min, dtype=dtype,
                         compute_dtype=compute_dtype, device=device)

    def input_dim(self) -> int:
        # euler state (12) minus position (3), + action (nn_model.py:349-353)
        return 12 - 3 + self._action_dim

    def output_dim(self) -> int:
        return 6

    def to_euler_state(self, x: torch.Tensor) -> torch.Tensor:
        """13-dim quaternion state -> 12-dim euler state (nn_model.py:564-588)."""
        return torch.cat([x[:, :3], quat.to_euler(x[:, 3:7]), x[:, 7:]],
                         dim=-1)

    def features(self, x, u):
        """[euler_state[3:], action]. Reference: nn_model.py:438-462."""
        return torch.cat([self.to_euler_state(x)[:, 3:], u], dim=-1)

    def apply_delta(self, x, delta):
        """Pose advanced by its rates over dt, delta added to the velocity.
        Reference: nn_model.py:464-471."""
        q, vel = x[:, 3:7], x[:, 7:13]
        pos_dot = torch.einsum("kij,kj->ki", quat.to_rotation_matrix(q),
                               vel[:, :3])
        quat_dot = torch.einsum("kij,kj->ki", quat.attitude_jacobian(q),
                                vel[:, 3:6])
        return torch.cat([x[:, :3] + pos_dot * self._dt,
                          quat.normalize(q + quat_dot * self._dt),
                          vel + delta], dim=-1)

    def _targets(self, x_t, x_t1):
        """The velocity delta only (nn_model.py:384-436)."""
        return x_t1[:, 7:13] - x_t[:, 7:13]
