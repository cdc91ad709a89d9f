"""Dynamic Mode Decomposition (with control) dynamics model.

A discrete linear model x' = A x + B u identified from observed
transitions by DMDc (Proctor, Brunton & Kutz, SIAM J. Appl. Dyn. Syst.
15(1), 2016): stack the snapshot matrix Omega = [X | U] (one transition a
row) and read the operator off its pseudo-inverse,

    [A B] = Xn^T pinv(Omega)^T,  pinv by the rank-r truncated SVD with
    Tikhonov-damped singular values s / (s^2 + reg).

Counterpart of ``mppi_tf_tpu/models/dmd.py``. A and B are the model's
``nn.Parameter`` s, so that ``interop`` carries them as the JAX package's
``{"A", "B"}`` params. ``fit`` is a pure function of the data: it returns
new ``{"A", "B"}`` tensors and leaves the model as it is; the controller
(``controller/dmd.py``) writes them in through ``MPPI.model_params``. On
the kernel path the (A, B) ride in the solve's ``dyn`` array
(``kernels/pm_mppi.FusedLTIMPPI``), so a refit is new data for the same
kernel.

Without truncation (``rank`` None) the damped-SVD solution
V diag(s / (s^2 + reg)) U^T Xn is the ridge solution
(Omega^T Omega + reg I)^-1 Omega^T Xn, and ``fit`` computes it by a
Householder QR of the stacked [Omega; sqrt(reg) I]: without forming
Omega^T Omega (so the condition number is not squared), and without the
host sync of ``torch.linalg.svd`` on the card, so that the on-device loop
(``envs/mjx_env.py``) captures the refit into a CUDA graph. Only a
truncated fit (``rank`` set) takes the SVD.
"""

from __future__ import annotations

import math

from typing import Optional

import numpy as np
import torch
from torch import nn

from .base import ModelBase


class DMDModel(ModelBase):
    """Discrete linear model x' = A x + B u identified by DMDc.

    ``rank``: truncate the snapshot SVD to this rank (None: full rank).
    ``reg``: Tikhonov damping of the singular values. The prior before the
    first fit is ``init_A`` / ``init_B`` (default identity A, zero B: hold
    the state).
    """

    def __init__(self, state_dim: int, action_dim: int, dt: float = 0.1,
                 rank: Optional[int] = None, reg: float = 1e-9,
                 init_A=None, init_B=None, name: str = "dmd_model",
                 act_max=None, act_min=None, dtype=torch.float32,
                 device=None):
        super().__init__(state_dim, action_dim, dt=dt, name=name,
                         act_max=act_max, act_min=act_min, dtype=dtype,
                         device=device)
        if rank is not None and not (0 < int(rank) <= state_dim + action_dim):
            raise ValueError(
                f"rank must be in [1, sDim+aDim={state_dim + action_dim}], "
                f"got {rank}")
        self._rank = None if rank is None else int(rank)
        self._reg = float(reg)
        A = (np.eye(state_dim) if init_A is None
             else np.array(init_A, np.float64))
        B = (np.zeros((state_dim, action_dim)) if init_B is None
             else np.array(init_B, np.float64))
        if A.shape != (state_dim, state_dim):
            raise ValueError(f"init_A must be [{state_dim},{state_dim}], "
                             f"got {A.shape}")
        if B.shape != (state_dim, action_dim):
            raise ValueError(f"init_B must be [{state_dim},{action_dim}], "
                             f"got {B.shape}")
        self.A = nn.Parameter(torch.as_tensor(A, dtype=dtype, device=device))
        self.B = nn.Parameter(torch.as_tensor(B, dtype=dtype, device=device))
        self._configured = {"A": A, "B": B}

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return x @ self.A.T + u @ self.B.T

    def _as(self, a) -> torch.Tensor:
        """``a`` in the model's dtype, on its own device (a host array on
        the CPU)."""
        if isinstance(a, torch.Tensor):
            return a.detach().to(self.dtype)
        return torch.as_tensor(np.asarray(a), dtype=self.dtype)

    @torch.no_grad()
    def fit(self, X, U, Xn) -> dict:
        """Identify (A, B) from transitions by DMDc: the ridge least
        squares by QR at full rank, the truncated SVD at ``rank``.

        X: [n, sDim] states, U: [n, aDim] actions, Xn: [n, sDim] successor
        states (the replay buffer's layout). Runs in the model's dtype on
        the device of the inputs; returns {"A", "B"} and leaves the model
        as it is. At full rank it neither syncs nor allocates on the host.
        """
        X, U, Xn = self._as(X), self._as(U), self._as(Xn)
        sdim, adim = self._state_dim, self._action_dim
        if X.ndim != 2 or X.shape[1] != sdim:
            raise ValueError(f"X must be [n, {sdim}], got {tuple(X.shape)}")
        if U.ndim != 2 or U.shape[1] != adim:
            raise ValueError(f"U must be [n, {adim}], got {tuple(U.shape)}")
        if Xn.shape != X.shape:
            raise ValueError(f"Xn {tuple(Xn.shape)} must match X "
                             f"{tuple(X.shape)}")
        omega = torch.cat([X, U], dim=1)                 # [n, s+a]
        g = (self._ridge(omega, Xn) if self._rank is None
             else self._truncated(omega, Xn))            # G = [A B]
        return {"A": g[:, :sdim], "B": g[:, sdim:]}

    def _truncated(self, omega, Xn) -> torch.Tensor:
        """G from the rank-truncated SVD: G^T = V s^-1 U^T Xn with the
        damped 1/s."""
        u_svd, s, vt = torch.linalg.svd(omega, full_matrices=False)
        u_svd, s, vt = (u_svd[:, :self._rank], s[:self._rank],
                        vt[:self._rank])
        s_inv = s / (s * s + self._reg)
        return ((vt.T * s_inv) @ (u_svd.T @ Xn)).T

    def _ridge(self, omega, Xn) -> torch.Tensor:
        """G from the ridge least squares: d = sDim + aDim Householder
        reflections of M = [Omega; sqrt(reg) I] ([n + d, d], applied to
        [Xn; 0] too), then R G^T = Q^T [Xn; 0] by ``solve_triangular``."""
        sdim = self._state_dim
        d = omega.shape[1]
        eye = torch.eye(d, dtype=omega.dtype, device=omega.device)
        m = torch.cat([omega, math.sqrt(self._reg) * eye])
        y = torch.cat([Xn, Xn.new_zeros(d, sdim)])
        for j in range(d):
            x = m[j:, j]
            norm = torch.linalg.vector_norm(x)
            v = x.clone()
            v[0] = v[0] + torch.where(x[0] >= 0, norm, -norm)
            beta = 2.0 / (v @ v)
            m[j:, j:] -= (beta * v)[:, None] * (v @ m[j:, j:])[None, :]
            y[j:] -= (beta * v)[:, None] * (v @ y[j:])[None, :]
        return torch.linalg.solve_triangular(torch.triu(m[:d]), y[:d],
                                             upper=True).T

    @property
    def rank(self):
        """The SVD truncation, or None (full rank: ``fit`` takes the QR)."""
        return self._rank

    def fit_from_buffer(self, rb) -> dict:
        """``fit`` over everything in a ``learning.ReplayBuffer``, on the
        CPU where the buffer lives, with the snapshot matrices zero-padded
        to the buffer's capacity (one shape at every fill level, as in the
        JAX package). Zero rows are exact no-ops for the least squares:
        they add nothing to Omega^T Omega or Omega^T Xn."""
        tr = rb.get_all_transitions()
        pad = ((0, rb.capacity - tr["obs"].shape[0]), (0, 0))
        return self.fit(*(np.pad(tr[key], pad)
                          for key in ("obs", "act", "next_obs")))
