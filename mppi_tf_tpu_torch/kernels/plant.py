"""The on-device plants' steps on Hopper: two CUDA kernels
(``csrc/plant.cu``) and their plain PyTorch versions.

- ``auv_step(model, x, u, substeps, consts)`` steps ``AUVModel.step`` (rk
  1, 2 or 4, the quaternion renormalised after each step) ``substeps``
  times under the held forces u, for n vehicles [n, 13] x [n, 6];
- ``pm_step(x, u, n_dof, mass, dt, substeps)`` the frictionless point
  mass's exact update on the interleaved state [..., 2 n_dof], in the JAX
  step's order.

Both take the action in the state's dtype (a mix raises, on the CPU as on
the card) and broadcast it over the state's vehicles: one action held by
a whole fleet is a valid input on either device.

On a CPU tensor each runs its plain version: the torch step, ``substeps``
times. On a CUDA tensor in float32 or float64 it launches its kernel once
for all the substeps (one node of a captured period, where the torch step
is ~10 kernels a substep for the point mass and ~190 for the AUV); any
other dtype raises. The kernel replaces no TPU kernel (the JAX plant is
XLA-fused; csrc/plant.cu says why it exists and what bounds it).

The launches count in this module's ``launch_counts`` and
``captured_counts`` (``tracing.counters()``'s ``plant_counts``), apart from
``_launch``'s: those are the solve's named kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.auv import GRAVITY
from ._launch import launch, on_card

ENTRIES = ("auv_plant", "pm_plant")
launch_counts = dict.fromkeys(ENTRIES, 0)
#: kernel nodes recorded into CUDA graphs, by entry point
captured_counts = dict.fromkeys(ENTRIES, 0)

#: offsets of the AUV's constants in the buffer the kernel reads
#: (``kMTot``... in plant.cu): row-major 6x6 matrices, then 3-vectors and
#: scalars
AUV_CONSTS = {"m_tot": 0, "inv_m": 36, "lin_damp": 72, "lin_damp_fwd": 108,
              "quad_damp": 144, "cog": 180, "cob": 183, "weight": 186,
              "buoyancy": 187}
AUV_CONSTS_SIZE = 188
_CARD_DTYPES = (torch.float32, torch.float64)


def _substeps(substeps) -> int:
    n = int(substeps)
    if n < 1:
        raise ValueError(f"substeps must be at least 1, got {substeps}")
    return n


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _same_dtype(x: torch.Tensor, u: torch.Tensor) -> None:
    if u.dtype != x.dtype:
        raise TypeError(f"the action must be in the state's dtype "
                        f"{x.dtype}, got {u.dtype}")


def _card_dtype(x: torch.Tensor) -> None:
    if x.dtype not in _CARD_DTYPES:
        raise TypeError(f"the plant kernels step float32 or float64 states, "
                        f"got {x.dtype}")


# --- the AUV ---------------------------------------------------------------

@torch.no_grad()
def auv_constants(model) -> torch.Tensor:
    """``model``'s constants in the ``AUV_CONSTS`` layout, on its device in
    its dtype, from the tensors ``AUVModel.step`` reads: ``precompute()``'s
    M_tot and M_tot^-1, the damping matrices, cog, cob, and the weight and
    buoyancy as ``restoring_forces`` computes them (the z entries of
    -m g e_z and rho V g e_z)."""
    m_tot, inv_m = model.precompute()
    unit_z = model.unit_z
    weight = (-model.mass * GRAVITY * unit_z)[2:]
    buoyancy = (model.buoyancy * unit_z)[2:]
    return torch.cat([m_tot.reshape(-1), inv_m.reshape(-1),
                      model.lin_damp.reshape(-1),
                      model.lin_damp_fwd.reshape(-1),
                      model.quad_damp.reshape(-1), model.cog, model.cob,
                      weight, buoyancy])


def auv_step_plain(model, x: torch.Tensor, u: torch.Tensor,
                   substeps: int = 1) -> torch.Tensor:
    """``substeps`` calls of ``model.step(x, u)``: x [n, 13], u [n, 6]
    or [1, 6]."""
    _same_dtype(x, u)
    for _ in range(_substeps(substeps)):
        x = model.step(x, u)
    return x


def auv_step(model, x: torch.Tensor, u: torch.Tensor, substeps: int = 1,
             consts: torch.Tensor | None = None) -> torch.Tensor:
    """``substeps`` steps of ``model`` (an ``AUVModel``) at its dt under the
    held forces: x [n, 13], u [n, 6] or [1, 6] -> [n, 13]. On the card one
    launch of ``auv_plant_kernel``, reading ``consts``
    (``auv_constants(model)``, made once before any capture)."""
    if not on_card(x, u):
        return auv_step_plain(model, x, u, substeps)
    n = _substeps(substeps)
    _same_dtype(x, u)
    _card_dtype(x)
    if consts is None:
        raise ValueError("the AUV plant kernel reads the model's constants: "
                         "pass consts=auv_constants(model)")
    if (consts.dtype != x.dtype or consts.device != x.device
            or consts.numel() != AUV_CONSTS_SIZE
            or not consts.is_contiguous()):
        raise ValueError(f"consts must be {AUV_CONSTS_SIZE} contiguous "
                         f"values in {x.dtype} on {x.device}")
    if (x.dim() == 2 and u.dim() == 2 and u.shape[0] == 1
            and x.shape[0] != 1):
        u = u.expand(x.shape[0], -1)
    if x.dim() != 2 or x.shape[1] != 13 or tuple(u.shape) != (x.shape[0], 6):
        raise ValueError(f"the AUV plant steps [n, 13] states under [n, 6] "
                         f"forces, got {tuple(x.shape)} and {tuple(u.shape)}")
    x, u = x.contiguous(), u.contiguous()
    out = torch.empty_like(x)
    dt = model.dt
    launch("auv_plant", x.device, x.data_ptr(), u.data_ptr(),
           out.data_ptr(), consts.data_ptr(), x.shape[0], model.rk, n, dt,
           dt / 2.0, dt / 6.0, int(x.dtype == torch.float64),
           counts=(launch_counts, captured_counts))
    return out


# --- the point mass --------------------------------------------------------

def pm_step_plain(x: torch.Tensor, u: torch.Tensor, n_dof: int, mass: float,
                  dt: float, substeps: int = 1) -> torch.Tensor:
    """``substeps`` exact steps of the point mass: x [..., 2 n_dof]
    interleaved [q0, v0, q1, v1, ...], u [..., >= n_dof] (the JAX package's
    order of operations, mjx_env.py:57-70)."""
    _same_dtype(x, u)
    for _ in range(_substeps(substeps)):
        q, v = x[..., 0::2], x[..., 1::2]
        a = u[..., :n_dof] / mass
        q = q + v * dt + 0.5 * a * dt * dt
        v = v + a * dt
        x = torch.stack([q, v], dim=-1).reshape(x.shape)
    return x


def pm_step(x: torch.Tensor, u: torch.Tensor, n_dof: int, mass: float,
            dt: float, substeps: int = 1) -> torch.Tensor:
    """``pm_step_plain`` on the card as one launch of ``pm_plant_kernel``:
    the torch step's bits (its division by the mass is CUDA's, a product
    with the reciprocal rounded to x's dtype)."""
    if not on_card(x, u):
        return pm_step_plain(x, u, n_dof, mass, dt, substeps)
    n = _substeps(substeps)
    _same_dtype(x, u)
    _card_dtype(x)
    if x.shape[-1] != 2 * n_dof or u.shape[-1] < n_dof:
        raise ValueError(f"the point-mass plant steps [..., {2 * n_dof}] "
                         f"states under [..., >= {n_dof}] forces, got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    # the action broadcast over the state's vehicles, as the torch step
    # broadcasts it
    u = u.expand(*x.shape[:-1], u.shape[-1])
    xb = x.reshape(-1, 2 * n_dof).contiguous()
    ub = u.reshape(-1, u.shape[-1])
    if ub.stride(-1) != 1 or (ub.shape[0] > 1
                              and ub.stride(0) < ub.shape[1]):
        ub = ub.contiguous()
    stride = ub.stride(0) if ub.shape[0] > 1 else ub.shape[1]
    f64 = x.dtype == torch.float64
    inv_m = 1.0 / mass if f64 else float(np.float32(1.0) / np.float32(mass))
    out = torch.empty_like(xb)
    launch("pm_plant", x.device, xb.data_ptr(), ub.data_ptr(),
           out.data_ptr(), xb.shape[0], int(n_dof), stride, n, inv_m,
           float(dt), int(f64), counts=(launch_counts, captured_counts))
    return out.reshape(x.shape)
