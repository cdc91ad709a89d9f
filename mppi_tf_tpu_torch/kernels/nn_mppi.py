"""Fused learned-dynamics MPPI solve on Hopper: the NNAUVModel MLP rollout
as two CUDA kernels, their plain PyTorch versions, and the solve object.

Replaces the Pallas kernel of ``mppi_tf_tpu/kernels/nn_mppi.py``
(``_nn_pallas``, body ``_make_nn_kernel``, noise ``_fill_noise_steps``) for
``NNAUVModel`` with the ``StaticQuatCost``:

- ``nn_fused_solve`` replaces ``_fused_nn_call`` (mode "fused"): one thread
  per sample rolls x += MLP([x[3:13], useq_t + scale z_t]) (quaternion
  renormalised) over the horizon, sums the cost
  sum_t [q(x_{t+1}) + rhs_z_t . z_t + nc_half z_t^T Mz z_t] + q(x_H) + u_half
  and writes the block's softmax partial row, merged by ``pm_merge``; each
  warp runs the MLP of its 32 samples on the tensor cores (``mma.sync``,
  3xTF32: the f32 products to a few ulps);
- ``nn_fused_costs`` replaces ``_fused_nn_costs`` (mode "costs", phase A
  of the normalized solve): costs[k] and a stats-only row per block.

Phase B (``_fused_nn_weights``) is ``pm_mppi.mppi_weights`` at adim 6, and
the noise is pm_mppi's Philox stream at adim 6: ``pm_noise_dump(seed,
solve, k, tau, 6)`` is exactly what these kernels consume. The TPU
kernel's per-step noise layout is not copied. The MLP weights are runtime
data with the X/Y normalisers folded in on the device (``pack_dyn``), so a
weight update reaches the kernel with no rebuild. Source:
``csrc/nn_mppi.cu``.

Two more builds of that source:

- ``compute_dtype="bfloat16"``, the ``*_bf16`` kernels (the JAX kernel's
  bf16 blocks, :148-149, :191-325): the folded weights and biases, x0,
  useq and the normals rounded to bf16; the force u_t + c_t (scale z_t),
  every MLP chain acc + w h (each product and sum rounded), the ReLU and
  the state update in bf16; the renormalisation's rsqrt, the
  ``StaticQuatCost`` (against the unrounded goal) and the cost sum in f32,
  the z terms bf16 values added to it;
- a model whose ``compute_dtype`` is bf16 at ``compute_dtype="float32"``,
  the ``*_bfp`` kernels: bf16 products with f32 accumulation (bf16
  ``mma.sync`` on the tensor cores), as the JAX
  XLA path computes that model (``models/nn.py::mlp_apply``), not as the
  JAX kernel does, which ignores the model's compute_dtype (ROADMAP §3).
  The normalisers ride unfolded in ``dyn`` (``NNDyn.norm``); the features
  are normalised in f32 and rounded, the weights are packed rounded, each
  hidden output is rounded as the next layer's input.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ._launch import check, launch, on_card, split64
from .auv_mppi import _quat_cost
from .errors import KernelUnsupportedError
from .pm_mppi import (BLOCK, STATS, TwoPhaseSolve, _sched_block,
                      bf16_dot, block_partials,
                      check_compute_dtype, cost_partials, entry,
                      round_bf16, round_bf16_np, sched_factors, solve_noise,
                      variant_args)

SDIM, ADIM = 13, 6
#: network input: the 10 state features x[3:13] and the 6 actions
FEATURES = SDIM - 3 + ADIM
#: hidden widths the CUDA kernel is instantiated for
SUPPORTED_HIDDEN = ((32, 32, 32), (8, 8))


def _round4(n: int) -> int:
    return (n + 3) & ~3


class NNDyn:
    """Layout of the per-solve array ``dyn`` (csrc/nn_mppi.cu ``Topo``):
    each layer as W^T rows [fan_out, fan_in] and its biases, the block
    padded to a multiple of 4 floats (16-byte aligned for the kernel's
    float4 loads), then x0, goal, useq, rhs_z and u_half; a scheduled
    solve appends the tau factors c_t. The bf16-products kernels
    (``bf16_products``) read the normalisers x_mean, x_std, y_mean and
    y_std, padded, between the layers and x0 (``norm``)."""

    def __init__(self, tau: int, sizes, scheduled: bool = False,
                 bf16_products: bool = False):
        self.sizes = tuple(int(s) for s in sizes)
        self.layers = []                 # (w_at, b_at, fan_in, fan_out)
        off = 0
        for fan_in, fan_out in zip(self.sizes[:-1], self.sizes[1:]):
            self.layers.append((off, off + fan_out * fan_in, fan_in, fan_out))
            off += _round4(fan_out * fan_in + fan_out)
        self.norm = None
        if bf16_products:
            self.norm = off
            off += _round4(2 * self.sizes[0] + 2 * self.sizes[-1])
        self.weights = off
        self.x0 = off                    # 13
        self.goal = off + SDIM           # 13
        self.useq = off + 2 * SDIM       # tau*6
        self.rhs_z = self.useq + ADIM * tau
        self.u_half = self.rhs_z + ADIM * tau
        self.size = self.u_half + 1
        self.sched = _sched_block(self, tau, scheduled)


@dataclass
class NnConsts:
    """Solve constants (the JAX kernel's compile-time ``mc``): the layer
    sizes, lam, nc_half = lam (1 - 1/upsilon) / 2, whether the quaternion
    is renormalised, scale = upsilon sigma, Mz = scale^T Sigma^-1 scale and
    the 10x10 cost weight Q; ``scheduled`` and ``antithetic`` are the
    runtime variants (launch arguments); ``compute_dtype`` the block
    compute type, and ``bf16_products`` (at float32) the build for a model
    whose products are bf16."""

    sizes: tuple
    lam: float
    nc_half: float
    renorm: bool
    scale: np.ndarray
    Mz: np.ndarray
    Q: np.ndarray
    scheduled: bool = False
    antithetic: bool = False
    compute_dtype: str = "float32"
    bf16_products: bool = False

    def entry(self, name: str) -> str:
        """The C entry point of ``name`` for this build."""
        return name + "_bfp" if self.bf16_products else entry(
            name, self.compute_dtype)

    def layout(self, tau: int) -> NNDyn:
        return NNDyn(tau, self.sizes, self.scheduled, self.bf16_products)

    @property
    def hidden(self) -> tuple:
        return tuple(self.sizes[1:-1])

    @functools.cached_property
    def packed(self) -> np.ndarray:
        """f32 host array in the order of ``NnConsts`` in nn_mppi.cu; at bf16
        with scale and Mz rounded to bf16."""
        scale, Mz = self.scale, self.Mz
        if self.compute_dtype == "bfloat16":
            scale, Mz = round_bf16_np(scale), round_bf16_np(Mz)
        return np.ascontiguousarray(np.concatenate([
            [self.lam, self.nc_half, float(self.renorm), 0.0],
            scale.ravel(), Mz.ravel(), self.Q.ravel()]).astype(np.float32))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def sample_costs_plain(consts: NnConsts, dyn: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """Per-sample rollout costs [k] in the kernel's algebra: the folded MLP
    of ``NNAUVModel.step`` and the ``StaticQuatCost`` over
    eps = c_t scale @ z, with Sigma^-1, u and the schedule folded into
    dyn; at bf16 ``_sample_costs_bf16``. The bf16-products build rounds the
    normalised features and each hidden output to bf16 (its weights come
    rounded in ``dyn``) and denormalises the output."""
    if consts.compute_dtype == "bfloat16":
        return _sample_costs_bf16(consts, dyn, z)
    tau, _, k = z.shape
    lay = consts.layout(tau)
    ct = sched_factors(dyn, lay, tau)

    def t_(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dyn.dtype,
                               device=dyn.device)

    scale, Mz, Q = t_(consts.scale), t_(consts.Mz), t_(consts.Q)
    layers = [(dyn[w:b].reshape(o, i).T, dyn[b:b + o])
              for w, b, i, o in lay.layers]
    goal = dyn[lay.goal:lay.useq]
    useq = dyn[lay.useq:lay.rhs_z].reshape(tau, ADIM)
    rhs_z = dyn[lay.rhs_z:lay.u_half].reshape(tau, ADIM)

    bfp = consts.bf16_products
    if bfp:
        nf, ns = consts.sizes[0], consts.sizes[-1]
        x_mean, x_std, y_mean, y_std = (
            dyn[lay.norm + o:lay.norm + o + n] for o, n in (
                (0, nf), (nf, nf), (2 * nf, ns), (2 * nf + ns, ns)))
    x = dyn[lay.x0:lay.goal].expand(k, SDIM)
    cost = torch.zeros(k, dtype=dyn.dtype, device=dyn.device)
    for t in range(tau):
        zt = z[t].T                                     # [k, 6]
        h = torch.cat([x[:, 3:], useq[t] + (ct[t] * zt) @ scale.T], dim=-1)
        if bfp:
            h = round_bf16((h - x_mean) / x_std)
        for w, b in layers[:-1]:
            h = torch.relu(h @ w + b)
            if bfp:
                h = round_bf16(h)
        y = h @ layers[-1][0] + layers[-1][1]
        x = x + (y * y_std + y_mean if bfp else y)
        if consts.renorm:
            qn = torch.rsqrt(torch.clamp(torch.sum(
                x[:, 3:7] ** 2, dim=-1, keepdim=True), min=1e-24))
            x = torch.cat([x[:, :3], x[:, 3:7] * qn, x[:, 7:]], dim=-1)
        cost = (cost + _quat_cost(Q, goal, x) + zt @ rhs_z[t]
                + consts.nc_half * ct[t]
                * torch.sum((zt @ Mz.T) * zt, dim=-1))
    return cost + _quat_cost(Q, goal, x) + dyn[lay.u_half]


def _sample_costs_bf16(consts: NnConsts, dyn: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's per-sample costs [k], op for op (nn_mppi.cu at
    Val = bf16x2): bf16 state columns, each layer's chains run over its
    inputs in order for all outputs at once, the f32 rsqrt and
    ``StaticQuatCost`` on the widened state, the z terms as bf16 values
    summed in f32."""
    tau, _, k = z.shape
    lay = consts.layout(tau)
    d = dyn.to(torch.float32)
    dev = d.device

    def r(v):
        return v.to(torch.bfloat16)

    rows = [np.float32(m).astype(float).tolist()
            for m in (consts.scale, consts.Mz)]
    scale, Mz = rows
    Q = torch.as_tensor(np.float32(consts.Q), device=dev)
    layers = [(r(d[w:b]).reshape(o, i).T, r(d[b:b + o]))
              for w, b, i, o in lay.layers]
    goal = d[lay.goal:lay.useq]
    useq = r(d[lay.useq:lay.rhs_z]).reshape(tau, ADIM)
    rhs_z = r(d[lay.rhs_z:lay.u_half]).reshape(tau, ADIM)
    ct = sched_factors(d, lay, tau)
    nc_half = torch.as_tensor(np.float32(consts.nc_half), device=dev)

    def q(x):
        return _quat_cost(Q, goal, torch.stack(x, dim=-1).float())

    zb = r(z.to(torch.float32))
    x = [r(v).expand(k) for v in d[lay.x0:lay.goal].unbind()]
    cost = torch.zeros(k, dtype=torch.float32, device=dev)
    for t in range(tau):
        zt = list(zb[t].unbind())
        c_t = r(torch.as_tensor(ct[t], dtype=torch.float32, device=dev))
        u = [useq[t, i] + c_t * bf16_dot(scale[i], zt) for i in range(ADIM)]
        h = torch.stack(x[3:] + u, dim=-1)                  # [k, 16] bf16
        for li, (w, b) in enumerate(layers):
            acc = b.expand(k, -1)
            for i in range(w.shape[0]):
                acc = acc + h[:, i:i + 1] * w[i]
            h = torch.relu(acc) if li < len(layers) - 1 else acc
        x = [xi + h[:, i] for i, xi in enumerate(x)]
        if consts.renorm:
            s2 = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]
            inv = r(torch.rsqrt(torch.clamp(s2.float(), min=1e-24)))
            x = x[:3] + [xi * inv for xi in x[3:7]] + x[7:]
        cost = cost + q(x)
        quad = None
        for j in range(ADIM):
            cost = cost + (rhs_z[t, j] * zt[j]).float()
            term = zt[j] * bf16_dot(Mz[j], zt)
            quad = term if quad is None else quad + term
        cost = cost + (r(nc_half * ct[t]) * quad).float()
    return (cost + q(x) + d[lay.u_half]).to(dyn.dtype)


def fused_solve_plain(consts: NnConsts, dyn: torch.Tensor, k: int, tau: int,
                      seed: int = 0, solve: int = 0, z=None,
                      block: int = BLOCK) -> torch.Tensor:
    """Plain version of ``nn_fused_solve``: block partials
    [n_blocks, STATS + tau*6]."""
    z = solve_noise(seed, solve, k, tau, ADIM, dyn, z,
                    consts.antithetic, consts.compute_dtype)
    costs = sample_costs_plain(consts, dyn, z)
    return block_partials(costs, z.reshape(tau * ADIM, k), consts.lam, block)


def fused_costs_plain(consts: NnConsts, dyn: torch.Tensor, k: int, tau: int,
                      seed: int = 0, solve: int = 0, z=None,
                      block: int = BLOCK):
    """Plain version of ``nn_fused_costs``: (costs [k], stats-only rows)."""
    z = solve_noise(seed, solve, k, tau, ADIM, dyn, z,
                    consts.antithetic, consts.compute_dtype)
    costs = sample_costs_plain(consts, dyn, z)
    return costs, cost_partials(costs, block)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

def _hidden_args(consts: NnConsts):
    """(n1, n2, n3) of the kernel instance for these widths; raises on a
    topology the kernel is not built for."""
    if consts.hidden not in SUPPORTED_HIDDEN or consts.sizes[0] != FEATURES \
            or consts.sizes[-1] != SDIM:
        raise KernelUnsupportedError(
            f"the NN kernel is built for [{FEATURES}, *hidden, {SDIM}] with "
            f"hidden in {SUPPORTED_HIDDEN}, got sizes {list(consts.sizes)}")
    return (*consts.hidden, 0)[:3]


def _check_inputs(consts, dyn, z, k, tau):
    args = _hidden_args(consts)
    check(dyn, "dyn", (consts.layout(tau).size,))
    if z is not None:
        check(z, "z", (tau, ADIM, k))
    return args


def nn_fused_solve(consts: NnConsts, dyn: torch.Tensor, k: int, tau: int,
                   seed: int = 0, solve: int = 0, z=None) -> torch.Tensor:
    """Fused MLP rollout + block softmax partials [n_blocks, STATS + tau*6];
    ``z`` (f32 [tau, 6, k]) injects the normals in place of the Philox
    stream of (seed, solve)."""
    if not on_card(dyn, z):
        return fused_solve_plain(consts, dyn, k, tau, seed, solve, z)
    widths = _check_inputs(consts, dyn, z, k, tau)
    partials = torch.empty((-(-k // BLOCK), STATS + tau * ADIM),
                           dtype=torch.float32, device=dyn.device)
    launch(consts.entry("nn_fused_solve"), dyn.device, *widths,
           consts.packed.ctypes.data,
           dyn.data_ptr(), None if z is None else z.data_ptr(),
           partials.data_ptr(), k, tau, *variant_args(consts, k),
           *split64(seed), *split64(solve))
    return partials


def nn_fused_costs(consts: NnConsts, dyn: torch.Tensor, k: int, tau: int,
                   seed: int = 0, solve: int = 0, z=None):
    """Phase A: per-sample costs [k] and stats-only rows [n_blocks, STATS]."""
    if not on_card(dyn, z):
        return fused_costs_plain(consts, dyn, k, tau, seed, solve, z)
    widths = _check_inputs(consts, dyn, z, k, tau)
    costs = torch.empty(k, dtype=torch.float32, device=dyn.device)
    partials = torch.empty((-(-k // BLOCK), STATS), dtype=torch.float32,
                           device=dyn.device)
    launch(consts.entry("nn_fused_costs"), dyn.device, *widths,
           consts.packed.ctypes.data,
           dyn.data_ptr(), None if z is None else z.data_ptr(),
           costs.data_ptr(), partials.data_ptr(), k, tau,
           *variant_args(consts, k), *split64(seed), *split64(solve))
    return costs, partials


# ---------------------------------------------------------------------------
# solve object
# ---------------------------------------------------------------------------

def fold_layers(model) -> list:
    """The model's layers as (W [fan_in, fan_out], b) with the X/Y
    normalisers folded into the first and last (JAX
    ``FusedNNMPPI.pack_dyn``): W1' = W1 / x_std, b1' = b1 - (x_mean /
    x_std) W1; W_L' = W_L y_std, b_L' = b_L y_std + y_mean. Torch ops on
    the model's device, no host sync."""
    out = []
    last = len(model.net) - 1
    for i, layer in enumerate(model.net):
        w, b = layer.w.detach(), layer.b.detach()
        if i == 0:
            b = b - (model.x_mean / model.x_std) @ w
            w = w / model.x_std[:, None]
        if i == last:
            w = w * model.y_std[None, :]
            b = b * model.y_std + model.y_mean
        out.append((w, b))
    return out


class FusedNNMPPI(TwoPhaseSolve):
    """Fused solve for MPPI over NNAUVModel + StaticQuatCost: packs ``dyn``
    (the folded MLP weights, the state, the live goal and the nominal
    sequence's action-cost terms), runs ``nn_fused_solve`` + ``pm_merge``,
    or the two phases ``nn_fused_costs`` and ``mppi_weights``, and un-folds
    the weighted normals to action units.

    Counterpart of the JAX package's ``FusedNNMPPI``; ``antithetic`` and
    ``schedule`` are its runtime variants, ``compute_dtype`` ("float32" or
    "bfloat16", the block compute type) its build. A model whose
    ``compute_dtype`` is bf16 runs, at float32, the bf16-products build
    (the JAX XLA path's arithmetic). The kernels are built for the hidden
    widths in ``SUPPORTED_HIDDEN``; on the CPU the f32 plain versions run
    at the model's dtype.
    """

    def __init__(self, model, cost, k: int, tau: int, lam: float,
                 upsilon: float, sigma, antithetic: bool = False,
                 schedule=None, compute_dtype: str = "float32"):
        from ..costs.static import StaticQuatCost
        from ..models.nn import NNAUVModel, NNAUVModelSpeed

        self.compute_dtype = check_compute_dtype(compute_dtype)
        # NNAUVModelSpeed advances the pose analytically: another step
        if not isinstance(model, NNAUVModel) or isinstance(
                model, NNAUVModelSpeed):
            raise KernelUnsupportedError(
                "fused NN kernel supports NNAUVModel only")
        if type(cost) is not StaticQuatCost:
            raise KernelUnsupportedError(
                "fused NN kernel supports StaticQuatCost only")
        if model.get_action_dim() != ADIM:
            raise KernelUnsupportedError(
                "fused NN kernel is specialised to the 6-action AUV")
        if model.device.type != "cpu" and model.dtype != torch.float32:
            raise KernelUnsupportedError(
                f"fused kernel is float32, model is {model.dtype}")
        self.model, self.cost = model, cost
        self.k, self.tau = int(k), int(tau)
        self.sdim, self.adim = SDIM, ADIM
        self.lam, self.upsilon = float(lam), float(upsilon)
        self.gamma = float(cost.gamma)
        sigma = np.asarray(sigma, np.float64)
        scale = self.upsilon * sigma
        inv_sigma = np.linalg.inv(sigma)
        like = {"dtype": model.dtype, "device": model.device}
        self._noise_options(antithetic, schedule, like)
        self.consts = NnConsts(
            sizes=tuple(model.sizes()), lam=self.lam,
            nc_half=0.5 * self.lam * (1.0 - 1.0 / self.upsilon),
            renorm=bool(model.renormalize_quat), scale=scale,
            Mz=scale.T @ inv_sigma @ scale,
            Q=cost.Q.detach().cpu().numpy().astype(np.float64),
            scheduled=self.scheduled, antithetic=self.antithetic,
            compute_dtype=self.compute_dtype,
            bf16_products=(model.compute_dtype is not None
                           and self.compute_dtype == "float32"))
        _hidden_args(self.consts)
        self._scale = torch.as_tensor(scale, **like)
        self._inv_sigma = torch.as_tensor(inv_sigma, **like)

    def pack_dyn(self, x0: torch.Tensor, useq: torch.Tensor) -> torch.Tensor:
        """The per-solve ``dyn`` array ([NNDyn.size], the model's dtype):
        the live weights folded with the normalisers (``fold_layers``; for
        the bf16-products build the weights rounded to bf16 and the
        normalisers after them), then the state, goal, nominal sequence,
        its action-cost terms and the schedule."""
        dtype = self.model.dtype
        useq = useq.to(dtype).reshape(self.tau, ADIM)
        rhs_z, u_half = self._action_terms(useq)
        parts = []
        if self.consts.bf16_products:    # rounded weights, normalisers
            m = self.model
            layers = [(round_bf16(layer.w.detach()), layer.b.detach())
                      for layer in m.net]
            norm = [m.x_mean, m.x_std, m.y_mean, m.y_std]
        else:
            layers, norm = fold_layers(self.model), []
        for w, b in layers:
            n = w.numel() + b.numel()
            parts += [w.T.reshape(-1), b,
                      w.new_zeros(_round4(n) - n)]
        if norm:
            n = sum(v.numel() for v in norm)
            parts += [v.to(dtype).reshape(-1) for v in norm] + [
                norm[0].new_zeros(_round4(n) - n, dtype=dtype)]
        return torch.cat(parts + [
            x0.to(dtype).reshape(SDIM), self.cost.goal.reshape(-1),
            useq.reshape(-1), rhs_z.reshape(-1), u_half.reshape(1),
            *self._sched_tail()])

    def _template_args(self, mode: int) -> tuple:
        """<N1, N2, N3, MODE> of nn_fused_solve_kernel."""
        return (*_hidden_args(self.consts), mode)

    def _fused(self, dyn, seed, solve, z):
        return nn_fused_solve(self.consts, dyn, self.k, self.tau, seed=seed,
                              solve=solve, z=z)

    def _costs(self, dyn, seed, solve, z):
        return nn_fused_costs(self.consts, dyn, self.k, self.tau, seed=seed,
                              solve=solve, z=z)
