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
kernel's per-step noise layout is not copied. The MLP weights and the X/Y
normalisers are runtime data, the weight segment at the head of ``dyn``
(``pack_dyn``), so a weight update reaches the kernel with no rebuild.
Source: ``csrc/nn_mppi.cu``.

Fleets: a fleet's solve is one launch of each kernel over all its
vehicles (``FusedNNMPPI.fleet_axis``): the weight segment once, shared by
the vehicles, and a row a vehicle (state, goal, sequence, action-cost
terms), vehicle v drawing solve s n + v, so that the launch equals n
one-vehicle launches bit for bit (``mppi_common.cuh``, fleets). The
segment is packed once a solve, from the live parameters, by one gather
(``pack_weights``, counted in ``weight_packs``).

The normalisers are not folded into the first layer, as the TPU kernel
folds them (W1 / x_std, ``mppi_tf_tpu/kernels/nn_mppi.py:498-509``): a
feature that is constant over the learner's buffer has x_std = 1e-8, its
folded weights are 1e8 W1, and the first layer's f32 sum cancels. Every
build normalises the features in f32 as the XLA route does,
(f - x_mean) / x_std, and denormalises the output as y y_std + y_mean
(``models/nn.py``), which the port is held against (ROADMAP §3).

Two more builds of that source:

- ``compute_dtype="bfloat16"``, the ``*_bf16`` kernels (the JAX kernel's
  bf16 blocks, :148-149, :191-325): the weights and biases, x0, useq and
  the normals rounded to bf16; the force u_t + c_t (scale z_t), every MLP
  chain acc + w h (each product and sum rounded), the ReLU and the state
  update in bf16; the normalisation of the features and of the output in
  f32, each rounded to bf16; the renormalisation's rsqrt, the
  ``StaticQuatCost`` (against the unrounded goal) and the cost sum in f32,
  the z terms bf16 values added to it;
- a model whose ``compute_dtype`` is bf16 at ``compute_dtype="float32"``,
  the ``*_bfp`` kernels: bf16 products with f32 accumulation (bf16
  ``mma.sync`` on the tensor cores), as the JAX
  XLA path computes that model (``models/nn.py::mlp_apply``), not as the
  JAX kernel does, which ignores the model's compute_dtype (ROADMAP §3).
  The normalised features are rounded, the weights are packed rounded,
  each hidden output is rounded as the next layer's input.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ._launch import check, launch, on_card, solve_words, split64
from .auv_mppi import _quat_cost
from .errors import KernelUnsupportedError
from .pm_mppi import (BLOCK, STATS, TwoPhaseSolve, _sched_block,
                      bf16_dot, block_partials,
                      check_compute_dtype, cost_partials, entry, fleet_dims,
                      n_vehicles, per_vehicle, round_bf16, round_bf16_np,
                      sched_factors, solve_noise, variant_args)

SDIM, ADIM = 13, 6
#: network input: the 10 state features x[3:13] and the 6 actions
FEATURES = SDIM - 3 + ADIM
#: hidden widths the CUDA kernel is instantiated for
SUPPORTED_HIDDEN = ((32, 32, 32), (8, 8))
#: weight segments packed in this process (``FusedNNMPPI.pack_weights``;
#: ``tracing.counters()["nn_weight_packs"]``)
weight_packs = 0


def _round4(n: int) -> int:
    return (n + 3) & ~3


class NNDyn:
    """Layout of the per-solve array ``dyn`` (csrc/nn_mppi.cu ``Topo``):
    each layer as W^T rows [fan_out, fan_in] and its biases, the block
    padded to a multiple of 4 floats (16-byte aligned for the kernel's
    float4 loads), the normalisers x_mean, x_std, y_mean and y_std, padded
    (``norm``): the weight segment, its first ``weights`` floats; then the
    solve's row, x0, goal, useq, rhs_z and u_half; a scheduled solve
    appends the tau factors c_t. ``row`` is the row's length (a fleet's
    rows are [n, row] over one segment)."""

    def __init__(self, tau: int, sizes, scheduled: bool = False):
        self.sizes = tuple(int(s) for s in sizes)
        self.layers = []                 # (w_at, b_at, fan_in, fan_out)
        off = 0
        for fan_in, fan_out in zip(self.sizes[:-1], self.sizes[1:]):
            self.layers.append((off, off + fan_out * fan_in, fan_in, fan_out))
            off += _round4(fan_out * fan_in + fan_out)
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
        self.row = self.size - self.weights


def segment_index(lay: NNDyn) -> np.ndarray:
    """Where each float of the weight segment comes from in the parameters
    laid end to end (each layer's w [fan_in, fan_out] and b, then x_mean,
    x_std, y_mean, y_std, then a zero that the pads read)."""
    src = np.full(lay.weights, -1, np.int64)
    at = 0
    for w_at, b_at, fan_in, fan_out in lay.layers:
        # W^T[o, i] = w[i, o]
        src[w_at:b_at] = (at + np.arange(fan_in * fan_out)
                          .reshape(fan_in, fan_out).T.ravel())
        at += fan_in * fan_out
        src[b_at:b_at + fan_out] = at + np.arange(fan_out)
        at += fan_out
    n_norm = 2 * lay.sizes[0] + 2 * lay.sizes[-1]
    src[lay.norm:lay.norm + n_norm] = at + np.arange(n_norm)
    src[src < 0] = at + n_norm
    return src


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
        return NNDyn(tau, self.sizes, self.scheduled)

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

def _normalisers(dyn: torch.Tensor, lay: NNDyn) -> tuple:
    """(x_mean, x_std, y_mean, y_std) from ``dyn``'s normaliser block."""
    nf, ns = lay.sizes[0], lay.sizes[-1]
    return tuple(dyn[lay.norm + o:lay.norm + o + n] for o, n in (
        (0, nf), (nf, nf), (2 * nf, ns), (2 * nf + ns, ns)))


def sample_costs_plain(consts: NnConsts, dyn: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """Per-sample rollout costs [k] in the kernel's algebra: the MLP of
    ``NNAUVModel.step`` between the normalisation of its features and the
    denormalisation of its output, and the ``StaticQuatCost`` over
    eps = c_t scale @ z, with Sigma^-1, u and the schedule folded into
    dyn; at bf16 ``_sample_costs_bf16``. The bf16-products build rounds the
    normalised features and each hidden output to bf16 (its weights come
    rounded in ``dyn``)."""
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
    x_mean, x_std, y_mean, y_std = _normalisers(dyn, lay)
    x = dyn[lay.x0:lay.goal].expand(k, SDIM)
    cost = torch.zeros(k, dtype=dyn.dtype, device=dyn.device)
    for t in range(tau):
        zt = z[t].T                                     # [k, 6]
        h = torch.cat([x[:, 3:], useq[t] + (ct[t] * zt) @ scale.T], dim=-1)
        h = (h - x_mean) / x_std
        if bfp:
            h = round_bf16(h)
        for w, b in layers[:-1]:
            h = torch.relu(h @ w + b)
            if bfp:
                h = round_bf16(h)
        y = h @ layers[-1][0] + layers[-1][1]
        x = x + (y * y_std + y_mean)
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
    Val = bf16x2): bf16 state columns, the features normalised in f32 and
    rounded, each layer's chains run over its inputs in order for all
    outputs at once, the output denormalised in f32 and rounded, the f32
    rsqrt and ``StaticQuatCost`` on the widened state, the z terms as bf16
    values summed in f32."""
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
    x_mean, x_std, y_mean, y_std = _normalisers(d, lay)

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
        h = r((h.float() - x_mean) / x_std)
        for li, (w, b) in enumerate(layers):
            acc = b.expand(k, -1)
            for i in range(w.shape[0]):
                acc = acc + h[:, i:i + 1] * w[i]
            h = torch.relu(acc) if li < len(layers) - 1 else acc
        y = r(h.float() * y_std + y_mean)
        x = [xi + y[:, i] for i, xi in enumerate(x)]
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


def _check_inputs(consts, dyn, z, k, tau, weights):
    """(kernel widths, segment address, rows address, vehicle axis) of a
    launch: one vehicle's whole ``dyn`` [size] (its segment and row), or
    rows [row] / [n, row] over the segment ``weights``."""
    args = _hidden_args(consts)
    lay = consts.layout(tau)
    if weights is None:
        check(dyn, "dyn", (lay.size,))
        lead = ()
        w_at = dyn.data_ptr()
        rows_at = w_at + 4 * lay.weights
    else:
        check(weights, "weights", (lay.weights,))
        lead = fleet_dims(dyn, 1)
        check(dyn, "dyn", (*lead, lay.row))
        w_at, rows_at = weights.data_ptr(), dyn.data_ptr()
    if z is not None:
        check(z, "z", (*lead, tau, ADIM, k))
    return args, w_at, rows_at, lead


def _plain(fn, dyn, solve, z, weights):
    """A wrapper's plain version ``fn(solve, dyn, z)`` over one vehicle's
    whole dyn, or each vehicle's segment and row (``per_vehicle``)."""
    if weights is None:
        return fn(solve, dyn, z)
    if dyn.dim() == 1:
        return fn(solve, torch.cat([weights, dyn]), z)
    return per_vehicle(lambda s, d, zv: fn(s, torch.cat([weights, d]), zv),
                       dyn.shape[0], solve, dyn, z)


def nn_fused_solve(consts: NnConsts, dyn: torch.Tensor, k: int, tau: int,
                   seed: int = 0, solve: int = 0, z=None,
                   weights=None) -> torch.Tensor:
    """Fused MLP rollout + block softmax partials [n_blocks, STATS + tau*6];
    ``z`` (f32 [tau, 6, k]) injects the normals in place of the Philox
    stream of (seed, solve). ``dyn``: one vehicle's [NNDyn.size]; or, with
    the weight segment ``weights`` [NNDyn.weights], a fleet's rows
    [n, NNDyn.row] (z [n, tau, 6, k]) in one launch, vehicle v drawing
    solve solve * n + v: partials [n, n_blocks, ...]."""
    if not on_card(dyn, z, weights):
        return _plain(lambda s, d, zv: fused_solve_plain(
            consts, d, k, tau, seed, s, zv), dyn, solve, z, weights)
    widths, w_at, rows_at, lead = _check_inputs(consts, dyn, z, k, tau,
                                                weights)
    partials = torch.empty((*lead, -(-k // BLOCK), STATS + tau * ADIM),
                           dtype=torch.float32, device=dyn.device)
    launch(consts.entry("nn_fused_solve"), dyn.device, *widths,
           consts.packed.ctypes.data, w_at, rows_at,
           None if z is None else z.data_ptr(), partials.data_ptr(), k, tau,
           *variant_args(consts, k), *split64(seed),
           *solve_words(solve, dyn.device, n_vehicles(lead)),
           n_vehicles(lead))
    return partials


def nn_fused_costs(consts: NnConsts, dyn: torch.Tensor, k: int, tau: int,
                   seed: int = 0, solve: int = 0, z=None, weights=None):
    """Phase A: per-sample costs [k] and stats-only rows [n_blocks, STATS]
    (a fleet's rows over ``weights``, as ``nn_fused_solve``: [n, k] and
    [n, n_blocks, STATS] from one launch)."""
    if not on_card(dyn, z, weights):
        return _plain(lambda s, d, zv: fused_costs_plain(
            consts, d, k, tau, seed, s, zv), dyn, solve, z, weights)
    widths, w_at, rows_at, lead = _check_inputs(consts, dyn, z, k, tau,
                                                weights)
    costs = torch.empty((*lead, k), dtype=torch.float32, device=dyn.device)
    partials = torch.empty((*lead, -(-k // BLOCK), STATS),
                           dtype=torch.float32, device=dyn.device)
    launch(consts.entry("nn_fused_costs"), dyn.device, *widths,
           consts.packed.ctypes.data, w_at, rows_at,
           None if z is None else z.data_ptr(), costs.data_ptr(),
           partials.data_ptr(), k, tau, *variant_args(consts, k),
           *split64(seed),
           *solve_words(solve, dyn.device, n_vehicles(lead)),
           n_vehicles(lead))
    return costs, partials


# ---------------------------------------------------------------------------
# solve object
# ---------------------------------------------------------------------------

class FusedNNMPPI(TwoPhaseSolve):
    """Fused solve for MPPI over NNAUVModel + StaticQuatCost: packs ``dyn``
    (the MLP weights and normalisers, the state, the live goal and the
    nominal sequence's action-cost terms), runs ``nn_fused_solve`` + ``pm_merge``,
    or the two phases ``nn_fused_costs`` and ``mppi_weights``, and un-folds
    the weighted normals to action units. A fleet runs every phase as one
    launch over its vehicles, on one weight segment (``fleet_axis``).

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
        self._index = torch.as_tensor(
            segment_index(self.consts.layout(self.tau)), device=model.device)

    fleet_axis = True

    def pack_weights(self) -> torch.Tensor:
        """The weight segment ([NNDyn.weights], the model's dtype): the
        live weights (rounded to bf16 for the bf16-products build) and
        biases as W^T rows, then the normalisers, padded; one gather of
        the parameters laid end to end."""
        global weight_packs
        with tracing.span("mppi.solve.pack.weights"):
            m = self.model
            parts = []
            for layer in m.net:
                w = layer.w.detach()
                if self.consts.bf16_products:
                    w = round_bf16(w)
                parts += [w.reshape(-1), layer.b.detach()]
            parts += [m.x_mean, m.x_std, m.y_mean, m.y_std]
            flat = torch.cat(parts + [parts[-1].new_zeros(1)])
            weight_packs += 1
            return flat[self._index]

    def _rows(self, x0, useq, cp, lead: tuple) -> torch.Tensor:
        """The solves' rows ([*lead, NNDyn.row]): the state, goal, nominal
        sequence, its action-cost terms and the schedule, of one vehicle
        (``lead`` ()) or of a fleet's (lead (n,), goals from ``cp``)."""
        dtype = self.model.dtype
        useq = useq.to(dtype).reshape(*lead, self.tau, ADIM)
        rhs_z, u_half = self._action_terms(useq)
        goal = self.cost.goal if cp is None else cp["goal"]

        def row(t):   # a shared entry, repeated a vehicle
            return t.reshape(-1).expand(*lead, t.numel())

        return torch.cat([
            x0.to(dtype).reshape(*lead, SDIM), goal.reshape(*lead, SDIM),
            useq.reshape(*lead, -1), rhs_z.reshape(*lead, -1),
            u_half.reshape(*lead, 1), *map(row, self._sched_tail())], dim=-1)

    def pack_dyn(self, x0: torch.Tensor, useq: torch.Tensor, cp=None):
        """One vehicle's ``dyn`` array ([NNDyn.size], the model's dtype):
        the weight segment (``pack_weights``) and the solve's row; a
        fleet's states [n, 13], sequences [n, tau, 6] and stacked cost
        params ``cp`` give (segment, rows [n, NNDyn.row])."""
        lead = tuple(x0.shape[:-1]) if x0.dim() == 2 else ()
        weights = self.pack_weights()
        rows = self._rows(x0, useq, cp, lead)
        return (weights, rows) if lead else torch.cat([weights, rows])

    def _template_args(self, mode: int) -> tuple:
        """<N1, N2, N3, MODE> of nn_fused_solve_kernel."""
        return (*_hidden_args(self.consts), mode)

    def _fused(self, dyn, seed, solve, z):
        weights, rows = dyn if isinstance(dyn, tuple) else (None, dyn)
        return nn_fused_solve(self.consts, rows, self.k, self.tau, seed=seed,
                              solve=solve, z=z, weights=weights)

    def _costs(self, dyn, seed, solve, z):
        weights, rows = dyn if isinstance(dyn, tuple) else (None, dyn)
        return nn_fused_costs(self.consts, rows, self.k, self.tau, seed=seed,
                              solve=solve, z=z, weights=weights)
