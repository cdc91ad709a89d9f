"""Counts of the learned AUV family (``nn_auv``): a sample-step is the
force u + eps, the 16 features normalised, the ReLU MLP, the delta
denormalised and added, the quaternion's renormalisation, the quaternion
state cost and the action cost's terms.

The work is of two kinds, run by two pipes of the H100 that can overlap:

- the MLP's multiply-adds, 2 fan_in fan_out a layer and sample-step
  (unpadded: 5,952 at 16 -> 3 x 32 -> 13), at the dense TF32 tensor-core
  peak of 495 TFLOP/s (NVIDIA H100 SXM5 datasheet; held here, since
  ``peaks.json`` has the f32 and HBM rates alone);
- the rest (the normals at ``OPS_PER_NORMAL``, the force, the
  normalisation, the ReLUs, the denormalisation, the renormalisation, the
  cost, the action terms, and the weights' pass over the normals) at the
  f32 peak outside the tensor cores.

The least time of a solve is the larger of the two pipes' times and the
bytes' time at HBM's rate. ``solve_work`` returns it as f32-peak-equivalent
operations (that time at ``f32_ops_per_s``), so that ``harness.counts()``,
``solve_roofline.fleet`` and ``mfu.fleet`` read a floor that no
implementation keeping the f32 judge can beat, and no reading can pass
100%. This is not the port's ``roofline.nn_tc_bound`` (the kernel table's
diagnostic), which counts the products as the kernel runs them: padded to
the mma's tiles, three TF32 products each (3xTF32), and the tensor cores'
time added to the CUDA cores' rather than overlapped.
"""

from __future__ import annotations

from .mppi import (BLOCK, PEAKS, STATS, diag, nnz, rollout, scale,
                   two_phase, z_quadratic)

#: dense TF32 tensor-core rate of one H100 SXM5 at 700 W (datasheet)
TF32_OPS_PER_S = 495e12
FEATURES, SDIM, ADIM = 16, 13, 6


def sizes(config: dict) -> list:
    return [FEATURES, *config["model"]["hidden"], SDIM]


def mlp_flops(config: dict) -> int:
    """The MLP's products of one sample-step: 2 fan_in fan_out a layer."""
    s = sizes(config)
    return sum(2 * i * o for i, o in zip(s[:-1], s[1:]))


def dyn_floats(config: dict, tau: int) -> int:
    """A solve's parameters: the weights and biases, the four normalisers,
    then x0, the goal (13 each), the sequence and its cost terms (12 a
    step) and u_half."""
    s = sizes(config)
    params = sum(i * o + o for i, o in zip(s[:-1], s[1:]))
    return params + 2 * FEATURES + 2 * SDIM + 2 * SDIM + 12 * tau + 1


def step_ops(config: dict) -> tuple:
    """(operations of one sample-step outside the MLP's products, of one
    state cost): the force (6 sums and scale z), the normalisation (2 a
    feature), the ReLUs, the denormalisation (2 an output), the delta, the
    renormalisation (4 squares summed, an rsqrt, 4 products), the
    ``static_quat`` cost (as ``auv.py`` counts it) and the action terms."""
    q_ops = 3 + 7 + 2 + 10 + 2 + 6 + 2 * nnz(diag(config["cost"]["Q"])) + 20
    relu = sum(config["model"]["hidden"])
    step = (6 + 2 * nnz(scale(config)) + 2 * FEATURES + relu + 2 * SDIM
            + SDIM + 12 + q_ops + 12 + z_quadratic(config, ADIM))
    return step, q_ops


def solve_work(config: dict, traffic: dict) -> dict:
    """{"ops", "bytes"} of one solve at the cell's K, H and options, the
    operations as f32-peak equivalents of the least time of both pipes."""
    k, tau = int(traffic["k"]), int(traffic["tau"])
    step, q_ops = step_ops(config)
    work = two_phase(k, tau, ADIM, step, q_ops, dyn_floats(config, tau),
                     bool(traffic["normalize"]))
    tc = float(k * tau * mlp_flops(config))
    t_ops = max(tc / TF32_OPS_PER_S, work["ops"] / PEAKS["f32_ops_per_s"])
    return {"ops": t_ops * PEAKS["f32_ops_per_s"], "bytes": work["bytes"]}


def rollout_floor_s(config: dict, traffic: dict) -> float:
    """The least seconds of one solve's rollout (what ``nn_fused_solve``'s
    kernel does), the largest of the tensor cores', the CUDA cores' and
    HBM's time: the costs' pass of a normalised solve (costs and
    stats-only rows written), or the whole solve unnormalised."""
    k, tau = int(traffic["k"]), int(traffic["tau"])
    step, q_ops = step_ops(config)
    normalize = bool(traffic["normalize"])
    nb = -(-k // BLOCK)
    ops = rollout(k, tau, ADIM, step, q_ops, normalize)
    rows = 4.0 * nb * STATS if normalize else 4.0 * nb * (STATS + tau * ADIM)
    n_bytes = (4.0 * dyn_floats(config, tau) + rows
               + (4.0 * k if normalize else 0.0))
    return max(k * tau * mlp_flops(config) / TF32_OPS_PER_S,
               ops / PEAKS["f32_ops_per_s"],
               n_bytes / PEAKS["hbm_bytes_per_s"])

