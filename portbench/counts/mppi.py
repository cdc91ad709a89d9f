"""Frozen counts of the work of an MPPI solve and of a plant period.

The operations and bytes are worked out from a configuration's shapes and
constants and a cell's K, H and options: the same work whatever kernel
implements it. The operations of a sample-step follow the model's and the
cost's arithmetic with the nonzeros of the configuration's matrices (a
multiply-add counts 2, an acos 10, an rsqrt 1); a standard normal counts
``OPS_PER_NORMAL`` (Philox4x32-10 and Box-Muller). On an H100 a normal
issues about 136 operations, so a bound built on 32 is a floor the card
cannot reach; the count is kept as defined so that readings stay
comparable. The bytes are the solve's parameters read and its partial
results written (a row of block sums every 256 samples). A normalised
solve needs the costs' minimum and maximum before its weights, so it
counts two passes over the normals, the cheaper way to have each twice.

``point_mass.py`` and ``auv.py`` count each model family's work (a
configuration names its family's module under ``counts``) with these
shared parts. ``bound_ms`` is the least time at the datasheet peaks of
``peaks.json``: the larger of the operations at the f32 rate and the
bytes at HBM's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

#: Philox4x32-10 is 98 integer ops per 4 words (10 rounds of 2 mul-hi,
#: 2 mul-lo, 4 xor; 9 key bumps of 2 adds); Box-Muller ~15 per pair
OPS_PER_NORMAL = 98 / 4 + 15 / 2
#: samples a block of the program's solves reduces to one row
BLOCK = 256
#: leading statistics of a row (m, l, cost min, max, sum, pad x3)
STATS = 8
PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def nnz(a) -> int:
    return int(np.count_nonzero(a))


def diag(v) -> np.ndarray:
    a = np.asarray(v, np.float64)
    return np.diag(a) if a.ndim == 1 else a


def scale(config: dict) -> np.ndarray:
    c = config["controller"]
    return float(c["upsilon"]) * diag(c["sigma_diag"])


def z_quadratic(config: dict, adim: int) -> int:
    """Operations of the z^T Mz z term, which vanishes at upsilon 1."""
    c = config["controller"]
    if float(c["upsilon"]) == 1.0:
        return 0
    sigma = diag(c["sigma_diag"])
    sc = scale(config)
    mz = sc.T @ np.linalg.inv(sigma) @ sc
    return 2 * nnz(mz) + 2 * adim + 2


def rollout(k, tau, adim, step, q_ops, costs_only) -> float:
    n_normals = k * tau * adim
    if costs_only:
        ops = k * (tau * step + q_ops + 1)
    else:
        ops = k * (tau * step + q_ops + 6) + 2 * n_normals
    return float(ops + n_normals * OPS_PER_NORMAL)


def weights_ops(k: int, n_z: int) -> float:
    """The weights of a normalised solve: the bounded exponent (4 a
    sample), a pass over the normals and the w * z sums (2 a normal)."""
    return float(k * 4 + k * n_z * (2 + OPS_PER_NORMAL))


def bound_ms(ops: float, n_bytes: float) -> tuple:
    """(least ms at the datasheet peaks, "operations" or "bytes")."""
    t_o = ops / PEAKS["f32_ops_per_s"]
    t_b = n_bytes / PEAKS["hbm_bytes_per_s"]
    return max(t_o, t_b) * 1e3, ("bytes" if t_b > t_o else "operations")


def two_phase(k: int, tau: int, adim: int, step: int, q_ops: int,
              dyn: int, normalize: bool) -> dict:
    """{"ops", "bytes"} of one solve whose sample-step costs ``step`` and
    state cost ``q_ops`` operations, over parameters of ``dyn`` floats:
    one pass (rollout, softmax, w * z) or, normalised, the costs' pass and
    the weights' pass."""
    n_z = tau * adim
    nb = -(-k // BLOCK)
    if normalize:
        ops = rollout(k, tau, adim, step, q_ops, True) + weights_ops(k, n_z)
        n_bytes = (4.0 * dyn + 4.0 * k + 4.0 * nb * STATS
                   + 4.0 * k + 8.0 + 4.0 * nb * (STATS + n_z))
    else:
        ops = rollout(k, tau, adim, step, q_ops, False)
        n_bytes = 4.0 * dyn + 4.0 * nb * (STATS + n_z)
    return {"ops": ops, "bytes": n_bytes}
