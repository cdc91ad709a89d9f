"""Block-diagonal matrix construction (host-side, numpy).

Assembles the LTI system matrices of the point-mass model once on the host
(reference: scripts/src/models/point_mass_model.py:6-25).
"""

from __future__ import annotations

import numpy as np


def block_diag(block: np.ndarray, count: int) -> np.ndarray:
    """Tile ``block`` ``count`` times along the diagonal of a zero matrix.

    block: [h, w] array. Returns [count*h, count*w].
    """
    block = np.asarray(block)
    h, w = block.shape
    out = np.zeros((count * h, count * w), dtype=block.dtype)
    for i in range(count):
        out[i * h:(i + 1) * h, i * w:(i + 1) * w] = block
    return out
