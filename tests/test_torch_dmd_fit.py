"""The f32 DMDc refit of the port (models/dmd.py ``DMDModel.fit``) on
rank-deficient snapshots, against the JAX package's f32 fit: the one
trajectory segment that ``reg`` guards (three state components constant,
one action component zero), with numpy's f64 ridge solution as the
yardstick. The port's full-rank fit must stand no farther from it than
JAX's f32 damped-SVD fit, within 2x."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_tf_tpu.models.dmd import DMDModel as JDMDModel
from mppi_tf_tpu_torch.models.dmd import DMDModel

N, SDIM, ADIM = 200, 6, 3
#: how far the port's f32 A may stand from the f64 ridge A, as a multiple
#: of JAX's f32 A's distance from it
RATIO = 2.0


def _segment(seed: int):
    """One trajectory segment: X[:, :3] constant, U[:, 2] = 0, and the
    successors of a random LTI model."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, SDIM))
    X[:, :3] = rng.normal(size=3)
    U = rng.normal(size=(N, ADIM))
    U[:, 2] = 0.0
    A = np.eye(SDIM) + 0.1 * rng.normal(size=(SDIM, SDIM))
    B = rng.normal(size=(SDIM, ADIM))
    Xn = X @ A.T + U @ B.T
    return X, U, Xn


def _ridge_f64(X, U, Xn, reg: float) -> np.ndarray:
    """G = [A B] of min |Omega G^T - Xn|^2 + reg |G|^2 in f64, by least
    squares on the stacked [Omega; sqrt(reg) I] (no normal equations)."""
    omega = np.concatenate([X, U], axis=1)
    d = omega.shape[1]
    m = np.concatenate([omega, np.sqrt(reg) * np.eye(d)])
    y = np.concatenate([Xn, np.zeros((d, SDIM))])
    return np.linalg.lstsq(m, y, rcond=None)[0].T


@pytest.mark.parametrize("reg", [1e-9, 1e-8])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_f32_fit_tracks_the_f64_ridge_as_jax(seed, reg):
    X, U, Xn = _segment(seed)
    # both f32 fits read the same f32-rounded data
    X32, U32, Xn32 = (a.astype(np.float32) for a in (X, U, Xn))
    ridge_a = _ridge_f64(*(a.astype(np.float64) for a in (X32, U32, Xn32)),
                         reg)[:, :SDIM]
    got = DMDModel(SDIM, ADIM, reg=reg, dtype=torch.float32).fit(
        torch.as_tensor(X32), torch.as_tensor(U32), torch.as_tensor(Xn32))
    want = JDMDModel(SDIM, ADIM, reg=reg, dtype=jnp.float32).fit(
        X32, U32, Xn32)
    assert got["A"].dtype == torch.float32
    err_port = np.abs(got["A"].double().numpy() - ridge_a).max()
    err_jax = np.abs(np.asarray(want["A"], np.float64) - ridge_a).max()
    print(f"seed {seed} reg {reg:g}: port {err_port:.3e}, jax {err_jax:.3e}")
    assert err_port <= RATIO * err_jax, (err_port, err_jax)
