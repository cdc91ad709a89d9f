"""ctypes binding of the native C++ MPPI core: the float64 golden model.

The port's own copy of the JAX package's ``native/src/mppi_core.cpp``
(byte for byte, ``src/mppi_core.cpp``), the counterpart of the reference's
whole C++ implementation (src/controller_base.cpp, src/model_base.cpp,
src/cost_base.cpp): the softmax update law and the point-mass rollout and
solve over samples in f64. At first use it is compiled with ``g++`` into
``mppi_tf_tpu_torch/_build/`` under a name that carries a hash of the
source and the flags, so an edited source never loads a stale build, and
a failed build raises (no older library is loaded in its place). It is
built without ``-fopenmp``, which the JAX package's Makefile passes: the
H100 machine's g++ has no OpenMP runtime, and the one parallel loop
(``mppi_pm_rollout``, over samples) computes each sample alone, so the
serial build gives the OpenMP build's bits. The API is the JAX package's ``native/core.py``:
``available``, ``update``, ``pm_rollout``, ``pm_solve`` on numpy f64
arrays. The tests hold the port's plain solve and the JAX package's core
against it; ``chip_smoke.py`` holds the card's kernels against it. The
C++ demo and unit test of the same source stay with the JAX package
(its native Makefile's ``test`` and ``demo``). Imports no torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "src" / "mppi_core.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmppicore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the core unless this exact build exists; returns its path.
    Raises ``OSError`` without a C++ compiler or on a failed build."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found: the native MPPI core cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.so.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed ({proc.returncode}):\n"
                      f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)   # atomic: builds running at once agree
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the core, once per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    d = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    i64, dbl, c_int = ctypes.c_int64, ctypes.c_double, ctypes.c_int
    lib.mppi_update.argtypes = [d, d, i64, i64, i64, dbl, c_int, d, d]
    lib.mppi_pm_rollout.argtypes = [d] * 8 + [i64] * 4 + [dbl] * 3 + [d]
    lib.mppi_pm_solve.argtypes = ([d] * 8 + [i64] * 4 + [dbl] * 3 + [c_int]
                                  + [d] * 3)
    for fn in (lib.mppi_update, lib.mppi_pm_rollout, lib.mppi_pm_solve):
        fn.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """Whether the core builds and loads here."""
    try:
        load_library()
        return True
    except OSError:
        return False


def _f64(*arrays):
    return [np.ascontiguousarray(a, np.float64) for a in arrays]


def _stats(s) -> dict:
    return {"beta": s[0], "nabla": s[1], "cost_mean": s[2], "cost_max": s[3]}


def update(costs, eps, lam: float, normalize: bool = False):
    """Softmax update law over rollout costs [k] and noise [k, tau, adim].
    Returns (wnoise [tau, adim], stats dict)."""
    lib = load_library()
    costs, eps = _f64(costs, eps)
    k, tau, adim = eps.shape
    if costs.shape != (k,):
        raise ValueError(f"costs must be [{k}], got {costs.shape}")
    wnoise, stats = np.zeros((tau, adim)), np.zeros(4)
    lib.mppi_update(costs, eps, k, tau, adim, float(lam),
                    int(bool(normalize)), wnoise, stats)
    return wnoise, _stats(stats)


def _pm_args(A, Bm, x0, useq, eps, Q, goal, inv_sigma):
    """The point-mass arguments as contiguous f64, their shapes checked
    (the C side trusts them); returns (arrays, k, tau, sdim, adim)."""
    arrays = _f64(A, Bm, x0, useq, eps, Q, goal, inv_sigma)
    A, Bm, x0, useq, eps, Q, goal, inv_sigma = arrays
    k, tau, adim = eps.shape
    sdim = x0.shape[0]
    want = {"A": (A.shape, (sdim, sdim)), "Bm": (Bm.shape, (sdim, adim)),
            "useq": (useq.shape, (tau, adim)), "Q": (Q.shape, (sdim, sdim)),
            "goal": (goal.shape, (sdim,)),
            "inv_sigma": (inv_sigma.shape, (adim, adim))}
    bad = {n: s for n, (s, w) in want.items() if s != w}
    if k < 1 or bad:
        raise ValueError(f"point-mass shapes (k={k}, sdim={sdim}, "
                         f"adim={adim}) do not fit: {bad}")
    return arrays, k, tau, sdim, adim


def pm_rollout(A, Bm, x0, useq, eps, Q, goal, inv_sigma, lam: float,
               gamma: float, upsilon: float):
    """Point-mass rollout costs [k]."""
    lib = load_library()
    arrays, k, tau, sdim, adim = _pm_args(A, Bm, x0, useq, eps, Q, goal,
                                          inv_sigma)
    costs = np.zeros(k)
    lib.mppi_pm_rollout(*arrays, k, tau, sdim, adim, float(lam),
                        float(gamma), float(upsilon), costs)
    return costs


def pm_solve(A, Bm, x0, useq, eps, Q, goal, inv_sigma, lam: float,
             gamma: float, upsilon: float, normalize: bool = False):
    """One control step. Returns (action [adim], next_useq [tau, adim],
    stats dict); the caller carries next_useq."""
    lib = load_library()
    arrays, k, tau, sdim, adim = _pm_args(A, Bm, x0, useq, eps, Q, goal,
                                          inv_sigma)
    action, next_useq, stats = np.zeros(adim), np.zeros((tau, adim)), \
        np.zeros(4)
    lib.mppi_pm_solve(*arrays, k, tau, sdim, adim, float(lam), float(gamma),
                      float(upsilon), int(bool(normalize)), action,
                      next_useq, stats)
    return action, next_useq, _stats(stats)
