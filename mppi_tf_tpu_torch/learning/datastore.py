"""ctypes binding of the native C++ transition datastore.

The storage backend of :class:`.replay.ReplayBuffer` (``use_native=True``).
The source is the port's own copy, ``native/src/datastore.cpp``; at first
use it is compiled with ``g++`` into ``mppi_tf_tpu_torch/_build/`` under a
name that carries a hash of the source and the flags, so an edited source
never loads a stale build. The reference counterpart is the C++ DataBase
(include/data_base.hpp, src/data_base.cpp); the JAX package binds the
same ABI (``mppi_tf_tpu/learning/datastore.py``). Imports no torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "src" / "datastore.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmppidata_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the datastore unless this exact build exists; returns its
    path. Raises ``OSError`` without a C++ compiler or on a failed build."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found: the native datastore cannot be built")
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
    """Build (if needed) and load the datastore, once per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.ds_create.restype = ctypes.c_void_p
    lib.ds_create.argtypes = [ctypes.c_int64] * 3
    lib.ds_destroy.argtypes = [ctypes.c_void_p]
    lib.ds_size.restype = ctypes.c_int64
    lib.ds_size.argtypes = [ctypes.c_void_p]
    lib.ds_capacity.restype = ctypes.c_int64
    lib.ds_capacity.argtypes = [ctypes.c_void_p]
    dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.ds_add.argtypes = [ctypes.c_void_p, dptr, dptr, dptr]
    lib.ds_get_all.restype = ctypes.c_int64
    lib.ds_get_all.argtypes = [ctypes.c_void_p, dptr, dptr, dptr,
                               ctypes.c_int64]
    lib.ds_to_csv.restype = ctypes.c_int
    lib.ds_to_csv.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    _lib = lib
    return lib


class NativeDataStore:
    """Owner of one C datastore handle: a ring of ``capacity`` float64
    transitions (obs [s_dim], act [a_dim], next_obs [s_dim])."""

    def __init__(self, capacity: int, s_dim: int, a_dim: int):
        self._lib = load_library()
        self.s_dim = int(s_dim)
        self.a_dim = int(a_dim)
        self._h = self._lib.ds_create(capacity, s_dim, a_dim)
        if not self._h:
            raise ValueError("invalid datastore dimensions")

    def __len__(self) -> int:
        return int(self._lib.ds_size(self._h))

    def add(self, obs, act, next_obs) -> None:
        self._lib.ds_add(self._h,
                         np.ascontiguousarray(obs, np.float64),
                         np.ascontiguousarray(act, np.float64),
                         np.ascontiguousarray(next_obs, np.float64))

    def get_all(self) -> Dict[str, np.ndarray]:
        """Every stored transition, oldest first. The C call bounds its
        copy by the rows given and returns how many it wrote."""
        n = len(self)
        obs = np.empty((n, self.s_dim))
        act = np.empty((n, self.a_dim))
        nxt = np.empty((n, self.s_dim))
        if n:
            wrote = int(self._lib.ds_get_all(self._h, obs, act, nxt, n))
            obs, act, nxt = obs[:wrote], act[:wrote], nxt[:wrote]
        return {"obs": obs, "act": act, "next_obs": nxt}

    def to_csv(self, path: str) -> None:
        """The C++ DataBase CSV layout: a header, then x..., u..., x_next...
        a row at 17 significant digits."""
        if self._lib.ds_to_csv(self._h, os.fsencode(path)) != 0:
            raise OSError(f"csv export failed: {path}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ds_destroy(self._h)
            self._h = None
