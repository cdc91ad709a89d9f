"""Build the CUDA sources with ``nvcc`` at first use and bind them with ctypes.

The shared library has a plain C interface, so the build compiles no
PyTorch headers. It goes to ``mppi_tf_tpu_torch/_build/`` under a name
that carries a hash of the sources and flags, so a stale build is never
loaded. ``-Xptxas -v`` output (registers, shared memory, spills per
kernel) is kept beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from .errors import KernelLaunchError

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pm_mppi.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_SIGNATURES = {
    "pm_noise_dump": [_P, _I, _I, _U, _U, _U, _U, _P],
    "pm_fused_solve": [_I, _I, _P, _P, _P, _P, _I, _I, _U, _U, _U, _U, _P],
    "pm_merge": [_P, _I, _I, _P, _P, _P],
}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelLaunchError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpm_mppi_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact build exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelLaunchError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pm_error_string.argtypes = [ctypes.c_int]
        lib.pm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(code: int) -> str:
    return f"{code} ({load_library().pm_error_string(code).decode()})"


def ptxas_report() -> list:
    """Per-kernel registers, shared memory and spills of this build."""
    build()
    log = library_path().with_suffix(".ptxas.txt")
    if not log.exists():
        raise KernelLaunchError(f"no ptxas log at {log}")
    return parse_ptxas(log.read_text())


def parse_ptxas(text: str) -> list:
    """Rows of (kernel, registers, static_smem, stack, spills) from the
    ``-Xptxas -v`` output of nvcc."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(s.group(1)) if s else 0
    return rows
