"""Build the CUDA sources with ``nvcc`` at first use and bind them with ctypes.

Every ``.cu`` under ``csrc/`` is compiled to an object by its own ``nvcc``,
all started together (the ``*_bf16.cu`` and ``*_bfp.cu`` units rebuild a
source at another block compute type, see ``mppi_common.cuh``), and the objects are linked into one shared library
with a plain C interface, so the build compiles no PyTorch headers. The
library goes to ``mppi_tf_tpu_torch/_build/`` under a name that carries a
hash of every ``.cu`` and ``.cuh`` source and the flags, so an edited
source or header never loads a stale build. ``-Xptxas -v`` output
(registers, shared memory, spills per kernel) is kept beside the library;
``sass_counts`` reads the built machine code back with ``cuobjdump``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from .. import tracing
from .errors import KernelLaunchError

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_D = ctypes.c_double
# the antithetic half, (seed, solve) as 32-bit words, then the solve index's
# device address or null (mppi_common.cuh Seeds)
_SEEDS = [_U, _U, _U, _U, _U, _P]
# k, tau, scheduled
_SOLVE = [_I, _I, _I]
# the kernels with a vehicle axis take the fleet's n before the stream
_N = [_I]
_SIGNATURES = {
    "pm_noise_dump": [_P, _I, _I, *_SEEDS, _P],
    # the point-mass solves take (sdim, adim, cost, structure) first and
    # add dynamic_ab after scheduled; the unnormalised solve takes the
    # normals a sample it holds (pm_mppi.held_normals) after the vehicles
    "pm_fused_solve": [_I, _I, _I, _I, _P, _P, _P, _P, *_SOLVE, _I,
                       *_SEEDS, *_N, _I, _P],
    "pm_fused_costs": [_I, _I, _I, _I, _P, _P, _P, _P, _P, *_SOLVE, _I,
                       *_SEEDS, *_N, _P],
    "mppi_weights": [_P, _P, _P, _P, _I, _I, *_SEEDS, *_N, _P],
    # (n_z, out[2]): phase B's blocks an SM and the rule's groups
    "mppi_weights_occupancy": [_I, _P],
    "pm_merge": [_P, _I, _I, _P, _P, *_N, _P],
    # an empty kernel: the launch floor chip_smoke.py times pm_merge against
    "pm_empty": [_P],
    # the AUV solves take (rk, cost, structure) first
    "auv_fused_solve": [_I, _I, _I, _P, _P, _P, _P, *_SOLVE, *_SEEDS, *_N,
                        _P],
    "auv_fused_costs": [_I, _I, _I, _P, _P, _P, _P, _P, *_SOLVE, *_SEEDS,
                        *_N, _P],
    "auv_dyn_size": [_I],
    # the NN solves take (n1, n2, n3) first, the weight segment before the
    # solves' rows
    "nn_fused_solve": [_I, _I, _I, _P, _P, _P, _P, _P, *_SOLVE, *_SEEDS,
                       *_N, _P],
    "nn_fused_costs": [_I, _I, _I, _P, _P, _P, _P, _P, _P, *_SOLVE,
                       *_SEEDS, *_N, _P],
    # (sdim, adim, cost, structure, mode, dynamic_ab, tau, held, out[2]),
    # (rk, cost, structure, mode, tau, out[2]) and (n1, n2, n3, mode, tau,
    # out[2]): blocks an SM and samples a thread of a solve kernel
    "pm_occupancy": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # out[3]: the card's shared memory a block (opt-in), an SM and
    # reserved a block, in bytes
    "pm_smem_limits": [_P],
    "auv_occupancy": [_I, _I, _I, _I, _I, _P],
    "nn_occupancy": [_I, _I, _I, _I, _I, _P],
    # the ceilings' microbenchmarks (csrc/roofline.cu, roofline.py):
    # (out, blocks, iters, ...) and the stream's (in, n4, out, blocks)
    "roofline_threads": [],
    "roofline_chains": [],
    "roofline_fma": [_P, _I, _I, ctypes.c_float, _P],
    "roofline_expf": [_P, _I, _I, _P],
    "roofline_bm": [_P, _I, _I, _U, _P],
    "roofline_stream": [_P, ctypes.c_longlong, _P, _I, _P],
    # the plants' steps (csrc/plant.cu, kernels/plant.py): (x, u, out,
    # consts, n, rk, substeps, dt, dt / 2, dt / 6, f64) and (x, u, out, n,
    # n_dof, u_stride, substeps, 1 / m, dt, f64)
    "auv_plant": [_P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _I, _P],
    "pm_plant": [_P, _P, _P, _I, _I, _I, _I, _D, _D, _I, _P],
}
# the bf16 builds of the sources (suffix _bf16, every kernel but pm_merge)
# and the NN kernel's bf16-products build (suffix _bfp) take the same
# arguments as their f32 entry points
_SIGNATURES.update(
    {f"{name}_bf16": _SIGNATURES[name] for name in (
        "pm_noise_dump", "pm_fused_solve", "pm_fused_costs", "mppi_weights",
        "mppi_weights_occupancy",
        "auv_fused_solve", "auv_fused_costs", "nn_fused_solve",
        "nn_fused_costs", "pm_occupancy", "auv_occupancy", "nn_occupancy")}
    | {f"{name}_bfp": _SIGNATURES[name]
       for name in ("nn_fused_solve", "nn_fused_costs", "nn_occupancy")})

_lib = None
#: the nvcc builds of the library in this process (set-up a later run of
#: the same sources skips)
library_builds = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelLaunchError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "cannot be built")
    return path


def sources() -> list:
    """The translation units of the library: every .cu under csrc/."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmppi_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact build exists; returns its path."""
    global library_builds
    out = library_path()
    if out.exists():
        return out
    with tracing.span("mppi.library.build"):
        _compile(out)
    library_builds += 1
    return out


def _compile(out: Path) -> None:
    """Build the library at ``out``: every source by its own nvcc, then
    one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, failed = [], []
    for src, proc in zip(sources(), procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err[-4000:]}")
    if failed:
        raise KernelLaunchError("nvcc failed: " + "\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise KernelLaunchError(
            f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
    out.with_suffix(".ptxas.txt").write_text("".join(logs))
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, once per process."""
    global _lib
    if _lib is None:
        with tracing.span("mppi.library.load"):
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


def _cuobjdump():
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return path if os.path.exists(path) else None


def sass_counts(path=None):
    """Per-kernel opcode counts of the machine code of the built library
    (or of the library at ``path``), from ``cuobjdump -sass``: {mangled
    kernel name: {opcode with its modifiers: count}}; None where
    ``cuobjdump`` is missing."""
    tool = _cuobjdump()
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(path or build())],
                         capture_output=True, text=True, check=True).stdout
    return parse_sass(out)


def parse_sass(text: str) -> dict:
    """{function: {opcode: count}} from ``cuobjdump -sass`` output; an
    opcode keeps its modifiers (``HFMA2.BF16_V2``), a guard predicate
    (``@P0``, ``@!PT``) is dropped."""
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                     r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)", line)
        if m and cur is not None:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return counts
