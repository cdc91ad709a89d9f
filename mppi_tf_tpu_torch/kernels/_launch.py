"""What every kernel wrapper shares: the device test, input checks, the
launch through the ctypes library and the launch counts.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Each launch adds one to
``launch_counts[name]``, and nothing else does.
"""

from __future__ import annotations

import torch

from .errors import KernelLaunchError

launch_counts = {"pm_noise_dump": 0, "pm_fused_solve": 0, "pm_merge": 0,
                 "pm_fused_costs": 0, "mppi_weights": 0,
                 "auv_fused_solve": 0, "auv_fused_costs": 0,
                 "nn_fused_solve": 0, "nn_fused_costs": 0}


#: the __global__ function each entry point launches (the solves' costs
#: mode is the MODE template argument of the same kernel)
KERNELS = {"pm_noise_dump": "pm_noise_dump_kernel",
           "pm_fused_solve": "pm_fused_solve_kernel",
           "pm_fused_costs": "pm_fused_solve_kernel",
           "pm_merge": "pm_merge_kernel",
           "mppi_weights": "mppi_weights_kernel",
           "auv_fused_solve": "auv_fused_solve_kernel",
           "auv_fused_costs": "auv_fused_solve_kernel",
           "nn_fused_solve": "nn_fused_solve_kernel",
           "nn_fused_costs": "nn_fused_solve_kernel"}


def kernel_symbol(entry: str, args=()) -> str:
    """The part of the mangled (Itanium) name that ptxas reports for the
    instantiation of ``entry``'s kernel at integer template ``args``:
    ``pm_fused_solve_kernelILi6ELi3ELi0ELi0E`` for <6, 3, 0, 0>."""
    sym = KERNELS[entry]
    return sym + "I" + "".join(f"Li{int(a)}E" for a in args) if args else sym


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def on_card(*tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors if t is not None}) != 1:
            raise ValueError("all tensors must be on the same CUDA device")
        return True
    raise ValueError(f"tensors must all be on the CPU or all on one CUDA "
                     f"device, got {sorted(kinds)}")


def check(t: torch.Tensor, name: str, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def split64(v: int):
    """(low, high) 32-bit words of a 64-bit seed or solve index."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v & 0xFFFFFFFF, v >> 32


def launch(name: str, device, *args) -> None:
    """Launch C entry point ``name`` on the current stream of ``device``."""
    from . import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise KernelLaunchError(f"{name} failed: {_build.error_string(rc)}")
    launch_counts[name] += 1
