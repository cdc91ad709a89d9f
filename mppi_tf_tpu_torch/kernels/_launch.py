"""What every kernel wrapper shares: the device test, input checks, the
launch through the ctypes library and the launch counts.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Each launch adds one to
``launch_counts[name]``, and nothing else does. A call made while the
stream is being captured into a CUDA graph launches nothing: it adds one
to ``captured_counts[name]`` instead, and the code that replays the graph
adds its launches (``count_replays``).
"""

from __future__ import annotations

import torch

from .errors import KernelLaunchError

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
#: the bf16 block-compute builds (suffix _bf16: every entry point but
#: pm_merge) and the NN kernel's bf16-products build (suffix _bfp)
KERNELS.update(
    {f"{e}_bf16": k.replace("_kernel", "_bf16_kernel")
     for e, k in KERNELS.items() if e != "pm_merge"}
    | {f"{e}_bfp": k.replace("_kernel", "_bfp_kernel")
       for e, k in KERNELS.items() if e.startswith("nn_")})

#: the other __global__ functions an entry point launches: pm_merge runs
#: stats-only rows (n_z = 0) through a kernel of their own
EXTRA_KERNELS = {"pm_merge": ("pm_merge_stats_kernel",)}

launch_counts = dict.fromkeys(KERNELS, 0)
#: kernel nodes recorded into CUDA graphs, by entry point
captured_counts = dict.fromkeys(KERNELS, 0)


def kernel_symbol(entry: str, args=()) -> str:
    """The part of the mangled (Itanium) name that ptxas reports for the
    instantiation of ``entry``'s kernel at integer template ``args``:
    ``pm_fused_solve_kernelILi6ELi3ELi0ELi0E`` for <6, 3, 0, 0>."""
    sym = KERNELS[entry]
    return sym + "I" + "".join(f"Li{int(a)}E" for a in args) if args else sym


def kernel_symbols(entry: str, args=()) -> tuple:
    """Every symbol ``entry`` may launch: ``kernel_symbol`` and its
    EXTRA_KERNELS."""
    return (kernel_symbol(entry, args), *EXTRA_KERNELS.get(entry, ()))


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
    """(low, high) 32-bit words of a 64-bit seed or solve index (an int,
    or a one-element tensor on the CPU)."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v & 0xFFFFFFFF, v >> 32


def solve_words(solve, device) -> tuple:
    """(s_lo, s_hi, address) of a kernel's solve index: an int by value
    (address None), or a one-element int64 tensor on ``device`` that the
    kernel reads when it draws (words 0): what a replayed CUDA graph needs,
    whose by-value arguments are frozen at capture."""
    if not isinstance(solve, torch.Tensor):
        return (*split64(solve), None)
    if solve.dtype != torch.int64 or solve.numel() != 1:
        raise ValueError(f"a solve index tensor must hold one int64, got "
                         f"{solve.dtype} {tuple(solve.shape)}")
    if solve.device != torch.device(device):
        raise ValueError(f"the solve index lies on {solve.device}, the "
                         f"kernel runs on {device}")
    return 0, 0, solve.data_ptr()


def launch(name: str, device, *args) -> None:
    """Launch C entry point ``name`` on the current stream of ``device``."""
    from . import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise KernelLaunchError(f"{name} failed: {_build.error_string(rc)}")
    if torch.cuda.is_current_stream_capturing():
        captured_counts[name] += 1
    else:
        launch_counts[name] += 1


def count_replays(nodes: dict, replays: int) -> None:
    """Add the launches of ``replays`` replays of a graph whose capture
    recorded ``nodes`` ({entry point: kernel nodes})."""
    for name, n in nodes.items():
        launch_counts[name] += n * replays
