"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Nothing here builds or loads a kernel at import time: ``_build`` compiles
the CUDA sources with ``nvcc`` at the first launch on a CUDA tensor.
"""

from .errors import KernelLaunchError, KernelUnsupportedError

__all__ = ["KernelLaunchError", "KernelUnsupportedError"]
