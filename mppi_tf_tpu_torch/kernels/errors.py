"""Dedicated exceptions for the kernel layer."""


class KernelUnsupportedError(TypeError):
    """Raised for a model/cost/option combination that no ported kernel
    supports. Subclasses TypeError, as in the JAX package, so that an
    eligibility probe never swallows a genuine TypeError."""


class KernelLaunchError(RuntimeError):
    """Raised when a CUDA kernel fails to build or to launch."""
