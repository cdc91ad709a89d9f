from .blockdiag import block_diag
from .shapes import assert_shape, check_shape

__all__ = ["block_diag", "assert_shape", "check_shape"]
