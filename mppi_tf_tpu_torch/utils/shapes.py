"""Shape-assertion guardrails (reference: scripts/src/misc/utile.py:31-38)."""

from __future__ import annotations


def assert_shape(array, shape) -> bool:
    """Return True iff ``array.shape`` matches ``shape``; -1 is a wildcard.

    ``shape`` is a tuple like ``(-1, 13, 1)`` where -1 matches any size.
    """
    if array is None:
        return False
    ashape = tuple(array.shape)
    if len(ashape) != len(shape):
        return False
    return all(want in (-1, got) for got, want in zip(ashape, shape))


def check_shape(array, shape, name: str = "array") -> None:
    """Raise AssertionError with a helpful message when shape mismatches."""
    if not assert_shape(array, shape):
        raise AssertionError(
            f"{name} has shape {tuple(array.shape)}, expected {tuple(shape)}"
        )
