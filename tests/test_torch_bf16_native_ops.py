"""The premise of the bf16 kernels' native arithmetic, on the CPU.

The pair builds of the AUV and NN kernels (csrc/mppi_common.cuh,
MPPI_BF16_PAIRS) compute every rollout op with Hopper's add.rn, sub.rn and
mul.rn.bf16x2, which round the exact result once to bf16. Their plain
versions, and the kernels' earlier form, compute the op in f32 and round
that to bf16. The two agree bit for bit: a product of two bf16 values is
exact in f32 (16 significant bits), and a sum rounded first to 24 bits and
then to 8 is innocuous double rounding (24 >= 2 * 8 + 2). Here both are
held against the exact result (``fractions.Fraction``) rounded to the
nearest bf16, ties to even, over seeded operands: ties, subnormals,
overflow to +-inf, signed zeros and operands 2**-40 apart. One more case
shows why the kernels never fuse: a single-rounded fma gives other bits
than a multiply and an add.
"""

import zlib
from fractions import Fraction

import numpy as np
import pytest
import torch

# bf16: 8 significant bits, exponents -126..127, subnormals down to 2**-133
_P, _EMIN, _EMAX = 8, -126, 127
_OVERFLOW = Fraction(2) ** (_EMAX + 1)


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (ties to even), as f32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _round_exact(q: Fraction, zero_sign: float) -> np.float32:
    """The exact value q rounded once to bf16, ties to even; an exact zero
    takes ``zero_sign``'s sign (IEEE 754 for the op)."""
    if q == 0:
        return np.float32(np.copysign(0.0, zero_sign))
    sign, m = (-1 if q < 0 else 1), abs(q)
    e = m.numerator.bit_length() - m.denominator.bit_length()
    if Fraction(2) ** e > m:
        e -= 1
    ulp = Fraction(2) ** (max(e, _EMIN) - (_P - 1))
    n, rem = divmod(m, ulp)
    if rem > ulp / 2 or (rem == ulp / 2 and n % 2 == 1):
        n += 1
    r = n * ulp
    if r >= _OVERFLOW:
        return np.float32(sign * np.inf)
    return np.float32(sign * float(r))


def _exact(op: str, a: np.float32, b: np.float32) -> np.float32:
    fa, fb = Fraction(float(a)), Fraction(float(b))
    if op == "mul":
        zero_sign = np.copysign(1.0, a) * np.copysign(1.0, b)
        return _round_exact(fa * fb, zero_sign)
    fb = fb if op == "add" else -fb
    sb = np.copysign(1.0, b) * (1.0 if op == "add" else -1.0)
    # an exact zero sum is +0 under round-to-nearest unless both are -0
    zero_sign = -1.0 if (np.copysign(1.0, a) < 0 and sb < 0) else 1.0
    return _round_exact(fa + fb, zero_sign)


def _f32_then_round(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore", invalid="ignore"):
        f = {"add": a + b, "sub": a - b, "mul": a * b}[op]
    return _bf16(f)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _random_bf16(rng, n: int, exp_lo: int, exp_hi: int) -> np.ndarray:
    """n bf16 values of random sign and significand, exponents in
    [exp_lo, exp_hi] (below -126 the subnormal's bits that bf16 keeps)."""
    sig = 1.0 + rng.integers(0, 128, n) / 128.0
    sgn = rng.choice([-1.0, 1.0], n)
    return _bf16(sgn * np.ldexp(sig, rng.integers(exp_lo, exp_hi + 1, n)))


def _operands(case: str, op: str):
    rng = np.random.default_rng(zlib.crc32(f"{case}/{op}".encode()))
    n = 1500
    if case == "ties":
        # exact results halfway between two bf16 values: for sums b is a
        # half ulp of a (either sign), for products pairs found by search
        if op == "mul":
            a = _random_bf16(rng, 200_000, -3, 3)
            b = _random_bf16(rng, 200_000, -3, 3)
            p = a.astype(np.float64) * b.astype(np.float64)
            mant, _ = np.frexp(np.abs(p))
            frac = mant * 2**_P
            keep = frac - np.floor(frac) == 0.5
            return a[keep][:n], b[keep][:n]
        # a moved by half its ulp away from zero, or toward it where a is
        # not a power of two (below one the ulp halves: no tie there)
        a = _random_bf16(rng, n, -20, 20)
        mant, e = np.frexp(np.abs(a))
        away = np.where(mant == 0.5, 1.0, rng.choice([-1.0, 1.0], n))
        step = np.sign(a) * away * np.ldexp(1.0, e - 1 - _P)
        b = (step if op == "add" else -step).astype(np.float32)
        return a, b
    if case == "subnormals":
        # results below 2**-126, where bf16 keeps fewer bits
        if op == "mul":
            return (_random_bf16(rng, n, -80, -50),
                    _random_bf16(rng, n, -80, -70))
        a = _random_bf16(rng, n, -133, -125)
        return a, _random_bf16(rng, n, -133, -125)
    if case == "overflow":
        # results at and past the largest bf16, (2 - 2**-7) 2**127
        big = np.float32(np.ldexp(2.0 - 2.0**-7, 127))
        if op == "mul":
            return (_random_bf16(rng, n, 60, 127),
                    _random_bf16(rng, n, 0, 70))
        a = _random_bf16(rng, n, 120, 127)
        b = _random_bf16(rng, n, 110, 127)
        if op == "sub":
            b = -b
        a[:4] = big
        b[:4] = [np.ldexp(1.0, 119), np.ldexp(1.0, 120), big, -big]
        return a, b
    if case == "signed_zeros":
        # +-0 against +-0 and against values, and x - x
        z = np.array([0.0, -0.0], np.float32)
        x = _random_bf16(rng, n, -30, 30)
        a = np.concatenate([np.repeat(z, 2), z.repeat(n // 4), x[: n // 2]])
        b = np.concatenate([np.tile(z, 2), x[: n // 2],
                            x[: n // 2] if op == "sub" else -x[: n // 2]])
        return a.astype(np.float32), b.astype(np.float32)[: a.size]
    if case == "apart_2m40":
        # operands 2**-40 apart (a and a + 2**-40 near 2**-33, where both
        # are bf16 values), and operands whose ratio is 2**-40 (the smaller
        # one far below the larger one's rounding)
        a = _random_bf16(rng, n, -33, -33)
        b = (a + np.sign(a) * np.float32(2.0**-40)).astype(np.float32)
        assert np.array_equal(_bf16(b), b)
        c = _random_bf16(rng, n, -5, 5)
        d = (c * np.float32(2.0**-40) * rng.choice([-1.0, 1.0], n)).astype(
            np.float32)
        return np.concatenate([a, c]), np.concatenate([b, d])
    # random: bf16 values of every exponent
    return _random_bf16(rng, n, -133, 127), _random_bf16(rng, n, -133, 127)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("case", ["ties", "subnormals", "overflow",
                                  "signed_zeros", "apart_2m40", "random"])
def test_f32_op_then_round_is_the_exact_bf16_op(case, op):
    a, b = _operands(case, op)
    assert a.size >= 100 and np.array_equal(_bf16(a), a) and np.array_equal(
        _bf16(b), b), "operands must be bf16 values"
    got = _f32_then_round(op, a, b)
    want = np.array([_exact(op, x, y) for x, y in zip(a, b)], np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    bad = np.flatnonzero(_bits(got)[~nan] != _bits(want)[~nan])
    assert bad.size == 0, (case, op, a[~nan][bad[:5]], b[~nan][bad[:5]],
                           got[~nan][bad[:5]], want[~nan][bad[:5]])
    if case == "ties":
        # every operand pair here is a tie (the round goes to even)
        exact = [Fraction(float(x)) * Fraction(float(y)) if op == "mul" else
                 Fraction(float(x)) + (1 if op == "add" else -1)
                 * Fraction(float(y)) for x, y in zip(a, b)]
        assert all(Fraction(float(w)) != q for w, q in zip(want, exact))
    if case == "overflow":
        assert np.isinf(want).any() and np.isfinite(want).any()
    if case == "subnormals":
        tiny = np.abs(want[np.isfinite(want)]) < 2.0**-126
        assert tiny.sum() > a.size // 4
    if case == "signed_zeros":
        zeros = want == 0
        assert np.signbit(want[zeros]).any() and (~np.signbit(
            want[zeros])).any()


def test_fused_multiply_add_rounds_otherwise():
    """fma(a, b, c) rounds a b + c once; the kernels' a b then + c rounds
    twice. With a = b = 1 + 2**-7 and c = -(1 + 2**-6): a b = 1 + 2**-6 +
    2**-14 rounds to 1 + 2**-6, so the pair gives 0 and the fma 2**-14.
    That is why the kernels use mul.rn and add.rn (never fma.rn.bf16x2,
    and never a mul without .rn that ptxas could contract)."""
    a = b = np.float32(1.0 + 2.0**-7)
    c = np.float32(-(1.0 + 2.0**-6))
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    fused = _round_exact(exact, 1.0)
    product = _exact("mul", a, b)
    unfused = _exact("add", product, c)
    assert fused == np.float32(2.0**-14)
    assert unfused == 0.0 and fused != unfused
    # and the f32 route the plain versions take gives the unfused bits
    assert _f32_then_round("add", _f32_then_round("mul", a, b), c) == unfused
