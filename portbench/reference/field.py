"""The field p = 1 + 407 * 2^119 over Python integers, and the few
polynomial operations the verifier needs."""

from __future__ import annotations

from typing import List, Sequence

P = 1 + 407 * (1 << 119)
# generator of the subgroup of order 2^119 (stark-anatomy algebra.py)
GENERATOR = 85408008396924667383611388730472331217
TWO_ADICITY = 119


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, P - 2, P)


def sample(data: bytes) -> int:
    """Bytes to a field element: big-endian accumulation, reduced mod p."""
    acc = 0
    for b in data:
        acc = (acc << 8) ^ b
    return acc % P


def primitive_root(n: int) -> int:
    """A primitive n-th root of unity, n a power of two up to 2^119, by
    squaring the generator."""
    if n & (n - 1) or not 1 <= n <= 1 << TWO_ADICITY:
        raise ValueError(f"no primitive root of order {n}")
    root, order = GENERATOR, 1 << TWO_ADICITY
    while order != n:
        root = root * root % P
        order //= 2
    return root


def interpolate(xs: Sequence[int], ys: Sequence[int]) -> List[int]:
    """Coefficients (lowest first) of the polynomial of degree < len(xs)
    through the points, by Lagrange's formula."""
    coeffs = [0] * len(xs)
    for j, (xj, yj) in enumerate(zip(xs, ys)):
        basis, denom = [1], 1
        for m, xm in enumerate(xs):
            if m == j:
                continue
            basis = [(a - xm * b) % P for a, b in zip([0] + basis, basis + [0])]
            denom = denom * (xj - xm) % P
        scale = yj * inv(denom) % P
        coeffs = [(c + scale * b) % P for c, b in zip(coeffs, basis)]
    return coeffs


def evaluate(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def dft(values: Sequence[int], omega: int) -> List[int]:
    """sum_j values[j] * omega^(jk) for every k, len(values) a power of two
    and omega of that order: the radix-2 recursion."""
    n = len(values)
    if n == 1:
        return list(values)
    even = dft(values[0::2], omega * omega % P)
    odd = dft(values[1::2], omega * omega % P)
    out = [0] * n
    w = 1
    for k in range(n // 2):
        t = w * odd[k] % P
        out[k] = (even[k] + t) % P
        out[k + n // 2] = (even[k] - t) % P
        w = w * omega % P
    return out


def high_coefficients_zero(values: Sequence[int], omega: int, degree: int) -> bool:
    """Whether the polynomial with values[i] at omega^i has no coefficient
    above ``degree`` (the coefficients are the inverse DFT's, up to the
    factor 1/n)."""
    return not any(dft(values, inv(omega))[degree + 1:])
