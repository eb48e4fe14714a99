"""Host-side iterative NTT over plain Python ints.

Used where device round-trips are not worth it: the FRI verifier's
last-codeword degree check (reference left this as a comment,
fri.py:165-166, and used O(n^2) Lagrange instead — docs/faster.md:450-461
prescribes the NTT version we implement here) and small host-side
polynomial work in the slow protocol path.
"""

from __future__ import annotations

from typing import List

from ..field.scalar import P


def _bitrev(values: List[int]) -> List[int]:
    n = len(values)
    bits = n.bit_length() - 1
    out = [0] * n
    for i in range(n):
        r = 0
        x = i
        for _ in range(bits):
            r = (r << 1) | (x & 1)
            x >>= 1
        out[r] = values[i]
    return out


def ntt_ints(values: List[int], omega: int) -> List[int]:
    """Evaluations of the polynomial with coefficients ``values`` at powers
    of ``omega`` (an n-th root of unity), natural order."""
    n = len(values)
    assert n & (n - 1) == 0
    if n == 1:
        return list(values)
    x = _bitrev(values)
    m = 1
    while m < n:
        w_m = pow(omega, n // (2 * m), P)
        for start in range(0, n, 2 * m):
            w = 1
            for j in range(m):
                u = x[start + j]
                t = w * x[start + j + m] % P
                x[start + j] = (u + t) % P
                x[start + j + m] = (u - t) % P
                w = w * w_m % P
        m *= 2
    return x


def intt_ints(values: List[int], omega: int) -> List[int]:
    """Inverse NTT (coefficients from evaluations), including 1/n scaling."""
    n = len(values)
    if n == 1:
        return list(values)
    omega_inv = pow(omega, P - 2, P)
    n_inv = pow(n, P - 2, P)
    out = ntt_ints(values, omega_inv)
    return [v * n_inv % P for v in out]


def host_zerofier(points: List[int]) -> List[int]:
    """Coefficients of the monic polynomial vanishing on ``points``.

    Plain-int O(n^2) accumulation — for small domains this beats shipping a
    product tree of many distinct shapes to the device (each shape is a
    fresh XLA compile); the device tree (ops/ntt.py:zerofier) takes over for
    large domains.
    """
    coeffs = [1]
    for pt in points:
        nxt = [0] * (len(coeffs) + 1)
        for i, c in enumerate(coeffs):
            nxt[i + 1] = (nxt[i + 1] + c) % P
            nxt[i] = (nxt[i] - c * pt) % P
        coeffs = nxt
    return coeffs
