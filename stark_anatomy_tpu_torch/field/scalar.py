"""Scalar (host-side) prime-field arithmetic.

A copy of ``stark_anatomy_tpu/field/scalar.py``: the port imports nothing
from the JAX package.

This is the slow, obviously-correct reference path of the framework: plain
Python integers mod p.  Every device kernel (limb/Montgomery arithmetic,
NTT, Rescue-Prime permutation) is cross-checked against this module.

Capability parity with the reference's ``algebra.py`` (lines 1-120): ``xgcd``, ``FieldElement`` with
operator overloading (including ``^`` as modular exponentiation and the
decimal-string ``__bytes__`` encoding, which is consensus-critical for
Merkle leaf hashing), and ``Field`` with ``main()``, ``generator()``,
``primitive_nth_root(n)`` and ``sample(byte_array)``.
"""

from __future__ import annotations

# The canonical field: p = 1 + 407 * 2^119  (128-bit prime, 2-adicity 119).
P = 1 + 407 * (1 << 119)
# Generator of the 2^119-element multiplicative subgroup of order 2^119
# (reference: algebra.py:100-102).
GENERATOR = 85408008396924667383611388730472331217
TWO_ADICITY = 119


def xgcd(x: int, y: int):
    """Extended Euclid: returns (a, b, g) with a*x + b*y == g == gcd(x, y)."""
    a0, a1 = 1, 0
    b0, b1 = 0, 1
    while y != 0:
        q, r = divmod(x, y)
        x, y = y, r
        a0, a1 = a1, a0 - q * a1
        b0, b1 = b1, b0 - q * b1
    return a0, b0, x


class FieldElement:
    """An element of a prime field, stored as a canonical int in [0, p)."""

    __slots__ = ("value", "field")

    def __init__(self, value: int, field: "Field"):
        self.value = value % field.p
        self.field = field

    # -- ring operations ----------------------------------------------------
    def __add__(self, other):
        return FieldElement((self.value + other.value) % self.field.p, self.field)

    def __sub__(self, other):
        return FieldElement((self.value - other.value) % self.field.p, self.field)

    def __mul__(self, other):
        return FieldElement((self.value * other.value) % self.field.p, self.field)

    def __neg__(self):
        return FieldElement(-self.value % self.field.p, self.field)

    def __truediv__(self, other):
        if other.value == 0:
            raise ZeroDivisionError("field division by zero")
        return self * other.inverse()

    def inverse(self) -> "FieldElement":
        a, _, g = xgcd(self.value, self.field.p)
        if g != 1:
            raise ZeroDivisionError("element not invertible")
        return FieldElement(a % self.field.p, self.field)

    def __pow__(self, exponent: int):
        return FieldElement(pow(self.value, exponent, self.field.p), self.field)

    # The reference overloads ``^`` for exponentiation (algebra.py:38-45);
    # we keep that for API compatibility.
    __xor__ = __pow__

    # -- comparisons / encodings -------------------------------------------
    def __eq__(self, other):
        return isinstance(other, FieldElement) and self.value == other.value

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self.value)

    def is_zero(self) -> bool:
        return self.value == 0

    def __str__(self):
        return str(self.value)

    def __repr__(self):
        return f"FieldElement({self.value})"

    def __bytes__(self):
        # Decimal-string encoding; consensus-critical: it defines Merkle leaf
        # bytes and hence all commitments (reference: algebra.py:56-57).
        return str(self.value).encode()


class Field:
    """A prime field GF(p)."""

    __slots__ = ("p",)

    def __init__(self, p: int):
        self.p = p

    def __eq__(self, other):
        return isinstance(other, Field) and self.p == other.p

    def __hash__(self):
        return hash(("Field", self.p))

    def zero(self) -> FieldElement:
        return FieldElement(0, self)

    def one(self) -> FieldElement:
        return FieldElement(1, self)

    def __call__(self, value: int) -> FieldElement:
        return FieldElement(value, self)

    # -- element-level ops (kept for reference API compatibility) -----------
    def add(self, a, b):
        return a + b

    def subtract(self, a, b):
        return a - b

    def multiply(self, a, b):
        return a * b

    def negate(self, a):
        return -a

    def inverse(self, a):
        return a.inverse()

    def divide(self, a, b):
        return a / b

    # -- canonical field -----------------------------------------------------
    @staticmethod
    def main() -> "Field":
        """The canonical 128-bit STARK field p = 1 + 407*2^119."""
        return Field(P)

    def generator(self) -> FieldElement:
        assert self.p == P, "generator known only for the canonical field"
        return FieldElement(GENERATOR, self)

    def primitive_nth_root(self, n: int) -> FieldElement:
        """Primitive n-th root of unity for power-of-two n <= 2^119.

        Derived by repeated squaring from the fixed 2^119-order generator
        (reference: algebra.py:104-114).
        """
        assert self.p == P, "roots of unity known only for the canonical field"
        assert n <= (1 << TWO_ADICITY) and (n & (n - 1)) == 0, (
            "n must be a power of two at most 2^119"
        )
        root = GENERATOR
        order = 1 << TWO_ADICITY
        while order != n:
            root = root * root % self.p
            order //= 2
        return FieldElement(root, self)

    def sample(self, byte_array: bytes) -> FieldElement:
        """Map hash output bytes to a field element.

        Big-endian accumulation of the bytes, reduced mod p (reference:
        algebra.py:116-120): acc = (acc << 8) ^ b over the bytes is their
        big-endian value.  Used for Fiat-Shamir challenges, so the exact
        accumulation order matters.
        """
        return FieldElement(int.from_bytes(bytes(byte_array), "big") % self.p, self)
