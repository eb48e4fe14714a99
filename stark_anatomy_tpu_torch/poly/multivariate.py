"""Sparse multivariate polynomials (host side) — the AIR constraint language.

Capability parity with the reference's multivariate.py:1-123:
dict-of-{exponent-tuple: coefficient} representation, ring ops, ``variables``,
``evaluate``, ``evaluate_symbolic`` (substituting univariate polynomials for
the variables — composing AIR with trace polynomials) and ``lift`` (embedding
a univariate polynomial as a multivariate one).

The device path does NOT use ``evaluate_symbolic``; it evaluates constraints
pointwise on LDE-domain codewords instead (see protocols/fast_stark.py).
This module is the symbolic reference semantics.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from ..field.scalar import Field, FieldElement
from .univariate import Polynomial


def _pad(exponents: Tuple[int, ...], n: int) -> Tuple[int, ...]:
    return tuple(exponents) + (0,) * (n - len(exponents))


class MPolynomial:
    __slots__ = ("dictionary",)

    def __init__(self, dictionary: Dict[Tuple[int, ...], FieldElement]):
        self.dictionary = dict(dictionary)

    # -- constructors --------------------------------------------------------
    @staticmethod
    def zero() -> "MPolynomial":
        return MPolynomial({})

    @staticmethod
    def constant(element: FieldElement) -> "MPolynomial":
        return MPolynomial({(0,): element})

    @staticmethod
    def variables(num_variables: int, field: Field):
        """[x_0, ..., x_{n-1}] as multivariate polynomials."""
        out = []
        for i in range(num_variables):
            exponent = tuple(1 if j == i else 0 for j in range(num_variables))
            out.append(MPolynomial({exponent: field.one()}))
        return out

    @staticmethod
    def lift(polynomial: Polynomial, variable_index: int) -> "MPolynomial":
        """Embed a univariate polynomial in variable ``variable_index``
        (reference: multivariate.py:114-123).  Also exposed as
        ``from_univariate`` — the name the reference's own test suite expects
        but the reference never defined (test_multivariate.py:38, a latent
        API bug we fix here)."""
        if polynomial.is_zero():
            return MPolynomial({})
        out: Dict[Tuple[int, ...], FieldElement] = {}
        for i, c in enumerate(polynomial.coefficients):
            if c.is_zero():
                continue
            exponent = (0,) * variable_index + (i,)
            out[exponent] = c
        return MPolynomial(out)

    from_univariate = lift

    # -- helpers -------------------------------------------------------------
    def num_variables(self) -> int:
        return max((len(k) for k in self.dictionary), default=0)

    def is_zero(self) -> bool:
        return all(v.is_zero() for v in self.dictionary.values())

    # -- ring operations -----------------------------------------------------
    def __add__(self, other: "MPolynomial"):
        n = max(self.num_variables(), other.num_variables())
        out: Dict[Tuple[int, ...], FieldElement] = {}
        for k, v in self.dictionary.items():
            out[_pad(k, n)] = v
        for k, v in other.dictionary.items():
            kk = _pad(k, n)
            out[kk] = out[kk] + v if kk in out else v
        return MPolynomial(out)

    def __sub__(self, other: "MPolynomial"):
        return self + (-other)

    def __neg__(self):
        return MPolynomial({k: -v for k, v in self.dictionary.items()})

    def __mul__(self, other: "MPolynomial"):
        n = max(self.num_variables(), other.num_variables())
        out: Dict[Tuple[int, ...], FieldElement] = {}
        for k0, v0 in self.dictionary.items():
            for k1, v1 in other.dictionary.items():
                e = tuple(
                    a + b for a, b in zip(_pad(k0, n), _pad(k1, n))
                )
                out[e] = out[e] + v0 * v1 if e in out else v0 * v1
        return MPolynomial(out)

    def __pow__(self, exponent: int):
        if self.is_zero():
            return MPolynomial({})
        field = next(iter(self.dictionary.values())).field
        n = self.num_variables()
        acc = MPolynomial({(0,) * n: field.one()})
        for bit in bin(exponent)[2:]:
            acc = acc * acc
            if bit == "1":
                acc = acc * self
        return acc

    __xor__ = __pow__

    def __eq__(self, other):
        if not isinstance(other, MPolynomial):
            return NotImplemented
        return (self - other).is_zero()

    def __ne__(self, other):
        return not self.__eq__(other)

    def __str__(self):
        terms = [f"{v}*x^{list(k)}" for k, v in self.dictionary.items()]
        return " + ".join(terms) if terms else "0"

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, point: Sequence[FieldElement]) -> FieldElement:
        """Evaluate at a tuple of field elements."""
        field = point[0].field
        acc = field.zero()
        for k, v in self.dictionary.items():
            term = v
            for i, e in enumerate(k):
                if e:
                    term = term * (point[i] ** e)
            acc = acc + term
        return acc

    def evaluate_symbolic(self, point: Sequence[Polynomial]) -> Polynomial:
        """Substitute univariate polynomials for the variables
        (reference: multivariate.py:105-112) — AIR ∘ trace composition."""
        acc = Polynomial([])
        for k, v in self.dictionary.items():
            term = Polynomial([v])
            for i, e in enumerate(k):
                if e:
                    term = term * (point[i] ** e)
            acc = acc + term
        return acc
