"""Host-side dense univariate polynomials over a prime field.

This is the scalar reference path (capability parity with
the reference's univariate.py:1-161).  It favors clarity over speed;
the device path in :mod:`stark_anatomy_tpu_torch.ops.ntt` provides the
O(N log N) kernels.  Coefficients are stored dense, lowest degree first.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field.scalar import Field, FieldElement


class Polynomial:
    __slots__ = ("coefficients",)

    def __init__(self, coefficients: Sequence[FieldElement]):
        self.coefficients: List[FieldElement] = list(coefficients)

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_ints(values: Sequence[int], field: Field) -> "Polynomial":
        return Polynomial([FieldElement(v, field) for v in values])

    @staticmethod
    def zero() -> "Polynomial":
        return Polynomial([])

    @staticmethod
    def constant(c: FieldElement) -> "Polynomial":
        return Polynomial([c])

    @staticmethod
    def x(field: Field) -> "Polynomial":
        return Polynomial([field.zero(), field.one()])

    # -- basic queries -------------------------------------------------------
    def degree(self) -> int:
        """Degree, with the zero polynomial having degree -1."""
        for i in range(len(self.coefficients) - 1, -1, -1):
            if not self.coefficients[i].is_zero():
                return i
        return -1

    def is_zero(self) -> bool:
        return self.degree() == -1

    def leading_coefficient(self) -> FieldElement:
        return self.coefficients[self.degree()]

    # -- ring operations -----------------------------------------------------
    def __neg__(self):
        return Polynomial([-c for c in self.coefficients])

    def __add__(self, other: "Polynomial"):
        a, b = self.coefficients, other.coefficients
        if len(a) < len(b):
            a, b = b, a
        out = list(a)
        for i, c in enumerate(b):
            out[i] = out[i] + c
        return Polynomial(out)

    def __sub__(self, other: "Polynomial"):
        return self + (-other)

    def __mul__(self, other: "Polynomial"):
        a, b = self.coefficients, other.coefficients
        if not a or not b:
            return Polynomial([])
        field = a[0].field
        out = [field.zero()] * (len(a) + len(b) - 1)
        for i, ca in enumerate(a):
            if ca.is_zero():
                continue
            for j, cb in enumerate(b):
                out[i + j] = out[i + j] + ca * cb
        return Polynomial(out)

    def __pow__(self, exponent: int):
        if self.is_zero():
            return Polynomial([])
        field = self.coefficients[0].field
        acc = Polynomial([field.one()])
        if exponent == 0:
            return acc
        base = self
        e = exponent
        while e > 0:
            if e & 1:
                acc = acc * base
            e >>= 1
            if e:
                base = base * base
        return acc

    __xor__ = __pow__  # reference's ``^`` notation (univariate.py:141-151)

    # -- division ------------------------------------------------------------
    @staticmethod
    def divide(numerator: "Polynomial", denominator: "Polynomial"):
        """Long division: returns (quotient, remainder)."""
        dd = denominator.degree()
        if dd == -1:
            raise ZeroDivisionError("polynomial division by zero")
        nd = numerator.degree()
        if nd < dd:
            return Polynomial([]), Polynomial(numerator.coefficients)
        field = denominator.coefficients[0].field
        lead_inv = denominator.leading_coefficient().inverse()
        rem = list(numerator.coefficients[: nd + 1])
        quot = [field.zero()] * (nd - dd + 1)
        for shift in range(nd - dd, -1, -1):
            c = rem[shift + dd]
            if c.is_zero():
                continue
            factor = c * lead_inv
            quot[shift] = factor
            for j in range(dd + 1):
                rem[shift + j] = rem[shift + j] - factor * denominator.coefficients[j]
        return Polynomial(quot), Polynomial(rem[:dd])

    def __truediv__(self, other: "Polynomial"):
        quo, rem = Polynomial.divide(self, other)
        assert rem.is_zero(), (
            "cannot perform polynomial division because remainder is not zero"
        )
        return quo

    def __mod__(self, other: "Polynomial"):
        _, rem = Polynomial.divide(self, other)
        return rem

    # -- comparisons ---------------------------------------------------------
    def __eq__(self, other):
        if not isinstance(other, Polynomial):
            return NotImplemented
        d = self.degree()
        if d != other.degree():
            return False
        return all(
            self.coefficients[i] == other.coefficients[i] for i in range(d + 1)
        )

    def __ne__(self, other):
        return not self.__eq__(other)

    def __str__(self):
        return "[" + ",".join(str(c) for c in self.coefficients) + "]"

    # -- evaluation / interpolation -----------------------------------------
    def evaluate(self, point: FieldElement) -> FieldElement:
        """Horner evaluation."""
        acc = point.field.zero()
        for c in reversed(self.coefficients):
            acc = acc * point + c
        return acc

    def evaluate_domain(self, domain: Sequence[FieldElement]):
        return [self.evaluate(d) for d in domain]

    @staticmethod
    def interpolate_domain(
        domain: Sequence[FieldElement], values: Sequence[FieldElement]
    ) -> "Polynomial":
        """Lagrange interpolation, O(n^2) (reference: univariate.py:107-120)."""
        assert len(domain) == len(values), "domain/values length mismatch"
        assert len(domain) > 0, "cannot interpolate zero points"
        field = domain[0].field
        x = Polynomial.x(field)
        acc = Polynomial([])
        for i in range(len(domain)):
            prod = Polynomial([values[i]])
            for j in range(len(domain)):
                if j == i:
                    continue
                prod = prod * (x - Polynomial([domain[j]]))
                prod = prod * Polynomial([(domain[i] - domain[j]).inverse()])
            acc = acc + prod
        return acc

    @staticmethod
    def zerofier_domain(domain: Sequence[FieldElement]) -> "Polynomial":
        """Monic polynomial vanishing exactly on ``domain``."""
        if len(domain) == 0:
            # The empty zerofier is the constant 1 (neutral for division).
            raise ValueError("zerofier of empty domain is undefined here")
        field = domain[0].field
        x = Polynomial.x(field)
        acc = Polynomial([field.one()])
        for d in domain:
            acc = acc * (x - Polynomial([d]))
        return acc

    def scale(self, factor: FieldElement) -> "Polynomial":
        """Substitute x -> factor*x; used for coset shifts
        (reference: univariate.py:153-154)."""
        out = []
        power = factor.field.one()
        for c in self.coefficients:
            out.append(power * c)
            power = power * factor
        return Polynomial(out)


def test_colinearity(points: Sequence[Tuple[FieldElement, FieldElement]]) -> bool:
    """Do the given points lie on a common line?  (FRI verifier primitive;
    reference: univariate.py:156-160)."""
    domain = [p[0] for p in points]
    values = [p[1] for p in points]
    polynomial = Polynomial.interpolate_domain(domain, values)
    return polynomial.degree() <= 1
