"""STARK protocol parameters and degree bookkeeping.

The port of ``StarkParams`` from stark_anatomy_tpu/protocols/stark.py
(reference: stark.py:8-71 / fast_stark.py:8-74), shared by the fast
prover.  The slow scalar ``Stark`` prover/verifier waits for a later
slice.
"""

from __future__ import annotations

from hashlib import blake2b
from typing import List, Optional, Sequence, Tuple

from ..field.scalar import Field, FieldElement
from ..poly.multivariate import MPolynomial
from ..poly.univariate import Polynomial
from .fri import Fri

Boundary = List[Tuple[int, int, FieldElement]]  # (cycle, register, value)


class StarkParams:
    """Protocol parameters and degree bookkeeping
    (reference: stark.py:8-71 / fast_stark.py:8-74)."""

    def __init__(
        self,
        field: Field,
        expansion_factor: int,
        num_colinearity_checks: int,
        security_level: int,
        num_registers: int,
        num_cycles: int,
        transition_constraints_degree: int = 2,
    ):
        assert field.p.bit_length() >= security_level, (
            "p must have at least as many bits as security level"
        )
        assert expansion_factor & (expansion_factor - 1) == 0, (
            "expansion factor must be a power of 2"
        )
        assert expansion_factor >= 4, "expansion factor must be 4 or greater"
        assert num_colinearity_checks * 2 >= security_level, (
            "number of colinearity checks must be at least half of security level"
        )

        self.field = field
        self.expansion_factor = expansion_factor
        self.num_colinearity_checks = num_colinearity_checks
        self.security_level = security_level

        self.num_randomizers = 4 * num_colinearity_checks
        self.num_registers = num_registers
        self.original_trace_length = num_cycles

        self.randomized_trace_length = self.original_trace_length + self.num_randomizers
        self.omicron_domain_length = 1 << (
            self.randomized_trace_length * transition_constraints_degree
        ).bit_length()
        self.fri_domain_length = self.omicron_domain_length * expansion_factor

        self.generator = self.field.generator()
        self.omega = self.field.primitive_nth_root(self.fri_domain_length)
        self.omicron = self.field.primitive_nth_root(self.omicron_domain_length)

        self.fri = Fri(
            self.generator.value,
            self.omega.value,
            self.fri_domain_length,
            self.expansion_factor,
            self.num_colinearity_checks,
        )

    @classmethod
    def from_config(cls, config, field: Optional[Field] = None, **kwargs):
        """Construct from a frozen :class:`stark_anatomy_tpu_torch.config.StarkConfig`
        (extra kwargs like ``device=`` pass through)."""
        return cls(
            field or Field.main(),
            config.expansion_factor,
            config.num_colinearity_checks,
            config.security_level,
            config.num_registers,
            config.num_cycles,
            transition_constraints_degree=config.transition_constraints_degree,
            **kwargs,
        )

    def omicron_powers(self, count: int) -> List[FieldElement]:
        """[omicron^0 .. omicron^(count-1)] by iterated multiplication."""
        acc = 1
        w = self.omicron.value
        out = []
        for _ in range(count):
            out.append(FieldElement(acc, self.field))
            acc = acc * w % self.field.p
        return out

    # -- degree bookkeeping (reference: stark.py:35-68) ----------------------
    def transition_degree_bounds(self, transition_constraints: Sequence[MPolynomial]):
        point_degrees = [1] + [
            self.original_trace_length + self.num_randomizers - 1
        ] * (2 * self.num_registers)
        return [
            max(
                sum(r * l for r, l in zip(point_degrees, k))
                for k in a.dictionary.keys()
            )
            for a in transition_constraints
        ]

    def transition_quotient_degree_bounds(self, transition_constraints):
        return [
            d - (self.original_trace_length - 1)
            for d in self.transition_degree_bounds(transition_constraints)
        ]

    def max_degree(self, transition_constraints):
        md = max(self.transition_quotient_degree_bounds(transition_constraints))
        return (1 << md.bit_length()) - 1

    def boundary_zerofiers(self, boundary: Boundary) -> List[Polynomial]:
        zerofiers = []
        for s in range(self.num_registers):
            points = [self.omicron ** c for c, r, v in boundary if r == s]
            zerofiers.append(Polynomial.zerofier_domain(points))
        return zerofiers

    def boundary_interpolants(self, boundary: Boundary) -> List[Polynomial]:
        interpolants = []
        for s in range(self.num_registers):
            points = [(c, v) for c, r, v in boundary if r == s]
            domain = [self.omicron ** c for c, v in points]
            values = [v for c, v in points]
            interpolants.append(Polynomial.interpolate_domain(domain, values))
        return interpolants

    def boundary_quotient_degree_bounds(self, randomized_trace_length, boundary):
        randomized_trace_degree = randomized_trace_length - 1
        return [
            randomized_trace_degree - bz.degree()
            for bz in self.boundary_zerofiers(boundary)
        ]

    def sample_weights(self, number: int, randomness: bytes) -> List[FieldElement]:
        return [
            self.field.sample(blake2b(randomness + i.to_bytes(4, "big")).digest())
            for i in range(number)
        ]
