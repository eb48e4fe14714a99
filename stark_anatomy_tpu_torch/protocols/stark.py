"""The slow STARK: host scalar prover and verifier, reference semantics.

The port of stark_anatomy_tpu/protocols/stark.py (reference:
stark.py:7-269): Lagrange interpolation, symbolic AIR-by-trace
composition, exact polynomial long division, including the reference's
deliberate behaviour that proving with a false witness CRASHES on the
non-zero division remainder (stark.py:111 via univariate.py:52;
DEVIATIONS.md #7).  Only FRI leaves the host: the combination codeword is
uploaded to the stark's device and ``Fri.prove`` folds and commits it
there (on the card: H0, H4 and H6; on the CPU their plain versions), with
the transcript of the host FRI.  The device-accelerated protocol is
fast_stark.py.

``StarkParams`` holds the protocol parameters, the degree bookkeeping and
the device (``resolve_device``: the card unless the caller passes
``device="cpu"``), shared by both provers.
"""

from __future__ import annotations

import os
from functools import reduce
from hashlib import blake2b
from typing import Dict, List, Optional, Sequence, Tuple

from ..commit.hashing import hash_paired_leaf
from ..commit.merkle import open_multi, paired_tree_from_ints, verify_multi
from ..config import resolve_device
from ..errors import MalformedProof, VerificationError, rejects_malformed
from ..field.scalar import Field, FieldElement
from ..ops.domain import power_table
from ..poly.multivariate import MPolynomial
from ..poly.univariate import Polynomial
from ..transcript.proof_stream import ProofStream
from ..utils.convert import device_from_ints
from .fri import Fri

Boundary = List[Tuple[int, int, FieldElement]]  # (cycle, register, value)


def opened_section(duplicated: Sequence[int], values, what: str) -> Dict[int, int]:
    """One opened section's values by position: ``duplicated`` lists the
    positions in the order the prover opened them, a position queried
    twice twice over.  A leaf hashes one copy of each value, so the copies
    must be equal, or a byte of the other could change and the proof still
    verify; raises MalformedProof otherwise."""
    if len(values) != len(duplicated) or not all(isinstance(v, int) for v in values):
        raise MalformedProof(f"{what}: bad opened-values section")
    section: Dict[int, int] = {}
    for i, v in zip(duplicated, values):
        if section.setdefault(i, v) != v:
            raise MalformedProof(f"{what}: two openings of position {i} differ")
    return section


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
        device=None,
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
        self.transition_constraints_degree = transition_constraints_degree
        self.omicron_domain_length = 1 << (
            self.randomized_trace_length * transition_constraints_degree
        ).bit_length()
        self.fri_domain_length = self.omicron_domain_length * expansion_factor

        self.generator = self.field.generator()
        self.omega = self.field.primitive_nth_root(self.fri_domain_length)
        self.omicron = self.field.primitive_nth_root(self.omicron_domain_length)
        self._omicron_domain = None
        self.device = resolve_device(device)

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

    @property
    def omicron_domain(self) -> List[FieldElement]:
        """The full omicron domain, built lazily by iterated multiplication."""
        if self._omicron_domain is None:
            self._omicron_domain = self.omicron_powers(self.omicron_domain_length)
        return self._omicron_domain

    def omicron_powers(self, count: int) -> List[FieldElement]:
        """[omicron^0 .. omicron^(count-1)] by iterated multiplication."""
        acc = 1
        w = self.omicron.value
        out = []
        for _ in range(count):
            out.append(FieldElement(acc, self.field))
            acc = acc * w % self.field.p
        return out

    def omicron_powers_device(self, count: int):
        """[omicron^0 .. omicron^(count-1)] as a Montgomery limb tensor
        (NLIMBS, count) on the stark's device (ops/domain.py:power_table)."""
        n = 1 << max(count - 1, 1).bit_length()  # next power of two >= count
        return power_table(self.omicron.value, n, self.device)[..., :count]

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

    def transition_zerofier(self) -> Polynomial:
        domain = self.omicron_domain[: self.original_trace_length - 1]
        return Polynomial.zerofier_domain(domain)

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


class Stark(StarkParams):
    """Slow scalar STARK prover/verifier (reference: stark.py:73-269)."""

    def prove(
        self,
        trace: List[List[FieldElement]],
        transition_constraints: Sequence[MPolynomial],
        boundary: Boundary,
        proof_stream: Optional[ProofStream] = None,
        urandom=os.urandom,
    ) -> bytes:
        """Generate a proof.  Randomness comes from ``urandom`` in the JAX
        package's order and sizes: num_randomizers rows of num_registers
        draws of 17 bytes, then max_degree + 1 for the randomizer
        polynomial."""
        if proof_stream is None:
            proof_stream = ProofStream()

        # concatenate randomizer rows for zero-knowledge
        trace = list(trace) + [
            [self.field.sample(urandom(17)) for _ in range(self.num_registers)]
            for _ in range(self.num_randomizers)
        ]

        # interpolate trace columns over the omicron domain prefix
        trace_domain = [self.omicron ** i for i in range(len(trace))]
        trace_polynomials = [
            Polynomial.interpolate_domain(
                trace_domain, [trace[c][s] for c in range(len(trace))]
            )
            for s in range(self.num_registers)
        ]

        # boundary quotients: exact division (CRASHES on a false witness,
        # the reference's slow path, stark.py:98)
        interpolants = self.boundary_interpolants(boundary)
        zerofiers = self.boundary_zerofiers(boundary)
        boundary_quotients = [
            (trace_polynomials[s] - interpolants[s]) / zerofiers[s]
            for s in range(self.num_registers)
        ]

        # commit to boundary quotient codewords
        fri_domain = [FieldElement(x, self.field) for x in self.fri.eval_domain()]
        boundary_quotient_codewords = []
        boundary_quotient_trees = []
        for s in range(self.num_registers):
            codeword = [v.value for v in boundary_quotients[s].evaluate_domain(fri_domain)]
            tree = paired_tree_from_ints(codeword)
            boundary_quotient_codewords.append(codeword)
            boundary_quotient_trees.append(tree)
            proof_stream.push(tree.root)

        # symbolic AIR composed with the trace
        point = (
            [Polynomial.x(self.field)]
            + trace_polynomials
            + [tp.scale(self.omicron) for tp in trace_polynomials]
        )
        transition_polynomials = [a.evaluate_symbolic(point) for a in transition_constraints]

        # transition quotients: exact division by the transition zerofier
        transition_zerofier = self.transition_zerofier()
        transition_quotients = [tp / transition_zerofier for tp in transition_polynomials]

        # randomizer polynomial commitment
        randomizer_polynomial = Polynomial(
            [
                self.field.sample(urandom(17))
                for _ in range(self.max_degree(transition_constraints) + 1)
            ]
        )
        randomizer_codeword = [v.value for v in randomizer_polynomial.evaluate_domain(fri_domain)]
        randomizer_tree = paired_tree_from_ints(randomizer_codeword)
        proof_stream.push(randomizer_tree.root)

        # Fiat-Shamir weights for the nonlinear combination
        weights = self.sample_weights(
            1 + 2 * len(transition_quotients) + 2 * len(boundary_quotients),
            proof_stream.prover_fiat_shamir(),
        )

        assert [
            tq.degree() for tq in transition_quotients
        ] == self.transition_quotient_degree_bounds(transition_constraints), (
            "transition quotient degrees do not match with expectation"
        )

        # combination polynomial: randomizer + (1, x^shift)-weighted terms
        x = Polynomial.x(self.field)
        max_degree = self.max_degree(transition_constraints)
        tq_bounds = self.transition_quotient_degree_bounds(transition_constraints)
        bq_bounds = self.boundary_quotient_degree_bounds(len(trace), boundary)
        terms: List[Polynomial] = [randomizer_polynomial]
        for i in range(len(transition_quotients)):
            terms.append(transition_quotients[i])
            terms.append((x ** (max_degree - tq_bounds[i])) * transition_quotients[i])
        for i in range(self.num_registers):
            terms.append(boundary_quotients[i])
            terms.append((x ** (max_degree - bq_bounds[i])) * boundary_quotients[i])
        combination = reduce(
            lambda a, b: a + b,
            [Polynomial([weights[i]]) * terms[i] for i in range(len(terms))],
            Polynomial([]),
        )
        combined_codeword = [v.value for v in combination.evaluate_domain(fri_domain)]

        # FRI low-degree proof on the device, then open the linked leaves
        indices = self.fri.prove(device_from_ints(combined_codeword, self.device), proof_stream)

        N = self.fri.domain_length
        duplicated_indices = indices + [(i + self.expansion_factor) % N for i in indices]
        quadrupled_indices = sorted(
            duplicated_indices + [(i + N // 2) % N for i in duplicated_indices]
        )
        # paired leaves: one multiproof over the reduced leaf index set
        leaf_indices = sorted({i % (N // 2) for i in duplicated_indices})

        for s in range(self.num_registers):
            proof_stream.push([boundary_quotient_codewords[s][i] for i in quadrupled_indices])
            proof_stream.push(open_multi(boundary_quotient_trees[s], leaf_indices))
        proof_stream.push([randomizer_codeword[i] for i in quadrupled_indices])
        proof_stream.push(open_multi(randomizer_tree, leaf_indices))

        return proof_stream.serialize()

    @rejects_malformed
    def verify(
        self,
        proof: bytes,
        transition_constraints: Sequence[MPolynomial],
        boundary: Boundary,
        proof_stream_factory=None,
    ) -> bool:
        """Returns True iff the proof verifies; never raises on a malformed
        proof (the reason is on ``self.last_rejection``)."""
        original_trace_length = 1 + max(c for c, r, v in boundary)
        randomized_trace_length = original_trace_length + self.num_randomizers

        if proof_stream_factory is None:
            proof_stream = ProofStream.deserialize(proof)
        else:
            proof_stream = proof_stream_factory(proof)

        boundary_quotient_roots = [
            proof_stream.pull_typed(bytes) for _ in range(self.num_registers)
        ]
        randomizer_root = proof_stream.pull_typed(bytes)

        weights = self.sample_weights(
            1 + 2 * len(transition_constraints) + 2 * self.num_registers,
            proof_stream.verifier_fiat_shamir(),
        )

        polynomial_values: List[Tuple[int, int]] = []
        if not self.fri.verify(proof_stream, polynomial_values):
            raise VerificationError(f"FRI rejected: {self.fri.last_rejection}")
        polynomial_values.sort(key=lambda iv: iv[0])
        indices = [i for i, v in polynomial_values]
        values = [v for i, v in polynomial_values]

        N = self.fri.domain_length
        duplicated_indices = sorted(
            indices + [(i + self.expansion_factor) % N for i in indices]
        )
        leaf_indices = sorted({i % (N // 2) for i in duplicated_indices})
        depth = N.bit_length() - 2                    # paired tree: N/2 leaves

        def pull_section(root, what: str):
            section = opened_section(duplicated_indices, proof_stream.pull_typed(list), what)
            proof = proof_stream.pull_typed(list)
            ld = {
                l: hash_paired_leaf(section[l], section[l + N // 2])
                for l in leaf_indices
            }
            if not verify_multi(root, depth, ld, proof):
                raise VerificationError(f"{what}: Merkle multiproof failed")
            return section

        leafs = [
            pull_section(boundary_quotient_roots[r], f"boundary quotient {r}")
            for r in range(len(boundary_quotient_roots))
        ]
        randomizer = pull_section(randomizer_root, "randomizer")

        # re-derive and check the combination at each queried index
        zerofiers = self.boundary_zerofiers(boundary)
        interpolants = self.boundary_interpolants(boundary)
        tq_bounds = self.transition_quotient_degree_bounds(transition_constraints)
        bq_bounds = self.boundary_quotient_degree_bounds(randomized_trace_length, boundary)
        max_degree = self.max_degree(transition_constraints)
        transition_zerofier = self.transition_zerofier()

        for i in range(len(indices)):
            current_index = indices[i]
            domain_current = self.generator * (self.omega ** current_index)
            next_index = (current_index + self.expansion_factor) % N
            domain_next = self.generator * (self.omega ** next_index)

            current_trace = []
            next_trace = []
            for s in range(self.num_registers):
                bq_cur = FieldElement(leafs[s][current_index], self.field)
                bq_next = FieldElement(leafs[s][next_index], self.field)
                current_trace.append(
                    bq_cur * zerofiers[s].evaluate(domain_current)
                    + interpolants[s].evaluate(domain_current)
                )
                next_trace.append(
                    bq_next * zerofiers[s].evaluate(domain_next)
                    + interpolants[s].evaluate(domain_next)
                )

            point = [domain_current] + current_trace + next_trace
            transition_values = [tc.evaluate(point) for tc in transition_constraints]

            terms: List[FieldElement] = [FieldElement(randomizer[current_index], self.field)]
            tz_value = transition_zerofier.evaluate(domain_current)
            for s in range(len(transition_values)):
                quotient = transition_values[s] / tz_value
                terms.append(quotient)
                terms.append(quotient * (domain_current ** (max_degree - tq_bounds[s])))
            for s in range(self.num_registers):
                bqv = FieldElement(leafs[s][current_index], self.field)
                terms.append(bqv)
                terms.append(bqv * (domain_current ** (max_degree - bq_bounds[s])))

            combination = reduce(
                lambda a, b: a + b,
                [terms[j] * weights[j] for j in range(len(terms))],
                self.field.zero(),
            )
            if combination.value != values[i]:
                raise VerificationError(
                    f"combination mismatch at query index {current_index}"
                )

        # anti-malleability: every transcript object must have been consumed
        if proof_stream.read_index != len(proof_stream.objects):
            raise MalformedProof("trailing transcript objects")

        return True
