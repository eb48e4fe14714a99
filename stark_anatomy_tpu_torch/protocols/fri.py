"""FRI low-degree test, host path: fold, commit, query and verify.

The port of stark_anatomy_tpu/protocols/fri.py for the branch the
signature takes: ``prove_host`` (folds on canonical ints, hashlib Merkle
trees) and the host verifier.  Protocol parity with the reference
(fri.py:11-231): iterated split-and-fold with Merkle commitments per
round, Fiat-Shamir folding challenges, colinearity spot checks.  The
device fold path of the JAX package (``Fri.commit``/``prove``) waits for
the large-trace slice.

Deliberate deviations (documented in DEVIATIONS.md): index-sampling counter
bytes use a fixed-width encoding, and colinearity accepts degree <= 1.
"""

from __future__ import annotations

from hashlib import blake2b
from typing import List, Tuple

from ..commit.merkle import MerkleTree, open_multi, verify_multi
from ..errors import MalformedProof, VerificationError, rejects_malformed
from ..field.scalar import Field, P
from ..poly.host_ntt import intt_ints
from ..transcript.proof_stream import ProofStream
from ..utils.convert import gather_rows

_TWO_INV = pow(2, P - 2, P)


class Fri:
    """FRI over the coset offset*<omega> of size ``initial_domain_length``."""

    def __init__(
        self,
        offset: int,
        omega: int,
        initial_domain_length: int,
        expansion_factor: int,
        num_colinearity_tests: int,
    ):
        self.offset = offset % P
        self.omega = omega % P
        self.domain_length = initial_domain_length
        self.field = Field.main()
        self.expansion_factor = expansion_factor
        self.num_colinearity_tests = num_colinearity_tests
        self._host_u0 = None  # lazy inverse-domain table
        assert self.num_rounds() >= 1, "cannot do FRI with less than one round"

    # -- round structure (reference: fri.py:22-28) --------------------------
    def num_rounds(self) -> int:
        codeword_length = self.domain_length
        num = 0
        while (
            codeword_length > self.expansion_factor
            and 4 * self.num_colinearity_tests < codeword_length
        ):
            codeword_length //= 2
            num += 1
        return num

    # -- index sampling (reference: fri.py:30-51) ---------------------------
    @staticmethod
    def sample_index(byte_array: bytes, size: int) -> int:
        acc = 0
        for b in byte_array:
            acc = (acc << 8) ^ int(b)
        return acc % size

    def sample_indices(self, seed: bytes, size: int, reduced_size: int, number: int):
        assert number <= reduced_size, (
            f"cannot sample more indices than available in last codeword; "
            f"requested: {number}, available: {reduced_size}"
        )
        indices: List[int] = []
        reduced_indices: List[int] = []
        counter = 0
        while len(indices) < number:
            index = Fri.sample_index(
                blake2b(seed + counter.to_bytes(8, "big")).digest(), size
            )
            reduced = index % reduced_size
            counter += 1
            if reduced not in reduced_indices:
                indices.append(index)
                reduced_indices.append(reduced)
        return indices

    @staticmethod
    def _layer_len(layer) -> int:
        return len(layer) if isinstance(layer, list) else layer.shape[0]

    def query(
        self,
        current_layer,
        current_tree: MerkleTree,
        c_indices: List[int],
        proof_stream: ProofStream,
    ):
        """Reveal, per test, the paired leaf (a, b) = (layer[i], layer[i+half])
        at i = c_indices[s], plus ONE multiproof for the whole index set."""
        half = self._layer_len(current_layer) // 2
        idx = [c_indices[s] for s in range(self.num_colinearity_tests)]
        vals = gather_rows(
            current_layer, idx + [i + half for i in idx]
        )
        for s in range(self.num_colinearity_tests):
            proof_stream.push((vals[s], vals[s + len(idx)]))
        proof_stream.push(open_multi(current_tree, c_indices))
        return c_indices

    # -- host prover -----------------------------------------------------------
    def _host_u(self) -> List[int]:
        if self._host_u0 is None:
            half = self.domain_length // 2
            omega_inv = pow(self.omega, P - 2, P)
            offset_inv = pow(self.offset, P - 2, P)
            u, us = offset_inv, []
            for _ in range(half):
                us.append(u)
                u = u * omega_inv % P
            self._host_u0 = us
        return self._host_u0

    @staticmethod
    def _host_tree(codeword: List[int]) -> MerkleTree:
        from ..commit.hashing import elt_bytes

        half = len(codeword) // 2
        return MerkleTree(
            [
                elt_bytes(codeword[i]) + elt_bytes(codeword[i + half])
                for i in range(half)
            ]
        )

    def prove_host(
        self, codeword: List[int], proof_stream: ProofStream
    ) -> List[int]:
        """Host-resident mirror of :meth:`prove` over canonical ints;
        byte-identical transcript output."""
        assert self.domain_length == len(codeword)
        two_inv = _TWO_INV
        u = self._host_u()
        layers: List[List[int]] = []
        trees: List[MerkleTree] = []
        for r in range(self.num_rounds()):
            tree = self._host_tree(codeword)
            proof_stream.push(tree.root)
            layers.append(codeword)
            trees.append(tree)
            if r == self.num_rounds() - 1:
                break
            alpha = self.field.sample(proof_stream.prover_fiat_shamir()).value
            half = len(codeword) // 2
            codeword = [
                two_inv
                * (
                    (1 + alpha * u[i]) * codeword[i]
                    + (1 - alpha * u[i]) * codeword[half + i]
                )
                % P
                for i in range(half)
            ]
            u = [v * v % P for v in u[: half // 2]]
        proof_stream.push(list(layers[-1]))

        top_level_indices = self.sample_indices(
            proof_stream.prover_fiat_shamir(),
            len(layers[0]) // 2,
            len(layers[-1]),
            self.num_colinearity_tests,
        )
        indices = list(top_level_indices)
        for i in range(len(layers) - 1):
            half = len(layers[i]) // 2
            indices = [idx % half for idx in indices]
            layer = layers[i]
            for s in range(self.num_colinearity_tests):
                proof_stream.push((layer[indices[s]], layer[indices[s] + half]))
            proof_stream.push(open_multi(trees[i], indices))
        return top_level_indices

    # -- verifier (host scalar) ----------------------------------------------
    @rejects_malformed
    def verify(
        self, proof_stream: ProofStream, polynomial_values: List[Tuple[int, int]]
    ) -> bool:
        """Returns True iff the proof verifies.  Never raises on malformed
        transcripts: any rejection (structural or cryptographic) returns
        False with the reason recorded on ``self.last_rejection``."""
        omega = self.omega
        offset = self.offset

        roots: List[bytes] = []
        alphas: List[int] = []
        for _ in range(self.num_rounds()):
            roots.append(proof_stream.pull_typed(bytes))
            alphas.append(
                self.field.sample(proof_stream.verifier_fiat_shamir()).value
            )

        last_codeword: List[int] = proof_stream.pull_typed(list)
        if not all(isinstance(v, int) for v in last_codeword):
            raise MalformedProof("last codeword is not a list of ints")
        # reachable from attacker-controlled bytes via len(last_codeword):
        # structured rejection, NOT an assert (reference asserts, fri.py:157)
        if len(last_codeword) < 2 or (
            len(last_codeword) & (len(last_codeword) - 1)
        ) != 0:
            raise MalformedProof("last codeword length is not a power of two")
        from ..commit.hashing import elt_bytes

        half_last = len(last_codeword) // 2
        if any(not (0 <= v < P) for v in last_codeword):
            raise MalformedProof("last codeword value out of field range")
        last_enc = [
            elt_bytes(last_codeword[i]) + elt_bytes(last_codeword[i + half_last])
            for i in range(half_last)
        ]
        if roots[-1] != MerkleTree(last_enc).root:
            raise VerificationError("last codeword does not match its root")

        degree = (len(last_codeword) // self.expansion_factor) - 1
        last_omega, last_offset = omega, offset
        for _ in range(self.num_rounds() - 1):
            last_omega = last_omega * last_omega % P
            last_offset = last_offset * last_offset % P
        if pow(last_omega, len(last_codeword), P) != 1:
            raise VerificationError(
                "last codeword length inconsistent with round structure "
                "(omega order mismatch)"
            )

        # Low-degree check of the last codeword via host NTT (the reference
        # used O(n^2) Lagrange here, fri.py:163-174; docs/faster.md:450-461
        # prescribes the NTT).  The codeword holds q(omega^i) for
        # q(x) = poly(offset*x); coset scaling does not change which
        # coefficients are zero, so checking q's degree suffices.
        coeffs = intt_ints(last_codeword, last_omega)
        if any(c != 0 for c in coeffs[degree + 1 :]):
            raise VerificationError(
                f"last codeword is not low-degree (> {degree})"
            )

        top_level_indices = self.sample_indices(
            proof_stream.verifier_fiat_shamir(),
            self.domain_length >> 1,
            self.domain_length >> (self.num_rounds() - 1),
            self.num_colinearity_tests,
        )

        # pull all query-round reveals: per round, `tests` paired-leaf
        # tuples (a, b) and ONE multiproof (prover: query())
        num_query_rounds = self.num_rounds() - 1
        reveals: List[Tuple[List[Tuple[int, int]], List[bytes]]] = []
        for r in range(num_query_rounds):
            tuples: List[Tuple[int, int]] = []
            for s in range(self.num_colinearity_tests):
                leaf = proof_stream.pull_typed(tuple)
                if len(leaf) != 2 or not all(isinstance(v, int) for v in leaf):
                    raise MalformedProof("FRI paired leaf is not 2 ints")
                tuples.append(leaf)
            reveals.append((tuples, proof_stream.pull_typed(list)))

        from ..commit.hashing import hash_paired_leaf

        for r in range(num_query_rounds):
            half = self.domain_length >> (r + 1)      # = len(layer r) / 2
            c_indices = [i % half for i in top_level_indices]
            tuples, multiproof = reveals[r]

            for s in range(self.num_colinearity_tests):
                ay, by = tuples[s]
                if r == 0:
                    polynomial_values.append((c_indices[s], ay))
                    polynomial_values.append((c_indices[s] + half, by))
                # c-value: component of the NEXT layer's paired leaf (or of
                # the clear last codeword for the final query round)
                ci = c_indices[s]                      # index into layer r+1
                if r + 1 < num_query_rounds:
                    next_half = half // 2
                    na, nb = reveals[r + 1][0][s]
                    cy = na if ci < next_half else nb
                else:
                    cy = last_codeword[ci]
                # colinearity: (by-ay)*(cx-ax) == (cy-ay)*(bx-ax)
                ax = offset * pow(omega, ci, P) % P
                bx = offset * pow(omega, ci + half, P) % P
                cx = alphas[r]
                lhs = (by - ay) * (cx - ax) % P
                rhs = (cy - ay) * (bx - ax) % P
                if lhs != rhs:
                    raise VerificationError(
                        f"colinearity check failed (round {r}, test {s})"
                    )

            depth = half.bit_length() - 1              # paired tree: half leaves
            ld = {
                c_indices[s]: hash_paired_leaf(*tuples[s])
                for s in range(self.num_colinearity_tests)
            }
            if not verify_multi(roots[r], depth, ld, multiproof):
                raise VerificationError(
                    f"Merkle multiproof failed (round {r})"
                )

            omega = omega * omega % P
            offset = offset * offset % P

        return True
