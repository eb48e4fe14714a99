"""FRI low-degree test: fold and commit on the card or on the host, query
and verify on the host.

The port of stark_anatomy_tpu/protocols/fri.py.  Protocol parity with the
reference (fri.py:11-231): iterated split-and-fold with Merkle
commitments per round, Fiat-Shamir folding challenges, colinearity spot
checks.  Two provers give the same transcript:

* ``prove`` (the JAX package's fused device path, taken where
  commit/device_merkle.py:use_device_commit says so): each round is one
  launch of H6 (field/kernels.py:fri_fold: the fold, the canonical form of
  the folded codeword and the next round's inverse-domain table) and the
  H4 passes of its tree, and only the 32-byte root is copied to the host.
  Every round runs so, down to the last layer, which alone is copied and
  sent in the clear.  The commit and the fold go through hooks
  (``commit_codeword``, ``fold_layer``, ...), which the sharded prover
  replaces by shard-local ones.  Rounds are sized exactly: the JAX
  package's shape-family padding (``_family_width``) only spared XLA
  compiles, and gives the same transcript, as does its host tail
  (``HOST_TAIL_MAX``: below it the remaining rounds fold host ints);
* ``prove_host`` folds canonical ints on the host and hashes with N1.

Both, and the batch prover (parallel/batch_prover.py), answer the queries
through one routine, ``queries``, for B proofs at once.

Deliberate deviations (documented in DEVIATIONS.md): index-sampling counter
bytes use a fixed-width encoding, and colinearity accepts degree <= 1.
"""

from __future__ import annotations

from hashlib import blake2b
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..commit import kernels as MK
from ..commit.device_merkle import DeviceMerkleTree, DeviceRows, device_commit_paired
from ..commit.merkle import MerkleTree, MultiproofWalk, verify_multi
from ..errors import MalformedProof, VerificationError, rejects_malformed
from ..field import kernels as K
from ..field import ops as F
from ..field.scalar import Field, P
from ..ops.domain import power_table
from ..poly.host_ntt import intt_ints
from ..transcript import codec
from ..transcript.proof_stream import ProofStream, push_runs
from ..utils.convert import gather_limbs, gather_rows
from ..utils.profiling import PhaseTimer

_TWO_INV = pow(2, P - 2, P)
# the timer of a prove that is handed none: no one reads it
_UNREAD = PhaseTimer()


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
        self._u0 = {}         # device -> (NLIMBS, N/2) Montgomery table
        # the device prover's hooks (the JAX package's commit_codeword, and
        # the port's fold hook in place of its fused_device_commit flag):
        # the sharded prover (parallel/sharded_stark.py) installs
        # shard-local versions.  commit_codeword(codeword) -> (rows, tree)
        # commits the first layer; initial_table(codeword) -> u its
        # inverse-domain table; fold_layer(codeword, u, alpha) -> (codeword,
        # u, rows, tree) folds a round and commits the result
        self.commit_codeword = self._commit_codeword_local
        self.initial_table = lambda codeword: self._initial_u(codeword.device)
        self.fold_layer = self._fold_layer_local
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
        # acc = (acc << 8) ^ b over the bytes is their big-endian value
        return int.from_bytes(bytes(byte_array), "big") % size

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

    def eval_domain(self) -> List[int]:
        """The FRI domain offset * omega^i, i < N, as host ints."""
        out, x = [], self.offset
        for _ in range(self.domain_length):
            out.append(x)
            x = x * self.omega % P
        return out

    # -- device prover -------------------------------------------------------
    def _initial_u(self, device) -> torch.Tensor:
        """The inverse-domain table u_i = 1/(offset * omega^i), i < N/2,
        (NLIMBS, N/2) Montgomery, cached per device."""
        device = torch.device(device)
        if device not in self._u0:
            half = self.domain_length // 2
            tab = power_table(pow(self.omega, P - 2, P), half, device)
            self._u0[device] = F.mont_mul(tab, F.mont_const(pow(self.offset, P - 2, P), device))
        return self._u0[device]

    def _commit_codeword_local(self, codeword: torch.Tensor):
        """The first layer's commitment where the codeword lies: H0 to
        canonical form and H4 (their plain versions on the CPU)."""
        return device_commit_paired(codeword)

    def _fold_layer_local(self, codeword: torch.Tensor, u: torch.Tensor, alpha: int):
        """One round on one device: H6 folds and writes the canonical form
        and the next table, H4 commits the canonical form."""
        codeword, canon, u = K.fri_fold(codeword, u, alpha)
        return codeword, u, DeviceRows(canon), DeviceMerkleTree(MK.merkle_paired(canon))

    @staticmethod
    def _fold_ints(codeword: List[int], u: List[int], alpha: int) -> List[int]:
        half = len(codeword) // 2
        return [
            _TWO_INV
            * ((1 + alpha * u[i]) * codeword[i] + (1 - alpha * u[i]) * codeword[half + i])
            % P
            for i in range(half)
        ]

    def commit(self, codeword: torch.Tensor, proof_stream: ProofStream,
               timer: PhaseTimer = _UNREAD):
        """Fold rounds of a Montgomery codeword (NLIMBS, N); returns (layers,
        trees), each layer the rows its commit gave (a DeviceRows on one
        device).  Mirrors the reference's commit loop (fri.py:56-96): per
        round, commit the current codeword, draw the challenge, fold.  A
        round is one H6 launch and the H4 passes of the folded codeword's
        tree (a round of each on every shard for the sharded prover), down
        to the last layer, which alone is copied to the host and sent in
        the clear.  Commitments use paired leaves: leaf i covers (c[i],
        c[i + n/2]), the fold's pair.

        ``timer`` gets the parts of the ``fri`` phase: ``fri.rounds``, the
        first layer's commit and every round (H6, H4, the root's copy and
        the draw), and ``fri.leave``, the copy and decode of the last
        layer."""
        layers, trees = [], []
        num = self.num_rounds()

        def record(rows, tree, r: int) -> Optional[int]:
            # send layer r's root; the challenge of the next fold, or None
            # after the last layer
            proof_stream.push(tree.root)
            layers.append(rows)
            trees.append(tree)
            if r == num - 1:
                return None
            return self.field.sample(proof_stream.prover_fiat_shamir()).value

        with timer.phase("fri.rounds"):
            codeword = codeword.contiguous()
            u = self.initial_table(codeword)
            rows, tree = self.commit_codeword(codeword)
            r = 0
            alpha = record(rows, tree, r)
            while alpha is not None:
                codeword, u, rows, tree = self.fold_layer(codeword, u, alpha)
                r += 1
                alpha = record(rows, tree, r)
        with timer.phase("fri.leave"):
            last = gather_rows(rows, range(self.domain_length >> r))
        proof_stream.push(last)
        return layers, trees

    def prove(self, codeword: torch.Tensor, proof_stream: ProofStream,
              timer: PhaseTimer = _UNREAD) -> List[int]:
        """The device prover over a Montgomery codeword (NLIMBS, N); the
        transcript of ``prove_host`` on the same values.  ``timer`` gets the
        parts of the ``fri`` phase (``commit``), and ``fri.queries``: the
        index draw and every layer's openings."""
        assert self.domain_length == codeword.shape[-1], (
            "initial codeword length does not match FRI domain length"
        )
        layers, trees = self.commit(codeword, proof_stream, timer)
        with timer.phase("fri.queries"):
            top = self.draw_indices([proof_stream])
            self.queries(layers, trees, top, [proof_stream])
        return top[0].tolist()

    def draw_indices(self, proof_streams: Sequence[ProofStream]) -> np.ndarray:
        """Each of B transcripts' top-level query indices, (B, T), drawn
        after its last layer."""
        return np.array([
            self.sample_indices(ps.prover_fiat_shamir(), self.domain_length // 2,
                                self.domain_length >> (self.num_rounds() - 1), self.num_colinearity_tests)
            for ps in proof_streams
        ], dtype=np.int64)

    def queries(self, layers: Sequence, trees: Sequence, top: np.ndarray,
                proof_streams: Sequence[ProofStream]) -> None:
        """The query rounds of B proofs at once, B = 1 for a one-proof
        prover: per layer but the last, the paired leaf (a, b) =
        (layer[i], layer[i + half]) at each of a proof's reduced indices i
        (``top`` (B, T) reduced mod half) and ONE multiproof for its set.
        ``layers[r]`` is what utils/convert.py:gather_limbs reads (stacked
        (B, n, NLIMBS) rows or (B, 8, n) DeviceRows give proof b its own)
        and ``trees[r]`` any tree a MultiproofWalk opens (B trees' stacked
        levels or DeviceMerkleTree give proof b its own): a layer's values
        are one gather, its multiproofs one walk, both encoded in bulk."""
        indices = np.asarray(top, dtype=np.int64)
        runs = []
        for r in range(len(layers) - 1):
            half = self.domain_length >> (r + 1)
            indices = indices % half
            pairs = gather_limbs(layers[r], np.stack([indices, indices + half], axis=-1))
            walk = MultiproofWalk(indices, half)
            runs.append((codec.encode_felt_tuples(pairs),)
                        + codec.encode_bytes_lists(walk.digests(trees[r]), walk.counts))
        push_runs(proof_streams, runs)

    # -- host prover -----------------------------------------------------------
    def _host_u(self) -> List[int]:
        """Host inverse-domain table 1/(offset * omega^i), i < N/2, cached."""
        if self._host_u0 is None:
            omega_inv = pow(self.omega, P - 2, P)
            u = pow(self.offset, P - 2, P)
            self._host_u0 = []
            for _ in range(self.domain_length // 2):
                self._host_u0.append(u)
                u = u * omega_inv % P
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
            codeword = self._fold_ints(codeword, u, alpha)
            u = [v * v % P for v in u[: half // 2]]
        proof_stream.push(list(layers[-1]))
        top = self.draw_indices([proof_stream])
        self.queries(layers, trees, top, [proof_stream])
        return top[0].tolist()

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
        # tuples (a, b) and ONE multiproof (prover: queries())
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
