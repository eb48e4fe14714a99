"""Batched proving: B STARK proofs of the Rescue-Prime AIR through one
device pipeline.

The port of stark_anatomy_tpu/parallel/batch_prover.py.  FastRPSSS signs
through it with B = 1.  The device phases run as (B, ...) tensors over the
field kernels; the per-proof host work (Merkle roots, Fiat-Shamir
challenges, transcript assembly) loops over the batch, and the stark's
``timer`` records the JAX package's five phases (pipeline, commit,
combination, fri, openings).  Ported: the host-FRI branch, taken while
B*N <= HOST_FRI_MAX (a signature is B = 1, N = 4096).  The batched device
FRI (``_fri_batch``) waits for the batch signing slice.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch

from ..commit.merkle import MerkleTree, open_multi
from ..field import ops as F
from ..field.limbs import NLIMBS
from ..field.scalar import Field, FieldElement
from ..models import rescue_prime as RP
from ..ops import ntt as NTT
from ..ops.domain import mont_const
from ..protocols.fast_stark import FastStark, TransitionZerofier
from ..commit.device_merkle import gather_rows
from ..utils.convert import canonical_np, device_from_ints, int_from_row


class BatchProver:
    """Batched FastStark prover for the Rescue-Prime AIR."""

    # below B*N total codeword elements, FRI runs entirely on the host
    HOST_FRI_MAX = 1 << 14

    def __init__(
        self,
        stark: FastStark,
        rp,
        transition_zerofier: TransitionZerofier,
        air=None,
    ):
        self.stark = stark
        self.rp = rp
        self.tz = transition_zerofier
        self.field = Field.main()
        # the symbolic AIR expansion (rhs**3, thousands of monomials) is
        # expensive: callers that already built it pass it in
        self.air = air if air is not None else rp.transition_constraints(stark.omicron)
        self._air_eval = RP.make_air_evaluator(stark)
        stark._interp_tables()

    # ------------------------------------------------------------------
    def _phase1_impl(self, sk_batch, randomizer_cols, rand_poly, inv_bz, interp):
        """sk (L, B); randomizers (B, R, L, nrand); rand_poly (B, L, D+1);
        inv_bz/interp (B, R, L, N) boundary tables.  The whole
        pre-commitment pipeline: trace -> LDE -> AIR quotients -> boundary
        quotients -> randomizer LDE."""
        stark = self.stark
        t = stark._interp_tables()
        traces = RP.trace_batch(sk_batch)                  # (n_cyc, m, L, B)
        cols = traces.permute(3, 1, 2, 0)                  # (B, R, L, n_cyc)
        cols = torch.cat([cols, randomizer_cols], dim=-1)
        trace_lde = stark._trace_lde(cols)                 # (B, R, L, N)
        next_lde = torch.roll(trace_lde, -stark.expansion_factor, dims=-1)
        constraint = self._air_eval(t["x_lde"], trace_lde, next_lde)
        tq_lde = F.mont_mul(constraint, self.tz.inv_codeword)
        rand_lde = NTT.coset_evaluate(rand_poly, stark.generator.value, stark.fri_domain_length)
        bq_lde = F.mont_mul(F.sub(trace_lde, interp), inv_bz)
        return bq_lde, tq_lde, rand_lde

    def _phase2_impl(self, bq_lde, tq_lde, rand_lde, weights, tq_shift, bq_shift):
        """weights: (B, W, L, 1).  Returns the combination codeword (B, L, N):
        all W terms in the transcript's weight order (randomizer, then per
        constraint [tq, shifted tq], then per register [bq, shifted bq])."""
        tq_t = tq_lde.movedim(1, 0)                        # (C, B, L, N)
        bq_t = bq_lde.movedim(1, 0)                        # (R, B, L, N)
        sh_tq = F.mont_mul(tq_shift[:, None], tq_t)
        sh_bq = F.mont_mul(bq_shift[:, None], bq_t)
        terms = torch.cat([
            rand_lde[None],
            torch.stack([tq_t, sh_tq], dim=1).reshape((-1,) + tq_t.shape[1:]),
            torch.stack([bq_t, sh_bq], dim=1).reshape((-1,) + bq_t.shape[1:]),
        ])                                                 # (W, B, L, N)
        return F.weighted_sum(terms, weights.movedim(1, 0))

    # ------------------------------------------------------------------
    def prove_batch(
        self,
        inputs: Sequence[FieldElement],
        proof_streams: List,
        urandom=os.urandom,
    ) -> List[bytes]:
        """Prove knowledge of each input (hash preimage): one proof per
        transcript in ``proof_streams``.  Randomness comes from ``urandom``
        in the JAX package's order and sizes: B*R*nrand draws of 17 bytes,
        then B*(max_degree+1)."""
        stark = self.stark
        rp = self.rp
        dev = stark.device
        B = len(inputs)
        R = stark.num_registers
        N = stark.fri_domain_length
        nrand = stark.num_randomizers
        if B * N > self.HOST_FRI_MAX:
            raise NotImplementedError(
                "batched device FRI (stark_anatomy_tpu/parallel/batch_prover.py:"
                "_fri_batch) is not ported yet"
            )

        boundaries = [rp.boundary_constraints(rp.hash(inp)) for inp in inputs]
        sk_dev = device_from_ints([inp.value for inp in inputs], dev)
        rand_rows = device_from_ints(
            [self.field.sample(urandom(17)).value for _ in range(B * R * nrand)], dev
        ).reshape(NLIMBS, B, R, nrand).permute(1, 2, 0, 3)
        max_degree = stark.max_degree(self.air)
        rand_poly = device_from_ints(
            [self.field.sample(urandom(17)).value for _ in range(B * (max_degree + 1))], dev
        ).reshape(NLIMBS, B, max_degree + 1).permute(1, 0, 2)

        tables = [stark._boundary_tables(b) for b in boundaries]
        inv_bz = torch.stack([tb[0] for tb in tables])     # (B, R, L, N)
        interp = torch.stack([tb[1] for tb in tables])

        # the JAX package's five phases (parallel/batch_prover.py:prove_batch);
        # each ends in a copy to the host or in host work, so it waits for
        # the card without a synchronisation of its own
        timer = stark.timer
        with timer.phase("pipeline"):
            bq_lde, tq_lde, rand_lde = self._phase1_impl(
                sk_dev, rand_rows, rand_poly, inv_bz, interp
            )
            bq_np = canonical_np(bq_lde)                   # (B, R, N, L)
            rand_np = canonical_np(rand_lde)               # (B, N, L)

        # per-proof commitments + Fiat-Shamir weights
        with timer.phase("commit"):
            bq_trees = [
                [MerkleTree.from_limbs_paired(bq_np[i][s]) for s in range(R)]
                for i in range(B)
            ]
            rand_trees = [MerkleTree.from_limbs_paired(rand_np[i]) for i in range(B)]
            weight_cols = []
            n_weights = 1 + 2 * len(self.air) + 2 * R
            for i in range(B):
                ps = proof_streams[i]
                for s in range(R):
                    ps.push(bq_trees[i][s].root)
                ps.push(rand_trees[i].root)
                ws = stark.sample_weights(n_weights, ps.prover_fiat_shamir())
                weight_cols.append(torch.stack([mont_const(w.value, dev) for w in ws]))
            weights = torch.stack(weight_cols)             # (B, W, L, 1)

        with timer.phase("combination"):
            tq_bounds = stark.transition_quotient_degree_bounds(self.air)
            bq_bounds = stark.boundary_quotient_degree_bounds(
                stark.randomized_trace_length, boundaries[0]
            )
            tq_shift = torch.stack([stark._x_lde_pow(max_degree - b) for b in tq_bounds])
            bq_shift = torch.stack([stark._x_lde_pow(max_degree - b) for b in bq_bounds])
            combos = self._phase2_impl(bq_lde, tq_lde, rand_lde, weights, tq_shift, bq_shift)

        # FRI on the host: one transfer of the combination codewords
        with timer.phase("fri"):
            combo_np = canonical_np(combos)                # (B, N, L)
            indices_per_proof = []
            for i in range(B):
                ints = [int_from_row(combo_np[i][j]) for j in range(N)]
                indices_per_proof.append(stark.fri.prove_host(ints, proof_streams[i]))

        # linked openings per proof (paired leaves: multiproof over the
        # reduced index set, values at the full quadrupled set)
        proofs = []
        with timer.phase("openings"):
            for i in range(B):
                ps = proof_streams[i]
                indices = indices_per_proof[i]
                duplicated = indices + [(idx + stark.expansion_factor) % N for idx in indices]
                quadrupled = sorted(duplicated + [(idx + N // 2) % N for idx in duplicated])
                leaf_indices = sorted({idx % (N // 2) for idx in duplicated})
                for s in range(R):
                    ps.push(gather_rows(bq_np[i][s], quadrupled))
                    ps.push(open_multi(bq_trees[i][s], leaf_indices))
                ps.push(gather_rows(rand_np[i], quadrupled))
                ps.push(open_multi(rand_trees[i], leaf_indices))
                ps.push(gather_rows(self.tz.rows, quadrupled))
                ps.push(open_multi(self.tz.tree, leaf_indices))
                proofs.append(ps.serialize())
        return proofs
