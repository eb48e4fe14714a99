"""Batched proving: B STARK proofs of the Rescue-Prime AIR through one
device pipeline.

The port of stark_anatomy_tpu/parallel/batch_prover.py.  FastRPSSS signs
through it with B = 1.  The device phases are parallel/batch.py's
``pipeline`` and ``combination`` over (B, ...) tensors; the per-proof host
work (Merkle roots, Fiat-Shamir challenges, FRI's index draws) loops over
the batch, and the stark's ``timer`` records the JAX package's five
phases (pipeline, commit, combination, fri, openings), the part
``batch.statements`` before them (its part ``batch.draws``, the calls to
``urandom``, inside its first span) and the parts ``fri.rounds`` and
``fri.queries`` of ``fri``.  The batch's randomness draws stay the bytes
``urandom`` gives, 17 a draw in the JAX package's order, are copied to
the device once, and become Montgomery elements by one H13 launch
(field/kernels.py:sample_mont).  The statements share their boundary
zerofiers; their public keys are one H2 launch and their interpolants
one evaluation.  The trees of a commitment or a FRI round are hashed for
the whole batch at once: where the batch lies on a CUDA card
(commit/device_merkle.py:use_device_commit, by the device alone) by one
H4 launch over the canonical codewords where they lie, only the roots
copied out (commit/device_merkle.py: stacked DeviceMerkleTree and
DeviceRows); elsewhere by N1 over copies on the host
(commit/merkle.py:paired_levels).  The batch's proofs are opened
together, by the routines of the one-proof prover at B proofs
(protocols/fri.py:Fri.queries, protocols/fast_stark.py:
FastStark.open_linked): a tree's multiproofs for all B by one sibling
walk, its values by one gather, each encoded in bulk.  FRI folds the
whole batch on the device at every B, one H7 launch a round
(field/kernels.py:fri_fold_batched): the JAX package's host branch below
B*N = 2^14 (HOST_FRI_MAX) is not ported, since the card's fold is faster
than the host's at B = 1 too (PERF.md, tools/port_fri_branch.py).
``make_batch_rpsss`` signs a batch of documents at the production
parameters or at a ``config``'s (the JAX package's BASELINE config 5 is
a batch of 64).  With a ``mesh`` the batch splits over its dp axis: each
group of B/dp proofs runs on its row's first device (a prover per
device), with the bytes of the unsplit batch.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch

from ..commit import kernels as MK
from ..commit.device_merkle import DeviceMerkleTree, DeviceRows, root_rows, use_device_commit
from ..commit.merkle import MerkleTree, paired_levels
from ..config import RPSSS_CONFIG
from ..field import kernels as K
from ..field import ops as F
from ..field.limbs import NLIMBS
from ..field.scalar import Field, FieldElement
from ..models import rescue_prime as RP
from ..protocols.fast_stark import FastStark, TransitionZerofier
from ..transcript import codec
from ..transcript.proof_stream import SignatureProofStream
from ..utils.convert import device_from_ints, ints_from_device, limb_rows_np
from .batch import combination, pipeline

# The span of a batch's statements: the draws and their conversion, the
# public keys (rp.hash, on the card) and the boundary tables, before
# ``pipeline``; and its part of the ``urandom`` calls alone.  The names are
# parts' (utils/profiling.py), so the phase table keeps exactly the JAX
# package's five phases.
STATEMENTS = "batch.statements"
DRAWS = "batch.draws"
SAMPLE = K.SAMPLE_BYTES


class BatchProver:
    """Batched FastStark prover for the Rescue-Prime AIR.  With ``mesh``
    (parallel/mesh.py), a batch whose size dp divides runs in dp groups,
    group g on the first device of the mesh's row g (under
    torch.distributed, each rank its row's group, and the proofs are
    gathered); the proofs are the unsplit batch's, byte for byte."""

    def __init__(
        self,
        stark: FastStark,
        rp,
        transition_zerofier: TransitionZerofier,
        mesh=None,
        air=None,
    ):
        self.stark = stark
        self.rp = rp
        self.tz = transition_zerofier
        self.mesh = mesh
        self.field = Field.main()
        # the symbolic AIR expansion (rhs**3, thousands of monomials) is
        # expensive: callers that already built it pass it in
        self.air = air if air is not None else rp.transition_constraints(stark.omicron)
        self._air_constants = RP.rescue_air_tables(stark)
        self._on_device = {stark.device: self}
        # the route of the batch's trees, all or nothing: H4 where the
        # codewords lie on a card, else N1 on the host
        self.device_trees = use_device_commit(device=stark.device)

    def _prover_on(self, device) -> "BatchProver":
        """The prover of this one's parameters on ``device``."""
        device = torch.device(device)
        if device not in self._on_device:
            s = self.stark
            stark = FastStark(s.field, s.expansion_factor, s.num_colinearity_checks, s.security_level,
                              s.num_registers, s.original_trace_length,
                              transition_constraints_degree=s.transition_constraints_degree,
                              device=device)
            self._on_device[device] = BatchProver(stark, self.rp, stark.preprocess(), air=self.air)
        return self._on_device[device]

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
        then B*(max_degree+1), one call a draw.  Their bytes are kept as
        they come; each group of the mesh converts its own on its device."""
        stark = self.stark
        B = len(inputs)
        width = stark.num_registers * stark.num_randomizers
        depth = stark.max_degree(self.air) + 1
        mesh = self.mesh
        dist = mesh is not None and mesh.backend == "dist"
        draws = None
        if not dist or mesh.rank == 0:
            with stark.timer.phase(STATEMENTS), stark.timer.phase(DRAWS):
                draws = b"".join([urandom(SAMPLE) for _ in range(B * (width + depth))])
        if dist:
            draws = mesh.broadcast(draws)
        if mesh is None or B % mesh.shape["dp"]:
            return self._prove(inputs, proof_streams, draws)
        b = B // mesh.shape["dp"]
        proofs = {}
        for g in ([mesh.dp_index] if dist else range(mesh.shape["dp"])):
            lo, hi = g * b, (g + 1) * b
            rows = draws[lo * width * SAMPLE: hi * width * SAMPLE]
            poly = draws[(B * width + lo * depth) * SAMPLE: (B * width + hi * depth) * SAMPLE]
            proofs[g] = self._prover_on(mesh.devices[g][0])._prove(
                inputs[lo:hi], proof_streams[lo:hi], rows + poly)
        if dist:
            for part in mesh.gather_all(proofs):
                proofs.update(part)
        return [p for g in sorted(proofs) for p in proofs[g]]

    def _prove(self, inputs, proof_streams, draws: bytes) -> List[bytes]:
        """The proofs of ``inputs`` on this prover's device from the draws'
        bytes, 17 a draw: B*R*nrand randomizer rows, then B*(max_degree+1)
        randomizer polynomial coefficients."""
        stark = self.stark
        rp = self.rp
        dev = stark.device
        B = len(inputs)
        R = stark.num_registers
        nrand = stark.num_randomizers

        width = R * nrand
        max_degree = len(draws) // (SAMPLE * B) - width - 1
        timer = stark.timer

        with timer.phase(STATEMENTS):
            sk_dev = device_from_ints([inp.value for inp in inputs], dev)
            # the public keys rp.hash(sk), by one H2 launch for the batch
            boundaries = [rp.boundary_constraints(FieldElement(pk, self.field))
                          for pk in ints_from_device(RP.hash_batch(sk_dev))]
            # the draws' values (8, n), by one copy and one H13 launch
            raw = torch.frombuffer(bytearray(draws), dtype=torch.uint8).view(-1, SAMPLE)
            vals = K.sample_mont(raw.to(dev))
            rand_rows = vals[:, :B * width].reshape(NLIMBS, B, R, nrand).permute(1, 2, 0, 3)
            rand_poly = vals[:, B * width:].reshape(NLIMBS, B, max_degree + 1).permute(1, 0, 2)
            # (R, L, N) zerofiers shared by the batch, (B, R, L, N) interpolants
            inv_bz, interp = stark._boundary_tables_batch(boundaries)

        # the JAX package's five phases (parallel/batch_prover.py:prove_batch);
        # each ends in a copy to the host, in host work or in a
        # synchronisation, so its seconds hold its device work
        with timer.phase("pipeline"):
            bq_lde, tq_lde, rand_lde = pipeline(
                stark, self._air_constants, sk_dev, rand_rows, rand_poly, inv_bz, interp,
                self.tz.inv_codeword,
            )
            # the R boundary quotients and the randomizer, (B, R + 1, L, N)
            committed = F.from_mont(torch.cat([bq_lde, rand_lde[:, None]], dim=1))
            stark._sync()

        # per-proof commitments + Fiat-Shamir weights; the trees stay
        # stacked, proof b's at [b], for the openings
        with timer.phase("commit"):
            opened, roots = self._commit(committed)                 # roots (B, R + 1, 32)
            weight_vals = []
            n_weights = 1 + 2 * len(self.air) + 2 * R
            for i in range(B):
                ps = proof_streams[i]
                for root in roots[i]:
                    ps.push(root.tobytes())
                weight_vals += [w.value for w in stark.sample_weights(n_weights, ps.prover_fiat_shamir())]
            weights = (device_from_ints(weight_vals, dev).reshape(NLIMBS, B, n_weights)
                       .permute(1, 2, 0).unsqueeze(-1).contiguous())   # (B, W, L, 1)

        with timer.phase("combination"):
            tq_bounds = stark.transition_quotient_degree_bounds(self.air)
            bq_bounds = stark.boundary_quotient_degree_bounds(
                stark.randomized_trace_length, boundaries[0]
            )
            tq_shift = torch.stack([stark._x_lde_pow(max_degree - b) for b in tq_bounds])
            bq_shift = torch.stack([stark._x_lde_pow(max_degree - b) for b in bq_bounds])
            combos = combination(bq_lde, tq_lde, rand_lde, weights, tq_shift, bq_shift)

        with timer.phase("fri"):
            top = self._fri_batch(combos, proof_streams)

        with timer.phase("openings"):
            stark.open_linked(proof_streams, top, opened + [(self.tz.rows, self.tz.tree)])
            proofs = [ps.serialize() for ps in proof_streams]
        return proofs

    # ------------------------------------------------------------------
    def _commit(self, canon: torch.Tensor):
        """One paired-leaf tree per codeword of B proofs' C canonical
        codewords each, (B, C, L, n): where they lie on the card, one H4
        launch for all B*C trees and one copy of their roots; elsewhere N1
        (``paired_levels``) on one copy to the host as element-major rows.
        Returns, per codeword c, the rows and the tree that hold the B
        proofs' stacked (proof b opens its own at [b]), and the roots (B, C,
        DIGEST_LEN) uint8."""
        B, C = canon.shape[:2]
        if self.device_trees:
            flat = MK.merkle_paired(canon)
            return ([(DeviceRows(canon[:, c]), DeviceMerkleTree(flat[:, c])) for c in range(C)],
                    root_rows(flat).reshape(B, C, -1))
        rows = limb_rows_np(canon)                          # (B, C, n, L)
        levels = [lv.reshape((B, C) + lv.shape[1:])
                  for lv in paired_levels(rows.reshape((B * C,) + rows.shape[2:]))]
        return ([(rows[:, c], MerkleTree.of_levels([lv[:, c] for lv in levels])) for c in range(C)],
                levels[-1][:, :, 0])

    def _fri_batch(self, codewords: torch.Tensor, proof_streams: List) -> List[List[int]]:
        """Batched FRI prove over (B, L, N) Montgomery codewords (the JAX
        package's _fri_batch), byte for byte the transcripts of
        ``Fri.prove_host``.  A round commits the canonical layer, one
        paired-leaf tree per proof (``_commit``: H4 where it lies on the
        card, N1 on a host copy), draws the B challenges and folds the
        batch in one H7 launch, whose canonical output is the next round's
        layer.  Then each proof's last layer in the clear (on the card's
        route the one layer copied out), and the query rounds of the whole
        batch (``Fri.queries``).  Returns each proof's top-level indices."""
        fri = self.stark.fri
        timer = self.stark.timer
        dev = codewords.device
        u = fri._initial_u(dev)
        codeword = codewords.contiguous()
        layers, trees = [], []                         # per round, the B proofs' stacked
        num = fri.num_rounds()
        with timer.phase("fri.rounds"):
            canon = F.from_mont(codeword)                  # (B, L, N)
            for r in range(num):
                [(rows, tree)], roots = self._commit(canon[:, None])
                layers.append(rows)
                trees.append(tree)
                for i, ps in enumerate(proof_streams):
                    ps.push(roots[i, 0].tobytes())
                if r == num - 1:
                    break
                alphas = [self.field.sample(ps.prover_fiat_shamir()).value for ps in proof_streams]
                alpha_dev = device_from_ints(alphas, dev).t().contiguous().unsqueeze(-1)  # (B, L, 1)
                codeword, canon, u = K.fri_fold_batched(codeword, u, alpha_dev)
            last_rows = limb_rows_np(canon)                    # (B, n, L)

        with timer.phase("fri.queries"):
            last = codec.encode_felt_lists(last_rows)
            for i, ps in enumerate(proof_streams):
                ps.push_encoded(last[i].tobytes(), (last.shape[1],))
            top = fri.draw_indices(proof_streams)
            fri.queries(layers, trees, top, proof_streams)
        return top.tolist()


def make_batch_rpsss(device=None, urandom=os.urandom, config=None):
    """A batch signer at FastRPSSS's production parameters, or at
    ``config`` (a StarkConfig, as ``FastRPSSS`` takes), like the JAX
    package's make_batch_rpsss: returns (prover, keygen, sign_batch).
    ``sign_batch(sks, documents)`` returns one signature per document, each
    of which verifies under ``FastRPSSS.verify`` with its own pk.  It runs
    on the CUDA card unless ``device="cpu"``; randomness comes from
    ``urandom``."""
    field = Field.main()
    rp = RP.RescuePrime()
    stark = FastStark.from_config(config or RPSSS_CONFIG, field, device=device)
    tz = stark.preprocess()
    prover = BatchProver(stark, rp, tz)

    def keygen():
        sk = field.sample(urandom(17))
        return sk, rp.hash(sk)

    def sign_batch(sks: Sequence[FieldElement], documents: Sequence[bytes]) -> List[bytes]:
        streams = [SignatureProofStream(doc) for doc in documents]
        return prover.prove_batch(list(sks), streams, urandom=urandom)

    return prover, keygen, sign_batch
