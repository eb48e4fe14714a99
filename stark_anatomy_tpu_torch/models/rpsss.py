"""RPSSS: the Rescue-Prime STARK Signature Scheme, slow and fast.

The port of stark_anatomy_tpu/models/rpsss.py (reference: rpsss.py:24-64,
fast_rpsss.py:24-65): sk is a random field element, pk = RescuePrime
hash(sk), and a signature is a zk-STARK proof of preimage knowledge under
a document-bound Fiat-Shamir transcript, at the production parameters
(expansion 4, 64 colinearity checks, security 128, AIR degree 3).
``RPSSS`` proves with the slow scalar ``Stark`` (minutes a signature at
these parameters, as in the reference), ``FastRPSSS`` with ``FastStark``.

``RPSSS()`` and ``FastRPSSS()`` run on the CUDA card and raise if there is
none; ``device="cpu"`` runs the plain PyTorch path.  Randomness comes
from ``urandom=`` (default ``os.urandom``), so a seeded caller gets
reproducible bytes.
"""

from __future__ import annotations

import os
from typing import Tuple

from ..config import RPSSS_CONFIG
from ..field.scalar import Field, FieldElement
from ..parallel.batch_prover import BatchProver
from ..protocols.fast_stark import FastStark
from ..protocols.stark import Stark
from ..transcript.proof_stream import SignatureProofStream
from .rescue_prime import RescuePrime, make_index_air_evaluator, make_point_air


class RPSSS:
    """Signature scheme over the slow scalar Stark (reference: rpsss.py:24-64)."""

    stark_class = Stark

    def __init__(self, device=None, config=None):
        self.field = Field.main()
        self.rp = RescuePrime()
        self.config = config or RPSSS_CONFIG
        self.stark = self.stark_class.from_config(self.config, self.field, device=device)
        self.device = self.stark.device

    def _air(self):
        # symbolic constraints are proof-independent; the rhs**3 expansion
        # is thousands of monomials, so build once per scheme instance
        if not hasattr(self, "_air_cache"):
            self._air_cache = self.rp.transition_constraints(self.stark.omicron)
        return self._air_cache

    def stark_prove(self, input_element: FieldElement, proof_stream, urandom=os.urandom) -> bytes:
        output_element = self.rp.hash(input_element)
        trace = self.rp.trace(input_element)
        return self.stark.prove(
            trace, self._air(), self.rp.boundary_constraints(output_element), proof_stream,
            urandom=urandom,
        )

    def stark_verify(self, output_element, stark_proof, document) -> bool:
        return self.stark.verify(
            stark_proof,
            self._air(),
            self.rp.boundary_constraints(output_element),
            proof_stream_factory=lambda proof: SignatureProofStream.deserialize_with_document(
                proof, document
            ),
        )

    def keygen(self, urandom=os.urandom) -> Tuple[FieldElement, FieldElement]:
        sk = self.field.sample(urandom(17))
        pk = self.rp.hash(sk)
        return sk, pk

    def sign(self, sk: FieldElement, document: bytes, urandom=os.urandom) -> bytes:
        return self.stark_prove(sk, SignatureProofStream(document), urandom=urandom)

    def verify(self, pk: FieldElement, document: bytes, signature: bytes) -> bool:
        return self.stark_verify(pk, signature, document)


class FastRPSSS(RPSSS):
    """Signature scheme over FastStark, signing through BatchProver (B = 1)."""

    stark_class = FastStark

    def __init__(self, device=None, config=None):
        super().__init__(device, config)
        self.transition_zerofier = self.stark.preprocess()
        self._point_air = None
        self._index_air = None
        self._batch_prover = None

    def _prover(self) -> BatchProver:
        if self._batch_prover is None:
            self._batch_prover = BatchProver(
                self.stark, self.rp, self.transition_zerofier, air=self._air()
            )
        return self._batch_prover

    def stark_prove(self, input_element: FieldElement, proof_stream, urandom=os.urandom) -> bytes:
        return self._prover().prove_batch([input_element], [proof_stream], urandom=urandom)[0]

    def stark_verify(self, output_element, stark_proof, document) -> bool:
        if self._index_air is None:
            self._point_air = make_point_air(self.stark)
            self._index_air = make_index_air_evaluator(self.stark)
        boundary = self.rp.boundary_constraints(output_element)
        return self.stark.verify(
            stark_proof,
            self._air(),
            boundary,
            self.transition_zerofier.root,
            proof_stream_factory=lambda proof: SignatureProofStream.deserialize_with_document(
                proof, document
            ),
            air_point_evaluator=self._point_air,
            air_index_evaluator=self._index_air,
        )
