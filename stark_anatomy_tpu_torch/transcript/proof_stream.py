"""ProofStream: the prover<->verifier channel and Fiat-Shamir transform.

Semantics match the reference (ip.py:4-30): an append-only object list
with a read index; the prover's challenge hashes the WHOLE transcript,
the verifier's challenge hashes only the prefix it has read — that
asymmetry is what makes the non-interactive replay line up.

Improvements over the reference: incremental serialization (the reference
re-pickles the entire transcript for every challenge, ip.py:21-25) and a
deterministic binary codec instead of pickle.  A prover may push a run of
objects as their codec bytes (``push_encoded``); such objects are decoded
from the transcript when ``objects`` is first read.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..commit.hashing import blake2s_digest, shake256
from ..errors import MalformedProof
from . import codec


# the place of an object pushed as bytes and not decoded yet
_ENCODED = object()


class ProofStream:
    def __init__(self):
        self._objects: List[codec.TranscriptObject] = []
        self._encoded = 0         # objects in _objects still _ENCODED
        self.read_index = 0
        # Incremental serialization: _buf is always codec.serialize(objects);
        # _offsets[i] = byte length of the serialized prefix of i objects.
        self._buf = bytearray(codec.MAGIC)
        self._offsets = [len(codec.MAGIC)]
        self.prefix = b""  # domain-separation prefix (see SignatureProofStream)

    @property
    def objects(self) -> List[codec.TranscriptObject]:
        if self._encoded:
            for k, obj in enumerate(self._objects):
                if obj is _ENCODED:
                    self._objects[k], end = codec.decode_obj(self._buf, self._offsets[k])
                    assert end == self._offsets[k + 1], "a pushed object's size is not its encoding's"
            self._encoded = 0
        return self._objects

    def push(self, obj: codec.TranscriptObject) -> None:
        self._objects.append(obj)
        self._buf += codec.encode_obj(obj)
        self._offsets.append(len(self._buf))

    def push_encoded(self, data: bytes, sizes: Sequence[int]) -> None:
        """Push a run of objects given as their bytes: ``data`` is
        codec.encode_obj of each one after another, ``sizes`` their
        lengths.  The transcript is as if each had been pushed."""
        ends = (len(self._buf) + np.cumsum(sizes, dtype=np.int64)).tolist()
        self._buf += data
        assert ends[-1] == len(self._buf), "the sizes do not add up to the data"
        self._offsets.extend(ends)
        self._objects.extend([_ENCODED] * len(sizes))
        self._encoded += len(sizes)

    def pull(self) -> codec.TranscriptObject:
        if self.read_index >= len(self.objects):
            raise MalformedProof("transcript exhausted: pull past end")
        obj = self.objects[self.read_index]
        self.read_index += 1
        return obj

    def pull_typed(self, expected_type) -> codec.TranscriptObject:
        """Pull and type-check (malformed proofs can swap object kinds)."""
        obj = self.pull()
        if not isinstance(obj, expected_type):
            raise MalformedProof(
                f"transcript object {self.read_index - 1}: expected "
                f"{getattr(expected_type, '__name__', expected_type)}, "
                f"got {type(obj).__name__}"
            )
        return obj

    def serialize(self) -> bytes:
        return bytes(self._buf)

    def prover_fiat_shamir(self, num_bytes: int = 32) -> bytes:
        return shake256(self.prefix + bytes(self._buf), num_bytes)

    def verifier_fiat_shamir(self, num_bytes: int = 32) -> bytes:
        return shake256(
            self.prefix + bytes(self._buf[: self._offsets[self.read_index]]), num_bytes
        )

    @classmethod
    def deserialize(cls, data: bytes) -> "ProofStream":
        ps = cls()
        for obj in codec.deserialize(data):
            ps.push(obj)
        return ps


class SignatureProofStream(ProofStream):
    """Document-bound transcript: Fiat-Shamir is prefixed with
    blake2s(document) (reference: rpsss.py:7-22)."""

    def __init__(self, document: bytes):
        super().__init__()
        self.document = document
        self.prefix = blake2s_digest(bytes(document))

    @classmethod
    def deserialize_with_document(cls, data: bytes, document: bytes) -> "SignatureProofStream":
        ps = cls(document)
        for obj in codec.deserialize(data):
            ps.push(obj)
        return ps


def push_runs(proof_streams: Sequence[ProofStream], runs: Sequence) -> None:
    """Push into each of B transcripts, run by run, a run's objects of one
    size, then its multiproof.  A run is (objects, data, ends): the
    objects' encodings (B, k, w) uint8 and the B multiproofs as
    codec.encode_bytes_lists gives them."""
    bounds = [(np.concatenate([[0], ends[:-1]]), ends) for _, _, ends in runs]
    for i, ps in enumerate(proof_streams):
        data, sizes = [], []
        for (objects, proofs, _), (lo, hi) in zip(runs, bounds):
            data += [objects[i].tobytes(), proofs[lo[i]:hi[i]].tobytes()]
            sizes += [objects.shape[2]] * objects.shape[1] + [hi[i] - lo[i]]
        ps.push_encoded(b"".join(data), sizes)
