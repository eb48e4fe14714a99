"""Hash primitives for commitments and transcripts.

Commitment scheme: blake2s-256 over FIXED-WIDTH encodings — a field
element hashes as its 16-byte little-endian canonical value.  DEVIATIONS
(DEVIATIONS.md): the reference uses blake2b-512 over decimal-string
encodings (merkle.py:6, algebra.py:56-57).  32-byte digests give 128-bit
collision resistance matching the 128-bit protocol target and halve proof
size.  The trees hash the same messages in C++ (commit/native.py, N1)
and on the card (commit/device_merkle.py, H4); the functions here hash
one message with hashlib.  shake_256 drives Fiat-Shamir and blake2s binds
signatures to documents, as in the reference (ip.py:1, rpsss.py:3).
"""

from __future__ import annotations

from hashlib import blake2s, shake_256

DIGEST_LEN = 32


def elt_bytes(v: int) -> bytes:
    """Consensus leaf encoding of a canonical field element."""
    return v.to_bytes(16, "little")


def hash_leaf(data: bytes) -> bytes:
    return blake2s(data).digest()


def hash_pair(left: bytes, right: bytes) -> bytes:
    return blake2s(left + right).digest()


def hash_paired_leaf(v0: int, v1: int) -> bytes:
    """Digest of a PAIRED codeword leaf covering values at i and i+n/2
    (the message that N1's stark_leaves_from_limb_pairs_s and H4 hash)."""
    return blake2s(elt_bytes(v0) + elt_bytes(v1)).digest()


def shake256(data: bytes, num_bytes: int = 32) -> bytes:
    return shake_256(data).digest(num_bytes)


def blake2s_digest(data: bytes) -> bytes:
    return blake2s(data).digest()
