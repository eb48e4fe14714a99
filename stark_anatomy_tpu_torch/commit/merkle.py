"""Cached binary Merkle trees over blake2s-256, hashed by N1.

The port of stark_anatomy_tpu/commit/merkle.py: ``MerkleTree`` with
``from_limbs`` and ``from_limbs_paired``, ``open_multi``, ``verify_multi``
and ``paired_tree_from_ints``.  Leaves and levels are hashed in C++ by
commit/native.py (N1), as the JAX package hashes them through
native/blake2b_batch.py; the hashlib versions there are the plain ones.
A tree built on the card is a commit/device_merkle.py:DeviceMerkleTree,
with the same roots, paths and multiproofs.

A field element hashes as its 16-byte little-endian canonical value; a
PAIRED leaf i covers rows i and i + n/2 (the FRI fold pairing).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import native as NB
from .hashing import elt_bytes, hash_pair


class MerkleTree:
    """A fully materialized Merkle tree.

    levels[0] is the leaf-digest layer ((n, DIGEST_LEN) uint8); levels[-1]
    is (1, DIGEST_LEN).
    """

    __slots__ = ("levels",)

    def __init__(self, leaf_encodings: Sequence[bytes] = None, _digests: np.ndarray = None):
        if _digests is None:
            n = len(leaf_encodings)
            assert n > 0 and n & (n - 1) == 0, "leaf count must be a power of two"
            _digests = NB.hash_encodings(list(leaf_encodings))
        self.levels: List[np.ndarray] = [_digests]
        level = _digests
        while level.shape[0] > 1:
            level = NB.merkle_level(level)
            self.levels.append(level)

    @classmethod
    def from_limbs(cls, canonical_limbs: np.ndarray) -> "MerkleTree":
        """Commit to canonical (n, NLIMBS) limb rows, one leaf per element:
        blake2s-256 over its 16-byte little-endian encoding."""
        n = canonical_limbs.shape[0]
        assert n > 0 and n & (n - 1) == 0, "leaf count must be a power of two"
        return cls(_digests=NB.leaves_from_limbs(canonical_limbs))

    @classmethod
    def from_limbs_paired(cls, canonical_limbs: np.ndarray) -> "MerkleTree":
        """Commit to a codeword given as canonical (n, NLIMBS) limb rows with
        PAIRED leaves: leaf i covers rows i and i + n/2."""
        n = canonical_limbs.shape[0]
        assert n > 1 and n & (n - 1) == 0, "row count must be a power of two"
        return cls(_digests=NB.leaves_from_limb_pairs(canonical_limbs))

    @property
    def root(self) -> bytes:
        return self.levels[-1][0].tobytes()

    def __len__(self) -> int:
        return self.levels[0].shape[0]

    def open(self, index: int) -> List[bytes]:
        """Authentication path (sibling digests, leaf level first)."""
        assert 0 <= index < len(self), "cannot open invalid index"
        path = []
        for level in self.levels[:-1]:
            path.append(level[index ^ 1].tobytes())
            index >>= 1
        return path

    @staticmethod
    def verify_path(root: bytes, index: int, path: List[bytes], leaf_digest: bytes) -> bool:
        assert 0 <= index < (1 << len(path)), "cannot verify invalid index"
        acc = leaf_digest
        for sibling in path:
            if index & 1:
                acc = hash_pair(sibling, acc)
            else:
                acc = hash_pair(acc, sibling)
            index >>= 1
        return acc == root


def paired_tree_from_ints(codeword: Sequence[int]) -> MerkleTree:
    """Paired-leaf tree over a host codeword of canonical ints (leaf i =
    H(LE16(c[i]) || LE16(c[i+n/2]))); matches MerkleTree.from_limbs_paired."""
    half = len(codeword) // 2
    enc = [
        elt_bytes(codeword[i]) + elt_bytes(codeword[i + half])
        for i in range(half)
    ]
    return MerkleTree(enc)


def open_multi(tree, indices) -> List[bytes]:
    """Minimal batched authentication proof for a SET of leaf indices:
    level by level, only siblings that cannot be recomputed from below, in
    sorted-index order (the verifier reproduces it exactly).  A tree on
    the card serves the same bytes through its own gather."""
    if hasattr(tree, "multiproof"):
        return tree.multiproof(indices)
    known = sorted(set(indices))
    proof: List[bytes] = []
    for level in tree.levels[:-1]:
        known_set = set(known)
        for i in known:
            if i ^ 1 not in known_set:
                proof.append(level[i ^ 1].tobytes())
        known = sorted({i >> 1 for i in known})
    return proof


def verify_multi(
    root: bytes,
    depth: int,
    leaf_digests: dict,
    proof: List[bytes],
) -> bool:
    """Verify a multiproof.  leaf_digests: {index: digest}."""
    nodes = dict(leaf_digests)
    pos = 0
    for _ in range(depth):
        known = sorted(nodes)
        known_set = set(known)
        parents = {}
        for i in known:
            if i ^ 1 in known_set and (i & 1):
                continue  # handled with its even sibling
            if i ^ 1 in known_set:
                left, right = nodes[i], nodes[i | 1]
            else:
                if pos >= len(proof):
                    return False
                sib = proof[pos]
                pos += 1
                if i & 1:
                    left, right = sib, nodes[i]
                else:
                    left, right = nodes[i], sib
            parents[i >> 1] = hash_pair(left, right)
        nodes = parents
    return pos == len(proof) and nodes.get(0) == root

