"""Cached binary Merkle trees over blake2s-256, hashed by N1.

The port of stark_anatomy_tpu/commit/merkle.py: ``MerkleTree`` with
``from_limbs`` and ``from_limbs_paired``, the per-shard ``MerkleForest``
and ``ShardedRows``, the stateless ``Merkle``, ``open_multi``,
``verify_multi`` and ``paired_tree_from_ints``; and, for a batch of
trees, ``paired_levels`` and ``MultiproofWalk``, which opens B trees at
B index sets in one walk.  Leaves and levels are hashed in C++ by
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
from .hashing import elt_bytes, hash_leaf, hash_pair


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

    @classmethod
    def of_levels(cls, levels: List[np.ndarray]) -> "MerkleTree":
        """The tree whose levels, leaf digests first, are already hashed."""
        tree = cls.__new__(cls)
        tree.levels = levels
        return tree

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


def paired_levels(layers: np.ndarray) -> List[np.ndarray]:
    """The levels, leaf digests first, of one paired-leaf tree per codeword
    of canonical (B, n, NLIMBS) rows, stacked: level l is (B, n/2^(l+1),
    DIGEST_LEN) and tree b is ``MerkleTree.from_limbs_paired`` of its rows.
    N1 hashes the whole batch's leaves in one call and each level of all B
    trees in one more: a level of B trees pairs digests 2j and 2j + 1
    inside one tree, so the batch's levels stack."""
    B, n = layers.shape[:2]
    assert n > 1 and n & (n - 1) == 0, "row count must be a power of two"
    half = n // 2
    width = layers.shape[2]
    # leaf j of tree b pairs rows b[j] and b[j + n/2]: the first halves
    # stacked, then the second halves, pair row i with row i + B n/2
    level = NB.leaves_from_limb_pairs(np.concatenate(
        [layers[:, :half].reshape(-1, width), layers[:, half:].reshape(-1, width)]))
    levels = [level]
    while level.shape[0] > B:
        level = NB.merkle_level(level)
        levels.append(level)
    return [lv.reshape(B, -1, lv.shape[-1]) for lv in levels]


def paired_trees(layers: np.ndarray) -> List[MerkleTree]:
    """``paired_levels`` as B trees, whose levels are views of the stacked
    ones."""
    stacked = paired_levels(layers)
    return [MerkleTree.of_levels([lv[b] for lv in stacked]) for b in range(len(layers))]


class MerkleForest(MerkleTree):
    """A Merkle tree built as a forest of per-shard subtrees plus a top tree.

    The commitment is bit-identical to the monolithic :class:`MerkleTree`
    over the concatenated leaves: a binary tree over n leaves split into S
    contiguous blocks is S subtrees of depth log2(n/S) joined by a top
    tree of depth log2(S).  Each block is hashed and reduced alone; only
    the S subtree roots meet.  The levels are stitched, so openings are
    the tree's own.
    """

    def __init__(self, shard_leaf_digests: List[np.ndarray]):
        S = len(shard_leaf_digests)
        assert S > 0 and S & (S - 1) == 0, "shard count must be a power of two"
        per = shard_leaf_digests[0].shape[0]
        assert all(d.shape[0] == per for d in shard_leaf_digests), (
            "all shards must hold the same number of leaves"
        )
        sub_levels: List[List[np.ndarray]] = []
        for d in shard_leaf_digests:
            levels = [d]
            while levels[-1].shape[0] > 1:
                levels.append(NB.merkle_level(levels[-1]))
            sub_levels.append(levels)
        # full-tree level k is the concatenation of the shards' levels k
        self.levels = [
            np.concatenate([sl[k] for sl in sub_levels]) for k in range(len(sub_levels[0]))
        ]
        # the top tree over the S subtree roots
        while self.levels[-1].shape[0] > 1:
            self.levels.append(NB.merkle_level(self.levels[-1]))

    @classmethod
    def from_limbs_paired_sharded(cls, canonical_limbs: np.ndarray, num_shards: int) -> "MerkleForest":
        """Paired-leaf forest over a canonical (n, NLIMBS) codeword: pair row
        i with i + n/2, split the n/2 leaves into ``num_shards`` contiguous
        blocks, hash each block alone."""
        n = canonical_limbs.shape[0]
        assert n > 1 and n & (n - 1) == 0
        half = n // 2
        assert half % num_shards == 0
        per = half // num_shards
        blocks = []
        for s in range(num_shards):
            lo = canonical_limbs[s * per : (s + 1) * per]
            hi = canonical_limbs[half + s * per : half + (s + 1) * per]
            blocks.append(NB.leaves_from_limb_pairs(np.concatenate([lo, hi], axis=0)))
        return cls(blocks)


class ShardedRows:
    """Element-major canonical rows of a codeword held as per-shard host
    blocks, never concatenated into one array.

    Reads like a monolithic canonical array (``rows[i]``, ``rows.shape``,
    iteration), mapping a global row to (block, local row).  The blocks are
    contiguous equal slices in global order (a sharded codeword's shards).
    """

    __slots__ = ("blocks", "per", "shape")

    def __init__(self, blocks: List[np.ndarray]):
        self.blocks = blocks
        self.per = blocks[0].shape[0]
        assert all(b.shape == blocks[0].shape for b in blocks)
        self.shape = (self.per * len(blocks),) + blocks[0].shape[1:]

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, i: int) -> np.ndarray:
        return self.blocks[i // self.per][i % self.per]

    def __iter__(self):
        for b in self.blocks:
            yield from b

    def paired_forest(self) -> MerkleForest:
        """The paired-leaf commitment hashed per shard pair: shard s with
        shard s + S/2 (the global pairing i <-> i + n/2 falls on exactly
        that pair), so every leaf and subtree hash reads two shards' blocks
        and only subtree roots meet.  Bit-identical to
        MerkleTree.from_limbs_paired over the concatenated rows."""
        S = len(self.blocks)
        assert S >= 2 and S & (S - 1) == 0
        return MerkleForest([
            NB.leaves_from_limb_pairs(np.concatenate([self.blocks[s], self.blocks[s + S // 2]]))
            for s in range(S // 2)
        ])


class Merkle:
    """The reference's stateless API (reference: merkle.py:3-44)."""

    @staticmethod
    def commit(data_array: Sequence) -> bytes:
        return MerkleTree([bytes(obj) for obj in data_array]).root

    @staticmethod
    def open(index: int, data_array: Sequence) -> List[bytes]:
        return MerkleTree([bytes(obj) for obj in data_array]).open(index)

    @staticmethod
    def verify(root: bytes, index: int, path: List[bytes], data_element) -> bool:
        return MerkleTree.verify_path(root, index, path, hash_leaf(bytes(data_element)))


def paired_tree_from_ints(codeword: Sequence[int]) -> MerkleTree:
    """Paired-leaf tree over a host codeword of canonical ints (leaf i =
    H(LE16(c[i]) || LE16(c[i+n/2]))); matches MerkleTree.from_limbs_paired."""
    half = len(codeword) // 2
    enc = [
        elt_bytes(codeword[i]) + elt_bytes(codeword[i + half])
        for i in range(half)
    ]
    return MerkleTree(enc)


class MultiproofWalk:
    """Which siblings the multiproofs of B leaf-index sets hold, for trees
    of n leaves: walked once for the batch, level by level, over the keys
    b n_l + i of node i of proof b at a level of n_l nodes (every level
    below the root is even, so the sibling k ^ 1 stays in proof b).  At
    each level a known node whose sibling is not known yields that
    sibling, in sorted-index order; then the parents are known.  One walk
    serves every tree opened at the same sets (``digests``).

    ``levels[l]`` is (proof, node) of level l's siblings, proof-major;
    ``order`` puts the concatenated levels in proof order, each proof's
    siblings leaf level first as ``open_multi`` gives them; ``counts[b]``
    is proof b's number of siblings."""

    __slots__ = ("levels", "order", "counts")

    def __init__(self, index_sets: Sequence[Sequence[int]], n: int):
        assert n > 0 and n & (n - 1) == 0, "leaf count must be a power of two"
        B = len(index_sets)
        keys = np.unique(np.concatenate(
            [b * n + np.asarray(s, dtype=np.int64).reshape(-1) for b, s in enumerate(index_sets)]))
        assert keys.size == 0 or (keys[0] >= 0 and keys[-1] < B * n), "cannot open invalid index"
        self.levels = []
        owners = []
        shift = n.bit_length() - 1
        for _ in range(shift):
            # siblings side by side in the sorted keys share a parent: a
            # node that is first under its parent and also last is alone
            # there, and yields its sibling
            parents = keys >> 1
            first = np.empty(keys.size + 1, dtype=bool)
            first[0] = first[-1] = True
            np.not_equal(parents[1:], parents[:-1], out=first[1:-1])
            sib = keys[first[:-1] & first[1:]] ^ 1
            b = sib >> shift
            self.levels.append((b, sib & ((1 << shift) - 1)))
            owners.append(b)
            keys = parents[first[:-1]]
            shift -= 1
        owner = np.concatenate(owners) if owners else np.zeros(0, dtype=np.int64)
        self.order = np.argsort(owner, kind="stable")
        self.counts = np.bincount(owner, minlength=B)

    def digests(self, levels: Sequence[np.ndarray]) -> np.ndarray:
        """The siblings' digests (total, DIGEST_LEN) in proof order, from a
        tree's levels, leaf digests first: stacked (B, n_l, DIGEST_LEN),
        proof b's tree at [b], or one tree's (n_l, DIGEST_LEN) shared by
        every proof.  One fancy index a level."""
        if not self.levels:
            return np.zeros((0, levels[0].shape[-1]), dtype=np.uint8)
        parts = [lv[b, i] if lv.ndim == 3 else lv[i] for lv, (b, i) in zip(levels, self.levels)]
        return np.concatenate(parts)[self.order]


def open_multi(tree, indices) -> List[bytes]:
    """Minimal batched authentication proof for a SET of leaf indices:
    level by level, only siblings that cannot be recomputed from below, in
    sorted-index order (the verifier reproduces it exactly).  A tree on
    the card serves the same bytes through its own gather.  One set walks
    with Python sets: below about a hundred indices that is faster than
    ``MultiproofWalk``'s numpy levels, whose cost a level a batch of sets
    shares."""
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

