"""Cached binary Merkle trees over blake2s-256, hashed by N1.

The port of stark_anatomy_tpu/commit/merkle.py: ``MerkleTree`` with
``from_limbs`` and ``from_limbs_paired``, the per-shard ``MerkleForest``
and ``ShardedRows``, the stateless ``Merkle``, ``open_multi``,
``verify_multi`` and ``paired_tree_from_ints``; and, for a batch of
trees, ``paired_levels``.  ``MultiproofWalk`` alone decides which
siblings a multiproof holds, for B index sets at once, and every kind of
tree serves the digests it names (``digests_at``); ``open_multi`` is the
walk of one set.  Leaves and levels are hashed in C++ by
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
from .hashing import DIGEST_LEN, elt_bytes, hash_leaf, hash_pair


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
        """The tree whose levels, leaf digests first, are already hashed;
        or B trees' stacked levels (B, n_l, DIGEST_LEN) (``paired_levels``),
        which a walk opens at each proof's own tree (they have no one
        ``root``)."""
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
        return open_multi(self, [index])

    def digests_at(self, level: np.ndarray, proof: np.ndarray, node: np.ndarray) -> np.ndarray:
        """The digests (k, DIGEST_LEN) at (level, proof, node), level by
        level (``MultiproofWalk``'s order): one fancy index a level, proof
        b's tree at [b] of stacked levels, the one tree of every proof
        otherwise."""
        cuts = np.searchsorted(level, np.arange(len(self.levels) + 1))
        return np.concatenate([
            lv[proof[a:b], node[a:b]] if lv.ndim == 3 else lv[node[a:b]]
            for lv, a, b in zip(self.levels, cuts[:-1], cuts[1:])
        ])

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
    of n leaves: the one walk of every prover, for host, card and forest
    trees alike.  A level's known nodes are the keys b n_l + i of node i
    of proof b at a level of n_l nodes (every level below the root is
    even, so the sibling k ^ 1 stays in proof b); a known node whose
    sibling is not known yields that sibling, in sorted-index order, and
    then the parents are known.  All levels at once: row l of a
    (depth + 1, k) table holds the sorted leaf keys shifted right by l, so
    each node of level l starts a run of equal keys in row l, and its
    parent's run in row l + 1 starts at the same column or before.  A node
    is alone under its parent when its run starts the parent's run and
    the next run of its row starts another parent's (or there is none).
    One walk serves every tree opened at the same sets (``digests``).

    ``level``, ``proof`` and ``node`` name the siblings level by level,
    proof-major within a level; ``order`` puts them in proof order, each
    proof's siblings leaf level first as ``open_multi`` gives them;
    ``counts[b]`` is proof b's number of siblings."""

    __slots__ = ("level", "proof", "node", "order", "counts")

    def __init__(self, index_sets: Sequence[Sequence[int]], n: int):
        assert n > 0 and n & (n - 1) == 0, "leaf count must be a power of two"
        sets = [np.asarray(s, dtype=np.int64).reshape(-1) for s in index_sets]
        flat = np.concatenate(sets)
        assert flat.size == 0 or (flat.min() >= 0 and flat.max() < n), "cannot open invalid index"
        keys = np.unique(np.repeat(np.arange(len(sets)) * n, [s.size for s in sets]) + flat)
        depth = n.bit_length() - 1
        rows = keys >> np.arange(depth + 1)[:, None]          # (depth + 1, k): row l, level l
        starts = np.ones(rows.shape, dtype=bool)
        np.not_equal(rows[:, 1:], rows[:, :-1], out=starts[:, 1:])
        first = np.flatnonzero(starts[:-1])                    # a node's first column, level < depth
        heads = starts[1:].reshape(-1)[first]                  # ... starts its parent's run
        alone = heads & np.append(heads[1:], True)
        at = first[alone]
        sib = rows[:-1].reshape(-1)[at] ^ 1
        self.level = at // max(keys.size, 1)
        shift = depth - self.level
        self.proof = sib >> shift
        self.node = sib & ((1 << shift) - 1)
        self.order = np.argsort(self.proof, kind="stable")
        self.counts = np.bincount(self.proof, minlength=len(sets))

    def digests(self, tree) -> np.ndarray:
        """The siblings' digests (total, DIGEST_LEN) in proof order, which
        ``tree`` serves from its own storage by ``digests_at``: a host
        MerkleTree (one tree shared by every proof, or B trees' stacked
        levels), a DeviceMerkleTree or a ForestTree
        (commit/device_merkle.py)."""
        if not self.level.size:
            return np.zeros((0, DIGEST_LEN), dtype=np.uint8)
        return tree.digests_at(self.level, self.proof, self.node)[self.order]


def open_multi(tree, indices) -> List[bytes]:
    """Minimal batched authentication proof for a SET of leaf indices:
    level by level, only siblings that cannot be recomputed from below, in
    sorted-index order (the verifier reproduces it exactly).  The walk of
    one set, over any kind of tree."""
    return [d.tobytes() for d in MultiproofWalk([list(indices)], len(tree)).digests(tree)]


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

