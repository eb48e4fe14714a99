"""blake2s-256 Merkle trees over paired leaves: leaf i of a codeword of n
elements covers elements i and i + n/2, each as 16 little-endian bytes;
a multiproof lists, level by level and in index order, the siblings that
cannot be recomputed from below."""

from __future__ import annotations

from hashlib import blake2s
from typing import Dict, List, Optional


def paired_leaf(v0: int, v1: int) -> bytes:
    return blake2s(v0.to_bytes(16, "little") + v1.to_bytes(16, "little")).digest()


def root_of(codeword: List[int]) -> bytes:
    """The root of a whole codeword's paired-leaf tree."""
    half = len(codeword) // 2
    level = [paired_leaf(codeword[i], codeword[i + half]) for i in range(half)]
    while len(level) > 1:
        level = [blake2s(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    return level[0]


def multiproof_root(depth: int, leaves: Dict[int, bytes], proof: List[bytes]) -> Optional[bytes]:
    """The root that the leaves and the multiproof imply, or None where the
    proof has too few or too many siblings."""
    nodes = dict(leaves)
    pos = 0
    for _ in range(depth):
        parents = {}
        for i in sorted(nodes):
            if i & 1 and i ^ 1 in nodes:
                continue
            if i ^ 1 in nodes:
                left, right = nodes[i], nodes[i ^ 1]
            else:
                if pos >= len(proof):
                    return None
                sib = proof[pos]
                pos += 1
                left, right = (sib, nodes[i]) if i & 1 else (nodes[i], sib)
            parents[i >> 1] = blake2s(left + right).digest()
        nodes = parents
    if pos != len(proof) or set(nodes) != {0}:
        return None
    return nodes[0]
