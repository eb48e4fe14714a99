"""N1, the port's host blake2s hasher, against hashlib and the JAX package.

The port's Merkle trees hash in C++ (commit/native.py, built from
csrc/blake2s_host.cpp at first use).  Over the same seeded canonical rows
its leaf digests, every level, the roots, ``open`` and ``open_multi`` are
byte for byte those of the hashlib plain versions and of the JAX
package's ``MerkleTree``.  A build that fails raises; nothing falls back.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.commit import merkle as JM
from stark_anatomy_tpu_torch.commit import native as NB
from stark_anatomy_tpu_torch.commit.merkle import MerkleTree, open_multi, paired_tree_from_ints, paired_trees
from stark_anatomy_tpu_torch.utils.convert import int_from_row

torch.set_num_threads(1)

SIZES = [2, 4, 64, 512, 4096]


def rows(n: int, seed: int) -> np.ndarray:
    """Seeded canonical (n, 8) uint32 limb rows (16-bit limbs, top limb
    below p's, so every value lies in the field)."""
    r = np.random.default_rng(seed).integers(0, 1 << 16, (n, 8)).astype(np.uint32)
    r[:, 7] &= 0x3FFF
    return r


@pytest.mark.parametrize("n", SIZES)
def test_paired_tree_matches_hashlib_and_jax(n):
    canon = rows(n, n)
    leaves = NB.leaves_from_limb_pairs(canon)
    assert leaves.tobytes() == NB.leaves_from_limb_pairs_plain(canon).tobytes()
    tree = MerkleTree.from_limbs_paired(canon)
    jtree = JM.MerkleTree.from_limbs_paired(canon)
    assert len(tree.levels) == len(jtree.levels) == (n // 2).bit_length()
    level = leaves
    for k, (got, want) in enumerate(zip(tree.levels, jtree.levels)):
        assert got.tobytes() == want.tobytes() == level.tobytes(), k
        if level.shape[0] > 1:
            level = NB.merkle_level_plain(level)
    assert tree.root == jtree.root
    for i in sorted({0, n // 4, n // 2 - 1, min(1, n // 2 - 1)}):
        assert tree.open(i) == jtree.open(i)
    idx = sorted(np.random.default_rng(n + 1).choice(n // 2, min(6, n // 2), replace=False).tolist())
    assert open_multi(tree, idx) == JM.open_multi(jtree, idx)
    # the tree over canonical ints hashes the same leaves
    assert paired_tree_from_ints([int_from_row(r) for r in canon]).root == tree.root


@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("n", [2, 4, 512])
def test_a_batch_of_paired_trees_is_each_codeword_s_tree(batch, n):
    """paired_trees hashes a batch's leaves and levels stacked: every tree
    is MerkleTree.from_limbs_paired of its own rows, level for level, with
    the same openings."""
    layers = np.stack([rows(n, 1000 * batch + n + b) for b in range(batch)])
    trees = paired_trees(layers)
    assert len(trees) == batch
    idx = sorted({0, n // 4, n // 2 - 1})
    for b, tree in enumerate(trees):
        alone = MerkleTree.from_limbs_paired(layers[b])
        assert [lv.tobytes() for lv in tree.levels] == [lv.tobytes() for lv in alone.levels], b
        assert tree.root == alone.root
        assert open_multi(tree, idx) == open_multi(alone, idx)
        assert tree.open(idx[-1]) == alone.open(idx[-1])


@pytest.mark.parametrize("n", SIZES)
def test_element_leaves_match_hashlib_and_jax(n):
    canon = rows(n, 100 + n)
    assert NB.leaves_from_limbs(canon).tobytes() == NB.leaves_from_limbs_plain(canon).tobytes()
    tree, jtree = MerkleTree.from_limbs(canon), JM.MerkleTree.from_limbs(canon)
    assert [lv.tobytes() for lv in tree.levels] == [lv.tobytes() for lv in jtree.levels]


def test_hash_encodings_variable_length():
    """Messages of 0 to 200 bytes: one block, exactly 64 bytes, and the
    multi-block path past 64."""
    rng = np.random.default_rng(7)
    msgs = [rng.bytes(k) for k in (0, 1, 15, 16, 32, 63, 64, 65, 127, 128, 129, 200)]
    got = NB.hash_encodings(msgs)
    assert got.shape == (len(msgs), 32)
    for m, d in zip(msgs, got):
        assert d.tobytes() == hashlib.blake2s(m).digest()
    assert got.tobytes() == NB.hash_encodings_plain(msgs).tobytes()
    tree = MerkleTree(msgs[:8])
    assert tree.root == JM.MerkleTree(msgs[:8]).root


def test_large_batch_splits_over_threads_with_the_same_bytes():
    canon = rows(1 << 15, 3)
    leaves = NB.leaves_from_limb_pairs(canon)
    assert leaves.tobytes() == NB.leaves_from_limb_pairs_plain(canon).tobytes()
    assert NB.merkle_level(leaves).tobytes() == NB.merkle_level_plain(leaves).tobytes()


def test_failed_build_raises(monkeypatch, tmp_path):
    from stark_anatomy_tpu_torch.utils import build as B

    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(B, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(NB, "SOURCE", str(broken))
    monkeypatch.setattr(NB, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        NB.hash_encodings([b"x"])
    assert not os.listdir(tmp_path / "build") or all(
        not f.endswith(".so") for f in os.listdir(tmp_path / "build"))
