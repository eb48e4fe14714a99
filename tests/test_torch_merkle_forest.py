"""The sharded commitments: the port's MerkleForest, ShardedRows and Merkle
against the JAX package's, and the forest of a sharded codeword
(commit/device_merkle.py:commit_forest) against the monolithic tree.

The cases are tests/test_merkle.py's (stateless API :60, the forest :75,
ShardedRows :97): roots, single paths and multiproofs at shard-boundary
indices, for S = 1, 2, 4 and 8, equal byte for byte.  The forest is
committed both ways on the CPU: host subtrees (N1) and device subtrees
(H0 and H4's plain versions), from pair blocks made by a local mesh's
exchange.
"""

import random

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.commit.merkle import Merkle as JaxMerkle
from stark_anatomy_tpu.commit.merkle import MerkleForest as JaxForest
from stark_anatomy_tpu.commit.merkle import MerkleTree as JaxTree
from stark_anatomy_tpu.commit.merkle import ShardedRows as JaxShardedRows
from stark_anatomy_tpu.commit.merkle import open_multi as jax_open_multi
from stark_anatomy_tpu_torch.commit.device_merkle import ForestRows, ForestTree, commit_forest
from stark_anatomy_tpu_torch.commit.merkle import Merkle, MerkleForest, MerkleTree, ShardedRows, open_multi
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.parallel.mesh import Mesh, Sharded
from stark_anatomy_tpu_torch.parallel.sharded_stark import Paired
from stark_anatomy_tpu_torch.utils.convert import canonical_np, device_from_ints

torch.set_num_threads(1)


def test_stateless_api_matches_jax():
    rng = random.Random(60)
    data = [str(rng.randrange(10**30)).encode() for _ in range(16)]
    tree = MerkleTree(data)
    assert Merkle.commit(data) == tree.root == JaxMerkle.commit(data)
    for i in (0, 5, 15):
        assert Merkle.open(i, data) == tree.open(i) == JaxMerkle.open(i, data)
        assert Merkle.verify(tree.root, i, Merkle.open(i, data), data[i])
        assert JaxMerkle.verify(tree.root, i, Merkle.open(i, data), data[i])
    assert not Merkle.verify(tree.root, 5, Merkle.open(5, data), data[6])


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_merkle_forest_matches_jax_and_the_tree(shards):
    canon = np.random.default_rng(42).integers(0, 1 << 16, size=(256, 8), dtype=np.uint32)
    tree = MerkleTree.from_limbs_paired(canon)
    forest = MerkleForest.from_limbs_paired_sharded(canon, shards)
    jax_forest = JaxForest.from_limbs_paired_sharded(canon, shards)
    assert forest.root == tree.root == jax_forest.root
    assert tree.root == JaxTree.from_limbs_paired(canon).root
    per = 128 // shards
    idx = sorted({0, 3, 17, 64, 100, 127, per - 1, min(per, 127)})
    assert open_multi(forest, idx) == open_multi(tree, idx) == jax_open_multi(jax_forest, idx)
    for i in (5, per - 1, min(per, 127)):
        assert forest.open(i) == tree.open(i) == jax_forest.open(i)


@pytest.mark.parametrize("n,shards", [(64, 2), (256, 4), (512, 8)])
def test_sharded_rows_paired_forest_matches_jax(n, shards):
    canon = np.random.default_rng(7 + n).integers(0, 1 << 16, size=(n, 8), dtype=np.uint32)
    blocks = [canon[s * (n // shards):(s + 1) * (n // shards)] for s in range(shards)]
    rows, jax_rows = ShardedRows(blocks), JaxShardedRows(blocks)
    assert len(rows) == len(jax_rows) == n and rows.shape == jax_rows.shape
    for i in (0, n // shards - 1, n // shards, n - 1):
        assert np.array_equal(rows[i], canon[i]) and np.array_equal(jax_rows[i], canon[i])
    assert np.array_equal(np.stack(list(rows)), canon)
    forest, jax_forest = rows.paired_forest(), jax_rows.paired_forest()
    tree = MerkleTree.from_limbs_paired(canon)
    assert forest.root == tree.root == jax_forest.root
    per_leaf = (n // 2) // (shards // 2)
    idx = sorted({0, per_leaf - 1, min(per_leaf, n // 2 - 1), n // 2 - 1})
    assert open_multi(forest, idx) == open_multi(tree, idx) == jax_open_multi(jax_forest, idx)


@pytest.mark.parametrize("on_device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("shards,batch", [(1, ()), (2, ()), (4, (2,)), (8, ())])
def test_forest_of_a_sharded_codeword_matches_the_tree(shards, batch, on_device):
    """commit_forest over pair blocks (the sharded prover's commitment):
    the monolithic tree's root, multiproofs (indices at every subtree's
    edges) and opened values, with host subtrees and with the device
    subtrees' plain versions; no hashed tensor is longer than n / S."""
    n = 128
    rng = random.Random(1000 + shards)
    vals = [rng.randrange(P) for _ in range(n * (batch[0] if batch else 1))]
    x = device_from_ints(vals, "cpu").reshape((8,) + batch + (n,)).movedim(0, -2).contiguous()
    mesh = Mesh([[torch.device("cpu")] * shards])
    paired = Paired.of(Sharded.place(mesh, x))
    assert all(q.shape[-1] == n // shards for q in paired.blocks.values())
    assert torch.equal(paired.gather(), x)
    got = commit_forest(paired.blocks, n, shards, on_device)
    whole = canonical_np(x).reshape((-1, n, 8))
    h = n // (2 * shards)
    leaves = sorted({0, n // 2 - 1} | {k * h + d for k in range(shards) for d in (0, h - 1)})
    positions = sorted(set(leaves) | {i + n // 2 for i in leaves})
    for r, (rows, tree) in enumerate(got):
        assert isinstance(rows, ForestRows) and isinstance(tree, ForestTree)
        mono = MerkleTree.from_limbs_paired(whole[r])
        assert tree.root == mono.root
        assert open_multi(tree, leaves) == open_multi(mono, leaves)
        j = min(h, n // 2 - 1)
        assert tree.open(j) == mono.open(j) and len(tree) == n // 2
        want = [int.from_bytes(whole[r][i].astype("<u2").tobytes(), "little") for i in positions]
        assert rows.gather(positions) == want and rows[positions[1]] == want[1]
