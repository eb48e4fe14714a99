"""The device commitment (H4's plain version on the CPU) against the JAX
package's device tree and against N1.

commit/device_merkle.py builds the whole paired-leaf tree where the
codeword lies, in the reference's flat layout.  On the CPU its kernel
wrapper runs the plain PyTorch version of H4, which must give the JAX
package's flat array (``_commit_paired_core``) word for word, the host
tree's (N1) levels, roots, paths and multiproofs byte for byte (B trees
stacked, (B, 8, n), as the host's stacked levels), and, with
STARK_TPU_DEVICE_HASH=1, the same proof bytes as the host commitment.
The CUDA kernel itself is held against this plain version by
chip_smoke.py on the card.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.commit import device_merkle as JD
from stark_anatomy_tpu.utils.convert import device_from_ints as jax_from_ints
from stark_anatomy_tpu_torch.commit import kernels as MK
from stark_anatomy_tpu_torch.commit.device_merkle import (
    DEVICE_COMMIT_MIN,
    DeviceMerkleTree,
    DeviceRows,
    device_commit_paired,
    device_commit_paired_many,
    gather_rows,
    use_device_commit,
)
from stark_anatomy_tpu_torch.commit.hashing import hash_paired_leaf
from stark_anatomy_tpu_torch.commit.merkle import MerkleTree, MultiproofWalk, open_multi, paired_levels
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.utils.convert import canonical_np, device_from_ints, gather_limbs, rows_from_ints

torch.set_num_threads(1)

RNG = random.Random(0xD3B1CE)


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    monkeypatch.delenv("STARK_TPU_DEVICE_HASH", raising=False)
    monkeypatch.delenv("STARK_TPU_DEVICE_HASH_MIN", raising=False)


def _codeword(n):
    vals = [RNG.randrange(P) for _ in range(n)]
    return vals, device_from_ints(vals, "cpu")


def _words(flat: torch.Tensor) -> np.ndarray:
    return flat.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [2, 4, 64, 512])
def test_flat_tree_matches_jax(n):
    vals, cw = _codeword(n)
    _, dtree = device_commit_paired(cw)
    jrows, jtree = JD.device_commit_paired(jax_from_ints(vals))
    assert dtree.flat.shape == (8, n)
    assert np.array_equal(_words(dtree.flat), np.asarray(jtree.flat))
    assert dtree.root == jtree.root
    assert dtree.offsets == jtree.offsets[: dtree.depth + 1]


@pytest.mark.parametrize("n", [4, 64])
def test_batched_flat_trees_match_jax(n):
    vals = [[RNG.randrange(P) for _ in range(n)] for _ in range(2)]
    cws = torch.stack([device_from_ints(v, "cpu") for v in vals])
    got = device_commit_paired_many(cws)
    want = JD.device_commit_paired_many(np.stack([np.asarray(jax_from_ints(v)) for v in vals]))
    for (rows, tree), (jrows, jtree), v in zip(got, want, vals):
        assert np.array_equal(_words(tree.flat), np.asarray(jtree.flat))
        assert tree.root == jtree.root == device_commit_paired(device_from_ints(v, "cpu"))[1].root
        assert gather_rows(rows, [0, n - 1]) == [v[0], v[n - 1]]


@pytest.mark.parametrize("n", [2, 4, 64, 512, 4096])
def test_device_tree_bit_identical_to_host(n):
    _, cw = _codeword(n)
    rows, dtree = device_commit_paired(cw)
    htree = MerkleTree.from_limbs_paired(canonical_np(cw))
    assert dtree.root == htree.root, n
    assert len(dtree) == len(htree) == n // 2
    assert len(dtree.levels) == len(htree.levels)
    for dl, hl in zip(dtree.levels, htree.levels):
        got = _words(dl).astype("<u4").T.copy().view(np.uint8)
        assert got.tobytes() == hl.tobytes(), n
    for i in sorted({0, n // 4, n // 2 - 1}):
        assert dtree.open(i) == htree.open(i), (n, i)
    idx = sorted(RNG.sample(range(n // 2), min(6, n // 2)))
    assert open_multi(dtree, idx) == open_multi(htree, idx)
    # the flat layout: root at column n - 2, a zero pad in column n - 1
    assert not dtree.flat[:, -1].any()


def test_device_leaf_matches_hashlib():
    vals, cw = _codeword(32)
    from stark_anatomy_tpu_torch.field import ops as F

    digs = _words(MK.paired_leaves_plain(F.from_mont(cw)).to(torch.int32))
    for i in range(16):
        assert digs[:, i].astype("<u4").tobytes() == hash_paired_leaf(vals[i], vals[i + 16]), i


def test_device_rows_gather():
    vals, cw = _codeword(128)
    rows, _ = device_commit_paired(cw)
    assert isinstance(rows, DeviceRows) and rows.shape == (128, 8) and len(rows) == 128
    idx = [0, 5, 77, 127]
    assert gather_rows(rows, idx) == [vals[i] for i in idx]
    assert rows[77] == vals[77]
    # the host-accessor path of gather_rows agrees
    assert gather_rows(canonical_np(cw), idx) == [vals[i] for i in idx]


@pytest.mark.parametrize("n,passes", [(2, 1), (4, 1), (512, 1), (1024, 2), (4096, 2), (1 << 22, 6)])
def test_tree_passes_cover_every_level(n, passes):
    # the stages of H4's one launch (commit/kernels.py:tree_stages): three
    # levels a stage from more than 2048 nodes, eight from more than 256,
    # then the rest
    plan = MK.tree_stages(n)
    assert len(plan) == passes
    depth = (n // 2).bit_length() - 1
    assert plan[0] == (n // 2, 0, 3 if n // 2 > 2048 else (8 if n // 2 > 256 else depth))
    assert sum(levels for _, _, levels in plan) == depth
    for (w, off, levels), (w2, off2, _) in zip(plan, plan[1:]):
        assert (w2, off2) == (w >> levels, off + 2 * w - (2 * w >> levels))


def test_wrapper_refuses_bad_input_and_non_cpu_tensors():
    with pytest.raises(ValueError):
        MK.merkle_paired(torch.zeros(8, 6, dtype=torch.int32))        # not a power of two
    with pytest.raises(ValueError):
        MK.merkle_paired(torch.zeros(8, 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        MK.merkle_paired(torch.zeros(8, 4, dtype=torch.int64))
    # a tensor that is neither on the CPU nor on a card: no plain fallback
    with pytest.raises(ValueError):
        MK.merkle_paired(torch.zeros(8, 4, dtype=torch.int32, device="meta"))


def test_use_device_commit_rule(monkeypatch):
    cuda = torch.device("cuda", 0)
    assert not use_device_commit(1 << 20, "cpu")
    assert not use_device_commit(DEVICE_COMMIT_MIN - 1, cuda)
    assert use_device_commit(DEVICE_COMMIT_MIN, cuda)
    monkeypatch.setenv("STARK_TPU_DEVICE_HASH", "0")
    assert not use_device_commit(1 << 20, cuda)
    monkeypatch.setenv("STARK_TPU_DEVICE_HASH", "1")
    assert use_device_commit(4, "cpu") and use_device_commit(None, "cpu")
    monkeypatch.setenv("STARK_TPU_DEVICE_HASH_MIN", "64")
    assert not use_device_commit(32, cuda) and use_device_commit(64, "cpu")
    monkeypatch.setenv("STARK_TPU_DEVICE_HASH", "yes")
    with pytest.warns(UserWarning):
        assert not use_device_commit(4, "cpu")


def det_urandom(seed: bytes):
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def test_full_prover_device_commit_byte_identical(monkeypatch):
    """A proof made with the device commitment forced on is byte-identical
    to the host-committed proof for the same randomness, and verifies."""
    from stark_anatomy_tpu_torch.field.scalar import Field
    from stark_anatomy_tpu_torch.models import rescue_prime as TR
    from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark

    field = Field.main()
    rp = TR.RescuePrime()
    sk = field.sample(b"device vs host")
    trace, boundary = rp.trace(sk), rp.boundary_constraints(rp.hash(sk))
    proofs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("STARK_TPU_DEVICE_HASH", mode)
        stark = FastStark(field, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3,
                          device="cpu")
        air = rp.transition_constraints(stark.omicron)
        tz = stark.preprocess()
        assert isinstance(tz.rows, DeviceRows) == (mode == "1")
        proof = stark.prove(trace, air, boundary, tz, air_evaluator=TR.make_air_evaluator(stark),
                            urandom=det_urandom(b"device-vs-host"))
        assert stark.verify(proof, air, boundary, tz.root,
                            air_index_evaluator=TR.make_index_air_evaluator(stark))
        proofs[mode] = (proof, tz.root)
    assert proofs["0"][1] == proofs["1"][1], "preprocess roots differ"
    assert proofs["0"][0] == proofs["1"][0], "proof bytes differ across commit paths"


@pytest.mark.parametrize("B,n", [(1, 2), (3, 2), (1, 64), (4, 8), (2, 512), (3, 4096)])
def test_stacked_trees_and_rows_match_the_host_s(B, n):
    """B proofs' trees stacked, (B, 8, n): a DeviceMerkleTree serves proof
    b's own digests (``digests_at``), its roots are N1's tree by tree, and
    DeviceRows gives proof b its own rows at indices[b], as the host's
    stacked levels (``paired_levels``) and numpy rows (``gather_limbs``)."""
    rows = np.stack([rows_from_ints([RNG.randrange(P) for _ in range(n)]) for _ in range(B)])
    canon = torch.from_numpy(np.ascontiguousarray(rows.transpose(0, 2, 1)).astype(np.int32))
    tree, dev_rows = DeviceMerkleTree(MK.merkle_paired(canon)), DeviceRows(canon)
    levels = paired_levels(rows)
    assert len(tree) == n // 2 and tree.depth == len(levels) - 1
    assert np.array_equal(tree.roots, levels[-1][:, 0])
    assert [r.tobytes() for r in tree.roots] == [MerkleTree.from_limbs_paired(r).root for r in rows]
    k = 40
    level = np.sort(np.array([RNG.randrange(len(levels)) for _ in range(k)]))
    proof = np.array([RNG.randrange(B) for _ in range(k)])
    node = np.array([RNG.randrange(levels[lv].shape[1]) for lv in level])
    want = np.stack([levels[lv][p, v] for lv, p, v in zip(level, proof, node)])
    assert np.array_equal(tree.digests_at(level, proof, node), want)
    sets = [sorted(RNG.sample(range(n // 2), min(3, n // 2))) for _ in range(B)]
    walk = MultiproofWalk(sets, n // 2)
    assert np.array_equal(walk.digests(tree), walk.digests(MerkleTree.of_levels(levels)))
    for shape in ((B, 7), (B, 5, 2)):
        idx = np.array([RNG.randrange(n) for _ in range(int(np.prod(shape)))]).reshape(shape)
        got = gather_limbs(dev_rows, idx)
        assert got.shape == shape + (8,) and got.dtype == np.uint32
        assert np.array_equal(got, gather_limbs(rows, idx))
