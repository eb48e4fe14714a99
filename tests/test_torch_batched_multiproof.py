"""Opening a batch of trees at once: ``MultiproofWalk`` and the bulk codec.

Every prover opens its trees by one sibling walk
(commit/merkle.py:MultiproofWalk), for B proofs at once, and each kind of
tree serves the digests the walk names from its own storage: host
levels (stacked for a batch, or one tree shared by every proof) with one
index a level, a DeviceMerkleTree (H4's plain version here) with one
gather, a forest of host or device subtrees with one gather a subtree.
The digests, the opened values and FRI's (a, b) pairs are encoded with
numpy (transcript/codec.py); ``ProofStream.push_encoded`` takes the
bytes.  Each is held here to the plain per-proof form: the set walk
below followed by ``codec.encode_obj``, and one ``push`` an object.
"""

import random

import numpy as np
import pytest

import torch

from stark_anatomy_tpu_torch.commit.device_merkle import DeviceMerkleTree, DeviceRows, commit_forest
from stark_anatomy_tpu_torch.commit.hashing import blake2s_digest
from stark_anatomy_tpu_torch.commit.kernels import merkle_paired
from stark_anatomy_tpu_torch.commit.merkle import (
    MerkleTree,
    MultiproofWalk,
    open_multi,
    paired_levels,
    paired_trees,
    verify_multi,
)
from stark_anatomy_tpu_torch.field import ops as F
from stark_anatomy_tpu_torch.field.limbs import NLIMBS, int_to_limbs
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.parallel.mesh import Mesh, Sharded
from stark_anatomy_tpu_torch.parallel.sharded_stark import Paired
from stark_anatomy_tpu_torch.transcript import codec
from stark_anatomy_tpu_torch.transcript.proof_stream import ProofStream, SignatureProofStream
from stark_anatomy_tpu_torch.utils.convert import gather_limbs

torch.set_num_threads(1)


def plain_open_multi(tree: MerkleTree, indices) -> list:
    """The per-proof set walk over a host tree's levels."""
    known = sorted(set(indices))
    proof = []
    for level in tree.levels[:-1]:
        known_set = set(known)
        for i in known:
            if i ^ 1 not in known_set:
                proof.append(level[i ^ 1].tobytes())
        known = sorted({i >> 1 for i in known})
    return proof


def limb_rows(values) -> np.ndarray:
    """Canonical ints -> element-major (len, NLIMBS) uint32 limb rows."""
    return np.array([int_to_limbs(v) for v in values], dtype=np.uint32).reshape(-1, NLIMBS)


def codewords(B: int, leaves: int, seed: int) -> np.ndarray:
    """B canonical codewords of 2 * leaves elements as (B, n, NLIMBS) rows."""
    rng = random.Random(seed)
    return limb_rows([rng.randrange(P) for _ in range(B * 2 * leaves)]).reshape(B, 2 * leaves, NLIMBS)


def index_sets(kind: str, B: int, n: int, seed: int):
    rng = random.Random(seed)
    if kind == "single":
        return [[rng.randrange(n)] for _ in range(B)]
    if kind == "all":
        return [list(range(n))[::-1] for _ in range(B)]
    if kind == "duplicates":
        return [[rng.randrange(n) for _ in range(max(2, n // 3))] * 2 for _ in range(B)]
    # mixed: each proof its own size, from one index to all of them
    return [[rng.randrange(n) for _ in range(rng.randint(1, 2 * n))] for _ in range(B)]


def split(walk: MultiproofWalk, digests: np.ndarray) -> list:
    out, pos = [], 0
    for c in walk.counts:
        out.append([d.tobytes() for d in digests[pos:pos + c]])
        pos += c
    return out


def card_trees(codeword: np.ndarray, tree: str):
    """(rows, tree) of one canonical codeword (2n, NLIMBS) as the card
    holds it: a DeviceMerkleTree, or a forest of S host or device
    subtrees ("forest-S-host", "forest-S-device") from a local mesh's pair
    blocks."""
    canon = torch.from_numpy(np.ascontiguousarray(codeword.T.astype(np.int32)))
    if tree == "device":
        return DeviceRows(canon), DeviceMerkleTree(merkle_paired(canon))
    _, S, where = tree.split("-")
    S = int(S)
    mesh = Mesh([[torch.device("cpu")] * S])
    paired = Paired.of(Sharded.place(mesh, F.to_mont(canon)))
    return commit_forest(paired.blocks, canon.shape[-1], S, where == "device")[0]


CARD_TREES = ["device", "forest-2-host", "forest-2-device", "forest-4-host", "forest-4-device"]
CASES = [
    (B, n, kind)
    for B, n, kind in [
        (1, 2, "single"), (1, 2, "all"), (3, 2, "mixed"),
        (1, 4, "duplicates"), (3, 8, "all"), (3, 16, "single"), (64, 4, "mixed"),
        (3, 64, "duplicates"), (64, 32, "mixed"), (1, 256, "mixed"), (3, 512, "all"),
        (64, 128, "single"), (1, 2048, "duplicates"), (3, 2048, "mixed"), (64, 2048, "mixed"),
    ]
]
# host levels, stacked and shared, under each case's own id; then the
# trees on the card, shared by every proof of the case
WALK_CASES = [pytest.param(B, n, kind, "host", id=f"{B}-{n}-{kind}") for B, n, kind in CASES] + [
    pytest.param(B, n, kind, tree, id=f"{B}-{n}-{kind}-{tree}")
    for B, n, kind in CASES for tree in CARD_TREES if not tree.startswith("forest-4") or n >= 4
]


@pytest.mark.parametrize("B,n,kind,tree", WALK_CASES)
def test_the_walk_gives_each_proof_its_set_walk_s_multiproof(B, n, kind, tree):
    """The batched walk over stacked levels (``paired_levels``), over one
    shared host tree, and over one shared tree on the card or in a forest,
    encoded by ``encode_bytes_lists``: each proof's digests and bytes are
    its own set walk's, and each verifies.  ``open_multi`` is the walk of
    one set, and the card's trees give their opened values as the host
    rows hold them."""
    layers = codewords(B, n, seed=B * n)
    trees = paired_trees(layers)
    sets = index_sets(kind, B, n, seed=n + B)
    walk = MultiproofWalk(sets, n)
    assert walk.counts.tolist() == [len(plain_open_multi(trees[b], sets[b])) for b in range(B)]
    if tree == "host":
        served = [(MerkleTree.of_levels(paired_levels(layers)), lambda b: trees[b]),
                  (trees[0], lambda b: trees[0])]
    else:
        rows, card = card_trees(layers[0], tree)
        assert card.root == trees[0].root and len(card) == n
        idx = np.asarray(sets[0][:8] + [0, 2 * n - 1], dtype=np.int64)
        assert np.array_equal(gather_limbs(rows, idx), layers[0][idx])
        served = [(card, lambda b: trees[0])]
    for served_tree, tree_of in served:
        digests = walk.digests(served_tree)
        data, ends = codec.encode_bytes_lists(digests, walk.counts)
        starts = [0] + ends[:-1].tolist()
        for b, proof in enumerate(split(walk, digests)):
            plain = tree_of(b)
            expected = plain_open_multi(plain, sets[b])
            assert proof == expected, (b, kind)
            assert data[starts[b]:ends[b]].tobytes() == codec.encode_obj(expected)
            leaves = {i: plain.levels[0][i].tobytes() for i in sets[b]}
            assert verify_multi(plain.root, len(plain.levels) - 1, leaves, proof)
    assert open_multi(served[-1][0], sets[0]) == plain_open_multi(trees[0], sets[0])


def test_a_walk_of_no_levels_and_of_no_index():
    """A tree of one leaf has no sibling to give; a proof with no index
    gives none either, and the others are unmoved."""
    one = MerkleTree.of_levels(paired_levels(codewords(2, 1, seed=1)))
    walk = MultiproofWalk([[0], [0]], 1)
    assert walk.counts.tolist() == [0, 0] and walk.digests(one).shape == (0, 32)
    layers = codewords(2, 8, seed=2)
    trees = paired_trees(layers)
    stacked = MerkleTree.of_levels(paired_levels(layers))
    walk = MultiproofWalk([[], [3, 5]], 8)
    proofs = split(walk, walk.digests(stacked))
    assert proofs == [[], plain_open_multi(trees[1], [3, 5])]
    data, ends = codec.encode_bytes_lists(walk.digests(stacked), walk.counts)
    assert data[:ends[0]].tobytes() == codec.encode_obj([])


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (2, 512)])
def test_felt_lists_and_tuples_encode_as_encode_obj(shape):
    B, k = shape
    rng = random.Random(B * k)
    vals = [[rng.randrange(P) for _ in range(k)] for _ in range(B)]
    vals[0][0] = P - 1
    rows = limb_rows([v for row in vals for v in row]).reshape(B, k, NLIMBS)
    lists = codec.encode_felt_lists(rows)
    assert [lists[b].tobytes() for b in range(B)] == [codec.encode_obj(v) for v in vals]
    pairs = np.stack([rows, rows[:, ::-1]], axis=2)             # (B, k, 2, NLIMBS)
    tuples = codec.encode_felt_tuples(pairs)
    assert tuples.shape == (B, k, 2 + 32)
    for b in range(B):
        assert [t.tobytes() for t in tuples[b]] == [
            codec.encode_obj((vals[b][s], vals[b][k - 1 - s])) for s in range(k)
        ]


def streams_fed_both_ways(make):
    """A transcript fed one ``push`` an object and the same fed runs of
    encoded felt tuples, felt lists and byte lists, with a Fiat-Shamir
    draw between runs."""
    rng = random.Random(5)
    pairs = [(rng.randrange(P), rng.randrange(P)) for _ in range(4)]
    lst = [rng.randrange(P) for _ in range(9)]
    digests = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(3)]
    runs = [
        [b"\x07" * 32],
        [lst, digests],
        pairs + [[]],
        [[], digests[:1], lst[:1]],
    ]
    plain, bulk = make(), make()
    draws = []
    for run in runs:
        for obj in run:
            plain.push(obj)
        data = [codec.encode_obj(obj) for obj in run]
        if run is runs[1]:
            # the felt list and the byte list from the bulk encoders
            rows = limb_rows(lst).reshape(1, len(lst), NLIMBS)
            mp, _ = codec.encode_bytes_lists(np.frombuffer(b"".join(digests), np.uint8).reshape(3, 32), [3])
            data = [codec.encode_felt_lists(rows)[0].tobytes(), mp.tobytes()]
        elif run is runs[2]:
            rows = limb_rows([v for p in pairs for v in p]).reshape(1, len(pairs), 2, NLIMBS)
            data = [t.tobytes() for t in codec.encode_felt_tuples(rows)[0]] + data[-1:]
        bulk.push_encoded(b"".join(data), [len(d) for d in data])
        draws.append((plain.prover_fiat_shamir(), bulk.prover_fiat_shamir()))
    return plain, bulk, draws


@pytest.mark.parametrize("kind", ["plain", "signature"])
def test_a_stream_fed_encoded_runs_is_the_stream_fed_pushes(kind):
    make = ProofStream if kind == "plain" else (lambda: SignatureProofStream(b"a document"))
    plain, bulk, draws = streams_fed_both_ways(make)
    assert all(a == b for a, b in draws)
    assert bulk._buf == plain._buf and bulk._offsets == plain._offsets
    assert bulk.serialize() == plain.serialize()
    assert bulk.prover_fiat_shamir(64) == plain.prover_fiat_shamir(64)
    assert bulk.objects == plain.objects
    bulk.push(12345)
    plain.push(12345)
    assert bulk.objects == plain.objects and bulk._offsets == plain._offsets
    if kind == "signature":
        again = SignatureProofStream.deserialize_with_document(bulk.serialize(), b"a document")
        assert again.objects == plain.objects
        assert again.prover_fiat_shamir() == plain.prover_fiat_shamir()
        assert again.prefix == blake2s_digest(b"a document")
