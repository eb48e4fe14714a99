"""The port's transcript, commitments and host FRI against the JAX package,
byte for byte: codec bytes, Fiat-Shamir challenges, Merkle roots and
multiproofs, and ``prove_host`` transcripts on the same codeword, plus
cross-verification and rejection of a corrupted proof."""

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.commit import merkle as JM
from stark_anatomy_tpu.field.scalar import Field, P
from stark_anatomy_tpu.protocols.fri import Fri as JFri
from stark_anatomy_tpu.transcript import codec as JCodec
from stark_anatomy_tpu.transcript.proof_stream import (
    ProofStream as JPS,
    SignatureProofStream as JSPS,
)
from stark_anatomy_tpu_torch.commit import merkle as TM
from stark_anatomy_tpu_torch.errors import MalformedProof
from stark_anatomy_tpu_torch.ops.ntt import coset_evaluate
from stark_anatomy_tpu_torch.protocols.fri import Fri as TFri
from stark_anatomy_tpu_torch.transcript import codec as TCodec
from stark_anatomy_tpu_torch.transcript.proof_stream import (
    ProofStream as TPS,
    SignatureProofStream as TSPS,
)
from stark_anatomy_tpu_torch.utils.convert import canonical_np, device_from_ints, ints_from_device

torch.set_num_threads(1)

FIELD = Field.main()
OBJECTS = [b"\x00root" * 6, 12345, (1, P - 1), [3, 4, 5], [b"ab", b"cde"], [], b""]


def values(count, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(count)]


def test_codec_bytes_match_jax():
    data = TCodec.serialize(OBJECTS)
    assert data == JCodec.serialize(OBJECTS)
    assert TCodec.deserialize(data) == OBJECTS
    with pytest.raises(MalformedProof):
        TCodec.deserialize(data[:-3] + b"\x09")


def test_fiat_shamir_matches_jax():
    for jps, tps in [(JPS(), TPS()), (JSPS(b"doc"), TSPS(b"doc"))]:
        for obj in OBJECTS:
            jps.push(obj)
            tps.push(obj)
            assert tps.prover_fiat_shamir() == jps.prover_fiat_shamir()
        assert tps.serialize() == jps.serialize()


def test_verifier_fiat_shamir_matches_jax():
    data = TSPS(b"doc")
    for obj in OBJECTS:
        data.push(obj)
    tback = TSPS.deserialize_with_document(data.serialize(), b"doc")
    jback = JSPS.deserialize_with_document(data.serialize(), b"doc")
    for _ in OBJECTS:
        assert tback.pull() == jback.pull()
        assert tback.verifier_fiat_shamir() == jback.verifier_fiat_shamir()
    with pytest.raises(MalformedProof):
        tback.pull()


@pytest.mark.parametrize("n", [2, 64, 1024])
def test_merkle_roots_and_multiproofs_match_jax(n):
    vals = values(n, n)
    rows = canonical_np(device_from_ints(vals, "cpu"))
    jt = JM.MerkleTree.from_limbs_paired(rows)
    tt = TM.MerkleTree.from_limbs_paired(rows)
    assert tt.root == jt.root == TM.paired_tree_from_ints(vals).root
    leaves = sorted({(7 * i) % max(n // 2, 1) for i in range(5)})
    proof = TM.open_multi(tt, leaves)
    assert proof == JM.open_multi(jt, leaves)
    digests = {i: tt.levels[0][i].tobytes() for i in leaves}
    depth = len(tt.levels) - 1
    assert TM.verify_multi(tt.root, depth, digests, proof)
    if proof:
        assert not TM.verify_multi(tt.root, depth, digests, proof[:-1])
    assert TM.MerkleTree.verify_path(tt.root, leaves[0], tt.open(leaves[0]), digests[leaves[0]])


def make_fri(cls, n=256, expansion=4, tests=17):
    omega = FIELD.primitive_nth_root(n).value
    return cls(FIELD.generator().value, omega, n, expansion, tests)


def test_prove_host_transcript_matches_jax_and_cross_verifies():
    n, expansion = 256, 4
    jf, tf = make_fri(JFri), make_fri(TFri)
    assert tf.num_rounds() == jf.num_rounds()
    coeffs = values(n // expansion, 11)
    codeword = ints_from_device(coset_evaluate(device_from_ints(coeffs, "cpu"), tf.offset, n))
    jps, tps = JPS(), TPS()
    assert tf.prove_host(codeword, tps) == jf.prove_host(codeword, jps)
    assert tps.serialize() == jps.serialize()

    values_t, values_j = [], []
    assert tf.verify(TPS.deserialize(jps.serialize()), values_t)
    assert jf.verify(JPS.deserialize(tps.serialize()), values_j)
    assert values_t == values_j
    assert all(codeword[i] == v for i, v in values_t)

    # a high-degree codeword is rejected with a reason, never an exception
    bad = list(codeword)
    bad[5] = (bad[5] + 1) % P
    ps = TPS()
    tf.prove_host(bad, ps)
    assert not tf.verify(TPS.deserialize(ps.serialize()), [])
    assert tf.last_rejection
    with pytest.raises(MalformedProof):
        TPS.deserialize(tps.serialize()[:-40])


def test_query_reveals_paired_leaves():
    tf = make_fri(TFri, n=64, tests=3)
    vals = values(64, 12)
    tree = TM.paired_tree_from_ints(vals)
    ps = TPS()
    # one queried layer: the last layer goes in the clear and is not opened
    tf.queries([vals, None], [tree, None], np.array([[1, 5, 30]]), [ps])
    assert len(ps.objects) == 4
    assert ps.objects[:3] == [(vals[1], vals[33]), (vals[5], vals[37]), (vals[30], vals[62])]
    assert ps.objects[3] == TM.open_multi(tree, [1, 5, 30])
