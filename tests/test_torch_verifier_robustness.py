"""The port's verifier against malformed proofs: it must REJECT them
(return False with ``last_rejection`` set), never raise.

The cases of tests/test_verifier_robustness.py, driven against the port's
``FastStark.verify``, Merkle multiproofs and transcript codec on the CPU,
with the same fixture: a Rescue-Prime proof at
``FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3)``,
made through the generic ``compile_air``.
"""

import random

import pytest
import torch

from stark_anatomy_tpu_torch.commit.hashing import hash_leaf
from stark_anatomy_tpu_torch.commit.merkle import MerkleTree, open_multi, verify_multi
from stark_anatomy_tpu_torch.errors import MalformedProof
from stark_anatomy_tpu_torch.field.scalar import Field
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark
from stark_anatomy_tpu_torch.transcript import codec
from stark_anatomy_tpu_torch.transcript.proof_stream import ProofStream

torch.set_num_threads(1)

FIELD = Field.main()
RNG = random.Random(0xB0B)


@pytest.fixture(scope="module")
def proof_setup():
    rp = RescuePrime()
    stark = FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3,
                      device="cpu")
    tz = stark.preprocess()
    input_element = FIELD.sample(b"robustness")
    output_element = rp.hash(input_element)
    trace = rp.trace(input_element)
    air = rp.transition_constraints(stark.omicron)
    boundary = rp.boundary_constraints(output_element)
    proof = stark.prove(trace, air, boundary, tz)
    assert stark.verify(proof, air, boundary, tz.root)
    return stark, air, boundary, tz, proof


def rejects(stark, proof, air, boundary, root) -> bool:
    """verify returned False (it never raises) and recorded a reason."""
    stark.last_rejection = None
    ok = stark.verify(proof, air, boundary, root)
    return ok is False and bool(stark.last_rejection)


def test_byte_flips_rejected_not_crash(proof_setup):
    stark, air, boundary, tz, proof = proof_setup
    n = len(proof)
    # flip a byte at positions spread across the whole proof (headers,
    # roots, leaf values, multiproof digests, last codeword)
    for frac in [0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.999]:
        pos = min(int(n * frac), n - 1)
        bad = bytearray(proof)
        bad[pos] ^= 0xFF
        assert rejects(stark, bytes(bad), air, boundary, tz.root), f"tampered byte at {pos}"


def test_truncations_rejected_not_crash(proof_setup):
    stark, air, boundary, tz, proof = proof_setup
    for cut in [0, 1, 4, len(proof) // 2, len(proof) - 1]:
        assert rejects(stark, proof[:cut], air, boundary, tz.root), cut


def test_garbage_and_extensions_rejected(proof_setup):
    stark, air, boundary, tz, proof = proof_setup
    for bad in (b"", b"not a proof at all", bytes(RNG.randbytes(4096)),
                codec.MAGIC + bytes(RNG.randbytes(4096)),
                # trailing objects change the prover/verifier Fiat-Shamir split
                proof + codec.encode_obj(12345)):
        assert rejects(stark, bad, air, boundary, tz.root)


def test_type_confusion_rejected(proof_setup):
    """Swap transcript object KINDS (int where bytes expected etc.)."""
    stark, air, boundary, tz, proof = proof_setup
    objs = codec.deserialize(proof)
    # first object is a boundary-quotient Merkle root (bytes) -> make it int
    assert rejects(stark, codec.serialize([7] + objs[1:]), air, boundary, tz.root)
    assert "expected bytes" in stark.last_rejection
    # replace the first list of ints (an opened-values or last-codeword
    # section) with a list of bytes
    i = next(i for i, o in enumerate(objs) if isinstance(o, list) and o and isinstance(o[0], int))
    swapped = objs[:i] + [[b"xx"] * len(objs[i])] + objs[i + 1 :]
    assert rejects(stark, codec.serialize(swapped), air, boundary, tz.root)


def test_multiproof_truncation_extension_reorder():
    leaves = [str(RNG.randrange(1 << 64)).encode() for _ in range(32)]
    tree = MerkleTree(leaves)
    indices = sorted(RNG.sample(range(32), 6))
    proof = open_multi(tree, indices)
    ld = {i: hash_leaf(leaves[i]) for i in indices}
    assert verify_multi(tree.root, 5, ld, proof)
    assert not verify_multi(tree.root, 5, ld, proof[:-1])               # truncated
    assert not verify_multi(tree.root, 5, ld, proof + [proof[0]])       # extended
    assert len(proof) >= 2
    assert not verify_multi(tree.root, 5, ld, [proof[1], proof[0]] + proof[2:])   # reordered
    assert not verify_multi(tree.root, 5, ld, [bytes(64)] + proof[1:])  # corrupted digest


def test_codec_roundtrip_and_malformed():
    objs = [b"root", 123, (1, 2, 3), [4, 5], [b"a", b"bb"]]
    data = codec.serialize(objs)
    assert codec.deserialize(data) == objs
    with pytest.raises(MalformedProof):
        codec.deserialize(b"BAD!!" + data[5:])
    with pytest.raises(MalformedProof):
        codec.deserialize(data[:-1])
    with pytest.raises(MalformedProof):
        codec.deserialize(data + b"\xff")  # bad tag
    with pytest.raises(MalformedProof):
        ProofStream().pull()
