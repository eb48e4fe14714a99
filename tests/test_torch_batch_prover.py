"""Batch signing: the port's BatchProver against the JAX package's.

A seeded batch of B = 3 proofs at ``FastStark(FIELD, 4, 2, 4, rp.m,
rp.N + 1)`` (FRI domain 512, six FRI rounds).  The port always takes the
batched FRI (``_fri_batch``: one batched fold a round, H7's plain version
here); the JAX package takes it above B*N = HOST_FRI_MAX, so the fixture
sets ``HOST_FRI_MAX = 0`` on the JAX instance.  The JAX package draws its
randomness from ``os.urandom``, which the fixture replaces with a
counter-mode stream (monkeypatch); the port takes the same stream as
``urandom=``.  The proofs are byte-identical, each package verifies the
other's, a proof is rejected under another document, and the batched FRI
writes the transcripts of ``Fri.prove_host`` on the same codewords.  The
batch's trees take one route, H4 (STARK_TPU_DEVICE_HASH=1) or N1, with
the same bytes.
"""

import hashlib
import os
import random

import pytest
import torch

from stark_anatomy_tpu.field.scalar import Field
from stark_anatomy_tpu.models.rescue_prime import RescuePrime as JaxRescuePrime
from stark_anatomy_tpu.parallel.batch_prover import BatchProver as JaxBatchProver
from stark_anatomy_tpu.protocols.fast_stark import FastStark as JaxFastStark
from stark_anatomy_tpu.transcript.proof_stream import SignatureProofStream as JaxSPS
from stark_anatomy_tpu_torch.commit import kernels as MK
from stark_anatomy_tpu_torch.commit import native as NB
from stark_anatomy_tpu_torch.commit.device_merkle import DeviceMerkleTree
from stark_anatomy_tpu_torch.commit.merkle import MerkleTree, MultiproofWalk
from stark_anatomy_tpu_torch.field.limbs import NLIMBS
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.models import rescue_prime as RP
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
from stark_anatomy_tpu_torch.parallel.batch_prover import BatchProver
from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark
from stark_anatomy_tpu_torch.transcript.proof_stream import SignatureProofStream
from stark_anatomy_tpu_torch.utils.convert import device_from_ints, ints_from_device

torch.set_num_threads(1)

FIELD = Field.main()
B = 3
DOCS = [b"batch doc %d" % i for i in range(B)]
SEED = b"batch prover"


def det_urandom(seed: bytes):
    """Deterministic os.urandom stand-in (counter-mode blake2b stream)."""
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def spy_urandom(seed: bytes, calls: list):
    """``det_urandom(seed)`` that records the size of every call."""
    draw = det_urandom(seed)

    def rand(n: int) -> bytes:
        calls.append(n)
        return draw(n)

    return rand


def inputs():
    return [FIELD.sample(bytes([7, i])) for i in range(B)]


@pytest.fixture(scope="module")
def jax_batch():
    """(stark, tz, air, proofs) of the JAX package's forced batched branch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        rp = JaxRescuePrime()
        stark = JaxFastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3)
        tz = stark.preprocess()
        prover = JaxBatchProver(stark, rp, tz)
        prover.HOST_FRI_MAX = 0
        mp.setattr(os, "urandom", det_urandom(SEED))
        proofs = prover.prove_batch(inputs(), [JaxSPS(d) for d in DOCS])
        return stark, tz, prover.air, proofs


@pytest.fixture(scope="module")
def port_prover():
    rp = RescuePrime()
    stark = FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device="cpu")
    return BatchProver(stark, rp, stark.preprocess())


@pytest.fixture(scope="module")
def port_proofs(port_prover):
    return port_prover.prove_batch(inputs(), [SignatureProofStream(d) for d in DOCS],
                                   urandom=det_urandom(SEED))


def boundaries():
    rp = RescuePrime()
    return [rp.boundary_constraints(rp.hash(x)) for x in inputs()]


def test_batched_fri_proofs_are_byte_identical_to_jax(jax_batch, port_proofs):
    _, _, _, jproofs = jax_batch
    assert len(port_proofs) == B
    assert port_proofs == jproofs


def test_each_package_verifies_the_others_batch(jax_batch, port_prover, port_proofs, monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    jstark, jtz, jair, jproofs = jax_batch
    stark, tz = port_prover.stark, port_prover.tz
    assert tz.root == jtz.root
    for i, boundary in enumerate(boundaries()):
        def port_stream(pr, d=DOCS[i]):
            return SignatureProofStream.deserialize_with_document(pr, d)

        def jax_stream(pr, d=DOCS[i]):
            return JaxSPS.deserialize_with_document(pr, d)

        assert stark.verify(port_proofs[i], port_prover.air, boundary, tz.root,
                            proof_stream_factory=port_stream), stark.last_rejection
        assert stark.verify(jproofs[i], port_prover.air, boundary, tz.root,
                            proof_stream_factory=port_stream), stark.last_rejection
        assert jstark.verify(port_proofs[i], jair, boundary, jtz.root,
                             proof_stream_factory=jax_stream)


def test_the_batch_draws_17_bytes_a_call_in_the_jax_package_s_order(port_prover, port_proofs):
    """A batch makes the JAX package's calls to ``urandom``, one a draw of
    17 bytes, B*(R*nrand + max_degree + 1) in all, and its proofs are the
    seeded ones (byte-identical to the JAX package's)."""
    stark = port_prover.stark
    calls = []
    proofs = port_prover.prove_batch(inputs(), [SignatureProofStream(d) for d in DOCS],
                                     urandom=spy_urandom(SEED, calls))
    width = stark.num_registers * stark.num_randomizers
    assert calls == [17] * (B * (width + stark.max_degree(port_prover.air) + 1))
    assert proofs == port_proofs


def test_a_proof_is_rejected_under_another_document(port_prover, port_proofs):
    stark, tz = port_prover.stark, port_prover.tz
    for i, boundary in enumerate(boundaries()):
        assert not stark.verify(
            port_proofs[i], port_prover.air, boundary, tz.root,
            proof_stream_factory=lambda pr: SignatureProofStream.deserialize_with_document(pr, b"other"),
        )
        assert stark.last_rejection
    # a proof under another proof's statement
    assert not stark.verify(
        port_proofs[0], port_prover.air, boundaries()[1], tz.root,
        proof_stream_factory=lambda pr: SignatureProofStream.deserialize_with_document(pr, DOCS[0]),
    )


def test_batched_fri_writes_the_transcripts_of_prove_host(port_prover):
    """``_fri_batch`` over a batch of codewords against ``Fri.prove_host``
    (the JAX package's branch at B*N <= 2^14) on each codeword alone: the
    same transcript bytes and the same top-level indices."""
    stark = port_prover.stark
    N = stark.fri_domain_length
    rng = random.Random(10)
    vals = [[rng.randrange(P) for _ in range(N)] for _ in range(B)]
    vals[0][:3] = [0, 1, P - 1]
    codewords = torch.stack([device_from_ints(v, "cpu") for v in vals])
    streams = [SignatureProofStream(d) for d in DOCS]
    indices = port_prover._fri_batch(codewords, streams)
    for i in range(B):
        host = SignatureProofStream(DOCS[i])
        assert stark.fri.prove_host(vals[i], host) == indices[i]
        assert host.serialize() == streams[i].serialize(), i


def test_the_batch_s_boundary_tables_are_each_statement_s(port_prover):
    """``_boundary_tables_batch`` (the public keys by one batched hash, the
    zerofiers shared by the batch, the interpolants in one pass) gives
    element for element ``_boundary_tables`` of each boundary alone."""
    stark = port_prover.stark
    sks = device_from_ints([x.value for x in inputs()], "cpu")
    assert ints_from_device(RP.hash_batch(sks)) == [RescuePrime().hash(x).value for x in inputs()]
    bs = boundaries()
    inv_bz, interp = stark._boundary_tables_batch(bs)
    assert tuple(inv_bz.shape) == (stark.num_registers, NLIMBS, stark.fri_domain_length)
    assert tuple(interp.shape) == (B,) + tuple(inv_bz.shape)
    for i, b in enumerate(bs):
        alone_bz, alone_ip = stark._boundary_tables(b)
        assert torch.equal(inv_bz, alone_bz)
        assert torch.equal(interp[i], alone_ip), i


def walks_served(monkeypatch) -> tuple:
    """(walks, served): each walk's number of index sets as it is made,
    and each tree it opens, as (type, number of proofs)."""
    walks, served = [], []
    make, digests = MultiproofWalk.__init__, MultiproofWalk.digests

    def counted_make(self, index_sets, n):
        make(self, index_sets, n)
        walks.append(len(self.counts))

    def counted_digests(self, tree):
        served.append((type(tree), len(self.counts)))
        return digests(self, tree)

    monkeypatch.setattr(MultiproofWalk, "__init__", counted_make)
    monkeypatch.setattr(MultiproofWalk, "digests", counted_digests)
    return walks, served


def test_the_batch_opens_every_multiproof_by_one_walk(port_prover, port_proofs, monkeypatch):
    """Every multiproof of a batch, the R + 2 opened trees' and each FRI
    query layer's, is served by a walk of all B index sets: one walk for
    the linked openings and one a query layer.  A second batch from the
    same draws gives the same bytes."""
    stark = port_prover.stark
    walks, served = walks_served(monkeypatch)
    again = port_prover.prove_batch(inputs(), [SignatureProofStream(d) for d in DOCS],
                                    urandom=det_urandom(SEED))
    assert again == port_proofs
    layers = stark.fri.num_rounds() - 1
    assert walks == [B] * (layers + 1)
    assert [b for _, b in served] == [B] * (layers + stark.num_registers + 2)


def test_a_zerofier_tree_on_the_device_is_opened_by_the_same_walk(port_proofs, monkeypatch):
    """With the transition zerofier committed on the device path (a
    DeviceMerkleTree, H4's plain version here), the walk that opens the
    batch's other trees opens it too, for all B proofs, and the proofs
    are the same bytes."""
    rp = RescuePrime()
    stark = FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device="cpu")
    monkeypatch.setenv("STARK_TPU_DEVICE_HASH", "1")
    tz = stark.preprocess()
    monkeypatch.delenv("STARK_TPU_DEVICE_HASH")
    assert isinstance(tz.tree, DeviceMerkleTree)
    prover = BatchProver(stark, rp, tz)
    walks, served = walks_served(monkeypatch)
    proofs = prover.prove_batch(inputs(), [SignatureProofStream(d) for d in DOCS],
                                urandom=det_urandom(SEED))
    assert proofs == port_proofs
    opened = served[stark.fri.num_rounds() - 1:]           # after FRI's query layers
    assert opened[-1] == (DeviceMerkleTree, B) and len(opened) == stark.num_registers + 2
    assert walks[-1] == B and len(walks) == stark.fri.num_rounds()


def trees_hashed(monkeypatch) -> dict:
    """Calls of N1's leaf and level hashers and of H4's wrapper, counted
    as they are made."""
    calls = {"leaves_from_limb_pairs": 0, "merkle_level": 0, "merkle_paired": 0}
    for module, name in ((NB, "leaves_from_limb_pairs"), (NB, "merkle_level"), (MK, "merkle_paired")):
        def counted(*args, _f=getattr(module, name), _name=name, **kwargs):
            calls[_name] += 1
            return _f(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("mode", ["0", "1"])
def test_the_batch_s_trees_take_one_route(mode, jax_batch, port_prover, port_proofs, monkeypatch):
    """STARK_TPU_DEVICE_HASH=1 puts the batch's trees on the card's route
    (H4's plain version here): one H4 call for the R codewords and the
    randomizer's stacked, and one a FRI round, no N1 call; the openings
    serve stacked DeviceMerkleTrees.  =0 keeps the host route: N1's calls
    for the commitment and every FRI round, no H4 call.
    Both give the host route's proofs and the JAX package's, byte for
    byte."""
    stark = port_prover.stark
    monkeypatch.setenv("STARK_TPU_DEVICE_HASH", mode)
    prover = BatchProver(stark, port_prover.rp, port_prover.tz, air=port_prover.air)
    assert prover.device_trees == (mode == "1")
    calls = trees_hashed(monkeypatch)
    walks, served = walks_served(monkeypatch)
    proofs = prover.prove_batch(inputs(), [SignatureProofStream(d) for d in DOCS],
                                urandom=det_urandom(SEED))
    assert proofs == port_proofs
    assert proofs == jax_batch[3]
    rounds = stark.fri.num_rounds()
    depths = [(stark.fri_domain_length >> r).bit_length() - 2 for r in range(rounds)]
    if mode == "1":
        assert calls == {"leaves_from_limb_pairs": 0, "merkle_level": 0, "merkle_paired": 1 + rounds}
    else:
        assert calls == {"leaves_from_limb_pairs": 1 + rounds,
                         "merkle_level": depths[0] + sum(depths), "merkle_paired": 0}
    kind = DeviceMerkleTree if mode == "1" else MerkleTree
    assert [t for t, _ in served[:-1]] == [kind] * (rounds - 1 + stark.num_registers + 1)
    assert served[-1] == (type(port_prover.tz.tree), B)
