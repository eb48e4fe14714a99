"""The benchmark's plain Rescue-Prime reference (portbench/reference/
rescue_prime.py: Python integers and hashlib, its constants derived from
the Rescue-Prime paper's recipe) against the port, and the port's batch
signer at the production parameters judged by it.

A seeded batch of B = 2 from ``make_batch_rpsss(device="cpu")`` (FRI
domain 4096, 64 colinearity checks) is accepted by ``judge_signature``,
and rejected under another document, under another key and with a byte
altered.  ``make_batch_rpsss`` with no ``config`` signs the bytes it
signed before it took one; with half the checks the transcript is
shorter.
"""

import dataclasses
import hashlib
import json
import os
import random

import pytest
import torch

from portbench.reference import rescue_prime as RR
from portbench.reference.stark import Rejected
from stark_anatomy_tpu_torch.config import RPSSS_CONFIG
from stark_anatomy_tpu_torch.field.scalar import Field
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
from stark_anatomy_tpu_torch.parallel.batch_prover import make_batch_rpsss
from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(ROOT, "portbench", "configs", "rpsss_prod.json")))
FIELD = Field.main()
DOCS = [b"document %d" % i for i in range(2)]
# blake2b-128 of the two seeded signatures below, as make_batch_rpsss
# signed them before it took a configuration
SIGNED_BEFORE = "71f3fb3136a72dcf22446059427504a5"


def det_urandom(seed: bytes):
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def signed(config=None):
    """The seeded batch of two: ([(sk, pk)], signatures)."""
    _, keygen, sign_batch = make_batch_rpsss(device="cpu", urandom=det_urandom(b"rpsss reference"),
                                             config=config)
    keys = [keygen() for _ in DOCS]
    return [(sk.value, pk.value) for sk, pk in keys], sign_batch([sk for sk, _ in keys], DOCS)


@pytest.fixture(scope="module")
def batch():
    return signed()


def test_the_configuration_is_the_port_s_production_parameters():
    stark = FastStark.from_config(RPSSS_CONFIG, FIELD, device="cpu")
    params = RR.params(CONFIG)
    assert (params.omicron_length, params.fri_length) == (stark.omicron_domain_length,
                                                          stark.fri_domain_length)
    assert params.fri_length == CONFIG["fri_domain_length"] == 4096
    assert params.fri_rounds() == stark.fri.num_rounds()
    assert (CONFIG["num_cycles"], CONFIG["num_colinearity_checks"], CONFIG["security_level"]) == (
        RPSSS_CONFIG.num_cycles, RPSSS_CONFIG.num_colinearity_checks, RPSSS_CONFIG.security_level)


def test_reference_hash_is_the_port_s():
    rp, ref = RescuePrime(), RR.instance(CONFIG)
    rng = random.Random(25)
    for _ in range(16):
        x = FIELD.sample(rng.randbytes(17))
        assert ref.hash(x.value) == rp.hash(x).value
        assert ref.trace(x.value) == [[e.value for e in row] for row in rp.trace(x)]


def test_reference_air_holds_on_a_true_trace_and_only_there():
    ref = RR.instance(CONFIG)
    omicron = RR.params(CONFIG).omicron
    air = RR.RescueAir(ref, omicron)
    trace = ref.trace(12345)
    for r in range(ref.rounds):
        x = pow(omicron, r, RR.P)
        assert air.constraints(x, trace[r], trace[r + 1]) == [0, 0]
        assert air.zerofier(x) == 0
    assert air.zerofier(pow(omicron, ref.rounds, RR.P)) != 0
    for row, col in ((0, 0), (5, 1), (ref.rounds, 0)):
        altered = [list(r) for r in trace]
        altered[row][col] = (altered[row][col] + 1) % RR.P
        bad = [air.constraints(pow(omicron, r, RR.P), altered[r], altered[r + 1])
               for r in range(ref.rounds)]
        assert any(any(c) for c in bad), (row, col)


def test_reference_zerofier_root_is_the_port_s():
    stark = FastStark.from_config(RPSSS_CONFIG, FIELD, device="cpu")
    assert RR.zerofier_root(CONFIG) == stark.preprocess().root


def test_reference_accepts_the_port_s_batch(batch):
    keys, signatures = batch
    root = RR.zerofier_root(CONFIG)
    for i, ((sk, pk), doc, sig) in enumerate(zip(keys, DOCS, signatures)):
        assert RR.judge_signature(CONFIG, f"signature {i}", sk, pk, doc, sig) == (False, None, root)


def test_reference_rejects_another_document_key_or_byte(batch):
    (sk, pk), (sk1, pk1) = batch[0]
    sig = batch[1][0]
    with pytest.raises(Rejected):
        RR.verify_signature(CONFIG, pk, DOCS[1], sig)
    with pytest.raises(Rejected):
        RR.verify_signature(CONFIG, pk1, DOCS[0], sig)
    i = len(sig) // 3
    flipped = sig[:i] + bytes([sig[i] ^ 1]) + sig[i + 1:]
    wrong, reason, root = RR.judge_signature(CONFIG, "flipped", sk, pk, DOCS[0], flipped)
    assert not wrong and reason and root is None
    wrong, reason, root = RR.judge_signature(CONFIG, "other key", sk1, pk, DOCS[0], sig)
    assert wrong and reason and root is None


def test_make_batch_rpsss_signs_as_before_and_takes_a_configuration(batch):
    keys, signatures = batch
    assert hashlib.blake2b(b"".join(signatures), digest_size=16).hexdigest() == SIGNED_BEFORE
    assert signed(RPSSS_CONFIG) == batch
    half = dataclasses.replace(RPSSS_CONFIG, num_colinearity_checks=32, security_level=64)
    half_keys, half_signatures = signed(half)
    assert half_keys == keys
    assert all(len(h) < len(s) for h, s in zip(half_signatures, signatures))
    with pytest.raises(Rejected):
        RR.verify_signature(CONFIG, keys[0][1], DOCS[0], half_signatures[0])
