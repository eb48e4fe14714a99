"""The slice as a whole: FastRPSSS keygen, sign and verify in the port on
the CPU against the JAX package.

With the same counter-mode ``urandom`` the port's signature is byte
identical to the JAX package's, each package verifies the other's
signature, and a forged document and a wrong pk are rejected.  The same
holds for a small ``FastStark.prove`` with the Rescue AIR evaluator."""

import hashlib
import os

import pytest
import torch

from stark_anatomy_tpu.field.scalar import Field
from stark_anatomy_tpu.models.rpsss import FastRPSSS as JaxRPSSS
from stark_anatomy_tpu_torch.models.rpsss import FastRPSSS

torch.set_num_threads(1)

DOC = b"Hello world: STARK signatures in PyTorch"


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


@pytest.fixture(scope="module")
def schemes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        yield JaxRPSSS(), FastRPSSS(device="cpu")


@pytest.fixture(scope="module")
def signatures(schemes):
    """(sk, pk, port signature, JAX signature) from one seed."""
    jax_scheme, port = schemes
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        mp.setattr(os, "urandom", det_urandom(b"rpsss"))
        jsk, jpk = jax_scheme.keygen()
        jsig = jax_scheme.sign(jsk, DOC)
    rand = det_urandom(b"rpsss")
    sk, pk = port.keygen(rand)
    sig = port.sign(sk, DOC, rand)
    assert (sk.value, pk.value) == (jsk.value, jpk.value)
    return sk, pk, sig, jsig


def test_seeded_signature_is_byte_identical_to_jax(signatures):
    _, _, sig, jsig = signatures
    assert sig == jsig


def test_each_package_verifies_the_others_signature(schemes, signatures, monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    jax_scheme, port = schemes
    _, pk, sig, jsig = signatures
    jpk = Field.main()(pk.value)
    assert port.verify(pk, DOC, sig)
    assert port.verify(pk, DOC, jsig)
    assert jax_scheme.verify(jpk, DOC, sig)


def test_forged_document_and_wrong_pk_are_rejected(schemes, signatures):
    _, port = schemes
    _, pk, sig, _ = signatures
    assert not port.verify(pk, b"forged document", sig)
    assert port.stark.last_rejection
    _, pk2 = port.keygen(det_urandom(b"other key"))
    assert not port.verify(pk2, DOC, sig)
    assert not port.verify(pk, DOC, sig[:-100])
    flipped = bytearray(sig)
    flipped[len(sig) // 2] ^= 1
    assert not port.verify(pk, DOC, bytes(flipped))


def test_fast_stark_prove_is_byte_identical_to_jax(monkeypatch):
    """FastStark.prove itself (the generic single-proof entry point), at
    small parameters with the Rescue evaluators."""
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    from stark_anatomy_tpu.models import rescue_prime as JR
    from stark_anatomy_tpu.protocols.fast_stark import FastStark as JStark
    from stark_anatomy_tpu_torch.models import rescue_prime as TR
    from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark as TStark

    field = Field.main()
    rp = TR.RescuePrime()
    args = (field, 4, 2, 4, rp.m, rp.N + 1)
    js = JStark(*args, transition_constraints_degree=3)
    ts = TStark(*args, transition_constraints_degree=3, device="cpu")
    sk = field.sample(b"fast stark witness")
    trace = rp.trace(sk)
    boundary = rp.boundary_constraints(rp.hash(sk))
    air = rp.transition_constraints(ts.omicron)

    jtz, ttz = js.preprocess(), ts.preprocess()
    assert ttz.root == jtz.root
    jproof = js.prove(trace, air, boundary, jtz, air_evaluator=JR.make_air_evaluator(js),
                      urandom=det_urandom(b"fast"))
    tproof = ts.prove(trace, air, boundary, ttz, air_evaluator=TR.make_air_evaluator(ts),
                      urandom=det_urandom(b"fast"))
    assert tproof == jproof

    index_air = TR.make_index_air_evaluator(ts)
    assert ts.verify(tproof, air, boundary, ttz.root, air_index_evaluator=index_air)
    # the scalar per-index loop (no batched evaluator) agrees
    assert ts.verify(tproof, air, boundary, ttz.root, air_point_evaluator=TR.make_point_air(ts))
    wrong = [(c, r, v + field.one()) for c, r, v in boundary]
    assert not ts.verify(tproof, air, wrong, ttz.root, air_index_evaluator=index_air)


def test_sign_records_the_jax_prove_batch_phases(schemes, signatures):
    """The port's PhaseTimer holds the JAX package's five prove_batch phase
    names after a sign, each timed once per sign (and the port's own
    ``verify`` phase, once per verify)."""
    jax_scheme, port = schemes
    phases = {"pipeline", "commit", "combination", "fri", "openings"}
    signed = {name: port.stark.timer.counts[name] for name in port.stark.timer.totals}
    signed.pop("verify", None)
    assert set(signed) == set(jax_scheme.stark.timer.totals) == phases
    assert len(set(signed.values())) == 1
    assert all(port.stark.timer.totals[name] > 0 for name in phases)
