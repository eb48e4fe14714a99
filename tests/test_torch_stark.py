"""The slow scalar STARK and RPSSS in the port on the CPU, against the
JAX package (the cases of tests/test_stark.py).

At tests/test_stark.py's parameters (expansion 4, 2 colinearity checks,
security 2, the Rescue-Prime trace), a seeded proof is byte-identical to
the JAX ``Stark``'s (the JAX package draws from ``os.urandom``, which the
tests replace with a counter-mode stream by monkeypatch; the port takes
the same stream as ``urandom=``), each package verifies the other's
proof, a wrong boundary is rejected, and a false witness crashes both
provers with an AssertionError (the reference's contract, DEVIATIONS.md
#7).  ``RPSSS(device="cpu")`` signs and verifies at the same small
parameters and gives the JAX scheme's bytes.  The entry points run on the
card unless asked for the CPU: without CUDA they raise.
"""

import hashlib
import os
import random

import pytest
import torch

from stark_anatomy_tpu.config import StarkConfig as JaxStarkConfig
from stark_anatomy_tpu.field.scalar import Field as JaxField
from stark_anatomy_tpu.models.rescue_prime import RescuePrime as JaxRescuePrime
from stark_anatomy_tpu.models.rpsss import RPSSS as JaxRPSSS
from stark_anatomy_tpu.protocols.stark import Stark as JaxStark
from stark_anatomy_tpu_torch.config import StarkConfig
from stark_anatomy_tpu_torch.field.scalar import Field, P
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
from stark_anatomy_tpu_torch.models.rpsss import RPSSS
from stark_anatomy_tpu_torch.protocols.stark import Stark

torch.set_num_threads(1)

FIELD = Field.main()
JFIELD = JaxField.main()
RNG = random.Random(0xFEED)
SMALL = dict(expansion_factor=4, num_colinearity_checks=2, security_level=2)


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


def port_stark():
    rp = RescuePrime()
    return rp, Stark(field=FIELD, num_registers=rp.m, num_cycles=rp.N + 1, device="cpu", **SMALL)


def jax_stark():
    rp = JaxRescuePrime()
    return rp, JaxStark(field=JFIELD, num_registers=rp.m, num_cycles=rp.N + 1, **SMALL)


def statement(rp, field, seed: bytes):
    x = field.sample(seed)
    out = rp.hash(x)
    return x, out, rp.trace(x), rp.boundary_constraints(out)


@pytest.fixture(scope="module")
def proofs():
    """(port proof, JAX proof) of one seeded statement, with both starks."""
    rp, stark = port_stark()
    jrp, jstark = jax_stark()
    _, _, trace, boundary = statement(rp, FIELD, b"0xdeadbeef")
    _, _, jtrace, jboundary = statement(jrp, JFIELD, b"0xdeadbeef")
    air = rp.transition_constraints(stark.omicron)
    jair = jrp.transition_constraints(jstark.omicron)
    proof = stark.prove(trace, air, boundary, urandom=det_urandom(b"slow stark"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        mp.setattr(os, "urandom", det_urandom(b"slow stark"))
        jproof = jstark.prove(jtrace, jair, jboundary)
    return (stark, air, boundary, proof), (jstark, jair, jboundary, jproof)


def test_seeded_proof_is_byte_identical_to_jax(proofs):
    (_, _, _, proof), (_, _, _, jproof) = proofs
    assert proof == jproof


def test_each_package_verifies_the_others_proof(proofs, monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    (stark, air, boundary, proof), (jstark, jair, jboundary, jproof) = proofs
    assert stark.verify(proof, air, boundary), stark.last_rejection
    assert stark.verify(jproof, air, boundary), stark.last_rejection
    assert jstark.verify(proof, jair, jboundary)


def test_wrong_boundary_is_rejected(proofs):
    (stark, air, boundary, proof), _ = proofs
    rp = RescuePrime()
    output = [v for c, r, v in boundary if c > 0][0]
    assert not stark.verify(proof, air, rp.boundary_constraints(output + FIELD.one()))
    assert stark.last_rejection
    assert not stark.verify(proof[:-50], air, boundary)


def test_prove_verify_chain_of_statements():
    """tests/test_stark.py's loop: each proof's output is the next input."""
    rp, stark = port_stark()
    x = FIELD.sample(b"chain")
    air = rp.transition_constraints(stark.omicron)
    for _ in range(2):
        out = rp.hash(x)
        boundary = rp.boundary_constraints(out)
        proof = stark.prove(rp.trace(x), air, boundary)
        assert stark.verify(proof, air, boundary), stark.last_rejection
        x = out


@pytest.mark.parametrize("package", ["port", "jax"])
def test_false_witness_crashes_the_prover(package, monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    rp, stark = port_stark() if package == "port" else jax_stark()
    field = FIELD if package == "port" else JFIELD
    _, _, trace, boundary = statement(rp, field, b"witness")
    air = rp.transition_constraints(stark.omicron)
    cycle = RNG.randrange(len(trace))
    register = RNG.randrange(rp.m)
    trace[cycle][register] = trace[cycle][register] + field(RNG.randrange(1, P))
    with pytest.raises(AssertionError):
        stark.prove(trace, air, boundary)


def test_stark_params_members_match_jax():
    _, stark = port_stark()
    _, jstark = jax_stark()
    assert [e.value for e in stark.omicron_domain] == [e.value for e in jstark.omicron_domain]
    assert [c.value for c in stark.transition_zerofier().coefficients] == \
        [c.value for c in jstark.transition_zerofier().coefficients]
    from stark_anatomy_tpu_torch.utils.convert import ints_from_device

    for count in (1, 5, 28):
        assert ints_from_device(stark.omicron_powers_device(count)) == \
            [e.value for e in stark.omicron_powers(count)]


def test_rpsss_signs_and_verifies_like_jax(monkeypatch):
    """RPSSS at the small parameters: sign, verify, a forged document and
    another key's pk rejected, and the JAX scheme's bytes."""
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    cfg = dict(num_colinearity_checks=2, security_level=4)
    scheme = RPSSS(device="cpu", config=StarkConfig(**cfg))
    assert scheme.device == torch.device("cpu")
    keys = det_urandom(b"rpsss keys")
    sk, pk = scheme.keygen(keys)
    _, pk_other = scheme.keygen(keys)
    doc = b"slow signature"
    sig = scheme.sign(sk, doc, det_urandom(b"rpsss sign"))
    assert scheme.verify(pk, doc, sig), scheme.stark.last_rejection
    assert not scheme.verify(pk, b"forged document", sig)
    assert not scheme.verify(pk_other, doc, sig)

    jscheme = JaxRPSSS(JaxStarkConfig(**cfg))
    monkeypatch.setattr(os, "urandom", det_urandom(b"rpsss sign"))
    jsig = jscheme.sign(JFIELD(sk.value), doc)
    assert sig == jsig
    assert jscheme.verify(JFIELD(pk.value), doc, sig)


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    from stark_anatomy_tpu_torch.entry import entry
    from stark_anatomy_tpu_torch.parallel.batch_prover import make_batch_rpsss

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (RPSSS, make_batch_rpsss, entry, lambda: Stark(FIELD, 4, 2, 2, 2, 28)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
