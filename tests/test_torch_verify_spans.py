"""The verifier's spans and its rejection path, on the CPU at the
production parameters.

``FastStark.verify`` times the phase ``verify`` and its parts
``verify.decode``, ``verify.fri``, ``verify.openings`` and ``verify.core``
on its timer: the parts open inside the phase and tile it, every span
closes on a rejection, and the verdicts and reasons are those of a run
whose timer records nothing.  On three kinds of forgery (another
document, another key's pk, one byte of the signature changed) the
port's verdict is the plain reference's (portbench/reference, Python
integers).  A signature whose two copies of one opened value differ is
rejected."""

import contextlib
import hashlib
import json
import os
import time

import pytest
import torch

from portbench.reference import openings
from portbench.reference.rescue_prime import verify_signature
from portbench.reference.stark import Rejected, verify_fri
from portbench.reference.transcript import Transcript
from stark_anatomy_tpu_torch.errors import MalformedProof
from stark_anatomy_tpu_torch.models.rpsss import FastRPSSS
from stark_anatomy_tpu_torch.protocols.stark import opened_section
from stark_anatomy_tpu_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = b"a 64-byte document, signed once and verified under its own key..."
PARTS = ("verify.decode", "verify.fri", "verify.openings", "verify.core")
KINDS = ("document", "key", "byte")


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


class Recorder(PhaseTimer):
    """A PhaseTimer that keeps every span (name, start, end) and the names
    still open."""

    def __init__(self):
        super().__init__()
        self.spans = []
        self.open = []

    @contextlib.contextmanager
    def phase(self, name: str):
        self.open.append(name)
        t0 = time.perf_counter()
        try:
            with super().phase(name):
                yield
        finally:
            self.open.remove(name)
            self.spans.append((name, t0, time.perf_counter()))


class Silent(PhaseTimer):
    """A timer that records nothing."""

    def phase(self, name: str):
        return contextlib.nullcontext()


@pytest.fixture(scope="module")
def signed():
    """(scheme, [(sk, pk)] of two seeded keys, one signature of DOC under
    the first)."""
    scheme = FastRPSSS(device="cpu")
    keys = [scheme.keygen(det_urandom(b"verify spans key %d" % k)) for k in range(2)]
    sig = scheme.sign(keys[0][0], DOC, det_urandom(b"verify spans sign"))
    return scheme, keys, sig


def forgery(kind, keys, sig):
    """(pk, document, signature) of a forgery of ``sig`` of DOC under key 0."""
    if kind == "document":
        return keys[0][1], DOC[:5] + bytes([DOC[5] ^ 0x21]) + DOC[6:], sig
    if kind == "key":
        return keys[1][1], DOC, sig
    at = len(sig) * 3 // 7
    return keys[0][1], DOC, sig[:at] + bytes([sig[at] ^ 0x5A]) + sig[at + 1:]


def verify(scheme, timer, pk, document, signature):
    scheme.stark.timer = timer
    try:
        return scheme.verify(pk, document, signature), scheme.stark.last_rejection
    finally:
        scheme.stark.timer = PhaseTimer()


def test_the_parts_open_inside_verify_and_tile_it(signed):
    scheme, keys, sig = signed
    timer = Recorder()
    assert verify(scheme, timer, keys[0][1], DOC, sig) == (True, None)
    (lo, hi), = [(a, b) for n, a, b in timer.spans if n == "verify"]
    parts = [(n, a, b) for n, a, b in timer.spans if n != "verify"]
    assert [n for n, _, _ in parts] == list(PARTS)
    assert all(lo <= a <= b <= hi for _, a, b in parts)
    assert sum(b - a for _, a, b in parts) >= 0.9 * (hi - lo)
    assert set(timer.totals) == {"verify"} and set(timer.parts) == set(PARTS)


@pytest.mark.parametrize("kind", KINDS)
def test_the_spans_close_on_each_forgery(signed, kind):
    scheme, keys, sig = signed
    timer = Recorder()
    accepted, reason = verify(scheme, timer, *forgery(kind, keys, sig))
    assert accepted is False and reason
    assert timer.open == []
    names = [n for n, _, _ in timer.spans]
    assert names[-1] == "verify" and names.count("verify") == 1
    assert names[:-1] == list(PARTS[:len(names) - 1])


@pytest.mark.parametrize("kind", ("genuine",) + KINDS)
def test_the_verdicts_and_reasons_are_those_of_a_silent_timer(signed, kind):
    scheme, keys, sig = signed
    args = (keys[0][1], DOC, sig) if kind == "genuine" else forgery(kind, keys, sig)
    assert verify(scheme, Recorder(), *args) == verify(scheme, Silent(), *args)


def config():
    with open(os.path.join(ROOT, "portbench", "configs", "rpsss_single.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", KINDS)
def test_the_port_and_the_plain_reference_reject_each_forgery(signed, kind):
    scheme, keys, sig = signed
    pk, document, signature = forgery(kind, keys, sig)
    assert scheme.verify(pk, document, signature) is False
    with pytest.raises(Rejected):
        verify_signature(config(), pk.value, document, signature)
    # and both accept the genuine signature
    assert scheme.verify(keys[0][1], DOC, sig)
    verify_signature(config(), keys[0][1].value, DOC, sig)


def test_two_copies_of_an_opened_value_must_agree(signed):
    """A query's index that is another query's next point is opened twice
    in each section; the leaf hashes one copy.  Changing the other copy
    must not leave the signature valid."""
    scheme, keys, sig = signed
    ts = Transcript(sig, hashlib.blake2s(DOC).digest())
    params = openings.RP.params(config())
    for _ in range(params.num_registers + 1):
        ts.pull(bytes)
    indices = sorted(i for i, _ in verify_fri(params, ts))
    n, e = params.fri_length, params.expansion_factor
    positions = sorted(indices + [(i + e) % n for i in indices])
    twice = next(j for j in range(len(positions) - 1) if positions[j] == positions[j + 1])
    section = ts.read                                 # the first opened values' object
    at = ts.ends[section] + 5 + 16 * twice + 15      # the last byte of its first copy
    changed = sig[:at] + bytes([sig[at] ^ 1]) + sig[at + 1:]
    assert scheme.verify(keys[0][1], DOC, changed) is False
    assert "two openings of position" in scheme.stark.last_rejection
    assert openings.copies_differ(config(), DOC, changed) is not None
    assert openings.copies_differ(config(), DOC, sig) is None


def test_an_opened_section_reads_each_position_once():
    assert opened_section([3, 5, 5, 9], [30, 50, 50, 90], "s") == {3: 30, 5: 50, 9: 90}
    with pytest.raises(MalformedProof, match="two openings of position 5 differ"):
        opened_section([3, 5, 5, 9], [30, 50, 51, 90], "s")
    with pytest.raises(MalformedProof, match="bad opened-values section"):
        opened_section([3, 5], [30], "s")
