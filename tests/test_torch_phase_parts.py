"""Named parts of a prove phase (utils/profiling.py:PhaseTimer).

A name ``"<phase>.<part>"`` is a part of ``<phase>``: it is timed through
the same ``phase`` call, kept out of ``totals`` and ``counts``, and listed
under its phase by ``report``.  A device prove of the MiMC chain on the CPU
(``STARK_TPU_DEVICE_HASH=1``, so the device FRI runs through the plain
versions of its kernels) records the three parts of ``fri`` (every round
folds on the card, to the last layer) and the two of ``trace_gen``, each
inside its phase, in the order the prover runs them, and the parts change
no byte of the proof.
"""

import contextlib
import hashlib
import time

import pytest
import torch

from stark_anatomy_tpu_torch.commit.device_merkle import DeviceRows
from stark_anatomy_tpu_torch.field.scalar import Field
from stark_anatomy_tpu_torch.models import mimc as TM
from stark_anatomy_tpu_torch.protocols.fri import Fri
from stark_anatomy_tpu_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)

PROVE_PHASES = {"trace_gen", "trace_lde", "boundary_quotients", "commit_bq", "air_quotients",
                "randomizer_poly", "commit_randomizer", "combination", "fri", "openings"}
FRI_PARTS = {"fri.rounds", "fri.leave", "fri.queries"}
TRACE_PARTS = {"trace_gen.chain", "trace_gen.upload"}
# make_stark(steps, 4, 4, 8): steps -> (the FRI domain, its rounds), the
# last layer 32 elements
STEPS = [(15, 512, 5), (63, 1024, 6), (127, 2048, 7), (255, 4096, 8)]


class SpanRecorder(PhaseTimer):
    """A PhaseTimer that also keeps each phase and part as (name, start,
    end), as a tracing subclass does."""

    def __init__(self):
        super().__init__()
        self.spans = []

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            with super().phase(name):
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))


def det_urandom(seed: bytes):
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def device_prove(monkeypatch, timer, steps=63, domain=1024, rounds=6, device_hash="1"):
    """A seeded prove of the ``steps``-step chain with ``timer`` on the
    stark, on the device path (``device_hash`` "0": the host FRI); the
    proof's bytes."""
    monkeypatch.setenv("STARK_TPU_DEVICE_HASH", device_hash)
    mimc, stark = TM.make_stark(steps, 4, 4, 8, device="cpu")
    assert (stark.fri.domain_length, stark.fri.num_rounds()) == (domain, rounds)
    stark.timer = timer
    x = Field.main().sample(b"phase parts")
    _, proof, _ = TM.prove_chain(mimc, stark, x, urandom=det_urandom(b"phase parts"))
    return proof


@pytest.mark.parametrize("steps,domain,rounds", STEPS)
def test_a_device_prove_records_the_parts_of_fri_and_trace_gen(monkeypatch, steps, domain, rounds):
    timer = PhaseTimer()
    device_prove(monkeypatch, timer, steps, domain, rounds)
    assert set(timer.totals) == PROVE_PHASES
    assert set(timer.counts) == PROVE_PHASES
    want = {"fri.rounds": 1, "fri.leave": 1, "fri.queries": 1,
            "trace_gen.chain": 1, "trace_gen.upload": 1}
    assert dict(timer.part_counts) == want
    assert set(timer.parts) == set(want) <= FRI_PARTS | TRACE_PARTS
    for phase in ("fri", "trace_gen"):
        inside = sum(v for k, v in timer.parts.items() if k.startswith(phase + "."))
        assert 0 < inside <= timer.totals[phase]


def test_one_device_folds_to_the_last_layer_on_the_card_and_changes_no_byte(monkeypatch):
    """Every round folds on the device path and only the last layer (32
    elements) leaves it, and the proof is the host FRI's (prove_host: every
    fold on the host)."""
    layers = []
    commit = Fri.commit

    def spy(self, *args, **kwargs):
        out = commit(self, *args, **kwargs)
        layers.extend(out[0])
        return out

    monkeypatch.setattr(Fri, "commit", spy)
    proof = device_prove(monkeypatch, PhaseTimer())
    assert [type(layer) for layer in layers] == [DeviceRows] * 6
    assert [len(layer) for layer in layers] == [1024 >> r for r in range(6)]
    monkeypatch.setattr(Fri, "commit", commit)
    assert proof == device_prove(monkeypatch, PhaseTimer(), device_hash="0")


def test_parts_lie_inside_their_phase_in_order_and_change_no_byte(monkeypatch):
    recorder = SpanRecorder()
    proof = device_prove(monkeypatch, recorder)
    assert proof == device_prove(monkeypatch, PhaseTimer())
    spans = sorted(recorder.spans, key=lambda s: s[1])
    phases = {name: (a, b) for name, a, b in spans if "." not in name}
    for name, a, b in spans:
        if "." in name:
            lo, hi = phases[name.partition(".")[0]]
            assert lo <= a <= b <= hi, name
    fri = [(name, a, b) for name, a, b in spans if name.startswith("fri.")]
    assert [name for name, _, _ in fri] == ["fri.rounds", "fri.leave", "fri.queries"]
    assert all(b <= a2 for (_, _, b), (_, a2, _) in zip(fri, fri[1:]))
    assert [name for name, _, _ in spans if name.startswith("trace_gen.")] == [
        "trace_gen.chain", "trace_gen.upload"]


def test_parts_stay_out_of_the_phase_table():
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("fri"):
            with timer.phase("fri.rounds"):
                pass
            with timer.phase("fri.leave"):
                pass
    assert set(timer.totals) == set(timer.counts) == {"fri"}
    assert timer.counts["fri"] == 2
    assert dict(timer.part_counts) == {"fri.rounds": 2, "fri.leave": 2}
    assert sum(timer.parts.values()) <= timer.totals["fri"]


def test_report_lists_each_part_under_its_phase_with_its_share():
    timer = PhaseTimer()
    timer.totals.update({"fri": 0.4, "trace_gen": 0.1, "openings": 0.2})
    timer.counts.update({"fri": 1, "trace_gen": 1, "openings": 1})
    timer.parts.update({"fri.rounds": 0.1, "fri.leave": 0.2, "trace_gen.chain": 0.05})
    timer.part_counts.update({"fri.rounds": 1, "fri.leave": 1, "trace_gen.chain": 1})
    lines = timer.report().splitlines()
    assert [line.split()[0] for line in lines] == [
        "fri", "fri.leave", "fri.rounds", "openings", "trace_gen", "trace_gen.chain"]
    assert [line.startswith("  ") for line in lines] == [False, True, True, False, False, True]
    assert lines[1].split()[1:] == ["200.00", "ms", "x1", "50.0%", "of", "fri"]
    assert lines[2].split()[-3] == "25.0%"
    assert lines[5].split()[-3] == "50.0%"


BATCH_PHASES = {"pipeline", "commit", "combination", "fri", "openings"}


def batch_sign(timer):
    """A seeded batch of two signatures at small parameters (FRI domain
    512) with ``timer`` on the prover's stark; their bytes."""
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
    from stark_anatomy_tpu_torch.parallel.batch_prover import BatchProver
    from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark
    from stark_anatomy_tpu_torch.transcript.proof_stream import SignatureProofStream

    rp = RescuePrime()
    stark = FastStark(Field.main(), 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3,
                      device="cpu")
    stark.timer = timer
    prover = BatchProver(stark, rp, stark.preprocess())
    sks = [Field.main().sample(bytes([9, i])) for i in range(2)]
    streams = [SignatureProofStream(b"parts %d" % i) for i in range(2)]
    return prover.prove_batch(sks, streams, urandom=det_urandom(b"batch parts"))


def test_a_batch_records_its_statements_and_the_parts_of_fri_and_changes_no_byte():
    recorder = SpanRecorder()
    proofs = batch_sign(recorder)
    assert proofs == batch_sign(PhaseTimer())
    assert set(recorder.totals) == set(recorder.counts) == BATCH_PHASES
    assert dict(recorder.part_counts) == {"batch.statements": 2, "batch.draws": 1, "fri.rounds": 1,
                                          "fri.queries": 1}
    spans = sorted(recorder.spans, key=lambda s: s[1])
    names = [name for name, _, _ in spans]
    assert names == ["batch.statements", "batch.draws", "batch.statements", "pipeline", "commit",
                     "combination", "fri", "fri.rounds", "fri.queries", "openings"]
    fri = dict((name, (a, b)) for name, a, b in spans)["fri"]
    for name, a, b in spans:
        if name.startswith("fri."):
            assert fri[0] <= a <= b <= fri[1], name
    # the draws lie inside the first statements; the spans around them follow one another
    (_, s0, s1), (_, d0, d1) = spans[:2]
    assert s0 <= d0 <= d1 <= s1
    outer = [span for span in spans if span[0] != "batch.draws"]
    assert all(b <= a2 for (_, _, b), (_, a2, _) in zip(outer[:5], outer[1:6]))
