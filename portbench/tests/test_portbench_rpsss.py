"""The bulk signer's cell (``rpsss.batch64``): its readers on synthetic
windows, its spans on a CPU batch, and its ``correct``.

The driver runs at a size a CPU can hold (the configuration's shapes with
4 colinearity checks and a batch of 2): the sound program comes out
correct, and it comes out not correct with the timed path broken
underneath (a signature altered, a wrong public key, a batch that hands
back its first signatures again) and under the control, the program at
half the checks and bits of security."""

import json
import os

import pytest
import torch

from portbench import control
from portbench import harness as H
from portbench import roofline

torch.set_num_threads(1)

CELL = "rpsss.batch64"
SMALL = {"num_colinearity_checks": 4, "security_level": 8}
PHASES = ("pipeline", "commit", "fri", "openings")
PART_READERS = {"rpsss.statements_ms": "batch.statements", "rpsss.fri_rounds_ms": "fri.rounds",
                "rpsss.fri_queries_ms": "fri.queries"}


def config():
    with open(os.path.join(H.HERE, "configs", "rpsss_prod.json")) as f:
        return json.load(f)


def window(batches, spans, **kw):
    spans = [("bench.prove", a, b) for a, b in batches] + spans
    traffic = {"batch": 64}
    return H.Window(0.0, 10.0, config(), traffic, spans=spans, requests={"prove": list(batches)},
                    **kw)


def test_the_cell_s_traffic_and_metrics():
    c = H.load_cell(CELL)
    assert c.chips == 1
    assert c.traffic == {"driver": "batch_signer", "batch": 64, "keys": 64, "document_bytes": 64,
                         "warmup": 2, "judged": 16, "torch_threads": 1}
    assert [m["name"] for m in c.end_to_end] == ["mimc_proofs_per_s", "setup_s"]
    assert sorted(m["name"] for m in c.per_layer) == sorted(
        ["rpsss.batch_ms", "rpsss.statements_ms", "rpsss.pipeline_ms", "rpsss.commit_ms",
         "rpsss.fri_ms", "rpsss.openings_ms", "rpsss.fri_rounds_ms", "rpsss.fri_queries_ms",
         "device_idle.rpsss", "air_roofline.rpsss"])
    assert c.config["reduced"] == [] and c.config["fri_domain_length"] == 4096


def test_batch_time_and_phases_are_medians_over_the_batches():
    batches = [(0.0, 2.0), (2.0, 5.0), (5.0, 6.0)]
    spans = [(f"phase.{p}", a + 0.1 * k, a + 0.1 * k + w)
             for (a, _), w in zip(batches, (0.2, 0.4, 0.3)) for k, p in enumerate(PHASES)]
    win = window(batches, spans)
    assert H.metric_reader("rpsss.batch_ms")(win) == pytest.approx(2000.0)
    for p in PHASES:
        assert H.metric_reader(f"rpsss.{p}_ms")(win) == pytest.approx(300.0)
    assert H.metric_reader("rpsss.batch_ms")(window([], [])) is None
    assert H.metric_reader("rpsss.openings_ms")(window(batches, [])) is None


@pytest.mark.parametrize("metric,part", sorted(PART_READERS.items()))
def test_a_part_sums_its_spans_in_each_batch(metric, part):
    name = "phase." + part
    win = window([(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)],
                 [(name, 0.1, 0.2), (name, 0.5, 0.6),         # 0.2 in the first batch
                  (name, 1.1, 1.4),                           # 0.3
                  (name, 2.1, 2.15),                          # 0.05
                  (name, 5.0, 6.0)])                          # in no batch
    assert H.metric_reader(metric)(win) == pytest.approx(200.0)
    assert H.metric_reader(metric)(window([(0.0, 1.0)], [])) is None


def test_signatures_a_second_count_every_signature_to_the_end_of_the_last_batch():
    win = window([(0.0, 14.0), (14.0, 31.0)], [], counts={"proofs": 128})
    assert H.metric_reader("mimc_proofs_per_s")(win) == pytest.approx(128 / 31.0)


def test_air_roofline_counts_h10_s_bytes_at_the_batch():
    n = 4096
    least = (8 * 64 + 7) * n * 16 / 3.35e12                  # 519 codewords of 16-byte elements
    read = H.metric_reader("air_roofline.rpsss")
    ops = [("(anonymous namespace)::quotients_kernel(int*, int*, QuotientArgs)", 1.0, 1.0001),
           ("(anonymous namespace)::combination_kernel(int*, CombinationArgs)", 1.2, 1.3),
           ("(anonymous namespace)::quotients_kernel(int*, int*, QuotientArgs)", 3.0, 3.00005)]
    win = window([(0.0, 2.0), (2.0, 4.0)], [], traced=True, ops=ops)
    assert read(win) == pytest.approx(100 * 2 * least / 0.00015)
    assert least == pytest.approx(roofline.least_seconds(519 * n * 16))
    assert read(window([(0.0, 2.0)], [], traced=True, ops=ops[1:2])) is None
    assert read(window([(0.0, 2.0)], [], ops=ops)) is None


def test_idle_share_reads_the_trace():
    win = window([(0.0, 10.0)], [], traced=True, busy=[(1.0, 2.0), (1.5, 3.0)])
    assert H.metric_reader("device_idle.rpsss")(win) == pytest.approx(80.0)
    assert H.metric_reader("device_idle.rpsss")(window([(0.0, 10.0)], [])) is None


# ---------------------------------------------------------------------------
# the driver on the CPU
# ---------------------------------------------------------------------------

def small_cell():
    c = H.load_cell(CELL)
    return H.Cell("test.sign_batch", 1, dict(c.config, **SMALL),
                  dict(c.traffic, batch=2, keys=2, warmup=1, judged=3), [], [])


def run(breaker=None, program=None, seconds=3.0):
    """(driver, window, checks) of one small run on the CPU; ``breaker()``
    runs between set-up and window."""
    cell = small_cell()
    driver = H.driver_module(cell).Driver(cell, program=program, device="cpu")
    driver.setup(11)
    if breaker:
        breaker(driver)
    try:
        win = driver.window(12, seconds, False)
    finally:
        driver.close()
    checks = driver.judge(win, 12)
    assert driver.attempted(win)[0] > 0
    return driver, win, checks


def test_the_sound_program_is_correct_and_its_spans_tile_a_batch():
    driver, win, checks = run()
    assert H.within(checks), checks
    assert win.counts["proofs"] == 2 * len(win.requests["prove"]) >= 2
    for lo, hi in win.requests["prove"]:
        inside = [(n, a, b) for n, a, b in win.spans if lo <= a and b <= hi]
        total = lambda names: sum(b - a for n, a, b in inside if n in names)
        phases = {"phase.batch.statements"} | {f"phase.{p}" for p in PHASES + ("combination",)}
        assert total(phases) >= 0.9 * (hi - lo)
        fri = total({"phase.fri"})
        assert 0 <= fri - total({"phase.fri.rounds", "phase.fri.queries"}) <= max(0.002, 0.02 * fri)


def test_the_control_is_not_correct():
    cell = small_cell()
    _, win, checks = run(program=control.control_program(cell.config))
    assert not H.within(checks), checks
    assert checks["signatures_rejected"][0] == min(3, win.counts["proofs"])


@pytest.mark.parametrize("fault", ["signature", "key", "stale"])
def test_batch_faults(fault):
    def breaker(driver):
        if fault == "key":
            driver.keys = [(sk, pk + 1) for sk, pk in driver.keys]
            return
        sign = driver.sign_batch
        # the stale signer hands back the signatures of an earlier batch
        earlier = sign(driver.sks, [b"earlier"] * len(driver.sks))

        def broken(sks, docs):
            sigs = sign(sks, docs)
            if fault == "stale":
                return earlier
            i = len(sigs[0]) // 3
            return [s[:i] + bytes([s[i] ^ 0x5A]) + s[i + 1:] for s in sigs]

        driver.sign_batch = broken

    _, _, checks = run(breaker)
    assert not H.within(checks), checks
    if fault == "key":
        assert checks["keys_wrong"][0] > 0 and checks["signatures_rejected"][0] == 0
    else:
        assert checks["signatures_rejected"][0] > 0
