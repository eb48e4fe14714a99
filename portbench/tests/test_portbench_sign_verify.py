"""The single signer's cell (``rpsss.sign_verify``): its readers on
synthetic windows, its driver on the CPU, and its ``correct``.

The driver runs at a size a CPU can hold (the configuration's shapes with
4 colinearity checks, 2 keys, windows of one round trip: a CPU sign takes
seconds): the sound program comes out correct on a genuine round trip
and on each kind of forgery, and not correct with the timed path broken
underneath (a verifier that accepts everything, a signer that hands back
an earlier signature, a wrong public key) and under the control, the
program at half the checks and bits of security."""

import importlib.util
import json
import os

import pytest
import torch

from portbench import control
from portbench import harness as H
from portbench import roofline

torch.set_num_threads(1)

CELL = "rpsss.sign_verify"
SMALL = {"num_colinearity_checks": 4, "security_level": 8}
PARTS = ("decode", "fri", "openings", "core")
KINDS = ("document", "key", "byte")


def config():
    with open(os.path.join(H.HERE, "configs", "rpsss_single.json")) as f:
        return json.load(f)


def window(trips, spans=(), **kw):
    spans = [("bench.prove", a, b) for a, b in trips] + list(spans)
    return H.Window(0.0, 10.0, config(), H.load_cell(CELL).traffic, spans=spans,
                    requests={"prove": list(trips)}, **kw)


def test_the_cell_s_traffic_and_metrics():
    c = H.load_cell(CELL)
    assert c.chips == 1
    assert c.traffic == {"driver": "sign_verifier", "clients": 1, "keys": 8, "document_bytes": 64,
                         "forged_every": 8, "forgeries": ["document", "key", "byte"], "warmup": 8,
                         "judged": 16, "judged_forged": 8, "torch_threads": 1}
    assert [m["name"] for m in c.end_to_end] == ["mimc_proofs_per_s", "setup_s"]
    assert sorted(m["name"] for m in c.per_layer) == sorted(
        ["sv.sign_ms", "sv.verify_ms", "sv.verify_decode_ms", "sv.verify_fri_ms",
         "sv.verify_openings_ms", "sv.verify_core_ms", "sv.sign_launches", "device_idle.sv",
         "verify_roofline.sv"])
    with open(os.path.join(H.HERE, "configs", "rpsss_prod.json")) as f:
        prod = json.load(f)
    scheme = set(prod) - {"system", "source", "guarantees", "assumed"}
    assert {k: c.config[k] for k in scheme} == {k: prod[k] for k in scheme}
    assert c.config["reduced"] == []


def test_sign_and_verify_are_medians_and_leave_the_forgeries_out():
    trips = [(0.0, 1.0), (1.0, 2.0), (2.0, 3.0), (3.0, 4.0)]
    spans = [("bench.sign", 0.0, 0.5), ("bench.verify", 0.5, 0.6),
             ("bench.sign", 1.0, 1.3), ("bench.verify", 1.3, 1.5),
             ("bench.sign", 2.0, 2.4), ("bench.verify_forged", 2.4, 2.9),
             ("bench.sign", 3.0, 3.2), ("bench.verify", 3.2, 3.5)]
    win = window(trips, spans)
    assert H.metric_reader("sv.sign_ms")(win) == pytest.approx(350.0)
    assert H.metric_reader("sv.verify_ms")(win) == pytest.approx(200.0)
    assert H.metric_reader("sv.sign_ms")(window([])) is None
    assert H.metric_reader("sv.verify_ms")(window(trips, spans[:1])) is None


@pytest.mark.parametrize("part", PARTS)
def test_a_verify_part_sums_its_spans_in_each_round_trip(part):
    name = f"phase.verify.{part}"
    win = window([(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)],
                 [(name, 0.1, 0.2), (name, 0.5, 0.6),         # 0.2 in the first round trip
                  (name, 1.1, 1.4),                           # 0.3
                  (name, 2.1, 2.15),                          # 0.05
                  (name, 5.0, 6.0)])                          # in none
    assert H.metric_reader(f"sv.verify_{part}_ms")(win) == pytest.approx(200.0)
    # a program without the verifier's spans (the parent's) reads None
    assert H.metric_reader(f"sv.verify_{part}_ms")(window([(0.0, 1.0)])) is None


def test_round_trips_a_second_count_every_round_trip_to_the_end_of_the_last_one():
    win = window([(0.0, 14.0), (14.0, 31.0)], counts={"proofs": 2})
    assert H.metric_reader("mimc_proofs_per_s")(win) == pytest.approx(2 / 31.0)


def test_sign_launches_count_the_kernels_that_start_inside_a_sign():
    spans = [("bench.sign", 0.0, 1.0), ("bench.verify", 1.0, 2.0), ("bench.sign", 2.0, 3.0),
             ("bench.sign", 4.0, 5.0)]
    ops = [("rescue_kernel", 0.1, 0.2), ("Memcpy HtoD (Pageable -> Device)", 0.2, 0.3),
           ("merkle_kernel", 0.4, 0.5), ("Memset (Device)", 0.6, 0.7),
           ("verify_kernel", 1.5, 1.6),                          # in the verify
           ("rescue_kernel", 2.1, 2.2), ("ntt_kernel", 2.3, 2.4), ("fri_fold", 2.9, 3.1),
           ("merkle_kernel", 4.5, 4.6)]
    read = H.metric_reader("sv.sign_launches")
    trips = [(0.0, 2.0), (2.0, 4.0), (4.0, 6.0)]
    assert read(window(trips, spans, traced=True, ops=ops)) == 2       # of 2, 3 and 1
    assert read(window(trips, spans, ops=ops)) is None
    assert read(window(trips, [], traced=True, ops=ops)) is None


def test_idle_share_reads_the_trace():
    win = window([(0.0, 10.0)], traced=True, busy=[(1.0, 2.0), (1.5, 3.0)])
    assert H.metric_reader("device_idle.sv")(win) == pytest.approx(80.0)
    assert H.metric_reader("device_idle.sv")(window([(0.0, 10.0)])) is None


def test_verify_roofline_counts_h12_at_128_points():
    """H12's thread a point: 249 products (172 of them squarings: the
    inverse chain's 136, the AIR's 4 cubes', the shifts' 7, 7, 9 and 9)
    and 34 adds, at 41, 29 and 16 instructions; the 8 K opened values and
    points in and K values out."""
    from stark_anatomy_tpu_torch.field import kernels as K

    spec = importlib.util.spec_from_file_location(
        "roofline_sv", os.path.join(H.HERE, "metrics", "verify_roofline.sv.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    assert reader.point_counts(config()) == (77, 172, 34)
    squarings = sum(a == b for _, a, b in K.INV_CHAIN)
    assert (reader.INV_SQUARINGS, reader.INV_PRODUCTS) == (squarings, len(K.INV_CHAIN) - squarings)
    instructions = 128 * (77 * 41 + 172 * 29 + 34 * 16)
    least = max(9 * 128 * 16 / 3.35e12, instructions / (132 * 4 * 32 * 1.98e9))
    assert least == pytest.approx(instructions / roofline.ISSUE_PER_S)   # the operations bound it
    assert reader.least_seconds(config()) == pytest.approx(least)
    ops = [("(anonymous namespace)::verify_kernel(int*, VerifyArgs)", 1.0, 1.0000376),
           ("(anonymous namespace)::quotients_kernel(int*, int*, QuotientArgs)", 1.2, 1.3),
           ("(anonymous namespace)::verify_kernel(int*, VerifyArgs)", 3.0, 3.0000376)]
    read = H.metric_reader("verify_roofline.sv")
    win = window([(0.0, 2.0), (2.0, 4.0)], traced=True, ops=ops)
    assert read(win) == pytest.approx(100 * least / 0.0000376)
    assert read(window([(0.0, 2.0)], traced=True, ops=ops[1:2])) is None
    assert read(window([(0.0, 2.0)], ops=ops)) is None


# ---------------------------------------------------------------------------
# the driver on the CPU
# ---------------------------------------------------------------------------

def small_cell():
    c = H.load_cell(CELL)
    return H.Cell("test.sign_verify", 1, dict(c.config, **SMALL),
                  dict(c.traffic, keys=2, warmup=0), [], [])


def traffic(kind):
    """One round trip a window: genuine (the first of every 2), or a forgery
    of ``kind`` (every round trip forged)."""
    base = small_cell().traffic
    if kind == "genuine":
        return dict(base, forged_every=2)
    return dict(base, forged_every=1, forgeries=[kind])


@pytest.fixture(scope="module")
def driver():
    cell = small_cell()
    d = H.driver_module(cell).Driver(cell, device="cpu")
    d.setup(11)
    yield d
    d.close()


def run(driver, kind, seed=12):
    """(window, checks) of one round trip."""
    driver.traffic = traffic(kind)
    win = driver.window(seed, 0.5, False)
    checks = driver.judge(win, seed)
    assert driver.attempted(win) == (1, 0)
    return win, checks


@pytest.mark.parametrize("kind", ("genuine",) + KINDS)
def test_the_sound_program_is_correct_and_its_spans_tile_a_round_trip(driver, kind):
    win, checks = run(driver, kind)
    assert H.within(checks), checks
    assert win.counts["proofs"] == len(win.requests["prove"]) == 1
    (lo, hi), = win.requests["prove"]
    inside = [(n, a, b) for n, a, b in win.spans if lo <= a and b <= hi]
    total = lambda names: sum(b - a for n, a, b in inside if n in names)
    verify_span = "bench.verify" if kind == "genuine" else "bench.verify_forged"
    assert total({"bench.sign", verify_span}) >= 0.9 * (hi - lo)
    (vlo, vhi), = [(a, b) for n, a, b in inside if n == verify_span]
    (plo, phi), = [(a, b) for n, a, b in inside if n == "phase.verify"]
    assert vlo <= plo <= phi <= vhi
    parts = {f"phase.verify.{p}" for p in PARTS}
    assert total(parts) >= 0.9 * (phi - plo)
    opened = {n for n, _, _ in inside if n in parts}
    # another key's pk passes FRI and the openings and fails in the core
    assert opened == parts if kind in ("genuine", "key") else "phase.verify.decode" in opened
    if kind != "genuine":
        (*_, accepted), = driver.forgeries
        assert accepted is False


def test_the_control_is_not_correct():
    cell = small_cell()
    d = H.driver_module(cell).Driver(cell, program=control.control_program(cell.config),
                                     device="cpu")
    d.setup(11)
    try:
        _, checks = run(d, "genuine")
    finally:
        d.close()
    assert not H.within(checks), checks
    assert checks["signatures_rejected"][0] == 1 and checks["genuine_rejected"][0] == 0


@pytest.mark.parametrize("fault", ["accepts_all", "stale", "key"])
def test_sign_verify_faults(driver, monkeypatch, fault):
    scheme = driver.scheme
    kind = "genuine"
    if fault == "accepts_all":
        monkeypatch.setattr(scheme, "verify", lambda pk, document, signature: True)
        kind = "byte"
    elif fault == "stale":
        # the stale signer signs, and hands back the signature of an earlier
        # document
        sign = scheme.sign
        earlier = sign(driver.sks[0], b"earlier")

        def stale(sk, document, urandom):
            sign(sk, document, urandom)
            return earlier

        monkeypatch.setattr(scheme, "sign", stale)
    else:
        monkeypatch.setattr(driver, "keys", [(sk, pk + 1) for sk, pk in driver.keys])
    _, checks = run(driver, kind)
    assert not H.within(checks), checks
    named = {"accepts_all": "forgeries_accepted", "stale": "signatures_rejected",
             "key": "keys_wrong"}[fault]
    assert checks[named][0] > 0
    if fault == "key":
        assert checks["signatures_rejected"][0] == 0


def test_a_forgery_in_the_zerofier_s_multiproof_is_judged_by_the_root_it_implies(driver,
                                                                                monkeypatch):
    """The transcript holds no zerofier root, so the reference checks the
    opened zerofier values and returns the root that their multiproof
    implies.  A byte changed in that multiproof passes its checks with
    another root; the port, which holds the root, rejects it, and the
    judge must count the reference's verdict as a rejection too."""
    from portbench.reference.rescue_prime import verify_signature, zerofier_root
    from portbench.reference.transcript import Transcript

    forged = []

    def in_the_zerofier_multiproof(kind, k, document, signature, draw):
        at = Transcript(signature).ends[-2] + 8           # the last object's first digest
        forged.append(signature[:at] + bytes([signature[at] ^ 1]) + signature[at + 1:])
        return k, document, forged[-1]

    monkeypatch.setattr(driver, "_forge", in_the_zerofier_multiproof)
    _, checks = run(driver, "byte")
    assert H.within(checks), checks
    cfg = driver.params
    (k, document, _), = driver.trips
    root = verify_signature(cfg, driver.keys[k][1], document, forged[0])
    assert root != zerofier_root(cfg)
