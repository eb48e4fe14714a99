"""The metric readers on synthetic windows: phase device time, roofline
shares, the idle share as the union of the device's intervals, and
rates."""

import pytest

from portbench import harness as H
from portbench import roofline
from portbench.reference.stark import Params

MIMC = {"steps": 1 << 20, "expansion_factor": 4, "num_colinearity_checks": 64,
        "transition_constraints_degree": 3}


def window(**kw):
    return H.Window(kw.pop("t0", 0.0), kw.pop("t1", 10.0), kw.pop("config", MIMC), {}, **kw)


def test_phase_device_time_sums_the_operations_inside_its_spans():
    win = window(traced=True,
                 spans=[("phase.trace_lde", 1.0, 2.0), ("phase.trace_lde", 5.0, 6.0),
                        ("phase.fri", 2.0, 5.0)],
                 ops=[("ntt", 1.1, 1.3), ("ntt", 1.9, 2.2), ("mul", 5.5, 5.6), ("fold", 3.0, 4.0)])
    count, seconds = win.device_seconds({"phase.trace_lde"})
    assert count == 2
    assert seconds == pytest.approx(0.2 + 0.1 + 0.1)


def test_ntt_roofline_is_least_time_over_device_time():
    params = Params.of(MIMC, 1, MIMC["steps"] + 1)
    least = 16 * (params.randomized_trace_length + params.fri_length) / roofline.HBM_BYTES_PER_S
    win = window(traced=True, spans=[("phase.trace_lde", 1.0, 2.0)], ops=[("ntt", 1.0, 1.004)])
    assert H.metric_reader("ntt_roofline.mimc")(win) == pytest.approx(100 * least / 0.004)
    assert params.fri_length == 1 << 24 and params.randomized_trace_length == (1 << 20) + 1 + 256


def test_merkle_roofline_counts_compressions_at_the_issue_rate():
    n = 1 << 24
    least = (n - 1) * 960 / (132 * 4 * 32 * 1.98e9)
    assert least > n * 16 / 3.35e12                      # the instructions bound it
    win = window(traced=True, spans=[("phase.commit_bq", 1.0, 2.0), ("phase.commit_randomizer", 3.0, 4.0)],
                 ops=[("merkle", 1.0, 1.001), ("canon", 1.001, 1.0012), ("merkle", 3.0, 3.001)])
    assert H.metric_reader("merkle_roofline.mimc")(win) == pytest.approx(100 * 2 * least / 0.0022)


def test_rooflines_are_silent_without_device_time():
    win = window(traced=True, spans=[("phase.trace_lde", 1.0, 2.0)], ops=[])
    assert H.metric_reader("ntt_roofline.mimc")(win) is None
    assert H.metric_reader("merkle_roofline.mimc")(window()) is None


def test_idle_share_is_the_union_of_the_device_s_intervals():
    # operations on several streams overlap: busy 1-3, 2-4 and 6-7 is 1-4 and 6-7
    win = window(traced=True, busy=[(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.5, 12.0)])
    assert win.busy_seconds() == pytest.approx(3.0 + 1.0 + 0.5)
    assert H.metric_reader("device_idle.mimc")(win) == pytest.approx(100 * (1 - 4.5 / 10))
    assert H.metric_reader("device_idle.mimc")(window()) is None


def test_merge_clips_and_joins():
    assert H.merge([(0, 2), (1, 3), (5, 6), (-1, 0.5)], 0.5, 5.5) == [(0.5, 3), (5, 5.5)]


def test_rates_count_all_work_over_the_time_it_took():
    proves = window(t0=10.0, t1=40.0, requests={"prove": [(10.0, 10.3), (39.8, 40.4)]},
                    counts={"proofs": 90})
    assert H.metric_reader("mimc_proofs_per_s")(proves) == pytest.approx(90 / 30.4)
    assert H.metric_reader("mimc_proofs_per_s")(window(requests={"prove": []})) is None


def test_phase_medians_take_every_span():
    win = window(spans=[("phase.fri", 0, 0.2), ("phase.fri", 0, 0.3), ("phase.fri", 0, 0.4),
                        ("phase.trace_gen", 0, 0.05)])
    assert H.metric_reader("mimc.fri_ms")(win) == pytest.approx(300)
    assert H.metric_reader("mimc.trace_gen_ms")(win) == pytest.approx(50)
    assert H.phase_ms(win, "commit_bq") is None


def test_breakdown_names_the_host_span_of_each_gap():
    win = window(t0=0.0, t1=10.0, traced=True,
                 spans=[("bench.prove", 0.0, 10.0), ("phase.fri", 4.0, 9.0)],
                 ops=[("ntt", 1.0, 4.0), ("ntt", 9.0, 9.5)])
    out = H.breakdown(win)
    assert out["device_ops"] == [["ntt", 3.5]]
    gaps = dict((k, v) for k, v in out["idle_gaps"])
    assert gaps["phase.fri"] == pytest.approx(5.0)
    assert gaps["bench.prove"] == pytest.approx(1.0 + 0.5)
