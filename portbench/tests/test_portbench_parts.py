"""The readers of the port's named parts of a phase on synthetic windows:
a part's spans summed inside each prove, spans outside every prove left
out, the median over the proves, and the count of copies to the host
inside a prove's ``fri`` phase."""

import pytest

from portbench import harness as H

MIMC = {"steps": 1 << 20, "expansion_factor": 4, "num_colinearity_checks": 64,
        "transition_constraints_degree": 3}
PART_READERS = {"mimc.fri_rounds_ms": "fri.rounds", "mimc.fri_leave_ms": "fri.leave",
                "mimc.fri_host_fold_ms": "fri.host_fold",
                "mimc.fri_host_commit_ms": "fri.host_commit",
                "mimc.fri_queries_ms": "fri.queries", "mimc.trace_chain_ms": "trace_gen.chain"}


def window(proves, spans, **kw):
    spans = [("bench.prove", a, b) for a, b in proves] + spans
    return H.Window(0.0, 10.0, MIMC, {}, spans=spans, requests={"prove": list(proves)}, **kw)


@pytest.mark.parametrize("metric,part", sorted(PART_READERS.items()))
def test_a_part_sums_its_spans_in_each_prove_and_takes_the_median(metric, part):
    name = "phase." + part
    win = window(
        [(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)],
        [(name, 0.1, 0.2), (name, 0.3, 0.35), (name, 0.5, 0.55),   # 0.2 in the first
         (name, 1.1, 1.2),                                          # 0.1 in the second
         (name, 2.1, 2.4), (name, 2.5, 2.6),                        # 0.4 in the third
         (name, 5.0, 9.0),                                          # in no prove
         ("phase.other", 1.3, 1.9)])
    assert H.metric_reader(metric)(win) == pytest.approx(200.0)


def test_a_prove_without_the_part_counts_zero_and_a_window_without_it_reads_none():
    read = H.metric_reader("mimc.fri_host_fold_ms")
    proves = [(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)]
    win = window(proves, [("phase.fri.host_fold", 0.1, 0.4), ("phase.fri.host_fold", 1.1, 1.3)])
    assert read(win) == pytest.approx(200.0)               # 300, 200 and 0 ms
    assert read(window(proves, [("phase.fri", 0.1, 0.4), ("phase.fri.host_fold", 5.0, 6.0)])) is None
    assert read(window([], [("phase.fri.host_fold", 0.1, 0.4)])) is None


def test_copies_out_counts_copies_to_the_host_that_start_in_the_fri_phase():
    read = H.metric_reader("mimc.fri_copies_out")
    proves = [(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)]
    spans = [("phase.fri", 0.2, 0.8), ("phase.fri", 1.2, 1.8), ("phase.fri", 2.2, 2.8),
             ("phase.openings", 0.8, 0.9)]
    out = "Memcpy DtoH (Device -> Pageable)"
    ops = ([(out, 0.3, 0.31), (out, 0.4, 0.41), (out, 0.5, 0.51), (out, 0.85, 0.86),  # 3 in fri
            ("Memcpy HtoD (Pageable -> Device)", 0.6, 0.7), ("merkle_kernel", 0.7, 0.75),
            (out, 1.3, 1.31),                                                     # 1
            (out, 2.3, 2.31), (out, 2.4, 2.41), (out, 2.79, 2.9),                  # 3: a start counts
            (out, 5.0, 5.1)])
    win = window(proves, spans, traced=True, ops=ops)
    assert read(win) == 3
    assert read(window(proves, spans, ops=ops)) is None    # untraced
    assert read(window(proves, [("phase.openings", 0.1, 0.9)], traced=True, ops=ops)) is None
    assert read(window(proves, spans, traced=True, ops=[])) == 0
