"""``rpsss.draws_ms``, the part ``batch.draws`` of the bulk signer's cell:
the calls to the entropy source, inside a batch's first
``batch.statements`` span.  Its reader on synthetic windows, and the cell
that reports it."""

import pytest

from portbench import harness as H
from portbench.tests.test_portbench_rpsss import CELL, window


def test_the_cell_reports_the_draws_beside_its_statements():
    names = [m["name"] for m in H.load_cell(CELL).per_layer]
    assert "rpsss.draws_ms" in names and "rpsss.statements_ms" in names


def test_the_draws_are_the_median_of_each_batch_s_part_inside_its_statements():
    batches = [(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)]
    spans = []
    for (a, _), draws in zip(batches, (0.2, 0.4, 0.3)):
        spans += [("phase.batch.statements", a, a + draws + 0.01),
                  ("phase.batch.draws", a, a + draws),
                  ("phase.batch.statements", a + 0.5, a + 0.52)]
    win = window(batches, spans)
    assert H.metric_reader("rpsss.draws_ms")(win) == pytest.approx(300.0)
    assert H.metric_reader("rpsss.statements_ms")(win) == pytest.approx(330.0)


def test_a_program_without_the_part_reads_none():
    win = window([(0.0, 1.0)], [("phase.batch.statements", 0.0, 0.5)])
    assert H.metric_reader("rpsss.draws_ms")(win) is None
