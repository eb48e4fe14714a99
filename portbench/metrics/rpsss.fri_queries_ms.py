"""The median milliseconds a batch spends in the ``fri.queries`` part of
its ``fri`` phase (parallel/batch_prover.py:_fri_batch): each proof's last
layer in the clear, its index draw and every layer's openings and
multiproof."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "fri.queries")
