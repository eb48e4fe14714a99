"""The median milliseconds a batch spends in the ``fri.rounds`` part of its
``fri`` phase (parallel/batch_prover.py:_fri_batch): every round's copy of
the batch's layer to the host, its B paired-leaf trees (N1), the B
challenges and the batch's fold (H7)."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "fri.rounds")
