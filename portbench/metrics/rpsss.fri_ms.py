"""The median milliseconds of a batch's ``fri`` phase
(parallel/batch_prover.py): the batched FRI (its parts ``fri.rounds`` and ``fri.queries``), over the window's batches."""

from portbench import harness as H


def read(win):
    return H.phase_ms(win, "fri")
