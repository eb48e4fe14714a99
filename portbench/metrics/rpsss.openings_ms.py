"""The median milliseconds of a batch's ``openings`` phase
(parallel/batch_prover.py): each proof's openings at its query indices and its transcript's bytes, over the window's batches."""

from portbench import harness as H


def read(win):
    return H.phase_ms(win, "openings")
