"""The median milliseconds of a batch's ``commit`` phase
(parallel/batch_prover.py): the host's paired-leaf trees of each proof's codewords (N1) and the Fiat-Shamir weights, over the window's batches."""

from portbench import harness as H


def read(win):
    return H.phase_ms(win, "commit")
