"""The median milliseconds of a batch's ``pipeline`` phase
(parallel/batch_prover.py): the device phase (parallel/batch.py:pipeline: the Rescue trace, the LDEs, H10's quotients) and the copies of its codewords to the host, over the window's batches."""

from portbench import harness as H


def read(win):
    return H.phase_ms(win, "pipeline")
