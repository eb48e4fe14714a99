"""The median milliseconds of one batch (``sign_batch``: 64 signatures
through parallel/batch_prover.py:BatchProver.prove_batch, wall time on
the host), over the window's batches."""

from portbench import harness as H


def read(win):
    batches = win.requests.get("prove")
    return 1000.0 * H.median([b - a for a, b in batches]) if batches else None
