"""The median milliseconds of one prove (prove_chain, wall time on the
host), over the window's proofs."""

from portbench import harness as H


def read(win):
    proves = win.requests.get("prove")
    return 1000.0 * H.median([b - a for a, b in proves]) if proves else None
