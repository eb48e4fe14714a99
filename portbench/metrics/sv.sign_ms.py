"""The median milliseconds of one sign (``bench.sign``: models/rpsss.py:
FastRPSSS.sign, the batch prover at B = 1, wall time on the host), over
the window's round trips."""

from portbench import harness as H


def read(win):
    signs = win.durations("bench.sign")
    return 1000.0 * H.median(signs) if signs else None
