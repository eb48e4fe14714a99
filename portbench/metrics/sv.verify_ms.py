"""The median milliseconds of one verify of a genuine signature
(``bench.verify``: models/rpsss.py:FastRPSSS.verify over protocols/
fast_stark.py:FastStark.verify, wall time on the host), over the window's
round trips; the forged verifies (``bench.verify_forged``) are left out."""

from portbench import harness as H


def read(win):
    verifies = win.durations("bench.verify")
    return 1000.0 * H.median(verifies) if verifies else None
