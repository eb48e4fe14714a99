"""The median milliseconds of a prove's ``fri`` phase (protocols/fri.py:
H6 and H4 rounds on the card, the host tail), over the window's
proofs."""

from portbench import harness as H


def read(win):
    return H.phase_ms(win, "fri")
