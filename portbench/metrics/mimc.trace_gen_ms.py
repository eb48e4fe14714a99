"""The median milliseconds of a prove's ``trace_gen`` phase: the N2 chain
on the host and its copy to the card (models/mimc.py), over the
window's proofs."""

from portbench import harness as H


def read(win):
    return H.phase_ms(win, "trace_gen")
