"""The share of the window in which the card ran no operation, in %."""

from portbench import harness as H


def read(win):
    return H.idle_percent(win)
