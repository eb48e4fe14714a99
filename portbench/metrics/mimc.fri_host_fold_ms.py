"""The median milliseconds a prove spends in the ``fri.host_fold`` part of
its ``fri`` phase (protocols/fri.py), summed over the host tail's rounds:
each fold of Python ints and the squaring of its inverse-domain table."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "fri.host_fold")
