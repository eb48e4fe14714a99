"""The median milliseconds a prove spends in the ``fri.leave`` part of its
``fri`` phase (protocols/fri.py): the copy of the layer where the host
tail starts (2^15 elements in this cell) to the host, its decode into
Python ints, and its inverse-domain table's."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "fri.leave")
