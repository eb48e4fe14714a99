"""The median milliseconds a prove spends in the ``fri.queries`` part of
its ``fri`` phase (protocols/fri.py): the query indices and every layer's
openings, the gathers from the card and the multiproofs."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "fri.queries")
