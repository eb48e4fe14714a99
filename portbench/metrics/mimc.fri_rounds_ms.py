"""The median milliseconds a prove spends in the ``fri.rounds`` part of
its ``fri`` phase (protocols/fri.py): the first layer's commit and every
round on the card, each an H6 fold, an H4 tree, the root's copy to the
host and the Fiat-Shamir draw."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "fri.rounds")
