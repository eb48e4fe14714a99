"""The median milliseconds a prove spends in the ``trace_gen.chain`` part
of its ``trace_gen`` phase (models/mimc.py): the 2^20-step chain by N2 on
the host, before its copy to the card."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "trace_gen.chain")
