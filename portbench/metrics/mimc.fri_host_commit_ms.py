"""The median milliseconds a prove spends in the ``fri.host_commit`` part
of its ``fri`` phase, summed over the host tail's rounds: each layer's
leaf encoding and its Merkle tree by N1 (commit/, csrc/blake2s_host.cpp),
the root sent and the next draw."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "fri.host_commit")
