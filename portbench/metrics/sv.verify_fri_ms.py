"""The median milliseconds a round trip spends in the verifier's part
``verify.fri``: protocols/fri.py:Fri.verify, the last layer's tree and
degree check by a host NTT, and every round's colinearity tests and
multiproof.  None where the program opens no such part."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "verify.fri")
