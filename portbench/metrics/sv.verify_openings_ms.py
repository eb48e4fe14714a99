"""The median milliseconds a round trip spends in the verifier's part
``verify.openings``: the R + 2 opened sections (boundary quotients, the
randomizer, the transition zerofier), each with its leaves hashed and
checked by commit/merkle.py:verify_multi.  A forgery rejected in FRI
opens none: its round trip counts 0.  None where the program opens no
such part."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "verify.openings")
