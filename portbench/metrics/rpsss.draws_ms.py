"""The median milliseconds a batch spends in its ``batch.draws`` part
(parallel/batch_prover.py), inside its first ``batch.statements`` span:
the calls to the entropy source alone, one a 17-byte draw, whose bytes are
kept as they come.  What ``rpsss.statements_ms`` holds beyond it is the
program's own work (the draws' conversion, the public keys, the boundary
tables).  A program that opens no such part reads None."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "batch.draws")
