"""The median milliseconds a batch spends in its ``batch.statements`` part
(parallel/batch_prover.py), before ``pipeline``: the randomness draws and
their conversion to the card, each signature's public key (the host's
Rescue-Prime hash) and boundary tables."""

from portbench import parts


def read(win):
    return parts.part_ms(win, "batch.statements")
