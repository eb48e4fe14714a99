"""H10 (csrc/air.cu, ``quotients_kernel``: the boundary and Rescue
transition quotients of a batch, one launch a batch) against its least
time, bytes alone: per proof the trace and the boundary interpolants
read, the boundary and transition quotients written, and the shared
inverse boundary zerofiers (every statement constrains the same cycles),
round-constant codewords and inverse transition zerofier read once, each
FRI-domain codeword at 16 bytes an element (the window's launches)."""

from portbench import roofline
from portbench.reference.stark import Params

KERNEL = "quotients_kernel"


def least_seconds(batch: int, registers: int, fri_length: int) -> float:
    """One launch over ``batch`` proofs: 2R codewords read and 2R written a
    proof (the Rescue AIR has a constraint a register; the next cycle is
    the trace read again), 3R + 1 shared ones read."""
    codewords = (4 * registers) * batch + 3 * registers + 1
    return roofline.least_seconds(codewords * fri_length * roofline.ELEMENT_BYTES)


def read(win):
    if not win.traced:
        return None
    launches = [(a, b) for name, a, b in win.ops if KERNEL in name]
    params = Params.of(win.config, win.config["state_width"], win.config["num_cycles"])
    least = least_seconds(win.traffic["batch"], win.config["state_width"], params.fri_length)
    return roofline.share(len(launches) * least, sum(b - a for a, b in launches))
