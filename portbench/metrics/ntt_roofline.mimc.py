"""The trace's low-degree extension (``trace_lde``: the 2^22-point inverse
NTT and the 2^24-point coset LDE of ops/ntt.py, with their pointwise
scalings) against its least time, bytes alone: the chain's one register
of trace and randomizer rows in, its FRI-domain codeword out (the
window's proves)."""

from portbench import roofline
from portbench.reference.stark import Params


def read(win):
    if not win.traced:
        return None
    params = Params.of(win.config, 1, win.config["steps"] + 1)
    count, device_s = win.device_seconds({"phase.trace_lde"})
    least = roofline.trace_lde_seconds(1, params.randomized_trace_length, params.fri_length)
    return roofline.share(count * least, device_s)
