"""The median count, over the window's signs, of the device operations
that start inside a ``bench.sign`` span and are neither a copy
(``Memcpy ...``) nor a fill (``Memset ...``): the kernels one sign
launches (parallel/batch_prover.py at B = 1), the hand-written ones and
PyTorch's own alike.  None untraced."""

from bisect import bisect_left, bisect_right

from portbench import harness as H

NOT_LAUNCHES = ("Memcpy", "Memset")


def read(win):
    if not win.traced:
        return None
    signs = [(a, b) for n, a, b in win.spans if n == "bench.sign"]
    if not signs:
        return None
    starts = sorted(a for name, a, _ in win.ops if not name.startswith(NOT_LAUNCHES))
    return H.median([bisect_right(starts, hi) - bisect_left(starts, lo) for lo, hi in signs])
