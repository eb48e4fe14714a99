"""The yardstick of the roofline metrics: the card's published peaks and
the least bytes and operations of an operation, from its shapes alone.

A roofline share is the least time over the device time the phase took.
The least time is the larger of two bounds: the bytes the operation must
move (each input read once, each output written once, an element of the
field at its 16 bytes whatever the program's layout) at the memory's
rate, and the operations that no implementation can do without at the
rate at which the card issues 32-bit instructions.  Where no count of
operations is settled (the NTT), the bound is the bytes alone.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet at its 700 W limit: HBM3 at 3.35 TB/s;
# 132 SMs, each issuing one warp instruction a clock on each of its four
# schedulers (128 lanes a clock), at the 1.98 GHz boost clock.  That is
# the most 32-bit instructions of any kind the card can start a second;
# the 67 TFLOP/s of float32 counts an FMA as two.
HBM_BYTES_PER_S = 3.35e12
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9

ELEMENT_BYTES = 16          # p < 2^128
DIGEST_BYTES = 32
# one blake2s compression: 10 rounds of 8 G functions, each 2 three-input
# adds, 2 adds, 4 xors and 4 rotates, with none of them fused on Hopper
BLAKE2S_INSTRUCTIONS = 10 * 8 * 12


def least_seconds(nbytes: float, operations: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, operations / ISSUE_PER_S)


def trace_lde_seconds(registers: int, rows: int, fri_length: int) -> float:
    """The trace's low-degree extension: ``rows`` values of each register
    in, its ``fri_length`` evaluations out (bytes alone)."""
    return least_seconds(registers * (rows + fri_length) * ELEMENT_BYTES)


def merkle_commit_seconds(codeword_length: int) -> float:
    """A paired-leaf commitment of one codeword: every element read once,
    the root written, and a compression for each of the n/2 leaves (two
    elements, one 64-byte block) and each of the n/2 - 1 inner nodes."""
    compressions = codeword_length - 1
    return least_seconds(codeword_length * ELEMENT_BYTES + DIGEST_BYTES,
                         compressions * BLAKE2S_INSTRUCTIONS)


def share(least_s: float, device_s: float):
    """The roofline share in percent, or None where no device time was
    read (the phase did not run, or the trace saw none of its kernels)."""
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s
