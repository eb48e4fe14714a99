"""What a prove spends in the port's named parts of a phase.

The port opens a part of a phase as ``timer.phase("<phase>.<part>")``
(its utils/profiling.py), and ``harness.SpanTimer`` keeps that as the span
``phase.<phase>.<part>``, marked in the device trace like any phase.  A
prove may hold several spans of one part (FRI's host tail opens two a
round): a part's time in a prove is the sum of its spans inside that
prove's ``bench.prove`` request, and the reading is the median of those
sums over the window's proves.  A program that opens no such span reads
None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench import harness as H


def _per_prove(win: H.Window, intervals) -> List[List[Tuple[float, float]]]:
    """The intervals that lie inside each prove of the window, a list a
    prove."""
    return [[(a, b) for a, b in intervals if lo <= a and b <= hi]
            for lo, hi in win.requests.get("prove", [])]


def part_ms(win: H.Window, part: str) -> Optional[float]:
    """The median milliseconds a prove spends in ``part``
    (``"<phase>.<part>"``), summed over its spans; None where no prove
    holds such a span."""
    inside = _per_prove(win, [(a, b) for n, a, b in win.spans if n == "phase." + part])
    if not any(inside):
        return None
    return 1000.0 * H.median([sum(b - a for a, b in spans) for spans in inside])


def ops_per_prove(win: H.Window, phase: str, prefix: str) -> Optional[float]:
    """The median count, over the window's proves, of the device
    operations whose name starts with ``prefix`` and that start inside the
    prove's spans of ``phase``; None untraced or where no prove holds such
    a span."""
    if not win.traced:
        return None
    inside = _per_prove(win, [(a, b) for n, a, b in win.spans if n == "phase." + phase])
    if not any(inside):
        return None
    starts = [a for n, a, _ in win.ops if n.startswith(prefix)]
    return H.median([sum(lo <= t <= hi for t in starts for lo, hi in spans) for spans in inside])
