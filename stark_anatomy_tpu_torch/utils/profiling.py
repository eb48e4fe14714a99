"""Phase timing of the prover.

The port of stark_anatomy_tpu/utils/profiling.py.  ``PhaseTimer`` adds
host wall-clock seconds per named phase; the prover's phases use the JAX
package's names (protocols/fast_stark.py:prove, parallel/batch_prover.py:
prove_batch), so the two packages' reports compare phase by phase.  A name
``"<phase>.<part>"`` is a part of ``<phase>``, opened inside it through the
same ``phase`` call: the parts of ``fri`` (protocols/fri.py:Fri.prove) and
of ``trace_gen`` (models/mimc.py:prove_chain) say where a phase's host
time goes, and are kept apart from the phases' own table.  The verifier
has one phase, ``verify`` (protocols/fast_stark.py:FastStark.verify), with
the parts ``decode``, ``fri``, ``openings`` and ``core``; the JAX package
times no verify.  It adds no
device synchronisation of its own: a phase of ``prove_batch`` ends in a
copy to the host or in host work, which waits for the card, and a phase of
``FastStark.prove`` that ends in launches calls ``device_sync``, as the
JAX package's prover does.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    """Accumulates wall-clock time per named phase (``totals``, ``counts``)
    and per part of a phase (``parts``, ``part_counts``): a name with a
    dot, ``"<phase>.<part>"``, is a part."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.parts: Dict[str, float] = defaultdict(float)
        self.part_counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        totals, counts = (self.parts, self.part_counts) if "." in name else (self.totals, self.counts)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            totals[name] += time.perf_counter() - t0
            counts[name] += 1

    def report(self) -> str:
        """One line a phase, longest first, and under it one indented line
        a part of that phase with its share of the phase."""
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<28s} {total*1000:10.2f} ms  x{self.counts[name]}")
            for part, seconds in sorted(self.parts.items(), key=lambda kv: -kv[1]):
                if part.partition(".")[0] == name:
                    share = 100 * seconds / total if total else 0.0
                    lines.append(f"  {part:<26s} {seconds*1000:10.2f} ms  x{self.part_counts[part]}"
                                 f"  {share:5.1f}% of {name}")
        return "\n".join(lines)


def device_sync(device) -> None:
    """Wait for the card at a phase boundary, so that the phase's seconds
    hold its own device work; nothing to wait for on the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
