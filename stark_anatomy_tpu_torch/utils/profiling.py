"""Phase timing of the prover, and device traces.

The port of stark_anatomy_tpu/utils/profiling.py.  ``PhaseTimer`` adds
host wall-clock seconds per named phase; the prover's phases use the JAX
package's names (protocols/fast_stark.py:prove, parallel/batch_prover.py:
prove_batch), so the two packages' reports compare phase by phase.  It
adds no device synchronisation of its own: a phase of ``prove_batch`` ends
in a copy to the host or in host work, which waits for the card, and a
phase of ``FastStark.prove`` that ends in launches calls ``device_sync``,
as the JAX package's prover does.  ``device_trace`` records a
torch.profiler trace of the card.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    """Accumulates wall-clock time per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<28s} {total*1000:10.2f} ms  x{self.counts[name]}")
        return "\n".join(lines)


def device_sync(device) -> None:
    """Wait for the card at a phase boundary, so that the phase's seconds
    hold its own device work; nothing to wait for on the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace of the host and the card into
    ``log_dir`` (a Chrome trace, one file per run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
