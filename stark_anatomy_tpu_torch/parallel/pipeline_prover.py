"""Pipelined proof stream: the host trace generation of statement k+1
overlaps the device proof of statement k.  The port of
stark_anatomy_tpu/parallel/pipeline_prover.py.

For a sequential workload (MiMC chains, a VDF shape) trace generation is
serial host work (N2, csrc/mimc_chain.cpp) while the rest of the prover
is device work.  So a stream of independent statements pipelines: while
the card runs the phases of proof k, one worker thread computes the trace
of proof k+1.  ctypes releases the interpreter lock during the C++ call,
so the overlap is real.  The worker touches no device: the copy to the
card and the unpack run on the main thread, in the order of the proof's
own launches (in the JAX package a worker's upload contended with the
prover's dispatches and made the pipeline slower than serial).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Tuple

from ..field.scalar import FieldElement
from ..models.mimc import prove_columns
from ..protocols.fast_stark import FastStark, TransitionZerofier
from ..utils.profiling import device_sync


def _deprioritize_worker() -> None:
    """Lower the worker thread's scheduling priority (Linux: per-thread
    nice by its native id), so that the main thread's proof loop gets a
    core first; the prefetch only has to finish within the proof in
    flight."""
    try:
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
    except (AttributeError, OSError):
        pass  # not Linux, or not allowed: the overlap still works


class PipelinedMiMCProver:
    """Streams proofs of MiMC-chain statements, the trace of statement k+1
    generated while statement k is proved."""

    def __init__(self, mimc, stark: FastStark, tz: TransitionZerofier):
        self.mimc = mimc
        self.stark = stark
        self.tz = tz
        # one worker: trace generation is serial per statement, and one
        # statement of prefetch hides it behind the proof in flight
        self._pool = ThreadPoolExecutor(max_workers=1, initializer=_deprioritize_worker)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def _gen(self, input_element: FieldElement):
        """Worker thread: packed host words and the output, no device touch."""
        words, out = self.mimc.trace_words_with_output(input_element.value)
        return words, FieldElement(out, self.mimc.field)

    def prove_stream(
        self,
        inputs: Iterable[FieldElement],
        urandom=os.urandom,
    ) -> Iterator[Tuple[FieldElement, bytes]]:
        """Yields (output_element, proof) per input, pipelined."""
        inputs = list(inputs)
        if not inputs:
            return
        fut = self._pool.submit(self._gen, inputs[0])
        for k in range(len(inputs)):
            words, output_element = fut.result()
            if k + 1 < len(inputs):
                fut = self._pool.submit(self._gen, inputs[k + 1])
            # the upload and unpack: the trace_gen phase's device part
            with self.stark.timer.phase("trace_gen"):
                cols = self.mimc.columns_from_words(words)
                device_sync(cols.device)
            yield output_element, prove_columns(
                self.mimc, self.stark, inputs[k], output_element, cols, self.tz, urandom)

    def prove_many(
        self, inputs: List[FieldElement], urandom=os.urandom
    ) -> List[Tuple[FieldElement, bytes]]:
        return list(self.prove_stream(inputs, urandom=urandom))
