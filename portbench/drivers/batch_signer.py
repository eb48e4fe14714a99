"""One bulk signer in a closed loop: it signs batches of fresh documents
under many keys with ``parallel/batch_prover.py:make_batch_rpsss`` (one
``sign_batch`` call a batch, document i under key i) back to back until
the window has passed; the batch under way then finishes.

Parameters (traffic file): ``batch`` documents a batch, ``keys`` (one
document a key a batch, so as many as ``batch``), ``document_bytes``,
``warmup`` batches before the window, ``judged`` signatures drawn from
the window's for the reference, ``torch_threads``.  A batch is one
``prove`` request; ``counts["proofs"]`` counts signatures, each one STARK
proof.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Tuple

from .. import harness as H


class Driver:
    def __init__(self, cell: H.Cell, program=None, device=None):
        self.cell = cell
        self.traffic = cell.traffic
        self.params = dict(cell.config, **(program or {}))   # what the program runs
        self.device = device
        assert self.traffic["keys"] == self.traffic["batch"], "one document a key a batch"

    def _urandom(self, n: int) -> bytes:
        return self.entropy(n)

    def setup(self, seed: int):
        t = time.perf_counter()
        from stark_anatomy_tpu_torch.config import StarkConfig
        from stark_anatomy_tpu_torch.parallel.batch_prover import make_batch_rpsss

        parts = [("import", time.perf_counter() - t)]
        t = time.perf_counter()
        p = self.params
        config = StarkConfig(expansion_factor=p["expansion_factor"],
                             num_colinearity_checks=p["num_colinearity_checks"],
                             security_level=p["security_level"], num_registers=p["state_width"],
                             num_cycles=p["num_cycles"],
                             transition_constraints_degree=p["transition_constraints_degree"])
        self.entropy = H.seeded_bytes("keys", seed)
        self.prover, keygen, self.sign_batch = make_batch_rpsss(self.device, self._urandom, config)
        self.timer = H.SpanTimer()
        self.prover.stark.timer = self.timer
        keys = [keygen() for _ in range(self.traffic["keys"])]
        self.sks = [sk for sk, _ in keys]
        self.keys = [(sk.value, pk.value) for sk, pk in keys]
        parts.append(("preprocess and keys", time.perf_counter() - t))
        t = time.perf_counter()
        self.entropy = H.seeded_bytes("warm-up", seed)
        documents = H.seeded_bytes("warm-up documents", seed)
        for _ in range(self.traffic["warmup"]):
            self.sign_batch(self.sks, self._documents(documents))
        parts.append(("warm-up", time.perf_counter() - t))
        return parts

    def _documents(self, draw):
        return [draw(self.traffic["document_bytes"]) for _ in range(self.traffic["batch"])]

    def window(self, seed: int, seconds: float, trace: bool) -> H.Window:
        documents = H.seeded_bytes("documents", seed)
        self.entropy = H.seeded_bytes("prover", seed)
        self.batches, self.failed = [], 0
        timer = self.timer
        timer.spans.clear()
        timer.recording, timer.tracing = True, trace
        with H.DeviceTrace(trace) as dt:
            t0 = time.perf_counter()
            t1 = t0 + seconds
            while time.perf_counter() < t1:
                docs = self._documents(documents)
                try:
                    with timer.span("bench.prove"):
                        signatures = self.sign_batch(self.sks, docs)
                except Exception as exc:          # a failed batch: counted, the loop goes on
                    self.failed += len(docs)
                    H.log(f"a batch failed: {exc!r}")
                    continue
                self.batches.append((docs, signatures))
        timer.recording = timer.tracing = False
        self.zerofier_root = self.prover.tz.root
        signed = sum(len(s) for _, s in self.batches)
        win = H.Window(t0, t1, self.params, self.traffic, traced=trace, spans=list(timer.spans),
                       ops=dt.ops, busy=[(a, b) for _, a, b in dt.ops])
        win.requests = {"prove": [(a, b) for n, a, b in win.spans if n == "bench.prove"]}
        win.counts = {"attempted": signed + self.failed, "proofs": signed}
        return win

    def memory_peak(self) -> int:
        import torch

        return torch.cuda.max_memory_reserved()

    def close(self) -> None:
        import torch

        for name in ("prover", "sign_batch", "sks"):
            self.__dict__.pop(name, None)
        torch.cuda.empty_cache()

    def judge(self, win: H.Window, seed: int) -> Dict[str, Tuple[int, int]]:
        """The reference's verdict on ``judged`` signatures drawn from the
        window's: each key pair (pk = hash(sk)), each signature under the
        true public key of its key and its own document, every opened
        transition zerofier value recomputed, and the zerofier root of the
        reference's whole codeword against the one the prover committed
        to and the one every judged signature's openings imply."""
        from ..reference.rescue_prime import judge_signature, zerofier_root

        flat = [(b, i) for b, (_, sigs) in enumerate(self.batches) for i in range(len(sigs))]
        picked = sorted(random.Random(seed).sample(flat, min(self.traffic["judged"], len(flat))))
        items = []
        for b, i in picked:
            sk, pk = self.keys[i]
            docs, sigs = self.batches[b]
            items.append((self.cell.config, f"batch {b} signature {i}", sk, pk, docs[i], sigs[i]))
        verdicts = H.judge_apart(judge_signature, items)
        roots = {zerofier_root(self.cell.config), self.zerofier_root}
        for _, reason, root in verdicts:
            if reason is not None:
                H.log(f"reference rejects {reason}")
            else:
                roots.add(root)
        return {"failed": (self.failed, 0),
                "signatures_rejected": (sum(reason is not None for _, reason, _ in verdicts), 0),
                "keys_wrong": (sum(wrong for wrong, _, _ in verdicts), 0),
                "zerofier_roots_differ": (len(roots) - 1, 0)}

    def attempted(self, win: H.Window) -> Tuple[int, int]:
        return win.counts["attempted"], self.failed
