"""One prover in a closed loop: it proves fresh MiMC chain statements with
``models/mimc.py:prove_chain`` back to back until the window has passed;
the proof under way then finishes.

Parameters (traffic file): ``warmup`` proofs before the window, ``judged``
proofs drawn from the window's for the reference, ``zerofier_points`` of
each judged proof's opened zerofier values that the reference
recomputes, ``torch_threads``.
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

    def setup(self, seed: int):
        t = time.perf_counter()
        from stark_anatomy_tpu_torch.field.scalar import Field
        from stark_anatomy_tpu_torch.models import mimc as MM

        parts = [("import", time.perf_counter() - t)]
        t = time.perf_counter()
        self.MM, self.field = MM, Field.main()
        p = self.params
        self.mimc, self.stark = MM.make_stark(p["steps"], p["expansion_factor"], p["num_colinearity_checks"],
                                              p["security_level"], device=self.device)
        self.timer = H.SpanTimer()
        self.stark.timer = self.timer
        self.tz = self.stark.preprocess()
        parts.append(("preprocess", time.perf_counter() - t))
        t = time.perf_counter()
        draw = H.seeded_bytes("warm-up", seed)
        for _ in range(self.traffic["warmup"]):
            MM.prove_chain(self.mimc, self.stark, self.field.sample(draw(17)), self.tz, urandom=draw)
        parts.append(("warm-up", time.perf_counter() - t))
        return parts

    def window(self, seed: int, seconds: float, trace: bool) -> H.Window:
        statements = H.seeded_bytes("statements", seed)
        entropy = H.seeded_bytes("prover", seed)
        self.proofs, self.failed = [], 0
        timer = self.timer
        timer.spans.clear()
        timer.recording, timer.tracing = True, trace
        with H.DeviceTrace(trace) as dt:
            t0 = time.perf_counter()
            t1 = t0 + seconds
            while time.perf_counter() < t1:
                x = self.field.sample(statements(17))
                try:
                    with timer.span("bench.prove"):
                        out, proof, _ = self.MM.prove_chain(self.mimc, self.stark, x, self.tz, urandom=entropy)
                except Exception as exc:          # a failed proof: counted, the loop goes on
                    self.failed += 1
                    H.log(f"a proof failed: {exc!r}")
                    continue
                self.proofs.append((x.value, out.value, proof))
        timer.recording = timer.tracing = False
        self.zerofier_root = self.tz.root
        win = H.Window(t0, t1, self.params, self.traffic, traced=trace, spans=list(timer.spans),
                       ops=dt.ops, busy=[(a, b) for _, a, b in dt.ops])
        win.requests = {"prove": [(a, b) for n, a, b in win.spans if n == "bench.prove"]}
        win.counts = {"attempted": len(self.proofs) + self.failed, "proofs": len(self.proofs)}
        return win

    def memory_peak(self) -> int:
        import torch

        return torch.cuda.max_memory_reserved()

    def close(self) -> None:
        import torch

        del self.mimc, self.stark, self.tz
        torch.cuda.empty_cache()

    def judge(self, win: H.Window, seed: int) -> Dict[str, Tuple[int, int]]:
        """The reference's verdict on ``judged`` proofs drawn from the
        window's: each chain's output, each proof for the true output with
        ``zerofier_points`` of its opened zerofier values recomputed, and
        the zerofier root that every judged proof's openings imply against
        the one the prover committed to."""
        from ..reference.mimc import judge_proof

        picked = sorted(random.Random(seed).sample(range(len(self.proofs)),
                                                   min(self.traffic["judged"], len(self.proofs))))
        verdicts = H.judge_apart(judge_proof, [(self.cell.config, self.traffic["zerofier_points"],
                                                f"{seed}/{i}", *self.proofs[i]) for i in picked])
        roots = {self.zerofier_root}
        for i, (_, reason, root) in zip(picked, verdicts):
            if reason is not None:
                H.log(f"reference rejects proof {i} of the window: {reason}")
            else:
                roots.add(root)
        return {"failed": (self.failed, 0),
                "proofs_rejected": (sum(reason is not None for _, reason, _ in verdicts), 0),
                "outputs_wrong": (sum(wrong for wrong, _, _ in verdicts), 0),
                "zerofier_roots_differ": (len(roots) - 1, 0)}

    def attempted(self, win: H.Window) -> Tuple[int, int]:
        return win.counts["attempted"], self.failed
