"""One client in a closed loop: it signs a fresh document with
``models/rpsss.py:FastRPSSS.sign`` (the batch prover at B = 1) and
verifies what it got back with ``FastRPSSS.verify``, back to back until
the window has passed; the round trip under way then finishes.  Every
``forged_every``-th round trip verifies a forgery of its signature in
place of the signature, so the verifier's rejection path runs too.

Parameters (traffic file): ``clients`` (1), ``keys`` made by ``keygen``
at set-up, round trip i signing under key i mod ``keys``;
``document_bytes``; ``forged_every``; ``forgeries``, the kinds of forgery
in turn: ``document`` (one byte of the document changed), ``key`` (the
next key's pk) and ``byte`` (one byte of the signature XORed with a
nonzero mask); ``warmup`` round trips before the window; ``judged``
signatures and ``judged_forged`` forged verifies drawn from the window's
for the reference; ``torch_threads``.  A round trip is one ``prove``
request (``bench.prove``) holding a ``bench.sign`` span and a
``bench.verify`` or ``bench.verify_forged`` span; ``counts["proofs"]``
counts round trips.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

from .. import harness as H


class Driver:
    def __init__(self, cell: H.Cell, program=None, device=None):
        self.cell = cell
        self.traffic = cell.traffic
        self.params = dict(cell.config, **(program or {}))   # what the program runs
        self.device = device
        assert self.traffic["clients"] == 1, "one client in a closed loop"
        assert set(self.traffic["forgeries"]) <= {"document", "key", "byte"}

    def setup(self, seed: int):
        t = time.perf_counter()
        from stark_anatomy_tpu_torch.config import StarkConfig
        from stark_anatomy_tpu_torch.models.rpsss import FastRPSSS

        parts = [("import", time.perf_counter() - t)]
        t = time.perf_counter()
        p = self.params
        config = StarkConfig(expansion_factor=p["expansion_factor"],
                             num_colinearity_checks=p["num_colinearity_checks"],
                             security_level=p["security_level"], num_registers=p["state_width"],
                             num_cycles=p["num_cycles"],
                             transition_constraints_degree=p["transition_constraints_degree"])
        self.scheme = FastRPSSS(self.device, config)
        self.timer = H.SpanTimer()
        self.scheme.stark.timer = self.timer
        draw = H.seeded_bytes("keys", seed)
        keys = [self.scheme.keygen(urandom=draw) for _ in range(self.traffic["keys"])]
        self.sks = [sk for sk, _ in keys]
        self.pks = [pk for _, pk in keys]
        self.keys = [(sk.value, pk.value) for sk, pk in keys]
        parts.append(("preprocess and keys", time.perf_counter() - t))
        t = time.perf_counter()
        self._round_trips(seed, "warm-up", lambda begun: begun < self.traffic["warmup"])
        parts.append(("warm-up", time.perf_counter() - t))
        return parts

    def _forge(self, kind: str, k: int, document: bytes, signature: bytes, draw):
        """(key whose pk is claimed, document, signature) of a forgery of
        ``signature``, made under key ``k`` over ``document``."""
        if kind == "key":
            k = (k + 1) % len(self.pks)
            return k, document, signature
        data = document if kind == "document" else signature
        at = int.from_bytes(draw(4), "big") % len(data)
        mask = 1 + draw(1)[0] % 255
        changed = data[:at] + bytes([data[at] ^ mask]) + data[at + 1:]
        if kind == "document":
            return k, changed, signature
        return k, document, changed

    def _round_trips(self, seed: int, label: str, go_on) -> None:
        """Round trips until ``go_on(round trips begun)`` is false; each one
        kept in ``self.trips`` as (key, document, signature), each forged
        verify in ``self.forgeries`` as (round trip, key whose pk it
        claimed, document, signature, the port's verdict)."""
        documents = H.seeded_bytes(label, "documents", seed)
        entropy = H.seeded_bytes(label, "prover", seed)
        tweaks = H.seeded_bytes(label, "forgeries", seed)
        t = self.traffic
        scheme, timer = self.scheme, self.timer
        self.trips: List[tuple] = []
        self.forgeries: List[tuple] = []
        self.failed = self.genuine_rejected = self.forgeries_accepted = 0
        i = 0
        while go_on(i):
            k = i % t["keys"]
            document = documents(t["document_bytes"])
            forged = i % t["forged_every"] == t["forged_every"] - 1
            kind = t["forgeries"][(i // t["forged_every"]) % len(t["forgeries"])]
            i += 1
            try:
                with timer.span("bench.prove"):
                    with timer.span("bench.sign"):
                        signature = scheme.sign(self.sks[k], document, urandom=entropy)
                    if forged:
                        fk, fdoc, fsig = self._forge(kind, k, document, signature, tweaks)
                        with timer.span("bench.verify_forged"):
                            accepted = scheme.verify(self.pks[fk], fdoc, fsig)
                    else:
                        with timer.span("bench.verify"):
                            accepted = scheme.verify(self.pks[k], document, signature)
            except Exception as exc:              # a failed round trip: counted, the loop goes on
                self.failed += 1
                H.log(f"a round trip failed: {exc!r}")
                continue
            if forged:
                self.forgeries_accepted += bool(accepted)
                self.forgeries.append((len(self.trips), fk, fdoc, fsig, accepted))
            else:
                self.genuine_rejected += not accepted
            self.trips.append((k, document, signature))

    def window(self, seed: int, seconds: float, trace: bool) -> H.Window:
        timer = self.timer
        timer.spans.clear()
        timer.recording, timer.tracing = True, trace
        with H.DeviceTrace(trace) as dt:
            t0 = time.perf_counter()
            t1 = t0 + seconds
            self._round_trips(seed, "window", lambda begun: time.perf_counter() < t1)
        timer.recording = timer.tracing = False
        self.zerofier_root = self.scheme.transition_zerofier.root
        win = H.Window(t0, t1, self.params, self.traffic, traced=trace, spans=list(timer.spans),
                       ops=dt.ops, busy=[(a, b) for _, a, b in dt.ops])
        win.requests = {"prove": [(a, b) for n, a, b in win.spans if n == "bench.prove"]}
        win.counts = {"attempted": len(self.trips) + self.failed, "proofs": len(self.trips)}
        return win

    def memory_peak(self) -> int:
        import torch

        return torch.cuda.max_memory_reserved()

    def close(self) -> None:
        import torch

        for name in ("scheme", "sks", "pks"):
            self.__dict__.pop(name, None)
        torch.cuda.empty_cache()

    def judge(self, win: H.Window, seed: int) -> Dict[str, Tuple[int, int]]:
        """The port's own verdicts over the whole window (a genuine
        signature rejected, a forgery accepted), and the reference's on
        ``judged`` signatures and ``judged_forged`` forged verifies drawn
        from the window's: each key pair (pk = hash(sk)), each signature
        under the true public key of its key and its own document with
        every opened transition zerofier value recomputed, each forgery's
        verdict against the port's on the same pk, document and bytes (the
        reference accepting only where the forgery's openings imply the
        zerofier root of its whole codeword), and that root against the
        one the prover committed to and the one every judged signature's
        openings imply."""
        from ..reference.openings import judge_signature
        from ..reference.rescue_prime import zerofier_root

        rng = random.Random(seed)
        trips, forgeries = self.trips, self.forgeries
        picked = sorted(rng.sample(range(len(trips)), min(self.traffic["judged"], len(trips))))
        picked_forged = sorted(rng.sample(forgeries,
                                          min(self.traffic["judged_forged"], len(forgeries))))
        items = []
        for i in picked:
            k, document, signature = trips[i]
            sk, pk = self.keys[k]
            items.append((self.cell.config, f"round trip {i}", sk, pk, document, signature))
        for i, fk, document, signature, _ in picked_forged:
            sk, pk = self.keys[fk]
            items.append((self.cell.config, f"forgery in round trip {i}", sk, pk, document,
                          signature))
        verdicts = H.judge_apart(judge_signature, items)
        genuine, forged_verdicts = verdicts[:len(picked)], verdicts[len(picked):]
        true_root = zerofier_root(self.cell.config)
        roots = {true_root, self.zerofier_root}
        for _, reason, root in genuine:
            if reason is not None:
                H.log(f"reference rejects {reason}")
            else:
                roots.add(root)
        differ = 0
        for (i, *_, port_accepts), (_, reason, root) in zip(picked_forged, forged_verdicts):
            # the transcript holds no zerofier root: a forgery is accepted
            # where its openings imply the true one
            reference_accepts = reason is None and root == true_root
            if port_accepts != reference_accepts:
                differ += 1
                verdict = {True: "accepts", False: "rejects"}
                H.log(f"forgery in round trip {i}: the port {verdict[port_accepts]}, "
                      f"the reference {verdict[reference_accepts]}")
        return {"failed": (self.failed, 0),
                "genuine_rejected": (self.genuine_rejected, 0),
                "forgeries_accepted": (self.forgeries_accepted, 0),
                "signatures_rejected": (sum(reason is not None for _, reason, _ in genuine), 0),
                "keys_wrong": (sum(wrong for wrong, _, _ in genuine), 0),
                "verdicts_differ": (differ, 0),
                "zerofier_roots_differ": (len(roots) - 1, 0)}

    def attempted(self, win: H.Window) -> Tuple[int, int]:
        return win.counts["attempted"], self.failed
