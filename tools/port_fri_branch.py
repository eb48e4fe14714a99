#!/usr/bin/env python3
"""Time the batch prover's FRI phase two ways on one CUDA card, in turns.

    python3 tools/port_fri_branch.py [--batches 1,2,4,8] [--pairs 10]

At FastRPSSS's production parameters (FRI domain N = 4096, four rounds)
and for each batch size B, the same seeded combination codewords (B, 8,
N) on the card go through:

* ``card``: ``BatchProver._fri_batch``, one fri_fold_batched (H7) launch a
  round and one host tree (N1) per proof and round;
* ``host``: one copy of the codewords to the host, then
  ``Fri.prove_host`` per proof, which folds Python ints and builds its
  trees from per-element byte strings (the JAX package's branch for
  B*N <= 2^14).

Each call starts from fresh transcripts and is timed on the host clock up
to a ``torch.cuda.synchronize()``; both give the same transcript bytes,
which the script checks.  It prints, per B, the median and quartiles of
the seconds of each side and the pairs the card won, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", default="1,2,4,8")
    parser.add_argument("--pairs", type=int, default=10)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_fri_branch: CUDA is not available", file=sys.stderr)
        return 1
    from stark_anatomy_tpu_torch.parallel.batch_prover import make_batch_rpsss
    from stark_anatomy_tpu_torch.transcript.proof_stream import SignatureProofStream
    from stark_anatomy_tpu_torch.utils.convert import canonical_np, int_from_row

    prover, _, _ = make_batch_rpsss()
    fri = prover.stark.fri
    N = prover.stark.fri_domain_length
    dev = prover.stark.device

    def streams(B):
        return [SignatureProofStream(b"port fri branch %d" % i) for i in range(B)]

    def card(combos):
        ps = streams(combos.shape[0])
        prover._fri_batch(combos, ps)
        return ps

    def host(combos):
        ps = streams(combos.shape[0])
        combo_np = canonical_np(combos)
        for i in range(combos.shape[0]):
            fri.prove_host([int_from_row(combo_np[i][j]) for j in range(N)], ps[i])
        return ps

    def timed(fn, combos) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(combos)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=10).stdout.strip()
    out = {"device": smi, "N": N, "rounds": fri.num_rounds(), "batches": {}}
    sides = {"card": card, "host": host}
    for B in (int(b) for b in args.batches.split(",")):
        gen = torch.Generator(device=dev).manual_seed(B)
        combos = torch.randint(0, 1 << 16, (B, 8, N), generator=gen, device=dev, dtype=torch.int32)
        combos[:, 7, :] &= 0x3FFF
        got = {name: [p.serialize() for p in fn(combos)] for name, fn in sides.items()}
        assert got["card"] == got["host"], f"the two FRI branches wrote different transcripts at B = {B}"
        seconds = {"card": [], "host": []}
        wins = 0
        for i in range(args.pairs):
            order = ("card", "host") if i % 2 == 0 else ("host", "card")
            pair = {name: timed(sides[name], combos) for name in order}
            for name, s in pair.items():
                seconds[name].append(s)
            wins += pair["card"] < pair["host"]
        row = {}
        for name, xs in seconds.items():
            q = statistics.quantiles(xs, n=4)
            row[name] = {"median_s": statistics.median(xs), "q1_s": q[0], "q3_s": q[2]}
        row["card_won"] = f"{wins}/{args.pairs}"
        out["batches"][B] = row
        print(f"B = {B}: card {row['card']['median_s']:.5f} s, host {row['host']['median_s']:.5f} s "
              f"(medians of {args.pairs}), card won {wins}/{args.pairs}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
