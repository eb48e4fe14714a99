#!/usr/bin/env python3
"""Time two trees of the port in one process, sign and verify in turns.

    python3 tools/port_interleave.py --parent DIR [--root DIR] [--pairs 40]

Imports ``stark_anatomy_tpu_torch`` from --root (default: this checkout)
and the one under --parent under the name ``parent_port``, builds both,
and makes a ``FastRPSSS()`` of each on one CUDA card.  Then, for sign and
for verify, it runs --pairs pairs of calls, the first of each pair
alternating between the trees, each call timed on the host clock up to a
``torch.cuda.synchronize()``.  It prints one JSON line: per operation and
tree the median and quartiles of the seconds, and the pairs the root tree
won.  Host time per call drifts by up to 2x between processes and within
one (PERF.md §2); calls in turns in one process see the same drift.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time


def load_as(name: str, root: str):
    """Import the package ``stark_anatomy_tpu_torch`` under ``root`` as
    ``name`` (its imports are relative, so it stays apart from the other)."""
    pkg = os.path.join(root, "stark_anatomy_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--pairs", type=int, default=40)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_interleave: CUDA is not available", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    roots = {"change": os.path.abspath(args.root), "parent": os.path.abspath(args.parent)}
    schemes, keys = {}, {}
    for side, name in (("change", "change_port"), ("parent", "parent_port")):
        load_as(name, roots[side])
        rpsss = importlib.import_module(f"{name}.models.rpsss")
        scheme = rpsss.FastRPSSS()
        sk, pk = scheme.keygen()
        sig = scheme.sign(sk, b"port interleave")
        assert scheme.verify(pk, b"port interleave", sig)
        schemes[side], keys[side] = scheme, (sk, pk, sig)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    out = {}
    for op in ("sign", "verify"):
        seconds = {"parent": [], "change": []}
        wins = 0
        for i in range(args.pairs):
            for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                scheme, (sk, pk, sig) = schemes[side], keys[side]
                if op == "sign":
                    seconds[side].append(timed(lambda: scheme.sign(sk, b"port interleave")))
                else:
                    seconds[side].append(timed(lambda: scheme.verify(pk, b"port interleave", sig)))
            wins += seconds["change"][-1] < seconds["parent"][-1]
        out[op] = {side: {"median": statistics.median(s), "quartiles": statistics.quantiles(s, n=4)}
                   for side, s in seconds.items()}
        out[op]["change_won"] = f"{wins} of {args.pairs}"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "roots": roots, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
