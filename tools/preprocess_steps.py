#!/usr/bin/env python3
"""Run a tree's chip_smoke.py with the 2^20 MiMC path's preprocess split
into its steps, on one CUDA card.

    python3 tools/preprocess_steps.py [--root DIR]

chip_smoke.py phase 5 times ``stark.preprocess()`` of the 2^20-step MiMC
stark (FRI domain 2^24) once, after the phase's other checks.  This
imports DIR's chip_smoke.py and port (default: this checkout), wraps
``FastStark.preprocess`` and its steps, and runs chip_smoke's ``main``
as it is.  For every preprocess on a domain of 2^24 or more it prints
one line ``DIAG {json}``:

* ``total_s``: the preprocess's seconds, synced on both sides;
* ``steps``: the seconds of ``_x_lde``, ``prefix_zerofier_evals``,
  ``_commit_rows`` and ``batch_inv``, each synced before and after;
* ``gc_s``, ``gc_n``, ``gc_gens``: the time, count and generations of
  Python's garbage collections inside it (gc callbacks);
* ``gc_counts_after``, ``gc_tracked``: gc's counters and tracked objects;
* ``reserved_gib_before``/``after``, ``device_alloc``, ``device_free``,
  ``alloc_retries``: the caching allocator's reserved memory and its
  cudaMalloc/cudaFree calls and retries over the preprocess
  (``torch.cuda.memory_stats``).

The syncs and counters add to chip_smoke's own preprocess time; the
steps' split is what it is for.  The script ends with ``DIAG rc N``,
chip_smoke's exit code.  To compare trees, run it on each in one chip
call, in turns.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path.insert(0, root)

    import torch

    from stark_anatomy_tpu_torch.field import ops as F
    from stark_anatomy_tpu_torch.ops import ntt as NTT
    from stark_anatomy_tpu_torch.protocols import fast_stark as FS

    state = {"on": False, "gc_s": 0.0, "gc_n": 0, "gc_gens": [], "steps": {}}
    gc_start = {}

    def on_gc(phase, info):
        if not state["on"]:
            return
        if phase == "start":
            gc_start["t"] = time.perf_counter()
        else:
            state["gc_s"] += time.perf_counter() - gc_start.get("t", time.perf_counter())
            state["gc_n"] += 1
            state["gc_gens"].append(info.get("generation"))

    gc.callbacks.append(on_gc)

    def timed(name, fn):
        def wrapped(*a, **k):
            if not state["on"]:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            state["steps"][name] = state["steps"].get(name, 0.0) + time.perf_counter() - t
            return out
        return wrapped

    FS.FastStark._x_lde = timed("_x_lde", FS.FastStark._x_lde)
    FS.FastStark._commit_rows = timed("_commit_rows", FS.FastStark._commit_rows)
    NTT.prefix_zerofier_evals = timed("prefix_zerofier_evals", NTT.prefix_zerofier_evals)
    F.batch_inv = timed("batch_inv", F.batch_inv)
    preprocess = FS.FastStark.preprocess

    def split_preprocess(self):
        if self.fri_domain_length < (1 << 24):
            return preprocess(self)
        state.update(on=True, gc_s=0.0, gc_n=0, gc_gens=[], steps={})
        before = torch.cuda.memory_stats()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = preprocess(self)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        state["on"] = False
        after = torch.cuda.memory_stats()
        print("DIAG " + json.dumps({
            "total_s": total, "steps": state["steps"], "gc_s": state["gc_s"], "gc_n": state["gc_n"],
            "gc_gens": state["gc_gens"], "gc_counts_after": gc.get_count(),
            "gc_tracked": len(gc.get_objects()),
            "reserved_gib_before": reserved / 2**30,
            "reserved_gib_after": torch.cuda.memory_reserved() / 2**30,
            "device_alloc": after.get("num_device_alloc", 0) - before.get("num_device_alloc", 0),
            "device_free": after.get("num_device_free", 0) - before.get("num_device_free", 0),
            "alloc_retries": after.get("num_alloc_retries", 0) - before.get("num_alloc_retries", 0),
        }), flush=True)
        return out

    FS.FastStark.preprocess = split_preprocess

    import chip_smoke

    sys.argv = ["chip_smoke.py"]
    rc = chip_smoke.main()
    print("DIAG rc", rc, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
