#!/usr/bin/env python3
"""Time H8's design candidates for its strided side on one CUDA card.

    python3 tools/ntt_tiled_probe.py

H8 (stark_anatomy_tpu_torch/csrc/ntt_tiled.cu) gives a cluster of kTile =
8 blocks 8 neighbouring transforms, so that 8 neighbouring threads read or
write a whole 32-byte sector of each limb row and move each point to its
transform's block through distributed shared memory.  The probe builds
the same source with kTileLog = 3, 2, 1 and 0: clusters of 8, 4 and 2
blocks (a warp instruction then moves half or a quarter of each sector it
touches, and the L2 cache merges the neighbouring clusters' parts), and
one block a transform with no exchange (4 of every 32 bytes of a sector
a block).  One nvcc call each, side by side, into the package's
git-ignored ``_build/``; each variant's output must equal the built
library's on the same inputs.  Then each step's ms a launch (CUDA events,
20 launches after a warm-up) at the 2^20 path's (8, 2^24) LDE with the
coset table and (8, 2^22) iNTT, the variants in turns 8, 4, 2, 1, 1, 2, 4,
8.  Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE_LOGS = (3, 2, 1, 0)
CASES = (("(8, 2^24) forward coset", 24, False), ("(8, 2^22) inverse", 22, True))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ntt_tiled_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field.scalar import Field
    from stark_anatomy_tpu_torch.ops.domain import coset_table
    from stark_anatomy_tpu_torch.ops.ntt import tiled_tables
    from stark_anatomy_tpu_torch.utils.build import Job, build_all

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    K.load()
    built = K._fns["ntt_tiled"]
    csrc = os.path.dirname(K.SOURCES["stark_ntt_tiled"])
    text = open(K.SOURCES["stark_ntt_tiled"]).read()
    assert text.count("constexpr int kTileLog = 3;") == 1
    tmp = tempfile.mkdtemp()
    try:
        for header in ("field_arith.cuh", "ntt_passes.cuh"):
            shutil.copy(os.path.join(csrc, header), tmp)
        jobs = []
        for t in TILE_LOGS:
            src = os.path.join(tmp, f"ntt_tiled_{t}.cu")
            with open(src, "w") as f:
                f.write(text.replace("constexpr int kTileLog = 3;", f"constexpr int kTileLog = {t};"))
            jobs.append(Job(f"stark_ntt_tiled_probe{t}", K._nvcc(), K.NVCC_FLAGS, src,
                            tuple(os.path.join(tmp, h) for h in ("field_arith.cuh", "ntt_passes.cuh"))))
        paths, _ = build_all(jobs)
    finally:
        shutil.rmtree(tmp)
    fns = {}
    for t in TILE_LOGS:
        fn = ctypes.CDLL(paths[f"stark_ntt_tiled_probe{t}"]).stark_ntt_tiled
        fn.argtypes, fn.restype = built.argtypes, built.restype
        fns[t] = fn

    g = Field.main().generator().value
    out = {}
    for label, log_n, inverse in CASES:
        n = 1 << log_n
        n1, inner, twiddles, outer, n_inv = tiled_tables(n, inverse, dev)
        gen = torch.Generator(device=dev).manual_seed(log_n)
        x = torch.randint(0, 1 << 16, (8, n), generator=gen, device=dev, dtype=torch.int32)
        x[7] &= 0x3FFF                                      # every value below p
        pre = None if inverse else coset_table(g, n, dev)
        steps = (lambda: K.ntt_tiled(x, 0, n1, inner, twiddles, scale=pre),
                 lambda y: K.ntt_tiled(y, 1, n1, outer, n_inv=n_inv))
        y_want = steps[0]()
        z_want = steps[1](y_want)
        times = {t: ([], []) for t in TILE_LOGS}
        try:
            for t in TILE_LOGS + TILE_LOGS[::-1]:
                K._fns["ntt_tiled"] = fns[t]
                y = steps[0]()
                assert torch.equal(y, y_want) and torch.equal(steps[1](y), z_want), \
                    f"the variant kTileLog = {t} differs from the built kernel at {label}"
                for k, run in enumerate((steps[0], lambda: steps[1](y_want))):
                    for _ in range(3):
                        run()
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(20):
                        run()
                    end.record()
                    torch.cuda.synchronize()
                    times[t][k].append(start.elapsed_time(end) / 20)
        finally:
            K._fns["ntt_tiled"] = built
        out[label] = {f"tile {1 << t}": {"step0_ms": s0, "step1_ms": s1,
                                         "median_ms": statistics.median(s0) + statistics.median(s1)}
                      for t, (s0, s1) in times.items()}
        del x, y_want, z_want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=10, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
