#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's field ops and main path on one CUDA card.

    python3 tools/port_compare.py [--root DIR]

Imports ``stark_anatomy_tpu_torch`` from DIR (default: this checkout),
builds its kernels, and prints one JSON line:

* ``ops_ms``: milliseconds per call through ``field/ops.py`` (CUDA events
  over a run of calls after a warm-up; the least of 5 runs, since the
  host's other load only adds), wrapper and launch included: ``mont_mul`` and ``add``
  at the Rescue state (2, 8, 1) and at (1, 2, 8, 4096), and ``mont_pow``
  with Rescue's ALPHA_INV at (2, 8, 1);
* ``pow_device_us``: device microseconds per ``F.mont_pow(x, ALPHA_INV)``
  at (2, 8, 1), all its kernels summed (torch.profiler; null if the
  profiler saw no device time);
* ``trace_s``: ``trace_batch`` on one key (B = 1), median of 5 warm runs,
  and ``trace_device_us``: its device microseconds (the Rescue
  permutation kernel and what else it launches);
* ``hash4096_device_us``: device microseconds of ``hash_batch`` on 4096
  inputs;
* ``lde_ms``: ``coset_evaluate`` of (2, 8, 4096) coefficients on the FRI
  domain (the prover's LDE), ms per call as for ``ops_ms``, and
  ``lde_device_us``: its device microseconds, all its kernels summed;
* ``sign_s`` and ``verify_s``: ``FastRPSSS()`` sign and verify at the
  production parameters, median of 5 warm runs after one warm-up, and
  ``phases``: the prover's PhaseTimer seconds per phase, the mean over
  those 5 signs (null for a tree without the timer);
* ``host_tree4096_ms``: one paired-leaf Merkle tree over 4096 canonical
  rows through ``MerkleTree.from_limbs_paired``, host milliseconds, the
  median of 50 after a warm-up (a tree with N1 hashes in C++, an older
  one with hashlib);
* ``sign_kernel_launches``: the port's own kernel launches in one warm
  sign (its launch counters), and ``launches_by_caller``: for that sign
  and for one verify, the calls of each kernel wrapper in
  ``field/kernels.py`` by calling function (the first frame outside the
  package's ``field/``, so ``F.mont_mul`` in ``ops/ntt.py:ntt`` counts
  for ``ops/ntt.py:ntt``; each call is one launch); ``sign_device_launches`` and
  ``sign_busy_share``: every kernel the profiler saw in one warm sign,
  PyTorch's included, and the device's busy time over the wall time
  under the profiler (null if it saw no device time);
* ``kernel_shapes``: H3 and H4 at the shapes where they spend their
  device time, each kernel's device microseconds per launch (H3) or per
  commit and per launch in launch order (H4), the medians of the
  profiler's kernel events over several calls: H3 at the sign's LDE
  (2, 8, 4096) forward with the pre-scale, and at the four-step's inner
  transforms of a 2^20 MiMC prove, (4096, 8, 4096) and (2048, 8, 2048),
  each with the twiddle post-scale and without; H4 at (8, n) for the 2^20
  path's layers 2^24, 2^20, 2^18 and 2^15, and at n = 4096; H5
  (``seed_expand_kernel``) at 2^22 elements, the 2^20 path's randomizer;
  the ladder (``pow_kernel``) at the paths' calls: x^(p-2) at (8, 1)
  (batch_inv's root) and at (8, 128), and the verifier's x^201 and x^741
  at (8, 128);
* ``mimc_prove``: ``preprocess_s``, the wall seconds of three calls of
  ``preprocess`` on one 2^20-step MiMC stark in turn (the first builds
  the instance's tables); then one steady prove after a first: its wall
  seconds, and under
  torch.profiler its wall and device busy seconds, the device
  milliseconds and launches of every kernel by name (``by_kernel``: H3
  ``ntt_kernel``, H4 ``merkle_kernel``, PyTorch's own), and each H0 and
  H1 launch's shapes with its device microseconds and bound, by shape
  (``by_shape``: the operands as the wrapper got them, each read once,
  the output written once, at 3.35 TB/s, or H0's 41 and H1's 16 32-bit
  operations an element at 67 T/s, the larger);
* ``large_ntt``: the transforms above H3's 8192 points at the 2^20 path's
  shapes (the LDE ``coset_evaluate`` of (8, 2^24) coefficients, the trace
  ``intt`` at (8, 2^22)) and at the sharded path's shard rows (``ntt`` of
  (8, 2^21), ``intt`` of (8, 2^19), S = 8): ms per call as for
  ``ops_ms``; one call's device kernels in launch order under
  torch.profiler (each launch's name and microseconds, median of 3
  calls) and their sum; the port's launches per call by kernel; the
  call's transient peak device memory (``max_memory_allocated`` less the
  memory held before it) and the bytes the tree's ``ops/ntt.py``
  twiddle cache holds after the calls;
* in ``mimc_prove`` also the steady prove's PhaseTimer phases and its
  peak device memory (``max_memory_allocated`` over the prove, after a
  reset);
* ``dist_ntt``: the distributed NTT on 8 in-process shards of the card
  (parallel/ntt_dist.py), the 2^24 coset evaluation (the LDE: the
  offset passed to the transform where the tree takes one, else the H0
  coset scale a shard before it, as the tree's ``_lde`` runs it) and the
  2^22 inverse (the trace iNTT), (8, n) codewords: ms per call as for
  ``ops_ms``, one call's device microseconds by kernel (median of 3
  calls under torch.profiler) and their sum, the port's launches per
  call, the call's transient peak device memory, and the device memory
  the calls left held (cached tables);
* ``sharded_prove``: the 2^20 MiMC chain on 8 in-process shards
  (``ShardedFastStark``, production parameters): preprocess and a first
  prove (wall seconds, the port's launches, peak device memory), then a
  steady prove's wall seconds and, under torch.profiler, its device busy
  milliseconds and the device milliseconds and launches of its top
  kernels;
* ``air_graphs``: the three graphs that H10-H12 replace, on random
  inputs at the paths' shapes (the sign's (1, 2, 8, 4096) quotients and
  combination, the batch of 64's, the 2^20 prove's combination (8, 2^24)
  with C = R = 1, and a verify's K = 128 points): by the glue the port
  ran before them (written out here over the tree's ``field/ops.py``, the
  lines of the parent's parallel/batch.py and protocols/fast_stark.py)
  and, where the tree has them, by the kernels; each route's ms per call
  as for ``ops_ms``, device microseconds per call (all its kernels) and
  the port's launches per call.  Both routes give the same values
  (checked);
* the card's name and power limit (nvidia-smi).

``--part sharded`` prints only ``dist_ntt`` and ``sharded_prove`` (with
the root and the card).

To compare two commits, unpack the older one into a git-ignored
directory (``git archive``) and run, in one command on one card:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ALPHA_INV = 180331931428153586757283157844700080811
WRAPPERS = ("mont_mul", "add_mod", "sub_mod", "mont_pow", "rescue_permutation", "ntt", "ntt_tiled",
            "fri_fold_batched", "rescue_quotients", "combination", "verify_core")


def ms_per_call(fn, iters: int, runs: int = 5) -> float:
    import torch

    for _ in range(3):
        fn()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return min(out)


def device_us_per_call(fn, iters: int):
    """Device microseconds per call of ``fn``, over every kernel it
    launches (torch.profiler); None if the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            total += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    return total / iters if total > 0 else None


def device_profile(fn):
    """(kernel launches, device busy seconds / wall seconds) of one call of
    ``fn`` under torch.profiler; (None, None) if it saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches, busy_us = 0, 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                launches += e.count
                busy_us += us
    if not launches:
        return None, None
    return launches, busy_us / 1e6 / wall


def launches_by_caller(K, pkg: str, fn) -> dict:
    """{caller: {wrapper: calls}} of one call of ``fn``: every kernel
    wrapper of the kernels module ``K`` that the tree has is counted under
    the 'path:function' of the first frame outside ``pkg``'s field/."""
    field = os.path.join(pkg, "field") + os.sep
    counts = collections.defaultdict(collections.Counter)

    def counting(name, wrapper):
        @functools.wraps(wrapper)
        def wrapped(*args, **kwargs):
            frame = sys._getframe(1)
            while frame is not None and frame.f_code.co_filename.startswith(field):
                frame = frame.f_back
            caller = "?" if frame is None else (
                f"{os.path.relpath(frame.f_code.co_filename, pkg)}:{frame.f_code.co_name}")
            counts[caller][name] += 1
            return wrapper(*args, **kwargs)
        return wrapped

    saved = {name: getattr(K, name) for name in WRAPPERS if hasattr(K, name)}
    for name, wrapper in saved.items():
        setattr(K, name, counting(name, wrapper))
    try:
        fn()
    finally:
        for name, wrapper in saved.items():
            setattr(K, name, wrapper)
    return {c: dict(per) for c, per in sorted(counts.items(), key=lambda kv: -sum(kv[1].values()))}


def kernel_events(fn, tag: str, calls: int):
    """Per call of ``fn``, the device microseconds of each launch of the
    kernels whose name holds ``tag``, in launch order (torch.profiler's
    kernel events); [] per call if the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.events()
                if getattr(e, "device_type", None) == DeviceType.CUDA and tag in e.name]
        hits.sort(key=lambda e: e.time_range.start)
        out.append([e.time_range.elapsed_us() for e in hits])
    return out


def kernel_shapes(dev) -> dict:
    """``kernel_shapes`` of the module docstring."""
    import torch

    from stark_anatomy_tpu_torch.commit import kernels as MK
    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.ops.domain import DOMAINS

    def codeword(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randint(0, 1 << 16, shape, generator=gen, device=dev, dtype=torch.int32)
        x[..., 7, :] &= 0x3FFF                # the top limb below p's: every value < p
        return x

    def median_per_launch(runs):
        flat = [us for run in runs for us in run]
        return statistics.median(flat) if flat else None

    out = {"ntt_device_us": {}, "merkle_device_us": {}, "seed_expand_device_us": {},
           "pow_device_us": {}}
    for batch, n, scale in ((2, 4096, "pre"), (4096, 4096, "post"), (4096, 4096, None),
                            (2048, 2048, "post"), (2048, 2048, None)):
        x = codeword((batch, 8, n), n + batch)
        table = codeword((batch, 8, n) if scale == "post" else (8, n), n + batch + 1)
        powers = DOMAINS.get(n, dev)["fwd_powers"]
        args = (powers, None, table if scale == "pre" else None, table if scale == "post" else None)
        runs = kernel_events(lambda: K.ntt(x, *args), "ntt_kernel", 5)
        out["ntt_device_us"][f"({batch}, 8, {n}){' ' + scale if scale else ''}"] = median_per_launch(runs)
        del x, table
        torch.cuda.empty_cache()
    for n in (1 << 24, 1 << 20, 1 << 18, 1 << 15, 4096):
        canon = codeword((8, n), 7 + n)
        runs = kernel_events(lambda: MK.merkle_paired(canon), "merkle_kernel", 5)
        per_launch = [statistics.median(col) for col in zip(*runs)] if runs and runs[0] else None
        out["merkle_device_us"][f"(8, {n})"] = {
            "commit": statistics.median(sum(run) for run in runs) if per_launch else None,
            "launches": per_launch}
        del canon
        torch.cuda.empty_cache()
    import hashlib

    import numpy as np

    from stark_anatomy_tpu_torch.field import ops as F
    from stark_anatomy_tpu_torch.field.scalar import P

    seed = torch.from_numpy(np.frombuffer(hashlib.blake2s(b"port compare seed").digest(), dtype="<u4")
                            .view(np.int32).copy()).to(dev)
    for count in (1 << 22,):
        runs = kernel_events(lambda: MK.seed_expand(seed, count), "seed_expand_kernel", 10)
        out["seed_expand_device_us"][str(count)] = median_per_launch(runs)
    for shape, e, label in (((8, 1), P - 2, "p-2"), ((8, 128), P - 2, "p-2"), ((8, 128), 201, "201"),
                            ((8, 128), 741, "741")):
        x = codeword(shape, shape[-1] + e % 1000)
        runs = kernel_events(lambda: F.mont_pow(x, e), "pow_kernel", 20)
        out["pow_device_us"][f"{shape} {label}"] = median_per_launch(runs)
    return out


def large_ntt(dev) -> dict:
    """``large_ntt`` of the module docstring."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field.scalar import Field
    from stark_anatomy_tpu_torch.ops import ntt as NTT

    g = Field.main().generator().value
    out = {}
    for label, log_n, call in (("coset_evaluate (8, 2^24)", 24, lambda x: NTT.coset_evaluate(x, g, x.shape[-1])),
                               ("intt (8, 2^22)", 22, NTT.intt),
                               ("ntt (8, 2^21) shard row", 21, NTT.ntt),
                               ("intt (8, 2^19) shard row", 19, NTT.intt)):
        gen = torch.Generator(device=dev).manual_seed(log_n)
        x = torch.randint(0, 1 << 16, (8, 1 << log_n), generator=gen, device=dev, dtype=torch.int32)
        x[7] &= 0x3FFF
        ms = ms_per_call(lambda: call(x), 5, runs=3)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call(x)
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            runs.append([(e.name[:80], e.time_range.elapsed_us()) for e in events])
        launches = None
        if runs[0] and all(len(r) == len(runs[0]) for r in runs):
            launches = [[name, statistics.median(r[k][1] for r in runs)] for k, (name, _) in enumerate(runs[0])]
        K.reset_launch_counts()
        call(x)
        torch.cuda.synchronize()
        port_launches = {k: v for k, v in K.LAUNCHES.items() if v}
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        call(x)
        torch.cuda.synchronize()
        out[label] = {"ms": ms, "device_launches": launches,
                      "device_us": sum(us for _, us in launches) if launches else None,
                      "port_launches": port_launches,
                      "transient_peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30}
        del x
        torch.cuda.empty_cache()
    cache = getattr(NTT, "_TWIDDLES", {})
    out["twiddle_cache_gib"] = sum(t.numel() * t.element_size() for t in cache.values()) / 2**30
    return out


def mimc_prove(dev) -> dict:
    """``mimc_prove`` of the module docstring."""
    import random

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field.scalar import Field, FieldElement
    from stark_anatomy_tpu_torch.models import mimc as MM

    field = Field.main()
    rng = random.Random(2020)
    mimc, stark = MM.make_stark(1 << 20)
    preprocess_s = []
    for _ in range(3):
        tz = None
        t = time.perf_counter()
        tz = stark.preprocess()
        torch.cuda.synchronize()
        preprocess_s.append(time.perf_counter() - t)
    MM.prove_chain(mimc, stark, FieldElement(rng.randrange(field.p), field), tz)
    torch.cuda.synchronize()
    t = time.perf_counter()
    MM.prove_chain(mimc, stark, FieldElement(rng.randrange(field.p), field), tz)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    timer = getattr(stark, "timer", None)
    if timer is not None:
        timer.totals.clear()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    MM.prove_chain(mimc, stark, FieldElement(rng.randrange(field.p), field), tz)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    phases = None if timer is None else dict(timer.totals)
    x = FieldElement(rng.randrange(field.p), field)
    calls = []                                   # (wrapper, a's shape, b's shape, out's shape)
    saved = {name: getattr(K, name) for name in ("mont_mul", "add_mod", "sub_mod")}

    def recording(name, wrapper):
        @functools.wraps(wrapper)
        def wrapped(a, b, *args, **kwargs):
            out = wrapper(a, b, *args, **kwargs)
            if out.is_cuda and out.numel():          # a launch (a CPU tensor runs the plain version)
                calls.append((name, tuple(a.shape), tuple(b.shape), tuple(out.shape)))
            return out
        return wrapped

    for name, wrapper in saved.items():
        setattr(K, name, recording(name, wrapper))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            MM.prove_chain(mimc, stark, x, tz)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t
    finally:
        for name, wrapper in saved.items():
            setattr(K, name, wrapper)
    busy_us, by_kernel = 0.0, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        busy_us += us
        if us > 0:
            acc = by_kernel.setdefault(e.key[:100], [0, 0.0])
            acc[0] += e.count
            acc[1] += us
    events = sorted((e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    h1 = {}
    for name, tag, ops in (("mont_mul", "MontMul", 41), ("add_mod", "AddMod", 16), ("sub_mod", "SubMod", 16)):
        launches = [e.time_range.elapsed_us() for e in events if tag in e.name]
        made = [c for c in calls if c[0] == name]
        if len(launches) != len(made):
            h1[name] = f"{len(made)} calls against {len(launches)} profiled launches: not paired"
            continue
        for (_, sa, sb, so), us in zip(made, launches):
            key = f"{name} {sa} {sb} -> {so}"
            nbytes = 4 * (math.prod(sa) + math.prod(sb) + math.prod(so))
            bound_us = max(nbytes / 3.35e12, math.prod(so) // 8 * ops / 67e12) * 1e6
            row = h1.setdefault(key, {"launches": 0, "device_us": [], "bound_us": bound_us})
            row["launches"] += 1
            row["device_us"].append(us)
    for row in h1.values():
        if isinstance(row, dict):
            row["device_us"] = statistics.median(row["device_us"])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    return {"preprocess_s": preprocess_s, "wall_s": wall, "steady_s": steady_s, "phases": phases,
            "peak_gib": peak_gib, "profiled_wall_s": prof_wall,
            "device_busy_s": busy_us / 1e6 if busy_us else None,
            "by_kernel": {tag: {"launches": c, "device_ms": us / 1e3} for tag, (c, us) in top},
            "by_shape": h1}


def profiled_kernels(fn, calls: int = 3) -> dict:
    """{kernel name: [launches, device us]} of one call of ``fn``, the
    medians over ``calls`` profiled calls (torch.profiler's kernel
    events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for _ in range(calls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per = collections.defaultdict(lambda: [0, 0.0])
        for e in prof.events():
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                per[e.name[:80]][0] += 1
                per[e.name[:80]][1] += e.time_range.elapsed_us()
        runs.append(per)
    names = set().union(*runs)
    return {k: [statistics.median(r[k][0] if k in r else 0 for r in runs),
                statistics.median(r[k][1] if k in r else 0.0 for r in runs)] for k in sorted(names)}


def dist_ntt(dev) -> dict:
    """``dist_ntt`` of the module docstring."""
    import inspect

    import torch

    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field import ops as F
    from stark_anatomy_tpu_torch.field.scalar import Field
    from stark_anatomy_tpu_torch.ops.domain import coset_table
    from stark_anatomy_tpu_torch.parallel.mesh import Mesh, Sharded, pointwise
    from stark_anatomy_tpu_torch.parallel.ntt_dist import make_distributed_ntt

    g = Field.main().generator().value
    mesh = Mesh([[dev] * 8])
    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    out = {}
    for label, log_n, inverse in (("coset_evaluate (8, 2^24), 8 shards", 24, False),
                                  ("intt (8, 2^22), 8 shards", 22, True)):
        n = 1 << log_n
        fn = make_distributed_ntt(n, mesh, inverse=inverse)
        fused = "offset" in inspect.signature(fn).parameters
        gen = torch.Generator(device=dev).manual_seed(log_n)
        x = torch.randint(0, 1 << 16, (8, n), generator=gen, device=dev, dtype=torch.int32)
        x[7] &= 0x3FFF
        xs = Sharded.place(mesh, x)
        del x
        if inverse:
            call = lambda: fn(xs)
        elif fused:
            call = lambda: fn(xs, g)
        else:
            scale = Sharded.place(mesh, coset_table(g, n, dev))
            call = lambda: fn(pointwise(F.mont_mul, xs, scale))
        ms = ms_per_call(call, 3, runs=3)
        kernels = profiled_kernels(call)
        K.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        port_launches = {k: v for k, v in K.LAUNCHES.items() if v}
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        out[label] = {"ms": ms, "fused_scale": fused and not inverse,
                      "device_us": sum(us for _, us in kernels.values()), "by_kernel": kernels,
                      "port_launches": port_launches,
                      "transient_peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30}
        del xs, call
        scale = None
        torch.cuda.empty_cache()
    out["held_after_gib"] = (torch.cuda.memory_allocated() - held0) / 2**30
    return out


def sharded_prove(dev) -> dict:
    """``sharded_prove`` of the module docstring."""
    import random

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field.scalar import Field, FieldElement
    from stark_anatomy_tpu_torch.models import mimc as MM
    from stark_anatomy_tpu_torch.parallel.mesh import Mesh
    from stark_anatomy_tpu_torch.parallel.sharded_stark import ShardedFastStark

    steps = 1 << 20
    field = Field.main()
    rng = random.Random(2021)
    mimc, _ = MM.make_stark(steps, device=dev)
    stark = ShardedFastStark(field, 4, 64, 128, 1, steps + 1, transition_constraints_degree=3,
                             mesh=Mesh([[dev] * 8]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t = time.perf_counter()
    tz = stark.preprocess()
    MM.prove_chain(mimc, stark, FieldElement(rng.randrange(field.p), field), tz)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    first = {"seconds": first_s, "port_launches": sum(K.LAUNCHES.values()),
             "by_kernel": {k: v for k, v in K.LAUNCHES.items() if v},
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "routes": dict(stark.routes)}
    steady = []
    for _ in range(2):
        t = time.perf_counter()
        MM.prove_chain(mimc, stark, FieldElement(rng.randrange(field.p), field), tz)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        MM.prove_chain(mimc, stark, FieldElement(rng.randrange(field.p), field), tz)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    busy_us, by_kernel = 0.0, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        busy_us += us
        if us > 0:
            acc = by_kernel.setdefault(e.key[:80], [0, 0.0])
            acc[0] += e.count
            acc[1] += us
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:14]
    return {"first": first, "steady_s": steady, "profiled_wall_s": prof_wall,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "by_kernel": {k: {"launches": c, "device_ms": us / 1e3} for k, (c, us) in top}}


def glue_quotients(F, RP, trace, interp, inv_bz, inv_tz, tables, shift):
    """The boundary and transition quotients as the port ran them before
    H10 (parallel/batch.py:pipeline): a rolled copy of the trace, then
    H0/H1 launches over the Rescue AIR's glue."""
    import torch

    c1, c2, mds, mds_inv = tables
    nxt = torch.roll(trace, -shift, dims=-1)
    bq = F.mont_mul(F.sub(trace, interp), inv_bz)
    return bq, F.mont_mul(RP._rescue_air_kernel(trace, nxt, c1, c2, mds, mds_inv), inv_tz)


def glue_batch_combination(F, rand, tq, bq, tq_shift, bq_shift, weights):
    """The batch core's combination before H11 (parallel/batch.py:
    combination): the shifted terms, a stack of every term, weighted_sum."""
    import torch

    tq_t, bq_t = tq.movedim(1, 0), bq.movedim(1, 0)
    sh_tq = F.mont_mul(tq_shift[:, None], tq_t)
    sh_bq = F.mont_mul(bq_shift[:, None], bq_t)
    terms = torch.cat([
        rand[None],
        torch.stack([tq_t, sh_tq], dim=1).reshape((-1,) + tq_t.shape[1:]),
        torch.stack([bq_t, sh_bq], dim=1).reshape((-1,) + bq_t.shape[1:]),
    ])
    w_lead = weights.movedim(-3, 0)
    if w_lead.dim() < terms.dim():
        w_lead = w_lead[:, None]
    return F.weighted_sum(terms, w_lead)


def glue_combination_core(F, rand, tq, bq, tq_shift, bq_shift, weights):
    """FastStark's combination before H11 (protocols/fast_stark.py:
    _combination_core): a product and an add a term, a stack of the terms
    and their sum."""
    import torch

    terms, idx = [F.mont_mul(rand, weights[0])], 1
    for q, shift in ((tq, tq_shift), (bq, bq_shift)):
        for s in range(q.shape[0]):
            ws = F.add(weights[idx], F.mont_mul(weights[idx + 1], shift[s]))
            terms.append(F.mont_mul(q[s], ws))
            idx += 2
    return F.field_sum(torch.stack(terms))


def air_graphs(dev, scheme, pk) -> dict:
    """``air_graphs`` of the module docstring."""
    import torch

    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field import ops as F
    from stark_anatomy_tpu_torch.models import rescue_prime as RP
    from stark_anatomy_tpu_torch.protocols import fast_stark as FS

    stark = scheme.stark
    N, E = stark.fri_domain_length, stark.expansion_factor
    gen = torch.Generator(device=dev).manual_seed(2020)

    def codeword(*shape):
        x = torch.randint(0, 1 << 16, shape, generator=gen, device=dev, dtype=torch.int32)
        x[..., 7, :] &= 0x3FFF
        return x

    def measure(fn, iters):
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        launches = sum(K.LAUNCHES.values())
        return {"ms": ms_per_call(fn, iters), "device_us": device_us_per_call(fn, max(iters // 4, 1)),
                "launches": launches}

    def same(a, b):
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), "the glue and the kernel disagree"

    def both(glue, kernel, iters):
        row = {"glue": measure(glue, iters), "kernel": None}
        if kernel is not None:
            same(glue(), kernel())
            row["kernel"] = measure(kernel, iters)
        return row

    has = hasattr(K, "rescue_quotients")
    tables = RP.rescue_air_tables(stark)
    inv_tz = scheme.transition_zerofier.inv_codeword
    out = {}
    for B in (1, 64):
        trace, interp, inv_bz = (codeword(B, 2, 8, N) for _ in range(3))
        out[f"quotients ({B}, 2, 8, {N})"] = both(
            lambda: glue_quotients(F, RP, trace, interp, inv_bz, inv_tz, tables, E),
            (lambda: K.rescue_quotients(trace, interp, inv_bz, inv_tz, tables, E)) if has else None,
            50 if B == 1 else 10)
        args = (codeword(B, 8, N), codeword(B, 2, 8, N), codeword(B, 2, 8, N), codeword(2, 8, N),
                codeword(2, 8, N), codeword(B, 9, 8, 1))
        out[f"combination ({B}, 8, {N})"] = both(
            lambda: glue_batch_combination(F, *args), (lambda: K.combination(*args)) if has else None,
            50 if B == 1 else 10)
    n = 1 << 24
    args = (codeword(8, n), codeword(1, 8, n), codeword(1, 8, n), codeword(1, 8, n), codeword(1, 8, n),
            codeword(5, 8, 1))
    out[f"combination (8, {n}) C = R = 1"] = both(
        lambda: glue_combination_core(F, *args), (lambda: K.combination(*args)) if has else None, 3)
    del args
    torch.cuda.empty_cache()
    air = scheme._air()
    boundary = scheme.rp.boundary_constraints(pk)
    max_degree = stark.max_degree(air)
    tq_sh = tuple(max_degree - b for b in stark.transition_quotient_degree_bounds(air))
    bq_sh = tuple(max_degree - b for b in stark.boundary_quotient_degree_bounds(
        stark.randomized_trace_length, boundary))
    Kq = 128
    vals = codeword(8, 8 * Kq)
    bz, ip = stark._stack_coeffs(stark.boundary_zerofiers(boundary)), stark._stack_coeffs(
        stark.boundary_interpolants(boundary))
    w = codeword(9, 8, 1)
    idx = torch.randint(0, N, (Kq,), generator=gen, device=dev)
    evaluator = RP.make_index_air_evaluator(stark)
    out[f"verify K = {Kq}, shifts {tq_sh} {bq_sh}, D = {bz.shape[-1]}, {ip.shape[-1]}"] = both(
        lambda: FS._verify_core(vals, bz, ip, w, idx, evaluator, 2, Kq, tq_sh, bq_sh),
        (lambda: K.verify_core(vals, bz, ip, w, idx, evaluator.rescue_tables, tq_sh, bq_sh)) if has else None,
        20)
    return out


def median_s(fn, runs: int = 5) -> float:
    import torch

    out = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return statistics.median(out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--part", choices=("all", "sharded"), default="all")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_compare: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import stark_anatomy_tpu_torch
    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field import ops as F
    from stark_anatomy_tpu_torch.field.scalar import Field
    from stark_anatomy_tpu_torch.models.rescue_prime import hash_batch, trace_batch
    from stark_anatomy_tpu_torch.models.rpsss import FastRPSSS
    from stark_anatomy_tpu_torch.ops import ntt as NTT
    from stark_anatomy_tpu_torch.utils.convert import device_from_ints

    assert os.path.dirname(os.path.dirname(os.path.abspath(stark_anatomy_tpu_torch.__file__))) == root
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    K.load()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip().splitlines()[0]
    if args.part == "sharded":
        print(json.dumps({"root": root, "card": smi, "dist_ntt": dist_ntt(dev),
                          "sharded_prove": sharded_prove(dev)}))
        return 0

    gen = torch.Generator().manual_seed(0)
    ops_ms, pow_device_us = {}, None
    for shape in ((2, 8, 1), (1, 2, 8, 4096)):
        x = torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32)
        x[..., 7, :] &= 0x3FFF                  # limb 7 below p's: every value < p
        x = x.to(dev)
        ops_ms[f"mont_mul {shape}"] = ms_per_call(lambda: F.mont_mul(x, x), 200)
        ops_ms[f"add {shape}"] = ms_per_call(lambda: F.add(x, x), 200)
        if shape == (2, 8, 1):
            ops_ms[f"mont_pow ALPHA_INV {shape}"] = ms_per_call(lambda: F.mont_pow(x, ALPHA_INV), 10)
            pow_device_us = device_us_per_call(lambda: F.mont_pow(x, ALPHA_INV), 20)
    coeffs = x.reshape(2, 8, 4096)               # the last shape's values
    generator = Field.main().generator().value
    lde_ms = ms_per_call(lambda: NTT.coset_evaluate(coeffs, generator, 4096), 50)
    lde_device_us = device_us_per_call(lambda: NTT.coset_evaluate(coeffs, generator, 4096), 20)

    scheme = FastRPSSS()
    sk, pk = scheme.keygen()
    sk_dev = device_from_ints([sk.value], dev)
    trace_batch(sk_dev)
    trace_s = median_s(lambda: trace_batch(sk_dev))
    trace_device_us = device_us_per_call(lambda: trace_batch(sk_dev), 10)
    inputs = device_from_ints([(7919 * i) ** 3 % Field.main().p for i in range(4096)], dev)
    hash4096_device_us = device_us_per_call(lambda: hash_batch(inputs), 5)
    doc = b"port compare"
    sig = scheme.sign(sk, doc)
    assert scheme.verify(pk, doc, sig)
    timer = getattr(scheme.stark, "timer", None)
    before = dict(timer.totals) if timer is not None else {}
    sign_s = median_s(lambda: scheme.sign(sk, doc))
    phases = None if timer is None else {
        name: (total - before.get(name, 0.0)) / 5 for name, total in timer.totals.items()}
    verify_s = median_s(lambda: scheme.verify(pk, doc, sig))
    from stark_anatomy_tpu_torch.commit.merkle import MerkleTree
    from stark_anatomy_tpu_torch.utils.convert import canonical_np

    rows = canonical_np(x.reshape(2, 8, 4096)[0])
    MerkleTree.from_limbs_paired(rows)
    tree_s = []
    for _ in range(50):
        t = time.perf_counter()
        MerkleTree.from_limbs_paired(rows)
        tree_s.append(time.perf_counter() - t)
    host_tree4096_ms = statistics.median(tree_s) * 1e3
    pkg = os.path.dirname(os.path.abspath(stark_anatomy_tpu_torch.__file__))
    K.reset_launch_counts()
    by_caller = {"sign": launches_by_caller(K, pkg, lambda: scheme.sign(sk, doc))}
    torch.cuda.synchronize()
    sign_kernel_launches = dict(K.LAUNCHES)
    by_caller["verify"] = launches_by_caller(K, pkg, lambda: scheme.verify(pk, doc, sig))
    sign_device_launches, sign_busy_share = device_profile(lambda: scheme.sign(sk, doc))
    graphs = air_graphs(dev, scheme, pk)
    shapes = kernel_shapes(dev)
    large = large_ntt(dev)
    prove = mimc_prove(dev)
    dist = dist_ntt(dev)
    sharded = sharded_prove(dev)
    print(json.dumps({
        "root": root, "card": smi, "ops_ms": ops_ms, "pow_device_us": pow_device_us,
        "trace_s": trace_s, "trace_device_us": trace_device_us,
        "hash4096_device_us": hash4096_device_us, "lde_ms": lde_ms, "lde_device_us": lde_device_us,
        "sign_s": sign_s, "verify_s": verify_s, "phases": phases,
        "host_tree4096_ms": host_tree4096_ms,
        "sign_kernel_launches": sign_kernel_launches, "launches_by_caller": by_caller,
        "sign_device_launches": sign_device_launches, "sign_busy_share": sign_busy_share,
        "air_graphs": graphs, "kernel_shapes": shapes, "large_ntt": large, "mimc_prove": prove,
        "dist_ntt": dist, "sharded_prove": sharded,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
