#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases (each prints its wall seconds):

0. device and build: the card's name and power limit, then the builds,
   all started together: one ``nvcc`` call per CUDA source
   (stark_anatomy_tpu_torch/csrc/field.cu, merkle.cu, ntt_tiled.cu,
   ntt_columns.cu and air.cu) and one host
   C++ call for N1, the blake2s tree hasher (csrc/blake2s_host.cpp);
1. kernels against their plain versions: H0 ``mont_mul`` and H1
   ``add_mod``/``sub_mod`` on the card against the plain PyTorch versions
   on CPU copies of the same inputs, exact equality, at the main path's
   shapes and a ragged one; the H0 ladder ``mont_pow`` the same way for
   the exponents 1, 2, 3, ALPHA_INV, p - 2 and a seeded 128-bit one at
   (2, 8, 1), (8, 4096) and the main shape (e = 2 is the squaring
   product alone), x^(p-2) (the fixed inverse chain) through ``F.inv``
   and ``F.batch_inv`` at (8, 1), (3, 8, 1) and (8, 128), the verifier's
   x^201 and x^741 at (8, 128), and a seeded exponent of every bit length
   0-128 at (8, 1); H2 ``rescue_perm`` (trace and hash) for B = 1, 7 and
   4096, random and special states, and the Rescue known-answer vectors.
   The special values are 0, 1, p - 1, p - 2 (its low words are all
   ones, which stresses the carries) and R mod p.  H3 ``ntt`` for every
   n = 2^0 .. 2^13, batch 1, 2 and 3 (its cluster path from n = 1024
   up), forward and inverse, with and without scales; H4 ``merkle`` (the
   blake2s Merkle tree) for n = 4, 64 and 4096, 1, 2 and 7 codewords in
   one launch, and N1 against hashlib at n = 4096;
   then each kernel's time per launch (CUDA events) and device time
   (profiler) beside the plain version's time on the card and the bound,
   and the same for the ladder (its record: x^(p-2) at (8, 1), the paths'
   launch) and ``mont_mul`` at each ladder shape; H4's
   time per commit (one launch a commit), and N1's and hashlib's per tree;
2. main path: ``FastRPSSS()`` keygen, sign and verify on the card at the
   production parameters; verify must accept, and reject a forged
   document and another key's pk; H10 ``rescue_quotients`` and H11
   ``combination`` at the inputs a sign gives them, H12 ``verify_core`` at
   a verify's (captured from the wrappers' calls), each against its plain
   version on the card, with the special values in front too (a zero
   transition-zerofier value for H12), and H10 with the next rows as
   their own operand; their times beside the bound; every kernel of the
   path must be launched in that sign (H7, the batched FRI fold, too: a
   sign is a batch of one), H12 in the verify; then one warm-up and three
   timed signs and verifies, and the kernel launches of one warm sign (at
   most 23) and of one verify (at most 3); the
   Rescue trace alone, which must be one ``rescue_perm`` launch and no
   H0/H1 launch; the prover's phase seconds (PhaseTimer) of the timed
   signs; a device profile of one sign (torch.profiler) and a host one
   (cProfile, the prover's main steps);
3. card against CPU: one seeded sign on the card and one with
   ``device="cpu"`` must give identical bytes, and each must verify the
   other's signature; then the generic prover, ``FastStark.prove`` with
   no AIR evaluator (``compile_air``) at the production parameters, on the
   card with the device commitment forced (STARK_TPU_DEVICE_HASH=1, so
   every tree is built by H4) and on the CPU with host trees: identical
   bytes, each verified, and H4 launched in that run;
4. H4 at the large-trace size: the tree of a seeded codeword of 2^22
   elements on the card against N1's tree of the same codeword (root,
   the first three levels, a 64-index multiproof), with H4's time per
   commit and N1's, the copy to the host included;
5. the large-trace path: H5 ``seed_expand`` against its plain version on
   the card at 1, 2, 3 and 4097 elements, at a tile's edges (1023, 1024
   and 1025 counters, each as an odd and an even count), at 2^16 + 1
   (whose deepest round must be 4 or more) and at the 2^20 path's 2^22
   (a seed whose round 0 rejects candidates), H6 ``fri_fold`` at the top round's
   h = 2^23 and at the path's small rounds, h = 2^14 down to 2^9; H4 at
   every FRI layer of that path, 2^24 down to its last, 2^9,
   against its plain version on the card and N1's root, with its device
   time per commit and bound; H3's persistent path at the four-step's
   inner shapes (4096, 8, 4096) and (2048, 8, 2048), with the twiddle
   post-scale and without, 16 seeded rows against the plain transform,
   with device time per launch and bound; the four-step NTT against H3's single-launch path at n = 8192
   (threshold lowered), against the plain transform at 2^16, and at 2^22
   and 2^24 by the forward/inverse round trip and spot values of a sparse
   polynomial computed on the host, each call two H8 launches and nothing
   else; H8 ``ntt_tiled`` against its plain version step by step at the
   path's (8, 2^22) inverse and (8, 2^24) forward and inverse with the
   coset table, and at a batch of 3 of 2^14, with each step's time and
   device time, the plain version's time and the bound; a seeded MiMC proof at
   ``make_stark(15, 4, 4, 8)`` with every large branch forced (rolling
   zerofier, bulk randomness, device FRI, four-step NTT) on the card and
   on the CPU, identical and cross-verified; then a MiMC chain of 2^20
   steps (FRI domain 2^24) at the production parameters: preprocess, a
   first prove and verify, three steady proves (median, phases), a false
   output rejected, the proof's bytes, peak device memory, the launches
   of one steady prove, its device busy share (torch.profiler), and the
   pipelined prover over four statements against four serial proves;
   before the proofs, H11 at that prove's combination (8, 2^24), C = R =
   1, against its plain version on the first and last 2^16 columns, with
   the special values too, and its time beside the bound;
6. batch signing: H7 ``fri_fold_batched`` against its plain version on
   the card at (64, 8, 4096) and (64, 8, 512) with 0, 1 and p - 1 among
   the inputs and a distinct challenge per proof, with its times and
   bound; a production batch of 64 signatures by ``make_batch_rpsss()``
   (a warm batch, then a steady one: seconds per batch and per signature,
   the five phases, the launches by kernel), every signature verified by
   ``FastRPSSS``, a forged document and another key's pk rejected, the
   device busy share of a batch (torch.profiler) and its host profile
   (cProfile); H10 and H11 at the batch's inputs (per-proof tables and
   weights) against their plain versions, with the special values too,
   and their times beside the bound; then the card against the CPU byte
   for byte: a seeded
   batch of 3 at the tests' small parameters, a seeded slow ``Stark`` proof at
   tests/test_stark.py's parameters, and ``entry()``'s core outputs at
   B = 2; and ``interpolate_generic`` round trips at n = 16 and 256, with
   K17's steps timed on the card and on the CPU beside their bound;
7. multi-GPU sharding on the one card (in-process shards, a virtual mesh
   of cuda:0 repeated): H9 ``ntt_columns`` (the distributed NTT's column
   step, both directions, with and without the coset pre-scale, on a
   local mesh's views and on one receive buffer, timed at S = 8 beside
   the glue it replaced), H3 (the glue's column transforms (w, 8, S)
   and the row transforms' former four-step inner shapes), H8
   (the row transforms of every shard length B > 8192, forward and
   inverse, timed at S = 8), H0 (the glue's
   cross twiddle (w, 8, S) and a shard's coset scale), H6 (a pair block's
   top round) and H4 (one launch over the S pair blocks) at the sharded
   2^20 path's shapes for S = 2, 4, 8 against their plain versions, and
   the distributed NTT and coset evaluation at 2^24 against the
   one-device ones, each one H9 and two H8 launches a shard; the topology
   test's proof (FRI domain 512) on S = 2, 4, 8 shards, identical to the
   one-device card proof and the CPU's; NCCL at world size 1 (the group,
   the controller, the distributed NTT, a sharded proof); the 2^20 MiMC
   proof on 8 shards identical to the one-device proof and verified, with
   its launches (every kernel of the path must launch); the scaling report
   for S = 1, 2, 4, 8 (seconds, peak memory, device busy share, routes:
   sharding overhead on one card, not collective scaling); and
   ``dryrun_multichip(8, devices=[cuda:0] * 8)``.

The last lines are the card's ``nvidia-smi`` name and power limit, a JSON
line with one record per kernel, and the result line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before the result line; without CUDA, or without the package beside this
script, it exits non-zero at once.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import random
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12     # H100 SXM 32-bit rate outside the tensor cores
# H100 SXM instruction issue: 4 warp instructions a cycle on each of 132
# SMs at the 1980 MHz boost clock, 32 lanes each (the float32 rate above
# counts 2 operations per lane-instruction)
INSTR_PER_S = 4 * 32 * 132 * 1.98e9
# integer instructions of one blake2s compression: a G step needs 12 (two
# three-input adds, two adds, four xors, four funnel-shift rotations), 8 G
# a round, 10 rounds
BLAKE2S_INSTR = 10 * 8 * 12
SHAPES = [(1, 2, 8, 4096), (8, 1024), (8, 1000)]
MAIN_SHAPE = (1, 2, 8, 4096)
RESCUE_SHAPE = (2, 8, 1)                 # the Rescue state (H2 runs its own x^(1/3) chain)
LADDER_SHAPES = [RESCUE_SHAPE, (8, 4096), MAIN_SHAPE]
INV_SHAPES = [(8, 1), (3, 8, 1), (8, 128)]   # x^(p-2): batch_inv's roots, the glue verifier's (8, 128)
# the ladder's launch on the paths: one a 2^20 prove and one its verify
# (the glue verifier of MiMC's AIR; a Rescue verify runs H12's chain)
INV_MAIN = (8, 1)
SHIFT_EXPONENTS = (201, 741)             # the glue verifier's x^e at (8, 128) (protocols/fast_stark.py:_verify_core)
SHIFT_SHAPE = (8, 128)
ALPHA_INV = 180331931428153586757283157844700080811
DOC = b"chip smoke: FastRPSSS on the card"

# what each kernel replaces in the JAX package, and 32-bit integer
# operations per element (H0: 20 32x32->64 products, two words each, and
# one 32-bit product, with p's sparse words; a squaring: 14 such products
# and the narrow one; the ladder does one squaring per bit and one product
# per multiply; H1: a 4-word add or subtract and the conditional
# correction)
MUL_OPS = 41
SQR_OPS = 29
ADD_OPS = 16
KERNEL_INFO = {
    "mont_mul": ("stark_anatomy_tpu/field/pallas_kernels.py:114", MUL_OPS),
    "mont_pow": ("stark_anatomy_tpu/field/ops.py:343", None),
    "add_mod": ("stark_anatomy_tpu/field/limb_arith.py:62", ADD_OPS),
    "sub_mod": ("stark_anatomy_tpu/field/limb_arith.py:68", ADD_OPS),
    "rescue_perm": ("stark_anatomy_tpu/models/rescue_prime.py:175", None),
    "ntt": ("stark_anatomy_tpu/ops/ntt.py:79", None),
    "merkle": ("stark_anatomy_tpu/commit/device_merkle.py:57", None),
    "seed_expand": ("stark_anatomy_tpu/utils/rand.py:33", None),
    "fri_fold": ("stark_anatomy_tpu/protocols/fri.py:43", None),
    "fri_fold_batched": ("stark_anatomy_tpu/protocols/fri.py:53", None),
    "ntt_tiled": ("stark_anatomy_tpu/ops/stage_ntt.py:383", None),
    "ntt_columns": ("stark_anatomy_tpu/parallel/ntt_dist.py:74", None),
    "rescue_quotients": ("stark_anatomy_tpu/protocols/fast_stark.py:1033", None),
    "combination": ("stark_anatomy_tpu/protocols/fast_stark.py:1087", None),
    "verify_core": ("stark_anatomy_tpu/protocols/fast_stark.py:958", None),
    "sample_mont": ("stark_anatomy_tpu/parallel/batch_prover.py:138", None),
}
# the profiler's kernel names
PROFILE_TAGS = {"mont_mul": "MontMul", "mont_pow": "pow_kernel",
                "add_mod": "AddMod", "sub_mod": "SubMod",
                "rescue_perm": "rescue_kernel", "ntt": "ntt_kernel",
                "merkle": "merkle_kernel", "seed_expand": "seed_expand_kernel",
                "fri_fold": "fri_fold_kernel", "fri_fold_batched": "fri_fold_batched_kernel",
                "ntt_tiled": "tiled_", "ntt_columns": "columns_kernel",
                "rescue_quotients": "quotients_kernel", "combination": "combination_kernel",
                "verify_core": "verify_kernel", "sample_mont": "sample_mont_kernel"}
TILED_STEPS = ("tiled_columns_kernel", "tiled_rows_kernel")   # H8's two launches
RESCUE_BATCHES = (1, 7, 4096)
NTT_SIZES = tuple(1 << k for k in range(14))   # every n H3 takes: its cluster path from 1024 up
NTT_MAIN = (2, 8, 4096)          # the LDE: coset_evaluate of two trace columns
TREE_SIZES = (4, 64, 4096)
TREE_BATCHES = (1, 2, 7)         # codewords of one launch at the main path's size
TREE_MAIN = (8, 4096)            # one FRI-domain codeword: a commitment of the main path
TREE_LARGE = 1 << 22             # the large-trace path's codeword (bench.py:229-236)
PHASES = ("pipeline", "commit", "combination", "fri", "openings")
# the large-trace path: bench.py:229-289 (seg_mimc) proves a MiMC chain of
# 2^20 steps; its omicron domain is 2^22 and its FRI domain 2^24
MIMC_STEPS = 1 << 20
# launched on that path, not in a sign (H1's subtract: the MiMC AIR's glue
# and its boundary quotients; a sign's quotients are H10's)
LARGE_KERNELS = ("merkle", "seed_expand", "fri_fold", "ntt_tiled", "sub_mod")
EXPAND_DEEP = (1 << 16) + 1                 # every seed has counters that need five rounds or more here
EXPAND_MAIN = 1 << 22                       # the 2^20 path's randomizer coefficients: H5's record
# of H5's 10 x 8 G steps, 7 of round 0's are the same for every counter
# and tag: a block computes them once (csrc/merkle.cu:seed_prefix)
EXPAND_HOISTED_G = 7
FOLD_HALF = 1 << 23                         # its top FRI round
NTT_LARGE = (22, 24)                        # log2 of its transforms: the trace iNTT, the LDEs
# H3's shapes inside those transforms under the four-step glue H8
# replaced: n1 rows of n2 points
# (the first pass with the twiddles as its post-scale, the second without)
NTT_INNER = ((4096, 8, 4096), (2048, 8, 2048))
NTT_PAIRED = (32, 8, 8192)                  # the persistent path's two-block instance (more than 16 rows at 8192)
NTT_SPOT_ROWS = 16                          # rows of an inner launch held against the plain transform
# H8 against its plain version, whole: (lead, log2 n, inverse, coset
# table) at the path's trace iNTT and LDEs, and a batch of 3; the first
# LDE is H8's record
TILED_CASES = (((), 24, False, True), ((), 24, True, True), ((), 22, True, False),
               ((3,), 14, False, True), ((3,), 14, True, True))
FRI_TREE_LOGS = range(9, 25)                # the FRI layers of that path the card commits: 2^24 down to 2^9
FOLD_SMALL_LOGS = range(9, 15)              # its small rounds' h (a fold of 2h elements), below the top rounds' 2^15
TREE_PATH = 1 << 24                         # its largest tree: the quotients', FRI's first layer
FOLD_BYTES = 176    # per folded element: c_i, c_{i+h}, u_i read; folded, canon, u_i^2 / 2 written
# batch signing: the JAX package's BASELINE config 5 signs a batch of 64
# (stark_anatomy_tpu/parallel/batch_prover.py:9)
BATCH = 64
FOLD_BATCHED_SHAPES = ((BATCH, 8, 4096), (BATCH, 8, 512))   # a batch's first FRI round, and its last fold
# H4 at a batch's own stacks (parallel/batch_prover.py:_commit): its
# commitment, the R = 2 boundary quotients and the randomizer of each
# proof, and its four FRI layers, 4096 rows down to 512
BATCH_TREES = ((BATCH, 3, 8, 4096),) + tuple((BATCH, 1, 8, 4096 >> r) for r in range(4))
BATCH_KERNELS = ("fri_fold_batched",)        # its record is made, and its launches read, on the batch's path
# H13's draws: a sign's (B = 1: R * nrand + max_degree + 1 = 1536), a
# batch of 64's (98,304, its record) and one
SAMPLE_SIZES = (1, 1536, 64 * 1536)
L2_BYTES = 50 << 20                          # H100 L2: timed inputs rotate over more than twice this
SMALL_BATCH = 3                              # the tests' seeded batch (tests/test_torch_batch_prover.py)
INTERP_SIZES = (16, 256)
FOLD_BATCHED_BYTES = 128    # per folded element: c_i, c_{i+h} read; folded, canon written
BATCH_SPANS = ("hash", "sample", "sample_mont", "device_from_ints", "_boundary_tables", "pipeline",
               "merkle_paired", "root_rows", "combination", "_fri_batch", "fri_fold_batched",
               "limb_rows_np", "queries", "open_linked", "digests", "gather_limbs", "serialize")
LARGE_PHASES = ("trace_gen", "trace_lde", "boundary_quotients", "commit_bq", "air_quotients",
                "randomizer_poly", "commit_randomizer", "combination", "fri", "openings")
# multi-GPU sharding (phase 7): in-process shards on the one card (a
# virtual mesh of cuda:0 repeated), at the topology test's parameters
# (tests/test_topology_invariance.py:59, FRI domain 512) and on the 2^20
# chain (omicron domain 2^22, FRI domain 2^24)
SHARD_COUNTS = (2, 4, 8)
SCALING_SHARDS = (1, 2, 4, 8)
SCALING_REPS = 2
SHARD_SPOT_ROWS = 256                       # rows (H9: columns at each end) of a launch held against the plain version
SHARDED_KERNELS = ("mont_mul", "mont_pow", "add_mod", "sub_mod", "merkle", "seed_expand",
                   "fri_fold", "ntt_tiled", "ntt_columns", "combination")   # every kernel the sharded 2^20 prove launches
SHARDED_ONLY = ("ntt_columns",)              # its record is made, and its launches read, on the sharded path
# the AIR kernels (csrc/air.cu): H10 and H11 launch once in a sign, H12 once
# in a verify, and nothing else of a verify but the result's conversion
VERIFY_KERNELS = ("verify_core",)
# a warm sign (the batch prover at B = 1, its trees on H4), by caller
# (tools/port_compare.py:launches_by_caller): batch_prover.py:_commit H4 5
# (the committed stack and each FRI layer), :_fri_batch H7 3 and H0 1,
# :_prove H0 1; ops/ntt.py:ntt H3 3, :evaluate_domain_horner H0 1 and H1
# 1; rescue_prime.py:_permute H2 2 (the hash and the trace);
# fast_stark.py:_pointwise H0 2, :_trace_lde H0 1; convert.py:
# ints_from_device H0 1; batch.py:pipeline H10 1, :combination H11 1;
# kernels.py:sample_mont H13 1 (the draws).  The benchmark's
# sv.sign_launches reads the same sign's kernels on the card.
SIGN_MAX_LAUNCHES = 24
VERIFY_MAX_LAUNCHES = 3
# H10 a point: 20 products (two of them squarings) and 12 adds or
# subtracts; H11 a point and pair: 2 products and 2 adds, and the first
# term's product
QUOTIENT_OPS = 20 * MUL_OPS + 12 * ADD_OPS
AIR_SPOT = 1 << 16                           # columns of each end of a 2^24 call held against the plain version


def clone_args(x):
    """A copy of a wrapper's argument: tensors cloned (their strides
    kept), tuples element by element, anything else as it is."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(clone_args(v) for v in x)
    return x


def capture_calls(K, names, fn) -> dict:
    """{name: (args, kwargs)} of the first call of each wrapper of ``K``
    in ``names`` during ``fn()``, the tensors copied: the inputs a path
    gives its kernels, to replay against the plain versions."""
    seen = {}
    saved = {name: getattr(K, name) for name in names}

    def wrap(name, wrapper):
        def wrapped(*args, **kwargs):
            if name not in seen:
                seen[name] = (clone_args(args), {k: clone_args(v) for k, v in kwargs.items()})
            return wrapper(*args, **kwargs)
        return wrapped

    for name, wrapper in saved.items():
        setattr(K, name, wrap(name, wrapper))
    try:
        fn()
    finally:
        for name, wrapper in saved.items():
            setattr(K, name, wrapper)
    return seen


def with_specials(x, special):
    """A copy of the limb tensor x (..., 8, n) whose first elements of each
    row are the (8, k) Montgomery limbs ``special``."""
    y = x.clone()
    k = min(special.shape[-1], y.shape[-1])
    y[..., :, :k] = special[:, :k]
    return y


def quotient_rows(batch: int, per_proof: bool) -> int:
    """32-byte limb rows an H10 point moves: a proof's trace (its next
    cycle is the same rows), interp and inv_bz (per proof or shared) and
    bq and tq written, 2 each; c1, c2 (2 each) and inv_tz once."""
    return batch * (6 + (4 if per_proof else 0)) + (0 if per_proof else 4) + 5


def combination_rows(batch: int, c: int, r: int) -> int:
    """32-byte limb rows an H11 point moves: a proof's rand, C + R
    quotients and its output; the C + R shift codewords once."""
    return batch * (2 + c + r) + c + r


def verify_work(K, K_: int, dz: int, di: int, shifts) -> tuple:
    """(32-bit operations, products one thread runs) of H12 at K_ points
    (csrc/air.cu:verify_kernel).  A point's thread runs its products in
    turn: 4 Horner evaluations (2 registers at x and at the next point, dz
    + di steps, a product and an add each) and a product and an add for
    each of the 4 trace values, the AIR (16 products, 10 adds), the inverse
    chain, 2 quotients, each shift's square and multiply, and the weighted
    sum (9 products by a weight, 4 by x^e, 8 adds)."""
    products = (4 * (dz + di) + 4 + 16 + len(K.INV_CHAIN) + 2
                + sum(pow_links(K, e) for e in shifts) + 13)
    adds = 4 * (dz + di) + 4 + 10 + 8
    return K_ * (products * MUL_OPS + adds * ADD_OPS), products


def det_urandom(seed: bytes):
    """Deterministic os.urandom stand-in (counter-mode blake2b stream)."""
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def phase(name: str, start: float) -> None:
    print(f"phase {name}: {time.perf_counter() - start:.3f} s", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_launches(fn, iters: int, warm: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(prof) -> dict:
    """{kernel name: (launches, device microseconds)} from a torch.profiler
    run; empty if the profiler saw no device time."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue                  # host ops: their device time is the kernels'
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = (e.count, us)
    return out


def profile_kernel(name: str, fn, iters: int):
    """Device microseconds per launch of kernel ``name`` over ``iters``
    calls of ``fn``, by the profiler; None if it saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [v for k, v in device_us(prof).items() if PROFILE_TAGS[name] in k]
    if not hits:
        return None
    return sum(us for _, us in hits) / sum(c for c, _ in hits)


def merkle_bound(n: int, batch: int):
    """(least ms, bound) of H4's trees over ``batch`` codewords of n
    elements: 32 bytes read per element and 32 written per flat column,
    and BLAKE2S_INSTR instructions for each of the n - 1 nodes."""
    bytes_ms = 64 * n * batch / HBM_BYTES_PER_S * 1e3
    instr_ms = (n - 1) * batch * BLAKE2S_INSTR / INSTR_PER_S * 1e3
    return max(bytes_ms, instr_ms), ("bytes" if bytes_ms >= instr_ms else "operations")


def host_ms(fn, runs: int) -> float:
    """Median host milliseconds of ``fn`` over ``runs`` calls after one."""
    fn()
    out = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t)
    return statistics.median(out) * 1e3


def hashlib_tree(NB, rows):
    """The root of the paired tree over canonical rows by the plain
    (hashlib) versions of N1's functions."""
    level = NB.leaves_from_limb_pairs_plain(rows)
    while level.shape[0] > 1:
        level = NB.merkle_level_plain(level)
    return level.tobytes()


def fmt_us(us) -> str:
    return f"{us:.3f} us" if us is not None else "not measured"


def bound_ms(numel: int, nbytes: int, ops_per_element: int):
    """(least ms on the card, "bytes" or "operations") for work on
    ``numel`` field elements that moves ``nbytes``."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = numel * ops_per_element / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def ladder_ops(exponent: int) -> int:
    """32-bit operations per element of x^exponent: a squaring for each bit
    after the top one and a product for each multiply of the ladder."""
    return SQR_OPS * (exponent.bit_length() - 1) + MUL_OPS * (bin(exponent).count("1") - 1)


def expand_counts(tile: int) -> tuple:
    """H5's counts: the smallest, a tile's edges in counters (T - 1, T,
    T + 1), each as an odd and an even count, 2^16 + 1, and the record."""
    edges = tuple(2 * c - o for c in (tile - 1, tile, tile + 1) for o in (1, 0))
    return (1, 2, 3, 4097) + edges + (EXPAND_DEEP, EXPAND_MAIN)


def pow_ops(K, exponent: int) -> int:
    """32-bit operations per element of x^exponent on the route the
    kernel takes: the fixed chain's squarings and products for p - 2,
    else the ladder's."""
    if K.pow_route(exponent) == "inv_chain":
        return sum(SQR_OPS if a == b else MUL_OPS for _, a, b in K.INV_CHAIN)
    return ladder_ops(exponent)


def pow_links(K, exponent: int) -> int:
    """Products in one element's dependent chain of x^exponent on the
    card: the fixed chain for p - 2, else the ladder's."""
    if K.pow_route(exponent) == "inv_chain":
        return len(K.INV_CHAIN)
    return max(exponent.bit_length() - 1, 0) + max(bin(exponent).count("1") - 1, 0)


def rescue_ops(batch: int, chain) -> int:
    """32-bit operations of the permutation on ``batch`` states: per round
    and element x^3 (a squaring and a product) and x^ALPHA_INV by the
    steps of ``chain``, two 2x2 MDS (4 products and 2 adds each) and 2
    constant adds per element."""
    chain_ops = sum(SQR_OPS if a == b else MUL_OPS for _, a, b in chain)
    per_round = (2 * (SQR_OPS + MUL_OPS + chain_ops) + 2 * (4 * MUL_OPS + 2 * ADD_OPS)
                 + 4 * ADD_OPS)
    return batch * 27 * per_round


def ntt_ops(batch: int, n: int, scales: int, inverse: bool) -> int:
    """32-bit operations of ``batch`` transforms of n points: n/2 log2(n)
    butterflies (a product, an add, a subtract), and a product per point
    for each scale and for 1/n."""
    butterflies = n // 2 * (n.bit_length() - 1) * (MUL_OPS + 2 * ADD_OPS)
    return batch * (butterflies + n * MUL_OPS * (scales + (inverse and n > 1)))


def columns_ops(shards: int, scaled: bool, inverse: bool) -> int:
    """32-bit operations of one H9 thread, a column of S points
    (csrc/ntt_columns.cu): the pre-scale (S - 1 products by c^(a B), one
    for c^b), the S-point DFT (S/2 log2(S) butterflies, an add and a
    subtract each, with 0, 1, 5 products at S = 2, 4, 8), u = r^b, 1/S
    times c^b, the powers of u and a product an output that is not 1."""
    dft = {1: 0, 2: 0, 4: 1, 8: 5}[shards]
    first = scaled or inverse                     # output 0 has a multiplier
    products = ((shards if scaled else 0) + dft + (scaled and inverse) + (shards > 1)
                + (shards - 1 if first else max(shards - 2, 0)) + shards - 1 + first)
    return products * MUL_OPS + shards * (shards.bit_length() - 1) * ADD_OPS


def profile_sign(sign) -> None:
    """Where one sign's time goes on the card: wall, device busy time and
    the kernels that take it (torch.profiler; 'not measured' if the
    profiler sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sign()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    seen = device_us(prof)
    busy = sum(us for _, us in seen.values()) / 1e6
    launches = sum(c for c, _ in seen.values())
    if not seen:
        print(f"profile of one sign: wall {wall:.4f} s, device time not measured")
        return
    print(f"profile of one sign: wall {wall:.4f} s (under the profiler), device busy "
          f"{busy:.4f} s = {100 * busy / wall:.2f}% of wall, {launches} kernel launches")
    top = sorted(seen.items(), key=lambda kv: -kv[1][1])[:8]
    for key, (count, us) in top:
        print(f"  {us / 1e3:9.3f} ms  {count:6d} launches  {key[:90]}")


# the prover's main steps, and what prove_batch does before its first
# phase: the host Rescue hash of the boundary, the max-degree bound of the
# symbolic AIR, the randomness draws and their upload
HOST_SPANS = ("trace_batch", "pipeline", "merkle_paired", "combination",
              "_fri_batch", "queries", "open_linked", "hash", "max_degree", "sample", "device_from_ints")
# the steps of a large-trace prove: N2's chain, the boundary tables, the
# device FRI's rounds and its copy of the last layer, the query rounds and
# the openings (their gathers and the one sibling walk), the transcript
LARGE_SPANS = ("chain_bytes", "columns_from_words", "_boundary_tables", "_trace_lde",
               "coset_evaluate", "_x_lde_pow", "device_sync", "commit", "fri_fold",
               "merkle_paired", "gather_limbs", "queries", "sample_indices", "open_linked", "digests",
               "serialize")


def host_profile(label: str, fn, spans) -> None:
    """Where one call's host time goes: cumulative seconds of the port's
    functions named in ``spans`` under cProfile.  The profiler slows
    Python code, so the shares are what to read, not the seconds."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = max(ct for (_, _, _, ct, _) in stats.values())
    seen = {}
    for (path, _, func), (_, _, _, ct, _) in stats.items():
        if func in spans and "stark_anatomy_tpu_torch" in path:
            seen[func] = seen.get(func, 0.0) + ct
    parts = ", ".join(f"{f} {seen[f]:.4f} s ({100 * seen[f] / total:.1f}%)" for f in spans if f in seen)
    print(f"host profile of {label} (cProfile): total {total:.4f} s; {parts}")


def field_inputs(shape, seed: int, special=None):
    """Two seeded limb tensors of ``shape`` (CPU) holding values in [0, p);
    their first elements are ``special`` (by default 0, 1, p - 1, p - 2 and
    the Montgomery one, R mod p), in rotated order."""
    import math

    import torch

    from stark_anatomy_tpu_torch.field.limbs import R, ints_to_array
    from stark_anatomy_tpu_torch.field.scalar import P

    rng = random.Random(seed)
    count = math.prod(shape) // 8
    special = list(special) if special is not None else [0, 1, P - 1, P - 2, R % P]
    lead, n = tuple(shape[:-2]), shape[-1]
    out = []
    for rot in range(2):
        vals = [rng.randrange(P) for _ in range(count)]
        k = min(len(special), count)
        vals[:k] = (special[rot:] + special[:rot])[:k]
        rows = torch.from_numpy(ints_to_array(vals, montgomery=False).astype("int32"))
        # (count, 8) element-major -> (*lead, 8, n)
        out.append(rows.reshape(lead + (n, 8)).transpose(-1, -2).contiguous())
    return out


def sample_inputs(n: int, seed: int):
    """n seeded draws as H13 takes them, a CPU (n, 17) uint8 tensor, the
    first the reduction's edges: 0, 2^136 - 1, p - 1, p, p + 1, 2p - 1,
    2^128 - 1, 2^128 and k p - 1, k p, k p + 1 for the largest k with
    k p < 2^136."""
    import torch

    from stark_anatomy_tpu_torch.field.kernels import SAMPLE_BYTES
    from stark_anatomy_tpu_torch.field.scalar import P

    top = 1 << (8 * SAMPLE_BYTES)
    k = (top - 1) // P
    edges = [0, top - 1, P - 1, P, P + 1, 2 * P - 1, (1 << 128) - 1, 1 << 128, k * P - 1, k * P, k * P + 1]
    rng = random.Random(seed)
    data = b"".join(v.to_bytes(SAMPLE_BYTES, "big") for v in edges[:n])
    data += rng.randbytes(SAMPLE_BYTES * max(0, n - len(edges)))
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).view(n, SAMPLE_BYTES)


def kernel_record(name: str, max_abs_err: int, ms: float, plain_ms: float, bound) -> dict:
    """One kernel's entry of the "kernels" line; its launches are filled in
    from the run of the path that launches it.  No PyTorch call computes
    any of these functions, so library_ms is null."""
    from stark_anatomy_tpu_torch.field import kernels as K

    source = os.path.basename(K.SOURCES[K.LIBRARY[name]])
    return {"name": name, "route": "cuda", "source": "stark_anatomy_tpu_torch/csrc/" + source,
            "replaces": KERNEL_INFO[name][0], "launches": None, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None}


def random_codeword(shape, seed: int, dev):
    """A seeded (…, 8, n) limb tensor on the card, every value below p (the
    top limb below p's)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 1 << 16, shape, generator=gen, device=dev, dtype=torch.int32)
    x[..., 7, :] &= 0x3FFF
    return x


def seed_tensor(label: bytes, dev):
    """The 8 int32 words of a 32-byte seed, on the card."""
    import numpy as np
    import torch

    words = np.frombuffer(hashlib.blake2s(label).digest(), dtype="<u4").view(np.int32).copy()
    return torch.from_numpy(words).to(dev)


def expand_depth(MK, seed, count: int) -> int:
    """The deepest round tag the plain rejection loop reaches."""
    ok = MK.below_p_plain(MK.expand_candidates_plain(seed, count, 0))
    r = 0
    while not bool(ok.all()):
        r += 1
        ok |= MK.below_p_plain(MK.expand_candidates_plain(seed, count, r))
    return r


def profile_all(fn):
    """(wall s, device busy s, {kernel name: (launches, us)}) of one call of
    ``fn`` under torch.profiler; busy is None if it saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    seen = device_us(prof)
    return wall, (sum(us for _, us in seen.values()) / 1e6 if seen else None), seen


def check_tiled(compare, label, x, inverse, pre, post):
    """H8's two steps on the card against its plain version on the same
    inputs, whole (step 1 from the plain step 0's output); returns (both
    steps on the card, both steps of the plain version) as functions."""
    import torch

    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.ops.ntt import tiled_tables

    n1, inner, twiddles, outer, n_inv = tiled_tables(x.shape[-1], inverse, x.device)
    y = K.ntt_tiled(x, 0, n1, inner, twiddles, scale=pre)
    torch.cuda.synchronize()
    want = K.ntt_tiled_plain(x, 0, n1, inner, twiddles, scale=pre)
    compare("ntt_tiled", f"{label} step 0 (columns) against plain", y, want)
    del y
    z = K.ntt_tiled(want, 1, n1, outer, n_inv=n_inv, scale=post)
    torch.cuda.synchronize()
    compare("ntt_tiled", f"{label} step 1 (rows) against plain", z,
            K.ntt_tiled_plain(want, 1, n1, outer, n_inv=n_inv, scale=post))
    del z, want

    def run():
        return K.ntt_tiled(K.ntt_tiled(x, 0, n1, inner, twiddles, scale=pre), 1, n1, outer,
                           n_inv=n_inv, scale=post)

    def plain():
        return K.ntt_tiled_plain(K.ntt_tiled_plain(x, 0, n1, inner, twiddles, scale=pre), 1, n1, outer,
                                 n_inv=n_inv, scale=post)

    return run, plain


def profile_steps(fn, iters: int) -> list:
    """Device microseconds per launch of each of H8's steps (TILED_STEPS)
    over ``iters`` calls of ``fn`` (torch.profiler; None where it saw
    none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    seen = device_us(prof)
    out = []
    for tag in TILED_STEPS:
        hits = [v for k, v in seen.items() if tag in k]
        out.append(sum(us for _, us in hits) / sum(c for c, _ in hits) if hits else None)
    return out


def air_bound(name: str, args) -> tuple:
    """(bound, what it counts) of one call of an AIR kernel on ``args``
    (the wrapper's positional arguments), from the shapes: H10's and
    H11's rows (quotient_rows, combination_rows) and operations a point;
    H12's bytes and verify_work's operations."""
    if name == "rescue_quotients":
        trace, interp = args[0], args[1]
        n = trace.shape[-1]
        batch = trace.numel() // (16 * n)
        rows = quotient_rows(batch, interp.dim() == 4)
        return bound_ms(1, rows * n * 32, batch * n * QUOTIENT_OPS), f"{rows} rows of {n}"
    if name == "combination":
        rand, tq, bq, weights = args[0], args[1], args[2], args[5]
        n = rand.shape[-1]
        batch, c, r = rand.numel() // (8 * n), tq.shape[-3], bq.shape[-3]
        rows = combination_rows(batch, c, r)
        ops = batch * n * ((1 + 2 * (c + r)) * MUL_OPS + 2 * (c + r) * ADD_OPS)
        return bound_ms(1, rows * n * 32 + weights.numel() * 4, ops), f"{rows} rows of {n}"
    from stark_anatomy_tpu_torch.field import kernels as K

    vals, bz, ip, weights, idx, tables, tq_sh, bq_sh = args
    k = idx.shape[0]
    ops, products = verify_work(K, k, bz.shape[-1], ip.shape[-1], tuple(tq_sh) + tuple(bq_sh))
    nbytes = 4 * (vals.numel() + bz.numel() + ip.numel() + weights.numel()) + 8 * k + 4 * 32 * k + 32 * k
    return bound_ms(1, nbytes, ops), f"K = {k}, {products} products a thread in turn"


def air_edges(name: str, args, special):
    """The call ``args`` with the special values (the (8, 5) limbs of 0, 1,
    p - 1, p - 2, R mod p) in front of every operand row, in rotated orders
    so that each meets the others (a zero minuend and subtrahend, p - 1
    against 1); H11's first five weights, H12's first five points and
    values of each part (a zero transition-zerofier value among them: its
    inverse is taken as 0)."""
    import torch

    def rot(k):
        return torch.roll(special, k, dims=-1)

    if name == "rescue_quotients":
        trace, interp, inv_bz, inv_tz, tables, *rest = args
        c1, c2, mds, mds_inv = tables
        rest = list(rest)
        if len(rest) > 1 and rest[1] is not None:
            rest[1] = with_specials(rest[1], rot(3))
        return (with_specials(trace, rot(0)), with_specials(interp, rot(1)), with_specials(inv_bz, rot(2)),
                with_specials(inv_tz, rot(3)), (with_specials(c1, rot(4)), with_specials(c2, rot(1)), mds, mds_inv),
                *rest)
    if name == "combination":
        weights = args[5].clone()
        k = min(5, weights.shape[-3])
        weights[..., :k, :, 0] = special[:, :k].t()
        return tuple(with_specials(x, rot(i)) for i, x in enumerate(args[:5])) + (weights,)
    vals, *rest = args
    k = rest[3].shape[0]
    vals = vals.clone()
    for part in range(vals.shape[-1] // k):
        vals[:, part * k:part * k + min(5, k)] = rot(part)[:, :min(5, k)]
    return (vals, *rest)


def check_air(name, label, args, kwargs, compare) -> None:
    """An AIR kernel on ``args`` against its plain version on the same
    inputs, on the card; each output compared."""
    import torch

    from stark_anatomy_tpu_torch.field import kernels as K

    got = getattr(K, name)(*args, **kwargs)
    torch.cuda.synchronize()
    want = K.PLAIN[name](*args, **kwargs)
    if isinstance(got, tuple):
        for part, g, w in zip(("bq", "tq"), got, want):
            compare(name, f"{label} {part}", g, w)
    else:
        compare(name, label, got, want)


def air_path(dev, smi, records, worst_err, compare, scheme, sk, pk, sig) -> None:
    """Phase 2's AIR kernels at the main path's inputs: H10 and H11 as one
    sign gives them, H12 as one verify does (captured from the wrappers'
    calls), each against its plain version on the card, then with the
    special values in front; H10 also with the next rows as their own
    operand (the sharded prover's form); each timed beside its bound,
    which gives its record."""
    import torch

    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field.limbs import R
    from stark_anatomy_tpu_torch.field.scalar import P
    from stark_anatomy_tpu_torch.utils.convert import device_from_ints

    calls = capture_calls(K, K.AIR_KERNELS, lambda: (scheme.sign(sk, DOC), scheme.verify(pk, DOC, sig)))
    special = device_from_ints([0, 1, P - 1, P - 2, R % P], dev)
    for name in K.AIR_KERNELS:
        args, kwargs = calls[name]
        shape = tuple(args[0].shape)
        check_air(name, f"{shape} as the path gives it", args, kwargs, compare)
        check_air(name, f"{shape} with the special values", air_edges(name, args, special), kwargs, compare)
        if name == "rescue_quotients":
            trace, shift = args[0], args[5]
            explicit = args[:5] + (0, torch.roll(trace, -shift, dims=-1))
            check_air(name, f"{shape} with the next rows given (shift 0)", explicit, {}, compare)
        kern, plain = getattr(K, name), K.PLAIN[name]
        ms = time_launches(lambda: kern(*args, **kwargs), 200)
        dev_us = profile_kernel(name, lambda: kern(*args, **kwargs), 50)
        plain_ms = time_launches(lambda: plain(*args, **kwargs), 3, warm=1)
        bound, what = air_bound(name, args)
        records[name] = kernel_record(name, worst_err[name], ms, plain_ms, bound)
        print(f"  {name} {shape} ({what}): {ms:.6f} ms/launch (CUDA events), device {fmt_us(dev_us)}/launch, "
              f"plain {plain_ms:.3f} ms, bound {bound[0]:.9f} ms ({bound[1]}) on {smi}")


def large_path(dev, smi, records, worst_err, compare) -> None:
    """Phase 5: the large-trace path's kernels against their plain
    versions, the four-step NTT, the card against the CPU with every large
    branch forced, the 2^20-step MiMC proof and the pipelined prover."""
    import torch

    from stark_anatomy_tpu_torch.commit import kernels as MK
    from stark_anatomy_tpu_torch.commit.device_merkle import device_commit_paired
    from stark_anatomy_tpu_torch.commit.merkle import MerkleTree
    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field.scalar import Field, FieldElement, P
    from stark_anatomy_tpu_torch.models import mimc as MM
    from stark_anatomy_tpu_torch.ops import ntt as NTT
    from stark_anatomy_tpu_torch.ops.domain import DOMAINS, coset_table
    from stark_anatomy_tpu_torch.parallel.pipeline_prover import PipelinedMiMCProver
    from stark_anatomy_tpu_torch.utils.convert import canonical_np, device_from_ints, ints_from_device

    def record(name, ms, plain_ms, bound):
        return kernel_record(name, worst_err[name], ms, plain_ms, bound)

    # H5 against its plain version on the card; the plain version counts
    # the compressions its threads need (one per counter and round until
    # both elements are accepted), which the bound counts
    seed = seed_tensor(b"chip smoke seed expansion", dev)
    for count in expand_counts(MK.EXPAND_TILE):
        got = MK.seed_expand(seed, count)
        torch.cuda.synchronize()
        rounds = []
        want = MK.seed_expand_plain(seed, count, rounds)
        if count > 4096:
            assert rounds[0] > (count + 1) // 2, "round 0 rejected no candidate: pick another seed"
        label = f"count={count} ({rounds[0]} compressions)"
        if count == EXPAND_DEEP:
            depth = expand_depth(MK, seed, count)
            assert depth >= 4, f"at {count} elements the deepest round is {depth}: pick another seed"
            label += f", deepest round {depth}"
        compare("seed_expand", label, got, want)
    count = EXPAND_MAIN
    ms = time_launches(lambda: MK.seed_expand(seed, count), 20)
    dev_us = profile_kernel("seed_expand", lambda: MK.seed_expand(seed, count), 10)
    plain_ms = time_launches(lambda: MK.seed_expand_plain(seed, count), 1, warm=0)
    # the work this design does: each compression less the hoisted G
    # steps, and those steps once a block
    hoisted = EXPAND_HOISTED_G * BLAKE2S_INSTR // 80
    blocks = -(-((count + 1) // 2) // MK.EXPAND_TILE)
    instr = rounds[0] * (BLAKE2S_INSTR - hoisted) + blocks * hoisted
    bytes_ms = (32 * count + 32) / HBM_BYTES_PER_S * 1e3
    ops_ms = (instr / INSTR_PER_S + count * MUL_OPS / INT32_OPS_PER_S) * 1e3
    bound = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")
    unhoisted_ms = (rounds[0] * BLAKE2S_INSTR / INSTR_PER_S + count * MUL_OPS / INT32_OPS_PER_S) * 1e3
    records["seed_expand"] = record("seed_expand", ms, plain_ms, bound)
    print(f"  seed_expand count={count}: {ms:.6f} ms/launch, device {fmt_us(dev_us)}/launch, "
          f"plain {plain_ms:.3f} ms, bound {bound[0]:.6f} ms ({bound[1]}: {rounds[0]} compressions x "
          f"{BLAKE2S_INSTR - hoisted} instructions + {blocks} blocks x {hoisted}, {count} Montgomery "
          f"conversions; {unhoisted_ms:.6f} ms at {BLAKE2S_INSTR} a compression) on {smi}")

    # H6 at the top round of the 2^20 path
    cw = random_codeword((8, 2 * FOLD_HALF), 3030, dev)
    u = random_codeword((8, FOLD_HALF), 3031, dev)
    alpha = random.Random(3032).randrange(P)
    got = K.fri_fold(cw, u, alpha)
    torch.cuda.synchronize()
    want = K.fri_fold_plain(cw, u, alpha)
    for label, g, w in zip(("folded", "canonical", "u^2"), got, want):
        compare("fri_fold", f"h=2^{FOLD_HALF.bit_length() - 1} {label}", g, w)
    del got, want
    # the small rounds, which the card folds down to the path's last layer
    for log_h in FOLD_SMALL_LOGS:
        h = 1 << log_h
        small_cw, small_u = random_codeword((8, 2 * h), 3060 + log_h, dev), random_codeword((8, h), 3070 + log_h, dev)
        got = K.fri_fold(small_cw, small_u, alpha)
        torch.cuda.synchronize()
        want = K.fri_fold_plain(small_cw, small_u, alpha)
        for label, g, w in zip(("folded", "canonical", "u^2"), got, want):
            compare("fri_fold", f"h=2^{log_h} {label}", g, w)
        del small_cw, small_u, got, want
    ms = time_launches(lambda: K.fri_fold(cw, u, alpha), 20)
    dev_us = profile_kernel("fri_fold", lambda: K.fri_fold(cw, u, alpha), 10)
    plain_ms = time_launches(lambda: K.fri_fold_plain(cw, u, alpha), 1, warm=0)
    ops = FOLD_HALF * (4 * MUL_OPS + 3 * ADD_OPS) + FOLD_HALF // 2 * SQR_OPS
    bound = bound_ms(1, FOLD_BYTES * FOLD_HALF, ops)
    records["fri_fold"] = record("fri_fold", ms, plain_ms, bound)
    print(f"  fri_fold h=2^{FOLD_HALF.bit_length() - 1}: {ms:.6f} ms/launch, device {fmt_us(dev_us)}/launch, plain "
          f"{plain_ms:.3f} ms, bound {bound[0]:.6f} ms ({bound[1]}: {FOLD_BYTES} bytes per element)")
    del cw, u
    # H4 at every FRI layer the path commits on the card (2^24, its largest
    # codeword, down to 2^9): the flat tree against the plain version on
    # the card, the root against N1's tree of the same canonical rows; the
    # largest gives its record, in place of phase 1's
    for log_n in FRI_TREE_LOGS:
        n = 1 << log_n
        cw = random_codeword((8, n), 3040 + log_n, dev)
        rows, dtree = device_commit_paired(cw)
        want = []
        plain_ms = time_launches(lambda: want.append(MK.merkle_paired_plain(rows.canon)), 1, warm=0)
        compare("merkle", f"(8, 2^{log_n}) against plain", dtree.flat, want[0])
        del want
        assert dtree.root == MerkleTree.from_limbs_paired(canonical_np(cw)).root, \
            f"H4's root at 2^{log_n} differs from N1's"
        canon = rows.canon
        dev_us = profile_kernel("merkle", lambda: MK.merkle_paired(canon), 5)
        bound = merkle_bound(n, 1)
        line = (f"  merkle (8, 2^{log_n}): root equals N1's; device {fmt_us(dev_us)}/commit "
                f"(1 launch, {len(MK.tree_stages(n))} stages), bound {bound[0]:.6f} ms ({bound[1]})")
        if n == TREE_PATH:
            ms = time_launches(lambda: MK.merkle_paired(canon), 10)
            records["merkle"] = record("merkle", ms, plain_ms, bound)
            line += f", {ms:.6f} ms/commit (CUDA events), plain {plain_ms:.3f} ms"
        print(line)
        del cw, rows, dtree, canon
    assert not any(bool(c.any()) for c in MK._COUNTERS.values()), "H4 left a ticket counted"
    torch.cuda.empty_cache()

    # H3's persistent path at the inner shapes of the four-step glue that
    # H8 replaced (large batches of 4096 and 2048 points), and its
    # two-block instance at 8192: NTT_SPOT_ROWS seeded rows of each launch
    # against the plain transform on the card, with the twiddle post-scale
    # (a row each) and without.  Bound: the input, the output and the
    # post-scale rows once, the butterflies and a product a point for the
    # scale.
    for batch, _, n in NTT_INNER + (NTT_PAIRED,):
        x, post = (random_codeword((batch, 8, n), 3150 + n + k, dev) for k in range(2))
        dom = DOMAINS.get(n, dev)
        rows = sorted(random.Random(3160 + n).sample(range(batch), NTT_SPOT_ROWS))
        plan = K.ntt_plan(batch, n.bit_length() - 1, torch.cuda.get_device_properties(dev).multi_processor_count)
        for scaled in (True, False):
            args = (dom["fwd_powers"], None, None, post if scaled else None)
            got = K.ntt(x, *args)
            want = K.ntt_plain(x[rows], args[0], None, None, post[rows] if scaled else None)
            compare("ntt", f"({batch}, 8, {n}){' post-scaled' if scaled else ''}, {NTT_SPOT_ROWS} rows "
                    f"against plain ({plan[0]} path, {plan[1]} blocks a row)", got[rows], want)
            dev_us = profile_kernel("ntt", lambda: K.ntt(x, *args), 10)
            nbytes = (2 + scaled) * batch * n * 32 + n * 16
            bound = bound_ms(1, nbytes, ntt_ops(batch, n, int(scaled), False))
            print(f"  ntt ({batch}, 8, {n}){' post-scaled' if scaled else ''}: device {fmt_us(dev_us)}/launch "
                  f"(1 launch), bound {bound[0]:.6f} ms ({bound[1]})")
        del x, post, got, want
    torch.cuda.empty_cache()

    # the four-step NTT: against H3's single-launch path at 8192 with the
    # threshold lowered, against the plain transform at 2^16, and at 2^22
    # and 2^24 by the round trip and host-computed spot values
    for batch in (1, 2):
        x, post = (random_codeword((batch, 8, 8192), 3100 + batch + k, dev) for k in range(2))
        pre = random_codeword((8, 8192), 3110 + batch, dev)
        for inverse in (False, True):
            want = NTT.ntt(x, inverse, pre, post[0])
            saved, NTT.NTT_MAX = NTT.NTT_MAX, 64
            try:
                K.reset_launch_counts()
                got = NTT.ntt(x, inverse, pre, post[0])
                torch.cuda.synchronize()
                tiled = K.LAUNCHES["ntt_tiled"]
                want_cpu = NTT.ntt(x.cpu(), inverse, pre.cpu(), post[0].cpu())   # H8's plain version
            finally:
                NTT.NTT_MAX = saved
            assert tiled > 0, "the threshold-64 route launched no H8"
            compare("ntt", f"four-step n=8192 batch={batch} {'inverse' if inverse else 'forward'} "
                    f"scaled, threshold 64, against one launch", got, want)
            compare("ntt_tiled", f"threshold-64 route n=8192 batch={batch} {'inverse' if inverse else 'forward'} "
                    f"scaled ({tiled} H8 launches: rows of 128 points) against the route on the CPU", got, want_cpu)
    n = 1 << 16
    x, pre = random_codeword((8, n), 3120, dev), random_codeword((8, n), 3121, dev)
    for inverse in (False, True):
        dom = DOMAINS.get(n, dev)
        want = K.ntt_plain(x, dom["inv_powers" if inverse else "fwd_powers"],
                           dom["n_inv"] if inverse else None, pre, None)
        compare("ntt", f"four-step n=2^16 {'inverse' if inverse else 'forward'} against plain",
                NTT.ntt(x, inverse, pre), want)
    field = Field.main()
    g = field.generator().value
    rng = random.Random(3130)
    for log_n in NTT_LARGE:
        n = 1 << log_n
        x = random_codeword((8, n), 3140 + log_n, dev)
        back = NTT.intt(NTT.ntt(x))
        torch.cuda.synchronize()
        assert torch.equal(back, x), f"the four-step round trip at 2^{log_n} changed the values"
        terms = {rng.randrange(n): rng.randrange(P) for _ in range(6)}
        c = torch.zeros((8, n), dtype=torch.int32, device=dev)
        c[:, list(terms)] = device_from_ints(list(terms.values()), dev)
        w = field.primitive_nth_root(n).value
        ks = [0, 1, n - 1] + [rng.randrange(n) for _ in range(5)]
        for label, got, base in (("ntt", NTT.ntt(c), 1), ("coset_evaluate", NTT.coset_evaluate(c, g, n), g)):
            vals = ints_from_device(got[:, ks])
            for k, v in zip(ks, vals):
                point = base * pow(w, k, P) % P
                assert v == sum(a * pow(point, i, P) for i, a in terms.items()) % P, \
                    f"{label} at 2^{log_n}: spot value {k} differs from the host's"
        # the path's shapes: the trace iNTT at M, the LDEs at N.  Bound:
        # the input and output once (and the coset table), the butterflies
        # and a product per point for 1/n or the scale
        inv = log_n == NTT_LARGE[0]
        call = (lambda: NTT.intt(x)) if inv else (lambda: NTT.coset_evaluate(x, g, n))
        ms = time_launches(call, 5)
        wall, busy, _ = profile_all(call)
        bound = bound_ms(1, (2 if inv else 3) * 32 * n, ntt_ops(1, n, 0 if inv else 1, inv))
        # one call on the card's route: two H8 launches and nothing else
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        assert launches == {"ntt_tiled": 2}, f"the 2^{log_n} transform's launches: {launches}"
        print(f"  four-step {'intt' if inv else 'coset_evaluate'} n=2^{log_n}: round trip and 8 spot "
              f"values of ntt and coset_evaluate equal the host's; {ms:.4f} ms/call (CUDA events), "
              f"device busy {fmt_us(None if busy is None else busy * 1e6)} of one call, bound "
              f"{bound[0]:.6f} ms ({bound[1]}); launches {launches}, transient peak "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**20:.1f} MiB")
    del x, back, c
    torch.cuda.empty_cache()

    # H8 step by step against its plain version, whole, at the path's
    # transforms and a batch of 3; then both steps' time (CUDA events),
    # each step's device time, the plain version's time and the bound as
    # for the four-step rows above (the input, the output and the coset
    # table once; the butterflies and a product a point for the scale or
    # 1/n).  The first case, the 2^24 LDE, gives H8's record.
    for lead, log_n, inverse, coset in TILED_CASES:
        n = 1 << log_n
        x = random_codeword(lead + (8, n), 3200 + log_n + inverse, dev)
        table = coset_table(g, n, dev, inverse) if coset else None
        pre, post = (None, table) if inverse else (table, None)
        label = f"{lead + (8, n)} {'inverse' if inverse else 'forward'}{' coset' if coset else ''}"
        run, plain = check_tiled(compare, label, x, inverse, pre, post)
        ms = time_launches(run, 10)
        steps_us = profile_steps(run, 5)
        plain_ms = time_launches(plain, 1, warm=0)
        batch = x.numel() // (8 * n)
        bound = bound_ms(1, (2 * batch + coset) * 32 * n, ntt_ops(batch, n, int(coset), inverse))
        if (lead, log_n, inverse, coset) == TILED_CASES[0]:
            records["ntt_tiled"] = record("ntt_tiled", ms, plain_ms, bound)
        print(f"  ntt_tiled {label}: {ms:.6f} ms/transform (2 launches, CUDA events), device step 0 "
              f"{fmt_us(steps_us[0])}, step 1 {fmt_us(steps_us[1])}; plain {plain_ms:.3f} ms; bound "
              f"{bound[0]:.6f} ms ({bound[1]}) on {smi}")
        del x, run, plain
    torch.cuda.empty_cache()

    # H11 at the 2^20 prove's combination (C = R = 1, FRI domain 2^24, 6 x
    # 512 MiB): the first and last AIR_SPOT columns against the plain
    # version on the same columns (the function is pointwise), with the
    # special values in front; its time beside the bound
    n = 1 << NTT_LARGE[1]
    cw = [random_codeword(shape, 3300 + k, dev)
          for k, shape in enumerate(((8, n), (1, 8, n), (1, 8, n), (1, 8, n), (1, 8, n), (5, 8, 1)))]
    special = device_from_ints([0, 1, P - 1, P - 2, (1 << 128) % P], dev)
    edge = air_edges("combination", tuple(cw), special)
    for label, args in (("random", tuple(cw)), ("with the special values", edge)):
        got = K.combination(*args)
        torch.cuda.synchronize()
        for lo in (0, n - AIR_SPOT):
            part = [x[..., lo:lo + AIR_SPOT] for x in args[:5]] + [args[5]]
            compare("combination", f"(8, 2^{NTT_LARGE[1]}) C = R = 1 {label}, columns [{lo}, {lo + AIR_SPOT}) "
                    f"against plain", got[..., lo:lo + AIR_SPOT], K.combination_plain(*part))
        del got
    del edge
    ms = time_launches(lambda: K.combination(*cw), 10)
    dev_us = profile_kernel("combination", lambda: K.combination(*cw), 5)
    bound, what = air_bound("combination", cw)
    print(f"  combination (8, 2^{NTT_LARGE[1]}), C = R = 1 ({what}): {ms:.6f} ms/launch (CUDA events), device "
          f"{fmt_us(dev_us)}/launch, bound {bound[0]:.6f} ms ({bound[1]}) on {smi}")
    del cw
    torch.cuda.empty_cache()

    # the card against the CPU with every large branch forced
    x_small = FieldElement(rng.randrange(P), field)
    proofs = {}
    saved = (NTT.NTT_MAX, NTT.HOST_ZEROFIER_MAX)
    os.environ["STARK_TPU_DEVICE_HASH"] = "1"
    NTT.NTT_MAX, NTT.HOST_ZEROFIER_MAX = 8, 1
    try:
        for label, device in (("card", dev), ("cpu", "cpu")):
            mimc, stark = MM.make_stark(15, 4, 4, 8, device=device)
            stark.bulk_randomizer_threshold = 0
            out, proof, tz = MM.prove_chain(mimc, stark, x_small, urandom=det_urandom(b"chip smoke mimc"))
            assert MM.verify_chain(mimc, stark, x_small, out, proof, tz.root), f"the {label} rejected its proof"
            proofs[label] = (mimc, stark, tz, out, proof)
    finally:
        del os.environ["STARK_TPU_DEVICE_HASH"]
        NTT.NTT_MAX, NTT.HOST_ZEROFIER_MAX = saved
    (cm, cs, ctz, cout, cproof), (hm, hs, htz, hout, hproof) = proofs["card"], proofs["cpu"]
    assert cproof == hproof and ctz.root == htz.root, "the card and the CPU proved different bytes"
    assert MM.verify_chain(cm, cs, x_small, hout, hproof, ctz.root), "the card rejected the CPU's proof"
    assert MM.verify_chain(hm, hs, x_small, cout, cproof, htz.root), "the CPU rejected the card's proof"
    print(f"  MiMC make_stark(15, 4, 4, 8), every large branch forced: card and CPU proofs identical "
          f"({len(cproof)} bytes), cross-verified")

    # the 2^20-step chain at the production parameters
    mimc, stark = MM.make_stark(MIMC_STEPS)
    print(f"  MiMC {MIMC_STEPS} steps: trace {stark.original_trace_length}, omicron domain {stark.omicron_domain_length}, "
          f"FRI domain {stark.fri_domain_length}")
    x = FieldElement(rng.randrange(P), field)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t = time.perf_counter()
    tz = stark.preprocess()
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t
    t = time.perf_counter()
    out, proof, _ = MM.prove_chain(mimc, stark, x, tz, urandom=det_urandom(b"chip smoke 2^20"))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    ok = MM.verify_chain(mimc, stark, x, out, proof, tz.root)
    verify_s = time.perf_counter() - t
    path_launches = dict(K.LAUNCHES)
    assert ok, f"verify rejected the large proof: {stark.last_rejection}"
    print(f"  launches in the large path (preprocess, prove, verify): {path_launches}")
    # every transform of this path is above 8192 points: H8's, not H3's
    for name in ("mont_mul", "mont_pow", "add_mod", "sub_mod", "ntt_tiled", "merkle", "seed_expand", "fri_fold",
                 "combination"):
        assert path_launches[name] > 0, f"{name} was not launched on the large path"
    for name in LARGE_KERNELS:
        records[name]["launches"] = path_launches[name]
    t = time.perf_counter()
    assert out == mimc.forward(x), "the chain's output differs from the scalar chain"
    forward_s = time.perf_counter() - t
    assert not MM.verify_chain(mimc, stark, x, out + field.one(), proof, tz.root), \
        "verify accepted a false output"
    print(f"  MiMC {MIMC_STEPS} steps: preprocess {pre_s:.3f} s, first prove {first_s:.3f} s, verify {verify_s:.3f} s, "
          f"proof {len(proof)} bytes; output equals the scalar chain ({forward_s:.1f} s on the host); "
          f"a false output is rejected")
    prove_s, phase_rows = [], []
    for k in range(3):
        stark.timer.totals.clear()
        stark.timer.counts.clear()
        xs = FieldElement(rng.randrange(P), field)
        t = time.perf_counter()
        o, pr, _ = MM.prove_chain(mimc, stark, xs, tz)
        torch.cuda.synchronize()
        prove_s.append(time.perf_counter() - t)
        phase_rows.append(dict(stark.timer.totals))
        t = time.perf_counter()
        assert MM.verify_chain(mimc, stark, xs, o, pr, tz.root)
        verify_s = time.perf_counter() - t
        total = sum(phase_rows[-1].values())
        print(f"  steady prove {k}: {prove_s[-1]:.4f} s, verify {verify_s:.4f} s; phases (s): "
              + ", ".join(f"{p} {phase_rows[-1].get(p, 0.0):.4f}" for p in LARGE_PHASES)
              + f"; sum {100 * total / prove_s[-1]:.1f}% of the prove")
    print(f"MiMC {MIMC_STEPS} steps: steady prove seconds (median of 3): {statistics.median(prove_s):.4f} {prove_s} on {smi}")
    print(f"MiMC {MIMC_STEPS} steps: peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"(max_memory_allocated)")
    # each of the next three proves a new statement, as a stream of proofs does
    K.reset_launch_counts()
    MM.prove_chain(mimc, stark, FieldElement(rng.randrange(P), field), tz)
    torch.cuda.synchronize()
    print(f"  kernel launches in one steady prove: {sum(K.LAUNCHES.values())} {dict(K.LAUNCHES)}")
    xs = FieldElement(rng.randrange(P), field)
    wall, busy, seen = profile_all(lambda: MM.prove_chain(mimc, stark, xs, tz))
    if busy is None:
        print(f"  profile of one steady prove: wall {wall:.4f} s, device time not measured")
    else:
        print(f"  profile of one steady prove: wall {wall:.4f} s (under the profiler), device busy "
              f"{busy:.4f} s = {100 * busy / wall:.2f}% of wall, "
              f"{sum(c for c, _ in seen.values())} device launches")
        for key, (cnt, us) in sorted(seen.items(), key=lambda kv: -kv[1][1])[:12]:
            print(f"  {us / 1e3:9.3f} ms  {cnt:6d} launches  {key[:90]}")

    xs = FieldElement(rng.randrange(P), field)
    host_profile("one steady prove", lambda: MM.prove_chain(mimc, stark, xs, tz), LARGE_SPANS)

    # the pipelined prover over four statements against four serial proves
    inputs = [FieldElement(rng.randrange(P), field) for _ in range(4)]
    t = time.perf_counter()
    for xs in inputs:
        MM.prove_chain(mimc, stark, xs, tz)
    torch.cuda.synchronize()
    serial_s = (time.perf_counter() - t) / len(inputs)
    prover = PipelinedMiMCProver(mimc, stark, tz)
    try:
        t = time.perf_counter()
        results = prover.prove_many(inputs)
        torch.cuda.synchronize()
        pipe_s = (time.perf_counter() - t) / len(inputs)
    finally:
        prover.close()
    for xs, (o, pr) in zip(inputs, results):
        assert MM.verify_chain(mimc, stark, xs, o, pr, tz.root), "a pipelined proof did not verify"
    print(f"MiMC {MIMC_STEPS} steps: pipelined prover: {pipe_s:.4f} s per proof against serial {serial_s:.4f} s "
          f"over {len(inputs)} statements, every proof verified, on {smi}")


def batch_path(dev, smi, records, worst_err, compare, scheme) -> None:
    """Phase 6: H7 against its plain version, a production batch of 64
    signatures, the card against the CPU (a small batch, the slow Stark,
    the entry's core) and interpolate_generic's round trips."""
    import torch

    from stark_anatomy_tpu_torch.entry import entry
    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field import ops as F
    from stark_anatomy_tpu_torch.field.scalar import Field, P
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
    from stark_anatomy_tpu_torch.ops import evaluate_generic, interpolate_generic
    from stark_anatomy_tpu_torch.ops.interpolate import _synthetic_divide_all, _tree_sum_last
    from stark_anatomy_tpu_torch.ops.ntt import zerofier
    from stark_anatomy_tpu_torch.parallel.batch_prover import BatchProver, make_batch_rpsss
    from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark
    from stark_anatomy_tpu_torch.protocols.stark import Stark
    from stark_anatomy_tpu_torch.transcript.proof_stream import SignatureProofStream
    from stark_anatomy_tpu_torch.utils.convert import device_from_ints, ints_from_device

    # H7 against its plain version, both on the card: the special values at
    # the start of every codeword, of its second half (their fold partners)
    # and of u; the challenges distinct, 0, 1 and p - 1 first.  The timed
    # launches rotate over codewords of more than twice the L2 in all, so
    # each reads its input from device memory, as its byte bound counts.
    rng = random.Random(6000)
    special = device_from_ints([0, 1, P - 1], dev)
    for k, (batch, _, n) in enumerate(FOLD_BATCHED_SHAPES):
        h = n // 2
        cw = random_codeword((batch, 8, n), 6010 + k, dev)
        u = random_codeword((8, h), 6020 + k, dev)
        cw[:, :, :3] = special
        cw[:, :, h:h + 3] = special
        u[:, :3] = special
        alphas = [0, 1, P - 1] + [rng.randrange(P) for _ in range(batch - 3)]
        assert len(set(alphas)) == batch
        al = device_from_ints(alphas, dev).t().contiguous().unsqueeze(-1)
        got = K.fri_fold_batched(cw, u, al)
        torch.cuda.synchronize()
        want = K.fri_fold_batched_plain(cw, u, al)
        for label, g, w in zip(("folded", "canonical", "u^2"), got, want):
            compare("fri_fold_batched", f"({batch}, 8, {n}) {label}", g, w)
        n_sets = 2 * L2_BYTES // (cw.numel() * 4) + 1
        cws = itertools.cycle([cw] + [random_codeword((batch, 8, n), 6100 + 100 * k + j, dev)
                                      for j in range(1, n_sets)])
        launch = lambda: K.fri_fold_batched(next(cws), u, al)
        ms = time_launches(launch, 200)
        dev_us = profile_kernel("fri_fold_batched", launch, 50)
        plain_ms = time_launches(lambda: K.fri_fold_batched_plain(cw, u, al), 3, warm=1)
        t = time.perf_counter()
        for _ in range(200):
            launch()
        enqueue_us = (time.perf_counter() - t) / 200 * 1e6
        torch.cuda.synchronize()
        # bytes: the codewords and u read once, the challenges, both outputs
        # and u^2 written once
        nbytes = FOLD_BATCHED_BYTES * batch * h + 48 * h + 32 * batch
        ops = batch * h * (4 * MUL_OPS + 3 * ADD_OPS) + h // 2 * SQR_OPS
        bound = bound_ms(1, nbytes, ops)
        if k == 0:
            records["fri_fold_batched"] = kernel_record("fri_fold_batched", worst_err["fri_fold_batched"],
                                                        ms, plain_ms, bound)
        print(f"  fri_fold_batched ({batch}, 8, {n}): {ms:.6f} ms/launch (CUDA events), device "
              f"{fmt_us(dev_us)}/launch (inputs rotated over {n_sets} codewords of {cw.numel() * 4} bytes), "
              f"host {enqueue_us:.2f} us/call (enqueue), plain {plain_ms:.3f} ms, "
              f"bound {bound[0]:.6f} ms ({bound[1]}: {nbytes} bytes)")
    del cw, cws, u, got, want

    # a production batch of 64 signatures on the card
    prover, keygen, sign_batch = make_batch_rpsss(urandom=det_urandom(b"chip smoke batch"))
    assert prover.stark.device == torch.device(dev), prover.stark.device
    keys = [keygen() for _ in range(BATCH)]
    sks = [sk for sk, _ in keys]
    docs = [b"chip smoke batch document %d" % i for i in range(BATCH)]
    t = time.perf_counter()
    sign_batch(sks, docs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    timer = prover.stark.timer
    timer.totals.clear()
    timer.counts.clear()
    K.reset_launch_counts()
    t = time.perf_counter()
    sigs = sign_batch(sks, docs)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t
    batch_launches = dict(K.LAUNCHES)
    phases = dict(timer.totals)
    assert len(sigs) == BATCH
    for name in BATCH_KERNELS:
        assert batch_launches[name] > 0, f"{name} was not launched by the batch"
        records[name]["launches"] = batch_launches[name]
    print(f"batch of {BATCH} (make_batch_rpsss, production parameters): warm batch {warm_s:.4f} s, "
          f"steady batch {steady_s:.4f} s = {steady_s / BATCH:.5f} s per signature on {smi}")
    total = sum(phases.values())
    print("  phases of the steady batch (PhaseTimer, s): "
          + ", ".join(f"{p} {phases.get(p, 0.0):.4f}" for p in PHASES)
          + f"; sum {total:.4f} = {100 * total / steady_s:.1f}% of the batch")
    print(f"  kernel launches in the steady batch: {sum(batch_launches.values())} {batch_launches}")
    t = time.perf_counter()
    for (sk, pk), doc, sig in zip(keys, docs, sigs):
        assert scheme.verify(pk, doc, sig), f"FastRPSSS rejected a batch signature: {scheme.stark.last_rejection}"
    verify_s = time.perf_counter() - t
    assert not scheme.verify(keys[0][1], b"forged document", sigs[0]), "verify accepted a forged document"
    assert not scheme.verify(keys[1][1], docs[0], sigs[0]), "verify accepted another key's pk"
    print(f"  all {BATCH} signatures verify under FastRPSSS ({verify_s:.3f} s, {verify_s / BATCH:.5f} s each); "
          f"a forged document and another key's pk are rejected; {len(sigs[0])} bytes a signature")
    # the card's tree route (H4) against the host's (N1,
    # STARK_TPU_DEVICE_HASH=0) on the same draws, byte for byte
    assert prover.device_trees == (torch.device(dev).type == "cuda"), "the batch took the wrong tree route"
    saved = os.environ.get("STARK_TPU_DEVICE_HASH")
    os.environ["STARK_TPU_DEVICE_HASH"] = "0"
    host_prover = BatchProver(prover.stark, prover.rp, prover.tz, air=prover.air)
    if saved is None:
        del os.environ["STARK_TPU_DEVICE_HASH"]
    else:
        os.environ["STARK_TPU_DEVICE_HASH"] = saved
    assert not host_prover.device_trees
    routes = [bp.prove_batch(sks, [SignatureProofStream(d) for d in docs],
                             urandom=det_urandom(b"chip smoke tree routes"))
              for bp in (prover, host_prover)]
    assert routes[0] == routes[1], "the card's and the host's tree routes gave different batches"
    print(f"  the card's tree route (H4) and the host's (N1) give the same {BATCH} signatures on the same draws")
    del host_prover, routes
    # H10 and H11 at the batch's inputs (per-proof boundary tables and
    # weights) against their plain versions, then with the special values;
    # each timed beside its bound
    special = device_from_ints([0, 1, P - 1, P - 2, (1 << 128) % P], dev)
    calls = capture_calls(K, ("rescue_quotients", "combination"), lambda: sign_batch(sks, docs))
    for name, (args, kwargs) in calls.items():
        shape = tuple(args[0].shape)
        check_air(name, f"batch {shape}", args, kwargs, compare)
        check_air(name, f"batch {shape} with the special values", air_edges(name, args, special), kwargs, compare)
        ms = time_launches(lambda: getattr(K, name)(*args, **kwargs), 50)
        dev_us = profile_kernel(name, lambda: getattr(K, name)(*args, **kwargs), 20)
        plain_ms = time_launches(lambda: K.PLAIN[name](*args, **kwargs), 1, warm=1)
        bound, what = air_bound(name, args)
        print(f"  {name} batch {shape} ({what}): {ms:.6f} ms/launch (CUDA events), device {fmt_us(dev_us)}/launch, "
              f"plain {plain_ms:.3f} ms, bound {bound[0]:.6f} ms ({bound[1]}) on {smi}")
    del calls
    wall, busy, seen = profile_all(lambda: sign_batch(sks, docs))
    if busy is None:
        print(f"  profile of one batch: wall {wall:.4f} s, device time not measured")
    else:
        print(f"  profile of one batch: wall {wall:.4f} s (under the profiler), device busy {busy:.4f} s = "
              f"{100 * busy / wall:.2f}% of wall, {sum(c for c, _ in seen.values())} device launches")
        for key, (cnt, us) in sorted(seen.items(), key=lambda kv: -kv[1][1])[:10]:
            print(f"  {us / 1e3:9.3f} ms  {cnt:6d} launches  {key[:90]}")
    host_profile(f"one batch of {BATCH}", lambda: sign_batch(sks, docs), BATCH_SPANS)
    del prover, sign_batch, sigs
    torch.cuda.empty_cache()

    # the card against the CPU: a seeded small batch through the batched FRI
    field, rp = Field.main(), RescuePrime()
    inputs = [field.sample(bytes([7, i])) for i in range(SMALL_BATCH)]
    small_docs = [b"chip smoke small batch %d" % i for i in range(SMALL_BATCH)]
    small = {}
    for label, device in (("card", dev), ("cpu", "cpu")):
        stark = FastStark(field, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device=device)
        bp = BatchProver(stark, rp, stark.preprocess())
        K.reset_launch_counts()
        proofs = bp.prove_batch(inputs, [SignatureProofStream(d) for d in small_docs],
                                urandom=det_urandom(b"chip smoke small batch"))
        if label == "card":
            torch.cuda.synchronize()
            assert K.LAUNCHES["fri_fold_batched"] > 0, "the small batch did not fold on the card"
        small[label] = (bp, proofs)
    (cbp, cproofs), (hbp, hproofs) = small["card"], small["cpu"]
    assert cproofs == hproofs, "the card and the CPU proved different batches"
    for i, x in enumerate(inputs):
        boundary = rp.boundary_constraints(rp.hash(x))
        factory = lambda pr, d=small_docs[i]: SignatureProofStream.deserialize_with_document(pr, d)
        assert cbp.stark.verify(hproofs[i], cbp.air, boundary, cbp.tz.root, proof_stream_factory=factory)
        assert hbp.stark.verify(cproofs[i], hbp.air, boundary, hbp.tz.root, proof_stream_factory=factory)
    print(f"  seeded batch of {SMALL_BATCH} (N = {cbp.stark.fri_domain_length}): card and "
          f"CPU proofs identical ({[len(p) for p in cproofs]} bytes), cross-verified")

    # the slow scalar Stark at tests/test_stark.py's parameters
    witness = field.sample(b"chip smoke slow stark")
    output = rp.hash(witness)
    trace, boundary = rp.trace(witness), rp.boundary_constraints(output)
    slow = {}
    for label, device in (("card", dev), ("cpu", "cpu")):
        stark = Stark(field, 4, 2, 2, rp.m, rp.N + 1, device=device)
        air = rp.transition_constraints(stark.omicron)
        t = time.perf_counter()
        proof = stark.prove(trace, air, boundary, urandom=det_urandom(b"chip smoke slow stark"))
        slow[label] = (stark, air, proof, time.perf_counter() - t)
    (cst, cair, cproof, cs), (hst, hair, hproof, hs) = slow["card"], slow["cpu"]
    assert cproof == hproof, "the card and the CPU proved different slow Stark proofs"
    assert cst.verify(hproof, cair, boundary) and hst.verify(cproof, hair, boundary)
    assert not cst.verify(cproof, cair, rp.boundary_constraints(output + field.one()))
    print(f"  slow Stark: card and CPU proofs identical ({len(cproof)} bytes; prove {cs:.3f} s and "
          f"{hs:.3f} s), cross-verified, a wrong boundary rejected")

    # the entry's core at B = 2
    outs = {}
    for label, device in (("card", dev), ("cpu", "cpu")):
        core, args = entry(device)
        outs[label] = [o.cpu() for o in core(*args)]
    for name, c, h in zip(("combination", "boundary quotients", "randomizer"), outs["card"], outs["cpu"]):
        assert torch.equal(c, h), f"entry(): the card's {name} codewords differ from the CPU's"
    print(f"  entry(): the core's three outputs {[tuple(o.shape) for o in outs['card']]} are identical "
          f"on the card and the CPU")

    # generic interpolation: round trips on the card, equal to the CPU's
    for n in INTERP_SIZES:
        pts = [rng.randrange(P) for _ in range(n)]
        assert len(set(pts)) == n
        vals = [rng.randrange(P) for _ in range(n)]
        coeffs = interpolate_generic(device_from_ints(pts, dev), device_from_ints(vals, dev))
        back = ints_from_device(evaluate_generic(coeffs, device_from_ints(pts, dev)))
        assert back == vals, f"interpolate_generic round trip at n = {n} failed on the card"
        cpu_coeffs = interpolate_generic(device_from_ints(pts, "cpu"), device_from_ints(vals, "cpu"))
        assert ints_from_device(coeffs) == ints_from_device(cpu_coeffs), f"interpolate_generic n = {n}"
        # K17's two steps (the synthetic divisions and the sum over the
        # points, glue over H0 and H1) on the card and on CPU copies (their
        # plain versions); bound: the zerofier, points and weights read and
        # the coefficients written once, and per point and coefficient a
        # product and an add for the division, a product for the weight and
        # an add for the sum
        z, x = zerofier(device_from_ints(pts, dev)), device_from_ints(pts, dev)
        w = device_from_ints(vals, dev)
        k17 = (lambda z, x, w: _tree_sum_last(F.mont_mul(w.unsqueeze(0), _synthetic_divide_all(z, x))))
        ms = time_launches(lambda: k17(z, x, w), 5)
        _, busy, seen = profile_all(lambda: k17(z, x, w))
        plain_ms = host_ms(lambda: k17(z.cpu(), x.cpu(), w.cpu()), 3)
        bound = bound_ms(n * n, (3 * n + 1) * 32, 2 * (MUL_OPS + ADD_OPS))
        print(f"  interpolate_generic n = {n}: round trip on the card, coefficients equal the CPU's; K17's "
              f"steps {ms:.4f} ms/call (CUDA events), device busy {fmt_us(None if busy is None else busy * 1e6)} "
              f"in {sum(c for c, _ in seen.values())} launches, plain (CPU) {plain_ms:.3f} ms, bound "
              f"{bound[0]:.9f} ms ({bound[1]}) on {smi}")


def sharded_path(dev, smi, records, worst_err, compare, steps: int = MIMC_STEPS) -> None:
    """Phase 7: the multi-GPU layer on the one card.  H3, H0, H4 and H6 at
    the shapes the sharded 2^20 path gives them against their plain
    versions, and the distributed NTT at 2^24 against the one-device one;
    the topology test's proof on in-process shards S = 2, 4, 8 against
    the one-device card proof and the CPU's; NCCL at world size 1; the
    sharded 2^20 MiMC proof at S = 8 against the one-device proof, and
    the scaling report (sharding overhead on one card) for S = 1-8; the
    multi-GPU dry run on a virtual mesh of 8."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from stark_anatomy_tpu_torch.commit import kernels as MK
    from stark_anatomy_tpu_torch.entry import dryrun_multichip
    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field.scalar import Field, FieldElement, P
    from stark_anatomy_tpu_torch.models import mimc as MM
    from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, make_air_evaluator
    from stark_anatomy_tpu_torch.ops import ntt as NTT
    from stark_anatomy_tpu_torch.ops.domain import DOMAINS
    from stark_anatomy_tpu_torch.parallel.mesh import Mesh, Sharded, make_mesh
    from stark_anatomy_tpu_torch.parallel.multihost import (
        collective_bytes_model, init_distributed, is_controller, make_mimc_scaling_prover,
        scaling_report, shutdown,
    )
    from stark_anatomy_tpu_torch.ops.domain import coset_table
    from stark_anatomy_tpu_torch.parallel import ntt_dist as ND
    from stark_anatomy_tpu_torch.parallel.ntt_dist import column_tables, make_distributed_ntt
    from stark_anatomy_tpu_torch.parallel.sharded_stark import ShardedFastStark
    from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark

    M = 1 << (3 * (steps + 1 + 4 * 64)).bit_length()      # the chain's omicron domain at 64 checks
    N = 4 * M                                             # and its FRI domain
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def spot(name, label, got, want_fn, rows):
        compare(name, f"{label}, {len(rows)} rows against plain", got[rows], want_fn(rows))

    # H9 against its plain version at every distributed transform of the
    # path (n = M and N, S = 2, 4, 8): both directions, with and without
    # the coset pre-scale, the pieces as a local mesh's views of the S
    # shards and as slices of one contiguous receive buffer; the last
    # shard's SHARD_SPOT_ROWS columns at each end (its largest exponents).
    # At S = 8 (the LDE's forward with the scale, the iNTT's inverse), H9's
    # time beside the glue it replaced: a shard's H0 coset scale, the
    # stack and transposes, H3 on rows of S points and H0's cross twiddle
    # (glue_columns, the route above 8 shards).  Then H3's column
    # transforms and H0's cross twiddle, the glue's kernels, at the same
    # shapes against their plain versions, and H3 at the row transforms'
    # inner shapes under the four-step glue that H8 replaced (n1 rows of n2)
    coset = Field.main().generator().value    # the LDEs' offset
    inner = set()
    for S in SHARD_COUNTS:
        for n in (M, N):
            B = n // S
            w, s = B // S, S - 1
            shards = [random_codeword((8, B), 7000 + S + n.bit_length() + 16 * a, dev) for a in range(S)]
            views = [x[..., s * w:(s + 1) * w] for x in shards]
            buf = torch.cat([v.reshape(-1) for v in views])
            layouts = {"views": views, "buffer": [buf[a * 8 * w:(a + 1) * 8 * w].view(8, w) for a in range(S)]}
            m = min(w, SHARD_SPOT_ROWS)
            for inverse, offset in itertools.product((False, True), (None, coset)):
                tabs = column_tables(n, S, inverse, offset, dev)
                for layout, pieces in layouts.items():
                    got = K.ntt_columns(pieces, s * w, tabs)
                    torch.cuda.synchronize()
                    for t0 in sorted({0, w - m}):
                        want = K.ntt_columns_plain([p[..., t0:t0 + m] for p in pieces], s * w + t0, tabs)
                        compare("ntt_columns", f"n = 2^{n.bit_length() - 1}, S = {S}, "
                                f"{'inverse' if inverse else 'forward'}{', coset pre-scale' if offset else ''}, "
                                f"{layout}, columns [{t0}, {t0 + m}) of ({S}, 8, {w}) against plain",
                                got[..., t0:t0 + m].transpose(-3, -2), want.transpose(-3, -2))
                    del got
            if S == SHARD_COUNTS[-1]:
                table = coset_table(coset, n, dev)
                for inverse, offset in ((False, coset), (True, None)):
                    tabs = column_tables(n, S, inverse, offset, dev)
                    label = (f"({S}, 8, {w}) n = 2^{n.bit_length() - 1} {'inverse' if inverse else 'forward'}"
                             f"{' with the coset pre-scale' if offset else ''}")
                    h9 = lambda: K.ntt_columns(views, s * w, tabs)
                    scale = table[:, s * B:(s + 1) * B].contiguous() if offset else None

                    def glue():
                        if scale is not None:
                            K.mont_mul(shards[s], scale)     # the shard's scale before the exchange
                        return ND.glue_columns(views, n, S, s, inverse)

                    ms, us = time_launches(h9, 20), profile_kernel("ntt_columns", h9, 10)
                    glue_ms = time_launches(glue, 10)
                    _, _, seen = profile_all(lambda: [glue() for _ in range(5)])
                    glue_us = {}
                    for k, (_, kus) in seen.items():
                        glue_us[k[:60]] = round(glue_us.get(k[:60], 0.0) + kus / 5, 3)
                    table_bytes = sum(4 * t.numel() for t in tabs if t is not None)
                    bound = bound_ms(w, 2 * 32 * B + table_bytes, columns_ops(S, offset is not None, inverse))
                    plain_ms = time_launches(lambda: K.ntt_columns_plain(views, s * w, tabs), 1, warm=0)
                    print(f"  ntt_columns {label}: {ms:.6f} ms/launch (CUDA events), device {fmt_us(us)}/launch, "
                          f"bound {bound[0]:.6f} ms ({bound[1]}), plain {plain_ms:.3f} ms; the glue it replaced "
                          f"{glue_ms:.6f} ms/shard, device us by kernel {glue_us} on {smi}")
                    if n == N and not inverse:
                        records["ntt_columns"] = kernel_record("ntt_columns", 0, ms, plain_ms, bound)
            x = shards[0][..., :w * S].reshape(8, w, S).transpose(0, 1).contiguous()    # (w, 8, S)
            rows = sorted(random.Random(7100 + S).sample(range(w), min(w, SHARD_SPOT_ROWS)))
            dom = DOMAINS.get(S, dev)
            for inverse in (False, True):
                args = (dom["inv_powers" if inverse else "fwd_powers"], dom["n_inv"] if inverse else None)
                got = K.ntt(x, *args)
                spot("ntt", f"column transforms ({w}, 8, {S}) {'inverse' if inverse else 'forward'} "
                     f"({K.ntt_plan(w, S.bit_length() - 1, sms)[0]} path)", got,
                     lambda r: K.ntt_plain(x[r], *args), rows)
            tw = ND.cross_twiddles(n, S, S - 1, False, dev)
            got = K.mont_mul(x, tw)
            spot("mont_mul", f"cross twiddle ({w}, 8, {S})", got, lambda r: K.mont_mul_plain(x[r], tw[r]), rows)
            del x, got, tw, shards, views, buf, layouts
            ND._TWIDDLES.clear()
            if B > NTT.NTT_MAX:
                n1 = 1 << ((B.bit_length() - 1) // 2)
                inner |= {(n1, B // n1, True), (B // n1, n1, False)}
    torch.cuda.empty_cache()
    for batch, n, scaled in sorted(inner):
        x, post = (random_codeword((batch, 8, n), 7200 + batch + n + k, dev) for k in range(2))
        rows = sorted(random.Random(7300 + n).sample(range(batch), NTT_SPOT_ROWS))
        args = (DOMAINS.get(n, dev)["fwd_powers"], None, None, post if scaled else None)
        got = K.ntt(x, *args)
        spot("ntt", f"four-step inner ({batch}, 8, {n}){' post-scaled' if scaled else ''} "
             f"({K.ntt_plan(batch, n.bit_length() - 1, sms)[0]} path)", got,
             lambda r: K.ntt_plain(x[r], args[0], None, None, post[r] if scaled else None), rows)
        del x, post, got
    # H8 at every shard row length B > NTT_MAX of the path (the row
    # transforms of the distributed NTT at n = M and N, S = 2, 4, 8),
    # forward and inverse, whole against its plain version; its time at
    # S = 8's rows, the LDE's forward and the trace iNTT's inverse
    for B in sorted({n // S for S in SHARD_COUNTS for n in (M, N) if n // S > NTT.NTT_MAX}):
        for inverse in (False, True):
            x = random_codeword((8, B), 7600 + B.bit_length() + inverse, dev)
            label = f"shard row (8, 2^{B.bit_length() - 1}) {'inverse' if inverse else 'forward'}"
            run, plain = check_tiled(compare, label, x, inverse, None, None)
            if (B, inverse) in ((N // SHARD_COUNTS[-1], False), (M // SHARD_COUNTS[-1], True)):
                ms, steps_us = time_launches(run, 20), profile_steps(run, 10)
                plain_ms = time_launches(plain, 1, warm=0)
                bound = bound_ms(1, 2 * 32 * B, ntt_ops(1, B, 0, inverse))
                print(f"  ntt_tiled {label}: {ms:.6f} ms/transform (2 launches, CUDA events), device step 0 "
                      f"{fmt_us(steps_us[0])}, step 1 {fmt_us(steps_us[1])}; plain {plain_ms:.3f} ms; bound "
                      f"{bound[0]:.6f} ms ({bound[1]}) on {smi}")
            del x, run, plain
    torch.cuda.empty_cache()
    # H0's coset scale and H6's top round on one shard, H4 over the S pair
    # blocks (one launch for the S subtrees); the largest S gives timings
    for S in SHARD_COUNTS:
        per = N // S
        a, b = random_codeword((8, per), 7400 + S, dev), random_codeword((8, per), 7410 + S, dev)
        compare("mont_mul", f"coset scale (8, 2^{per.bit_length() - 1})", K.mont_mul(a, b), K.mont_mul_plain(a, b))
        u = random_codeword((8, per // 2), 7420 + S, dev)
        alpha = random.Random(7430 + S).randrange(P)
        for label, g, w in zip(("folded", "canonical", "u^2"), K.fri_fold(a, u, alpha), K.fri_fold_plain(a, u, alpha)):
            compare("fri_fold", f"pair block (8, 2^{per.bit_length() - 1}) {label}", g, w)
        canon = random_codeword((S, 8, per), 7440 + S, dev)
        compare("merkle", f"forest of {S} subtrees ({S}, 8, 2^{per.bit_length() - 1})",
                MK.merkle_paired(canon), MK.merkle_paired_plain(canon))
        tree_ms = time_launches(lambda: MK.merkle_paired(canon), 5)
        tree_us = profile_kernel("merkle", lambda: MK.merkle_paired(canon), 5)
        tree_bound = merkle_bound(per, S)
        line = (f"  merkle ({S}, 8, 2^{per.bit_length() - 1}): {tree_ms:.6f} ms/commit (CUDA events), device "
                f"{fmt_us(tree_us)}/commit (1 launch), bound {tree_bound[0]:.6f} ms ({tree_bound[1]})")
        if S == SHARD_COUNTS[-1]:
            scale_ms = time_launches(lambda: K.mont_mul(a, b), 20)
            fold_ms = time_launches(lambda: K.fri_fold(a, u, alpha), 20)
            scale_us = profile_kernel("mont_mul", lambda: K.mont_mul(a, b), 10)
            fold_us = profile_kernel("fri_fold", lambda: K.fri_fold(a, u, alpha), 10)
            scale_bound = bound_ms(per, 3 * per * 32, MUL_OPS)
            h = per // 2
            fold_bound = bound_ms(1, FOLD_BYTES * h, h * (4 * MUL_OPS + 3 * ADD_OPS) + h // 2 * SQR_OPS)
            line += (f"; mont_mul coset scale (8, 2^{per.bit_length() - 1}): {scale_ms:.6f} ms/launch, device "
                     f"{fmt_us(scale_us)}/launch, bound {scale_bound[0]:.6f} ms ({scale_bound[1]}); fri_fold "
                     f"(8, 2^{per.bit_length() - 1}): {fold_ms:.6f} ms/launch, device {fmt_us(fold_us)}/launch, "
                     f"bound {fold_bound[0]:.6f} ms ({fold_bound[1]})")
        print(line + f" on {smi}")
        del a, b, u, canon
    # the distributed NTT at N (2^24) on S = 8 shards against the one-device
    # transform, both directions, and the LDE's coset evaluation; on the
    # card each is one H9 launch a shard (no H3 column launch, no H0
    # twiddle or coset-scale launch) and the rows' two H8 launches a shard
    mesh8 = Mesh([[dev] * 8])
    x = random_codeword((8, N), 7500, dev)
    fwd, inv = make_distributed_ntt(N, mesh8), make_distributed_ntt(N, mesh8, inverse=True)
    xs = Sharded.place(mesh8, x)
    want = NTT.ntt(x)
    y = fwd(xs)
    assert torch.equal(y.gather(), want), f"the distributed NTT at {N} differs from the one-device NTT"
    assert torch.equal(inv(y).gather(), x), f"the distributed inverse at {N} did not undo the forward"
    del want
    want = NTT.coset_evaluate(x, coset, N)
    y = fwd(xs, coset)
    assert torch.equal(y.gather(), want), f"the distributed coset evaluation at {N} differs from one device's"
    for label, call in (("coset forward", lambda: fwd(xs, coset)), ("inverse", lambda: inv(y))):
        K.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        made = {k: v for k, v in K.LAUNCHES.items() if v}
        print(f"  distributed NTT n=2^{N.bit_length() - 1} {label} on 8 shards: launches {made}")
        rows = {"ntt_tiled": 16} if N // 8 > NTT.NTT_MAX else {"ntt": 8}    # H8's two launches a shard row
        assert made == {"ntt_columns": 8, **rows}, f"the distributed {label} launched {made}"
    dist_ms = time_launches(lambda: fwd(xs, coset), 3, warm=1)
    one_ms = time_launches(lambda: NTT.coset_evaluate(x, coset, N), 3, warm=1)
    print(f"  distributed NTT n=2^{N.bit_length() - 1} over 8 in-process shards: equals the one-device NTT and "
          f"coset evaluation, inverse round trip exact; coset evaluation {dist_ms:.3f} ms/call against one "
          f"device's {one_ms:.3f} ms (CUDA events) on {smi}")
    del x, xs, want, y, fwd, inv
    gc.collect()
    torch.cuda.empty_cache()

    # the topology test's proof: in-process shards on the card, one
    # device on the card, and the CPU
    field = Field.main()
    rp = RescuePrime()
    params = (field, 4, 2, 4, rp.m, rp.N + 1)
    inp = field.sample(b"topology")
    trace, boundary = rp.trace(inp), rp.boundary_constraints(rp.hash(inp))

    def topology_proof(stark):
        air = rp.transition_constraints(stark.omicron)
        tz = stark.preprocess()
        return stark.prove(trace, air, boundary, tz, air_evaluator=make_air_evaluator(stark),
                           urandom=det_urandom(b"seed-A")), tz, air

    single = FastStark(*params, transition_constraints_degree=3, device=dev)
    want, tz1, air = topology_proof(single)
    cpu_proof = topology_proof(FastStark(*params, transition_constraints_degree=3, device="cpu"))[0]
    assert want == cpu_proof, "the card and the CPU proved different topology proofs"
    for S in SHARD_COUNTS:
        stark = ShardedFastStark(*params, transition_constraints_degree=3, mesh=Mesh([[dev] * S]))
        t = time.perf_counter()
        proof, tz, _ = topology_proof(stark)
        torch.cuda.synchronize()
        assert proof == want and tz.root == tz1.root, f"the sharded proof at S = {S} differs from one device's"
        assert single.verify(proof, air, boundary, tz1.root), f"the sharded proof at S = {S} did not verify"
        print(f"  topology proof on {S} in-process shards of the card: identical to the one-device card "
              f"proof and the CPU's ({len(proof)} bytes), verified; preprocess + prove "
              f"{time.perf_counter() - t:.3f} s, routes {dict(stark.routes)}")

    # NCCL at world size 1: the group, the controller, the distributed NTT
    # (sp = 1) and a sharded proof whose every exchange and gather is NCCL's
    rdv = tempfile.mkdtemp(prefix="stark_nccl_")
    try:
        assert init_distributed(f"file://{rdv}/rendezvous", 1, 0), "init_distributed did not start NCCL"
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1 and is_controller()
        mesh1 = make_mesh()
        assert mesh1.backend == "dist" and mesh1.device == dev, mesh1
        x = random_codeword((2, 8, 4096), 7600, dev)
        y = make_distributed_ntt(4096, mesh1)(Sharded.place(mesh1, x))
        assert torch.equal(y.gather(), NTT.ntt(x)), "the NCCL distributed NTT differs from the one-device NTT"
        assert torch.equal(make_distributed_ntt(4096, mesh1, inverse=True)(y).gather(), x)
        proof, tz, _ = topology_proof(ShardedFastStark(*params, transition_constraints_degree=3, mesh=mesh1))
        assert proof == want and tz.root == tz1.root, "the NCCL sharded proof differs from one device's"
        print(f"  NCCL at world size 1 ({dist.get_backend()}, {mesh1}): init_distributed, is_controller, the "
              f"distributed NTT (sp = 1) on the card and a sharded topology proof identical to one device's")
    finally:
        shutdown()
        shutil.rmtree(rdv, ignore_errors=True)
    del single, tz1
    gc.collect()
    torch.cuda.empty_cache()

    # the 2^20 chain at the production parameters on 8 in-process shards,
    # against the one-device seeded proof
    rng = random.Random(7700)
    x = FieldElement(rng.randrange(P), field)
    mimc, single = MM.make_stark(steps, device=dev)
    tz1 = single.preprocess()
    out1, proof1, _ = MM.prove_chain(mimc, single, x, tz1, urandom=det_urandom(b"chip smoke sharded"))
    stark = ShardedFastStark(field, 4, 64, 128, 1, steps + 1, transition_constraints_degree=3, mesh=mesh8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t = time.perf_counter()
    tz8 = stark.preprocess()
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t
    t = time.perf_counter()
    out8, proof8, _ = MM.prove_chain(mimc, stark, x, tz8, urandom=det_urandom(b"chip smoke sharded"))
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    print(f"  launches in the sharded 2^20 path (preprocess, prove; S = 8): {sum(launches.values())} {launches}")
    for name in SHARDED_KERNELS:
        assert launches[name] > 0, f"{name} was not launched on the sharded path"
    if M // 8 > NTT.NTT_MAX:                  # every shard row is H8's, every column step H9's
        assert launches["ntt"] == 0, f"H3 ran {launches['ntt']} times on the sharded path"
    for name in SHARDED_ONLY:
        records[name]["launches"] = launches[name]
        records[name]["max_abs_err"] = worst_err[name]
    assert tz8.root == tz1.root, "the sharded zerofier root differs from one device's"
    assert proof8 == proof1 and out8 == out1, "the sharded 2^20 proof differs from the one-device proof"
    assert MM.verify_chain(mimc, single, x, out8, proof8, tz1.root), "the sharded 2^20 proof did not verify"
    print(f"MiMC {steps} steps on 8 in-process shards of the card: proof identical to the one-device "
          f"proof ({len(proof8)} bytes) and verified; preprocess {pre_s:.3f} s, prove {prove_s:.3f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, routes {dict(stark.routes)} on {smi}")
    model = collective_bytes_model(stark, 8)
    print("  collective_bytes_model at S = 8 (bytes a proof would move between cards): "
          + ", ".join(f"{k} {v:.0f}" for k, v in model.items()))
    del stark, tz8, single, tz1
    gc.collect()
    torch.cuda.empty_cache()

    # the scaling report: one card, so the shards share it and this is the
    # sharding's overhead, not a speedup across cards
    prove_fn = make_mimc_scaling_prover(steps, 64, 128, devices=[dev] * 8)
    rows = []
    for s in SCALING_SHARDS:
        torch.cuda.reset_peak_memory_stats()
        rep = scaling_report(prove_fn, [s], reps=SCALING_REPS)[0]
        peak = torch.cuda.max_memory_allocated() / 2**30
        stark = prove_fn.get(s)[0]
        routes = getattr(stark, "routes", {})
        routes.clear()
        wall, busy, _ = profile_all(lambda: prove_fn(s))
        routes = dict(routes)                 # one prove's
        rows.append((s, rep["seconds"], peak, wall, busy, routes, collective_bytes_model(stark, s)["TOTAL"]))
        del stark
        prove_fn.drop(s)
        gc.collect()
        torch.cuda.empty_cache()
    base = rows[0][1]
    for s, sec, peak, wall, busy, routes, model_bytes in rows:
        share = "not measured" if busy is None else f"{100 * busy / wall:.2f}%"
        print(f"scaling S={s}: {sec:.4f} s a prove (mean of {SCALING_REPS} after a warm one), "
              f"{sec / base:.3f}x one device's, peak device memory {peak:.3f} GiB, device busy {share} of one "
              f"profiled prove ({wall:.4f} s), routes {routes}, collective bytes (model) {model_bytes:.0f}")
    print(f"scaling over {SCALING_SHARDS} in-process shards of ONE card: sharding overhead, not collective "
          f"scaling (that needs several cards) on {smi}")

    result = dryrun_multichip(8, devices=[dev] * 8)
    print(f"dryrun_multichip(8, devices=[{dev}] * 8): {result}; torch.cuda.device_count() = "
          f"{torch.cuda.device_count()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concurrent.futures import ThreadPoolExecutor

    from stark_anatomy_tpu_torch.commit import kernels as MK
    from stark_anatomy_tpu_torch.commit import native as NB
    from stark_anatomy_tpu_torch.commit.device_merkle import DeviceRows, device_commit_paired
    from stark_anatomy_tpu_torch.commit.merkle import MerkleTree, open_multi
    from stark_anatomy_tpu_torch.config import RPSSS_CONFIG
    from stark_anatomy_tpu_torch.field import kernels as K
    from stark_anatomy_tpu_torch.field import ops as F
    from stark_anatomy_tpu_torch.field.limbs import R
    from stark_anatomy_tpu_torch.field.scalar import Field, P
    from stark_anatomy_tpu_torch.models.rescue_prime import (
        RescuePrime, hash_batch, make_index_air_evaluator, permutation_tables, trace_batch,
    )
    from stark_anatomy_tpu_torch.ops.domain import DOMAINS
    from stark_anatomy_tpu_torch.models.rpsss import FastRPSSS
    from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark
    from stark_anatomy_tpu_torch.utils.build import host_compiler
    from stark_anatomy_tpu_torch.utils.convert import canonical_np, device_from_ints, ints_from_device

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- phase 0: device and build ------------------------------------------
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    tb = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(K.load), pool.submit(NB.load)]:
            job.result()
    print(f"build: {time.perf_counter() - tb:.3f} s (one nvcc call per CUDA source, "
          f"{K.NVCC_FLAGS}; N1 by {host_compiler()} {NB.CXX_FLAGS}; all at once)")
    for line in K.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    phase("0 device+build", t0)

    # -- phase 1: kernels against their plain versions ----------------------
    t1 = time.perf_counter()
    worst_mismatch, worst_err = 0, {name: 0 for name in K.KERNELS}
    cases = [(s, s) for s in SHAPES] + [(MAIN_SHAPE, (8, 1)), (MAIN_SHAPE, (8, 4096))]
    for i, (sa, sb) in enumerate(cases):
        a_cpu, _ = field_inputs(sa, 100 + i)
        _, b_cpu = field_inputs(sb, 200 + i)
        a, b = a_cpu.to(dev), b_cpu.to(dev)
        for name in K.BINARY:
            got = getattr(K, name)(a, b)
            torch.cuda.synchronize()
            want = K.PLAIN[name](a_cpu, b_cpu)
            got = got.cpu()
            assert got.shape == want.shape, (name, got.shape, want.shape)
            mismatch = int((got != want).any(dim=-2).sum())
            err = int((got.long() - want.long()).abs().max())
            print(f"  {name} {sa} x {sb}: mismatched elements {mismatch}, max abs limb error {err}")
            worst_mismatch = max(worst_mismatch, mismatch)
            worst_err[name] = max(worst_err[name], err)
    exponents = {"1": 1, "2": 2, "3": 3, "alpha_inv": ALPHA_INV, "p-2": P - 2,
                 "random128": random.Random(5).getrandbits(128) | (1 << 127)}
    for i, shape in enumerate(LADDER_SHAPES):
        # the Rescue state holds two elements: one zero, one random
        x_cpu, _ = field_inputs(shape, 300 + i, special=[0] if shape == RESCUE_SHAPE else None)
        x = x_cpu.to(dev)
        for label, e in exponents.items():
            got = K.mont_pow(x, e)
            torch.cuda.synchronize()
            want = K.mont_pow_plain(x_cpu, e)
            got = got.cpu()
            assert got.shape == want.shape, ("mont_pow", got.shape, want.shape)
            mismatch = int((got != want).any(dim=-2).sum())
            err = int((got.long() - want.long()).abs().max())
            print(f"  mont_pow {shape} e={label}: mismatched elements {mismatch}, max abs limb error {err}")
            worst_mismatch = max(worst_mismatch, mismatch)
            worst_err["mont_pow"] = max(worst_err["mont_pow"], err)
    # the paths' calls: x^(p-2) by the fixed chain through F.inv and
    # F.batch_inv (0, 1, p - 1, p - 2 and R among the inputs), the
    # verifier's shifts, and an exponent of every bit length by the ladder
    named = ([(shape, P - 2, None) for shape in INV_SHAPES] + [(INV_MAIN, P - 2, [])]
             + [(SHIFT_SHAPE, e, None) for e in SHIFT_EXPONENTS])
    rng = random.Random(6)
    pow_cases = named + [(INV_MAIN, rng.getrandbits(b) | (1 << b >> 1), []) for b in range(129)]
    for i, (shape, e, special) in enumerate(pow_cases):
        x_cpu = field_inputs(shape, 320 + i, special=special)[0]     # special=[]: a random value
        x = x_cpu.to(dev)
        pairs = [("mont_pow", K.mont_pow(x, e), K.mont_pow_plain(x_cpu, e))]
        if e == P - 2:
            pairs += [("F.inv", F.inv(x), K.mont_pow_plain(x_cpu, e)),
                      ("F.batch_inv", F.batch_inv(x), F.batch_inv(x_cpu))]
        torch.cuda.synchronize()
        for via, got, want in pairs:
            got = got.cpu()
            assert got.shape == want.shape, (via, got.shape, want.shape)
            mismatch = int((got != want).any(dim=-2).sum())
            err = int((got.long() - want.long()).abs().max())
            if i < len(named) or mismatch:
                print(f"  {via} {shape} e={'p-2' if e == P - 2 else e} ({K.pow_route(e)}): "
                      f"mismatched elements {mismatch}, max abs limb error {err}")
            worst_mismatch = max(worst_mismatch, mismatch)
            worst_err["mont_pow"] = max(worst_err["mont_pow"], err)
    print(f"  mont_pow {INV_MAIN}: a seeded exponent of every bit length 0-128 checked (ladder)")

    def compare(name, label, got, want):
        nonlocal worst_mismatch
        got, want = got.cpu(), want.cpu()
        assert got.shape == want.shape, (name, label, got.shape, want.shape)
        mismatch = int((got != want).any(dim=-2).sum())
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        print(f"  {name} {label}: mismatched elements {mismatch}, max abs limb error {err}")
        worst_mismatch = max(worst_mismatch, mismatch)
        worst_err[name] = max(worst_err[name], err)

    # H2, trace and hash, against the plain permutation (on CPU copies; on
    # the card for the large batch, where the CPU would take minutes).  In
    # a "special" batch both elements (both lanes of a state) start with
    # the special values, in opposite orders, and are random after them,
    # so only B = 1 needs a random state of its own.
    rescue_tabs = {d: (*permutation_tables(d), ALPHA_INV) for d in ("cpu", dev)}
    specials = [0, 1, P - 1, P - 2, R % P]
    for i, batch in enumerate(RESCUE_BATCHES):
        rng = random.Random(500 + i)
        rows = [s + [rng.randrange(P) for _ in range(batch - len(s))] for s in (specials, specials[::-1])]
        for label, special in (("random", []), ("special", rows[0] + rows[1]))[batch > 1:]:
            state_cpu = field_inputs((2, 8, batch), 500 + i, special=special)[0]
            ref_dev = "cpu" if batch < 100 else dev
            want = K.rescue_permutation_plain(state_cpu.to(ref_dev), *rescue_tabs[ref_dev], True)
            state = state_cpu.to(dev)
            got_trace = K.rescue_permutation(state, *rescue_tabs[dev], True)
            got_hash = K.rescue_permutation(state, *rescue_tabs[dev], False)
            torch.cuda.synchronize()
            compare("rescue_perm", f"trace B={batch} {label}", got_trace, want)
            compare("rescue_perm", f"hash B={batch} {label}", got_hash, want[-1])
    # H3 against the plain transform on CPU copies: a scale on the input
    # shared by the batch, one on the output per row; every n, batches 1-3
    # (the cluster path from n = 1024 up, one block a row below it)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, n in enumerate(NTT_SIZES):
        for batch in (1, 2, 3):
            x_cpu, post_cpu = field_inputs((batch, 8, n), 600 + 10 * i + batch)
            pre_cpu = field_inputs((8, n), 700 + 10 * i + batch)[0]
            for inverse in (False, True):
                key = "inv_powers" if inverse else "fwd_powers"
                tabs_cpu = [DOMAINS.get(n, "cpu")[key], DOMAINS.get(n, "cpu")["n_inv"] if inverse and n > 1 else None]
                tabs = [DOMAINS.get(n, dev)[key], DOMAINS.get(n, dev)["n_inv"] if inverse and n > 1 else None]
                for scaled in (False, True):
                    scales_cpu = [pre_cpu, post_cpu] if scaled else [None, None]
                    scales = [t if t is None else t.to(dev) for t in scales_cpu]
                    got = K.ntt(x_cpu.to(dev), *tabs, *scales)
                    torch.cuda.synchronize()
                    want = K.ntt_plain(x_cpu, *tabs_cpu, *scales_cpu)
                    path = K.ntt_plan(batch, n.bit_length() - 1, sms)[0]
                    label = (f"n={n} batch={batch} {'inverse' if inverse else 'forward'}"
                             f"{' scaled' if scaled else ''} ({path} path)")
                    compare("ntt", label, got, want)
    # H4 against its plain version on CPU copies of the same canonical
    # limbs (random values with the special ones first), one codeword and
    # two in one launch set
    for i, n in enumerate(TREE_SIZES):
        for batch in TREE_BATCHES:
            canon_cpu = field_inputs((batch, 8, n), 1000 + 10 * i + batch)[0]
            got = MK.merkle_paired(canon_cpu.to(dev))
            torch.cuda.synchronize()
            compare("merkle", f"n={n} R={batch}", got, MK.merkle_paired_plain(canon_cpu))
    for i, shape in enumerate(BATCH_TREES):
        canon_cpu = field_inputs(shape, 1050 + i)[0]
        got = MK.merkle_paired(canon_cpu.to(dev))
        torch.cuda.synchronize()
        compare("merkle", f"batch stack {shape}", got, MK.merkle_paired_plain(canon_cpu))
    # N1 against hashlib on the host, the main path's tree size
    rows_4096 = canonical_np(field_inputs(TREE_MAIN, 1100)[0])
    n1_leaves = NB.leaves_from_limb_pairs(rows_4096)
    assert n1_leaves.tobytes() == NB.leaves_from_limb_pairs_plain(rows_4096).tobytes()
    tree = MerkleTree.from_limbs_paired(rows_4096)
    level = n1_leaves
    for k, got_level in enumerate(tree.levels):
        assert got_level.tobytes() == level.tobytes(), f"N1 level {k} differs from hashlib"
        if level.shape[0] > 1:
            level = NB.merkle_level_plain(level)
    print(f"  N1 tree n={TREE_MAIN[-1]}: every level equals hashlib's")
    # H13 against its plain version at a sign's draws, a batch of 64's and
    # one, the first draws the reduction's edges (0, 2^136 - 1, p and its
    # neighbours, 2^128, the largest multiple of p below 2^136)
    for n in SAMPLE_SIZES:
        raw_cpu = sample_inputs(n, 1400 + n)
        compare("sample_mont", f"n={n}", K.sample_mont(raw_cpu.to(dev)), K.sample_mont_plain(raw_cpu))
    print(f"max mismatch count: {worst_mismatch}")
    assert worst_mismatch == 0, "a kernel disagrees with its plain version"

    # the Rescue-Prime known-answer vectors through the kernels
    vec_in = [1, 57322816861100832358702415967512842988]
    vec_out = [244180265933090377212304188905974087294, 89633745865384635541695204788332415101]
    assert ints_from_device(hash_batch(device_from_ints(vec_in, dev))) == vec_out
    assert ints_from_device(trace_batch(device_from_ints(vec_in, dev))[-1, 0]) == vec_out

    def record(name, ms, plain_ms, bound):
        return kernel_record(name, worst_err[name], ms, plain_ms, bound)

    a, b = (x.to(dev) for x in field_inputs(MAIN_SHAPE, 7))
    numel = a.numel() // 8
    records = {}
    for name in K.BINARY:
        kern, plain = getattr(K, name), K.PLAIN[name]
        ms = time_launches(lambda: kern(a, b), 200)
        plain_ms = time_launches(lambda: plain(a, b), 20)
        records[name] = record(name, ms, plain_ms, bound_ms(numel, 3 * a.numel() * 4, KERNEL_INFO[name][1]))
        got = profile_kernel(name, lambda: kern(a, b), 100)
        print(f"  {name} at {MAIN_SHAPE}: {ms:.6f} ms/launch, device {fmt_us(got)}/launch, "
              f"plain {plain_ms:.6f} ms, bound {records[name]['bound_ms']:.6f} ms "
              f"({records[name]['bound_by']})")

    # the ladder at the paths' calls: x^(p-2) by the fixed chain at (8, 1)
    # (batch_inv's root, one launch a verify and one a 2^20 prove: the
    # record) and at (8, 128), the verifier's shifts at (8, 128); beside
    # the bound, the dependent chain's length in products
    for shape, e in [(INV_MAIN, P - 2), (SHIFT_SHAPE, P - 2)] + [(SHIFT_SHAPE, e) for e in SHIFT_EXPONENTS]:
        x = field_inputs(shape, 410 + shape[-1])[0].to(dev)
        numel = x.numel() // 8
        ms = time_launches(lambda: K.mont_pow(x, e), 100)
        plain_ms = time_launches(lambda: K.mont_pow_plain(x, e), 3)
        bound = bound_ms(numel, 2 * x.numel() * 4, pow_ops(K, e))
        got = profile_kernel("mont_pow", lambda: K.mont_pow(x, e), 50)
        square_multiply = ""
        if K.pow_route(e) == "inv_chain":
            ladder_ms = bound_ms(numel, 2 * x.numel() * 4, ladder_ops(e))[0]
            square_multiply = f"; {ladder_ms:.9f} ms by square and multiply's {ladder_ops(e)} ops"
        print(f"  mont_pow e={'p-2' if e == P - 2 else e} at {shape} ({K.pow_route(e)}, a chain of "
              f"{pow_links(K, e)} products): {ms:.6f} ms/launch, device {fmt_us(got)}/launch, "
              f"plain {plain_ms:.6f} ms, bound {bound[0]:.9f} ms ({bound[1]}: {pow_ops(K, e)} ops an "
              f"element{square_multiply}) on {smi}")
        if shape == INV_MAIN and e == P - 2:
            records["mont_pow"] = record("mont_pow", ms, plain_ms, bound)
    # the product the ladder chains, and the ladder, at each ladder shape
    # (x^ALPHA_INV is on no path: H2 runs its own chain)
    for i, shape in enumerate(LADDER_SHAPES):
        x = field_inputs(shape, 400 + i)[0].to(dev)
        numel = x.numel() // 8
        ms = time_launches(lambda: K.mont_mul(x, x), 200)
        plain_ms = time_launches(lambda: K.mont_mul_plain(x, x), 20)
        bound = bound_ms(numel, 3 * x.numel() * 4, MUL_OPS)
        got = profile_kernel("mont_mul", lambda: K.mont_mul(x, x), 100)
        print(f"  mont_mul at {shape}: {ms:.6f} ms/launch, device {fmt_us(got)}/launch, "
              f"plain {plain_ms:.6f} ms, bound {bound[0]:.9f} ms ({bound[1]})")
        for label in ("alpha_inv", "p-2"):
            e = exponents[label]
            ms = time_launches(lambda: K.mont_pow(x, e), 100)
            plain_ms = time_launches(lambda: K.mont_pow_plain(x, e), 3)
            bound = bound_ms(numel, 2 * x.numel() * 4, pow_ops(K, e))
            got = profile_kernel("mont_pow", lambda: K.mont_pow(x, e), 50)
            print(f"  mont_pow e={label} at {shape}{' (on no path)' if label == 'alpha_inv' else ''}: "
                  f"{ms:.6f} ms/launch, device {fmt_us(got)}/launch, plain {plain_ms:.6f} ms, "
                  f"bound {bound[0]:.9f} ms ({bound[1]})")

    # H2 at each batch, trace and hash; the record is the main path's
    # trace_batch of one key (B = 1), the only case whose plain version is
    # timed (one call on the card takes seconds).  Bytes: the states in,
    # the trace or the final states out, the constant tables once.
    table_bytes = (27 * 2 * 2 + 2 * 2) * 8 * 4
    for batch in RESCUE_BATCHES:
        state = field_inputs((2, 8, batch), 800 + batch)[0].to(dev)
        for collect in (True, False):
            out_states = 28 if collect else 1
            bound = bound_ms(1, (1 + out_states) * 2 * 8 * batch * 4 + table_bytes,
                             rescue_ops(batch, K.ALPHA_INV_CHAIN))
            ms = time_launches(lambda: K.rescue_permutation(state, *rescue_tabs[dev], collect), 20)
            got = profile_kernel("rescue_perm", lambda: K.rescue_permutation(state, *rescue_tabs[dev], collect), 5)
            line = (f"  rescue_perm {'trace' if collect else 'hash'} B={batch}: {ms:.6f} ms/launch, "
                    f"device {fmt_us(got)}/launch, bound {bound[0]:.9f} ms ({bound[1]})")
            if batch == 1 and collect:
                plain_ms = time_launches(lambda: K.rescue_permutation_plain(state, *rescue_tabs[dev], collect),
                                         1, warm=0)
                records["rescue_perm"] = record("rescue_perm", ms, plain_ms, bound)
                line += f", plain {plain_ms:.3f} ms"
            print(line)

    # H3 at the main path's shapes; the record is the LDE, a forward
    # transform of two rows with the coset pre-scale.  Bytes: the input,
    # the output, each scale table and 1/n once, and the n/2 twiddles
    # omega^j, j < n/2, the kernel reads from the power table.
    for shape, inverse, scaled in ((NTT_MAIN, False, True), ((2, 8, 1024), True, False),
                                   (NTT_MAIN, True, True), ((3, 8, 8192), False, True)):
        batch, n = shape[0], shape[-1]
        x, post = (t.to(dev) for t in field_inputs(shape, 900 + n))
        pre = field_inputs((8, n), 901 + n)[0].to(dev)
        dom = DOMAINS.get(n, dev)
        args = (dom["inv_powers" if inverse else "fwd_powers"], dom["n_inv"] if inverse else None,
                pre if scaled and not inverse else None, post[0] if scaled and inverse else None)
        nbytes = ((2 * batch + scaled) * n + n // 2 + inverse) * 8 * 4
        bound = bound_ms(1, nbytes, ntt_ops(batch, n, int(scaled), inverse))
        ms = time_launches(lambda: K.ntt(x, *args), 200)
        got = profile_kernel("ntt", lambda: K.ntt(x, *args), 50)
        plain_ms = time_launches(lambda: K.ntt_plain(x, *args), 3, warm=1)
        print(f"  ntt {shape} {'inverse' if inverse else 'forward'}{' scaled' if scaled else ''}: "
              f"{ms:.6f} ms/launch, device {fmt_us(got)}/launch, plain {plain_ms:.6f} ms, "
              f"bound {bound[0]:.9f} ms ({bound[1]})")
        if shape == NTT_MAIN and not inverse:
            records["ntt"] = record("ntt", ms, plain_ms, bound)

    # H4 per commit (one launch: every stage of the tree, tree_stages) at
    # the main path's codeword, for 1, 2 and 7 codewords; the record is one
    # codeword.  N1 and hashlib per tree of the same size and of 2^16
    # elements, on the host.
    for batch in TREE_BATCHES:
        shape = (batch,) + TREE_MAIN if batch > 1 else TREE_MAIN
        canon = field_inputs(shape, 1200 + batch)[0].to(dev)
        n = shape[-1]
        bound = merkle_bound(n, batch)
        ms = time_launches(lambda: MK.merkle_paired(canon), 200)
        dev_us = profile_kernel("merkle", lambda: MK.merkle_paired(canon), 50)
        plain_ms = time_launches(lambda: MK.merkle_paired_plain(canon), 1, warm=1)
        print(f"  merkle {shape}: {ms:.6f} ms/commit (1 launch, {len(MK.tree_stages(n))} stages), device "
              f"{fmt_us(dev_us)}/commit, plain {plain_ms:.3f} ms, bound {bound[0]:.9f} ms "
              f"({bound[1]}; {BLAKE2S_INSTR} instructions per node at {INSTR_PER_S:.4g}/s)")
        if batch == 1:
            records["merkle"] = record("merkle", ms, plain_ms, bound)
    # H13 at a batch of 64's draws (its record) and a sign's.  Bytes: 17
    # read and an element written a draw; operations: one product and the
    # reduction's adds
    for n in SAMPLE_SIZES[::-1][:2]:
        raw = sample_inputs(n, 1500 + n).to(dev)
        bound = bound_ms(n, n * (K.SAMPLE_BYTES + 16), MUL_OPS + 2 * ADD_OPS)
        ms = time_launches(lambda: K.sample_mont(raw), 200)
        got = profile_kernel("sample_mont", lambda: K.sample_mont(raw), 50)
        plain_ms = time_launches(lambda: K.sample_mont_plain(raw), 3, warm=1)
        print(f"  sample_mont n={n}: {ms:.6f} ms/launch, device {fmt_us(got)}/launch, plain "
              f"{plain_ms:.6f} ms, bound {bound[0]:.9f} ms ({bound[1]})")
        if n == SAMPLE_SIZES[-1]:
            records["sample_mont"] = record("sample_mont", ms, plain_ms, bound)
    for n in (TREE_MAIN[-1], 1 << 16):
        rows = canonical_np(field_inputs((8, n), 1300 + n)[0])
        n1_ms = host_ms(lambda: MerkleTree.from_limbs_paired(rows), 20)
        plain_ms = host_ms(lambda: hashlib_tree(NB, rows), 3)
        print(f"  host paired tree n={n}: N1 {n1_ms:.4f} ms, hashlib {plain_ms:.4f} ms "
              f"(median, host clock)")
    phase("1 kernels", t1)

    # -- phase 2: the main path ---------------------------------------------
    t2 = time.perf_counter()
    scheme = FastRPSSS()
    assert scheme.device.type == "cuda"
    keys = det_urandom(b"chip smoke keys")
    sk, pk = scheme.keygen(keys)
    _, pk_other = scheme.keygen(keys)

    K.reset_launch_counts()
    sig = scheme.sign(sk, DOC)
    torch.cuda.synchronize()
    sign_launches = dict(K.LAUNCHES)
    accepted = scheme.verify(pk, DOC, sig)
    torch.cuda.synchronize()
    path_launches = dict(K.LAUNCHES)
    print(f"launches in one sign: {sign_launches}; sign + verify: {path_launches}")
    assert accepted, f"verify rejected an honest signature: {scheme.stark.last_rejection}"
    assert not scheme.verify(pk, b"forged document", sig), "verify accepted a forged document"
    assert not scheme.verify(pk_other, DOC, sig), "verify accepted another key's pk"
    # H10-H12 against their plain versions at the inputs this path gives
    # them (their records)
    air_path(dev, smi, records, worst_err, compare, scheme, sk, pk, sig)
    assert worst_mismatch == 0, "a kernel disagrees with its plain version"
    # H5 and H6 are not on this path (the sign's randomizer is under
    # bulk_randomizer_threshold), nor H1's subtract (the sign's quotients
    # are H10's); phase 5's 2^20 path reads their launches, and H4's, which
    # a sign launches too (the batch prover's trees, B = 1).  H7's record
    # is made in phase 6, which reads the batch's launches.  H12 is
    # launched by the verify.
    for name in K.KERNELS:
        if name not in LARGE_KERNELS + SHARDED_ONLY + VERIFY_KERNELS:
            assert sign_launches[name] > 0, f"{name} was not launched during sign"
        if name in VERIFY_KERNELS:
            assert path_launches[name] > sign_launches[name], f"{name} was not launched during verify"
        if name not in LARGE_KERNELS + BATCH_KERNELS + SHARDED_ONLY:
            records[name]["launches"] = path_launches[name]
    print(f"signature: {len(sig)} bytes")

    sign_s, verify_s, phase_s = [], [], []
    for _ in range(4):                       # one warm-up, three timed
        before = dict(scheme.stark.timer.totals)
        ts = time.perf_counter()
        s = scheme.sign(sk, DOC)
        torch.cuda.synchronize()
        tv = time.perf_counter()
        phase_s.append({p: scheme.stark.timer.totals[p] - before.get(p, 0.0) for p in PHASES})
        assert scheme.verify(pk, DOC, s)
        torch.cuda.synchronize()
        sign_s.append(tv - ts)
        verify_s.append(time.perf_counter() - tv)
    print(f"sign seconds (median of 3): {statistics.median(sign_s[1:]):.4f} {sign_s[1:]} on {smi}")
    print(f"verify seconds (median of 3): {statistics.median(verify_s[1:]):.4f} {verify_s[1:]} on {smi}")
    for k in range(1, 4):
        parts = ", ".join(f"{p} {phase_s[k][p]:.5f}" for p in PHASES)
        total = sum(phase_s[k].values())
        print(f"sign phases (PhaseTimer, s): {parts}; sum {total:.5f} = "
              f"{100 * total / sign_s[k]:.1f}% of the sign's {sign_s[k]:.5f}")
    K.reset_launch_counts()
    scheme.sign(sk, DOC)
    torch.cuda.synchronize()
    warm_launches = sum(K.LAUNCHES.values())
    print(f"kernel launches in one warm sign: {warm_launches} {dict(K.LAUNCHES)}")
    K.reset_launch_counts()
    assert scheme.verify(pk, DOC, sig)
    torch.cuda.synchronize()
    verify_launches = sum(K.LAUNCHES.values())
    print(f"kernel launches in one verify: {verify_launches} {dict(K.LAUNCHES)}")
    assert warm_launches <= SIGN_MAX_LAUNCHES, f"a warm sign made {warm_launches} launches"
    assert verify_launches <= VERIFY_MAX_LAUNCHES, f"a verify made {verify_launches} launches"
    # the Rescue trace alone: 27 rounds on one 2-element state, one launch
    sk_dev = device_from_ints([sk.value], dev)
    K.reset_launch_counts()
    trace_batch(sk_dev)
    torch.cuda.synchronize()
    trace_launches = dict(K.LAUNCHES)
    print(f"launches in one trace_batch (B = 1): {trace_launches}")
    assert trace_launches == {**{name: 0 for name in K.KERNELS}, "rescue_perm": 1}, trace_launches
    trace_s = []
    for _ in range(3):
        ts = time.perf_counter()
        trace_batch(sk_dev)
        torch.cuda.synchronize()
        trace_s.append(time.perf_counter() - ts)
    print(f"rescue trace_batch seconds (median of 3): {statistics.median(trace_s):.4f} {trace_s} on {smi}")
    profile_sign(lambda: scheme.sign(sk, DOC))
    host_profile("one sign", lambda: scheme.sign(sk, DOC), HOST_SPANS)
    phase("2 main path", t2)

    # -- phase 3: card against CPU, byte for byte ----------------------------
    t3 = time.perf_counter()
    sig_card = scheme.sign(sk, DOC, det_urandom(b"chip smoke sign"))
    cpu = FastRPSSS(device="cpu")
    sig_cpu = cpu.sign(sk, DOC, det_urandom(b"chip smoke sign"))
    assert sig_card == sig_cpu, "the card and the CPU signed different bytes"
    assert scheme.verify(pk, DOC, sig_cpu), "the card rejected the CPU's signature"
    assert cpu.verify(pk, DOC, sig_card), "the CPU rejected the card's signature"
    print(f"card and CPU signatures identical ({len(sig_card)} bytes), cross-verified")

    # the generic prover (compile_air) at the production parameters: on the
    # card with every commitment built by H4, on the CPU with host trees
    field, rp = Field.main(), RescuePrime()
    witness = field.sample(b"chip smoke generic prover")
    trace, boundary = rp.trace(witness), rp.boundary_constraints(rp.hash(witness))
    generic = {}
    for label, device, hash_mode in (("card", dev, "1"), ("cpu", "cpu", "0")):
        os.environ["STARK_TPU_DEVICE_HASH"] = hash_mode
        try:
            stark = FastStark.from_config(RPSSS_CONFIG, field, device=device)
            air = rp.transition_constraints(stark.omicron)
            K.reset_launch_counts()
            tg = time.perf_counter()
            tz = stark.preprocess()
            proof = stark.prove(trace, air, boundary, tz, urandom=det_urandom(b"chip smoke generic"))
            if label == "card":
                torch.cuda.synchronize()
                generic_launches = dict(K.LAUNCHES)
                assert isinstance(tz.rows, DeviceRows), "the device commitment was not taken"
            prove_s = time.perf_counter() - tg
        finally:
            del os.environ["STARK_TPU_DEVICE_HASH"]
        assert stark.verify(proof, air, boundary, tz.root,
                            air_index_evaluator=make_index_air_evaluator(stark)), \
            f"the {label} rejected its own generic proof: {stark.last_rejection}"
        generic[label] = (stark, air, tz, proof)
        print(f"generic prover on the {label} (compile_air, STARK_TPU_DEVICE_HASH={hash_mode}): "
              f"preprocess + prove {prove_s:.3f} s, {len(proof)} bytes; phases: "
              + ", ".join(f"{k} {v:.4f}" for k, v in stark.timer.totals.items()))
    print(f"launches in the card's generic preprocess + prove: {generic_launches}")
    assert generic_launches["merkle"] > 0, "H4 was not launched by the forced device commit"
    (cs, cair, ctz, cproof), (hs, hair, htz, hproof) = generic["card"], generic["cpu"]
    assert ctz.root == htz.root, "the card's zerofier root differs from the CPU's"
    assert cproof == hproof, "the card (H4 trees) and the CPU (host trees) proved different bytes"
    assert cs.verify(hproof, cair, boundary, ctz.root), "the card rejected the CPU's generic proof"
    assert hs.verify(cproof, hair, boundary, htz.root), "the CPU rejected the card's generic proof"
    print("generic proofs identical on the card and the CPU, cross-verified")
    phase("3 card vs cpu", t3)

    # -- phase 4: H4 at the large-trace size against N1 ----------------------
    t4 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2024)
    cw = torch.randint(0, 1 << 16, (8, TREE_LARGE), generator=gen, device=dev, dtype=torch.int32)
    cw[7] &= 0x3FFF                          # the top limb below p's: every value < p
    rows, dtree = device_commit_paired(cw)
    torch.cuda.synchronize()
    tn = time.perf_counter()
    host_rows = canonical_np(cw)
    htree = MerkleTree.from_limbs_paired(host_rows)
    n1_first_s = time.perf_counter() - tn
    assert dtree.root == htree.root, "H4's root at 2^22 differs from N1's"
    for k in range(3):
        got = dtree.levels[k].cpu().numpy().view("uint32").T.astype("<u4").tobytes()
        assert got == htree.levels[k].tobytes(), f"H4's level {k} at 2^22 differs from N1's"
    idx = sorted(random.Random(22).sample(range(TREE_LARGE // 2), 64))
    assert open_multi(dtree, idx) == open_multi(htree, idx), "the 64-index multiproofs differ"
    assert rows.gather(idx[:4]) == [int.from_bytes(host_rows[i].astype("<u2").tobytes(), "little")
                                    for i in idx[:4]]
    print(f"H4 at n = 2^22: root, levels 0-2 and a 64-index multiproof equal N1's")
    canon = rows.canon
    ms = time_launches(lambda: MK.merkle_paired(canon), 10)
    dev_us = profile_kernel("merkle", lambda: MK.merkle_paired(canon), 5)
    bound = merkle_bound(TREE_LARGE, 1)
    n1_ms = host_ms(lambda: MerkleTree.from_limbs_paired(canonical_np(cw)), 3)
    print(f"  merkle (8, {TREE_LARGE}): {ms:.6f} ms/commit (1 launch), device "
          f"{fmt_us(dev_us)}/commit, bound {bound[0]:.6f} ms ({bound[1]}); N1 with the copy to "
          f"the host {n1_ms:.3f} ms (median of 3; first {1e3 * n1_first_s:.3f} ms) on {smi}")
    phase("4 H4 at 2^22", t4)

    # -- phase 5: the large-trace path ---------------------------------------
    t5 = time.perf_counter()
    large_path(dev, smi, records, worst_err, compare)
    assert worst_mismatch == 0, "a kernel disagrees with its plain version"
    phase("5 large-trace path", t5)

    # -- phase 6: batch signing ----------------------------------------------
    t6 = time.perf_counter()
    batch_path(dev, smi, records, worst_err, compare, scheme)
    assert worst_mismatch == 0, "a kernel disagrees with its plain version"
    phase("6 batch signing", t6)

    # -- phase 7: multi-GPU sharding on the one card -------------------------
    t7 = time.perf_counter()
    sharded_path(dev, smi, records, worst_err, compare)
    assert worst_mismatch == 0, "a kernel disagrees with its plain version"
    phase("7 sharded", t7)

    print(f"total: {time.perf_counter() - t0:.3f} s")
    print(smi)
    print(json.dumps({"kernels": [records[name] for name in K.KERNELS]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
