"""The batched prover core of the flagship workload with example
arguments: the port of __graft_entry__.py's ``_build`` and ``entry``.

    from stark_anatomy_tpu_torch.entry import entry
    core, args = entry()            # on the CUDA card; entry("cpu") on the CPU
    combo, bq_lde, rand_lde = core(*args)

The core is parallel/batch.py:build_prover_core over FastStark with the
Rescue-Prime AIR at 2 colinearity checks (the device half of signing a
batch), and the arguments are a batch of B = 2 drawn from
``random.Random(2024)`` in the JAX package's order, so the JAX core fed
the same numbers gives the same outputs.  The multi-GPU dry run
(``dryrun_multichip``) comes with the multi-GPU slice.
"""

from __future__ import annotations

import random

import torch

from .config import resolve_device
from .field.limbs import NLIMBS
from .field.scalar import Field, FieldElement, P
from .models.rescue_prime import RescuePrime, rescue_air_tables
from .ops.domain import mont_const
from .parallel.batch import build_prover_core
from .protocols.fast_stark import FastStark
from .utils.convert import device_from_ints


def _build(checks: int = 2, device=None):
    """(core, make_args, stark): the core and a function of the batch size
    that draws its example arguments from one ``random.Random(2024)``."""
    device = resolve_device(device)
    rng = random.Random(2024)
    field = Field.main()
    rp = RescuePrime()
    stark = FastStark(field, 4, checks, 2 * checks, rp.m, rp.N + 1,
                      transition_constraints_degree=3, device=device)
    tz = stark.preprocess()
    air = rp.transition_constraints(stark.omicron)
    core = build_prover_core(stark, rescue_air_tables(stark))

    def make_args(batch: int):
        sk_vals = [rng.randrange(P) for _ in range(batch)]
        sk = device_from_ints(sk_vals, device)                      # (L, B)
        nrand = stark.num_randomizers
        rand_rows = device_from_ints(
            [rng.randrange(P) for _ in range(batch * rp.m * nrand)], device
        ).reshape(NLIMBS, batch, rp.m, nrand).permute(1, 2, 0, 3)   # (B, R, L, nrand)
        max_degree = stark.max_degree(air)
        rand_poly = device_from_ints(
            [rng.randrange(P) for _ in range(batch * (max_degree + 1))], device
        ).reshape(NLIMBS, batch, max_degree + 1).permute(1, 0, 2)   # (B, L, D+1)
        n_weights = 1 + 2 * len(air) + 2 * rp.m
        weights = torch.stack(
            [mont_const(rng.randrange(P), device) for _ in range(n_weights)]
        )                                                           # (W, L, 1)

        boundary = rp.boundary_constraints(rp.hash(FieldElement(sk_vals[0], field)))
        inv_bz, interp = stark._boundary_tables(boundary)
        tq_bounds = stark.transition_quotient_degree_bounds(air)
        bq_bounds = stark.boundary_quotient_degree_bounds(stark.randomized_trace_length, boundary)
        tq_shift = torch.stack([stark._x_lde_pow(max_degree - b) for b in tq_bounds])
        bq_shift = torch.stack([stark._x_lde_pow(max_degree - b) for b in bq_bounds])
        return (sk, rand_rows, rand_poly, weights, inv_bz, interp,
                tz.inv_codeword, tq_shift, bq_shift)

    return core, make_args, stark


def entry(device=None):
    """(core, example_args) at checks = 2 and a batch of B = 2, on the CUDA
    card unless ``device="cpu"``."""
    core, make_args, _ = _build(checks=2, device=device)
    return core, make_args(2)
