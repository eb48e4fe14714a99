"""The batched prover core of the flagship workload with example
arguments: the port of __graft_entry__.py's ``_build`` and ``entry``.

    from stark_anatomy_tpu_torch.entry import entry
    core, args = entry()            # on the CUDA card; entry("cpu") on the CPU
    combo, bq_lde, rand_lde = core(*args)

The core is parallel/batch.py:build_prover_core over FastStark with the
Rescue-Prime AIR at 2 colinearity checks (the device half of signing a
batch), and the arguments are a batch of B = 2 drawn from
``random.Random(2024)`` in the JAX package's order, so the JAX core fed
the same numbers gives the same outputs.

``dryrun_multichip(n, devices=None)`` is the multi-GPU dry run (the port
of __graft_entry__.py's): on an n-device (dp, sp) mesh, one batch-core
step with the batch split over dp must give the unsplit core's outputs,
and a ShardedFastStark proof over sp must give the one-device prover's
bytes and verify.  It runs on real devices (``make_mesh`` raises with
too few) unless ``devices`` is passed, e.g. ``[torch.device("cuda:0")] *
8``: a virtual mesh on one card.
"""

from __future__ import annotations

import hashlib
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


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The batch core on an n-device mesh split over dp, then the sharded
    prover against the one-device prover; raises on any difference.
    Returns what it checked."""
    from .parallel.mesh import make_mesh

    mesh = make_mesh(n_devices, devices=devices)
    dp = mesh.shape["dp"]
    core, make_args, stark = _build(checks=2, device=mesh.device)
    batch = max(dp, 2)
    args = make_args(batch)
    whole = core(*args)
    if batch % dp == 0:
        b = batch // dp
        cores = {stark.device: core}
        parts = []
        for g in range(dp):
            dev = mesh.devices[g][0]
            if dev not in cores:
                cores[dev] = _build(checks=2, device=dev)[0]
            sk, rand_rows, rand_poly, *shared = (a.to(dev) for a in args)
            sl = slice(g * b, (g + 1) * b)
            parts.append(cores[dev](sk[:, sl], rand_rows[sl], rand_poly[sl], *shared))
        for k, name in enumerate(("combo", "bq_lde", "rand_lde")):
            split = torch.cat([p[k].to(whole[k].device) for p in parts])
            if not torch.equal(split, whole[k]):
                raise AssertionError(f"the batch split over dp = {dp} changed {name}")
    combo = whole[0]
    assert combo.shape[-1] == stark.fri_domain_length
    print(f"dryrun_multichip OK: mesh {mesh.shape} ({mesh.backend}), combo {tuple(combo.shape)}, "
          f"batch of {batch} split over dp = {dp}")
    out = _dryrun_sharded_prover(mesh)
    out.update(mesh=dict(mesh.shape), combo_shape=tuple(combo.shape), batch=batch)
    return out


def _det_urandom(seed: bytes):
    """Deterministic os.urandom stand-in (counter-mode blake2b stream)."""
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def _dryrun_sharded_prover(mesh) -> dict:
    """A ShardedFastStark proof over the mesh's sp axis must be the
    one-device FastStark's, byte for byte, and verify."""
    from .models.rescue_prime import make_air_evaluator
    from .parallel.sharded_stark import ShardedFastStark

    field = Field.main()
    rp = RescuePrime()
    params = (field, 4, 2, 4, rp.m, rp.N + 1)
    input_element = field.sample(b"dryrun-sharded")
    output_element = rp.hash(input_element)
    trace = rp.trace(input_element)
    boundary = rp.boundary_constraints(output_element)
    proofs = {}
    starks = {
        "single": FastStark(*params, transition_constraints_degree=3, device=mesh.device),
        "sharded": ShardedFastStark(*params, transition_constraints_degree=3, mesh=mesh),
    }
    for name, stark in starks.items():
        air = rp.transition_constraints(stark.omicron)
        tz = stark.preprocess()
        proofs[name] = stark.prove(trace, air, boundary, tz, air_evaluator=make_air_evaluator(stark),
                                   urandom=_det_urandom(b"dryrun-seed"))
    if proofs["single"] != proofs["sharded"]:
        raise AssertionError(f"the sharded prover changed the transcript ({len(proofs['single'])} "
                             f"against {len(proofs['sharded'])} bytes)")
    single = starks["single"]
    air = rp.transition_constraints(single.omicron)
    if not single.verify(proofs["sharded"], air, boundary, single.preprocess().root):
        raise AssertionError(f"the sharded proof did not verify: {single.last_rejection}")
    routes = dict(starks["sharded"].routes)
    print(f"dryrun sharded-prover OK: ShardedFastStark proof ({len(proofs['sharded'])} bytes) "
          f"byte-identical to one device over sp = {mesh.shape['sp']}; routes {routes}")
    return {"proof_bytes": len(proofs["sharded"]), "sp": mesh.shape["sp"], "routes": routes}
