"""Multi-process support: process initialisation, the controller predicate,
the scaling harness and the analytic collective bytes.

The port of stark_anatomy_tpu/parallel/multihost.py.  Every process runs the
same program; ``init_distributed`` joins them into one
``torch.distributed`` group (NCCL for CUDA ranks, gloo for CPU ones), and a
mesh built under it (parallel/mesh.py:make_mesh) holds one shard a rank.
Every rank computes the same transcript from the gathered roots and
openings, so every rank returns the same proof bytes; rank 0 is the
controller.

Launch (one command per process; the coordinator is a host:port or an
init URL such as ``file:///tmp/stark_rendezvous``):

    STARK_TPU_COORD=host0:1234 STARK_TPU_NUM_PROC=4 STARK_TPU_PROC_ID=k \\
        python your_prover.py

Collective scaling needs several cards: on one card the in-process
shards measure the sharding's overhead, not its speedup.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

_RANK_DEVICE: Optional[torch.device] = None


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Initialise torch.distributed from the arguments or the STARK_TPU_COORD,
    STARK_TPU_NUM_PROC and STARK_TPU_PROC_ID variables.

    Returns False, and does nothing, without a coordinator or a process id
    (the single-process case: callers need no branch).  Else it joins the
    group and returns True: NCCL on this rank's CUDA card (cuda:(id mod
    cards)) unless ``device`` is the CPU, which takes gloo.  A world of one
    process is allowed (NCCL runs on a single card so)."""
    global _RANK_DEVICE
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("STARK_TPU_COORD")
    num_processes = num_processes or int(os.environ.get("STARK_TPU_NUM_PROC", 0))
    process_id = process_id if process_id is not None else int(os.environ.get("STARK_TPU_PROC_ID", -1))
    if not coordinator or num_processes < 1 or process_id < 0:
        return False
    if device is not None and torch.device(device).type == "cpu":
        rank_dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA is not available; pass device='cpu' for gloo")
        rank_dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(rank_dev)
        backend = "nccl"
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    _RANK_DEVICE = rank_dev
    return True


def rank_device() -> torch.device:
    """This rank's device: the one ``init_distributed`` chose, or for a
    group initialised elsewhere, cuda:(rank mod cards) under NCCL and the
    CPU under gloo."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def shutdown() -> None:
    """Leave the group ``init_distributed`` joined."""
    global _RANK_DEVICE
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE = None


def is_controller() -> bool:
    """True on the process that reports results: rank 0, or the only
    process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def make_mimc_scaling_prover(
    steps: int, num_colinearity_checks: int = 4, security_level: int = 8, devices=None,
):
    """``prove_fn(num_shards)`` for :func:`scaling_report`: one real
    end-to-end MiMC proof (``prove_chain``) by a FastStark (1 shard) or a
    ShardedFastStark on a (dp=1, sp=num_shards) mesh.  The mesh is over
    ``devices[:s]`` when ``devices`` is given (a virtual mesh, such as one
    card repeated), else over the real devices (``make_mesh``, which
    raises with too few).  Provers and their preprocessing are built at
    the first call for each shard count, so a timed call proves only;
    ``prove_fn.get(s)`` gives (stark, tz) and ``prove_fn.drop(s)`` frees
    them."""
    from ..field.scalar import Field, FieldElement
    from ..models.mimc import MiMC, prove_chain
    from ..protocols.fast_stark import FastStark
    from .mesh import Mesh, make_mesh
    from .sharded_stark import ShardedFastStark

    field = Field.main()
    x = FieldElement(field.sample(b"scaling-bench").value, field)
    provers = {}

    def mesh_for(s: int) -> Mesh:
        if devices is None:
            return _row_mesh(make_mesh(s), s)
        return Mesh([list(devices)[:s]])

    def get(s: int):
        if s not in provers:
            mesh = mesh_for(s)
            args = (field, 4, num_colinearity_checks, security_level, 1, steps + 1)
            if s == 1:
                stark = FastStark(*args, transition_constraints_degree=3, device=mesh.device)
            else:
                stark = ShardedFastStark(*args, transition_constraints_degree=3, mesh=mesh)
            mimc = MiMC(steps, device=stark.device)
            provers[s] = (stark, stark.preprocess(), mimc)
        return provers[s][:2]

    def prove_fn(s: int):
        get(s)
        stark, tz, mimc = provers[s]
        _, proof, _ = prove_chain(mimc, stark, x, tz)
        return proof

    prove_fn.get = get
    prove_fn.drop = lambda s: provers.pop(s, None)
    return prove_fn


def _row_mesh(mesh, s: int):
    """A (1, s) mesh over the first s devices of ``mesh``."""
    from .mesh import Mesh

    flat = [d for row in mesh.devices for d in row]
    return Mesh([flat[:s]], backend=mesh.backend)


def collective_bytes_model(stark, s: int) -> dict:
    """Analytic per-proof collective volume for a ShardedFastStark proof on
    sp = s shards (the JAX package's model, parallel/multihost.py): three
    all_to_alls of the whole (NLIMBS, n) array a distributed NTT, an
    all_to_all of an n-element codeword moving n * 32 B * (s - 1)/s; one
    length-M iNTT and one length-N LDE a register, one length-N LDE for the
    randomizer; and about 2 n_r * 32 B a FRI round."""
    R = stark.num_registers
    M = stark.omicron_domain_length
    N = stark.fri_domain_length
    elt = 32  # resident bytes per element (8 x 32-bit limb lanes)
    frac = (s - 1) / s if s > 1 else 0.0
    per = {}
    total = 0
    for name, count, n in (
        ("trace iNTT (M)", R, M),
        ("trace LDE (N)", R, N),
        ("randomizer LDE (N)", 1, N),
    ):
        b = 3 * count * n * elt * frac
        per[name] = b
        total += b
    fri_bytes = 0
    n = N
    for _ in range(stark.fri.num_rounds() - 1):
        fri_bytes += 2 * n * elt * frac
        n //= 2
    per["FRI folds (sum rounds)"] = fri_bytes
    total += fri_bytes
    per["TOTAL"] = total
    return per


def scaling_report(prove_fn, shard_counts, reps: int = 3):
    """Prove seconds against shard count.  ``prove_fn(num_shards)`` runs one
    proof on that many shards and returns when done; one call warms up,
    then ``reps`` are timed.  Returns [{shards, seconds, speedup,
    efficiency}] (speedup and efficiency against the first count)."""
    results = []
    base = None
    for s in shard_counts:
        prove_fn(s)  # warm
        _sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            prove_fn(s)
        _sync()
        dt = (time.perf_counter() - t0) / reps
        if base is None:
            base = dt
        speedup = base / dt
        results.append({
            "shards": s,
            "seconds": dt,
            "speedup": speedup,
            "efficiency": speedup / (s / shard_counts[0]),
        })
    return results


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
