"""Device meshes and sharded codewords for multi-GPU proving.

The port of stark_anatomy_tpu/parallel/mesh.py.  The parallel axes are the
JAX package's:

  dp  -- data parallelism over independent proofs (batch signing);
  sp  -- parallelism over the codeword axis (the NTT/FRI/Merkle domain).

JAX shards an array by a ``NamedSharding`` and lets XLA run every
pointwise op per shard and insert the collectives.  Here both are
explicit:

* ``Mesh`` is a (dp, sp) grid of torch devices with a backend: "local",
  one process holding every shard (on several cards, or on one device
  repeated: a virtual mesh, the analog of the JAX package's virtual CPU
  devices), or "dist", one shard per ``torch.distributed`` rank;
* ``Sharded`` is a codeword sharded on its last axis: the shards this
  process holds, shard index -> tensor (..., 8, n/S) on its device (all S
  on a local mesh, one under torch.distributed), the JAX package's
  ``addressable_shards``;
* ``pointwise`` maps a function over the shards; ``Mesh.exchange`` is the
  one collective: every shard sends each other shard slices of its last
  axis, by copies on a local mesh and by ``all_to_all_single`` under
  torch.distributed.  The halo of a roll, the distributed NTT's
  all_to_alls, the FRI's pairing and a gather are all exchanges, so the
  prover's sharded code is written once for both backends.

``make_mesh(n)`` raises when fewer than n real devices exist, as the JAX
``make_mesh`` does; a virtual mesh exists only when the caller passes
``devices=``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[int, int]


def factor_mesh(n_devices: int) -> Tuple[int, int]:
    """Split n devices into (dp, sp) as evenly as possible, sp-major."""
    dp = 1
    sp = n_devices
    while sp > dp * 2 and sp % 2 == 0:
        sp //= 2
        dp *= 2
    return dp, sp


class Mesh:
    """A (dp, sp) grid of devices.  ``backend`` is "local" (this process
    holds every shard; ``devices`` is the dp x sp grid) or "dist" (one
    shard per torch.distributed rank: rank r is (r // sp, r % sp) on
    ``device``).  Build one with ``make_mesh`` or ``MeshConfig.build``."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: Sequence[Sequence], backend: str = "local"):
        rows = [[torch.device(d) for d in row] for row in devices]
        assert rows and rows[0] and all(len(r) == len(rows[0]) for r in rows), "devices must form a grid"
        self.backend = backend
        self.devices = rows
        self.shape = {"dp": len(rows), "sp": len(rows[0])}
        self.sp_group = None
        self.rank = 0
        if backend == "dist":
            import torch.distributed as dist

            assert dist.is_initialized(), "a dist mesh needs torch.distributed initialised"
            dp, sp = self.shape["dp"], self.shape["sp"]
            assert dist.get_world_size() == dp * sp, (
                f"a ({dp}, {sp}) dist mesh needs {dp * sp} ranks, have {dist.get_world_size()}"
            )
            self.rank = dist.get_rank()
            # every rank creates every row's group, in the same order
            groups = [dist.new_group(list(range(d * sp, (d + 1) * sp))) if dp > 1 else None
                      for d in range(dp)]
            self.sp_group = groups[self.rank // sp]
        else:
            assert backend == "local", f"unknown mesh backend {backend!r}"

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend!r}, devices={self.devices})"

    # -- where the shards are ------------------------------------------------
    @property
    def dp_index(self) -> int:
        """This process's row of the grid (0 on a local mesh)."""
        return self.rank // self.shape["sp"]

    def local_shards(self) -> List[int]:
        """The sp shard indices this process holds."""
        if self.backend == "dist":
            return [self.rank % self.shape["sp"]]
        return list(range(self.shape["sp"]))

    def device_of(self, shard: int) -> torch.device:
        """The device of sp shard ``shard`` in this process's row."""
        return self.devices[self.dp_index][shard]

    @property
    def device(self) -> torch.device:
        """The device of this process's first shard."""
        return self.device_of(self.local_shards()[0])

    # -- collectives -----------------------------------------------------------
    def exchange(self, shards: Dict[int, torch.Tensor],
                 plan: Callable[[int, int], Sequence[Interval]]) -> Dict[int, List[torch.Tensor]]:
        """Every sp shard sends every other one slices of its last axis:
        ``plan(src, dst)`` lists the (lo, hi) intervals of shard src's last
        axis that go to shard dst, joined in order into one piece.  Returns,
        for each local dst, the non-empty pieces from src = 0, 1, ... in
        order.  Every shard has the same leading shape and dtype.  A local
        mesh copies each piece to dst's device (a view when src is dst); a
        dist mesh runs one ``all_to_all_single`` over the row's group."""
        S = self.shape["sp"]
        if self.backend == "local":
            out = {}
            for dst in range(S):
                dev = self.device_of(dst)
                pieces = []
                for src in range(S):
                    ivs = plan(src, dst)
                    if sum(hi - lo for lo, hi in ivs):
                        pieces.append(_cut(shards[src], ivs).to(dev))
                out[dst] = pieces
            return out
        import torch.distributed as dist

        me = self.rank % S
        x = shards[me]
        lead = tuple(x.shape[:-1])
        sends = [_cut(x, plan(me, dst)) for dst in range(S)]
        recv_len = [sum(hi - lo for lo, hi in plan(src, me)) for src in range(S)]
        width = math.prod(lead)
        send = torch.cat([p.reshape(-1) for p in sends])
        recv = torch.empty(width * sum(recv_len), dtype=x.dtype, device=x.device)
        dist.all_to_all_single(recv, send, [width * k for k in recv_len], [p.numel() for p in sends],
                               group=self.sp_group)
        pieces, at = [], 0
        for k in recv_len:
            if k:
                pieces.append(recv[at:at + width * k].view(lead + (k,)))
            at += width * k
        return {me: pieces}

    def merge(self, local: dict) -> dict:
        """Join the dicts the sp shards' processes hold (one process on a
        local mesh: its dict is already whole)."""
        if self.backend == "local":
            return local
        import torch.distributed as dist

        parts = [None] * self.shape["sp"]
        dist.all_gather_object(parts, local, group=self.sp_group)
        out = {}
        for part in parts:
            out.update(part)
        return out

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank (a local mesh: ``obj``)."""
        if self.backend == "local":
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def gather_all(self, obj) -> list:
        """Every rank's ``obj``, in rank order (a local mesh: [obj])."""
        if self.backend == "local":
            return [obj]
        import torch.distributed as dist

        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, obj)
        return parts

    def synchronize(self) -> None:
        """Wait for every local device."""
        for dev in {self.device_of(s) for s in self.local_shards()}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def _cut(x: torch.Tensor, ivs: Sequence[Interval]) -> torch.Tensor:
    """The intervals of ``x``'s last axis, joined in order."""
    parts = [x[..., lo:hi] for lo, hi in ivs if hi > lo]
    if not parts:
        return x[..., :0]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _available_devices() -> List[torch.device]:
    """The real devices one process can shard over: the CUDA cards."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A (dp, sp) mesh of ``n_devices`` (``factor_mesh``).

    ``devices`` given: a local mesh over them, repeated entries allowed (a
    virtual mesh, e.g. ``[torch.device("cuda:0")] * 8`` or
    ``[torch.device("cpu")] * 8``).  Without it: under torch.distributed a
    dist mesh over the ranks, one shard a rank on this rank's device; else
    a local mesh over the CUDA cards.  Raises when fewer devices (or ranks)
    exist than asked for: a silently smaller mesh would run less sharded."""
    if devices is not None:
        devices = list(devices)
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(f"make_mesh({n_devices}) but {len(devices)} devices were given")
            devices = devices[:n_devices]
        dp, sp = factor_mesh(len(devices))
        return Mesh([devices[d * sp:(d + 1) * sp] for d in range(dp)])
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"make_mesh({n_devices}) under torch.distributed with {world} ranks: "
                             f"a dist mesh holds one shard a rank")
        dp, sp = factor_mesh(world)
        from .multihost import rank_device

        return Mesh([[rank_device()] * sp for _ in range(dp)], backend="dist")
    available = _available_devices()
    if not available or (n_devices is not None and len(available) < n_devices):
        raise ValueError(
            f"make_mesh({n_devices}) but only {len(available)} CUDA devices are available: a "
            f"silently smaller mesh would run unsharded (for a virtual mesh pass devices=, "
            f"e.g. [torch.device('cuda:0')] * n)"
        )
    return make_mesh(n_devices, devices=available[: n_devices or len(available)])


@dataclass(frozen=True)
class ShardSpec:
    """Which axis of an array is split over which mesh axis: ``spec`` has one
    entry per array axis, a mesh axis name or None (replicated), as JAX's
    PartitionSpec."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def proof_batch_sharding(mesh: Mesh) -> ShardSpec:
    """Per-proof inputs laid out (NLIMBS, B): batch axis over dp."""
    return ShardSpec(mesh, (None, "dp"))


def codeword_sharding(mesh: Mesh, batched: bool = True) -> ShardSpec:
    """Codewords in the limb-first layout: (B, NLIMBS, N) batch over dp and
    domain over sp, or (NLIMBS, N) domain over sp."""
    return ShardSpec(mesh, ("dp", None, "sp") if batched else (None, "sp"))


# ---------------------------------------------------------------------------
# sharded codewords
# ---------------------------------------------------------------------------

class Sharded:
    """A codeword (..., 8, length) sharded on its last axis over the mesh's
    sp axis: shard s holds [s * length / S, (s + 1) * length / S).
    ``shards`` holds the ones this process has (all S on a local mesh)."""

    __slots__ = ("mesh", "shards", "length")

    def __init__(self, mesh: Mesh, shards: Dict[int, torch.Tensor], length: int):
        self.mesh = mesh
        self.shards = dict(sorted(shards.items()))
        self.length = length

    @property
    def num_shards(self) -> int:
        return self.mesh.shape["sp"]

    @property
    def per(self) -> int:
        return self.length // self.num_shards

    @property
    def shape(self) -> tuple:
        return tuple(next(iter(self.shards.values())).shape[:-1]) + (self.length,)

    def __getitem__(self, i) -> "Sharded":
        """Index the leading axes of every shard."""
        return Sharded(self.mesh, {s: x[i] for s, x in self.shards.items()}, self.length)

    @classmethod
    def place(cls, mesh: Mesh, x: torch.Tensor, length: Optional[int] = None) -> "Sharded":
        """Shard a whole tensor's last axis, zero-padded to ``length`` (by
        default its own): each shard is cut from ``x`` and padded alone, so
        the padded whole never exists."""
        n = x.shape[-1]
        length = n if length is None else length
        S = mesh.shape["sp"]
        assert length % S == 0 and n <= length, (n, length, S)
        per = length // S
        out = {}
        for s in mesh.local_shards():
            part = x[..., s * per:min((s + 1) * per, n)].to(mesh.device_of(s))
            if part.shape[-1] < per:
                part = torch.nn.functional.pad(part, (0, per - part.shape[-1]))
            out[s] = part.contiguous()
        return cls(mesh, out, length)

    def gather(self) -> torch.Tensor:
        """The whole codeword on this process's first device (an exchange of
        every shard to every shard under torch.distributed)."""
        if self.mesh.backend == "local":
            dev = self.mesh.device
            return torch.cat([x.to(dev) for x in self.shards.values()], dim=-1)
        per = self.per
        got = self.mesh.exchange(self.shards, lambda src, dst: [(0, per)])
        return torch.cat(next(iter(got.values())), dim=-1)

    def redistribute(self, wants: Callable[[int], Sequence[Interval]], per_out: int) -> Dict[int, torch.Tensor]:
        """New blocks of ``per_out`` elements: block t joins the global
        intervals ``wants(t)`` (ascending, within [0, length)) and is
        zero-padded at the end to per_out.  One exchange."""
        per = self.per

        def plan(src: int, dst: int):
            lo_s = src * per
            out = []
            for a, b in wants(dst):
                lo, hi = max(a, lo_s), min(b, lo_s + per)
                if lo < hi:
                    out.append((lo - lo_s, hi - lo_s))
            return out

        got = self.mesh.exchange(self.shards, plan)
        out = {}
        for t, pieces in got.items():
            dev = self.mesh.device_of(t)
            blk = torch.cat(pieces, dim=-1) if pieces else torch.zeros(
                self.shape[:-1] + (0,), dtype=torch.int32, device=dev)
            if blk.shape[-1] < per_out:
                blk = torch.nn.functional.pad(blk, (0, per_out - blk.shape[-1]))
            out[t] = blk.contiguous()
        return out

    def resize(self, length: int) -> "Sharded":
        """The codeword zero-padded (or cut) to ``length``, resharded."""
        per_out = length // self.num_shards
        keep = min(length, self.length)
        blocks = self.redistribute(lambda t: [(t * per_out, min((t + 1) * per_out, keep))], per_out)
        return Sharded(self.mesh, blocks, length)

    def roll_left(self, k: int) -> "Sharded":
        """The codeword rolled left by k (element i + k at i, cyclic): each
        shard takes the first k columns of the next one (a halo exchange);
        ``torch.roll(x, -k, dims=-1)`` on the whole."""
        S, per = self.num_shards, self.per
        assert 0 < k <= per, f"a halo of {k} needs shards of at least {k} elements, have {per}"
        got = self.mesh.exchange(self.shards, lambda src, dst: [(0, k)] if src == (dst + 1) % S else [])
        return Sharded(self.mesh, {s: torch.cat([self.shards[s][..., k:], got[s][0]], dim=-1)
                                   for s in self.shards}, self.length)


def pointwise(fn, *args):
    """``fn`` on every local shard: each ``Sharded`` argument gives its shard,
    a tensor is moved to the shard's device, anything else passes as it is.
    Returns a ``Sharded`` (or a tuple of them, if ``fn`` returns a tuple).
    Only for functions whose every output element depends on the inputs at
    the same position (and tables that broadcast)."""
    sharded = [a for a in args if isinstance(a, Sharded)]
    assert sharded, "pointwise needs a Sharded argument"
    mesh, length = sharded[0].mesh, sharded[0].length
    assert all(a.length == length for a in sharded), "pointwise over codewords of different lengths"
    outs = {}
    for s in sharded[0].shards:
        dev = mesh.device_of(s)
        call = [a.shards[s] if isinstance(a, Sharded)
                else a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
        outs[s] = fn(*call)
    first = next(iter(outs.values()))
    if isinstance(first, tuple):
        return tuple(Sharded(mesh, {s: o[i] for s, o in outs.items()}, length)
                     for i in range(len(first)))
    return Sharded(mesh, outs, length)


def shard_parts(part: torch.Tensor, whole, *tables):
    """The tables' shards at the place of ``part`` in ``whole``: for a model
    function called per shard (pointwise) with a shard of ``whole`` that
    must read the same shard of its own sharded tables.  Unsharded:
    the tables as they are."""
    if not isinstance(whole, Sharded):
        return tables
    s = next(s for s, x in whole.shards.items() if x is part)
    return tuple(t.shards[s] if isinstance(t, Sharded) else t for t in tables)
