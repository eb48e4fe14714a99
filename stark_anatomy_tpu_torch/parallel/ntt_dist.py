"""Distributed NTT over a codeword sharded on the mesh's sp axis.

The port of stark_anatomy_tpu/parallel/ntt_dist.py (K18, a ``shard_map``
graph there).  Four-step (Bailey) NTT for n = A * B with A = S shards:
view the coefficients as an A x B matrix, row a on shard a,

1. an all_to_all brings each shard a (B/A)-wide slice of every row; the
   column transforms of length A run there, batched over the B/A columns,
   and entry (a, b) is multiplied by the cross twiddle omega_n^(a b);
2. a second all_to_all regroups whole rows: each shard transforms its row
   (length B);
3. the result stands as Y[a][b] = X_hat[a + A b]; a third all_to_all and a
   transpose inside each shard give the natural order.

The transforms are ops/ntt.py:ntt (H3, or the four-step over H3 for B >
8192) and the twiddle is H0; the all_to_alls are ``Mesh.exchange``
(copies on a local mesh, ``all_to_all_single`` under torch.distributed).
The inverse runs inverse transforms, whose 1/A and 1/B make the 1/n the
JAX package multiplies by at the end: the same values, one launch less.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..field import ops as F
from ..field.limbs import NLIMBS
from ..ops import ntt as NTT
from ..ops.domain import DOMAINS
from .mesh import Mesh, Sharded

_TWIDDLES: Dict[tuple, torch.Tensor] = {}


def dist_ntt_ok(n: int, shards: int) -> bool:
    """The routing rule of the sharded prover (the JAX package's
    sharded_stark.py:_dist_ntt): the distributed transform for S >= 2
    shards when S^2 divides n."""
    return shards >= 2 and n % (shards * shards) == 0


def cross_twiddles(n: int, shards: int, shard: int, inverse: bool, device) -> torch.Tensor:
    """Shard ``shard``'s cross twiddles (B/A, NLIMBS, A): entry [t][:, a] is
    omega_n^(+-a (shard B/A + t)), gathered from the domain's power table
    (omega^-e = omega^(n - e)); cached per (n, S, shard, direction,
    device)."""
    key = (n, shards, shard, inverse, torch.device(device))
    if key not in _TWIDDLES:
        A, B = shards, n // shards
        w = B // A
        b = shard * w + torch.arange(w, device=device)
        e = (b.view(w, 1) * torch.arange(A, device=device)) % n            # (B/A, A)
        if inverse:
            e = (n - e) % n
        tab = DOMAINS.get(n, device)["fwd_powers"].index_select(-1, e.flatten())   # (8, B/A * A)
        _TWIDDLES[key] = tab.view(NLIMBS, w, A).transpose(0, 1).contiguous()
    return _TWIDDLES[key]


def make_distributed_ntt(n: int, mesh: Mesh, axis: str = "sp", inverse: bool = False):
    """The distributed (i)NTT of codewords of length ``n`` sharded on their
    last axis over ``axis``: fn(x: Sharded (..., 8, n)) -> Sharded, in
    natural order.  Needs S^2 | n (S = 1 runs the row transform alone)."""
    assert axis == "sp", "the codeword axis is sharded over sp"
    S = mesh.shape[axis]
    assert n % (S * S) == 0, "need n divisible by shards^2"
    A, B = S, n // S
    w = B // A

    def slices(src: int, dst: int):
        return [(dst * w, (dst + 1) * w)]

    def run(x: Sharded) -> Sharded:
        assert x.length == n and x.mesh is mesh, (x.length, n)
        # step 1: column transforms of length A; piece a' of row a goes to
        # shard a', which stacks the rows: (..., 8, A, B/A)
        got = mesh.exchange(x.shards, slices)
        cols = {}
        for s, pieces in got.items():
            c = torch.stack(pieces, dim=-2)                          # (..., 8, A, B/A)
            c = c.movedim(-1, -3).contiguous()                       # (..., B/A, 8, A)
            if A > 1:
                c = NTT.ntt(c, inverse)
            c = F.mont_mul(c, cross_twiddles(n, S, s, inverse, c.device))
            cols[s] = c.movedim(-3, -1).reshape(c.shape[:-3] + (NLIMBS, B))   # (..., 8, A * B/A)
        # step 2: whole rows back on their shards, the row transform
        got = mesh.exchange(cols, slices)
        rows = {s: NTT.ntt(torch.cat(pieces, dim=-1).contiguous(), inverse) for s, pieces in got.items()}
        # step 3: natural order.  Shard a holds X_hat[a + A b']; with b' =
        # q B/A + t, the element goes to shard q at position t A + a
        got = mesh.exchange(rows, slices)
        out = {}
        for s, pieces in got.items():
            y = torch.stack(pieces, dim=-1)                          # (..., 8, B/A, A): [t][a]
            out[s] = y.reshape(y.shape[:-2] + (B,)).contiguous()
        return Sharded(mesh, out, n)

    return run
