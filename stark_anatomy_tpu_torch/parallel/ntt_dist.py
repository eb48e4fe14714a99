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

Step 1 is H9 (field/kernels.py:ntt_columns), one launch a shard for A <=
COLUMNS_MAX: the column transforms, the cross twiddle from two small
tables and, for a coset evaluation (``offset``), the pre-scale
offset^(a B + b) that the JAX package's sharded ``_lde`` applies before
the transform.  It reads the exchanged pieces where they lie and writes
the layout step 2 exchanges.  Above COLUMNS_MAX shards step 1 runs as
glue (``glue_columns``: a stack, H3 on rows of A points, H0 with the
cached ``cross_twiddles``, the pre-scale an H0 launch a shard before the
exchange); ``column_route`` states the rule.  The row transforms are
ops/ntt.py:ntt (H3, or H8 for B > 8192); the all_to_alls are
``Mesh.exchange`` (copies on a local mesh, ``all_to_all_single`` under
torch.distributed).  The inverse runs inverse transforms, whose 1/A and
1/B make the 1/n the JAX package multiplies by at the end: the same
values, one launch less.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..field import kernels as K
from ..field import ops as F
from ..field.limbs import NLIMBS
from ..field.scalar import P
from ..ops import ntt as NTT
from ..ops.domain import DOMAINS, coset_table
from .mesh import Mesh, Sharded, pointwise

_TWIDDLES: Dict[tuple, torch.Tensor] = {}


def dist_ntt_ok(n: int, shards: int) -> bool:
    """The routing rule of the sharded prover (the JAX package's
    sharded_stark.py:_dist_ntt): the distributed transform for S >= 2
    shards when S^2 divides n."""
    return shards >= 2 and n % (shards * shards) == 0


def column_route(shards: int) -> str:
    """Step 1's route by the shape: "h9" (one H9 launch a shard) for S <=
    K.COLUMNS_MAX, whose column transforms H9 holds in registers, else
    "glue" (``glue_columns``)."""
    return "h9" if shards <= K.COLUMNS_MAX else "glue"


def column_split(n: int, shards: int) -> int:
    """F, the fine table's length of H9's split b = (b / F) F + (b mod F)
    over a shard's B = n / S columns: 2^ceil(log2(B) / 2)."""
    log_b = (n // shards).bit_length() - 1
    return 1 << ((log_b + 1) // 2)


def column_tables(n: int, shards: int, inverse: bool, offset: Optional[int], device) -> K.ColumnTables:
    """H9's tables (``K.ColumnTables``) for the distributed (i)NTT of n
    points over S shards: the S-point domain table, omega_n^(+-b) split at
    F (``column_split``), the pre-scale's offset^(a B), (offset^F)^i and
    offset^i where ``offset`` is given, and 1/S for the inverse.  Tables of
    S, B/F and F entries, cached (ops/domain.py)."""
    A, B = shards, n // shards
    f = column_split(n, shards)
    omega = DOMAINS.get(n, device).omega
    dom = DOMAINS.get(A, device)
    scale = ()
    if offset is not None:
        scale = (coset_table(pow(offset, B, P), A, device), coset_table(pow(offset, f, P), B // f, device),
                 coset_table(offset, f, device))
    return K.ColumnTables(dom["inv_powers" if inverse else "fwd_powers"],
                          coset_table(pow(omega, f, P), B // f, device, inverse),
                          coset_table(omega, f, device, inverse), *(scale or (None,) * 3),
                          dom["n_inv"] if inverse else None)


def cross_twiddles(n: int, shards: int, shard: int, inverse: bool, device) -> torch.Tensor:
    """Shard ``shard``'s cross twiddles (B/A, NLIMBS, A): entry [t][:, a] is
    omega_n^(+-a (shard B/A + t)), gathered from the domain's power table
    (omega^-e = omega^(n - e)); cached per (n, S, shard, direction,
    device).  The glue route's table (H9 builds none)."""
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


def glue_columns(pieces, n: int, shards: int, shard: int, inverse: bool) -> torch.Tensor:
    """Step 1 on shard ``shard`` as glue, the pieces pre-scaled already:
    stacked to (..., B/A, 8, A), H3 over the A points, H0 with
    ``cross_twiddles``; returns the contiguous (..., 8, A, B/A) that
    ``K.ntt_columns`` returns."""
    c = torch.stack(list(pieces), dim=-2)                    # (..., 8, A, B/A)
    c = c.movedim(-1, -3).contiguous()                       # (..., B/A, 8, A)
    if shards > 1:
        c = NTT.ntt(c, inverse)
    c = F.mont_mul(c, cross_twiddles(n, shards, shard, inverse, c.device))
    return c.movedim(-3, -1).contiguous()


def make_distributed_ntt(n: int, mesh: Mesh, axis: str = "sp", inverse: bool = False):
    """The distributed (i)NTT of codewords of length ``n`` sharded on their
    last axis over ``axis``: fn(x: Sharded (..., 8, n), offset=None) ->
    Sharded, in natural order, of x pre-scaled by offset^i where an offset
    is given (a coset evaluation).  Needs S^2 | n (S = 1 runs the row
    transform alone).  ``fn.columns`` names step 1's route
    (``column_route``)."""
    assert axis == "sp", "the codeword axis is sharded over sp"
    S = mesh.shape[axis]
    assert n % (S * S) == 0, "need n divisible by shards^2"
    A, B = S, n // S
    w = B // A
    route = column_route(S)
    scales: Dict[int, Sharded] = {}          # the glue route's pre-scale tables, by offset

    def slices(src: int, dst: int):
        return [(dst * w, (dst + 1) * w)]

    def run(x: Sharded, offset: Optional[int] = None) -> Sharded:
        assert x.length == n and x.mesh is mesh, (x.length, n)
        if offset is not None and route == "glue":
            if offset not in scales:
                scales[offset] = Sharded.place(mesh, coset_table(offset, n, mesh.device))
            x = pointwise(F.mont_mul, x, scales[offset])
        # step 1: column transforms of length A; piece a' of row a goes to
        # shard a', which writes (..., 8, A, B/A)
        got = mesh.exchange(x.shards, slices)
        cols = {}
        for s, pieces in got.items():
            if route == "h9":
                c = K.ntt_columns(pieces, s * w, column_tables(n, S, inverse, offset, pieces[0].device))
            else:
                c = glue_columns(pieces, n, S, s, inverse)
            cols[s] = c.view(c.shape[:-3] + (NLIMBS, B))
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

    run.columns = route
    return run
