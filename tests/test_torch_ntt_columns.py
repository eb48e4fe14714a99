"""H9 (field/kernels.py:ntt_columns, csrc/ntt_columns.cu), step 1 of the
distributed NTT on one shard, on the CPU.

The kernel has no CPU mode; chip_smoke.py holds it against its plain
version on the card.  Here, with zero tolerance (every value is an exact
field element):

* the plain version equals the glue it replaces (parallel/ntt_dist.py:
  glue_columns on pieces pre-scaled by the coset table, as the sharded
  ``_lde`` scaled them) and a Python-int model of
  out[k, t] = (1/A) c^b w_n^(k b) sum_a w_A^(a k) c^(a B) piece_a[t],
  for S = 2, 4, 8, both directions, with and without the pre-scale, at
  n = 512 and 4096, lead () and (3,), the pieces as views of the shards
  (a local mesh) and as slices of one receive buffer (torch.distributed);
* the distributed NTT with the fused scale equals the JAX package's
  sharded ``_lde`` on its virtual CPU devices (as
  tests/test_torch_ntt_dist.py runs K18);
* a model of H9's index plan: each thread's (lead row, t) and the
  sectors a warp's loads touch, the coarse/fine split of every twiddle
  and scale exponent within the tables, and the twiddle exponents against
  the JAX package's ``idx_full`` (captured from its make_distributed_ntt);
* the route: one H9 call a shard, no H0, no H3 on rows of S points and no
  cross-twiddle table for S <= 8; the glue above 8 shards, counted in
  ``ShardedFastStark.routes``; the wrapper's checks.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from stark_anatomy_tpu.field.scalar import Field as JaxField
from stark_anatomy_tpu.parallel import ntt_dist as JND
from stark_anatomy_tpu.parallel.sharded_stark import ShardedFastStark as JaxShardedFastStark
from stark_anatomy_tpu.utils.convert import device_from_ints as jax_from_ints
from stark_anatomy_tpu.utils.convert import ints_from_device as jax_ints
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field import ops as F
from stark_anatomy_tpu_torch.field.scalar import Field, P
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
from stark_anatomy_tpu_torch.ops import ntt as NTT
from stark_anatomy_tpu_torch.ops.domain import coset_table
from stark_anatomy_tpu_torch.parallel import ntt_dist as ND
from stark_anatomy_tpu_torch.parallel.mesh import Mesh, Sharded
from stark_anatomy_tpu_torch.parallel.sharded_stark import ShardedFastStark
from stark_anatomy_tpu_torch.utils.convert import device_from_ints, ints_from_device

torch.set_num_threads(1)

OFFSET = Field.main().generator().value
THREADS = 128                   # csrc/ntt_columns.cu:kColumnsThreads
WARP = 32


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def cpu_mesh(shards: int) -> Mesh:
    return Mesh([[torch.device("cpu")] * shards])


def random_shards(n, shards, lead, seed):
    """S shards (*lead, 8, B) of seeded field elements, and their ints."""
    rng = random.Random(seed)
    rows = int(np.prod(lead, dtype=np.int64))
    B = n // shards
    ints = [[rng.randrange(P) for _ in range(rows * B)] for _ in range(shards)]
    tensors = [device_from_ints(v, "cpu").view(8, rows, B).movedim(1, 0).contiguous().view(lead + (8, B))
               for v in ints]
    return tensors, ints


def piece_sets(tensors, s, w, lead):
    """Shard s's pieces as the two exchanges give them: views of the shards
    (a local mesh) and slices of one receive buffer (torch.distributed)."""
    views = [x[..., s * w:(s + 1) * w] for x in tensors]
    buf = torch.cat([v.reshape(-1) for v in views])
    per = views[0].numel()
    return {"views": views, "buffer": [buf[a * per:(a + 1) * per].view(lead + (8, w)) for a in range(len(views))]}


def as_ints(out):
    """(..., 8, A, w) -> ints in (..., A, w) order."""
    return ints_from_device(out.transpose(-3, -2).contiguous())


def model(ints, n, shards, s, rows, inverse, offset):
    """The column step on Python ints: out[r][k][t], flattened (r, k, t)."""
    A, B = shards, n // shards
    w = B // A
    omega = Field.main().primitive_nth_root(n).value
    root = pow(omega, P - 2, P) if inverse else omega
    root_a = pow(root, B, P)                      # w_A^(+-1)
    assert pow(Field.main().primitive_nth_root(A).value, P - 2 if inverse else 1, P) == root_a
    a_inv = pow(A, P - 2, P) if inverse else 1
    c = 1 if offset is None else offset
    out = []
    for r in range(rows):
        col = [[ints[a][r * B + s * w + t] * pow(c, a * B, P) % P for t in range(w)] for a in range(A)]
        for k in range(A):
            wk = [pow(root_a, a * k, P) for a in range(A)]
            for t in range(w):
                b = s * w + t
                acc = sum(wk[a] * col[a][t] for a in range(A)) % P
                out.append(acc * a_inv * pow(c, b, P) * pow(root, k * b, P) % P)
    return out


@pytest.mark.parametrize("lead", [(), (3,)], ids=["lead0", "lead3"])
@pytest.mark.parametrize("n", [512, 4096])
@pytest.mark.parametrize("offset", [None, OFFSET], ids=["plain", "coset"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_plain_equals_glue_and_model(shards, inverse, offset, n, lead):
    A, B = shards, n // shards
    w = B // A
    rows = int(np.prod(lead, dtype=np.int64))
    tensors, ints = random_shards(n, shards, lead, seed=n + 10 * shards + inverse)
    table = coset_table(offset, n, "cpu") if offset is not None else None
    tabs = ND.column_tables(n, shards, inverse, offset, "cpu")
    for s in sorted({0, shards - 1}):
        sets = piece_sets(tensors, s, w, lead)
        glue_in = sets["views"]
        if table is not None:   # the old _lde: shard a times its slice of offset^i
            glue_in = [F.mont_mul(p, table[:, a * B + s * w:a * B + (s + 1) * w].contiguous())
                       for a, p in enumerate(glue_in)]
        glue = ND.glue_columns(glue_in, n, shards, s, inverse)
        want = model(ints, n, shards, s, rows, inverse, offset)
        assert as_ints(glue) == want
        for layout, pieces in sets.items():
            got = K.ntt_columns_plain(pieces, s * w, tabs)
            assert got.shape == lead + (8, A, w) and got.is_contiguous(), layout
            assert torch.equal(got, glue), (layout, s)
            assert torch.equal(K.ntt_columns(pieces, s * w, tabs), got), layout


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_lde_equals_jax_sharded_lde(shards):
    """ShardedFastStark._lde (the distributed NTT with the scale fused into
    step 1) against the JAX package's sharded _lde (scale, then K18), at the
    topology test's parameters (FRI domain 512)."""
    rp = RescuePrime()
    params = (4, 2, 4, rp.m, rp.N + 1)
    stark = ShardedFastStark(Field.main(), *params, transition_constraints_degree=3,
                             mesh=cpu_mesh(shards))
    jmesh = JaxMesh(np.array(jax.devices()[:shards]).reshape(1, shards), axis_names=("dp", "sp"))
    jstark = JaxShardedFastStark(JaxField.main(), *params, transition_constraints_degree=3, mesh=jmesh)
    order = stark.fri_domain_length
    rng = random.Random(300 + shards)
    vals = [[rng.randrange(P) for _ in range(order // 4)] for _ in range(2)]
    coeffs = torch.stack([device_from_ints(v, "cpu") for v in vals])
    got = stark._lde(coeffs, OFFSET, order)
    assert stark.routes["ntt_dist"] == 1 and stark.routes["columns_h9"] == 1
    want = jstark._lde(jnp.stack([jax_from_ints(v) for v in vals]), OFFSET, order)
    assert ints_from_device(got.gather()) == jax_ints(want)
    assert torch.equal(got.gather(), NTT.coset_evaluate(coeffs, OFFSET, order))


def jax_idx_full(n, shards, monkeypatch):
    """The JAX package's cross-twiddle indices idx_full (S, A, B/A), taken
    from its make_distributed_ntt (the jnp.take that gathers them)."""
    seen = []
    take = jnp.take

    def spy(arr, idx, *args, **kwargs):
        if not isinstance(idx, jax.core.Tracer):        # the tables' jitted gathers trace theirs
            seen.append(np.asarray(idx))
        return take(arr, idx, *args, **kwargs)

    monkeypatch.setattr(JND.jnp, "take", spy)
    jmesh = JaxMesh(np.array(jax.devices()[:shards]).reshape(1, shards), axis_names=("dp", "sp"))
    JND.make_distributed_ntt(n, jmesh, "sp")
    monkeypatch.setattr(JND.jnp, "take", take)
    (idx,) = [i for i in seen if i.size == n]
    return idx.reshape(shards, shards, n // shards // shards)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_index_plan(shards, monkeypatch):
    """H9's plan as csrc/ntt_columns.cu runs it: thread g of a grid-stride
    loop takes (row g >> log w, t = g mod w); a warp's loads of each piece's
    limb row touch the fewest 32-byte sectors its columns can; every
    twiddle and scale exponent splits within the tables; the twiddle's
    running product r^b, r^(2b), ... reaches the exponents of the JAX
    package's idx_full."""
    n = 4096
    A, B = shards, n // shards
    w = B // A
    log_w = w.bit_length() - 1
    f = ND.column_split(n, shards)
    log_f = f.bit_length() - 1
    tabs = ND.column_tables(n, shards, False, OFFSET, "cpu")
    assert tabs.fine.shape == (8, f) and tabs.coarse.shape == (8, B // f)
    assert tabs.scale_fine.shape == (8, f) and tabs.scale_coarse.shape == (8, B // f)
    assert tabs.rows.shape == (8, A) and tabs.powers.shape == (8, A)
    assert f * f >= B >= f and max(f, B // f) <= 2 * int(B ** 0.5) + 1
    idx = jax_idx_full(n, shards, monkeypatch)
    for rows in (1, 3):
        total = rows * w
        for grid in (1, 5, -(-total // THREADS)):
            covered = []
            for block in range(grid):
                for g0 in range(block * THREADS, total, grid * THREADS):
                    for lane0 in range(g0, min(g0 + THREADS, total), WARP):
                        warp = [(g >> log_w, g & (w - 1)) for g in range(lane0, min(lane0 + WARP, total))]
                        covered += warp
                        # a warp's loads of a limb row of a piece: row r's
                        # words r sb + l sl + t, consecutive t within each
                        # row, so each sector is read whole
                        assert warp == sorted(warp)
                        for r in {r for r, _ in warp}:
                            ts = [t for rr, t in warp if rr == r]
                            assert ts == list(range(ts[0], ts[0] + len(ts)))
            assert sorted(covered) == [(r, t) for r in range(rows) for t in range(w)]
    for s in range(shards):
        for t in range(w):
            b = s * w + t
            hi, lo = b >> log_f, b & (f - 1)
            assert hi < B // f and lo < f and hi * f + lo == b          # r^b and c^b
            e = 0
            for k in range(A):                                           # r^(k b) by the running product
                assert e == idx[s, k, t] and e < n
                e += b
    assert all(a * B < n for a in range(A))                              # c^(a B): A entries


def test_route_is_one_h9_call_a_shard(monkeypatch):
    """On the h9 route a distributed transform calls H9 once a shard, no H0
    (no twiddle, no coset scale), no H3 on rows of S points and builds no
    cross-twiddle table; values as the one-device transform."""
    n, S = 4096, 8
    mesh = cpu_mesh(S)
    rng = random.Random(5)
    x = device_from_ints([rng.randrange(P) for _ in range(2 * n)], "cpu").view(8, 2, n).movedim(1, 0).contiguous()
    xs = Sharded.place(mesh, x)
    fwd, inv = ND.make_distributed_ntt(n, mesh), ND.make_distributed_ntt(n, mesh, inverse=True)
    assert fwd.columns == inv.columns == "h9"
    fwd(xs, OFFSET), inv(xs)                                   # the tables, once
    calls = {"ntt_columns": 0, "mont_mul": 0, "ntt": []}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            if name == "ntt":
                calls[name].append(args[0].shape[-1])
            else:
                calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in calls:
        monkeypatch.setattr(K, name, count(name, getattr(K, name)))
    ND._TWIDDLES.clear()
    got = fwd(xs, OFFSET)
    assert calls["ntt_columns"] == S and calls["mont_mul"] == 0
    assert calls["ntt"] == [n // S] * S, "H3 ran on rows other than the shard rows"
    assert not ND._TWIDDLES
    assert torch.equal(got.gather(), NTT.coset_evaluate(x, OFFSET, n))
    assert torch.equal(inv(got).gather(), NTT.coset_scale(x, OFFSET))


@pytest.mark.parametrize("n", [512, 1024])
def test_glue_route_above_eight_shards(n, monkeypatch):
    """S = 16: step 1 runs as glue by the shape rule (no H9 call), with the
    pre-scale before the exchange; values as the one-device transforms;
    ShardedFastStark counts the route."""
    S = 16
    assert ND.column_route(S) == "glue" and ND.column_route(K.COLUMNS_MAX) == "h9"

    def refuse(*args, **kwargs):
        raise AssertionError("H9 was called on the glue route")

    monkeypatch.setattr(K, "ntt_columns", refuse)
    mesh = cpu_mesh(S)
    rng = random.Random(n)
    x = device_from_ints([rng.randrange(P) for _ in range(n)], "cpu")
    xs = Sharded.place(mesh, x)
    fwd, inv = ND.make_distributed_ntt(n, mesh), ND.make_distributed_ntt(n, mesh, inverse=True)
    assert fwd.columns == "glue"
    assert torch.equal(fwd(xs, OFFSET).gather(), NTT.coset_evaluate(x, OFFSET, n))
    assert torch.equal(fwd(xs).gather(), NTT.ntt(x))
    assert torch.equal(inv(xs).gather(), NTT.intt(x))
    rp = RescuePrime()
    stark = ShardedFastStark(Field.main(), 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, mesh=mesh)
    coeffs = x[..., : n // 4][None]
    got = stark._lde(coeffs, OFFSET, n)
    assert stark.routes["columns_glue"] == 1 and "columns_h9" not in stark.routes
    assert torch.equal(got.gather(), NTT.coset_evaluate(coeffs, OFFSET, n))


def test_wrapper_checks():
    """The wrapper refuses what H9 does not take, and a tensor that is on
    neither the CPU nor a CUDA card: it never falls back."""
    n, S = 512, 4
    B = n // S
    w = B // S
    tabs = ND.column_tables(n, S, False, OFFSET, "cpu")
    tensors, _ = random_shards(n, S, (), seed=1)
    pieces = [x[..., :w] for x in tensors]
    assert K.ntt_columns(pieces, 0, tabs).shape == (8, S, w)
    with pytest.raises(ValueError, match="A = 1, 2, 4 or 8"):
        K.ntt_columns(pieces[:3], 0, tabs)
    with pytest.raises(ValueError, match="power of two"):
        K.ntt_columns([p[..., :6] for p in pieces], 0, tabs)
    with pytest.raises(ValueError, match="outside"):
        K.ntt_columns(pieces, B - w + 1, tabs)
    with pytest.raises(ValueError, match="together"):
        K.ntt_columns(pieces, 0, tabs._replace(rows=None))
    with pytest.raises(ValueError, match="powers"):
        K.ntt_columns(pieces, 0, ND.column_tables(n, 2 * S, False, None, "cpu"))
    with pytest.raises(ValueError, match="adjacent"):
        K.ntt_columns([x[..., : 2 * w:2] for x in tensors], 0, tabs)
    with pytest.raises(ValueError, match="CUDA"):
        K.ntt_columns([p.to("meta") for p in pieces], 0, tabs)
