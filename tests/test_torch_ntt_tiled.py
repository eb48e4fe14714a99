"""H8, the NTT above H3's 8192 points in two tiled launches
(csrc/ntt_tiled.cu, wrapper and plain version field/kernels.py:ntt_tiled
and ntt_tiled_plain, route ops/ntt.py:_tiled), on the CPU.

* The plain version, through ``ops/ntt.py:ntt`` with NTT_MAX lowered so
  that n = 2^10 .. 2^14 takes H8's route, against the JAX package's
  ``ops/stage_ntt.py:staged_ntt`` (forward and inverse, with and without
  the pre- and post-scale, batch 1 and 3) and ``ops/ntt.py:ntt``.
* A model of H8's plan on Python ints, as tests/test_torch_kernel_plans.py
  models H3: which cluster rank and thread moves which (limb, position)
  words, that every warp instruction on the strided side moves whole
  32-byte sectors (every thread's items, in a block of under 8 threads)
  and every word is moved once a step, the slots each
  block's shared memory takes (each written once, a quarter warp's eight
  16-byte accesses in distinct bank groups), the inner transforms by H3's
  model, where each output lands and which twiddle index each point takes
  (j1 k2 mod n); held against the plain version step by step and against
  the JAX transform.
* The route: above NTT_MAX a transform is exactly two wrapper calls (no
  H3, H0 or H1 call, no transpose table in ``ops/ntt.py:_TWIDDLES``).
* The wrapper's checks, the packing, and the source's constants.

CUDA kernels have no CPU mode: chip_smoke.py holds H8 against this plain
version on the card.  Tolerance: zero (exact field arithmetic).
"""

import collections
import os
import re

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.ops import ntt as JN
from stark_anatomy_tpu.ops import stage_ntt as JS
from stark_anatomy_tpu.ops.domain import DOMAINS as JDOMAINS
from stark_anatomy_tpu.utils.convert import device_from_ints as jfrom
from stark_anatomy_tpu.utils.convert import ints_from_device as jints
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.scalar import Field, P
from stark_anatomy_tpu_torch.ops import ntt as TN
from stark_anatomy_tpu_torch.ops.domain import DOMAINS, coset_table
from stark_anatomy_tpu_torch.utils.convert import ints_from_device as tints
from test_torch_kernel_plans import ntt_model, slot, table_ints

torch.set_num_threads(1)

NTT_TILED_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "stark_anatomy_tpu_torch", "csrc", "ntt_tiled.cu")
ONE = (1 << 128) % P                      # the Montgomery one: a scale table of it scales nothing


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def field_limbs(shape, seed):
    """Seeded int32 limbs (..., 8, n) of values below p."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.int64)
    x[..., 7, :] &= 0x3FFF
    return x.astype(np.int32)


def one_table(n):
    limbs = [(ONE >> (16 * k)) & 0xFFFF for k in range(8)]
    return np.tile(np.array(limbs, dtype=np.int32).reshape(8, 1), (1, n))


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

# (n, inverse): one staged_ntt compile each, batch 3, both scales given;
# the tables of the Montgomery one give the transform without scales
STAGED = [(1 << 10, False), (1 << 14, True)]


@pytest.fixture(scope="module")
def staged_refs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        refs = {}
        for n, inverse in STAGED:
            x = field_limbs((3, 8, n), n + inverse)
            pre, post = field_limbs((8, n), n + 10), field_limbs((3, 8, n), n + 11)
            ones = one_table(n)
            want = {}
            for scaled, (a, b) in ((True, (pre, post)), (False, (ones, np.broadcast_to(ones, post.shape)))):
                out = JS.staged_ntt(x.astype(np.uint32), inverse, scale_pre=a.astype(np.uint32),
                                    scale_post=np.ascontiguousarray(b).astype(np.uint32))
                want[scaled] = np.asarray(out).astype(np.int32)
            refs[(n, inverse)] = (x, pre, post, want)
        return refs


@pytest.mark.parametrize("n,inverse", STAGED, ids=[f"n{n}-{'inv' if i else 'fwd'}" for n, i in STAGED])
@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
@pytest.mark.parametrize("batch", [1, 3])
def test_tiled_route_matches_jax_staged_ntt(monkeypatch, staged_refs, n, inverse, scaled, batch):
    monkeypatch.setattr(TN, "NTT_MAX", 128)       # 2^10 = 32 x 32 .. 2^14 = 128 x 128 take H8
    x, pre, post, want = staged_refs[(n, inverse)]
    rows = slice(0, batch) if batch > 1 else 0
    args = (torch.from_numpy(pre), torch.from_numpy(post[rows])) if scaled else (None, None)
    got = TN.ntt(torch.from_numpy(x[rows]), inverse, *args)
    assert np.array_equal(got.numpy(), want[scaled][rows])


def test_tiled_route_matches_jax_ntt(monkeypatch):
    """ops/ntt.py:ntt of the JAX package (its scan lowering below 8192)."""
    monkeypatch.setattr(TN, "NTT_MAX", 64)
    n = 1 << 12                                    # 64 x 64
    x = field_limbs((3, 8, n), 41)
    want_f = np.asarray(JN.ntt(x.astype(np.uint32))).astype(np.int32)
    want_i = np.asarray(JN.intt(want_f.astype(np.uint32))).astype(np.int32)
    got = TN.ntt(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want_f)
    assert np.array_equal(TN.intt(got).numpy(), want_i) and np.array_equal(want_i, x)


@pytest.mark.parametrize("n,lead", [(1 << 10, ()), (1 << 13, (3,)), (1 << 14, ())])
@pytest.mark.parametrize("inverse", [False, True])
def test_tiled_route_matches_one_launch_plain(monkeypatch, n, lead, inverse):
    """The route against H3's plain transform over all n points at once."""
    x = torch.from_numpy(field_limbs(lead + (8, n), 7 * n + inverse))
    pre, post = (torch.from_numpy(field_limbs((8, n), 7 * n + k)) for k in (2, 3))
    dom = DOMAINS.get(n, "cpu")
    want = K.ntt_plain(x, dom["inv_powers" if inverse else "fwd_powers"],
                       dom["n_inv"] if inverse else None, pre, post)
    monkeypatch.setattr(TN, "NTT_MAX", 128)
    assert torch.equal(TN.ntt(x, inverse, pre, post), want)


# ---------------------------------------------------------------------------
# the plan: a model of the two steps on Python ints
# ---------------------------------------------------------------------------

def whole_sectors(words, per_sector):
    """The positions one warp instruction moves (or, in a block of fewer
    than 8 threads, one thread's items) cover whole sectors."""
    sectors = collections.Counter(p // per_sector for p in words)
    assert len(set(words)) == len(words) and all(c == per_sector for c in sectors.values()), \
        ("a warp instruction moves part of a sector", sorted(words)[:16])


def distinct_banks(accesses):
    """accesses: the (block, slot) of 8 neighbouring threads (a quarter
    warp's 16-byte accesses); within each block, distinct bank groups."""
    per_block = collections.defaultdict(list)
    for block, s in accesses:
        per_block[block].append(s % 8)
    for banks in per_block.values():
        assert len(set(banks)) == len(banks), ("a bank conflict", accesses)


def lanes(T):
    """The threads of a block by warp: lists of up to 32."""
    return [list(range(w, min(w + 32, T))) for w in range(0, T, 32)]


def cluster_exchange(L, visit):
    """The strided side of a step over a cluster's 8 transforms of L
    points: block r, thread t, item i moves point j = r L/8 + (t + i L/8)
    / 8 of transform q = (t + i L/8) mod 8, to or from slot(j) of block
    q's buffer; visit(r, i, warp, q, j) for each, warp by warp.  Checks
    that a quarter warp's 8 accesses fall in distinct bank groups of each
    block."""
    T, lg_t = L // 8, L.bit_length() - 4
    for r in range(8):
        for i in range(8):
            for warp in lanes(T):
                for q0 in range(0, len(warp), 8):
                    acc = []
                    for t in warp[q0:q0 + 8]:
                        it = t + (i << lg_t)
                        j, q = (r << lg_t) + (it >> 3), it & 7
                        acc.append((q, slot(j)))
                        visit(r, i, warp[0], q, j)
                    distinct_banks(acc)


def tiled_model(x, n1, inverse, pre=None, post=None):
    """H8 on canonical ints, one batch row: (Y, X, twiddle exponents).  The
    step-0 cluster of tile c holds the columns c0 = 8c .. c0 + 7: its block
    r loads points [r n2/8, (r+1) n2/8) of all 8 into the buffer of each
    column's block; each block runs H3's passes (ntt_model, with its bank
    checks); block r stores points [r n2/8, (r+1) n2/8) of the 8 columns,
    times w_n^(j1 k2), to Y[k2 n1 + j1].  The step-1 cluster holds the rows
    k2 = c0 .. c0 + 7 of Y: block q loads row c0 + q whole, and the
    cluster stores X[k2 + n2 k1] as step 0 stores Y, with 1/n and the
    post-scale."""
    n = len(x)
    n2 = n // n1
    lg1, lg2 = n1.bit_length() - 1, n2.bit_length() - 1
    key = "inv_powers" if inverse else "fwd_powers"
    tw1, tw2 = table_ints(DOMAINS.get(n1, "cpu")[key]), table_ints(DOMAINS.get(n2, "cpu")[key])
    fine = table_ints(coset_table(DOMAINS.get(n, "cpu").omega, n2, "cpu", inverse))
    n_inv = pow(n, P - 2, P) if inverse else 1
    y, out, exponents = [None] * n, [None] * n, {}
    read = collections.Counter()
    loads, stores = collections.defaultdict(list), collections.defaultdict(list)

    # step 0: strided loads (words by limb row), packed stores
    for c0 in range(0, n1, 8):
        bufs = [[None] * n2 for _ in range(8)]

        def load(r, i, warp, q, j2):
            pos = c0 + q + n1 * j2
            for limb in range(8):
                loads[(c0, r, i if n2 >= 64 else None, warp, limb)].append(pos)
                read[(limb, pos)] += 1
            assert bufs[q][slot(j2)] is None, "a slot written twice"
            bufs[q][slot(j2)] = x[pos] * (pre[pos] if pre else 1) % P

        cluster_exchange(n2, load)
        done = [ntt_model([b[slot(j)] for j in range(n2)], lg2, tw2, 1) for b in bufs]

        def store(r, i, warp, q, k2):
            j1 = c0 + q
            e = j1 * k2
            assert e < n and (e >> lg2) < n1
            exponents[(j1, k2)] = e
            pos = k2 * n1 + j1
            assert y[pos] is None, "a point of Y written twice"
            stores[(c0, r, i if n2 >= 64 else None, warp)].append(pos)
            y[pos] = done[q][k2] * tw1[e >> lg2] * fine[e & (n2 - 1)] % P

        cluster_exchange(n2, store)
    for words in loads.values():
        whole_sectors(words, 8)               # 8 int32 words a sector
    for words in stores.values():
        whole_sectors(words, 2)               # 2 packed 16-byte elements a sector
    assert len(read) == 8 * n and set(read.values()) == {1}, "a word of x not read exactly once"

    # step 1: a row of Y a block (thread t its points t + i n1/8), then
    # strided stores by limb row
    stores.clear()
    T1, lg_t1 = n1 // 8, lg1 - 3
    for c0 in range(0, n2, 8):
        bufs = [[None] * n1 for _ in range(8)]
        for q in range(8):
            if T1 == 1:                       # one thread: its 8 items, in pairs
                whole_sectors([(c0 + q) * n1 + i for i in range(8)], 2)
            for i in range(8):
                for warp in lanes(T1):
                    pos = [(c0 + q) * n1 + t + (i << lg_t1) for t in warp]
                    if T1 > 1:
                        whole_sectors(pos, 2)
                    for q0 in range(0, len(warp), 8):
                        distinct_banks([(q, slot(t + (i << lg_t1))) for t in warp[q0:q0 + 8]])
                    for t, p_ in zip(warp, pos):
                        bufs[q][slot(t + (i << lg_t1))] = y[p_]
        assert all(v is not None for b in bufs for v in b), "a slot left unwritten"
        done = [ntt_model([b[slot(j)] for j in range(n1)], lg1, tw1, 1) for b in bufs]

        def store(r, i, warp, q, k1):
            k = c0 + q + n2 * k1
            assert out[k] is None, "a point of X written twice"
            for limb in range(8):
                stores[(c0, r, i if n1 >= 64 else None, warp, limb)].append(k)
            out[k] = done[q][k1] * n_inv * (post[k] if post else 1) % P

        cluster_exchange(n1, store)
    for words in stores.values():
        whole_sectors(words, 8)
    assert all(v is not None for v in out), "a point of X left unwritten"
    return y, out, exponents


def packed_ints(words):
    """Canonical ints of packed (n, 4) Montgomery words."""
    w = words.numpy().astype(np.uint32).astype(object)
    mont = w[:, 0] | (w[:, 1] << 32) | (w[:, 2] << 64) | (w[:, 3] << 96)
    r_inv = pow(1 << 128, P - 2, P)
    return [int(v) * r_inv % P for v in mont]


def mont_limbs(vals):
    """(8, n) int32 Montgomery limbs of canonical ints."""
    m = [v * (1 << 128) % P for v in vals]
    return torch.tensor([[(v >> (16 * k)) & 0xFFFF for v in m] for k in range(8)], dtype=torch.int32)


MODEL_CASES = [(8, 8, False, False), (8, 16, True, False), (32, 32, False, True), (32, 64, True, True)]


@pytest.mark.parametrize("n1,n2,inverse,scaled", MODEL_CASES,
                         ids=[f"{a}x{b}-{'inv' if i else 'fwd'}{'-scaled' if s else ''}"
                              for a, b, i, s in MODEL_CASES])
def test_tiled_model_matches_plain_and_jax(n1, n2, inverse, scaled):
    n = n1 * n2
    rng = np.random.default_rng(500 + n + inverse)
    x, pre, post = ([int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)] for _ in range(3))
    if not scaled:
        pre = post = None
    y, out, exponents = tiled_model(x, n1, inverse, pre, post)
    assert exponents == {(j1, k2): j1 * k2 % n for j1 in range(n1) for k2 in range(n2)}
    # the plain version, step by step
    key = "inv_powers" if inverse else "fwd_powers"
    outer, inner = DOMAINS.get(n1, "cpu")[key], DOMAINS.get(n2, "cpu")[key]
    fine = coset_table(DOMAINS.get(n, "cpu").omega, n2, "cpu", inverse)
    tpre, tpost = (None if v is None else mont_limbs(v) for v in (pre, post))
    yw = K.ntt_tiled_plain(mont_limbs(x), 0, n1, inner, (outer, fine), scale=tpre)
    assert packed_ints(yw) == y
    zw = K.ntt_tiled_plain(yw, 1, n1, outer, n_inv=DOMAINS.get(n, "cpu")["n_inv"] if inverse else None,
                           scale=tpost)
    assert tints(zw) == out
    # the JAX transform (its 1/n applied as in the kernel), the scales on the host
    dom = JDOMAINS.get(n)
    src = [v * (pre[j] if pre else 1) % P for j, v in enumerate(x)]
    want = jints(JN._ntt_core_jit(jfrom(src), dom["bitrev"], dom[key], dom["n_inv"] if inverse else None))
    assert out == [v * (post[k] if post else 1) % P for k, v in enumerate(want)]


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

SPIED = ("ntt_tiled", "ntt", "mont_mul", "add_mod", "sub_mod", "mont_pow")


def spy_wrappers(monkeypatch, calls):
    for name in SPIED:
        wrapper = getattr(K, name)

        def spy(*args, _name=name, _wrapper=wrapper, **kwargs):
            calls.append((_name, args[1]) if _name == "ntt_tiled" else (_name,))
            return _wrapper(*args, **kwargs)

        monkeypatch.setattr(K, name, spy)


ROUTE_CALLS = {
    "ntt": lambda x, n, g: TN.ntt(x),
    "intt": lambda x, n, g: TN.intt(x),
    "coset_evaluate": lambda x, n, g: TN.coset_evaluate(x[..., : n // 4], g, n),
    "coset_interpolate": lambda x, n, g: TN.coset_interpolate(x, g),
}


@pytest.mark.parametrize("call", list(ROUTE_CALLS))
@pytest.mark.parametrize("lead", [(), (3,)], ids=["b1", "b3"])
def test_route_above_ntt_max_is_two_tiled_launches(monkeypatch, call, lead):
    n = 1 << 12
    g = Field.main().generator().value
    x = torch.from_numpy(field_limbs(lead + (8, n), 9))
    fn = ROUTE_CALLS[call]
    want = fn(x, n, g)                             # H3's one launch, and the coset tables made
    monkeypatch.setattr(TN, "NTT_MAX", 64)         # 64 x 64
    before = dict(TN._TWIDDLES)
    calls = []
    spy_wrappers(monkeypatch, calls)
    got = fn(x, n, g)
    assert calls == [("ntt_tiled", 0), ("ntt_tiled", 1)]
    assert TN._TWIDDLES == before, "the route made a transpose twiddle table"
    assert torch.equal(got, want)


def test_route_above_ntt_max_squared_recurses_over_h8(monkeypatch):
    """n > NTT_MAX^2 (threshold 64 at 8192, as chip_smoke checks it): the
    four-step glue over rows, whose transforms are H8's and H3's."""
    n = 8192
    x = torch.from_numpy(field_limbs((8, n), 11))
    want = TN.ntt(x)
    monkeypatch.setattr(TN, "NTT_MAX", 64)
    calls = []
    spy_wrappers(monkeypatch, calls)
    assert torch.equal(TN.ntt(x), want)
    tiled = [c for c in calls if c[0] == "ntt_tiled"]
    assert tiled == [("ntt_tiled", 0), ("ntt_tiled", 1)], "the rows of 128 points: one H8 transform"
    assert ("ntt",) in calls


@pytest.mark.parametrize("n,max_,route", [(1 << 24, 8192, "tiled"), (1 << 14, 8192, "tiled"),
                                          (1 << 25, 8192, "four_step"), (8192, 8192, "h3"),
                                          (64, 8, "tiled"), (32, 8, "four_step"), (1 << 13, 64, "four_step")])
def test_route_choice(n, max_, route):
    n1, n2 = K.tiled_split(n)
    assert n1 * n2 == n and n1 <= n2 <= 2 * n1
    if n <= max_:
        assert route == "h3"
    else:
        tiled = n1 >= K.TILED_MIN and n2 <= min(max_, K.TILED_MAX)
        assert ("tiled" if tiled else "four_step") == route


# ---------------------------------------------------------------------------
# the wrapper, the packing, the source
# ---------------------------------------------------------------------------

def test_wrapper_never_falls_back_off_the_cpu():
    x = torch.empty(8, 4096, dtype=torch.int32, device="meta")
    p = torch.empty(8, 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.ntt_tiled(x, 0, 64, p, (p, p))


@pytest.mark.parametrize("shape,step,n1", [
    ((8, 4096), 2, 64),             # no such step
    ((8, 64), 0, 4),                # n1 below TILED_MIN
    ((8, 1 << 26), 0, 8192),        # n1 above TILED_MAX
    ((8, 1000), 0, 8),              # not a power of two
    ((4096, 8), 1, 64),             # step 1 takes packed (..., n, 4) words
    ((4, 4096), 0, 64),             # step 0 takes 8 limb rows
])
def test_tiled_layout_refuses(shape, step, n1):
    with pytest.raises(ValueError):
        K.tiled_layout(torch.zeros(shape, dtype=torch.int32), step, n1)


def test_tiled_layout_refuses_strided_and_wrong_type():
    x = torch.zeros(8, 2 * 4096, dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError):
        K.tiled_layout(x, 0, 64)
    with pytest.raises(ValueError):
        K.tiled_layout(torch.zeros(8, 4096, dtype=torch.int64), 0, 64)
    assert K.tiled_layout(torch.zeros(3, 4096, 4, dtype=torch.int32), 1, 64) == (3, 4096, 64)


def test_pack_words_round_trip_and_twiddle_words():
    x = torch.from_numpy(field_limbs((3, 8, 64), 5))
    w = K.pack_words(x)
    assert w.shape == (3, 64, 4) and w.dtype == torch.int32 and w.is_contiguous()
    assert torch.equal(K.unpack_words(w), x)
    powers = DOMAINS.get(64, "cpu")["fwd_powers"]
    assert torch.equal(K.twiddle_words(powers), K.pack_words(powers))


def test_constants_match_the_source():
    text = open(NTT_TILED_CU).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert 1 << const["kTileLog"] == 8 <= K.TILED_MIN        # a cluster's tile: the model's 8
    assert 1 << const["kTiledMinLog"] == K.TILED_MIN and 1 << const["kTiledMaxLog"] == K.TILED_MAX
    assert K.TILED_MAX <= K.NTT_MAX
