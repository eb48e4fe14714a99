"""The AIR kernels' plain versions against the JAX package's graphs, byte
for byte: H10 ``rescue_quotients`` (the boundary and transition quotients
of the Rescue AIR) against _bq_core, _air_quotient_fn and
_rescue_air_kernel; H11 ``combination`` against _combination_core and the
batch core's weighted_sum; H12 ``verify_core`` against _verify_core with
the Rescue index evaluator.  The CPU wrappers run the plain versions, so
each call below goes through the wrapper (its layout checks too).  Inputs
come from a numpy seed, with 0, 1, p - 1, p - 2 and R mod p among them
and, for the verifier, a zero transition-zerofier value (its inverse is
taken as 0).  Tolerance: zero (exact field arithmetic).  Then the paths:
a seeded FastRPSSS signature through the new routes equals the JAX
package's bytes, and the routes that take each kernel."""

import hashlib
import os

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.field import ops as JF
from stark_anatomy_tpu.field.scalar import Field
from stark_anatomy_tpu.models import rescue_prime as JR
from stark_anatomy_tpu.parallel import batch as JB
from stark_anatomy_tpu.protocols import fast_stark as JFS
from stark_anatomy_tpu.utils.convert import device_from_ints as jfrom
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.limbs import R
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.models import rescue_prime as TR
from stark_anatomy_tpu_torch.utils.convert import device_from_ints as tfrom

torch.set_num_threads(1)

SPECIAL = [0, 1, P - 1, P - 2, R % P]
E = 4                      # the expansion factor: the next cycle's offset on the FRI domain


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def pair(shape, seed, special=True):
    """The same Montgomery-form values (..., 8, n) as a JAX array and a
    contiguous CPU tensor, drawn from a numpy seed; the special values at
    the start of the flattened elements."""
    *lead, _, n = shape
    count = int(np.prod(lead, dtype=np.int64)) * n
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(count)]
    if special:
        vals[:len(SPECIAL)] = SPECIAL[:count]
    j = np.moveaxis(np.asarray(jfrom(vals)).reshape((8,) + tuple(lead) + (n,)), 0, -2).copy()
    t = tfrom(vals, "cpu").reshape((8,) + tuple(lead) + (n,)).movedim(0, -2).contiguous()
    return j, t


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def mds_pair():
    t = (TR._mont_matrix(TR.MDS, "cpu"), TR._mont_matrix(TR.MDS_INV, "cpu"))
    return tuple(x.numpy().astype(np.uint32) for x in t), t


# ---------------------------------------------------------------------------
# H10
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("shared", [True, False], ids=["shared_tables", "per_proof_tables"])
@pytest.mark.parametrize("next_form", ["index", "explicit"])
def test_rescue_quotients_match_jax(batch, n, shared, next_form):
    import jax.numpy as jnp

    trace_j, trace_t = pair((batch, 2, 8, n), 10 + n + batch)
    table_shape = (2, 8, n) if shared else (batch, 2, 8, n)
    interp_j, interp_t = pair(table_shape, 20 + n + batch)
    inv_bz_j, inv_bz_t = pair(table_shape, 30 + n + batch)
    c1_j, c1_t = pair((2, 8, n), 40 + n)
    c2_j, c2_t = pair((2, 8, n), 50 + n)
    inv_tz_j, inv_tz_t = pair((8, n), 60 + n)
    (mds_j, mdsi_j), (mds_t, mdsi_t) = mds_pair()
    x_j, _ = pair((8, n), 70 + n)

    def evaluator(x_lde, current, next_):
        return JR._rescue_air_kernel(current, next_, jnp.asarray(c1_j), jnp.asarray(c2_j),
                                     jnp.asarray(mds_j), jnp.asarray(mdsi_j))

    want_bq = JFS._bq_core(jnp.asarray(trace_j), jnp.asarray(interp_j), jnp.asarray(inv_bz_j))
    want_tq = JFS._air_quotient_fn(evaluator, E)(jnp.asarray(x_j), jnp.asarray(trace_j),
                                                 jnp.asarray(inv_tz_j))
    tables = (c1_t, c2_t, mds_t, mdsi_t)
    if next_form == "index":
        bq, tq = K.rescue_quotients(trace_t, interp_t, inv_bz_t, inv_tz_t, tables, E)
    else:
        bq, tq = K.rescue_quotients(trace_t, interp_t, inv_bz_t, inv_tz_t, tables, 0,
                                    next_rows=torch.roll(trace_t, -E, dims=-1))
    same(want_bq, bq)
    same(want_tq, tq)
    assert bq.is_contiguous() and tq.is_contiguous()


def test_rescue_quotients_one_proof_without_a_batch_axis():
    """FastStark.prove's call: a (2, 8, n) trace, no batch axis, against
    the batch of one."""
    n = 64
    _, trace = pair((2, 8, n), 1)
    _, interp = pair((2, 8, n), 2)
    _, inv_bz = pair((2, 8, n), 3)
    _, c = pair((4, 8, n), 4)
    _, inv_tz = pair((8, n), 5)
    _, (mds, mdsi) = mds_pair()
    tables = (c[:2], c[2:], mds, mdsi)
    one = K.rescue_quotients(trace, interp, inv_bz, inv_tz, tables, E)
    batched = K.rescue_quotients(trace[None], interp, inv_bz, inv_tz, tables, E)
    for a, b in zip(one, batched):
        assert a.shape == (2, 8, n)
        assert torch.equal(a, b[0])


def test_rescue_air_plain_is_the_glue():
    """The plain AIR of H10 and H12 is the evaluators' glue
    (models/rescue_prime.py:_rescue_air_kernel), value for value."""
    n = 64
    _, cur = pair((3, 2, 8, n), 80)
    _, nxt = pair((3, 2, 8, n), 81)
    _, c1 = pair((2, 8, n), 82)
    _, c2 = pair((2, 8, n), 83)
    _, (mds, mdsi) = mds_pair()
    assert torch.equal(K.rescue_air_plain(cur, nxt, c1, c2, mds, mdsi),
                       TR._rescue_air_kernel(cur, nxt, c1, c2, mds, mdsi))


# ---------------------------------------------------------------------------
# H11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,R_", [(2, 2), (1, 1), (3, 2)])
@pytest.mark.parametrize("n", [64, 512])
def test_combination_matches_jax_combination_core(C, R_, n):
    import jax.numpy as jnp

    seed = 100 * C + 10 * R_ + n
    rand = pair((8, n), seed)
    tq = pair((C, 8, n), seed + 1)
    bq = pair((R_, 8, n), seed + 2)
    tq_sh = pair((C, 8, n), seed + 3)
    bq_sh = pair((R_, 8, n), seed + 4)
    w = pair((1 + 2 * C + 2 * R_, 8, 1), seed + 5)
    want = JFS._combination_core(*(jnp.asarray(x[0]) for x in (rand, tq, bq, tq_sh, bq_sh, w)))
    same(want, K.combination(*(x[1] for x in (rand, tq, bq, tq_sh, bq_sh, w))))


@pytest.mark.parametrize("per_proof", [True, False], ids=["per_proof_weights", "shared_weights"])
@pytest.mark.parametrize("n", [64, 512])
def test_combination_matches_jax_batch_weighted_sum(per_proof, n):
    """The batch core's form: terms stacked in the transcript's order, the
    weights moved to the lead axis, F.weighted_sum
    (stark_anatomy_tpu/parallel/batch.py:build_prover_core)."""
    import jax.numpy as jnp

    B, C, R_ = 3, 2, 2
    W = 1 + 2 * C + 2 * R_
    rand_j, rand_t = pair((B, 8, n), n + 1)
    tq_j, tq_t = pair((B, C, 8, n), n + 2)
    bq_j, bq_t = pair((B, R_, 8, n), n + 3)
    tsh_j, tsh_t = pair((C, 8, n), n + 4)
    bsh_j, bsh_t = pair((R_, 8, n), n + 5)
    w_j, w_t = pair((B, W, 8, 1) if per_proof else (W, 8, 1), n + 6)

    tq_l = jnp.moveaxis(jnp.asarray(tq_j), -3, 0)
    bq_l = jnp.moveaxis(jnp.asarray(bq_j), -3, 0)
    sh_tq = JF.mont_mul(JB._bcast_shift(jnp.asarray(tsh_j), tq_l), tq_l)
    sh_bq = JF.mont_mul(JB._bcast_shift(jnp.asarray(bsh_j), bq_l), bq_l)
    terms = jnp.concatenate([
        jnp.asarray(rand_j)[None],
        jnp.stack([tq_l, sh_tq], axis=1).reshape((-1,) + tq_l.shape[1:]),
        jnp.stack([bq_l, sh_bq], axis=1).reshape((-1,) + bq_l.shape[1:]),
    ])
    w_lead = jnp.moveaxis(jnp.asarray(w_j), -3, 0)
    while w_lead.ndim < terms.ndim:
        w_lead = w_lead[:, None]
    want = JF.weighted_sum(terms, w_lead)
    same(want, K.combination(rand_t, tq_t, bq_t, tsh_t, bsh_t, w_t))


def test_combination_takes_strided_views():
    """A shard's slices and a single exponent's view load as they lie."""
    n = 64
    _, wide = pair((5, 8, 2 * n), 7)
    views = [wide[k, :, n // 2:n // 2 + n] for k in range(5)]
    rand, tq, bq, tsh, bsh = views[0], views[1][None], views[2][None], views[3][None], views[4][None]
    _, w = pair((5, 8, 1), 8)
    want = K.combination_plain(*(x.contiguous() for x in (rand, tq, bq, tsh, bsh)), w)
    assert torch.equal(K.combination(rand, tq, bq, tsh, bsh, w), want)


# ---------------------------------------------------------------------------
# H12
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def starks():
    from stark_anatomy_tpu.protocols.fast_stark import FastStark as JStark
    from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark as TStark

    rp = TR.RescuePrime()
    args = (Field.main(), 4, 2, 4, rp.m, rp.N + 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        js = JStark(*args, transition_constraints_degree=3)
        yield js, TStark(*args, transition_constraints_degree=3, device="cpu")


@pytest.mark.parametrize("K_", [16, 128])
@pytest.mark.parametrize("dz,di", [(2, 1), (3, 2)])
@pytest.mark.parametrize("shifts", [((201, 741), (5, 0)), ((1, 2), (3, 1 << 40))])
def test_verify_core_matches_jax(starks, K_, dz, di, shifts):
    import jax.numpy as jnp

    js, ts = starks
    N = ts.fri_domain_length
    seed = K_ + 10 * dz + di + shifts[0][0]
    vals_j, vals_t = pair((8, 8 * K_), seed)
    # a zero transition-zerofier value (part 2R + 1 = 5) and a zero point
    vals_j[:, 5 * K_ + 3] = 0
    vals_t[:, 5 * K_ + 3] = 0
    vals_j[:, 6 * K_ + 1] = 0
    vals_t[:, 6 * K_ + 1] = 0
    bz_j, bz_t = pair((2, 8, dz), seed + 1)
    ip_j, ip_t = pair((2, 8, di), seed + 2)
    w_j, w_t = pair((9, 8, 1), seed + 3)
    idx = np.random.default_rng(seed + 4).integers(0, N, K_)
    tq_sh, bq_sh = shifts
    want = JFS._verify_core(jnp.asarray(vals_j), jnp.asarray(bz_j), jnp.asarray(ip_j),
                            jnp.asarray(w_j), jnp.asarray(idx.astype(np.uint32)),
                            JR.make_index_air_evaluator(js), 2, K_, tq_sh, bq_sh)
    tables = TR.make_index_air_evaluator(ts).rescue_tables
    got = K.verify_core(vals_t, bz_t, ip_t, w_t, torch.from_numpy(idx.astype(np.int64)), tables,
                        tq_sh, bq_sh)
    same(want, got)


def test_verify_core_is_the_ports_glue(starks):
    """The port's own glue (protocols/fast_stark.py:_verify_core with the
    index evaluator, on the CPU) gives H12's values."""
    from stark_anatomy_tpu_torch.protocols.fast_stark import _verify_core

    _, ts = starks
    K_ = 32
    _, vals = pair((8, 8 * K_), 5)
    vals[:, 5 * K_] = 0
    _, bz = pair((2, 8, 2), 6)
    _, ip = pair((2, 8, 1), 7)
    _, w = pair((9, 8, 1), 8)
    idx = torch.from_numpy(np.random.default_rng(9).integers(0, ts.fri_domain_length, K_))
    evaluator = TR.make_index_air_evaluator(ts)
    want = _verify_core(vals, bz, ip, w, idx, evaluator, 2, K_, (201, 741), (5, 0))
    assert torch.equal(K.verify_core(vals, bz, ip, w, idx, evaluator.rescue_tables, (201, 741), (5, 0)),
                       want)


# ---------------------------------------------------------------------------
# the wrappers refuse what the kernels do not take
# ---------------------------------------------------------------------------

def test_wrappers_refuse_bad_operands():
    n = 64
    _, trace = pair((1, 2, 8, n), 1)
    _, tab = pair((2, 8, n), 2)
    _, itz = pair((8, n), 3)
    _, (mds, mdsi) = mds_pair()
    tables = (tab, tab, mds, mdsi)
    with pytest.raises(ValueError, match="shift"):
        K.rescue_quotients(trace, tab, tab, itz, tables, n)
    with pytest.raises(ValueError, match="interp"):
        K.rescue_quotients(trace, tab[..., :n // 2], tab, itz, tables, 1)
    with pytest.raises(ValueError, match="trace"):
        K.rescue_quotients(trace.long(), tab, tab, itz, tables, 1)
    with pytest.raises(ValueError, match="next_rows"):
        K.rescue_quotients(trace, tab, tab, itz, tables, 0, next_rows=trace[0])
    with pytest.raises(ValueError, match="adjacent"):
        K.rescue_quotients(trace, tab, tab, itz, tables, 0,
                           next_rows=trace.transpose(-1, -2).contiguous().transpose(-1, -2))
    _, w = pair((9, 8, 1), 4)
    with pytest.raises(ValueError, match="weights"):
        K.combination(itz, tab, tab, tab, tab, w[:7])
    with pytest.raises(ValueError, match="idx"):
        K.verify_core(torch.zeros(8, 8, dtype=torch.int32), tab[..., :2], tab[..., :1], w,
                      torch.zeros(1, dtype=torch.int32), tables, (1, 2), (3, 4))
    with pytest.raises(ValueError, match="shift exponents"):
        K.verify_core(torch.zeros(8, 8, dtype=torch.int32), tab[..., :2].contiguous(),
                      tab[..., :1].contiguous(), w, torch.zeros(1, dtype=torch.int64), tables,
                      (1, 2, 3), (3, 4))


# ---------------------------------------------------------------------------
# the paths: the routes that take each kernel, and the bytes
# ---------------------------------------------------------------------------

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


def spy(monkeypatch, calls):
    """Count the calls of the three wrappers and of the glue they replace."""
    for name in K.AIR_KERNELS:
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _f=fn, _n=name, **kw: (calls.append(_n), _f(*a, **kw))[1])
    glue = TR._rescue_air_kernel
    monkeypatch.setattr(TR, "_rescue_air_kernel",
                        lambda *a, **kw: (calls.append("glue_air"), glue(*a, **kw))[1])


def test_seeded_fast_rpsss_signature_through_the_kernels_equals_jax(monkeypatch):
    """A seeded FastRPSSS sign takes H10 and H11 (one call each), its verify
    H12, no glue AIR, and the signature is the JAX package's, byte for
    byte."""
    from stark_anatomy_tpu.models.rpsss import FastRPSSS as JaxRPSSS
    from stark_anatomy_tpu_torch.models.rpsss import FastRPSSS

    doc = b"the AIR kernels' route"
    port = FastRPSSS(device="cpu")
    calls = []
    spy(monkeypatch, calls)
    rand = det_urandom(b"air kernels")
    sk, pk = port.keygen(rand)
    sig = port.sign(sk, doc, rand)
    assert calls == ["rescue_quotients", "combination"]
    calls.clear()
    assert port.verify(pk, doc, sig)
    assert calls == ["verify_core"]
    assert not port.verify(pk, b"forged", sig)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "urandom", det_urandom(b"air kernels"))
        jax_scheme = JaxRPSSS()
        jsk, _ = jax_scheme.keygen()
        jsig = jax_scheme.sign(jsk, doc)
    assert jsk.value == sk.value
    assert sig == jsig


def test_fast_stark_routes(monkeypatch, starks):
    """FastStark.prove takes H10 for the Rescue evaluator, the glue for
    another (the generic compile_air), and H11 for both; verify takes H12
    only for the Rescue index evaluator.  Both proofs are the same bytes."""
    _, ts = starks
    rp = TR.RescuePrime()
    field = Field.main()
    sk = field.sample(b"routes")
    trace, boundary = rp.trace(sk), rp.boundary_constraints(rp.hash(sk))
    air = rp.transition_constraints(ts.omicron)
    tz = ts.preprocess()
    calls = []
    spy(monkeypatch, calls)
    fast = ts.prove(trace, air, boundary, tz, air_evaluator=TR.make_air_evaluator(ts),
                    urandom=det_urandom(b"routes"))
    assert calls == ["rescue_quotients", "combination"]
    calls.clear()
    generic = ts.prove(trace, air, boundary, tz, urandom=det_urandom(b"routes"))
    assert calls == ["combination"]
    assert fast == generic
    calls.clear()
    index_air = TR.make_index_air_evaluator(ts)
    assert ts.verify(fast, air, boundary, tz.root, air_index_evaluator=index_air)
    assert calls == ["verify_core"]
    calls.clear()

    def other(idx, current, next_):               # an index evaluator that is not Rescue's
        return index_air(idx, current, next_)

    assert ts.verify(fast, air, boundary, tz.root, air_index_evaluator=other)
    assert calls == ["glue_air"]
