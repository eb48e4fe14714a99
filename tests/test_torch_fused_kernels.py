"""The port's fused kernels H2 (the Rescue permutation) and H3 (the NTT)
against the JAX package, bit for bit, on the CPU, where their wrappers run
the plain versions; the NTT wrapper's input checks; and the fusion itself:
``trace_batch`` and ``ntt`` each make one wrapper call and no call of the
field kernels H0/H1.  Tolerance: zero (exact field arithmetic)."""

import collections

import numpy as np
import pytest
import torch

import stark_anatomy_tpu.field.ops as JF
from stark_anatomy_tpu.field.scalar import Field, P
from stark_anatomy_tpu.models import rescue_prime as JR
from stark_anatomy_tpu.ops import ntt as JN
from stark_anatomy_tpu.utils.convert import device_from_ints as jfrom
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.models import rescue_prime as TR
from stark_anatomy_tpu_torch.ops import ntt as TN
from stark_anatomy_tpu_torch.utils.convert import device_from_ints as tfrom

torch.set_num_threads(1)

G = Field.main().generator().value
SPECIAL = [0, 1, P - 1]


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def values(count, seed):
    """``count`` seeded field values; the last ones are 0, 1 and p - 1."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(count)]
    k = min(count, len(SPECIAL))
    if count > 1:
        vals[count - k:] = SPECIAL[:k]
    return vals


def pair(vals, lead):
    """The same Montgomery values as (*lead, 8, n) arrays in both packages."""
    count = int(np.prod(lead, dtype=np.int64))
    n = len(vals) // count
    j = np.moveaxis(np.asarray(jfrom(vals)).reshape((8,) + tuple(lead) + (n,)), 0, -2)
    t = tfrom(vals, "cpu").reshape((8,) + tuple(lead) + (n,)).movedim(0, -2).contiguous()
    return j, t


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


# -- H2: the Rescue permutation ----------------------------------------------

@pytest.mark.parametrize("batch", [1, 3, 17])
def test_rescue_trace_and_hash_match_jax(batch):
    vals = values(batch, 100 + batch)
    trace = TR.trace_batch(tfrom(vals, "cpu"))
    assert trace.shape == (K.RESCUE_ROUNDS + 1, K.RESCUE_M, 8, batch)
    same(JR.trace_batch(jfrom(vals)), trace)
    digest = TR.hash_batch(tfrom(vals, "cpu"))
    same(JR.hash_batch(jfrom(vals)), digest)
    assert torch.equal(digest, trace[-1, 0])


def test_rescue_plain_takes_any_state():
    """The plain permutation runs on a whole (m, 8, B) state, capacity
    included: its final state is the trace's last row."""
    _, state = pair(values(2 * 5, 7), (2,))
    tables = (*TR.permutation_tables("cpu"), TR.ALPHA_INV)
    trace = K.rescue_permutation(state, *tables, collect_trace=True)
    assert torch.equal(trace[0], state)
    assert torch.equal(K.rescue_permutation(state, *tables, collect_trace=False), trace[-1])


# -- H3: the NTT ---------------------------------------------------------------

NTT_SIZES = [1, 2, 8, 1024, 4096]
LEADS = [(), (2,), (1, 2)]


@pytest.mark.parametrize("lead", LEADS, ids=str)
@pytest.mark.parametrize("n", NTT_SIZES)
def test_ntt_and_intt_match_jax(n, lead):
    count = int(np.prod(lead, dtype=np.int64))
    j, t = pair(values(count * n, n + count), lead)
    fwd = TN.ntt(t)
    assert fwd.shape == t.shape
    same(JN.ntt(j), fwd)
    same(JN.intt(j), TN.intt(t))
    assert torch.equal(TN.intt(fwd), t)


@pytest.mark.parametrize("n", NTT_SIZES)
def test_coset_evaluate_and_interpolate_match_jax(n):
    j, t = pair(values(2 * n, 3 * n), (2,))
    lde = TN.coset_evaluate(t, G, n)
    same(JN.coset_evaluate(j, G, n), lde)
    same(JN.coset_interpolate(j, G), TN.coset_interpolate(t, G))
    assert torch.equal(TN.coset_interpolate(lde, G), t)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("scales", ["pre", "post", "both"])
@pytest.mark.parametrize("n", [1, 8, 1024])
def test_ntt_scales_match_jax(n, scales, inverse):
    """Random scale tables: ``scale_pre`` shared over the batch, and
    ``scale_post`` one table per row."""
    j, t = pair(values(2 * n, 5 * n), (2,))
    jpre, tpre = pair(values(n, 7 * n), (1,))
    jpost, tpost = pair(values(2 * n, 11 * n), (2,))
    use_pre, use_post = scales in ("pre", "both"), scales in ("post", "both")
    want = JF.mont_mul(j, jpre[0]) if use_pre else j
    want = JN.ntt(want, inverse=inverse)
    want = JF.mont_mul(want, jpost) if use_post else want
    got = TN.ntt(t, inverse, tpre[0] if use_pre else None, tpost if use_post else None)
    same(want, got)


# -- the NTT wrapper's checks -------------------------------------------------

@pytest.mark.parametrize("shape,want", [
    ((8, 1), (1, 0)), ((2, 8, 16), (2, 4)), ((1, 3, 8, 4096), (3, 12)), ((2, 8, 8192), (2, 13)),
])
def test_ntt_layout_accepts(shape, want):
    assert K.ntt_layout(torch.zeros(shape, dtype=torch.int32)) == want


@pytest.mark.parametrize("case,match", [
    ("not a power of two", "power of two"),
    ("too long", "8192"),
    ("int64", "int32"),
    ("limb axis", "int32"),
    ("not contiguous", "contiguous"),
])
def test_ntt_layout_refuses(case, match):
    x = {
        "not a power of two": torch.zeros(2, 8, 12, dtype=torch.int32),
        "too long": torch.zeros(8, 16384, dtype=torch.int32),
        "int64": torch.zeros(2, 8, 16, dtype=torch.int64),
        "limb axis": torch.zeros(2, 7, 16, dtype=torch.int32),
        "not contiguous": torch.zeros(8, 32, dtype=torch.int32)[:, ::2],
    }[case]
    with pytest.raises(ValueError, match=match):
        K.ntt_layout(x)


def test_fused_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel launch, which
    raises for anything it does not take (here: a non-CUDA device)."""
    state = torch.empty(2, 8, 3, dtype=torch.int32, device="meta")
    rc, mds = (t.to("meta") for t in TR.permutation_tables("cpu"))
    with pytest.raises(ValueError):
        K.rescue_permutation(state, rc, mds, TR.ALPHA_INV, collect_trace=True)
    x = torch.empty(8, 16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.ntt(x, x)


# -- fusion: one wrapper call, no field-kernel call ---------------------------

FIELD_WRAPPERS = ("mont_mul", "add_mod", "sub_mod", "mont_pow")


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts the calls of every kernel wrapper in field/kernels.py."""
    calls = collections.Counter()

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in FIELD_WRAPPERS + ("rescue_permutation", "ntt"):
        monkeypatch.setattr(K, name, counting(name, getattr(K, name)))
    return calls


def test_trace_and_hash_call_the_rescue_wrapper_once(wrapper_calls):
    inputs = tfrom(values(3, 1), "cpu")
    TR.trace_batch(inputs)
    assert dict(wrapper_calls) == {"rescue_permutation": 1}
    wrapper_calls.clear()
    TR.hash_batch(inputs)
    assert dict(wrapper_calls) == {"rescue_permutation": 1}


@pytest.mark.parametrize("call", ["ntt", "intt", "coset_evaluate", "coset_interpolate"])
def test_ntt_calls_the_ntt_wrapper_once(call, wrapper_calls):
    _, t = pair(values(2 * 256, 2), (2,))
    fn = {
        "ntt": TN.ntt, "intt": TN.intt,
        "coset_evaluate": lambda x: TN.coset_evaluate(x[..., :100], G, 256),
        "coset_interpolate": lambda x: TN.coset_interpolate(x, G),
    }[call]
    fn(t)                              # builds and caches the domain tables
    wrapper_calls.clear()
    fn(t)
    assert dict(wrapper_calls) == {"ntt": 1}
