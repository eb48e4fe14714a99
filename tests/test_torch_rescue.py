"""The port's Rescue-Prime against the reference vectors and the JAX
package, bit for bit: the hash vectors of tests/test_rescue_prime.py,
``trace_batch``, the pointwise AIR on random codewords and the round
constant tables.  Tolerance: zero (exact field arithmetic)."""

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.field.scalar import Field, FieldElement, P
from stark_anatomy_tpu.models import rescue_prime as JR
from stark_anatomy_tpu.utils.convert import device_from_ints as jfrom
from stark_anatomy_tpu_torch.models import rescue_prime as TR
from stark_anatomy_tpu_torch.utils.convert import device_from_ints as tfrom, ints_from_device

torch.set_num_threads(1)

VEC1_IN, VEC1_OUT = 1, 244180265933090377212304188905974087294
VEC2_IN, VEC2_OUT = (
    57322816861100832358702415967512842988,
    89633745865384635541695204788332415101,
)


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def values(count, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(count)]


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def test_hash_vectors_scalar_and_batch():
    rp = TR.RescuePrime()
    field = rp.field
    assert rp.hash(FieldElement(VEC1_IN, field)).value == VEC1_OUT
    assert rp.hash(FieldElement(VEC2_IN, field)).value == VEC2_OUT
    got = TR.hash_batch(tfrom([VEC1_IN, VEC2_IN], "cpu"))
    assert ints_from_device(got) == [VEC1_OUT, VEC2_OUT]


def test_trace_batch_matches_jax_and_scalar():
    vals = values(3, 1) + [VEC2_IN]
    trace = TR.trace_batch(tfrom(vals, "cpu"))
    assert trace.shape == (TR.N_ROUNDS + 1, TR.M, 8, len(vals))
    same(JR.trace_batch(jfrom(vals)), trace)
    rows = TR.RescuePrime().trace(FieldElement(vals[-1], Field.main()))
    assert [ints_from_device(trace[r, :, :, -1:]) for r in range(len(rows))] == [
        [v.value for v in row] for row in rows
    ]


def random_codewords(shape, seed):
    """The same random Montgomery codewords (..., 8, n) in both packages."""
    *lead, _, n = shape
    vals = values(int(np.prod(lead)) * n, seed)
    j = jfrom(vals).reshape((8,) + tuple(lead) + (n,))
    t = tfrom(vals, "cpu").reshape((8,) + tuple(lead) + (n,))
    return np.moveaxis(np.asarray(j), 0, -2), t.movedim(0, -2).contiguous()


def test_air_kernel_matches_jax_on_random_codewords():
    import jax.numpy as jnp

    n = 64
    cur_j, cur_t = random_codewords((2, 2, 8, n), 2)
    nxt_j, nxt_t = random_codewords((2, 2, 8, n), 3)
    c1_j, c1_t = random_codewords((2, 8, n), 4)
    c2_j, c2_t = random_codewords((2, 8, n), 5)
    mds_t = TR._mont_matrix(TR.MDS, "cpu")
    mdsi_t = TR._mont_matrix(TR.MDS_INV, "cpu")
    want = JR._rescue_air_kernel(
        jnp.asarray(cur_j), jnp.asarray(nxt_j), jnp.asarray(c1_j), jnp.asarray(c2_j),
        jnp.asarray(mds_t.numpy().astype(np.uint32)), jnp.asarray(mdsi_t.numpy().astype(np.uint32)),
    )
    got = TR._rescue_air_kernel(cur_t, nxt_t, c1_t, c2_t, mds_t, mdsi_t)
    same(want, got)


def test_air_vanishes_on_an_honest_trace_and_tables_match_jax():
    """The point AIR on an honest trace is zero; the round-constant
    codewords on the FRI domain equal the JAX package's."""
    from stark_anatomy_tpu.protocols.fast_stark import FastStark as JStark
    from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark as TStark

    rp = TR.RescuePrime()
    args = (Field.main(), 4, 2, 4, rp.m, rp.N + 1)
    js = JStark(*args, transition_constraints_degree=3)
    ts = TStark(*args, transition_constraints_degree=3, device="cpu")
    for jt, tt in zip(JR.rescue_air_tables(js), TR.rescue_air_tables(ts)):
        same(jt, tt)

    point_air = TR.make_point_air(ts)
    trace = rp.trace(FieldElement(VEC2_IN, rp.field))
    for c in range(rp.N):
        x = ts.omicron ** c
        assert all(v.is_zero() for v in point_air(x, trace[c], trace[c + 1]))
