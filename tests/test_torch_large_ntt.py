"""The port's four-step NTT and rolling zerofier against its single-launch NTT
and the JAX package's ops/ntt.py.

Above ``ops/ntt.py:NTT_MAX`` points the port runs a four-step transform:
H8's two launches up to NTT_MAX^2 points, the glue (row transforms of n2
and n1 points, the twiddles, three transposes) above.  Here the
threshold is lowered to 8, so both decompositions (the glue recursing
where a row is still longer than 8) run on the CPU through the plain
versions at n = 16 to 4096, and must give the single-launch path's values and
the JAX package's, with pre- and post-scales and batched leading axes.
``prefix_zerofier_evals`` must give the JAX function's values.  Field
arithmetic is exact: equality, no tolerance.
"""

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.field import ops as JF
from stark_anatomy_tpu.field.scalar import Field, P
from stark_anatomy_tpu.ops import ntt as JN
from stark_anatomy_tpu.ops.domain import DOMAINS as JDOMAINS
from stark_anatomy_tpu.ops.domain import mont_const as jax_const
from stark_anatomy_tpu_torch.field import ops as TF
from stark_anatomy_tpu_torch.ops import ntt as TN
from stark_anatomy_tpu_torch.ops.domain import DOMAINS as TDOMAINS

torch.set_num_threads(1)

FIELD = Field.main()


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def field_limbs(shape, seed):
    """Seeded int32 limbs (..., 8, n) of values below p: random 16-bit
    limbs, the top one below p's top limb."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.int64)
    x[..., 7, :] &= 0x3FFF
    return x.astype(np.int32)


def four_step(monkeypatch):
    monkeypatch.setattr(TN, "NTT_MAX", 8)


CASES = [(16, ()), (64, ()), (64, (2,)), (512, ()), (512, (1, 2)), (4096, ())]


@pytest.mark.parametrize("n,lead", CASES, ids=[f"n{n}-b{'x'.join(map(str, l)) or 1}" for n, l in CASES])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_four_step_matches_one_block(monkeypatch, n, lead, inverse):
    x = torch.from_numpy(field_limbs(lead + (8, n), n))
    pre = torch.from_numpy(field_limbs((8, n), n + 1))
    post = torch.from_numpy(field_limbs(lead + (8, n), n + 2))
    want_scaled, want = TN.ntt(x, inverse, pre, post), TN.ntt(x, inverse)
    four_step(monkeypatch)
    assert torch.equal(TN.ntt(x, inverse, pre, post), want_scaled)
    assert torch.equal(TN.ntt(x, inverse), want)


@pytest.mark.parametrize("n,lead", [(16, (3,)), (512, ()), (4096, ())], ids=["n16-b3", "n512", "n4096"])
def test_four_step_matches_jax(monkeypatch, n, lead):
    four_step(monkeypatch)
    x = field_limbs(lead + (8, n), 7 * n)
    t, j = torch.from_numpy(x), x.astype(np.uint32)
    assert np.array_equal(TN.ntt(t).numpy(), np.asarray(JN.ntt(j)).astype(np.int32))
    assert np.array_equal(TN.intt(t).numpy(), np.asarray(JN.intt(j)).astype(np.int32))
    g = FIELD.generator().value
    k = n // 4                                   # coefficients of an LDE: zero-padded
    coeffs = field_limbs(lead + (8, k), 7 * n + 1)
    lde = TN.coset_evaluate(torch.from_numpy(coeffs), g, n)
    assert np.array_equal(lde.numpy(), np.asarray(JN.coset_evaluate(coeffs.astype(np.uint32), g, n)))
    back = TN.coset_interpolate(lde, g)
    assert np.array_equal(back[..., :k].numpy(), coeffs)
    assert not back[..., k:].any()
    assert np.array_equal(back.numpy(), np.asarray(JN.coset_interpolate(lde.numpy().astype(np.uint32), g)))


def test_four_step_twiddles_are_cached(monkeypatch):
    four_step(monkeypatch)
    x = torch.from_numpy(field_limbs((8, 512), 5))     # 16 x 32: above NTT_MAX^2, the glue
    TN.ntt(x)
    before = dict(TN._TWIDDLES)
    TN.ntt(x)
    assert all(TN._TWIDDLES[k] is v for k, v in before.items())
    assert (512, 16, False, torch.device("cpu")) in TN._TWIDDLES


# (count, unit) on a domain of D = 256: counts that are not powers of two,
# one, and count * unit == D
ZEROFIER_CASES = [(1, 1), (5, 4), (15, 4), (37, 2), (64, 4), (100, 1), (255, 1), (256, 1)]


@pytest.fixture(scope="module")
def zerofier_domain():
    D = 256
    g = FIELD.generator().value
    jy = JF.mont_mul(JDOMAINS.get(D)["fwd_powers"], jax_const(g))
    ty = TF.mont_mul(TDOMAINS.get(D, "cpu")["fwd_powers"], TF.mont_const(g, "cpu"))
    assert np.array_equal(np.asarray(jy).astype(np.int32), ty.numpy())
    return D, jy, ty


@pytest.mark.parametrize("count,unit", ZEROFIER_CASES, ids=[f"c{c}-u{u}" for c, u in ZEROFIER_CASES])
def test_prefix_zerofier_evals_matches_jax(zerofier_domain, count, unit):
    D, jy, ty = zerofier_domain
    root = pow(FIELD.primitive_nth_root(D).value, unit, P)
    want = np.asarray(JN.prefix_zerofier_evals(jy, root, unit, count)).astype(np.int32)
    got = TN.prefix_zerofier_evals(ty, root, unit, count)
    assert np.array_equal(got.numpy(), want)
