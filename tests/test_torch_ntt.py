"""The port's NTT against the JAX package, bit for bit, at the sizes of the
signature's main path (the omicron domain 1024 and the FRI domain 4096).

The JAX package's scan and staged transforms are bit-exact with each other
(stark_anatomy_tpu/ops/stage_ntt.py:24-25), so only the output values are
compared.  Tolerance: zero (exact field arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_anatomy_tpu.field.scalar import Field, P
from stark_anatomy_tpu.ops import ntt as JN
from stark_anatomy_tpu.poly.host_ntt import ntt_ints
from stark_anatomy_tpu.utils.convert import device_from_ints as jfrom
from stark_anatomy_tpu_torch.ops import ntt as TN
from stark_anatomy_tpu_torch.utils.convert import device_from_ints as tfrom, ints_from_device

torch.set_num_threads(1)

G = Field.main().generator().value


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def values(count, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(count)]


def pair(vals, batch=1):
    """Same values as (batch, 8, n) tensors in both packages."""
    n = len(vals) // batch
    j = jfrom(vals).reshape(8, batch, n).transpose(1, 0, 2)
    t = tfrom(vals, "cpu").reshape(8, batch, n).permute(1, 0, 2).contiguous()
    return j, t


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


@pytest.mark.parametrize("n", [1024, 4096])
def test_ntt_and_intt_match_jax(n):
    j, t = pair(values(2 * n, n), batch=2)
    fwd = TN.ntt(t)
    same(JN.ntt(j), fwd)
    same(JN.intt(j), TN.intt(t))
    assert torch.equal(TN.intt(fwd), t)


def test_ntt_matches_host_ints():
    n = 1024
    vals = values(n, 5)
    omega = Field.main().primitive_nth_root(n).value
    assert ints_from_device(TN.ntt(tfrom(vals, "cpu"))) == ntt_ints(vals, omega)


@pytest.mark.parametrize("k,order", [(1024, 4096), (300, 1024)])
def test_coset_evaluate_and_interpolate_match_jax(k, order):
    j, t = pair(values(2 * k, k + order), batch=2)
    lde = TN.coset_evaluate(t, G, order)
    same(JN.coset_evaluate(j, G, order), lde)
    same(JN.coset_interpolate(JN.coset_evaluate(j, G, order), G), TN.coset_interpolate(lde, G))
    back = TN.coset_interpolate(lde, G)
    assert torch.equal(back[..., :k], t) and not back[..., k:].any()


@pytest.mark.parametrize("n", [1024, 4096])
def test_evaluate_domain_horner_matches_jax(n):
    jc, tc = pair(values(3 * 27, 7), batch=3)
    jp, tp = pair(values(n, 8))
    same(JN.evaluate_domain_horner(jc, jnp.broadcast_to(jp, (3,) + jp.shape[1:])),
         TN.evaluate_domain_horner(tc, tp[0]))
