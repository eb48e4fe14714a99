"""The fixed chain for the Rescue S-box x^(1/3) (field/kernels.py
ALPHA_INV_CHAIN), which H2 and its plain version run in place of the
ladder: on Python integers against pow(x, ALPHA_INV, p), through the plain
Montgomery product against the JAX package's ``F.mont_pow``, its product
count, and the refusal of any other exponent.  Tolerance: zero (exact
field arithmetic)."""

import numpy as np
import pytest
import torch

import stark_anatomy_tpu.field.ops as JF
from stark_anatomy_tpu.models.rescue_constants import ALPHA_INV as JAX_ALPHA_INV
from stark_anatomy_tpu.utils.convert import device_from_ints as jfrom
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.limbs import R
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.models import rescue_prime as TR
from stark_anatomy_tpu_torch.models.rescue_constants import ALPHA_INV
from stark_anatomy_tpu_torch.utils.convert import device_from_ints as tfrom

torch.set_num_threads(1)

R_INV = pow(R, -1, P)
SPECIAL = {"0": 0, "1": 1, "p-1": P - 1, "p-2": P - 2, "R mod p": R % P}


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def seeded(count, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(count)]


def test_chain_computes_alpha_inv():
    """The chain's exponent is the Rescue constant of both packages, and
    x^ALPHA_INV is x^(1/3): cubing it gives x back."""
    assert K.ALPHA_INV == ALPHA_INV == JAX_ALPHA_INV == (2 * P - 1) // 3
    assert 3 * ALPHA_INV % (P - 1) == 1


def test_chain_product_count():
    """147 products, 127 of them squarings (PERF.md), against the ladder's
    191 (127 squarings and one multiply per further one bit)."""
    squarings = sum(a == b for _, a, b in K.ALPHA_INV_CHAIN)
    assert (len(K.ALPHA_INV_CHAIN), squarings) == (147, 127)
    assert ALPHA_INV.bit_length() - 1 + bin(ALPHA_INV).count("1") - 1 == 191


def test_chain_reads_only_values_it_has():
    have = {"x"}
    for out, a, b in K.ALPHA_INV_CHAIN:
        assert a in have and b in have, (out, a, b)
        have.add(out)
    assert K.ALPHA_INV_CHAIN[-1][0] == "acc"


@pytest.mark.parametrize("x", list(SPECIAL.values()) + seeded(8, 1), ids=list(SPECIAL) + [f"seeded{i}" for i in range(8)])
def test_chain_on_integers_matches_pow(x):
    """The chain over the Montgomery product on Python integers gives
    x^ALPHA_INV in Montgomery form."""
    got = K.run_chain(x * R % P, lambda a, b: a * b * R_INV % P)
    assert got == pow(x, ALPHA_INV, P) * R % P


@pytest.mark.parametrize("count,seed", [(5, 0), (64, 2)])
def test_chain_through_plain_product_matches_jax_mont_pow(count, seed):
    """The chain through ``mont_mul_plain`` against the JAX package's
    ladder ``F.mont_pow(x, ALPHA_INV)``; the first values are 0, 1, p - 1,
    p - 2 and R mod p."""
    vals = list(SPECIAL.values()) + seeded(count - len(SPECIAL), seed)
    got = K.run_chain(tfrom(vals, "cpu"), K.mont_mul_plain)
    want = JF.mont_pow(jfrom(vals), JAX_ALPHA_INV)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy().astype(np.int64))
    assert torch.equal(got, K.mont_pow_plain(tfrom(vals, "cpu"), ALPHA_INV))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("exponent", [ALPHA_INV - 2, ALPHA_INV + 1, 3, P - 2])
def test_rescue_permutation_refuses_another_exponent(exponent, device):
    """The kernel runs a fixed chain, so the wrapper refuses any other
    exponent before any launch, on the CPU as on another device."""
    state = tfrom([5, 0], "cpu").reshape(8, 2, 1).movedim(0, 1).contiguous().to(device)
    rc, mds = (t.to(device) for t in TR.permutation_tables("cpu"))
    with pytest.raises(ValueError, match="ALPHA_INV"):
        K.rescue_permutation(state, rc, mds, exponent, collect_trace=True)
    with pytest.raises(ValueError, match="ALPHA_INV"):
        K.rescue_permutation_plain(state, rc, mds, exponent, collect_trace=False)
