"""Generic interpolation and evaluation (ops/interpolate.py) and the
product-tree helpers under them (ops/ntt.py: poly_multiply, zerofier,
coset_divide), in the port on the CPU against the JAX package.

The same seeded points and values go through both packages; the outputs
are equal, exactly, and the interpolant passes through every point with
degree < n (the round trip of tests/test_ntt.py:173).
"""

import random

import pytest
import torch

import stark_anatomy_tpu.ops as JO
from stark_anatomy_tpu.utils.convert import device_from_ints as jax_from_ints
from stark_anatomy_tpu.utils.convert import ints_from_device as jax_ints
import stark_anatomy_tpu_torch.ops as TO
from stark_anatomy_tpu_torch.field.scalar import Field, FieldElement, P
from stark_anatomy_tpu_torch.poly.univariate import Polynomial
from stark_anatomy_tpu_torch.utils.convert import device_from_ints, ints_from_device

torch.set_num_threads(1)

FIELD = Field.main()
RNG = random.Random(0x1A7E)


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def rand_ints(n):
    return [RNG.randrange(P) for _ in range(n)]


def port(vals):
    return device_from_ints(vals, "cpu")


@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_interpolate_generic_matches_jax(n):
    pts, vals = rand_ints(n), rand_ints(n)
    got = ints_from_device(TO.interpolate_generic(port(pts), port(vals)))
    want = jax_ints(JO.interpolate_generic(jax_from_ints(pts), jax_from_ints(vals)))
    assert got == want


@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_evaluate_generic_matches_jax(n):
    coeffs, pts = rand_ints(n), rand_ints(2 * n + 1)
    got = ints_from_device(TO.evaluate_generic(port(coeffs), port(pts)))
    want = jax_ints(JO.evaluate_generic(jax_from_ints(coeffs), jax_from_ints(pts)))
    assert got == want
    poly = Polynomial.from_ints(coeffs, FIELD)
    assert got == [poly.evaluate(FieldElement(x, FIELD)).value for x in pts]


def test_interpolate_generic_roundtrip():
    for n in [1, 2, 5, 16]:
        pts, vals = rand_ints(n), rand_ints(n)
        coeffs = ints_from_device(TO.interpolate_generic(port(pts), port(vals)))
        poly = Polynomial.from_ints(coeffs, FIELD)
        for x, v in zip(pts, vals):
            assert poly.evaluate(FieldElement(x, FIELD)).value == v
        assert poly.degree() < n
        back = ints_from_device(TO.evaluate_generic(port(coeffs), port(pts)))
        assert back == vals


@pytest.mark.parametrize("n", [1, 3, 8, 13])
def test_zerofier_matches_jax_and_vanishes(n):
    pts = rand_ints(n)
    got = ints_from_device(TO.zerofier(port(pts)))
    assert got == jax_ints(JO.zerofier(jax_from_ints(pts)))
    assert len(got) == n + 1 and got[-1] == 1
    poly = Polynomial.from_ints(got, FIELD)
    assert all(poly.evaluate(FieldElement(x, FIELD)).value == 0 for x in pts)


def test_poly_multiply_and_coset_divide_match_jax():
    a, b = rand_ints(7), rand_ints(5)
    prod = TO.poly_multiply(port(a), port(b))
    want = jax_ints(JO.poly_multiply(jax_from_ints(a), jax_from_ints(b)))
    assert ints_from_device(prod) == want
    pa, pb = Polynomial.from_ints(a, FIELD), Polynomial.from_ints(b, FIELD)
    assert ints_from_device(prod) == [c.value for c in (pa * pb).coefficients]
    g = FIELD.generator().value
    quot = ints_from_device(TO.coset_divide(prod, port(b), g, 16, out_len=7))
    jquot = jax_ints(JO.coset_divide(jax_from_ints(want), jax_from_ints(b), g, 16, out_len=7))
    assert quot == jquot == a


def test_reference_names():
    assert TO.fast_interpolate is TO.interpolate_generic
    assert TO.fast_evaluate is TO.evaluate_generic
    assert TO.fast_zerofier is TO.zerofier
    assert TO.fast_multiply is TO.poly_multiply
    assert TO.fast_coset_divide is TO.coset_divide
    assert TO.fast_coset_evaluate is TO.coset_evaluate
    assert set(TO.__all__) == set(JO.__all__)
