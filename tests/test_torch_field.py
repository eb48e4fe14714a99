"""The port's field arithmetic against the JAX package, bit for bit.

Same inputs (numpy, fixed seed) through stark_anatomy_tpu.field.ops and
stark_anatomy_tpu_torch.field.ops on the CPU, where the port's wrappers
run the kernels' plain versions.  Field arithmetic is exact: the
tolerance is zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stark_anatomy_tpu.field.ops as JF
import stark_anatomy_tpu_torch.field.ops as TF
from stark_anatomy_tpu.field.limbs import NLIMBS, R
from stark_anatomy_tpu.field.scalar import P
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.limbs import limbs_to_int

torch.set_num_threads(1)

RINV = pow(R, P - 2, P)
TOP = (P - 1) >> 112           # limb 7 of p - 1; below it every value is < p


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def limbs(shape, seed, special=True):
    """Random raw limb arrays (values in [0, p)) of shape (..., 8, n) as
    uint32; the first elements are 0, 1, p-1 and R mod p."""
    rng = np.random.default_rng(seed)
    *lead, _, n = shape
    x = rng.integers(0, 1 << 16, size=tuple(lead) + (n, NLIMBS), dtype=np.uint32)
    x[..., NLIMBS - 1] = rng.integers(0, TOP, size=tuple(lead) + (n,), dtype=np.uint32)
    if special:
        vals = [0, 1, P - 1, R % P][:n]
        for j, v in enumerate(vals):
            x[..., j, :] = [(v >> (16 * k)) & 0xFFFF for k in range(NLIMBS)]
    return np.ascontiguousarray(np.moveaxis(x, -1, -2))


def both(x):
    return jnp.asarray(x), torch.from_numpy(x.astype(np.int32))


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def ints(x):
    flat = np.moveaxis(np.asarray(x), -2, -1).reshape(-1, NLIMBS)
    return [limbs_to_int(row) for row in flat]


SHAPES = [(8, 512), (3, 8, 37), (2, 1, 8, 64)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops_match_jax(op, shape):
    (ja, ta), (jb, tb) = both(limbs(shape, 1)), both(limbs(shape, 2))
    same(getattr(JF, op)(ja, jb), getattr(TF, op)(ta, tb))


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops_broadcast_constant(op):
    (ja, ta), (jb, tb) = both(limbs((3, 8, 40), 3)), both(limbs((8, 1), 4, special=False))
    same(getattr(JF, op)(ja, jb), getattr(TF, op)(ta, tb))


def test_mont_mul_matches_scalar_field():
    a, b = limbs((8, 300), 5), limbs((8, 300), 6)
    got = ints(TF.mont_mul(torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32))).numpy())
    want = [x * y * RINV % P for x, y in zip(ints(a), ints(b))]
    assert got == want


def test_plain_mont_mul_matches_pallas_kernel_interpreted():
    """The plain version of H0 against K0 itself, run through the Pallas
    interpreter at n = 512 (as tests/test_field.py runs it)."""
    from stark_anatomy_tpu.field.pallas_kernels import mont_mul_pallas_core

    (ja, ta), (jb, tb) = both(limbs((2, 8, 512), 7)), both(limbs((2, 8, 512), 8))
    same(mont_mul_pallas_core(ja, jb, interpret=True), K.mont_mul_plain(ta, tb))


@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont", "inv", "batch_inv"])
def test_unary_ops_match_jax(op):
    x = limbs((2, 8, 70), 9)
    x[..., 5] = 0                       # extra zeros: batch_inv maps them to zero
    jx, tx = both(x)
    same(getattr(JF, op)(jx), getattr(TF, op)(tx))


def test_batch_inv_maps_zero_to_zero():
    x = limbs((8, 33), 10)
    got = ints(TF.batch_inv(torch.from_numpy(x.astype(np.int32))).numpy())
    vals = ints(x)
    assert vals[0] == 0 and got[0] == 0
    # Montgomery inverse of xR is x^-1 R, i.e. raw (R^2 / raw) mod p
    want = [pow(v, P - 2, P) * R * R % P if v else 0 for v in vals]
    assert got == want


@pytest.mark.parametrize("exponent", [0, 1, 2, 3, 1 << 40, 180331931428153586757283157844700080811])
def test_mont_pow_matches_jax(exponent):
    jx, tx = both(limbs((8, 16), 11))
    same(JF.mont_pow(jx, exponent), TF.mont_pow(tx, exponent))


ALPHA_INV = 180331931428153586757283157844700080811        # Rescue's 1/3
RANDOM_128 = int.from_bytes(np.random.default_rng(17).bytes(16), "little") | (1 << 127)


@pytest.mark.parametrize("shape", [(2, 8, 1), (1, 8, 17)])
@pytest.mark.parametrize("exponent", [0, 1, 2, 3, ALPHA_INV, P - 2, RANDOM_128],
                         ids=["0", "1", "2", "3", "alpha_inv", "p-2", "random128"])
def test_plain_ladder_matches_jax(exponent, shape):
    """The ladder's plain version against the JAX scan, with zeros among
    the elements (the last element of the first row; the special values
    where the row is long enough)."""
    x = limbs(shape, 18, special=shape[-1] >= 4)
    x[0, :, -1] = 0
    jx, tx = both(x)
    same(JF.mont_pow(jx, exponent), K.mont_pow_plain(tx, exponent))


@pytest.mark.parametrize("exponent", [0, 1, 2, 1 << 64, (1 << 64) - 1, ALPHA_INV, P - 2, (1 << 128) - 1])
def test_exponent_words_round_trip(exponent):
    lo, hi, nbits = K.exponent_words(exponent)
    assert 0 <= lo < 1 << 64 and 0 <= hi < 1 << 64
    assert lo | (hi << 64) == exponent and nbits == exponent.bit_length()


@pytest.mark.parametrize("exponent", [-1, -(1 << 70), 1 << 128, (1 << 129) + 5])
def test_ladder_refuses_exponents_out_of_range(exponent):
    with pytest.raises(ValueError):
        K.exponent_words(exponent)
    with pytest.raises(ValueError):
        K.mont_pow(torch.zeros(8, 2, dtype=torch.int32), exponent)


def test_cpu_mont_pow_launches_nothing():
    before = dict(K.LAUNCHES)
    x = torch.from_numpy(limbs((2, 8, 1), 19, special=False).astype(np.int32))
    K.mont_pow(x, ALPHA_INV)
    TF.mont_pow(x, P - 2)
    TF.batch_inv(x)
    assert K.LAUNCHES == before


def test_ops_check_each_operand_once(monkeypatch):
    """field/ops.py works out the kernels' layout once per call and hands
    it to the wrapper, which keeps every check that raises."""
    calls = []
    strides = K.operand_strides
    monkeypatch.setattr(K, "operand_strides", lambda *a: calls.append(1) or strides(*a))
    a = torch.empty(2, 8, 4, dtype=torch.int32, device="meta")
    for fn in (TF.mont_mul, TF.add, TF.sub):
        calls.clear()
        with pytest.raises(ValueError, match="CUDA device"):
            fn(a, a)
        assert len(calls) == 2
    with pytest.raises(ValueError, match="limb tensors"):
        TF.mont_mul(torch.empty(2, 7, 4, dtype=torch.int32, device="meta"), a[:, :7])


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_field_sum_and_weighted_sum_match_jax(k):
    (jt, tt), (jw, tw) = both(limbs((k, 8, 50), 12)), both(limbs((k, 8, 1), 13, special=False))
    same(JF.field_sum(jt), TF.field_sum(tt))
    same(JF.weighted_sum(jt, jw), TF.weighted_sum(tt, tw))


def test_mul_by_int_eq_is_zero_match_jax():
    (ja, ta), (jb, tb) = both(limbs((8, 20), 14)), both(limbs((8, 20), 15))
    same(JF.mul_by_int(ja, 123456789), TF.mul_by_int(ta, 123456789))
    same(JF.eq(ja, jb), TF.eq(ta, tb))
    same(JF.eq(ja, ja), TF.eq(ta, ta))
    same(JF.is_zero(ja), TF.is_zero(ta))


def test_constants_match_jax():
    from stark_anatomy_tpu.ops.domain import mont_const as jconst

    same(JF.mont_one(5, (2,)), TF.mont_one(5, (2,)))
    same(JF.mont_zero(3), TF.mont_zero(3))
    same(jconst(987654321), TF.mont_const(987654321, "cpu"))


def test_convert_matches_jax():
    from stark_anatomy_tpu.utils import convert as JC
    from stark_anatomy_tpu_torch.utils import convert as TC

    vals = ints(limbs((8, 45), 16)) + [P - 1, 0, 1]
    jd, td = JC.device_from_ints(vals), TC.device_from_ints(vals, "cpu")
    same(jd, td)
    assert TC.ints_from_device(td) == vals == JC.ints_from_device(jd)
    np.testing.assert_array_equal(JC.canonical_np(jd), TC.canonical_np(td))
    rows = TC.canonical_np(td)
    assert [TC.int_from_row(r) for r in rows] == vals == TC.ints_from_rows(rows)
    assert TC.gather_rows(rows, [3, 0]) == [vals[3], vals[0]]
    assert TC.device_from_ints([], "cpu").shape == (NLIMBS, 0)


def test_operand_strides_accept_and_refuse():
    a = torch.zeros(2, 3, 8, 16, dtype=torch.int32)
    assert K.operand_strides(a, (2, 3), 16) == (8 * 16, 16, 1)
    assert K.operand_strides(torch.zeros(8, 16, dtype=torch.int32), (2, 3), 16) == (0, 16, 1)
    assert K.operand_strides(torch.zeros(2, 3, 8, 1, dtype=torch.int32), (2, 3), 16) == (8, 1, 0)
    assert K.operand_strides(a.long(), (2, 3), 16) is None               # dtype
    assert K.operand_strides(a.transpose(0, 1), (3, 2), 16) is None     # not contiguous
    assert K.operand_strides(torch.zeros(3, 8, 16, dtype=torch.int32), (2, 3), 16) is None


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel launch, which
    raises for anything it does not take (here: a non-CUDA device)."""
    a = torch.empty(8, 4, dtype=torch.int32, device="meta")
    for fn in (K.mont_mul, K.add_mod, K.sub_mod):
        with pytest.raises(ValueError):
            fn(a, a)
    with pytest.raises(ValueError):
        K.mont_pow(a, 3)


def test_build_is_one_nvcc_call_into_the_build_dir(monkeypatch, tmp_path):
    """One nvcc call per CUDA source, all started before any is waited on,
    cached by the source's hash."""
    from stark_anatomy_tpu_torch.utils import build as B

    calls, waited = [], []

    class FakeCompile:
        def __init__(self, cmd, **kwargs):
            assert not waited, "a build started after another was waited on"
            calls.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()
            self.returncode = 0

        def communicate(self):
            waited.append(self)
            return "", None

    monkeypatch.setattr(B, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(K, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(B.subprocess, "Popen", FakeCompile)
    libs = K.build()
    assert K.build() == libs and len(calls) == len(K.SOURCES)     # cached by source hash
    assert sorted(cmd[-1] for cmd in calls) == sorted(K.SOURCES.values())
    for cmd in calls:
        assert cmd[0] == "nvcc"
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert set(libs) == set(K.SOURCES)
    for lib in libs.values():
        assert lib.startswith(str(tmp_path)) and lib.endswith(".so")
