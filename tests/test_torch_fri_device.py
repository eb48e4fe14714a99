"""The port's device FRI (H6's plain version and H4's on the CPU) against
the JAX package's fused fold and commit, and against the port's host FRI.

H6 ``fri_fold`` computes one fold round, the folded codeword's canonical
form and the next round's inverse-domain table; its plain version must
give the JAX package's _fold_kernel, _square_half and from_mont.  With the
device commitment forced (STARK_TPU_DEVICE_HASH=1), ``Fri.prove`` folds
every round on the device path, down to the last layer, and must write
the port's ``prove_host`` transcript and the JAX package's, byte for byte,
whatever the JAX package's own crossover to its host tail (HOST_TAIL_MAX:
its default, 8 or 32); each package verifies the other's.  The CUDA kernel
is held against its plain version by chip_smoke.py on the card.
"""

import random

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.field import ops as JF
from stark_anatomy_tpu.ops import ntt as JN
from stark_anatomy_tpu.ops.domain import mont_const as jax_const
from stark_anatomy_tpu.protocols import fri as JFRI
from stark_anatomy_tpu.transcript.proof_stream import ProofStream as JPS
from stark_anatomy_tpu.utils.convert import device_from_ints as jax_from_ints
from stark_anatomy_tpu_torch.commit.device_merkle import DeviceRows
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.scalar import Field, P
from stark_anatomy_tpu_torch.ops import ntt as TN
from stark_anatomy_tpu_torch.protocols import fri as TFRI
from stark_anatomy_tpu_torch.transcript.proof_stream import ProofStream as TPS
from stark_anatomy_tpu_torch.utils.convert import device_from_ints, ints_from_device

torch.set_num_threads(1)

FIELD = Field.main()
RNG = random.Random(0xF01D)


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


@pytest.mark.parametrize("h", [2, 64, 256])
@pytest.mark.parametrize("alpha", [0, 1, P - 1, "random"])
def test_fold_plain_matches_jax(h, alpha):
    alpha = RNG.randrange(P) if alpha == "random" else alpha
    special = [0, 1, P - 1, P - 2]
    cw_vals = special + [RNG.randrange(P) for _ in range(2 * h - 4)]
    u_vals = [RNG.randrange(P) for _ in range(h)]
    folded, canon, u2 = K.fri_fold(device_from_ints(cw_vals, "cpu"), device_from_ints(u_vals, "cpu"), alpha)
    jcw, ju = jax_from_ints(cw_vals), jax_from_ints(u_vals)
    jfold = JFRI._fold_kernel(jcw, ju, jax_const(alpha), jax_const(JFRI._TWO_INV))
    assert np.array_equal(folded.numpy(), np.asarray(jfold).astype(np.int32))
    assert np.array_equal(canon.numpy(), np.asarray(JF.from_mont(jfold)).astype(np.int32))
    assert np.array_equal(u2.numpy(), np.asarray(JFRI._square_half(ju)).astype(np.int32))


def test_fold_rejects_bad_shapes():
    cw = device_from_ints(list(range(8)), "cpu")
    with pytest.raises(ValueError):
        K.fri_fold(cw, device_from_ints(list(range(3)), "cpu"), 5)       # 8 != 2 * 3
    with pytest.raises(ValueError):
        K.fri_fold(cw[:, :2], device_from_ints([1], "cpu"), 5)          # h < 2
    with pytest.raises(ValueError):
        K.fri_fold(cw.long(), device_from_ints(list(range(4)), "cpu"), 5)


def make_fri(cls, n, expansion, tests):
    return cls(FIELD.generator().value, FIELD.primitive_nth_root(n).value, n, expansion, tests)


@pytest.mark.parametrize("jax_tail", [None, 8, 32], ids=["default", "tail8", "tail32"])
def test_device_fri_transcript_matches_jax_and_host(monkeypatch, jax_tail):
    """Six layers, 512 down to 16 elements, all on the port's device path;
    the JAX package folds on its host from its default crossover (2^14:
    every fold here), on its device to 16 elements with HOST_TAIL_MAX = 8,
    and to 64 with 32."""
    n, expansion, tests = 512, 4, 2
    coeffs = [RNG.randrange(P) for _ in range(n // expansion)]
    monkeypatch.setenv("STARK_TPU_DEVICE_HASH", "1")
    if jax_tail is not None:
        monkeypatch.setattr(JFRI.Fri, "HOST_TAIL_MAX", jax_tail)
    jf, tf = make_fri(JFRI.Fri, n, expansion, tests), make_fri(TFRI.Fri, n, expansion, tests)

    codeword = TN.coset_evaluate(device_from_ints(coeffs, "cpu"), tf.offset, n)
    tps = TPS()
    layers, _ = tf.commit(codeword, TPS())
    assert [type(l) for l in layers] == [DeviceRows] * 6
    assert [len(l) for l in layers] == [n >> r for r in range(6)]
    t_idx = tf.prove(codeword, tps)

    jps = JPS()
    j_idx = jf.prove(JN.coset_evaluate(jax_from_ints(coeffs), jf.offset, n), jps)
    hps = TPS()
    h_idx = tf.prove_host(ints_from_device(codeword), hps)

    assert t_idx == j_idx == h_idx
    assert tps.serialize() == jps.serialize() == hps.serialize()
    values_t, values_j = [], []
    assert tf.verify(TPS.deserialize(jps.serialize()), values_t)
    assert jf.verify(JPS.deserialize(tps.serialize()), values_j)
    assert values_t == values_j


def test_device_fri_rejects_a_high_degree_codeword(monkeypatch):
    n, expansion, tests = 256, 4, 2
    monkeypatch.setenv("STARK_TPU_DEVICE_HASH", "1")
    tf = make_fri(TFRI.Fri, n, expansion, tests)
    vals = [RNG.randrange(P) for _ in range(n)]               # degree n - 1
    ps = TPS()
    tf.prove(device_from_ints(vals, "cpu"), ps)
    assert not tf.verify(TPS.deserialize(ps.serialize()), [])
    assert tf.last_rejection
