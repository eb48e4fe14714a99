"""H7 ``fri_fold_batched``'s plain version against the JAX package's
batched fold.

H7 folds B codewords in one launch, one challenge per proof, with the
inverse-domain table shared: its plain version must give the JAX
package's _fold_kernel_batched and _square_half on the same numpy
inputs, with a canonical output equal to the canonical form of the folded
one, and at B = 1 the output of H6's plain version.  Exact equality.  The
CUDA kernel is held against its plain version by chip_smoke.py on the
card.
"""

import random

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.field import ops as JF
from stark_anatomy_tpu.ops.domain import mont_const as jax_const
from stark_anatomy_tpu.protocols import fri as JFRI
from stark_anatomy_tpu.utils.convert import device_from_ints as jax_from_ints
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field import ops as F
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.utils.convert import device_from_ints

torch.set_num_threads(1)

RNG = random.Random(0xBA7C)
SPECIAL = [0, 1, P - 1, P - 2]


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def batch_inputs(batch, h):
    """Codeword values (B lists of 2h), u values (h) and B challenges, the
    special values among each: at the start of every codeword and of u,
    and 0, 1, p - 1 among the challenges, every challenge distinct."""
    cws = [SPECIAL[b % 4:] + SPECIAL[:b % 4] + [RNG.randrange(P) for _ in range(2 * h - 4)]
           for b in range(batch)]
    u_vals = (SPECIAL + [RNG.randrange(P) for _ in range(h)])[:h]
    alphas = ([0, 1, P - 1] + [RNG.randrange(P) for _ in range(batch)])[:batch]
    return cws, u_vals, alphas


def port_batch(cws, u_vals, alphas):
    cw = torch.stack([device_from_ints(c, "cpu") for c in cws])          # (B, 8, 2h)
    u = device_from_ints(u_vals, "cpu")
    al = device_from_ints(alphas, "cpu").t().contiguous().unsqueeze(-1)   # (B, 8, 1)
    return cw, u, al


@pytest.mark.parametrize("h", [2, 64, 1024])
@pytest.mark.parametrize("batch", [1, 3])
def test_batched_fold_plain_matches_jax(batch, h):
    cws, u_vals, alphas = batch_inputs(batch, h)
    folded, canon, u2 = K.fri_fold_batched(*port_batch(cws, u_vals, alphas))
    jcw = np.stack([np.asarray(jax_from_ints(c)) for c in cws])
    ju = jax_from_ints(u_vals)
    jal = np.stack([np.asarray(jax_const(a)) for a in alphas])
    jfold = JFRI._fold_kernel_batched(jcw, ju, jal, jax_const(JFRI._TWO_INV))
    assert folded.shape == (batch, 8, h) and canon.shape == (batch, 8, h) and u2.shape == (8, h // 2)
    assert np.array_equal(folded.numpy(), np.asarray(jfold).astype(np.int32))
    assert np.array_equal(canon.numpy(), np.asarray(JF.from_mont(jfold)).astype(np.int32))
    assert np.array_equal(u2.numpy(), np.asarray(JFRI._square_half(ju)).astype(np.int32))
    assert torch.equal(canon, F.from_mont(folded))


@pytest.mark.parametrize("h", [2, 64, 1024])
def test_batch_of_one_equals_the_single_fold(h):
    cws, u_vals, _ = batch_inputs(1, h)
    alpha = RNG.randrange(P)
    cw, u, al = port_batch(cws, u_vals, [alpha])
    got = K.fri_fold_batched(cw, u, al)
    want = K.fri_fold(cw[0], u, alpha)
    assert torch.equal(got[0][0], want[0])
    assert torch.equal(got[1][0], want[1])
    assert torch.equal(got[2], want[2])


def test_batched_fold_rejects_bad_shapes():
    cw, u, al = port_batch(*batch_inputs(2, 4))
    with pytest.raises(ValueError):
        K.fri_fold_batched(cw[:, :, :6].contiguous(), u, al)    # 6 != 2 * 4
    with pytest.raises(ValueError):
        K.fri_fold_batched(cw, u, al[:1])                       # one challenge for two proofs
    with pytest.raises(ValueError):
        K.fri_fold_batched(cw[0], u, al)                        # no batch axis
    with pytest.raises(ValueError):
        K.fri_fold_batched(cw.long(), u, al)
    with pytest.raises(ValueError):
        K.fri_fold_batched(cw, u, al.expand(2, 8, 2))
