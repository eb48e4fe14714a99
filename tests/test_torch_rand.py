"""The port's seed expansion (utils/rand.py, H5's plain version on the CPU)
against the JAX package's utils/rand.py, bit for bit.

A 32-byte seed expands by blake2s in counter mode into field elements in
Montgomery form, with candidates >= p redrawn under the next round tag.
The CUDA kernel H5 is held against this plain version by chip_smoke.py on
the card.
"""

import hashlib

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.utils import rand as JR
from stark_anatomy_tpu_torch.commit import kernels as MK
from stark_anatomy_tpu_torch.utils import rand as TR

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def seed_bytes(k: int) -> bytes:
    return hashlib.blake2s(b"rand test seed %d" % k).digest()


@pytest.mark.parametrize("count", [1, 2, 3, 1000, 4097])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_seed_expand_matches_jax(count, k):
    seed = seed_bytes(k)
    got = TR.seed_expand_mont(count, seed, "cpu")
    want = np.asarray(JR.seed_expand_mont(count, seed)).astype(np.int32)
    assert got.shape == (8, count)
    assert np.array_equal(got.numpy(), want)


def test_some_elements_need_a_later_round():
    """The cases above exercise the redraw: at 1000 elements round 0
    rejects some candidates, and the expansion still matches."""
    words = torch.from_numpy(np.frombuffer(seed_bytes(0), dtype="<u4").view(np.int32).copy())
    first = MK.expand_candidates_plain(words, 1000, 0)
    assert not bool(MK.below_p_plain(first).all())
    rounds = []
    MK.seed_expand_plain(words, 1000, rounds)
    assert rounds[0] > 500          # some counter hashed more than once


def test_bulk_random_draws_one_seed():
    draws = []

    def urandom(n):
        draws.append(n)
        return seed_bytes(7)

    got = TR.bulk_random_mont(33, "cpu", urandom)
    assert draws == [32]
    want = np.asarray(JR.bulk_random_mont(33, lambda n: seed_bytes(7))).astype(np.int32)
    assert np.array_equal(got.numpy(), want)


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        TR.seed_expand_mont(4, b"short", "cpu")
    with pytest.raises(ValueError):
        MK.seed_expand(torch.zeros(8, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        MK.seed_expand(torch.zeros(7, dtype=torch.int32), 4)
