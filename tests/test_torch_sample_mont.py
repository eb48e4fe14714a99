"""H13 ``sample_mont``: a batch's randomness draws, 17 bytes each, to
Montgomery field elements (field/kernels.py, csrc/field.cu).

Every case is held to ``Field.sample`` of each draw followed by
``device_from_ints``, the route the batch prover took on the host: the
plain version here on the CPU, H13 on the card (marked ``cuda``: skips
without one).  A model of the kernel's reduction by p's sparse form runs
here step for step on Python ints.  This file imports no JAX: on the
card's machine it runs whole by

    python3 -m pytest -q --noconftest tests/test_torch_sample_mont.py
"""

import random

import pytest
import torch

from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.scalar import Field, P
from stark_anatomy_tpu_torch.utils.convert import device_from_ints

FIELD = Field.main()
NBYTES = K.SAMPLE_BYTES
TOP = 1 << (8 * NBYTES)                      # 2^136: every draw lies below it
KMAX = (TOP - 1) // P                        # the largest k with k p < 2^136
# the reduction's edges: 0 and 2^136 - 1, p and its neighbours, 2^128 and
# its neighbour, the largest multiple of p and its neighbours, and the
# quotient a = v >> 119 = 407 q + r at r = 0 and 406, q = 0 and 322
EDGES = ([0, TOP - 1, P - 1, P, P + 1, 2 * P - 1, (1 << 128) - 1, 1 << 128,
          KMAX * P - 1, KMAX * P, KMAX * P + 1]
         + [((407 * q + r) << 119) + b for q in (0, 322) for r in (0, 406) for b in (0, (1 << 119) - 1)
            if ((407 * q + r) << 119) + b < TOP])


def draws_of(values):
    """The draws' bytes, each value big-endian in 17 bytes."""
    return [v.to_bytes(NBYTES, "big") for v in values]


def seeded_draws(n: int, seed: int):
    rng = random.Random(seed)
    return [rng.randbytes(NBYTES) for _ in range(n)]


def raw_of(draws, device="cpu") -> torch.Tensor:
    """The (n, 17) uint8 tensor of the draws, as the batch prover uploads it."""
    data = bytearray(b"".join(draws))
    return torch.frombuffer(data, dtype=torch.uint8).view(-1, NBYTES).to(device)


def sampled(draws, device="cpu") -> torch.Tensor:
    """The yardstick: Field.sample of each draw, then device_from_ints."""
    return device_from_ints([FIELD.sample(d).value for d in draws], device)


def reduce_136(v: int) -> int:
    """csrc/field.cu:reduce_136 on Python ints, word for word: v mod p."""
    w = [(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
    a = ((v >> 128) << 9) | (w[3] >> 23)
    q, r = a // 407, a % 407
    x = w[0] | w[1] << 32 | w[2] << 64 | ((w[3] & 0x7FFFFF) | (r << 23)) << 96
    assert x <= P - 2 and q <= 322
    x -= q
    return x + P if x < 0 else x


def test_the_kernel_s_reduction_by_p_s_sparse_form_is_v_mod_p():
    values = EDGES + [int.from_bytes(d, "big") for d in seeded_draws(100_000, 0x5A17)]
    assert [reduce_136(v) for v in values] == [v % P for v in values]


@pytest.mark.parametrize("n", [1, 1536, 98_304])
def test_the_plain_version_is_field_sample_then_device_from_ints(n):
    draws = draws_of(EDGES)[:n] + seeded_draws(max(0, n - len(EDGES)), n)
    got = K.sample_mont_plain(raw_of(draws))
    assert got.shape == (8, n) and got.is_contiguous()
    assert torch.equal(got, sampled(draws))
    assert torch.equal(K.sample_mont(raw_of(draws)), got)     # the CPU's route


def test_the_plain_version_holds_the_edges_and_100000_seeded_draws():
    draws = draws_of(EDGES) + seeded_draws(100_000, 0xD4A5)
    assert torch.equal(K.sample_mont_plain(raw_of(draws)), sampled(draws))


@pytest.mark.parametrize("bad", [
    torch.zeros((4, NBYTES), dtype=torch.int32),
    torch.zeros((4, NBYTES + 1), dtype=torch.uint8),
    torch.zeros(4 * NBYTES, dtype=torch.uint8),
    torch.zeros((NBYTES, 4), dtype=torch.uint8).t(),
])
def test_the_kernel_refuses_any_other_layout(bad):
    with pytest.raises(ValueError, match="sample_mont"):
        K.sample_mont(bad)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1536, 98_304])
def test_h13_equals_its_plain_version_and_field_sample(card, n):
    draws = draws_of(EDGES)[:n] + seeded_draws(max(0, n - len(EDGES)), n)
    raw = raw_of(draws, card)
    before = K.LAUNCHES["sample_mont"]
    got = K.sample_mont(raw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sample_mont"] == before + 1
    assert got.device == raw.device and got.shape == (8, n) and got.is_contiguous()
    want = K.sample_mont_plain(raw_of(draws))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, sampled(draws))


@pytest.mark.cuda
def test_h13_holds_the_edges_and_100000_seeded_draws(card):
    draws = draws_of(EDGES) + seeded_draws(100_000, 0xD4A5)
    got = K.sample_mont(raw_of(draws, card)).cpu()
    assert torch.equal(got, K.sample_mont_plain(raw_of(draws)))
    assert torch.equal(got, sampled(draws))
