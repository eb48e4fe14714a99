"""The one-device FRI prover on the card (marked ``cuda``: skips without
one).  This file imports no JAX: it runs on the card's machine by

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_card_fri.py

A low-degree codeword of 2^16 elements (expansion 4, 64 colinearity
tests) folds on the card to its last layer of 2^9 elements: every round is
one H6 launch and one H4 launch, and the transcript is ``prove_host``'s
over the same values byte for byte: H6 and H4 give the whole protocol's
bytes at the small layers (2^9-2^15) a 2^20 prove's last rounds fold.
"""

import random

import pytest
import torch

from stark_anatomy_tpu_torch.commit.device_merkle import DeviceRows
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.scalar import Field, P
from stark_anatomy_tpu_torch.ops import ntt as NTT
from stark_anatomy_tpu_torch.protocols.fri import Fri
from stark_anatomy_tpu_torch.transcript.proof_stream import ProofStream
from stark_anatomy_tpu_torch.utils.convert import device_from_ints, ints_from_device


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_device_fri_folds_to_2p9_on_the_card_as_prove_host(card):
    n, expansion, tests = 1 << 16, 4, 64
    field = Field.main()
    fri = Fri(field.generator().value, field.primitive_nth_root(n).value, n, expansion, tests)
    assert fri.num_rounds() == 8           # layers 2^16 down to 2^9
    rng = random.Random(0xF216)
    coeffs = device_from_ints([rng.randrange(P) for _ in range(n // expansion)], card)
    codeword = NTT.coset_evaluate(coeffs, fri.offset, n)

    layers, _ = fri.commit(codeword, ProofStream())
    assert [type(layer) for layer in layers] == [DeviceRows] * 8
    assert [len(layer) for layer in layers] == [n >> r for r in range(8)]
    assert all(layer.canon.device.type == "cuda" for layer in layers)

    before = dict(K.LAUNCHES)
    ps = ProofStream()
    idx = fri.prove(codeword, ps)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}
    assert launched.get("fri_fold") == 7 and launched.get("merkle") == 8, launched

    host_ps = ProofStream()
    assert idx == fri.prove_host(ints_from_device(codeword), host_ps)
    assert ps.serialize() == host_ps.serialize()
    values = []
    assert fri.verify(ProofStream.deserialize(ps.serialize()), values)
