"""The port's pipelined MiMC prover (parallel/pipeline_prover.py), the
analog of tests/test_pipeline.py: pipelined proofs verify in both
packages, give the outputs of the scalar chain and the bytes of serial
proofs from the same entropy, and ``trace_columns_with_output`` matches
``forward``."""

import hashlib
import random

import numpy as np
import torch

from stark_anatomy_tpu.field.scalar import Field as JField
from stark_anatomy_tpu.field.scalar import FieldElement as JElement
from stark_anatomy_tpu.models import mimc as JM
from stark_anatomy_tpu_torch.field.scalar import Field, FieldElement, P
from stark_anatomy_tpu_torch.models import mimc as TM
from stark_anatomy_tpu_torch.parallel.pipeline_prover import PipelinedMiMCProver
from stark_anatomy_tpu_torch.utils.convert import ints_from_device

torch.set_num_threads(1)

FIELD = Field.main()
RNG = random.Random(1234)


def det_urandom(seed: bytes):
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def test_pipelined_proofs_verify(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    mimc, stark = TM.make_stark(15, 4, 4, 8, device="cpu")
    tz = stark.preprocess()
    inputs = [FieldElement(RNG.randrange(P), FIELD) for _ in range(3)]
    prover = PipelinedMiMCProver(mimc, stark, tz)
    try:
        results = prover.prove_many(inputs, urandom=det_urandom(b"pipeline"))
    finally:
        prover.close()
    assert len(results) == 3
    jmimc, jstark = JM.make_stark(15, 4, 4, 8)
    serial = det_urandom(b"pipeline")
    for x, (out, proof) in zip(inputs, results):
        assert out == mimc.forward(x), "pipelined output mismatch"
        assert TM.verify_chain(mimc, stark, x, out, proof, tz.root)
        jx, jout = (JElement(v.value, JField.main()) for v in (x, out))
        assert JM.verify_chain(jmimc, jstark, jx, jout, proof, tz.root)
        _, serial_proof, _ = TM.prove_chain(mimc, stark, x, tz, urandom=serial)
        assert serial_proof == proof


def test_empty_stream_yields_nothing():
    mimc, stark = TM.make_stark(15, 4, 4, 8, device="cpu")
    prover = PipelinedMiMCProver(mimc, stark, None)
    try:
        assert prover.prove_many([]) == []
    finally:
        prover.close()


def test_trace_columns_with_output_matches_forward():
    mimc, _ = TM.make_stark(31, 4, 4, 8, device="cpu")
    x = FieldElement(RNG.randrange(P), FIELD)
    cols, out = mimc.trace_columns_with_output(x.value)
    assert cols.shape[-1] == 32
    assert out == mimc.forward(x).value
    assert ints_from_device(cols[0]) == [row[0].value for row in mimc.trace(x)]
    words, out2 = mimc.trace_words_with_output(x.value)
    assert out2 == out and words.shape == (4, 32) and words.dtype == np.uint32
    assert torch.equal(mimc.columns_from_words(words), cols)
