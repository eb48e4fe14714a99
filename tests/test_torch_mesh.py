"""The mesh layer and the small public names, against the JAX package.

``factor_mesh`` for 1-64 devices; ``make_mesh`` raises with too few real
devices unless ``devices=`` is passed (a virtual mesh), and so does
``MeshConfig.build`` (tests/test_fast_stark.py:109); a batch split over
dp = 2 (``BatchProver(mesh=)``) gives the unsplit batch's bytes;
``collective_bytes_model`` equals the JAX function's dict; and
``coset_scale``, ``prefix_zerofier``, ``coset_power_tables`` and
``bit_reversal_permutation`` equal the JAX functions on seeded inputs.
Zero tolerance.
"""

import hashlib
import os
import random

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.config import MeshConfig as JaxMeshConfig
from stark_anatomy_tpu.ops import domain as JD
from stark_anatomy_tpu.ops import ntt as JNTT
from stark_anatomy_tpu.parallel.mesh import factor_mesh as jax_factor_mesh
from stark_anatomy_tpu.parallel.multihost import collective_bytes_model as jax_bytes_model
from stark_anatomy_tpu.protocols.fast_stark import FastStark as JaxFastStark
from stark_anatomy_tpu.utils.convert import device_from_ints as jax_from_ints
from stark_anatomy_tpu.utils.convert import ints_from_device as jax_ints
from stark_anatomy_tpu_torch.config import MeshConfig, StarkConfig
from stark_anatomy_tpu_torch.field.scalar import Field, P
from stark_anatomy_tpu_torch.models.mimc import MiMC
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime
from stark_anatomy_tpu_torch.ops import domain as D
from stark_anatomy_tpu_torch.ops import ntt as NTT
from stark_anatomy_tpu_torch.parallel.batch_prover import BatchProver
from stark_anatomy_tpu_torch.parallel.mesh import (
    Mesh, codeword_sharding, factor_mesh, make_mesh, proof_batch_sharding,
)
from stark_anatomy_tpu_torch.parallel.multihost import collective_bytes_model
from stark_anatomy_tpu_torch.parallel.sharded_stark import ShardedFastStark
from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark
from stark_anatomy_tpu_torch.transcript.proof_stream import SignatureProofStream
from stark_anatomy_tpu_torch.utils.convert import device_from_ints, ints_from_device

os.environ.setdefault("STARK_TPU_AOT", "0")
torch.set_num_threads(1)

FIELD = Field.main()
CPU8 = [torch.device("cpu")] * 8


def test_factor_mesh_matches_jax():
    for n in range(1, 65):
        assert factor_mesh(n) == jax_factor_mesh(n), n


def test_make_mesh_needs_real_devices_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(8)
    with pytest.raises(ValueError):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh(8, devices=CPU8[:4])
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.shape == {"dp": 2, "sp": 4} and mesh.backend == "local"
    assert mesh.local_shards() == [0, 1, 2, 3] and mesh.device == torch.device("cpu")
    assert proof_batch_sharding(mesh).spec == (None, "dp")
    assert codeword_sharding(mesh).spec == ("dp", None, "sp")
    assert codeword_sharding(mesh, batched=False).spec == (None, "sp")


def test_mesh_config_matches_jax(monkeypatch):
    cfg, jcfg = MeshConfig(dp=2, sp=4), JaxMeshConfig(dp=2, sp=4)
    assert cfg.num_devices == jcfg.num_devices == 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        cfg.build()
    mesh = cfg.build(devices=CPU8)
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert MeshConfig(dp=4, sp=2).build(devices=CPU8).shape == {"dp": 4, "sp": 2}
    stark_cfg = StarkConfig(num_colinearity_checks=8, security_level=16, num_registers=1, num_cycles=16)
    s2 = FastStark.from_config(stark_cfg, device="cpu")
    assert s2.omicron_domain_length == stark_cfg.omicron_domain_length
    s3 = ShardedFastStark.from_config(stark_cfg, mesh=mesh)
    assert s3.mesh is mesh and s3.device == torch.device("cpu")


def det_urandom(seed: bytes):
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def test_batch_split_over_dp_matches_unsplit():
    rp = RescuePrime()
    stark = FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device="cpu")
    tz = stark.preprocess()
    docs = [b"mesh batch 0", b"mesh batch 1"]
    inputs = [FIELD.sample(bytes([3, i])) for i in range(2)]
    unsplit = BatchProver(stark, rp, tz)
    whole = unsplit.prove_batch(
        inputs, [SignatureProofStream(d) for d in docs], urandom=det_urandom(b"dp"))
    mesh = Mesh([[torch.device("cpu")], [torch.device("cpu")]])
    split = BatchProver(stark, rp, tz, mesh=mesh, air=unsplit.air).prove_batch(
        inputs, [SignatureProofStream(d) for d in docs], urandom=det_urandom(b"dp"))
    assert mesh.shape == {"dp": 2, "sp": 1}
    assert split == whole


def test_a_batch_of_4_split_over_two_groups_draws_as_the_unsplit_one():
    """Each group converts its own slices of the one stream of draws: the
    calls to ``urandom`` (17 bytes each, B*(R*nrand + max_degree + 1)) are
    the unsplit batch's, and so are the proofs."""
    rp = RescuePrime()
    stark = FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device="cpu")
    tz = stark.preprocess()
    docs = [b"mesh draws %d" % i for i in range(4)]
    inputs = [FIELD.sample(bytes([5, i])) for i in range(4)]
    unsplit = BatchProver(stark, rp, tz)
    mesh = Mesh([[torch.device("cpu")], [torch.device("cpu")]])
    split = BatchProver(stark, rp, tz, mesh=mesh, air=unsplit.air)
    calls, proofs = {}, {}
    for label, prover in (("unsplit", unsplit), ("split", split)):
        draw, seen = det_urandom(b"dp draws"), []
        calls[label] = seen

        def spy(n, draw=draw, seen=seen):
            seen.append(n)
            return draw(n)

        proofs[label] = prover.prove_batch(inputs, [SignatureProofStream(d) for d in docs], urandom=spy)
    width = stark.num_registers * stark.num_randomizers
    assert calls["split"] == calls["unsplit"] == [17] * (4 * (width + stark.max_degree(unsplit.air) + 1))
    assert proofs["split"] == proofs["unsplit"]


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_collective_bytes_model_matches_jax(shards):
    steps = 1 << 10
    args = (FIELD, 4, 4, 8, MiMC.m, steps + 1)
    port = FastStark(*args, transition_constraints_degree=3, device="cpu")
    jax_stark = JaxFastStark(*args, transition_constraints_degree=3)
    assert collective_bytes_model(port, shards) == jax_bytes_model(jax_stark, shards)


def test_small_public_names_match_jax():
    rng = random.Random(131)
    vals = [rng.randrange(P) for _ in range(64)]
    g = FIELD.generator().value
    for inverse in (False, True):
        got = ints_from_device(NTT.coset_scale(device_from_ints(vals, "cpu"), g, inverse))
        assert got == jax_ints(JNTT.coset_scale(jax_from_ints(vals), g, inverse))
    w = FIELD.primitive_nth_root(1 << 13).value
    saved = NTT.HOST_ZEROFIER_MAX
    try:
        for count in (1, 5, 37):
            assert ints_from_device(NTT.prefix_zerofier(w, count, "cpu")) == \
                jax_ints(JNTT.prefix_zerofier(w, count))
        # the recursion above HOST_ZEROFIER_MAX: the coefficients are unique,
        # so the port's split (threshold lowered) meets the JAX package's
        NTT.HOST_ZEROFIER_MAX = 4
        assert ints_from_device(NTT.prefix_zerofier(w, 37, "cpu")) == \
            jax_ints(JNTT.prefix_zerofier(w, 37))
    finally:
        NTT.HOST_ZEROFIER_MAX = saved
    for n in (1, 2, 8, 64):
        fwd, inv = D.coset_power_tables(g, n, "cpu")
        jfwd, jinv = JD.coset_power_tables(g, n)
        assert ints_from_device(fwd) == jax_ints(jfwd) and ints_from_device(inv) == jax_ints(jinv)
        got = D.bit_reversal_permutation(n)
        assert got.dtype == np.uint32 and np.array_equal(got, JD.bit_reversal_permutation(n))


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        NTT.prefix_zerofier(3, 4)
