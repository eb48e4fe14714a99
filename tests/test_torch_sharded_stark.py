"""The sharded prover: ShardedFastStark on in-process CPU shards against the
port's FastStark and the JAX package's, at tests/test_topology_invariance.py's
parameters (Rescue-Prime, FRI domain N = 512, omicron domain M = 128).

For S = 2, 4 and 8 shards of a local mesh and one seeded urandom stream:
the sharded proof equals the port's one-device proof and the JAX
package's byte for byte, the zerofier roots are equal, and the JAX
verifier accepts the sharded proof.  The heavy arrays really are sharded
(S shards of N / S), and a spy on the one-device transforms and trees
shows that none of them sees a codeword of N elements while the sharded
route proves, the FRI folding on the shards down to its last layer.
"""

import hashlib
import os
import random

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.field.scalar import Field
from stark_anatomy_tpu.models.rescue_prime import RescuePrime as JaxRescuePrime
from stark_anatomy_tpu.models.rescue_prime import make_air_evaluator as jax_air_evaluator
from stark_anatomy_tpu.protocols.fast_stark import FastStark as JaxFastStark
from stark_anatomy_tpu_torch.commit import device_merkle as DM
from stark_anatomy_tpu_torch.commit import kernels as MK
from stark_anatomy_tpu_torch.commit.merkle import MerkleTree
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.models.rescue_prime import RescuePrime, make_air_evaluator
from stark_anatomy_tpu_torch.ops import ntt as NTT
from stark_anatomy_tpu_torch.parallel.mesh import Mesh, Sharded
from stark_anatomy_tpu_torch.parallel.sharded_stark import Paired, ShardedFastStark
from stark_anatomy_tpu_torch.protocols import fast_stark as FS
from stark_anatomy_tpu_torch.protocols.fast_stark import FastStark
from stark_anatomy_tpu_torch.transcript.proof_stream import ProofStream
from stark_anatomy_tpu_torch.utils.convert import device_from_ints

torch.set_num_threads(1)

FIELD = Field.main()
N = 512
SEED = b"seed-A"


def det_urandom(seed: bytes):
    """Deterministic os.urandom stand-in (counter-mode blake2b stream)."""
    state = {"ctr": 0}

    def rand(n: int) -> bytes:
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(seed + state["ctr"].to_bytes(8, "big")).digest()
            state["ctr"] += 1
        return out[:n]

    return rand


def statement(rp):
    x = FIELD.sample(b"topology")
    return rp.trace(x), rp.boundary_constraints(rp.hash(x))


def sharded(shards: int) -> ShardedFastStark:
    rp = RescuePrime()
    return ShardedFastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3,
                            mesh=Mesh([[torch.device("cpu")] * shards]))


def port_prove(stark):
    rp = RescuePrime()
    trace, boundary = statement(rp)
    air = rp.transition_constraints(stark.omicron)
    tz = stark.preprocess()
    proof = stark.prove(trace, air, boundary, tz, air_evaluator=make_air_evaluator(stark),
                        urandom=det_urandom(SEED))
    return proof, tz


@pytest.fixture(scope="module")
def jax_side():
    """(stark, proof, tz root, air, boundary) of the JAX package's one-device prover."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        rp = JaxRescuePrime()
        stark = JaxFastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3)
        trace, boundary = statement(rp)
        air = rp.transition_constraints(stark.omicron)
        tz = stark.preprocess()
        proof = stark.prove(trace, air, boundary, tz, air_evaluator=jax_air_evaluator(stark),
                            urandom=det_urandom(SEED))
        return stark, proof, tz.root, air, boundary


@pytest.fixture(scope="module")
def port_single():
    rp = RescuePrime()
    stark = FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device="cpu")
    proof, tz = port_prove(stark)
    return proof, tz.root


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_proof_equals_one_device_and_jax(shards, jax_side, port_single):
    jstark, jproof, jroot, jair, jboundary = jax_side
    stark = sharded(shards)
    proof, tz = port_prove(stark)
    assert tz.root == port_single[1] == jroot, "preprocessing must not depend on the topology"
    assert proof == port_single[0] == jproof, (len(proof), len(jproof))
    assert jstark.verify(proof, jair, jboundary, jroot)
    # the distributed transforms and the forests ran: two iNTT/LDE pairs
    # (preprocess's zerofier LDE, the trace, the randomizer)
    assert stark.routes["ntt_dist"] == 4 and "ntt_gathered" not in stark.routes
    # and every FRI round folds on the shards, to the last layer (16 elements)
    assert stark.routes["commit_host_forest"] == 4 and stark.routes["fold_sharded"] == 5


def test_sharded_prover_actually_shards():
    """The tables and the trace LDE are sharded: S shards of N / S."""
    shards = 8
    stark = sharded(shards)
    t = stark._interp_tables()
    for key in ("x_lde", "zn_over_xm"):
        assert isinstance(t[key], Sharded) and t[key].length == N
        assert sorted(t[key].shards) == list(range(shards))
        assert all(x.shape == (8, N // shards) for x in t[key].shards.values())
    rng = random.Random(7)
    cols = device_from_ints([rng.randrange(P) for _ in range(stark.randomized_trace_length)], "cpu")[None]
    lde = stark._trace_lde(cols)
    assert isinstance(lde, Sharded) and lde.shape == (1, 8, N)
    assert all(x.shape == (1, 8, N // shards) for x in lde.shards.values())
    assert torch.equal(lde.gather(), FastStark._trace_lde(_one_device(), cols))


def _one_device():
    rp = RescuePrime()
    return FastStark(FIELD, 4, 2, 4, rp.m, rp.N + 1, transition_constraints_degree=3, device="cpu")


def test_sharded_route_never_forms_a_full_codeword(monkeypatch, port_single):
    """A spy on the one-device transforms (NTT.ntt, intt, coset_evaluate,
    H3), the trees (MerkleTree.from_limbs_paired, H4, device commits) and
    H6: while the sharded prover proves, none sees a codeword of N
    elements; the proof is still the one-device proof."""
    stark = sharded(4)
    rp = RescuePrime()
    trace, boundary = statement(rp)
    air = rp.transition_constraints(stark.omicron)
    tz = stark.preprocess()
    evaluator = make_air_evaluator(stark)
    seen = {}

    def spy(name, fn, length):
        def wrapped(*args, **kwargs):
            n = length(args[0])
            seen.setdefault(name, []).append(n)
            assert n != N, f"{name} saw a full codeword of {N} elements"
            return fn(*args, **kwargs)
        return wrapped

    last = lambda x: x.shape[-1]
    rows = lambda x: np.asarray(x).shape[0]
    for mod, name, length in ((NTT, "ntt", last), (NTT, "intt", last), (NTT, "coset_evaluate", last),
                              (K, "ntt", last), (K, "fri_fold", last), (MK, "merkle_paired", last),
                              (DM, "merkle_paired", last), (DM, "device_commit_paired", last),
                              (DM, "device_commit_paired_many", last), (FS, "device_commit_paired", last),
                              (FS, "device_commit_paired_many", last), (DM, "canonical_np", last),
                              (FS, "canonical_np", last)):
        monkeypatch.setattr(mod, name, spy(f"{mod.__name__}.{name}", getattr(mod, name), length))
    tree_fn = MerkleTree.from_limbs_paired.__func__
    monkeypatch.setattr(MerkleTree, "from_limbs_paired",
                        classmethod(lambda cls, canon: spy("from_limbs_paired",
                                                           lambda c: tree_fn(cls, c), rows)(canon)))
    proof = stark.prove(trace, air, boundary, tz, air_evaluator=evaluator, urandom=det_urandom(SEED))
    assert proof == port_single[0]
    # the spies saw the sharded route's work: shards' transforms, folds, subtrees
    assert max(seen["stark_anatomy_tpu_torch.ops.ntt.ntt"]) == N // 4
    assert max(seen["stark_anatomy_tpu_torch.field.kernels.fri_fold"]) == N // 4
    assert max(seen["from_limbs_paired"]) == N // 4
    assert stark.routes["fold_sharded"] == 5


@pytest.mark.parametrize("shards", [2, 8])
def test_a_sharded_prover_folds_fri_to_the_last_layer(shards):
    """Over a FRI domain of 2^16 (13 layers, 2^16 down to 16 elements)
    the sharded prover folds every round on its shards, as one device folds
    every round on the card: 12 sharded folds, each layer a forest, the
    last one's pair blocks an element each at 8 shards; every transcript
    is prove_host's."""
    args = (FIELD, 4, 2, 4, 1, 4096)
    stark = ShardedFastStark(*args, transition_constraints_degree=2,
                             mesh=Mesh([[torch.device("cpu")] * shards]))
    single = FastStark(*args, transition_constraints_degree=2, device="cpu")
    assert stark.fri_domain_length == single.fri_domain_length == 1 << 16
    assert stark.fri.num_rounds() == 13
    rng = random.Random(0x7A11 + shards)
    values = [rng.randrange(P) for _ in range(1 << 16)]
    codeword = device_from_ints(values, "cpu")
    sharded_ps, single_ps, host_ps = ProofStream(), ProofStream(), ProofStream()
    idx = stark._fri(Sharded.place(stark.mesh, codeword), sharded_ps)
    assert stark.routes["fold_sharded"] == 12
    layers, _ = stark.fri.commit(Paired.of(Sharded.place(stark.mesh, codeword)), ProofStream())
    assert [type(layer) for layer in layers] == [DM.ForestRows] * 13
    layers, _ = single.fri.commit(codeword, ProofStream())
    assert [type(layer) for layer in layers] == [DM.DeviceRows] * 13
    assert idx == single.fri.prove(codeword, single_ps) == single.fri.prove_host(values, host_ps)
    assert sharded_ps.serialize() == single_ps.serialize() == host_ps.serialize()
