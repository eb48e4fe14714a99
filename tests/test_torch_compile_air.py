"""The generic AIR compiler of the port against the JAX package's.

``compile_air`` turns the symbolic Rescue-Prime transition constraints
into a pointwise evaluator over LDE codewords.  On the same seeded inputs
(numpy, on the CPU) the port's evaluator gives the JAX package's values,
and a seeded ``FastStark.prove`` with no ``air_evaluator`` (so through
``compile_air``) gives the JAX package's proof bytes; each package
verifies the other's proof.  Field arithmetic is exact: tolerance zero.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_anatomy_tpu.field.scalar import Field, P
from stark_anatomy_tpu.protocols import fast_stark as JFS
from stark_anatomy_tpu_torch.models import rescue_prime as TR
from stark_anatomy_tpu_torch.protocols import fast_stark as TFS
from stark_anatomy_tpu_torch.utils.convert import device_from_ints, ints_from_device

torch.set_num_threads(1)

FIELD = Field.main()
PROVE_PHASES = {"trace_lde", "boundary_quotients", "commit_bq", "air_quotients",
                "randomizer_poly", "commit_randomizer", "combination", "fri", "openings"}


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


@pytest.fixture(scope="module")
def setup():
    """The robustness fixture's parameters in both packages: the stark, the
    Rescue AIR, a boundary and the preprocessed zerofier."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        rp = TR.RescuePrime()
        args = (FIELD, 4, 2, 4, rp.m, rp.N + 1)
        js = JFS.FastStark(*args, transition_constraints_degree=3)
        ts = TFS.FastStark(*args, transition_constraints_degree=3, device="cpu")
        sk = FIELD.sample(b"compile air witness")
        trace = rp.trace(sk)
        boundary = rp.boundary_constraints(rp.hash(sk))
        air = rp.transition_constraints(ts.omicron)
        jtz, ttz = js.preprocess(), ts.preprocess()
        yield js, ts, trace, boundary, air, jtz, ttz


@pytest.mark.parametrize("n", [8, 64])
def test_compile_air_matches_jax_on_seeded_lde_inputs(setup, n, monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    from stark_anatomy_tpu.utils.convert import device_from_ints as jax_from_ints
    from stark_anatomy_tpu.utils.convert import ints_from_device as jax_ints

    _, _, _, _, air, _, _ = setup
    rng = np.random.default_rng(n)
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(5 * n)]
    # x, then R = 2 current and R = 2 next rows, n points each
    x, cur, nxt = vals[:n], vals[n : 3 * n], vals[3 * n :]
    got = TFS.compile_air(air)(
        device_from_ints(x, "cpu"),
        torch.stack([device_from_ints(cur[r * n : (r + 1) * n], "cpu") for r in range(2)]),
        torch.stack([device_from_ints(nxt[r * n : (r + 1) * n], "cpu") for r in range(2)]),
    )
    want = JFS.compile_air(air)(
        jax_from_ints(x),
        jnp.stack([jax_from_ints(cur[r * n : (r + 1) * n]) for r in range(2)]),
        jnp.stack([jax_from_ints(nxt[r * n : (r + 1) * n]) for r in range(2)]),
    )
    assert tuple(got.shape) == tuple(want.shape) == (len(air), 8, n)
    assert ints_from_device(got) == jax_ints(want)


def test_compiled_air_is_cached_by_constraint_content(setup):
    _, ts, _, _, air, _, _ = setup
    fn = ts._compiled_air(air)
    assert ts._compiled_air(list(air)) is fn


@pytest.fixture(scope="module")
def proofs(setup):
    """(port proof, JAX proof), both through compile_air, one seed."""
    js, ts, trace, boundary, air, jtz, ttz = setup
    assert ttz.root == jtz.root
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STARK_TPU_AOT", "0")
        jproof = js.prove(trace, air, boundary, jtz, urandom=det_urandom(b"compile air"))
    tproof = ts.prove(trace, air, boundary, ttz, urandom=det_urandom(b"compile air"))
    return tproof, jproof


def test_prove_without_air_evaluator_is_byte_identical_to_jax(proofs):
    tproof, jproof = proofs
    assert tproof == jproof


def test_each_package_verifies_the_others_compiled_air_proof(setup, proofs, monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    js, ts, _, boundary, air, jtz, ttz = setup
    tproof, jproof = proofs
    index_air = TR.make_index_air_evaluator(ts)
    assert ts.verify(jproof, air, boundary, ttz.root, air_index_evaluator=index_air)
    assert ts.verify(tproof, air, boundary, ttz.root)           # symbolic per-index loop
    assert js.verify(tproof, air, boundary, jtz.root)


def test_prove_records_the_jax_phase_names(setup, proofs):
    js, ts, _, _, _, _, _ = setup
    # the port's timer also holds ``verify`` once the port has verified
    assert set(ts.timer.totals) - {"verify"} == PROVE_PHASES
    assert set(js.timer.totals) == PROVE_PHASES
    assert all(ts.timer.counts[name] >= 1 for name in PROVE_PHASES)
    assert "openings" in ts.timer.report()

