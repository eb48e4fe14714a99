"""The port's MiMC model and its proofs against the JAX package's
models/mimc.py, at CPU-sized traces.

N2 (csrc/mimc_chain.cpp, the host chain) must equal its plain version and
the JAX package's trace; the device and scalar AIR evaluators the JAX
package's.  A seeded ``prove_chain`` at ``make_stark(15, 4, 4, 8)`` must
give the JAX package's proof bytes with the default knobs and with each
large-trace branch forced in both packages (the rolling zerofier, bulk
randomness, the device FRI) and, in the port, the four-step NTT too; each
package verifies the other's proof and rejects a false output.  Field
arithmetic is exact: equality, no tolerance.
"""

import functools
import hashlib
import random

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.field.scalar import Field as JField
from stark_anatomy_tpu.field.scalar import FieldElement as JElement
from stark_anatomy_tpu.models import mimc as JM
from stark_anatomy_tpu.ops import ntt as JN
from stark_anatomy_tpu.protocols.fri import Fri as JFri
from stark_anatomy_tpu_torch.commit.device_merkle import gather_rows
from stark_anatomy_tpu_torch.field.limbs import R
from stark_anatomy_tpu_torch.field.scalar import Field, FieldElement, P
from stark_anatomy_tpu_torch.models import mimc as TM
from stark_anatomy_tpu_torch.ops import ntt as TN
from stark_anatomy_tpu_torch.utils.convert import ints_from_device

torch.set_num_threads(1)

FIELD = Field.main()
RNG = random.Random(0x313C)
PROVE_PHASES = {"trace_gen", "trace_lde", "boundary_quotients", "commit_bq", "air_quotients",
                "randomizer_poly", "commit_randomizer", "combination", "fri", "openings"}


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")
    monkeypatch.delenv("STARK_TPU_DEVICE_HASH", raising=False)


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


def element(seed: int) -> FieldElement:
    return FieldElement(random.Random(seed).randrange(P), FIELD)


def jax_element(x: FieldElement) -> JElement:
    return JElement(x.value, JField.main())


def test_chain_constant_matches_jax():
    assert TM.MIMC_C == JM.MIMC_C


@pytest.mark.parametrize("steps", [1, 17, 64])
def test_native_chain_matches_plain_and_jax(steps):
    x = element(steps)
    mimc, jmimc = TM.MiMC(steps, device="cpu"), JM.MiMC(steps)
    x_m, c_m = x.value * R % P, TM.MIMC_C * R % P
    buf = TM.chain_bytes(x_m, c_m, steps)
    native = [int.from_bytes(buf[16 * i: 16 * (i + 1)].tobytes(), "little") for i in range(steps + 1)]
    assert native == TM.chain_plain(x_m, c_m, steps)
    want = [row[0].value for row in jmimc.trace(jax_element(x))]
    assert [v * pow(R, P - 2, P) % P for v in native] == want
    cols, out = mimc.trace_columns_with_output(x.value)
    assert cols.shape == (1, 8, steps + 1) and cols.dtype == torch.int32
    assert ints_from_device(cols[0]) == want
    assert np.array_equal(cols.numpy(), np.asarray(jmimc.trace_columns(x.value)).astype(np.int32))
    assert out == want[-1] == jmimc.forward(jax_element(x)).value
    assert [r[0].value for r in mimc.trace(x)] == want


def test_failed_chain_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "mimc_chain.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TM, "SOURCE", str(bad))
    monkeypatch.setattr(TM, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        TM.MiMC(3, device="cpu").trace_columns(5)


def test_airs_match_jax():
    mimc, jmimc = TM.MiMC(4, device="cpu"), JM.MiMC(4)
    air = mimc.transition_constraints()
    for _ in range(4):
        x, cur, nxt = (FieldElement(RNG.randrange(P), FIELD) for _ in range(3))
        want = [tc.evaluate([x, cur, nxt]).value for tc in air]
        assert [v.value for v in mimc.point_air()(x, [cur], [nxt])] == want
        jx, jcur, jnxt = (jax_element(v) for v in (x, cur, nxt))
        assert [v.value for v in jmimc.point_air()(jx, [jcur], [jnxt])] == want
    rng = np.random.default_rng(4)
    shape = (1, 8, 64)
    vals = rng.integers(0, 1 << 16, size=(3,) + shape, dtype=np.int64)
    vals[:, :, 7] &= 0x3FFF
    x_lde, cur, nxt = (v.astype(np.int32) for v in vals)
    got = mimc.air_evaluator()(torch.from_numpy(x_lde[0]), torch.from_numpy(cur), torch.from_numpy(nxt))
    want = jmimc.air_evaluator()(x_lde[0].astype(np.uint32), cur.astype(np.uint32), nxt.astype(np.uint32))
    assert got.shape == (1, 8, 64)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    idx = torch.arange(64)
    got = mimc.index_air()(idx, torch.from_numpy(cur), torch.from_numpy(nxt))
    want = jmimc.index_air()(np.arange(64), cur.astype(np.uint32), nxt.astype(np.uint32))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    assert mimc.air_evaluator() is mimc.air_evaluator() and mimc.index_air() is mimc.index_air()


def force(monkeypatch, config, jstark, tstark):
    """Set the knobs of one configuration in both packages."""
    if config in ("rolling_zerofier", "all"):
        monkeypatch.setattr(JN, "HOST_ZEROFIER_MAX", 1)
        monkeypatch.setattr(TN, "HOST_ZEROFIER_MAX", 1)
    if config in ("bulk_randomness", "all"):
        jstark.bulk_randomizer_threshold = 0
        tstark.bulk_randomizer_threshold = 0
    if config in ("device_fri", "all"):
        monkeypatch.setenv("STARK_TPU_DEVICE_HASH", "1")
        monkeypatch.setattr(JFri, "HOST_TAIL_MAX", 8)     # the port folds on the card to the end
    if config == "all":
        monkeypatch.setattr(TN, "NTT_MAX", 8)


CONFIGS = ["defaults", "rolling_zerofier", "bulk_randomness", "device_fri", "all"]


@pytest.mark.parametrize("config", CONFIGS)
def test_prove_chain_matches_jax(monkeypatch, config):
    x = element(15)
    jx = jax_element(x)
    jmimc, jstark = JM.make_stark(15, 4, 4, 8)
    tmimc, tstark = TM.make_stark(15, 4, 4, 8, device="cpu")
    force(monkeypatch, config, jstark, tstark)
    seed = b"mimc proof " + config.encode()
    # the JAX package's prove_chain draws from FastStark.prove's urandom
    jstark.prove = functools.partial(jstark.prove, urandom=det_urandom(seed))
    jout, jproof, jtz = JM.prove_chain(jmimc, jstark, jx)
    tout, tproof, ttz = TM.prove_chain(tmimc, tstark, x, urandom=det_urandom(seed))
    assert tout.value == jout.value == tmimc.forward(x).value
    assert ttz.root == jtz.root
    assert tproof == jproof
    assert TM.verify_chain(tmimc, tstark, x, tout, jproof, ttz.root)
    assert JM.verify_chain(jmimc, jstark, jx, jout, tproof, jtz.root)
    assert not TM.verify_chain(tmimc, tstark, x, tout + FIELD.one(), tproof, ttz.root)
    assert not TM.verify_chain(tmimc, tstark, x + FIELD.one(), tout, tproof, ttz.root)


def test_rolling_preprocess_matches_host_path(monkeypatch):
    _, stark = TM.make_stark(15, 4, 4, 8, device="cpu")
    tz = stark.preprocess()
    monkeypatch.setattr(TN, "HOST_ZEROFIER_MAX", 1)
    _, rolling = TM.make_stark(15, 4, 4, 8, device="cpu")
    rtz = rolling.preprocess()
    assert rtz.root == tz.root
    idx = [0, 7, 100, 511]
    assert gather_rows(rtz.rows, idx) == gather_rows(tz.rows, idx)
    assert torch.equal(rtz.inv_codeword, tz.inv_codeword)
    assert torch.equal(rolling._interp_tables()["zn_over_xm"], stark._interp_tables()["zn_over_xm"])
    assert torch.equal(rolling._interp_tables()["inv_dz"], stark._interp_tables()["inv_dz"])


def test_phases_cover_a_steady_prove():
    """The phase table accounts for a steady prove's wall clock (the JAX
    package's tests/test_mimc.py:118-129); the first prove builds tables
    outside the phases."""
    import time

    mimc, stark = TM.make_stark(63, 4, 4, 8, device="cpu")
    tz = stark.preprocess()
    x = element(63)
    TM.prove_chain(mimc, stark, x, tz)
    stark.timer.totals.clear()
    stark.timer.counts.clear()
    t = time.perf_counter()
    out, proof, _ = TM.prove_chain(mimc, stark, x, tz)
    wall = time.perf_counter() - t
    assert set(stark.timer.totals) == PROVE_PHASES
    assert sum(stark.timer.totals.values()) > 0.8 * wall
    assert TM.verify_chain(mimc, stark, x, out, proof, tz.root)


def test_mimc_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.MiMC(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.make_stark(15, 4, 4, 8)
