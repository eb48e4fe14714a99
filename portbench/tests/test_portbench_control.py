"""``correct`` comes out false where it has to.  Each cell's driver runs at
a size a CPU can hold (the configuration's shapes with fewer colinearity
checks and 63 steps), with the timed path broken underneath: an answer
altered where it is produced, a step that hands back its last answer
unchanged, a wrong chain output, and the control, the program at half
the configuration's colinearity checks and bits of security.  The sound program at the same size comes out correct.
On a card, the last test reads the sound program and the control at each
cell's own size."""

import json
import os

import pytest

from portbench import control
from portbench import harness as H

SMALL = {"mimc_2p20": {"num_colinearity_checks": 4, "security_level": 8, "steps": 63}}
TRAFFIC = {"prove": {"warmup": 1, "judged": 4, "zerofier_points": 2}}
CONFIG = {"prove": "mimc_2p20"}
SECONDS = {"prove": 3.0}


def small_cell(mix):
    """The mix on its configuration, by their files, cut to a CPU's size."""
    with open(os.path.join(H.HERE, "configs", CONFIG[mix] + ".json")) as f:
        config = dict(json.load(f), **SMALL[CONFIG[mix]])
    with open(os.path.join(H.HERE, "traffic", mix + ".json")) as f:
        traffic = dict(json.load(f), **TRAFFIC[mix])
    return H.Cell("test." + mix, 1, config, traffic, [], [])


def run(mix, breaker=None, program=None):
    """The checks of one small run on the CPU; ``breaker()`` runs between
    set-up and window."""
    cell = small_cell(mix)
    driver = H.driver_module(cell).Driver(cell, program=program, device="cpu")
    driver.setup(11)
    if breaker:
        breaker()
    try:
        win = driver.window(12, SECONDS[mix], False)
    finally:
        driver.close()
    checks = driver.judge(win, 12)
    assert driver.attempted(win)[0] > 0
    return checks


def altered(data: bytes) -> bytes:
    i = len(data) // 3
    return data[:i] + bytes([data[i] ^ 0x5A]) + data[i + 1:]


@pytest.mark.parametrize("mix", ["prove"])
def test_the_sound_program_is_correct(mix):
    checks = run(mix)
    assert H.within(checks), checks


@pytest.mark.parametrize("mix", ["prove"])
def test_the_control_is_not_correct(mix):
    cell = small_cell(mix)
    checks = run(mix, program=control.control_program(cell.config))
    assert not H.within(checks), checks


@pytest.mark.parametrize("fault", ["output", "proof", "stale"])
def test_chain_proof_faults(monkeypatch, fault):
    from stark_anatomy_tpu_torch.models import mimc as MM

    prove, first = MM.prove_chain, []

    def broken(*a, **k):
        out, proof, tz = prove(*a, **k)
        if fault == "output":
            return out + MM.FieldElement(1, out.field), proof, tz
        if fault == "proof":
            return out, altered(proof), tz
        if not first:
            first.append((out, proof, tz))
        return first[0]

    checks = run("prove", lambda: monkeypatch.setattr(MM, "prove_chain", broken))
    assert not H.within(checks), checks
    if fault == "output":
        assert checks["outputs_wrong"][0] > 0
    else:
        assert checks["proofs_rejected"][0] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in json.load(open(os.path.join(H.ROOT, "BENCHMARK.json")))
                                  ["workloads"]])
def test_control_at_the_cell_s_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = H.load_cell(cell)
    (_, sound, _), = control.readings(c, "sound", [21], 10.0)
    (_, ctrl, _), = control.readings(c, "control", [21], 10.0)
    assert H.within(sound), sound
    assert not H.within(ctrl), ctrl
