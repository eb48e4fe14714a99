"""The plain reference agrees with itself at a tiny size, and judges the
port's proofs: it accepts them and rejects them altered."""

import random

import pytest

from portbench.reference import field as F
from portbench.reference import merkle, mimc
from portbench.reference.stark import Params, Rejected, sample_indices

P = F.P
SMALL_MIMC = {"steps": 63, "expansion_factor": 4, "num_colinearity_checks": 4, "security_level": 8,
              "transition_constraints_degree": 3,
              "round_constant": 5788833881383624466382647819188111782}


def test_dft_is_the_sum_it_stands_for():
    rng = random.Random(1)
    for n in (1, 2, 8, 32):
        w = F.primitive_root(n)
        v = [rng.randrange(P) for _ in range(n)]
        assert F.dft(v, w) == [sum(v[j] * pow(w, j * k, P) for j in range(n)) % P for k in range(n)]


def test_degree_check_tells_low_from_high():
    w = F.primitive_root(16)
    low = [F.evaluate([3, 5, 7], pow(w, i, P)) for i in range(16)]
    high = [F.evaluate([3, 5, 7, 0, 1], pow(w, i, P)) for i in range(16)]
    assert F.high_coefficients_zero(low, w, 3)
    assert not F.high_coefficients_zero(high, w, 3)


def test_interpolation_passes_through_its_points():
    rng = random.Random(2)
    xs = [rng.randrange(P) for _ in range(6)]
    ys = [rng.randrange(P) for _ in range(6)]
    coeffs = F.interpolate(xs, ys)
    assert [F.evaluate(coeffs, x) for x in xs] == ys


def open_multi(codeword, indices):
    """A multiproof over a whole tree, as the reference reads it."""
    half = len(codeword) // 2
    level = [merkle.paired_leaf(codeword[i], codeword[i + half]) for i in range(half)]
    known, proof = sorted(set(indices)), []
    while len(level) > 1:
        proof += [level[i ^ 1] for i in known if i ^ 1 not in known]
        known = sorted({i >> 1 for i in known})
        from hashlib import blake2s

        level = [blake2s(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    return proof


def test_multiproofs_meet_the_root_and_nothing_else():
    rng = random.Random(3)
    codeword = [rng.randrange(P) for _ in range(64)]
    root = merkle.root_of(codeword)
    idx = sorted(rng.sample(range(32), 5))
    leaves = {i: merkle.paired_leaf(codeword[i], codeword[i + 32]) for i in idx}
    proof = open_multi(codeword, idx)
    assert merkle.multiproof_root(5, leaves, proof) == root
    assert merkle.multiproof_root(5, leaves, proof[:-1]) is None
    assert merkle.multiproof_root(5, leaves, proof + [proof[0]]) is None
    bad = {**leaves, idx[0]: merkle.paired_leaf(1, 2)}
    assert merkle.multiproof_root(5, bad, proof) != root


def test_mimc_air_holds_on_the_chain():
    air = mimc.MimcAir(7, F.primitive_root(256), 63)
    x = 5
    for i in range(63):
        nxt = (x ** 3 + 7) % P
        assert air.constraints(123, [x], [nxt]) == [0]
        assert air.zerofier(pow(air.omicron, i, P)) == 0
        x = nxt
    assert mimc.chain_output(5, 7, 63) == x
    assert air.zerofier(pow(air.omicron, 63, P)) != 0


def test_query_indices_are_distinct_in_the_last_codeword():
    idx = sample_indices(b"seed", 2048, 256, 64)
    assert len({i % 256 for i in idx}) == 64 and all(0 <= i < 2048 for i in idx)


def test_parameters_of_the_configuration_are_the_port_s():
    import json
    import os

    from stark_anatomy_tpu_torch.models import mimc as MM

    _, stark = MM.make_stark(63, 4, 4, 8, device="cpu")
    p = Params.of(SMALL_MIMC, 1, 64)
    assert (p.omicron_length, p.fri_length) == (stark.omicron_domain_length, stark.fri_domain_length)
    assert (p.fri_length, p.fri_rounds()) == (1024, 6)
    config = json.load(open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                                         "mimc_2p20.json")))
    prod = Params.of(config, 1, config["steps"] + 1)
    assert (prod.omicron_length, prod.fri_length) == (1 << 22, config["fri_domain_length"])


def seeded(label):
    import hashlib

    ctr = [0]

    def draw(n):
        out = b""
        while len(out) < n:
            out += hashlib.blake2b(label + ctr[0].to_bytes(8, "big")).digest()
            ctr[0] += 1
        return out[:n]

    return draw


def flips(data, count, seed):
    rng = random.Random(seed)
    for _ in range(count):
        i = rng.randrange(len(data))
        yield data[:i] + bytes([data[i] ^ rng.randrange(1, 256)]) + data[i + 1:]


def test_reference_judges_the_port_s_chain_proofs():
    from stark_anatomy_tpu_torch.field.scalar import Field
    from stark_anatomy_tpu_torch.models import mimc as MM

    chain, stark = MM.make_stark(63, 4, 4, 8, device="cpu")
    x = Field.main().sample(b"x0")
    out, proof, tz = MM.prove_chain(chain, stark, x, urandom=seeded(b"chain"))
    assert mimc.chain_output(x.value, SMALL_MIMC["round_constant"], 63) == out.value
    pick = random.Random(5).sample
    assert mimc.verify_chain_proof(SMALL_MIMC, x.value, out.value, proof, 4, pick) == tz.root
    with pytest.raises(Rejected):
        mimc.verify_chain_proof(SMALL_MIMC, x.value, out.value + 1, proof, 1, pick)
    for f in flips(proof, 40, 6):
        try:
            root = mimc.verify_chain_proof(SMALL_MIMC, x.value, out.value, f, 1, pick)
        except Rejected:
            continue
        assert root != tz.root        # only the zerofier's path was altered: its root moved
    assert mimc.judge_proof(SMALL_MIMC, 2, "a", x.value, out.value, proof) == (False, None, tz.root)
    wrong, reason, root = mimc.judge_proof(SMALL_MIMC, 2, "a", x.value, out.value + 1, proof)
    assert wrong and reason is None and root == tz.root
    wrong, reason, root = mimc.judge_proof(SMALL_MIMC, 2, "a", x.value + 1, out.value, proof)
    assert reason and root is None
