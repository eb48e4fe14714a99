"""The MiMC cubing chain x -> x^3 + c (Albrecht et al., ASIACRYPT 2016,
with the exponent 3 and one round constant for every step), its AIR at a
point, and its transition zerofier."""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

from . import field as F

P = F.P


def chain_output(x0: int, c: int, steps: int) -> int:
    x = x0 % P
    for _ in range(steps):
        x = (x * x % P * x + c) % P
    return x


def boundary(x0: int, output: int, steps: int):
    """(cycle, register, value): the chain's input and its output."""
    return [(0, 0, x0 % P), (steps, 0, output % P)]


class MimcAir:
    num_constraints = 1

    def __init__(self, c: int, omicron: int, steps: int):
        self.c, self.omicron, self.steps = c % P, omicron, steps

    def constraints(self, x: int, cur: List[int], nxt: List[int]) -> List[int]:
        return [(nxt[0] - pow(cur[0], 3, P) - self.c) % P]

    def zerofier(self, x: int) -> int:
        """prod over the chain's steps of (x - omicron^i), factor by factor."""
        z, o = 1, 1
        w = self.omicron
        for _ in range(self.steps):
            z = z * (x - o) % P
            o = o * w % P
        return z


def verify_chain_proof(config: dict, x0: int, output: int, proof: bytes, zerofier_points: int,
                       pick) -> bytes:
    """Raises stark.Rejected unless ``proof`` proves that the chain of the
    configuration's steps and round constant takes ``x0`` to ``output``;
    ``zerofier_points`` of the opened zerofier values, chosen by
    ``pick(population, k)``, are checked against the zerofier itself (a
    product of 2^20 factors at the full size).  Returns the zerofier root
    that the openings imply."""
    from .stark import Params, Rejected, verify

    steps = config["steps"]
    params = Params.of(config, 1, steps + 1)
    air = MimcAir(config["round_constant"], params.omicron, steps)

    def zerofier_check(opened):
        for x in pick(sorted(opened), zerofier_points):
            if air.zerofier(x) != opened[x]:
                raise Rejected("an opened transition zerofier value is wrong")

    return verify(params, proof, b"", boundary(x0, output, steps), air.constraints,
                  air.num_constraints, zerofier_check)


def judge_proof(config: dict, zerofier_points: int, label: str, x0: int, output: int,
                proof: bytes) -> Tuple[bool, Optional[str], Optional[bytes]]:
    """One proof of the chain from ``x0`` judged by the reference: whether
    ``output`` differs from the chain's true output, why the proof is
    rejected for that true output (None where it verifies), and the
    zerofier root that its openings imply.  ``label`` seeds the choice of
    the opened zerofier values that are recomputed."""
    from .stark import Rejected

    expected = chain_output(x0, config["round_constant"], config["steps"])
    try:
        root = verify_chain_proof(config, x0, expected, proof, zerofier_points,
                                  random.Random(label).sample)
    except Rejected as exc:
        return output != expected, str(exc), None
    return output != expected, None, root
