"""Rescue-Prime (Szepieniec, Ashur and Dhooghe, eprint 2020/1143) and the
signature scheme RPSSS of "Anatomy of a STARK" part 6 (rpsss.py,
fast_rpsss.py) over Python integers.

The instance's parameters come from the paper's own recipe, not from a
table: alpha is the least integer above 1 prime to p - 1; the MDS matrix
is the transposed right half of the echelon form of the m x 2m
Vandermonde matrix in the least primitive element; the 2mN round
constants are SHAKE256 of "Rescue-XLIX(p,m,capacity,security)" cut into
integers of ceil(log2(p)/8) + 1 little-endian bytes, each reduced mod p.

A secret key sk is a field element, its public key pk = hash(sk), and a
signature on a document is a STARK proof that the prover knows a preimage
of pk: the permutation's trace (cycle 0 register 1 is 0, the last cycle's
register 0 is pk) satisfies the AIR of the tutorial, which sets each
forward half-round of one cycle equal to the backward half-round of the
next read backwards, so every constraint has degree alpha.  The
Fiat-Shamir transcript is prefixed by blake2s(document).
"""

from __future__ import annotations

import hashlib
import math
from functools import lru_cache
from typing import List, Optional, Tuple

from . import field as F

P = F.P


class RescuePrime:
    """The permutation, hash and trace of one Rescue-Prime instance."""

    def __init__(self, m: int, capacity: int, rounds: int, security_level: int):
        self.m, self.capacity, self.rounds = m, capacity, rounds
        self.alpha = next(a for a in range(2, P) if math.gcd(a, P - 1) == 1)
        self.alpha_inv = pow(self.alpha, -1, P - 1)
        g = least_primitive_element()
        top = [[pow(g, i * j, P) for j in range(2 * m)] for i in range(m)]
        right = [row[m:] for row in echelon(top)]
        self.mds = [[right[j][i] for j in range(m)] for i in range(m)]
        self.mds_inv = inverse(self.mds)
        width = math.ceil(math.log2(P) / 8) + 1
        seed = f"Rescue-XLIX({P},{m},{capacity},{security_level})".encode()
        stream = hashlib.shake_256(seed).digest(width * 2 * m * rounds)
        self.round_constants = [int.from_bytes(stream[width * i:width * (i + 1)], "little") % P
                                for i in range(2 * m * rounds)]

    def _mix(self, matrix, state, constants):
        return [(sum(a * s for a, s in zip(row, state)) + c) % P for row, c in zip(matrix, constants)]

    def round(self, state: List[int], r: int) -> List[int]:
        m, rc = self.m, self.round_constants
        state = self._mix(self.mds, [pow(s, self.alpha, P) for s in state], rc[2 * r * m:2 * r * m + m])
        return self._mix(self.mds, [pow(s, self.alpha_inv, P) for s in state],
                         rc[2 * r * m + m:2 * r * m + 2 * m])

    def trace(self, sk: int) -> List[List[int]]:
        """The state before the first round and after each round."""
        state = [sk % P] + [0] * (self.m - 1)
        rows = [state]
        for r in range(self.rounds):
            state = self.round(state, r)
            rows.append(state)
        return rows

    def hash(self, sk: int) -> int:
        return self.trace(sk)[-1][0]


def least_primitive_element() -> int:
    factors = [2, 11, 37]                        # p - 1 = 2^119 * 11 * 37
    assert (P - 1) == (1 << 119) * 11 * 37
    return next(g for g in range(2, P) if all(pow(g, (P - 1) // q, P) != 1 for q in factors))


def echelon(rows: List[List[int]]) -> List[List[int]]:
    """The reduced row echelon form of a matrix of full row rank."""
    rows = [list(r) for r in rows]
    for i in range(len(rows)):
        pivot = next(k for k in range(i, len(rows)) if rows[k][i])
        rows[i], rows[pivot] = rows[pivot], rows[i]
        scale = F.inv(rows[i][i])
        rows[i] = [v * scale % P for v in rows[i]]
        for k in range(len(rows)):
            if k != i and rows[k][i]:
                f = rows[k][i]
                rows[k] = [(a - f * b) % P for a, b in zip(rows[k], rows[i])]
    return rows


def inverse(matrix: List[List[int]]) -> List[List[int]]:
    n = len(matrix)
    wide = echelon([row + [int(i == k) for k in range(n)] for i, row in enumerate(matrix)])
    return [row[n:] for row in wide]


class RescueAir:
    """The tutorial's AIR of the permutation at a point x of the FRI
    domain: for each register i, the forward half-round of the current
    state equals the next state with the backward half-round undone,
    (MDS cur^alpha + c1(x))_i = ((MDS^-1 (nxt - c2(x)))_i)^alpha, where
    c1, c2 interpolate the round constants on omicron^r, r < rounds."""

    def __init__(self, rp: RescuePrime, omicron: int):
        self.rp = rp
        self.omicron = omicron
        m, n = rp.m, rp.rounds
        xs = [pow(omicron, r, P) for r in range(n)]
        rc = rp.round_constants
        self.first = [F.interpolate(xs, [rc[2 * r * m + i] for r in range(n)]) for i in range(m)]
        self.second = [F.interpolate(xs, [rc[2 * r * m + m + i] for r in range(n)]) for i in range(m)]
        self.num_constraints = m

    def constraints(self, x: int, cur: List[int], nxt: List[int]) -> List[int]:
        rp = self.rp
        c1 = [F.evaluate(c, x) for c in self.first]
        c2 = [F.evaluate(c, x) for c in self.second]
        lhs = rp._mix(rp.mds, [pow(s, rp.alpha, P) for s in cur], c1)
        undone = rp._mix(rp.mds_inv, [(s - c) % P for s, c in zip(nxt, c2)], [0] * rp.m)
        return [(a - pow(b, rp.alpha, P)) % P for a, b in zip(lhs, undone)]

    def zerofier(self, x: int) -> int:
        """prod over the rounds (the transitions) of (x - omicron^r)."""
        z = 1
        for r in range(self.rp.rounds):
            z = z * (x - pow(self.omicron, r, P)) % P
        return z


def instance(config: dict) -> RescuePrime:
    return _instance(config["state_width"], config["capacity"], config["rounds"],
                     config["hash_security_level"])


@lru_cache(maxsize=None)
def _instance(m: int, capacity: int, rounds: int, security_level: int) -> RescuePrime:
    return RescuePrime(m, capacity, rounds, security_level)


def params(config: dict):
    from .stark import Params

    return Params.of(config, config["state_width"], config["num_cycles"])


def boundary(config: dict, pk: int) -> List[Tuple[int, int, int]]:
    """(cycle, register, value): the capacity starts at 0, and the rate
    ends at the public key."""
    return [(0, 1, 0), (config["rounds"], 0, pk % P)]


def zerofier_root(config: dict) -> bytes:
    """The root of the paired-leaf tree of the transition zerofier's whole
    codeword on the FRI domain."""
    from .merkle import root_of

    p = params(config)
    air = RescueAir(instance(config), p.omicron)
    x, codeword = F.GENERATOR, []
    for _ in range(p.fri_length):
        codeword.append(air.zerofier(x))
        x = x * p.omega % P
    return root_of(codeword)


def verify_signature(config: dict, pk: int, document: bytes, signature: bytes) -> bytes:
    """Raises stark.Rejected unless ``signature`` proves knowledge of a
    preimage of ``pk`` under the transcript of ``document``, every opened
    transition zerofier value recomputed; returns the zerofier root that
    its openings imply."""
    from .stark import Rejected, verify

    p = params(config)
    air = RescueAir(instance(config), p.omicron)

    def zerofier_check(opened):
        for x, value in opened.items():
            if air.zerofier(x) != value:
                raise Rejected("an opened transition zerofier value is wrong")

    prefix = hashlib.blake2s(bytes(document)).digest()
    return verify(p, signature, prefix, boundary(config, pk), air.constraints, air.num_constraints,
                  zerofier_check)


def judge_signature(config: dict, label: str, sk: int, pk: int, document: bytes,
                    signature: bytes) -> Tuple[bool, Optional[str], Optional[bytes]]:
    """One signature judged by the reference: whether ``pk`` differs from
    the hash of ``sk``, why the signature is rejected for the true public
    key and ``document`` (None where it verifies), and the zerofier root
    that its openings imply.  ``label`` names the signature in messages."""
    from .stark import Rejected

    expected = instance(config).hash(sk)
    try:
        root = verify_signature(config, expected, document, signature)
    except Rejected as exc:
        return pk != expected, f"{label}: {exc}", None
    return pk != expected, None, root
