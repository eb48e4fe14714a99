"""The STARK verifier of "Anatomy of a STARK" (code/fast_stark.py and
fri.py), over Python integers, with the port's encodings.

``verify`` judges one proof against a statement: the boundary values, an
AIR (its constraints at a point and its transition zerofier) and the
parameters of the configuration.  It re-derives the domains, the
Fiat-Shamir challenges, the degree bounds and the combination of the
openings at every query point, checks each Merkle opening against the
root in the transcript, every FRI colinearity test and the degree of the
last codeword, and checks the transition zerofier's opened values at the
points the AIR chooses against its own evaluation.  The zerofier's root
is not in the transcript: it is checked against the caller's, where the
caller can afford the whole codeword, and ``verify`` returns the root
that the openings imply, so that the caller can hold every proof of a
run to one tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from hashlib import blake2b
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import field as F
from .merkle import multiproof_root, paired_leaf, root_of
from .transcript import Malformed, Transcript

P = F.P


class Rejected(Exception):
    """The proof does not verify; the message says where."""


@dataclass(frozen=True)
class Params:
    expansion_factor: int
    num_colinearity_checks: int
    num_registers: int
    trace_length: int          # cycles of the original trace
    air_degree: int            # the transition constraints' degree in the trace

    @property
    def num_randomizers(self) -> int:
        return 4 * self.num_colinearity_checks

    @property
    def randomized_trace_length(self) -> int:
        return self.trace_length + self.num_randomizers

    @property
    def omicron_length(self) -> int:
        return 1 << (self.randomized_trace_length * self.air_degree).bit_length()

    @property
    def fri_length(self) -> int:
        return self.omicron_length * self.expansion_factor

    @property
    def omicron(self) -> int:
        return F.primitive_root(self.omicron_length)

    @property
    def omega(self) -> int:
        return F.primitive_root(self.fri_length)

    @classmethod
    def of(cls, config: dict, num_registers: int, trace_length: int) -> "Params":
        """The parameters a configuration file states, for an AIR of
        ``num_registers`` registers over ``trace_length`` cycles."""
        return cls(config["expansion_factor"], config["num_colinearity_checks"],
                   num_registers, trace_length, config["transition_constraints_degree"])

    def fri_rounds(self) -> int:
        n, rounds = self.fri_length, 0
        while n > self.expansion_factor and 4 * self.num_colinearity_checks < n:
            n //= 2
            rounds += 1
        return rounds


def sample_indices(seed: bytes, size: int, reduced_size: int, number: int) -> List[int]:
    """FRI's query indices: blake2b of the seed and an 8-byte counter, kept
    where distinct modulo the last codeword's length."""
    indices, reduced, counter = [], set(), 0
    while len(indices) < number:
        acc = 0
        for b in blake2b(seed + counter.to_bytes(8, "big")).digest():
            acc = (acc << 8) ^ b
        counter += 1
        index = acc % size
        if index % reduced_size not in reduced:
            indices.append(index)
            reduced.add(index % reduced_size)
    return indices


def sample_weights(number: int, seed: bytes) -> List[int]:
    return [F.sample(blake2b(seed + i.to_bytes(4, "big")).digest()) for i in range(number)]


def verify_fri(params: Params, ts: Transcript) -> List[Tuple[int, int]]:
    """FRI over the combination codeword; returns (index, value) of the
    first layer at every opened position, or raises Rejected."""
    rounds = params.fri_rounds()
    checks = params.num_colinearity_checks
    omega, offset = params.omega, F.GENERATOR
    N = params.fri_length
    roots, alphas = [], []
    for _ in range(rounds):
        roots.append(ts.pull(bytes))
        alphas.append(F.sample(ts.challenge()))
    last = ts.pull(list)
    if len(last) != N >> (rounds - 1):
        raise Rejected(f"last codeword has {len(last)} elements")
    if any(not 0 <= v < P for v in last):
        raise Rejected("last codeword leaves the field")
    if root_of(last) != roots[-1]:
        raise Rejected("last codeword does not match its root")
    last_omega = pow(omega, 1 << (rounds - 1), P)
    if not F.high_coefficients_zero(last, last_omega, len(last) // params.expansion_factor - 1):
        raise Rejected("last codeword is not of low degree")

    top = sample_indices(ts.challenge(), N >> 1, N >> (rounds - 1), checks)
    reveals = []
    for _ in range(rounds - 1):
        pairs = [ts.pull(tuple) for _ in range(checks)]
        if any(len(pair) != 2 for pair in pairs):
            raise Rejected("a FRI leaf is not a pair")
        reveals.append((pairs, ts.pull(list)))

    opened: List[Tuple[int, int]] = []
    for r in range(rounds - 1):
        half = N >> (r + 1)
        idx = [i % half for i in top]
        pairs, multiproof = reveals[r]
        for s in range(checks):
            ay, by = pairs[s]
            if r == 0:
                opened += [(idx[s], ay), (idx[s] + half, by)]
            if r + 2 < rounds:
                na, nb = reveals[r + 1][0][s]
                cy = na if idx[s] < half // 2 else nb
            else:
                cy = last[idx[s]]
            ax = offset * pow(omega, idx[s], P) % P
            bx = offset * pow(omega, idx[s] + half, P) % P
            if (by - ay) * (alphas[r] - ax) % P != (cy - ay) * (bx - ax) % P:
                raise Rejected(f"colinearity fails in round {r}, test {s}")
        leaves = {idx[s]: paired_leaf(*pairs[s]) for s in range(checks)}
        if multiproof_root(half.bit_length() - 1, leaves, multiproof) != roots[r]:
            raise Rejected(f"FRI opening of round {r} does not match its root")
        omega = omega * omega % P
        offset = offset * offset % P
    return opened


def verify(
    params: Params,
    proof: bytes,
    prefix: bytes,
    boundary: Sequence[Tuple[int, int, int]],
    constraints: Callable[[int, List[int], List[int]], List[int]],
    num_constraints: int,
    zerofier_check: Callable[[Dict[int, int]], None],
    zerofier_root: Optional[bytes] = None,
) -> bytes:
    """Verify ``proof``; returns the transition zerofier's root that its
    openings imply, or raises Rejected.  ``boundary`` lists (cycle,
    register, value); ``constraints(x, current, next)`` are the AIR's
    values at a point; ``zerofier_check({x: opened value})`` raises
    Rejected where an opened zerofier value is wrong; ``zerofier_root``,
    where the caller has computed it, is the root the openings must meet."""
    try:
        return _verify(params, proof, prefix, boundary, constraints, num_constraints,
                       zerofier_check, zerofier_root)
    except Malformed as exc:
        raise Rejected(f"malformed: {exc}") from None


def _verify(params, proof, prefix, boundary, constraints, num_constraints, zerofier_check,
            zerofier_root):
    ts = Transcript(proof, prefix)
    R, E, N = params.num_registers, params.expansion_factor, params.fri_length
    omicron, omega, g = params.omicron, params.omega, F.GENERATOR

    bq_roots = [ts.pull(bytes) for _ in range(R)]
    rand_root = ts.pull(bytes)
    weights = sample_weights(1 + 2 * num_constraints + 2 * R, ts.challenge())
    opened = sorted(verify_fri(params, ts))
    indices = [i for i, _ in opened]
    duplicated = sorted(indices + [(i + E) % N for i in indices])
    leaf_indices = sorted({i % (N // 2) for i in duplicated})
    depth = N.bit_length() - 2

    def section(root):
        values = ts.pull(list)
        multiproof = ts.pull(list)
        if len(values) != len(duplicated):
            raise Rejected("an opened section has the wrong length")
        vals = dict(zip(duplicated, values))
        leaves = {l: paired_leaf(vals[l], vals[l + N // 2]) for l in leaf_indices}
        implied = multiproof_root(depth, leaves, multiproof)
        if implied is None or (root is not None and implied != root):
            raise Rejected("an opened section does not match its root")
        return vals, implied

    bq = [section(bq_roots[s])[0] for s in range(R)]
    rand = section(rand_root)[0]
    tz, tz_root = section(zerofier_root)
    if not ts.exhausted():
        raise Rejected("trailing transcript objects")

    # degree bounds (fast_stark.py:35-68), with every constraint of degree
    # air_degree in the trace's variables
    d = params.randomized_trace_length - 1
    tq_bound = params.air_degree * d - (params.trace_length - 1)
    max_degree = (1 << tq_bound.bit_length()) - 1
    per_register = [[(c, v) for c, r, v in boundary if r == s] for s in range(R)]
    bq_bounds = [d - len(pts) for pts in per_register]
    interpolants = [F.interpolate([pow(omicron, c, P) for c, _ in pts], [v for _, v in pts])
                    for pts in per_register]

    def trace_at(s, x, value):
        z = 1
        for c, _ in per_register[s]:
            z = z * (x - pow(omicron, c, P)) % P
        return (value * z + F.evaluate(interpolants[s], x)) % P

    zerofier_check({g * pow(omega, i, P) % P: tz[i] for i in indices})
    for i, claimed in opened:
        x = g * pow(omega, i, P) % P
        xn = g * pow(omega, (i + E) % N, P) % P
        cur = [trace_at(s, x, bq[s][i]) for s in range(R)]
        nxt = [trace_at(s, xn, bq[s][(i + E) % N]) for s in range(R)]
        tz_inv = F.inv(tz[i])
        terms = [rand[i]]
        for value in constraints(x, cur, nxt):
            q = value * tz_inv % P
            terms += [q, q * pow(x, max_degree - tq_bound, P) % P]
        for s in range(R):
            terms += [bq[s][i], bq[s][i] * pow(x, max_degree - bq_bounds[s], P) % P]
        if len(terms) != len(weights):
            raise Rejected("the AIR gives the wrong number of constraints")
        if sum(w * t for w, t in zip(weights, terms)) % P != claimed:
            raise Rejected(f"the combination differs at index {i}")
    return tz_root
