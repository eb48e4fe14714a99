"""Rescue-Prime: the framework's built-in AIR workload ("model").

The port of stark_anatomy_tpu/models/rescue_prime.py.  Scalar semantics
match the reference (rescue_prime.py:5-273): m=2 state, rate 1, capacity
1, N=27 rounds, alpha=3, with the forward/backward half-round
arithmetization trick that keeps the AIR at degree 3.

Device parts, over the field kernels:
* :func:`hash_batch` / :func:`trace_batch` -- the permutation over a batch
  of inputs (the JAX package's lax.scan, ``_permutation_scan``): one
  launch of H2 (field/kernels.py:rescue_permutation) on the card, its
  plain version over the rounds on the CPU; the x^(1/3) S-box is a
  128-bit square and multiply, the dominant per-round cost.
* :func:`_rescue_air_kernel` -- the pointwise AIR on LDE codewords, the
  evaluators' glue over H0/H1.  The paths take the kernels that fuse it
  instead: H10 (field/kernels.py:rescue_quotients, the prover's boundary
  and transition quotients) and H12 (verify_core, the verifier's
  combination at the query points).  ``rescue_air_tables`` holds the
  tables both take, and the evaluators carry them as ``rescue_tables``,
  so that a caller can tell a Rescue evaluator from another.
"""

from __future__ import annotations

from typing import List

import torch

from ..field import kernels as K
from ..field import ops as F
from ..field.limbs import NLIMBS
from ..field.scalar import Field, FieldElement, P
from ..parallel.mesh import Sharded, shard_parts
from ..poly.multivariate import MPolynomial
from ..poly.univariate import Polynomial
from .rescue_constants import ALPHA, ALPHA_INV, MDS, MDS_INV, ROUND_CONSTANTS

M = 2
N_ROUNDS = 27


class RescuePrime:
    """Scalar Rescue-Prime instance over the canonical field."""

    def __init__(self):
        self.field = Field.main()
        self.p = P
        self.m = M
        self.rate = 1
        self.capacity = 1
        self.N = N_ROUNDS
        self.alpha = ALPHA
        self.alphainv = ALPHA_INV
        self.MDS = [[FieldElement(v, self.field) for v in row] for row in MDS]
        self.MDSinv = [[FieldElement(v, self.field) for v in row] for row in MDS_INV]
        self.round_constants = [FieldElement(v, self.field) for v in ROUND_CONSTANTS]

    # -- permutation ---------------------------------------------------------
    def _round(self, state: List[FieldElement], r: int) -> List[FieldElement]:
        # forward half-round: S-box x^alpha, MDS, constants
        state = [s ** self.alpha for s in state]
        state = [
            sum(
                (self.MDS[i][j] * state[j] for j in range(self.m)),
                self.field.zero(),
            )
            + self.round_constants[2 * r * self.m + i]
            for i in range(self.m)
        ]
        # backward half-round: S-box x^(1/alpha), MDS, constants
        state = [s ** self.alphainv for s in state]
        state = [
            sum(
                (self.MDS[i][j] * state[j] for j in range(self.m)),
                self.field.zero(),
            )
            + self.round_constants[2 * r * self.m + self.m + i]
            for i in range(self.m)
        ]
        return state

    def hash(self, input_element: FieldElement) -> FieldElement:
        state = [input_element] + [self.field.zero()] * (self.m - 1)
        for r in range(self.N):
            state = self._round(state, r)
        return state[0]

    def trace(self, input_element: FieldElement) -> List[List[FieldElement]]:
        state = [input_element] + [self.field.zero()] * (self.m - 1)
        trace = [list(state)]
        for r in range(self.N):
            state = self._round(state, r)
            trace.append(list(state))
        return trace

    # -- AIR -----------------------------------------------------------------
    def boundary_constraints(self, output_element: FieldElement):
        """[(cycle, register, value)] (reference: rescue_prime.py:206-215)."""
        return [
            (0, 1, self.field.zero()),          # capacity starts at zero
            (self.N, 0, output_element),        # rate ends at the hash output
        ]

    def round_constants_polynomials(self, omicron: FieldElement):
        """Interpolate the round constants over the trace domain and lift
        (reference: rescue_prime.py:217-237)."""
        domain = [omicron ** r for r in range(self.N)]
        first, second = [], []
        for i in range(self.m):
            vals = [self.round_constants[2 * r * self.m + i] for r in range(self.N)]
            first.append(MPolynomial.lift(Polynomial.interpolate_domain(domain, vals), 0))
        for i in range(self.m):
            vals = [
                self.round_constants[2 * r * self.m + self.m + i]
                for r in range(self.N)
            ]
            second.append(MPolynomial.lift(Polynomial.interpolate_domain(domain, vals), 0))
        return first, second

    def transition_constraints(self, omicron: FieldElement) -> List[MPolynomial]:
        """The AIR: m polynomials in 1+2m variables equating
        forward-half-round(prev) with backward-half-round^{-1}(next) — both
        degree alpha, which is the trick that keeps the AIR at degree 3
        (reference: rescue_prime.py:239-267)."""
        first_step, second_step = self.round_constants_polynomials(omicron)
        variables = MPolynomial.variables(1 + 2 * self.m, self.field)
        previous_state = variables[1 : 1 + self.m]
        next_state = variables[1 + self.m : 1 + 2 * self.m]
        air = []
        for i in range(self.m):
            lhs = MPolynomial.constant(self.field.zero())
            for k in range(self.m):
                lhs = lhs + MPolynomial.constant(self.MDS[i][k]) * (
                    previous_state[k] ** self.alpha
                )
            lhs = lhs + first_step[i]
            rhs = MPolynomial.constant(self.field.zero())
            for k in range(self.m):
                rhs = rhs + MPolynomial.constant(self.MDSinv[i][k]) * (
                    next_state[k] - second_step[k]
                )
            rhs = rhs ** self.alpha
            air.append(lhs - rhs)
        return air


# ---------------------------------------------------------------------------
# Device code
# ---------------------------------------------------------------------------

def _mont_matrix(rows, device) -> torch.Tensor:
    """(m, m) host ints -> (m, m, NLIMBS, 1) Montgomery constants."""
    return torch.stack(
        [torch.stack([F.mont_const(v, device) for v in row]) for row in rows]
    )


_PERMUTATION_TABLES = {}


def permutation_tables(device):
    """(round constants (N, 2, m, NLIMBS, 1), MDS (m, m, NLIMBS, 1)) in
    Montgomery form, the tables H2 takes, cached per device.  Round r adds
    [r, 0] after its forward half and [r, 1] after its backward half."""
    device = torch.device(device)
    if device not in _PERMUTATION_TABLES:
        rc = _mont_matrix(
            [[ROUND_CONSTANTS[2 * r * M + half + i] for i in range(M)]
             for r in range(N_ROUNDS) for half in (0, M)],
            device,
        ).reshape(N_ROUNDS, 2, M, NLIMBS, 1)
        _PERMUTATION_TABLES[device] = (rc, _mont_matrix(MDS, device))
    return _PERMUTATION_TABLES[device]


def _permute(state: torch.Tensor, collect_trace: bool) -> torch.Tensor:
    rc, mds = permutation_tables(state.device)
    return K.rescue_permutation(state, rc, mds, ALPHA_INV, collect_trace)


def _initial_state(inputs: torch.Tensor) -> torch.Tensor:
    """(NLIMBS, B) inputs -> (m, NLIMBS, B) states: the input absorbed into
    the rate, the capacity zero."""
    return torch.stack([inputs, torch.zeros_like(inputs)], dim=-3)


def hash_batch(inputs: torch.Tensor) -> torch.Tensor:
    """Batched Rescue-Prime hash: (NLIMBS, B) mont inputs -> (NLIMBS, B)."""
    return _permute(_initial_state(inputs), collect_trace=False)[..., 0, :, :]


def trace_batch(inputs: torch.Tensor) -> torch.Tensor:
    """Batched execution trace: (NLIMBS, B) -> (N+1, m, NLIMBS, B)."""
    return _permute(_initial_state(inputs), collect_trace=True)


def _rescue_air_kernel(trace_lde, next_lde, c1_lde, c2_lde, mds, mds_inv):
    """Pointwise Rescue AIR on LDE codewords.

    constraint_i = [ sum_k MDS[i][k] * prev_k^3 + C1_i(x) ]
                 - [ sum_k MDSinv[i][k] * (next_k - C2_k(x)) ]^3

    trace_lde/next_lde: (..., m, NLIMBS, N); c1_lde/c2_lde: (m, NLIMBS, N).
    """
    outs = []
    prev3 = F.mont_mul(F.mont_mul(trace_lde, trace_lde), trace_lde)
    inner = F.sub(next_lde, c2_lde)
    for i in range(M):
        lhs = F.mont_mul(prev3[..., 0, :, :], mds[i, 0])
        for k in range(1, M):
            lhs = F.add(lhs, F.mont_mul(prev3[..., k, :, :], mds[i, k]))
        lhs = F.add(lhs, c1_lde[..., i, :, :])
        rhs = F.mont_mul(inner[..., 0, :, :], mds_inv[i, 0])
        for k in range(1, M):
            rhs = F.add(rhs, F.mont_mul(inner[..., k, :, :], mds_inv[i, k]))
        rhs = F.mont_mul(F.mont_mul(rhs, rhs), rhs)
        outs.append(F.sub(lhs, rhs))
    return torch.stack(outs, dim=-3)


def make_point_air(stark):
    """Scalar per-point AIR evaluator for the VERIFIER.

    ``FastStark.verify`` evaluates the transition constraints at each query
    point; the generic path goes through the symbolic :class:`MPolynomial`
    constraints, whose ``rhs**3`` expansion has thousands of monomials —
    seconds of host big-int work per proof.  This closure evaluates the
    SAME constraints in factored form (two MDS combines, two cubings, and
    2m degree-(N_ROUNDS-1) Horner evaluations of the round-constant
    interpolants): ~120 field multiplies per point.  Pass as
    ``air_point_evaluator=`` to FastStark.verify.
    """
    rp = RescuePrime()
    omicron = stark.omicron
    domain = [omicron ** r for r in range(rp.N)]
    first, second = [], []
    for i in range(rp.m):
        vals1 = [rp.round_constants[2 * r * rp.m + i] for r in range(rp.N)]
        vals2 = [rp.round_constants[2 * r * rp.m + rp.m + i] for r in range(rp.N)]
        first.append(Polynomial.interpolate_domain(domain, vals1))
        second.append(Polynomial.interpolate_domain(domain, vals2))

    def evaluator(x, current, next_):
        c1 = [p.evaluate(x) for p in first]
        c2 = [p.evaluate(x) for p in second]
        inner = [next_[k] - c2[k] for k in range(rp.m)]
        values = []
        for i in range(rp.m):
            lhs = c1[i]
            for k in range(rp.m):
                lhs = lhs + rp.MDS[i][k] * (current[k] ** rp.alpha)
            rhs = rp.MDSinv[i][0] * inner[0]
            for k in range(1, rp.m):
                rhs = rhs + rp.MDSinv[i][k] * inner[k]
            values.append(lhs - rhs ** rp.alpha)
        return values

    return evaluator


def rescue_air_tables(stark):
    """(c1_lde, c2_lde, mds, mds_inv) round-constant tables for a FastStark
    instance, built once (kept on the instance) and shared by the prover
    evaluator and the batched verifier evaluator: the 2m round-constant
    polynomials are interpolated on the host and evaluated on the FRI
    domain with one batched Horner call."""
    cached = getattr(stark, "_rescue_tables", None)
    if cached is not None:
        return cached
    from ..ops.ntt import evaluate_domain_horner
    from ..utils.convert import device_from_ints

    device = stark.device
    rp = RescuePrime()
    omicron = stark.omicron
    domain = [omicron ** r for r in range(rp.N)]
    x_lde = stark._interp_tables()["x_lde"]

    coeff_ints = []
    for half in (0, rp.m):
        for i in range(rp.m):
            vals = [rp.round_constants[2 * r * rp.m + half + i] for r in range(rp.N)]
            poly = Polynomial.interpolate_domain(domain, vals)
            cs = [c.value for c in poly.coefficients]
            cs += [0] * (rp.N - len(cs))
            coeff_ints.extend(cs)
    coeffs = device_from_ints(coeff_ints, device)            # (L, 2m*N_ROUNDS)
    coeffs = coeffs.reshape(NLIMBS, 2 * rp.m, rp.N).movedim(1, 0)  # (2m, L, N_ROUNDS)
    both = stark._pointwise(evaluate_domain_horner, coeffs, x_lde)   # (2m, L, N_fri)
    out = (both[: rp.m], both[rp.m :], _mont_matrix(MDS, device), _mont_matrix(MDS_INV, device))
    stark._rescue_tables = out
    return out


def make_air_evaluator(stark):
    """Device AIR evaluator bound to a FastStark instance: the round
    constant codewords C1_i(x), C2_i(x) are cached, so each proof pays only
    the ~20-multiply kernel above.  Its ``rescue_tables`` (those of
    ``rescue_air_tables``) send FastStark.prove to H10, which computes the
    quotients with this AIR in one launch."""
    c1_lde, c2_lde, mds, mds_inv = rescue_air_tables(stark)
    x_lde = stark._interp_tables()["x_lde"]

    def evaluator(x_lde_arg, current, next_):
        # a sharded prover calls this per shard: take the tables' shards
        c1, c2 = shard_parts(x_lde_arg, x_lde, c1_lde, c2_lde)
        return _rescue_air_kernel(current, next_, c1, c2, mds, mds_inv)

    evaluator.rescue_tables = (c1_lde, c2_lde, mds, mds_inv)
    return evaluator


def make_index_air_evaluator(stark):
    """Device AIR evaluator for the BATCHED VERIFIER: query points are
    FRI-domain positions, so the cached round-constant codewords serve the
    constants by a gather at the query indices."""
    c1_lde, c2_lde, mds, mds_inv = rescue_air_tables(stark)
    c1_lde, c2_lde = (t.gather() if isinstance(t, Sharded) else t for t in (c1_lde, c2_lde))

    def evaluator(idx, current, next_):
        c1_pts = c1_lde.index_select(-1, idx)
        c2_pts = c2_lde.index_select(-1, idx)
        return _rescue_air_kernel(current, next_, c1_pts, c2_pts, mds, mds_inv)

    # FastStark.verify takes H12 for an evaluator that carries these
    evaluator.rescue_tables = (c1_lde, c2_lde, mds, mds_inv)
    return evaluator
