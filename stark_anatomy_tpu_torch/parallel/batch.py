"""The batched prover core: the device half of FastStark.prove over a
batch of independent witnesses, as functions of tensors.

The port of stark_anatomy_tpu/parallel/batch.py.  ``pipeline`` runs trace
generation, prefix interpolation and LDE, boundary quotients, the Rescue
AIR, transition quotients and the randomizer LDE for a whole batch of
proofs; ``combination`` weights its codewords into FRI's input.  Between
the two lie the host's Fiat-Shamir commitments, which draw the weights:
``BatchProver.prove_batch`` calls the two on either side of them, and
``build_prover_core`` chains them into one function (``entry.py`` returns
it with example arguments).  On the card they launch H2 (the trace), H3
(the transforms), H0 (the LDE's scales), H10 (the boundary and transition
quotients, the next cycle read in place of a rolled copy) and H11 (the
combination).
"""

from __future__ import annotations

import torch

from ..field import kernels as K
from ..models import rescue_prime as RP
from ..ops import ntt as NTT
from ..protocols.fast_stark import FastStark


def pipeline(stark: FastStark, air_constants, sk_batch, randomizer_cols, rand_poly,
             inv_bz, interp, inv_tz):
    """Returns (bq_lde, tq_lde, rand_lde): the boundary quotients (B, R,
    NLIMBS, N), the transition quotients (B, C, NLIMBS, N) and the
    randomizer codeword (B, NLIMBS, N).

    Limb-first layout throughout (field/ops.py), on the stark's device:
    air_constants:   rescue_air_tables(stark)
    sk_batch:        (NLIMBS, B) Montgomery-form secret keys
    randomizer_cols: (B, R, NLIMBS, num_randomizers) random trace rows
    rand_poly:       (B, NLIMBS, max_degree+1) randomizer polynomial coeffs
    inv_bz, interp:  (R, NLIMBS, N) or (B, R, NLIMBS, N) boundary tables
    inv_tz:          (NLIMBS, N) inverse transition zerofier codeword"""
    # trace: (n_cycles, m, L, B) -> columns (B, m, L, n_cycles)
    traces = RP.trace_batch(sk_batch)
    cols = torch.cat([traces.permute(3, 1, 2, 0), randomizer_cols], dim=-1)

    trace_lde = stark._trace_lde(cols)                        # (B, R, L, N)
    # (B, R, L, N) and (B, C, L, N); the next cycle is E points on
    bq_lde, tq_lde = K.rescue_quotients(trace_lde, interp, inv_bz, inv_tz, air_constants,
                                        stark.expansion_factor)
    rand_lde = NTT.coset_evaluate(rand_poly, stark.generator.value, stark.fri_domain_length)
    return bq_lde, tq_lde, rand_lde


def combination(bq_lde, tq_lde, rand_lde, weights, tq_shift_pows, bq_shift_pows):
    """The combination codeword (B, NLIMBS, N), FRI's input: all W terms in
    the transcript's weight order (randomizer, then per constraint [tq,
    shifted tq], then per register [bq, shifted bq]).

    weights:      (W, NLIMBS, 1) shared, or (B, W, NLIMBS, 1) per proof
    *_shift_pows: (C, NLIMBS, N) and (R, NLIMBS, N) x^shift codewords
    One launch of H11 (field/kernels.py:combination)."""
    return K.combination(rand_lde, tq_lde, bq_lde, tq_shift_pows, bq_shift_pows, weights)


def build_prover_core(stark: FastStark, air_constants):
    """Returns fn(sk_batch, randomizer_cols, rand_poly, weights, inv_bz,
    interp, inv_tz, tq_shift_pows, bq_shift_pows) -> (combo, bq_lde,
    rand_lde): ``pipeline`` followed by ``combination`` with the weights
    given, so the combination codeword (B, NLIMBS, N) and the committed
    codewords bq_lde (B, R, NLIMBS, N) and rand_lde (B, NLIMBS, N)."""

    def core(sk_batch, randomizer_cols, rand_poly, weights, inv_bz, interp,
             inv_tz, tq_shift_pows, bq_shift_pows):
        bq_lde, tq_lde, rand_lde = pipeline(
            stark, air_constants, sk_batch, randomizer_cols, rand_poly, inv_bz, interp, inv_tz
        )
        combo = combination(bq_lde, tq_lde, rand_lde, weights, tq_shift_pows, bq_shift_pows)
        return combo, bq_lde, rand_lde

    return core
