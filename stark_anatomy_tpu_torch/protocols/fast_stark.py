"""FastStark: the device-accelerated STARK prover.

The port of stark_anatomy_tpu/protocols/fast_stark.py.  Same transcript
structure as the JAX package (boundary-quotient roots, randomizer root,
Fiat-Shamir weights, FRI, quadrupled-index openings including the
preprocessed transition-zerofier section), hence the same proof bytes:

* trace interpolation over the length-n PREFIX of the omicron domain by
  the partial-fractions identity  f = Z_n * A / (x^M - 1)  with
  A = M * rot(intt(v / Z_n'(omega^i)));
* everything downstream evaluated POINTWISE on FRI-domain codewords:
  boundary quotients, the AIR (a model's device evaluator), transition
  quotients, degree-adjustment shifts and the weighted combination.

All field arithmetic goes through field/ops.py, so on the card it runs in
the hand-written kernels.  Both branches of the tables are ported: host
coefficients for traces up to HOST_ZEROFIER_MAX rows, and for longer ones
the rolling zerofier (ops/ntt.py:prefix_zerofier_evals) with no
coefficient form at all.  ``prove`` takes host rows or device trace
columns (``trace_columns``, models/mimc.py), draws the randomizer
polynomial per element on the host or, above
``bulk_randomizer_threshold`` coefficients, expands it on the card from
one seed (utils/rand.py, H5), commits on the host by N1 or on the card by
H4 (commit/device_merkle.py:use_device_commit), and runs FRI on the card
(protocols/fri.py:Fri.prove, H6 and H4) where the device commit is taken,
else on the host; the generic AIR compiler ``compile_air`` serves where no
model evaluator is given.  Where the evaluator is Rescue's (it carries
``rescue_tables``), the boundary and transition quotients are one launch
of H10, and the batched verifier's whole recomputation one of H12; the
combination is one launch of H11 for every AIR (field/kernels.py).
``verify`` has the batched device check, and ``timer`` the per-phase
seconds.  The LDE is one N-point coset transform
(ops/ntt.py, four-step above NTT_MAX points): the JAX package's
blocked-coset LDE computes the same values as E transforms of M points,
which only spared XLA compiles.  ``prove`` reaches its codewords through
hooks (``_place_codeword``, ``_lde``, ``_intt``, ``_pointwise``,
``_roll_left``, ``_next_rows``, ``_x_lde_pows``, ``_commit_rows``, ``_fri``, ...): here
each is the one-device operation, and parallel/sharded_stark.py
overrides them to shard the codeword axis.
"""

from __future__ import annotations

import os
from functools import reduce
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..commit.device_merkle import device_commit_paired, device_commit_paired_many, use_device_commit
from ..commit.merkle import MerkleTree, MultiproofWalk, verify_multi
from ..errors import MalformedProof, VerificationError, rejects_malformed
from ..field import kernels as K
from ..field import ops as F
from ..field.limbs import NLIMBS
from ..field.scalar import FieldElement, P
from ..ops import ntt as NTT
from ..ops.domain import DOMAINS, mont_const
from ..poly.host_ntt import host_zerofier
from ..poly.multivariate import MPolynomial
from ..transcript import codec
from ..transcript.proof_stream import ProofStream, push_runs
from ..utils.convert import canonical_np, device_from_ints, gather_limbs, ints_from_device
from ..utils.profiling import PhaseTimer, device_sync
from ..utils.rand import bulk_random_mont
from .stark import Boundary, StarkParams, opened_section


class TransitionZerofier:
    """Preprocessing artifact (reference: fast_stark.py:36-40) extended with
    the cached inverse codeword and Merkle tree."""

    def __init__(self, codeword, rows, inv_codeword, tree):
        self.codeword = codeword              # (L, N_fri) Montgomery, or None
        self.rows = rows                      # canonical (N_fri, L) numpy rows, or DeviceRows
        self.inv_codeword = inv_codeword      # (L, N_fri) Montgomery
        self.tree = tree                      # MerkleTree or DeviceMerkleTree

    @property
    def root(self) -> bytes:
        return self.tree.root


class FastStark(StarkParams):
    # randomizer-polynomial sampling crossover: above this many coefficients
    # prove() switches from per-element host sampling to one seed expanded
    # on the device (utils/rand.py).  The switch changes the randomness
    # source, so proof bytes differ across it for a fixed urandom stream;
    # tests lower it to cover the bulk branch (the JAX package's knob)
    bulk_randomizer_threshold: int = 4096

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._interp_cache = None
        self._bz_cache: Dict[tuple, tuple] = {}
        self._bz_shared: Dict[tuple, torch.Tensor] = {}
        self._xpow_cache: Dict[int, torch.Tensor] = {}
        self._x_lde_arr = None
        self._air_fn_cache: Dict[tuple, object] = {}
        # per-phase wall-clock seconds under the JAX package's phase names,
        # and the parts of fri and trace_gen; read ``self.timer.report()``
        # after prove (utils/profiling.py)
        self.timer = PhaseTimer()

    # ------------------------------------------------------------------
    # preprocessing
    # ------------------------------------------------------------------
    def preprocess(self) -> TransitionZerofier:
        """Commit to the transition zerofier Z(x) = prod_{i<T-1}(x - omicron^i):
        its FRI-domain codeword (small traces: host coefficients and one
        coset LDE; large ones: the rolling evaluation on the domain, with
        no coefficients), a paired-leaf commitment and the inverse
        codeword.  Both branches give the same values."""
        count = self.original_trace_length - 1
        if count <= NTT.HOST_ZEROFIER_MAX:
            pts = [e.value for e in self.omicron_powers(count)]
            coeffs = device_from_ints(host_zerofier(pts), self.device)
            codeword = self._lde(coeffs, self.generator.value, self.fri_domain_length)
        else:
            # the rolling evaluation runs over the whole domain (its rolls
            # cross shards), then the codeword is placed
            codeword = self._place_codeword(NTT.prefix_zerofier_evals(
                self._x_lde(), self.omicron.value, self.expansion_factor, count
            ))
        rows, tree = self._commit_rows(codeword)
        # the codeword itself is not kept: the prover divides by the inverse
        # and opens through rows and tree (512 MiB less at N = 2^24)
        return TransitionZerofier(None, rows, self._pointwise(F.batch_inv, codeword), tree)

    def _x_lde(self) -> torch.Tensor:
        """Cached FRI-domain codeword of x itself: g * omega_N^j."""
        if self._x_lde_arr is None:
            N = self.fri_domain_length
            self._x_lde_arr = F.mont_mul(
                DOMAINS.get(N, self.device)["fwd_powers"],
                mont_const(self.generator.value, self.device),
            )
        return self._x_lde_arr

    # ------------------------------------------------------------------
    # cached per-instance device tables
    # ------------------------------------------------------------------
    def _interp_tables(self):
        """Tables for prefix-domain interpolation + LDE (see module doc)."""
        if self._interp_cache is not None:
            return self._interp_cache
        n = self.randomized_trace_length
        M = self.omicron_domain_length
        N = self.fri_domain_length
        g = self.generator.value
        w = self.omicron.value
        E = self.expansion_factor
        dev = self.device
        x_lde = self._x_lde()

        if n <= NTT.HOST_ZEROFIER_MAX:
            # Z_n from host coefficients; Z_n' via the coefficient derivative
            # (k+1) * z_{k+1} evaluated with one length-M NTT
            pts = [e.value for e in self.omicron_powers(n)]
            zn = device_from_ints(host_zerofier(pts), dev)       # (L, n+1)
            kplus1 = np.arange(1, zn.shape[-1], dtype=np.int64)
            k_limbs = np.zeros((NLIMBS, len(kplus1)), dtype=np.int32)
            k_limbs[0] = kplus1 & 0xFFFF
            k_limbs[1] = kplus1 >> 16
            k_mont = F.to_mont(torch.from_numpy(k_limbs).to(dev))
            dz = F.mont_mul(zn[..., 1:], k_mont)                  # (L, n)
            dz_evals = NTT.ntt(NTT._pad_coeffs(dz, M))            # (L, M)
            inv_dz = F.batch_inv(dz_evals[..., :n])               # (L, n)
            zn_fri = NTT.coset_evaluate(zn, g, N)                 # (L, N)
        else:
            # no coefficient form of Z_n: its FRI-domain codeword by the
            # rolling evaluation, and 1/Z_n'(w^i) from the suffix zerofier
            # S = prod_{j>=n}(x - w^j): Z_n * S = x^M - 1, so at the prefix
            # roots 1/Z_n'(w^i) = S(w^i) * w^i / M
            zn_fri = NTT.prefix_zerofier_evals(x_lde, w, E, n)   # (L, N)
            m_tab = DOMAINS.get(M, dev)["fwd_powers"]             # w^i
            if M == n:
                # Z_n = x^M - 1, so 1/Z_n'(w^i) = w^i / M
                inv_dz = F.mont_mul(m_tab, mont_const(pow(M, P - 2, P), dev))
            else:
                suffix = NTT.prefix_zerofier_evals(m_tab, w, 1, M - n)
                # S(w^i) = w^(n(M-n)) * S0(w^(i-n)), and for i < n the
                # wrapped index i - n + M is among the last n entries of S0
                const = pow(w, n * (M - n), P) * pow(M, P - 2, P) % P
                inv_dz = F.mont_mul(
                    F.mont_mul(suffix[..., M - n:], m_tab[..., :n]), mont_const(const, dev)
                )                                                 # (L, n)

        # 1 / ((g*omega_N^j)^M - 1) has period E: E host inversions, tiled
        zeta = pow(self.omega.value, M, P)
        gM = pow(g, M, P)
        vals = [pow(gM * pow(zeta, j, P) % P - 1, P - 2, P) for j in range(E)]
        inv_xm = device_from_ints(vals, dev).repeat(1, N // E)

        self._interp_cache = {
            "inv_dz": inv_dz,
            # _trace_lde multiplies by Z_n(x) and 1/(x^M - 1) back to back
            "zn_over_xm": F.mont_mul(zn_fri, inv_xm),
            "x_lde": x_lde,
            "m_const": mont_const(M, dev),
        }
        return self._interp_cache

    # -- hooks of the sharded prover (parallel/sharded_stark.py overrides
    # them; here each is the one-device operation) -------------------------
    def _place_codeword(self, arr: torch.Tensor):
        """Placement of a codeword-axis array (the sharded prover shards it)."""
        return arr

    def _lde(self, coeffs, offset: int, order: int):
        """Evaluation of coefficients on the coset offset * <omega_order>."""
        return NTT.coset_evaluate(coeffs, offset, order)

    def _intt(self, values):
        """The inverse NTT (the sharded prover's is distributed)."""
        return NTT.intt(values)

    def _pointwise(self, fn, *args):
        """``fn`` over codewords whose every element depends on the inputs
        at its own position (the sharded prover runs it shard by shard)."""
        return fn(*args)

    def _roll_left(self, x, k: int):
        """The codeword rolled left by k: element i + k at i."""
        return torch.roll(x, -k, dims=-1)

    def _next_rows(self, trace_lde, k: int):
        """(next rows, shift) for H10: the trace's next cycle is element
        i + k, read in place (the sharded prover's rows cross shards, so it
        rolls them and reads at shift 0)."""
        return None, k

    def _x_lde_pows(self, exponents) -> torch.Tensor:
        """The stacked codewords of x^e for each exponent (one exponent: a
        view of the cached codeword, no copy)."""
        if len(exponents) == 1:
            return self._x_lde_pow(exponents[0]).unsqueeze(0)
        return torch.stack([self._x_lde_pow(e) for e in exponents])

    def _draw(self, urandom, count: int, size: int) -> List[bytes]:
        """``count`` draws of ``size`` bytes, in order."""
        return [urandom(size) for _ in range(count)]

    def _fri(self, combo, proof_stream: ProofStream) -> List[int]:
        """FRI over the combination codeword: on the card where its
        commitment is (the JAX package's fused fold and commit), else on
        the host; the transcripts are byte-identical.  The device prover
        times its parts on ``self.timer`` as it is at the call (a caller
        may have replaced the timer since construction)."""
        if use_device_commit(self.fri_domain_length, combo.device):
            return self.fri.prove(combo, proof_stream, self.timer)
        return self.fri.prove_host(ints_from_device(combo), proof_stream)

    def _sync(self) -> None:
        """Wait for the prover's device(s): a phase ends in its launches."""
        device_sync(self.device)

    def _merkle_from_canon(self, canon) -> MerkleTree:
        """Commitment hook: the paired-leaf tree over canonical host rows."""
        return MerkleTree.from_limbs_paired(canon)

    def _commit_rows(self, codeword: torch.Tensor):
        """Commit one (L, N) codeword.  Returns (rows, tree): rows is a
        canonical opening-value accessor.  On the card at
        DEVICE_COMMIT_MIN elements or more (or when STARK_TPU_DEVICE_HASH
        forces it) the tree is built where the codeword lies, by H4, and
        only the root is copied; else the canonical rows are copied to the
        host and hashed by N1.  Both give the same bytes."""
        if use_device_commit(codeword.shape[-1], codeword.device):
            return device_commit_paired(codeword)
        canon = canonical_np(codeword)
        return canon, self._merkle_from_canon(canon)

    def _commit_rows_many(self, codewords: torch.Tensor):
        """Commit R stacked codewords (R, L, N): on the card, one set of H4
        launches and one root copy for all R; on the host, one copy of the
        canonical rows for all R."""
        R = codewords.shape[0]
        if R == 1:
            return [self._commit_rows(codewords[0])]
        if use_device_commit(codewords.shape[-1], codewords.device):
            return device_commit_paired_many(codewords)
        canon = canonical_np(codewords)                           # (R, N, L)
        return [(canon[s], self._merkle_from_canon(canon[s])) for s in range(R)]

    def _compiled_air(self, transition_constraints):
        """The generic pointwise AIR evaluator, cached by the constraints'
        content, so repeated proofs reuse one evaluator."""
        key = tuple(
            tuple(sorted((k, c.value) for k, c in tc.dictionary.items()))
            for tc in transition_constraints
        )
        if key not in self._air_fn_cache:
            self._air_fn_cache[key] = compile_air(transition_constraints)
        return self._air_fn_cache[key]

    def _trace_lde(self, columns: torch.Tensor) -> torch.Tensor:
        """(..., R, L, n) trace columns -> (..., R, L, N_fri) LDE; the trace
        polynomial is never materialized in coefficient form."""
        t = self._interp_tables()
        M = self.omicron_domain_length
        N = self.fri_domain_length
        c = F.mont_mul(columns, t["inv_dz"])                     # v_i / Z'(w^i)
        c = self._place_codeword(NTT._pad_coeffs(c, M))           # zeros beyond n
        e = self._intt(c)
        a = self._pointwise(F.mont_mul, self._roll_left(e, 1), t["m_const"])  # A = M * rot(e)
        a_lde = self._lde(a, self.generator.value, N)             # (..., R, L, N)
        return self._pointwise(F.mont_mul, a_lde, t["zn_over_xm"])

    def _x_lde_pow(self, e: int) -> torch.Tensor:
        """Codeword of x^e on the FRI coset, closed form:
        (g*omega^j)^e = g^e * omega^(j*e mod N), one gather from the domain
        power table; cached per exponent (an entry is 512 MiB at N = 2^24)."""
        e = int(e)
        if e in self._xpow_cache:
            return self._xpow_cache[e]
        N = self.fri_domain_length
        tab = DOMAINS.get(N, self.device)["fwd_powers"]
        idx = (torch.arange(N, device=self.device) * (e % N)) & (N - 1)
        out = F.mont_mul(
            tab.index_select(-1, idx),
            mont_const(pow(self.generator.value, e, P), self.device),
        )
        self._xpow_cache[e] = out
        return out

    def _boundary_tables(self, boundary: Boundary):
        """FRI-domain codewords of the boundary zerofiers (inverted) and
        interpolants, cached by boundary values (two entries at most)."""
        key = tuple(sorted((c, r, v.value) for c, r, v in boundary))
        if key in self._bz_cache:
            return self._bz_cache[key]
        while len(self._bz_cache) >= 2:
            self._bz_cache.pop(next(iter(self._bz_cache)))
        t = self._interp_tables()
        out = self._pointwise(
            _boundary_tables_core,
            self._stack_coeffs(self.boundary_zerofiers(boundary)),
            self._stack_coeffs(self.boundary_interpolants(boundary)),
            t["x_lde"],
        )
        self._bz_cache[key] = out
        return out

    def _boundary_tables_batch(self, boundaries: Sequence[Boundary]):
        """The boundary tables of a batch of statements of one AIR, whose
        boundaries constrain the same (cycle, register) points with values
        of their own: the inverted zerofier codewords (R, L, N), which
        depend on the points alone and are shared by the batch (cached),
        and the interpolant codewords (B, R, L, N), all evaluated in one
        pass.  Element for element ``_boundary_tables`` of each."""
        points = {tuple(sorted((c, r) for c, r, _ in b)) for b in boundaries}
        assert len(points) == 1, "a batch's boundaries constrain the same points"
        key = points.pop()
        if key not in self._bz_shared:
            self._bz_shared[key] = self._pointwise(
                _inverse_evaluations,
                self._stack_coeffs(self.boundary_zerofiers(boundaries[0])),
                self._interp_tables()["x_lde"],
            )
        R = self.num_registers
        interps = [p for b in boundaries for p in self.boundary_interpolants(b)]
        coeffs = self._stack_coeffs(interps)
        interp = self._pointwise(
            NTT.evaluate_domain_horner,
            coeffs.reshape((len(boundaries), R) + tuple(coeffs.shape[1:])),
            self._interp_tables()["x_lde"],
        )
        return self._bz_shared[key], interp

    def _stack_coeffs(self, polys) -> torch.Tensor:
        """Host polynomials -> (len(polys), L, deg) zero-padded coefficient
        tensor, in one copy to the device."""
        deg = max(max(len(p.coefficients) for p in polys), 1)
        values = [c.value for p in polys for c in p.coefficients + [self.field.zero()] * (deg - len(p.coefficients))]
        limbs = device_from_ints(values, self.device).reshape(NLIMBS, len(polys), deg)
        return limbs.permute(1, 0, 2).contiguous()

    # ------------------------------------------------------------------
    # prover
    # ------------------------------------------------------------------
    def prove(
        self,
        trace: List[List[FieldElement]],
        transition_constraints: Sequence[MPolynomial],
        boundary: Boundary,
        transition_zerofier: TransitionZerofier,
        proof_stream: Optional[ProofStream] = None,
        air_evaluator=None,
        trace_columns: Optional[torch.Tensor] = None,
        urandom=os.urandom,
    ) -> bytes:
        """Generate a proof.  ``air_evaluator``, if given, is a device
        function (x_lde, current, next_) -> (C, L, N) evaluating the
        transition constraints pointwise; otherwise the symbolic
        constraints are compiled generically (``compile_air``).  The trace
        comes as host rows (``trace``) or as ``trace_columns``, an (R, L,
        n_cycles) Montgomery tensor on the prover's device from a device
        trace generator (models/mimc.py).  Randomness is drawn from
        ``urandom`` in the JAX package's order, so a seeded run gives the
        same bytes.  Each step adds its seconds to ``self.timer`` under
        the JAX package's phase names; a phase that ends in launches waits
        for the card."""
        if proof_stream is None:
            proof_stream = ProofStream()
        R = self.num_registers
        N = self.fri_domain_length
        dev = self.device
        t = self._interp_tables()
        timer = self.timer

        # randomized trace columns: (R, L, n)
        draws = self._draw(urandom, self.num_randomizers * R, 17)
        rand_rows = [
            [self.field.sample(draws[i * R + s]).value for s in range(R)]
            for i in range(self.num_randomizers)
        ]
        if trace_columns is not None:
            rand_cols = torch.stack(
                [device_from_ints([row[s] for row in rand_rows], dev) for s in range(R)]
            )
            columns = torch.cat([trace_columns, rand_cols], dim=-1)
            n_rows = trace_columns.shape[-1] + self.num_randomizers
        else:
            rows = [[v.value for v in row] for row in trace] + rand_rows
            columns = torch.stack(
                [device_from_ints([rows[c][s] for c in range(len(rows))], dev) for s in range(R)]
            )
            n_rows = len(rows)

        with timer.phase("trace_lde"):
            trace_lde = self._trace_lde(columns)                 # (R, L, N)
            self._sync()

        # boundary quotients, committed; with the Rescue AIR's evaluator the
        # transition quotients come from the same launch (H10), the trace's
        # next cycle read in place
        rescue = getattr(air_evaluator, "rescue_tables", None)
        with timer.phase("boundary_quotients"):
            inv_bz, interp = self._boundary_tables(boundary)
            if rescue is not None:
                bq_lde, tq_lde = self._pointwise(                          # (R, L, N), (C, L, N)
                    _rescue_quotients_core, trace_lde, *self._next_rows(trace_lde, self.expansion_factor),
                    interp, inv_bz, transition_zerofier.inv_codeword, *rescue)
            else:
                bq_lde = self._pointwise(_bq_core, trace_lde, interp, inv_bz)   # (R, L, N)
            self._sync()
        with timer.phase("commit_bq"):
            bq_trees = []
            bq_rows = []
            for rows_s, tree in self._commit_rows_many(bq_lde):
                bq_rows.append(rows_s)
                bq_trees.append(tree)
                proof_stream.push(tree.root)

        # transition quotients: pointwise AIR / zerofier
        with timer.phase("air_quotients"):
            if rescue is None:
                if air_evaluator is None:
                    air_evaluator = self._compiled_air(transition_constraints)
                next_lde = self._roll_left(trace_lde, self.expansion_factor)
                tq_lde = self._pointwise(_air_quotient_core, air_evaluator, t["x_lde"], trace_lde,
                                         next_lde, transition_zerofier.inv_codeword)
                del next_lde
            # nothing downstream reads the trace LDE (512 MiB a register at
            # N = 2^24)
            del trace_lde
            self._sync()

        # randomizer polynomial
        max_degree = self.max_degree(transition_constraints)
        with timer.phase("randomizer_poly"):
            if max_degree + 1 > self.bulk_randomizer_threshold:
                # one seed expanded on the card (H5): per-element host draws
                # would take minutes at 2^22 coefficients
                rand_poly = bulk_random_mont(max_degree + 1, dev,
                                             lambda size: self._draw(urandom, 1, size)[0])
            else:
                rand_coeffs = [self.field.sample(b).value
                               for b in self._draw(urandom, max_degree + 1, 17)]
                rand_poly = device_from_ints(rand_coeffs, dev)
            rand_lde = self._lde(rand_poly, self.generator.value, N)
            del rand_poly
            self._sync()
        with timer.phase("commit_randomizer"):
            rand_rows, rand_tree = self._commit_rows(rand_lde)
            proof_stream.push(rand_tree.root)

        # Fiat-Shamir weights
        weights = self.sample_weights(
            1 + 2 * len(transition_constraints) + 2 * R, proof_stream.prover_fiat_shamir()
        )

        # weighted combination, pointwise: w_a*q + w_b*x^s*q = q*(w_a + w_b*x^s)
        with timer.phase("combination"):
            tq_bounds = self.transition_quotient_degree_bounds(transition_constraints)
            bq_bounds = self.boundary_quotient_degree_bounds(n_rows, boundary)
            tq_shift = self._x_lde_pows([max_degree - b for b in tq_bounds])
            bq_shift = self._x_lde_pows([max_degree - b for b in bq_bounds])
            w_dev = torch.stack([mont_const(wv.value, dev) for wv in weights])
            combo = self._pointwise(K.combination, rand_lde, tq_lde, bq_lde, tq_shift, bq_shift, w_dev)
            del tq_shift, bq_shift, tq_lde, bq_lde, rand_lde
            self._sync()

        # FRI over the combination codeword
        with timer.phase("fri"):
            indices = self._fri(combo, proof_stream)
            del combo

        with timer.phase("openings"):
            opened = list(zip(bq_rows, bq_trees)) + [
                (rand_rows, rand_tree), (transition_zerofier.rows, transition_zerofier.tree)]
            self.open_linked([proof_stream], [indices], opened)
        return proof_stream.serialize()

    def open_linked(self, proof_streams: Sequence[ProofStream], top, opened: Sequence) -> None:
        """The linked openings of B proofs at once, B = 1 for ``prove``
        (reference: fast_stark.py:154-177): per opened tree, the values at
        the quadrupled index set and one multiproof over the paired leaves
        of the duplicated set.  ``top`` (B, T) holds each proof's FRI
        top-level indices; ``opened`` each tree's (rows, tree) in the
        transcript's order, as FRI's ``queries`` takes a layer (stacked
        ones give proof b its own).  The index sets are (B, ...) arrays
        formed once, one walk serves every tree, and a tree's values are
        one gather."""
        N = self.fri_domain_length
        top = np.asarray(top, dtype=np.int64)
        duplicated = np.concatenate([top, (top + self.expansion_factor) % N], axis=1)
        quadrupled = np.sort(np.concatenate([duplicated, (duplicated + N // 2) % N], axis=1), axis=1)
        walk = MultiproofWalk(duplicated % (N // 2), N // 2)
        push_runs(proof_streams, [
            (codec.encode_felt_lists(gather_limbs(rows, quadrupled))[:, None],)
            + codec.encode_bytes_lists(walk.digests(tree), walk.counts)
            for rows, tree in opened
        ])

    # ------------------------------------------------------------------
    # verifier (host scalar; mirrors reference fast_stark.py:180-286)
    # ------------------------------------------------------------------
    @rejects_malformed
    def verify(
        self,
        proof: bytes,
        transition_constraints: Sequence[MPolynomial],
        boundary: Boundary,
        transition_zerofier_root: bytes,
        proof_stream_factory=None,
        air_point_evaluator=None,
        air_index_evaluator=None,
    ) -> bool:
        """Verify a proof.  ``air_point_evaluator``, if given, is a scalar
        function (x, current_trace, next_trace) -> constraint values used
        in place of the symbolic ``MPolynomial.evaluate`` — models whose
        constraints factor (e.g. Rescue's lhs - rhs**3,
        models/rescue_prime.py:make_point_air) evaluate orders of magnitude
        faster than their expanded monomial form.  The seconds go to
        ``self.timer`` as it is at the call: the phase ``verify`` and its
        parts ``verify.decode`` (the transcript's objects), ``verify.fri``,
        ``verify.openings`` (the R + 2 opened sections, their leaves and
        multiproofs) and ``verify.core`` (the combination at every query
        point); each closes on a rejection too."""
        timer = self.timer
        with timer.phase("verify"):
            original_trace_length = 1 + max(c for c, r, v in boundary)
            randomized_trace_length = original_trace_length + self.num_randomizers

            with timer.phase("verify.decode"):
                if proof_stream_factory is None:
                    proof_stream = ProofStream.deserialize(proof)
                else:
                    proof_stream = proof_stream_factory(proof)

            R = self.num_registers
            boundary_quotient_roots = [proof_stream.pull_typed(bytes) for _ in range(R)]
            randomizer_root = proof_stream.pull_typed(bytes)

            weights = self.sample_weights(
                1 + 2 * len(transition_constraints) + 2 * R,
                proof_stream.verifier_fiat_shamir(),
            )

            polynomial_values: List[Tuple[int, int]] = []
            with timer.phase("verify.fri"):
                fri_accepts = self.fri.verify(proof_stream, polynomial_values)
            if not fri_accepts:
                raise VerificationError(f"FRI rejected: {self.fri.last_rejection}")
            polynomial_values.sort(key=lambda iv: iv[0])
            indices = [i for i, v in polynomial_values]
            values = [v for i, v in polynomial_values]

            with timer.phase("verify.openings"):
                N = self.fri.domain_length
                # `indices` already contains each test's a AND b positions (from
                # FRI's polynomial_values), so adding the +expansion shifts yields
                # exactly the prover's sorted `quadrupled` multiset
                duplicated = sorted(
                    indices + [(i + self.expansion_factor) % N for i in indices]
                )
                # paired leaves: leaf l covers positions l and l + N/2
                leaf_indices = sorted({i % (N // 2) for i in duplicated})

                depth = N.bit_length() - 2                    # paired tree: N/2 leaves

                from ..commit.hashing import hash_paired_leaf

                def pull_section(root, what: str) -> Dict[int, int]:
                    section = opened_section(duplicated, proof_stream.pull_typed(list), what)
                    proof = proof_stream.pull_typed(list)
                    ld = {
                        l: hash_paired_leaf(section[l], section[l + N // 2])
                        for l in leaf_indices
                    }
                    if not verify_multi(root, depth, ld, proof):
                        raise VerificationError(f"{what}: Merkle multiproof failed")
                    return section

                leafs: List[Dict[int, int]] = []
                for r in range(R):
                    leafs.append(
                        pull_section(boundary_quotient_roots[r], f"boundary quotient {r}")
                    )

                randomizer = pull_section(randomizer_root, "randomizer")
                zerofier_leafs = pull_section(transition_zerofier_root, "transition zerofier")

            with timer.phase("verify.core"):
                zerofiers = self.boundary_zerofiers(boundary)
                interpolants = self.boundary_interpolants(boundary)
                tq_bounds = self.transition_quotient_degree_bounds(transition_constraints)
                bq_bounds = self.boundary_quotient_degree_bounds(
                    randomized_trace_length, boundary
                )
                max_degree = self.max_degree(transition_constraints)

                if air_index_evaluator is not None:
                    bad = self._verify_combinations_batched(
                        indices, values, leafs, randomizer, zerofier_leafs, weights,
                        zerofiers, interpolants, tq_bounds, bq_bounds, max_degree,
                        air_index_evaluator,
                    )
                    if bad is not None:
                        raise VerificationError(
                            f"combination mismatch at query index {bad}"
                        )
                    if proof_stream.read_index != len(proof_stream.objects):
                        raise MalformedProof("trailing transcript objects")
                    return True

                for i in range(len(indices)):
                    current_index = indices[i]
                    domain_current = self.generator * (self.omega ** current_index)
                    next_index = (current_index + self.expansion_factor) % N
                    domain_next = self.generator * (self.omega ** next_index)

                    current_trace = []
                    next_trace = []
                    for s in range(R):
                        bq_cur = FieldElement(leafs[s][current_index], self.field)
                        bq_next = FieldElement(leafs[s][next_index], self.field)
                        current_trace.append(
                            bq_cur * zerofiers[s].evaluate(domain_current)
                            + interpolants[s].evaluate(domain_current)
                        )
                        next_trace.append(
                            bq_next * zerofiers[s].evaluate(domain_next)
                            + interpolants[s].evaluate(domain_next)
                        )

                    if air_point_evaluator is not None:
                        transition_values = air_point_evaluator(
                            domain_current, current_trace, next_trace
                        )
                    else:
                        point = [domain_current] + current_trace + next_trace
                        transition_values = [
                            tc.evaluate(point) for tc in transition_constraints
                        ]

                    terms: List[FieldElement] = [
                        FieldElement(randomizer[current_index], self.field)
                    ]
                    tz_value = FieldElement(zerofier_leafs[current_index], self.field)
                    for s in range(len(transition_values)):
                        quotient = transition_values[s] / tz_value
                        terms.append(quotient)
                        terms.append(quotient * (domain_current ** (max_degree - tq_bounds[s])))
                    for s in range(R):
                        bqv = FieldElement(leafs[s][current_index], self.field)
                        terms.append(bqv)
                        terms.append(bqv * (domain_current ** (max_degree - bq_bounds[s])))

                    combination = reduce(
                        lambda a, b: a + b,
                        [terms[j] * weights[j] for j in range(len(terms))],
                        self.field.zero(),
                    )
                    if combination.value != values[i]:
                        raise VerificationError(
                            f"combination mismatch at query index {current_index}"
                        )

                # anti-malleability: every transcript object must have been consumed
                # (trailing junk would give distinct valid encodings of one proof)
                if proof_stream.read_index != len(proof_stream.objects):
                    raise MalformedProof("trailing transcript objects")

                return True

    # ------------------------------------------------------------------
    # batched verifier core: all K query checks through the device
    # kernels instead of K iterations of host scalar field arithmetic
    # ------------------------------------------------------------------
    def _verify_combinations_batched(
        self, indices, claimed, leafs, randomizer, zerofier_leafs, weights,
        zerofiers, interpolants, tq_bounds, bq_bounds, max_degree,
        air_index_evaluator,
    ) -> Optional[int]:
        """Returns the first mismatching query index, or None if all K
        combination values check out."""
        R = self.num_registers
        N = self.fri.domain_length
        count = len(indices)
        dev = self.device
        next_indices = [(i + self.expansion_factor) % N for i in indices]

        # ONE upload: every opened value + the query points, concatenated
        flat: List[int] = []
        for s in range(R):
            flat.extend(leafs[s][i] for i in indices)
            flat.extend(leafs[s][i] for i in next_indices)
        flat.extend(randomizer[i] for i in indices)
        flat.extend(zerofier_leafs[i] for i in indices)
        g, w = self.generator.value, self.omega.value
        flat.extend(g * pow(w, i, P) % P for i in indices)
        flat.extend(g * pow(w, i, P) % P for i in next_indices)
        vals = device_from_ints(flat, dev)                        # (L, (2R+4) count)

        w_dev = torch.stack([mont_const(wv.value, dev) for wv in weights])
        tq_sh = tuple(max_degree - b for b in tq_bounds)
        bq_sh = tuple(max_degree - b for b in bq_bounds)
        idx_dev = torch.tensor(indices, dtype=torch.int64, device=dev)

        bz, ip = self._stack_coeffs(zerofiers), self._stack_coeffs(interpolants)
        rescue = getattr(air_index_evaluator, "rescue_tables", None)
        if rescue is not None:
            # the Rescue AIR's whole recomputation in one launch (H12)
            combo = K.verify_core(vals, bz, ip, w_dev, idx_dev, rescue, tq_sh, bq_sh)
        else:
            combo = _verify_core(vals, bz, ip, w_dev, idx_dev, air_index_evaluator, R, count, tq_sh, bq_sh)
        got = ints_from_device(combo)
        for i in range(count):
            if got[i] != claimed[i]:
                return indices[i]
        return None


def _verify_core(vals, bz, ip, weights, idx, air_index_evaluator, R, K, tq_sh, bq_sh):
    """Batched combination recomputation at K query points.

    vals: (L, (2R+4)K) Montgomery: per register K current + K next
    boundary-quotient openings, then K randomizer, K zerofier openings,
    K current points, K next points.
    """
    parts = [vals[..., i * K : (i + 1) * K] for i in range(2 * R + 4)]
    bq_cur = torch.stack(parts[0:2 * R:2])                    # (R, L, K)
    bq_next = torch.stack(parts[1:2 * R:2])
    rand_cur = parts[2 * R]
    tz_cur = parts[2 * R + 1]
    x_cur = parts[2 * R + 2].contiguous()
    x_next = parts[2 * R + 3].contiguous()

    # coeffs (R, L, D) at points (L, K) -> (R, L, K)
    poly_eval = NTT.evaluate_domain_horner
    cur_trace = F.add(F.mont_mul(bq_cur, poly_eval(bz, x_cur)), poly_eval(ip, x_cur))
    next_trace = F.add(F.mont_mul(bq_next, poly_eval(bz, x_next)), poly_eval(ip, x_next))
    constraints = air_index_evaluator(idx, cur_trace, next_trace)  # (C, L, K)
    tq = F.mont_mul(constraints, F.batch_inv(tz_cur))

    terms = [rand_cur]
    for s, e in enumerate(tq_sh):
        terms.append(tq[s])
        terms.append(F.mont_mul(tq[s], F.mont_pow(x_cur, e)))
    for s, e in enumerate(bq_sh):
        terms.append(bq_cur[s])
        terms.append(F.mont_mul(bq_cur[s], F.mont_pow(x_cur, e)))
    return F.weighted_sum(torch.stack(terms), weights)


def _boundary_tables_core(bz: torch.Tensor, ip: torch.Tensor, x_lde: torch.Tensor):
    """(R, L, D) boundary zerofier/interpolant coefficients -> their
    (R, L, N) FRI-domain codewords (zerofiers inverted)."""
    return (
        F.batch_inv(NTT.evaluate_domain_horner(bz, x_lde)),
        NTT.evaluate_domain_horner(ip, x_lde),
    )


def _inverse_evaluations(coeffs: torch.Tensor, x_lde: torch.Tensor):
    """(..., L, D) coefficients -> the inverses of their (..., L, N)
    FRI-domain codewords."""
    return F.batch_inv(NTT.evaluate_domain_horner(coeffs, x_lde))


def _bq_core(trace_lde, interp, inv_bz):
    """Boundary quotients: (trace - interpolant) / zerofier, pointwise."""
    return F.mont_mul(F.sub(trace_lde, interp), inv_bz)


def _rescue_quotients_core(trace_lde, next_lde, shift, interp, inv_bz, inv_tz, c1, c2, mds, mds_inv):
    """H10 (field/kernels.py:rescue_quotients) as a pointwise function of
    its operands, so that a sharded prover runs it shard by shard."""
    return K.rescue_quotients(trace_lde, interp, inv_bz, inv_tz, (c1, c2, mds, mds_inv), shift, next_lde)


def _air_quotient_core(air_evaluator, x_lde, trace_lde, next_lde, inv_tz):
    """The AIR quotient: the constraints evaluated pointwise on the trace and
    its one-cycle shift (``next_lde``, the trace rolled by the expansion
    factor), divided by the transition zerofier."""
    return F.mont_mul(air_evaluator(x_lde, trace_lde, next_lde), inv_tz)


# ---------------------------------------------------------------------------
# generic pointwise AIR compiler
# ---------------------------------------------------------------------------

def compile_air(transition_constraints: Sequence[MPolynomial]):
    """Compile symbolic AIR constraints into a pointwise device evaluator
    (the port of stark_anatomy_tpu/protocols/fast_stark.py:compile_air).

    Returns fn(x_lde, current, next_) -> (C, L, N): for each constraint,
    the sum over its dictionary terms of coeff * prod(var_i ^ e_i), with
    per-variable power tables built by repeated products.  Models on the
    hot path supply a hand-written evaluator instead
    (models/rescue_prime.py); this is the generic fallback, the device
    analog of MPolynomial.evaluate.
    """

    def evaluator(x_lde, current, next_):
        R = current.shape[0]
        vars_ = [x_lde] + [current[s] for s in range(R)] + [next_[s] for s in range(R)]
        nvars = len(vars_)
        # max exponent per variable across all constraints
        max_exp = [0] * nvars
        for c in transition_constraints:
            for k in c.dictionary.keys():
                for vi, e in enumerate(k):
                    if vi < nvars:
                        max_exp[vi] = max(max_exp[vi], e)
        # power tables: powers[v][e] = vars_[v]^e
        powers = []
        for v in range(nvars):
            tab = [None, vars_[v]]
            for e in range(2, max_exp[v] + 1):
                tab.append(F.mont_mul(tab[-1], vars_[v]))
            powers.append(tab)

        outs = []
        for c in transition_constraints:
            acc = None
            for k, coeff in c.dictionary.items():
                term = mont_const(coeff.value, x_lde.device)     # (L, 1), broadcast
                for vi, e in enumerate(k):
                    if e > 0 and vi < nvars:
                        term = F.mont_mul(term, powers[vi][e])
                acc = term if acc is None else F.add(acc, term)
            if acc is None:
                acc = torch.zeros_like(x_lde)
            outs.append(acc.expand(x_lde.shape))
        return torch.stack(outs)

    return evaluator
