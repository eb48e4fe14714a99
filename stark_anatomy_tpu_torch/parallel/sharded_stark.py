"""ShardedFastStark: FastStark with the codeword axis sharded over a mesh.

The port of stark_anatomy_tpu/parallel/sharded_stark.py.  The prover's
heavy arrays (trace LDEs, quotient codewords, zerofier tables, the FRI
codeword and its fold layers) all lie on the FRI evaluation domain, and
this class holds each as a ``Sharded`` codeword over the mesh's sp axis
(parallel/mesh.py).  FastStark.prove is written against hooks, and this
class overrides them:

* ``_pointwise`` runs the pointwise kernels shard by shard, and
  ``_roll_left`` (the AIR's next row, which ``_next_rows`` hands to H10,
  and the interpolation's rotation) fetches a halo of the next shard;
* ``_intt`` and ``_lde`` run the distributed four-step NTT
  (parallel/ntt_dist.py; the LDE's coset scale rides its step 1) where
  S >= 2 and S^2 divides the length, the JAX package's rule, else the
  one-device transform on the gathered codeword; ``routes`` counts which
  ran, and step 1's route (H9, or glue above 8 shards);
* ``_commit_rows`` commits a forest (commit/device_merkle.py:
  commit_forest): the codeword's pair blocks Q_k = (c[k h : (k + 1) h],
  c[n/2 + k h : n/2 + (k + 1) h]), h = n / 2S, come together by one
  exchange, and each is one subtree (H4 on the card above
  DEVICE_COMMIT_MIN, N1 on the host below), with a host top tree;
* FRI runs on the pair blocks: H6 folds block k with its slice of the
  inverse-domain table into shard k of the next layer, whose pair
  blocks come by the next exchange and are committed where they lie (a
  device forest at every size, as one device's fused fold and commit),
  down to the last layer, whose pair blocks must hold an element each
  (a last layer of 2S elements or more).

Between the LDE and the commitment the whole codeword never exists as
one tensor, and every transcript byte is the one-device prover's: the
roots, openings and draws are the same values.  Under torch.distributed
the roots and openings are gathered to every rank and the draws come from
rank 0, so every rank returns the same proof.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List

import torch

from ..commit.device_merkle import commit_forest, use_device_commit
from ..commit.merkle import MerkleForest, MerkleTree
from ..field import kernels as K
from ..field import ops as F
from ..field.scalar import P
from ..ops import ntt as NTT
from ..ops.domain import DOMAINS, mont_const, power_table
from ..protocols.fast_stark import FastStark, TransitionZerofier
from ..transcript.proof_stream import ProofStream
from .mesh import Mesh, Sharded, pointwise
from .ntt_dist import dist_ntt_ok, make_distributed_ntt


class Paired:
    """A codeword of ``length`` elements held as its S pair blocks: block k
    (..., 8, length / S) holds [k h, (k + 1) h) and then [n/2 + k h, n/2 +
    (k + 1) h), h = length / 2S.  The layout of the forest's subtrees and
    of the sharded FRI's folds."""

    __slots__ = ("mesh", "blocks", "length")

    def __init__(self, mesh: Mesh, blocks: Dict[int, torch.Tensor], length: int):
        self.mesh = mesh
        self.blocks = blocks
        self.length = length

    @classmethod
    def of(cls, x: Sharded) -> "Paired":
        """The pair blocks of a sharded codeword (one exchange)."""
        n, S = x.length, x.num_shards
        h = n // (2 * S)
        assert h >= 1, f"a codeword of {n} elements has no pair blocks over {S} shards"
        blocks = x.redistribute(lambda k: [(k * h, (k + 1) * h), (n // 2 + k * h, n // 2 + (k + 1) * h)],
                                2 * h)
        return cls(x.mesh, blocks, n)

    @property
    def shape(self) -> tuple:
        return tuple(next(iter(self.blocks.values())).shape[:-1]) + (self.length,)

    @property
    def device(self) -> torch.device:
        return next(iter(self.blocks.values())).device

    def contiguous(self) -> "Paired":
        return self

    def gather(self) -> torch.Tensor:
        """The whole codeword in natural order (tests)."""
        S = self.mesh.shape["sp"]
        flat = Sharded(self.mesh, self.blocks, self.length).gather()     # blocks in order
        lead = flat.shape[:-1]
        return flat.view(lead + (S, 2, self.length // (2 * S))).transpose(-3, -2).reshape(
            lead + (self.length,))


class ShardedFastStark(FastStark):
    """FastStark whose codeword axis is sharded over ``mesh``'s ``axis``."""

    def __init__(self, *args, mesh: Mesh, axis: str = "sp", **kwargs):
        kwargs.setdefault("device", mesh.device)
        super().__init__(*args, **kwargs)
        assert axis == "sp", "the codeword axis is sharded over sp"
        self.mesh = mesh
        self.axis = axis
        self._tables_placed = False
        self._ntt_cache = {}
        self._fri_u0 = None
        # which route each step took: the distributed NTT or the gathered
        # one-device transform, the device or host forest, sharded folds
        self.routes = Counter()
        fri = self.fri
        fri.commit_codeword = self._commit_rows
        fri.initial_table = self._fri_initial_table
        fri.fold_layer = self._fri_fold_layer

    @property
    def num_shards(self) -> int:
        return self.mesh.shape[self.axis]

    # ------------------------------------------------------------------
    def _shard_last(self, arr: torch.Tensor) -> Sharded:
        """``arr`` sharded over its last (codeword) axis."""
        return Sharded.place(self.mesh, arr)

    def _dist_ntt(self, n: int, inverse: bool):
        """The cached distributed (i)NTT of length n, or None where the
        routing rule does not hold."""
        if not dist_ntt_ok(n, self.num_shards):
            return None
        key = (n, inverse)
        if key not in self._ntt_cache:
            self._ntt_cache[key] = make_distributed_ntt(n, self.mesh, self.axis, inverse=inverse)
        return self._ntt_cache[key]

    # -- hooks consumed by FastStark ---------------------------------------
    def _place_codeword(self, arr: torch.Tensor) -> Sharded:
        return self._shard_last(arr)

    def _lde(self, coeffs, offset: int, order: int) -> Sharded:
        """Sharded coset evaluation: the coefficients zero-padded to
        ``order`` and sharded (a reshard if they come sharded), then the
        distributed NTT with the coset pre-scale (on the card one H9 launch
        a shard runs the scale with the column step): the JAX ``_lde``'s
        scale, then transform."""
        if isinstance(coeffs, Sharded):
            padded = coeffs.resize(order)
        else:
            padded = Sharded.place(self.mesh, coeffs, order)
        dist = self._dist_ntt(order, inverse=False)
        if dist is None:
            self.routes["ntt_gathered"] += 1
            return self._shard_last(NTT.coset_evaluate(padded.gather(), offset, order))
        self._count_dist(dist)
        return dist(padded, offset)

    def _intt(self, values: Sharded) -> Sharded:
        dist = self._dist_ntt(values.length, inverse=True)
        if dist is None:
            self.routes["ntt_gathered"] += 1
            return self._shard_last(NTT.intt(values.gather()))
        self._count_dist(dist)
        return dist(values)

    def _count_dist(self, dist) -> None:
        """Count a distributed transform and its step 1's route."""
        self.routes["ntt_dist"] += 1
        self.routes["columns_" + dist.columns] += 1

    def _pointwise(self, fn, *args):
        if not any(isinstance(a, Sharded) for a in args):
            return fn(*args)
        return pointwise(fn, *args)

    def _roll_left(self, x: Sharded, k: int) -> Sharded:
        return x.roll_left(k)

    def _next_rows(self, trace_lde: Sharded, k: int):
        # the next cycle crosses shards: H10 reads the exchanged rows as
        # they come, at shift 0
        return self._roll_left(trace_lde, k), 0

    def _x_lde_pows(self, exponents) -> Sharded:
        """x^e on the FRI coset shard by shard, by the closed form
        g^e omega^(j e mod N) (one gather from the domain table and one H0
        launch a shard and exponent); cached per exponent list."""
        key = tuple(int(e) for e in exponents)
        if key not in self._xpow_cache:
            N = self.fri_domain_length
            per = N // self.num_shards
            parts = {}
            for s in self.mesh.local_shards():
                dev = self.mesh.device_of(s)
                tab = DOMAINS.get(N, dev)["fwd_powers"]
                j = s * per + torch.arange(per, device=dev)
                parts[s] = torch.stack([
                    F.mont_mul(tab.index_select(-1, (j * (e % N)) & (N - 1)),
                               mont_const(pow(self.generator.value, e, P), dev))
                    for e in key
                ])
            self._xpow_cache[key] = Sharded(self.mesh, parts, N)
        return self._xpow_cache[key]

    def _draw(self, urandom, count: int, size: int) -> List[bytes]:
        """Rank 0's draws on every rank (every rank proves the same bytes)."""
        if self.mesh.backend == "local":
            return super()._draw(urandom, count, size)
        mine = super()._draw(urandom, count, size) if self.mesh.rank == 0 else None
        return self.mesh.broadcast(mine)

    def _fri(self, combo: Sharded, proof_stream: ProofStream) -> List[int]:
        """FRI on the pair blocks, through the hooks this class installs."""
        return self.fri.prove(Paired.of(combo), proof_stream, self.timer)

    def _sync(self) -> None:
        self.mesh.synchronize()

    def _merkle_from_canon(self, canon):
        """The per-shard forest over a canonical host array (bit-identical
        to the monolithic tree)."""
        S = self.num_shards
        if S > 1 and (canon.shape[0] // 2) % S == 0:
            return MerkleForest.from_limbs_paired_sharded(canon, S)
        return MerkleTree.from_limbs_paired(canon)

    def _commit_many(self, x, on_device=None) -> list:
        """Commit the R codewords of a sharded (R, 8, n) or (8, n) codeword
        as forests, on the device where ``use_device_commit`` says so (or
        ``on_device``); a list of R (rows, tree)."""
        if isinstance(x, Sharded):
            x = Paired.of(x)
        if on_device is None:
            on_device = use_device_commit(x.length, x.device)
        self.routes["commit_device_forest" if on_device else "commit_host_forest"] += 1
        return commit_forest(x.blocks, x.length, self.num_shards, on_device, merge=self.mesh.merge)

    def _commit_rows(self, codeword):
        if not isinstance(codeword, (Sharded, Paired)):
            return super()._commit_rows(codeword)
        return self._commit_many(codeword)[0]

    def _commit_rows_many(self, codewords):
        if not isinstance(codewords, (Sharded, Paired)):
            return super()._commit_rows_many(codewords)
        return self._commit_many(codewords)

    def _interp_tables(self):
        t = super()._interp_tables()
        if not self._tables_placed:
            for key in ("zn_over_xm", "x_lde"):
                t[key] = self._shard_last(t[key])
            # drop the whole x table (a preprocess that needs it rebuilds it)
            self._x_lde_arr = None
            self._tables_placed = True
        return t

    # -- the FRI's hooks -----------------------------------------------------
    def _fri_initial_table(self, codeword: Paired) -> Dict[int, torch.Tensor]:
        """Block k of the first round's inverse-domain table, u_i =
        1/(offset omega^i) for i in [k h, (k + 1) h): a table of h powers
        shared by the blocks, each scaled by omega^(-k h)."""
        if self._fri_u0 is None:
            fri = self.fri
            h = codeword.length // (2 * self.num_shards)
            w_inv = pow(fri.omega, P - 2, P)
            u0 = {}
            for k in self.mesh.local_shards():
                dev = self.mesh.device_of(k)
                base = F.mont_mul(power_table(w_inv, h, dev), mont_const(pow(fri.offset, P - 2, P), dev))
                u0[k] = base if k == 0 else F.mont_mul(base, mont_const(pow(w_inv, k * h, P), dev))
            self._fri_u0 = u0
        return self._fri_u0

    def _fri_fold_layer(self, codeword: Paired, u: Dict[int, torch.Tensor], alpha: int):
        """One sharded round: H6 folds pair block k into shard k of the next
        layer (positions [k h, (k + 1) h)) and gives u_i^2 there; the next
        table's block k is that times omega_next^(k h / 2).  Then the next
        layer's pair blocks (one exchange) and its forest."""
        fri = self.fri
        n_next = codeword.length // 2
        h2 = n_next // (2 * self.num_shards)
        w_next = pow(fri.omega, fri.domain_length // n_next, P)
        folded, u_next = {}, {}
        for k, q in codeword.blocks.items():
            f, _, u2 = K.fri_fold(q, u[k], alpha)
            folded[k] = f
            u_next[k] = u2 if k == 0 else F.mont_mul(u2, mont_const(pow(w_next, k * h2, P), u2.device))
        self.routes["fold_sharded"] += 1
        layer = Paired.of(Sharded(self.mesh, folded, n_next))
        # a layer the card folded is committed there, as one device's
        # fused fold and commit does at every size
        rows, tree = self._commit_many(layer, on_device=True)[0]
        return layer, u_next, rows, tree

    # ------------------------------------------------------------------
    def prove(self, trace, transition_constraints, boundary,
              transition_zerofier: TransitionZerofier, proof_stream=None, **kwargs) -> bytes:
        # a zerofier preprocessed by a one-device prover is sharded once
        tz = transition_zerofier
        inv = tz.inv_codeword
        if not (isinstance(inv, Sharded) and inv.mesh is self.mesh):
            tz.inv_codeword = self._shard_last(inv.gather() if isinstance(inv, Sharded) else inv)
        return super().prove(trace, transition_constraints, boundary, tz, proof_stream, **kwargs)
