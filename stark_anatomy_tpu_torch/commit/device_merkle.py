"""Device-resident Merkle commitment: hash a codeword where it lives.

The port of stark_anatomy_tpu/commit/device_merkle.py: ``DeviceMerkleTree``,
``DeviceRows``, ``device_commit_paired``, ``device_commit_paired_many``,
``use_device_commit``, ``DEVICE_COMMIT_MIN`` and ``gather_rows``; and the
forest of a sharded codeword (``commit_forest``, ``ForestTree``,
``ForestRows``), the port's own, which commits without gathering.  The
tree is H4 (commit/kernels.py:merkle_paired) over the canonical limbs
that one H0 launch makes (``F.from_mont``); only the roots and the
queried digests and values are copied to the host: the digests a
commit/merkle.py:MultiproofWalk names by one gather and one copy
(``digests_at``), the values likewise (``limbs_at``).  A tree and its
rows hold one codeword, (8, n), or B proofs' codewords stacked, (B, 8,
n), of which proof b opens its own (the batch prover's,
parallel/batch_prover.py); the tensor's rank says which.  Roots, paths
and multiproofs are byte for byte those of the host MerkleTree over the
same codeword.

Not ported: the reference's padded gathers (``_take_padded``) and its
padded-buffer trees (``n_leaves``, ``_commit_paired_dynamic``), which only
kept XLA from recompiling: the device FRI (protocols/fri.py) builds each
round's tree over an exactly sized codeword.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..field import ops as F
from ..field.limbs import NLIMBS
from ..utils.convert import canonical_np, gather_limbs, gather_rows, ints_from_rows
from .kernels import merkle_paired
from .hashing import DIGEST_LEN
from .merkle import MerkleTree, open_multi

__all__ = [
    "DEVICE_COMMIT_MIN", "DeviceMerkleTree", "DeviceRows", "ForestRows", "ForestTree",
    "commit_forest", "device_commit_paired", "device_commit_paired_many", "gather_rows",
    "root_rows", "use_device_commit",
]

# below this many codeword elements the host path is taken, as in the
# reference: its threshold, kept so one setting drives both packages
DEVICE_COMMIT_MIN = 1 << 18


def _digest_rows(cols: torch.Tensor) -> np.ndarray:
    """(8, k) digest words on any device -> the k digests (k, 32) uint8."""
    return np.ascontiguousarray(cols.cpu().numpy().view(np.uint32).T.astype("<u4")).view(np.uint8)


def root_rows(flat: torch.Tensor) -> np.ndarray:
    """The roots (k, DIGEST_LEN) uint8 of flat trees (..., 8, n), k =
    prod(...) in row-major order (1 for one tree): one copy."""
    return _digest_rows(flat[..., -2].reshape(-1, flat.shape[-2]).T)   # column -1 is the pad


class DeviceMerkleTree:
    """A Merkle tree whose levels live on the card, as one flat (8, n)
    digest-word tensor (leaves first, root at column n - 2, pad last); or
    B trees stacked, (B, 8, n), one a proof, as the host's stacked levels
    (commit/merkle.py:paired_levels) hold them.  Same roots, paths and
    multiproofs as the host MerkleTree; the digests a walk names are one
    gather over the flat tensor and one copy."""

    __slots__ = ("flat", "offsets", "depth", "_root")

    def __init__(self, flat: torch.Tensor, root: Optional[bytes] = None):
        half = flat.shape[-1] // 2
        self.depth = half.bit_length() - 1
        self.offsets = [2 * half - (2 * half >> level) for level in range(self.depth + 1)]
        self.flat = flat
        if root is None and flat.dim() == 2:
            root = self.roots[0].tobytes()
        self._root = root

    @property
    def levels(self) -> List[torch.Tensor]:
        """Per-level views into the flat digest tensor (tests)."""
        half = self.flat.shape[-1] // 2
        return [self.flat[..., off : off + (half >> k)] for k, off in enumerate(self.offsets)]

    @property
    def root(self) -> bytes:
        """The root of one tree (stacked trees have no one root: ``roots``)."""
        return self._root

    @property
    def roots(self) -> np.ndarray:
        """Every tree's root (B, DIGEST_LEN) uint8, (1, DIGEST_LEN) for one
        tree: one copy."""
        return root_rows(self.flat)

    def __len__(self) -> int:
        return self.flat.shape[-1] // 2

    def digests_at(self, level: np.ndarray, proof: np.ndarray, node: np.ndarray) -> np.ndarray:
        """The digests (k, 32) at (level, proof, node): proof b's own tree
        of stacked trees, the one tree of every proof otherwise.  One
        gather over the flat tensor and one copy."""
        col = np.asarray(self.offsets)[level] + node
        if self.flat.dim() == 2:
            return _digest_rows(self.flat.index_select(-1, torch.from_numpy(col).to(self.flat.device)))
        at = torch.from_numpy(np.stack([proof, col])).to(self.flat.device)
        return _digest_rows(self.flat[at[0], :, at[1]].T)

    def open(self, index: int) -> List[bytes]:
        """Authentication path (sibling digests, leaf level first)."""
        return open_multi(self, [index])


class DeviceRows:
    """Opening values of a codeword whose canonical limbs (8, n) lie on the
    card, or of B proofs' codewords stacked, (B, 8, n): queried elements
    are gathered there and decoded on the host; the codeword itself is
    never copied."""

    __slots__ = ("canon",)

    def __init__(self, canon: torch.Tensor):
        self.canon = canon

    @property
    def shape(self):
        return self.canon.shape[:-2] + (self.canon.shape[-1], self.canon.shape[-2])

    def __len__(self) -> int:
        return self.canon.shape[-1]

    def limbs_at(self, indices) -> np.ndarray:
        """Canonical limb rows (..., NLIMBS) at an index array (...) of any
        shape, of stacked rows (B, ...), whose proof b reads its own rows
        at indices[b], as utils/convert.py:gather_limbs reads stacked numpy
        rows: one gather, one copy."""
        idx = np.asarray(indices, dtype=np.int64)
        if self.canon.dim() == 2:
            flat = torch.from_numpy(np.ascontiguousarray(idx.reshape(-1))).to(self.canon.device)
            got = self.canon.index_select(-1, flat).cpu().numpy().T
        else:
            proof = np.broadcast_to(np.arange(self.canon.shape[0]).reshape((-1,) + (1,) * (idx.ndim - 1)),
                                    idx.shape)
            at = torch.from_numpy(np.stack([proof.reshape(-1), idx.reshape(-1)])).to(self.canon.device)
            got = self.canon[at[0], :, at[1]].cpu().numpy()
        return got.astype(np.uint32).reshape(idx.shape + (NLIMBS,))

    def gather(self, indices) -> List[int]:
        """Canonical ints at ``indices`` (one gather, one copy)."""
        return ints_from_rows(self.limbs_at(indices))

    def __getitem__(self, i: int) -> int:
        return self.gather([i])[0]


def use_device_commit(n: Optional[int] = None, device=None) -> bool:
    """Commit on the card when the codeword lies there (``device``, a CUDA
    device) and has at least DEVICE_COMMIT_MIN elements; with no size
    ``n``, by the device alone (the batch prover's route).
    STARK_TPU_DEVICE_HASH=0 turns the device commit off, and =1 turns it
    on at any size from STARK_TPU_DEVICE_HASH_MIN (default 0) and on any
    device: on a CPU tensor it runs H4's plain version."""
    env = os.environ.get("STARK_TPU_DEVICE_HASH")
    if env == "0":
        return False
    if env == "1":
        return True if n is None else n >= int(os.environ.get("STARK_TPU_DEVICE_HASH_MIN", 0))
    if env is not None:
        warnings.warn(
            f"STARK_TPU_DEVICE_HASH={env!r} is not '0' or '1'; ignoring it and "
            "deciding by the codeword's device"
        )
    on_card = device is not None and torch.device(device).type == "cuda"
    return on_card and (n is None or n >= DEVICE_COMMIT_MIN)


def device_commit_paired(codeword_mont: torch.Tensor):
    """Commit a Montgomery codeword (8, n) with paired leaves where it lies:
    one H0 launch to canonical form, the H4 passes, one 32-byte root copy.
    Returns (DeviceRows, DeviceMerkleTree)."""
    canon = F.from_mont(codeword_mont)
    return DeviceRows(canon), DeviceMerkleTree(merkle_paired(canon))


def device_commit_paired_many(codewords_mont: torch.Tensor):
    """Commit R stacked codewords (R, 8, n): one H0 launch and one set of
    H4 passes for all R trees, one copy of the R roots.  Returns a list of
    (DeviceRows, DeviceMerkleTree)."""
    canon = F.from_mont(codewords_mont)
    flat = merkle_paired(canon)
    roots = root_rows(flat)
    return [
        (DeviceRows(canon[r]), DeviceMerkleTree(flat[r], root=roots[r].tobytes()))
        for r in range(codewords_mont.shape[0])
    ]


# ---------------------------------------------------------------------------
# the forest of a sharded codeword
# ---------------------------------------------------------------------------
#
# A codeword of n elements in S shards is committed as S subtrees and a top
# tree.  Subtree k covers the paired leaves [k h, (k + 1) h), h = n / (2S):
# its input is the pair block Q_k = (c[k h : (k + 1) h], c[n/2 + k h : n/2 +
# (k + 1) h]), whose own paired tree (leaf t hashes Q_k[t] and Q_k[t + h])
# is exactly that part of the monolithic tree.  So no tensor longer than
# 2h = n/S is hashed, and the top tree over the S roots gives the
# monolithic root; an opening is a subtree path and a top path.


def _no_merge(local: dict) -> dict:
    return local


class ForestTree:
    """The paired-leaf tree of a codeword held as per-block subtrees (host
    MerkleTree or DeviceMerkleTree, the ones this process holds) and a host
    top tree over all S roots.  Same root, paths and multiproofs as the
    monolithic tree.  ``merge`` joins the digests that each process's
    subtrees serve (identity in one process)."""

    __slots__ = ("subtrees", "top", "sub_depth", "depth", "merge")

    def __init__(self, subtrees: Dict[int, object], roots: List[bytes], leaves: int, merge=None):
        S = len(roots)
        assert S & (S - 1) == 0 and leaves % S == 0
        self.subtrees = subtrees
        self.top = MerkleTree(_digests=np.frombuffer(b"".join(roots), dtype=np.uint8).reshape(S, -1))
        self.sub_depth = (leaves // S).bit_length() - 1
        self.depth = leaves.bit_length() - 1
        self.merge = merge or _no_merge

    @property
    def root(self) -> bytes:
        return self.top.root

    def __len__(self) -> int:
        return 1 << self.depth

    def digests_at(self, level: np.ndarray, proof: np.ndarray, node: np.ndarray) -> np.ndarray:
        """The digests (k, DIGEST_LEN) at (level, node) of the monolithic
        tree, level by level: a subtree level's from the subtree holding the
        node, one gather each, joined by ``merge``; a top level's from the
        top tree."""
        out = np.empty((level.size, DIGEST_LEN), dtype=np.uint8)
        sub = level < self.sub_depth                 # the levels sort, so the subtrees' come first
        sub_level, sub_proof = level[sub], proof[sub]
        shift = self.sub_depth - sub_level
        owner = node[sub] >> shift
        local_node = node[sub] & ((1 << shift) - 1)
        local = {}
        for k in np.unique(owner).tolist():
            if k in self.subtrees:
                m = owner == k
                local[k] = self.subtrees[k].digests_at(sub_level[m], sub_proof[m], local_node[m])
        at = np.flatnonzero(sub)
        for k, digests in self.merge(local).items():
            out[at[owner == k]] = digests
        top = ~sub
        if top.any():
            out[top] = self.top.digests_at(level[top] - self.sub_depth, proof[top], node[top])
        return out

    def open(self, index: int) -> List[bytes]:
        """Authentication path (sibling digests, leaf level first)."""
        return open_multi(self, [index])


class ForestRows:
    """Opening values of a codeword held as the forest's pair blocks: block
    k holds the canonical rows of global elements [k h, (k + 1) h) and then
    [n/2 + k h, n/2 + (k + 1) h), h = n / (2S), as DeviceRows or as
    element-major numpy rows (the blocks this process holds)."""

    __slots__ = ("blocks", "n", "h", "merge")

    def __init__(self, blocks: Dict[int, object], n: int, num_blocks: int, merge=None):
        self.blocks = blocks
        self.n = n
        self.h = n // (2 * num_blocks)
        self.merge = merge or _no_merge

    @property
    def shape(self):
        return (self.n, 8)

    def __len__(self) -> int:
        return self.n

    def limbs_at(self, indices) -> np.ndarray:
        """Canonical limb rows (..., NLIMBS) at global indices, an array
        (...) of any shape: one gather a block, joined by ``merge``."""
        idx = np.asarray(indices, dtype=np.int64)
        flat = idx.reshape(-1)
        half = self.n // 2
        leaf = flat % half
        block = leaf // self.h
        local_pos = leaf % self.h + np.where(flat >= half, self.h, 0)
        local = {k: gather_limbs(self.blocks[k], local_pos[block == k])
                 for k in np.unique(block).tolist() if k in self.blocks}
        out = np.empty((flat.size, NLIMBS), dtype=np.uint32)
        for k, rows in self.merge(local).items():
            out[block == k] = rows
        return out.reshape(idx.shape + (NLIMBS,))

    def gather(self, indices) -> List[int]:
        """Canonical ints at global ``indices`` (one gather a block)."""
        return ints_from_rows(self.limbs_at(indices))

    def __getitem__(self, i: int) -> int:
        return self.gather([i])[0]


def commit_forest(blocks: Dict[int, torch.Tensor], n: int, num_blocks: int, on_device: bool,
                  merge=None):
    """Commit the pair blocks Q_k (..., 8, n/S), Montgomery form, of R =
    prod(...) codewords of n elements: on the
    device, the blocks on one device are stacked and committed by one H0
    launch to canonical form and one H4 launch for all their trees; on the
    host, each block's canonical rows are copied and hashed by N1.  The S
    roots of each codeword meet in its top tree.  Returns a list of R
    (ForestRows, ForestTree)."""
    merge = merge or _no_merge
    lead = tuple(next(iter(blocks.values())).shape[:-2])
    R = int(np.prod(lead)) if lead else 1
    rows: Dict[tuple, object] = {}
    trees: Dict[tuple, object] = {}
    roots: Dict[tuple, bytes] = {}
    if on_device:
        by_dev: Dict[torch.device, list] = {}
        for k, q in blocks.items():
            by_dev.setdefault(q.device, []).append(k)
        for ks in by_dev.values():
            stacked = torch.stack([blocks[k] for k in ks])
            canon = F.from_mont(stacked).reshape((len(ks), R) + stacked.shape[-2:])
            flat = merkle_paired(canon)
            tops = root_rows(flat)
            for a, k in enumerate(ks):
                for r in range(R):
                    root = tops[a * R + r].tobytes()
                    rows[k, r] = DeviceRows(canon[a, r])
                    trees[k, r] = DeviceMerkleTree(flat[a, r], root=root)
                    roots[k, r] = root
    else:
        for k, q in blocks.items():
            rows_k = canonical_np(q).reshape((R, q.shape[-1], 8))
            for r in range(R):
                tree = MerkleTree.from_limbs_paired(rows_k[r])
                rows[k, r], trees[k, r], roots[k, r] = rows_k[r], tree, tree.root
    roots = merge(roots)
    leaves = n // 2
    return [
        (ForestRows({k: rows[k, r] for k in blocks}, n, num_blocks, merge),
         ForestTree({k: trees[k, r] for k in blocks}, [roots[k, r] for k in range(num_blocks)],
                    leaves, merge))
        for r in range(R)
    ]
