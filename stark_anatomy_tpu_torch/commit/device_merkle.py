"""Device-resident Merkle commitment: hash a codeword where it lives.

The port of stark_anatomy_tpu/commit/device_merkle.py: ``DeviceMerkleTree``,
``DeviceRows``, ``device_commit_paired``, ``device_commit_paired_many``,
``use_device_commit``, ``DEVICE_COMMIT_MIN`` and ``gather_rows``.  The
tree is H4 (commit/kernels.py:merkle_paired) over the canonical limbs
that one H0 launch makes (``F.from_mont``); only the root and the
queried digests and values are copied to the host, each opening by one
``index_select`` and one copy.  Roots, paths and multiproofs are byte
for byte those of the host MerkleTree over the same codeword.

Not ported: the reference's padded gathers (``_take_padded``) and its
padded-buffer trees (``n_leaves``, ``_commit_paired_dynamic``), which only
kept XLA from recompiling: the device FRI (protocols/fri.py) builds each
round's tree over an exactly sized codeword.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..field import ops as F
from ..utils.convert import gather_rows, int_from_row
from .kernels import merkle_paired

__all__ = [
    "DEVICE_COMMIT_MIN", "DeviceMerkleTree", "DeviceRows", "device_commit_paired",
    "device_commit_paired_many", "gather_rows", "use_device_commit",
]

# below this many codeword elements the host path is taken, as in the
# reference: its threshold, kept so one setting drives both packages
DEVICE_COMMIT_MIN = 1 << 18


def _digest_bytes(cols: torch.Tensor) -> List[bytes]:
    """(8, k) digest words on any device -> the k 32-byte digests."""
    words = cols.cpu().numpy().view(np.uint32).T.astype("<u4")
    return [words[j].tobytes() for j in range(words.shape[0])]


class DeviceMerkleTree:
    """A Merkle tree whose levels live on the card, as one flat (8, n)
    digest-word tensor (leaves first, root at column n - 2, pad last).
    Same roots, paths and multiproofs as the host MerkleTree; an opening
    is one gather over the flat tensor."""

    __slots__ = ("flat", "offsets", "depth", "_root")

    def __init__(self, flat: torch.Tensor, root: Optional[bytes] = None):
        half = flat.shape[-1] // 2
        self.depth = half.bit_length() - 1
        self.offsets = [2 * half - (2 * half >> level) for level in range(self.depth + 1)]
        self.flat = flat
        if root is None:
            col = self.offsets[self.depth]
            root = _digest_bytes(flat[:, col : col + 1])[0]
        self._root = root

    @property
    def levels(self) -> List[torch.Tensor]:
        """Per-level views into the flat digest tensor (tests)."""
        half = self.flat.shape[-1] // 2
        return [self.flat[:, off : off + (half >> k)] for k, off in enumerate(self.offsets)]

    @property
    def root(self) -> bytes:
        return self._root

    def __len__(self) -> int:
        return self.flat.shape[-1] // 2

    def _gather_flat(self, flat_idx: Sequence[int]) -> List[bytes]:
        if not flat_idx:
            return []
        idx = torch.tensor(list(flat_idx), dtype=torch.int64, device=self.flat.device)
        return _digest_bytes(self.flat.index_select(-1, idx))

    def open(self, index: int) -> List[bytes]:
        """Authentication path (sibling digests, leaf level first)."""
        assert 0 <= index < len(self), "cannot open invalid index"
        flat_idx = []
        for level in range(self.depth):
            flat_idx.append(self.offsets[level] + (index ^ 1))
            index >>= 1
        return self._gather_flat(flat_idx)

    def multiproof(self, indices) -> List[bytes]:
        """Minimal batched authentication proof, the bytes of
        commit/merkle.py:open_multi over the host tree, from one gather."""
        known = sorted(set(indices))
        flat_idx: List[int] = []
        for level in range(self.depth):
            known_set = set(known)
            flat_idx.extend(self.offsets[level] + (i ^ 1) for i in known if i ^ 1 not in known_set)
            known = sorted({i >> 1 for i in known})
        return self._gather_flat(flat_idx)


class DeviceRows:
    """Opening values of a codeword whose canonical limbs (8, n) lie on the
    card: queried elements are gathered there and decoded on the host; the
    codeword itself is never copied."""

    __slots__ = ("canon",)

    def __init__(self, canon: torch.Tensor):
        self.canon = canon

    @property
    def shape(self):
        return (self.canon.shape[-1], self.canon.shape[-2])

    def __len__(self) -> int:
        return self.canon.shape[-1]

    def gather(self, indices) -> List[int]:
        """Canonical ints at ``indices`` (one gather, one copy)."""
        if not len(indices):
            return []
        idx = torch.tensor(list(indices), dtype=torch.int64, device=self.canon.device)
        rows = self.canon.index_select(-1, idx).cpu().numpy().T
        return [int_from_row(row) for row in rows]

    def __getitem__(self, i: int) -> int:
        return self.gather([i])[0]


def use_device_commit(n: Optional[int] = None, device=None) -> bool:
    """Commit on the card when the codeword lies there (``device``, a CUDA
    device) and has at least DEVICE_COMMIT_MIN elements.
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
    roots = _digest_bytes(flat[..., -2].T)                   # column -1 is the pad
    return [
        (DeviceRows(canon[r]), DeviceMerkleTree(flat[r], root=roots[r]))
        for r in range(codewords_mont.shape[0])
    ]
