"""H4: the blake2s-256 Merkle tree kernel, and H5: the seed-expansion
kernel, with their plain versions.

H4 ``merkle_paired`` (csrc/merkle.cu) replaces the JAX package's jnp
blake2s graphs K11 (stark_anatomy_tpu/commit/device_merkle.py:
_compress_words, _paired_leaf_digests, _parent_level, _flat_tree_core).
The source's header says what bounds it and how the design answers it.
field/kernels.py builds and loads it with the field kernels and counts
its launches under "merkle", one per tree (or per set of R trees).

The wrapper takes canonical limbs (..., 8, n), int32 lanes holding 16-bit
limbs, n a power of two >= 2, and returns the flat tree (..., 8, n) of
u32 digest words held in int32 lanes, in the reference's layout: the n/2
paired leaves (leaf i hashes LE16(v_i) || LE16(v_{i+n/2})), each parent
level after them, the root in column n - 2 and a zero pad in column
n - 1.  On a CPU tensor it runs the plain version below; on a CUDA tensor
it launches H4 or raises.

H5 ``seed_expand`` (csrc/merkle.cu, sharing H4's compression) replaces the
jnp graph stark_anatomy_tpu/utils/rand.py:_expand_impl: ``count`` field
elements in Montgomery form from 8 seed words, by blake2s in counter mode
with rejection sampling.  Its launches count under "seed_expand".
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..field import kernels as K
from ..field.limbs import NLIMBS, R
from ..field.scalar import P

TREE_THREADS = 256       # nodes one H4 block takes at a stage
STAGE_LEVELS = 3         # levels a wide stage reduces (each block 256 nodes to 32, in full warps)
WIDE_STAGE = 2048        # a stage from more nodes than this (more than 8 blocks) is wide
TREE_LEVELS = 8          # levels a narrower stage of more than TREE_THREADS nodes reduces
MAX_BATCH = 65535        # codewords per launch: the grid's y axis
MASK32 = 0xFFFFFFFF

_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_H = (_IV[0] ^ 0x01010020,) + _IV[1:]      # digest length 32, fanout 1, depth 1
_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def tree_layout(canon: torch.Tensor) -> Tuple[int, int]:
    """(batch, n) of a canonical (..., 8, n) input H4 takes: int32, n a
    power of two >= 2.  Raises ValueError for any other input."""
    if canon.dtype != torch.int32 or canon.dim() < 2 or canon.shape[-2] != NLIMBS:
        raise ValueError(f"merkle: the kernel takes int32 (..., {NLIMBS}, n) canonical limbs; "
                         f"got {tuple(canon.shape)} {canon.dtype}")
    n = canon.shape[-1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"merkle: the codeword length must be a power of two >= 2, got {n}")
    return math.prod(canon.shape[:-2]), n


def tree_stages(n: int) -> List[Tuple[int, int, int]]:
    """The stages of H4's one launch over a tree of n elements: (width,
    in_off, levels) each, the first hashing the n/2 leaves.  A stage starts
    from the level of ``width`` nodes at flat column ``in_off``, each block
    taking TREE_THREADS of them: a wide stage (more than WIDE_STAGE nodes)
    reduces STAGE_LEVELS levels, each block 256 nodes to 32 in full warps;
    a narrower one TREE_LEVELS, each block 256 nodes to 1; the stage that
    starts from TREE_THREADS nodes or fewer takes them to the root in one
    block.  Every block of a stage after the first is the last block to
    finish of the group of 2^levels blocks of the stage before whose
    outputs it takes."""
    stages, width, off = [], n // 2, 0
    while width > TREE_THREADS:
        levels = STAGE_LEVELS if width > WIDE_STAGE else TREE_LEVELS
        stages.append((width, off, levels))
        for _ in range(levels):
            off += width
            width //= 2
    stages.append((width, off, width.bit_length() - 1))
    return stages


def stage_blocks(width: int) -> int:
    """Blocks of a stage that starts from ``width`` nodes."""
    return max(1, width // TREE_THREADS)


def tree_counters(n: int) -> int:
    """Tickets of one tree: a counter for each block of each stage after
    the first (the group of blocks it takes over counts into it)."""
    return sum(stage_blocks(width) for width, _, _ in tree_stages(n)[1:])


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def ticket_counters(canon: torch.Tensor, size: int) -> torch.Tensor:
    """At least ``size`` zeroed H4 ticket counters for launches on the
    current stream of ``canon``'s device.  They are allocated once per
    device and stream (again when a larger set is needed) and kept: every
    H4 launch leaves its counters zeroed, so a commit launches only H4."""
    stream, device = K._stream(canon)
    key = (device, stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < size:
        counters = torch.zeros(size, dtype=torch.int32, device=canon.device)
        _COUNTERS[key] = counters
    return counters


def merkle_paired(canon: torch.Tensor) -> torch.Tensor:
    """H4: the flat paired-leaf blake2s tree (..., 8, n) of canonical limbs
    (..., 8, n), every tree of the batch in one launch."""
    batch, n = tree_layout(canon)
    if canon.device.type == "cpu":
        return merkle_paired_plain(canon)
    K._check_cuda("merkle", canon)
    if not canon.is_contiguous():
        raise ValueError("merkle: the kernel takes a contiguous input")
    if batch > MAX_BATCH:
        raise ValueError(f"merkle: one launch takes at most {MAX_BATCH} codewords, got {batch}")
    flat = torch.empty_like(canon)
    if batch == 0:
        return flat
    n_counters = tree_counters(n)
    counters = ticket_counters(canon, batch * n_counters) if n_counters else None
    err = K._entry("merkle")(flat.data_ptr(), canon.data_ptr(),
                             None if counters is None else counters.data_ptr(), batch, n,
                             n_counters, *K._stream(canon))
    K._finish("merkle", err)
    return flat


# ---------------------------------------------------------------------------
# plain PyTorch version (any device): int64 words, & 0xFFFFFFFF
# ---------------------------------------------------------------------------

def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & MASK32


def compress_plain(m, t: int) -> List[torch.Tensor]:
    """One final blake2s-256 compression over 16 message words (int64
    tensors or ints that broadcast), t = message bytes <= 64: the 8 digest
    words, vectorised over the tensors' elements."""
    v = list(_H) + list(_IV)
    v[12] ^= t
    v[14] ^= MASK32

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & MASK32
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & MASK32
        v[b] = _rotr(v[b] ^ v[c], 12)
        v[a] = (v[a] + v[b] + y) & MASK32
        v[d] = _rotr(v[d] ^ v[a], 8)
        v[c] = (v[c] + v[d]) & MASK32
        v[b] = _rotr(v[b] ^ v[c], 7)

    for s in _SIGMA:
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [_H[k] ^ v[k] ^ v[k + 8] for k in range(8)]


def paired_leaves_plain(canon: torch.Tensor) -> torch.Tensor:
    """(..., 8, n) canonical limbs -> (..., 8, n/2) int64 leaf digest words."""
    limbs = canon.long() & 0xFFFF
    words = limbs[..., 0::2, :] | (limbs[..., 1::2, :] << 16)        # (..., 4, n)
    half = canon.shape[-1] // 2
    lo, hi = words[..., :half], words[..., half:]
    m = [lo[..., k, :] for k in range(4)] + [hi[..., k, :] for k in range(4)] + [0] * 8
    return torch.stack(compress_plain(m, 32), dim=-2)


def parent_level_plain(digests: torch.Tensor) -> torch.Tensor:
    """(..., 8, w) int64 digest words -> (..., 8, w/2) parents."""
    left, right = digests[..., 0::2], digests[..., 1::2]
    m = [left[..., k, :] for k in range(8)] + [right[..., k, :] for k in range(8)]
    return torch.stack(compress_plain(m, 64), dim=-2)


def merkle_paired_plain(canon: torch.Tensor) -> torch.Tensor:
    """Plain version of H4: the same flat tree, one level at a time."""
    tree_layout(canon)
    levels = [paired_leaves_plain(canon)]
    while levels[-1].shape[-1] > 1:
        levels.append(parent_level_plain(levels[-1]))
    levels.append(torch.zeros_like(levels[-1][..., :1]))                # the pad column
    flat = torch.cat(levels, dim=-1)
    return torch.where(flat >= 1 << 31, flat - (1 << 32), flat).to(torch.int32)


# ---------------------------------------------------------------------------
# H5: seed expansion
# ---------------------------------------------------------------------------

_P_WORDS = tuple((P >> (32 * k)) & MASK32 for k in range(4))
EXPAND_TILE = 1024      # counters a block of H5 takes (csrc/merkle.cu:kExpandTile)


def seed_expand(seed_words: torch.Tensor, count: int) -> torch.Tensor:
    """H5: ``count`` field elements (8, count) in Montgomery form from the
    8 seed words ``seed_words`` (an int32 tensor of the 32-byte seed read
    little-endian), on the seed's device.  With h = ceil(count / 2),
    element i (element h + i) is words 0-3 (4-7) of blake2s(seed || i ||
    r) for the first round tag r at which that candidate is below p.  The
    kernel gives each block a tile of EXPAND_TILE counters and redraws
    only the rejected ones, compacted (csrc/merkle.cu)."""
    if seed_words.dtype != torch.int32 or tuple(seed_words.shape) != (8,):
        raise ValueError(f"seed_expand: the seed must be 8 int32 words; "
                         f"got {tuple(seed_words.shape)} {seed_words.dtype}")
    if not 1 <= count <= 1 << 32:
        raise ValueError(f"seed_expand: the count must lie in [1, 2^32], got {count}")
    if seed_words.device.type == "cpu":
        return seed_expand_plain(seed_words, count)
    K._check_cuda("seed_expand", seed_words)
    seed_words = seed_words.contiguous()
    out = torch.empty((NLIMBS, count), dtype=torch.int32, device=seed_words.device)
    err = K._entry("seed_expand")(out.data_ptr(), seed_words.data_ptr(), count,
                                  *K._stream(seed_words))
    K._finish("seed_expand", err)
    return out


def expand_candidates_plain(seed_words: torch.Tensor, count: int, round_tag: int) -> torch.Tensor:
    """The candidates of round ``round_tag``: (4, count) int64 words of the
    128-bit values, least significant first."""
    half = (count + 1) // 2
    key = [int(w) & MASK32 for w in seed_words.tolist()]
    ctr = torch.arange(half, dtype=torch.int64, device=seed_words.device)
    d = torch.stack(compress_plain(key + [ctr, round_tag] + [0] * 6, 40))    # (8, half)
    return torch.cat([d[:4], d[4:]], dim=-1)[:, :count]


def below_p_plain(words: torch.Tensor) -> torch.Tensor:
    """(4, n) int64 words -> (n,) bool, value < p (p's words are 1, 0, 0,
    0xCB800000)."""
    top = words[3]
    low_zero = (words[0] | words[1] | words[2]) == 0
    return (top < _P_WORDS[3]) | ((top == _P_WORDS[3]) & low_zero)


def seed_expand_plain(seed_words: torch.Tensor, count: int, rounds: list = None) -> torch.Tensor:
    """Plain version of H5, the reference's rejection loop: every element
    draws from round 0, then each element still >= p from the next round
    tag, until none is left.  With ``rounds`` (a list), appends the number
    of compressions H5's threads run, one per counter and round until
    both its elements are accepted (the work the bound counts)."""
    v = expand_candidates_plain(seed_words, count, 0)
    ok = below_p_plain(v)
    done = torch.zeros_like(ok, dtype=torch.int64)                # round of acceptance
    r = 0
    while not bool(ok.all()):
        r += 1
        c = expand_candidates_plain(seed_words, count, r)
        bad = ~ok
        v = torch.where(bad, c, v)
        done = torch.where(bad, r, done)
        ok = below_p_plain(v)
    if rounds is not None:
        pad = torch.nn.functional.pad(done, (0, count % 2))        # the last counter's lone element
        rounds.append(int((pad.view(2, -1).amax(0) + 1).sum()))
    limbs = torch.stack([(v[k // 2] >> (16 * (k % 2))) & 0xFFFF for k in range(NLIMBS)])
    r2 = torch.tensor([(R * R % P >> (16 * k)) & 0xFFFF for k in range(NLIMBS)],
                      dtype=torch.int32, device=v.device).view(NLIMBS, 1)
    return K.mont_mul_plain(limbs.to(torch.int32), r2)
