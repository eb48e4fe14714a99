"""The index arithmetic of H3 (the NTT kernel) and H4 (the Merkle tree
kernel), modelled in Python and held against the JAX package.

The CUDA kernels have no CPU mode; chip_smoke.py holds them against their
plain versions on the card.  What the CPU can check is their plan: the
model below runs H3's Stockham passes thread by thread as
csrc/field.cu:ntt_kernel does (each thread's groups and positions, the
twiddle exponents read from the packed table, the exchange buffer split
over the blocks of a cluster and swizzled within each), on Python ints,
and must equal the JAX package's ``ntt_core``.  The tree model runs H4's
stages as csrc/merkle.cu:merkle_kernel does (the leaf blocks, the levels
through shared memory, the last-block-done tickets in a seeded finishing
order, the levels inside one warp by shuffles) and must equal the plain
version and the JAX package's flat tree.  The seed-expansion model runs
H5's tile plan as csrc/merkle.cu:seed_expand_kernel does (round 0 over a
tile of counters, from the state seed_prefix leaves; the queue of
counters with the mask of their elements still needed, in a seeded order
of arrival, round by round; the final positions of both candidates) and
must equal the JAX package's expansion and the plain version's count of
compressions.  The wrapper's path choice is a plain function, tested here.
Tolerance: zero (exact field arithmetic and exact hashing).
"""

import hashlib
import os
import random
import re

import numpy as np
import pytest
import torch

from stark_anatomy_tpu.commit import device_merkle as JD
from stark_anatomy_tpu.ops import ntt as JN
from stark_anatomy_tpu.ops.domain import DOMAINS as JDOMAINS
from stark_anatomy_tpu.utils.convert import device_from_ints as jfrom
from stark_anatomy_tpu.utils.convert import ints_from_device as jints
from stark_anatomy_tpu.utils import rand as JR
from stark_anatomy_tpu_torch.commit import kernels as MK
from stark_anatomy_tpu_torch.field import kernels as K
from stark_anatomy_tpu_torch.field.limbs import R
from stark_anatomy_tpu_torch.field.scalar import P
from stark_anatomy_tpu_torch.ops.domain import DOMAINS
from stark_anatomy_tpu_torch.utils.convert import ints_from_device as tints

torch.set_num_threads(1)

R_INV = pow(R, P - 2, P)
SMS = 132                      # the H100's streaming multiprocessors
SMEM_MAX = 232448              # shared memory one block may use on it


@pytest.fixture(autouse=True)
def _no_aot(monkeypatch):
    monkeypatch.setenv("STARK_TPU_AOT", "0")


def slot(i):
    """csrc/field.cu:ntt_slot, the swizzle within a block."""
    return i ^ ((i >> 3) & 7)


def ntt_radices(log_n):
    """The radices of ntt_kernel's Stockham passes: 8 while three bits are
    left, then one pass of 4 or 2 (none for n = 1)."""
    return (8,) * (log_n // 3) + {0: (), 1: (2,), 2: (4,)}[log_n % 3]


def table_ints(powers):
    """Canonical ints of the packed (n, 4) twiddle words H3 reads."""
    words = K.twiddle_words(powers).numpy().astype(np.uint32).astype(object)
    mont = words[:, 0] | (words[:, 1] << 32) | (words[:, 2] << 64) | (words[:, 3] << 96)
    return [int(v) * R_INV % P for v in mont]


def ntt_model(vals, log_n, tw, cluster):
    """H3 on Python ints, as ntt_kernel runs it with ``cluster`` blocks a
    transform: every pass's reads and writes go through the cluster's
    per-block exchange buffers, each written once per pass, and every
    quarter warp's eight 16-byte accesses to one block fall in distinct
    bank groups."""
    n = 1 << log_n
    T = max(n // 8, 1)
    per = n // cluster
    per_log = per.bit_length() - 1
    block_threads = T // cluster
    radices = ntt_radices(log_n)
    bufs = [[None] * per for _ in range(cluster)]

    def where(i):
        return i >> per_log, slot(i & (per - 1))

    def check_banks(targets):
        """targets[t]: the buffer position thread t touches (or None)."""
        for t0 in range(0, T, 8):
            if t0 // block_threads != (t0 + 7) // block_threads or n < 64:
                continue
            seen = {}
            for t in range(t0, t0 + 8):
                if targets[t] is not None:
                    b, s = where(targets[t])
                    seen.setdefault(b, []).append(s % 8)
            for banks in seen.values():
                assert len(set(banks)) == len(banks), (log_n, cluster, t0, banks)

    first = 1 if not radices else radices[0]
    v = []
    for t in range(T):
        groups = (n // first) // T
        v.append([vals[t + (i // first) * T + (i % first) * (n // first)]
                  if i // first < groups else None for i in range(8)])
    for p, radix in enumerate(radices):
        ns = 1 << (3 * p)
        groups = (n // radix) // T
        last = p == len(radices) - 1
        if p > 0:
            for i in range(8):
                targets = [t + (i // radix) * T + (i % radix) * (n // radix)
                           if i // radix < groups else None for t in range(T)]
                check_banks(targets)
                for t in range(T):
                    if targets[t] is not None:
                        b, s = where(targets[t])
                        v[t][i] = bufs[b][s]
        for t in range(T):
            for gi in range(groups):
                k = (t + gi * T) & (ns - 1)
                x = v[t][gi * radix:(gi + 1) * radix]
                if ns > 1:
                    x = [x[r] * tw[k * r * (n // (ns * radix))] % P for r in range(radix)]
                for s in range(radix):
                    v[t][gi * radix + s] = sum(x[r] * tw[(r * s % radix) * (n // radix)]
                                               for r in range(radix)) % P
        dest = [[(g // ns) * ns * radix + (g & (ns - 1)) + (i % radix) * ns
                 if (g := t + (i // radix) * T) < n // radix and i // radix < groups else None
                 for i in range(8)] for t in range(T)]
        if last:
            out = [None] * n
            for t in range(T):
                for i in range(8):
                    if dest[t][i] is not None:
                        out[dest[t][i]] = v[t][i]
            return out
        bufs = [[None] * per for _ in range(cluster)]
        for i in range(8):
            check_banks([dest[t][i] for t in range(T)])
            for t in range(T):
                if dest[t][i] is not None:
                    b, s = where(dest[t][i])
                    assert bufs[b][s] is None, "two writes to one slot in a pass"
                    bufs[b][s] = v[t][i]
        assert all(x is not None for buf in bufs for x in buf), "a slot left unwritten"
    return [v[0][0]]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(14))
def test_ntt_model_matches_jax_ntt_core(log_n, inverse):
    n = 1 << log_n
    rng = np.random.default_rng(1000 + 2 * log_n + inverse)
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]
    if n == 1:
        want = vals
    else:
        dom = JDOMAINS.get(n)       # the transform alone: 1/n is a scale, as in H3
        want = jints(JN._ntt_core_jit(jfrom(vals), dom["bitrev"],
                                      dom["inv_powers" if inverse else "fwd_powers"], None))
    tw = table_ints(DOMAINS.get(n, "cpu")["inv_powers" if inverse else "fwd_powers"])
    clusters = [c for c in (1, 2, 8) if max(n // 8, 1) % c == 0 and max(n // 8, 1) // c <= 512]
    planned = {K.ntt_plan(b, log_n, SMS)[1] for b in (1, 4096)}
    assert planned <= set(clusters)
    for cluster in clusters:
        assert ntt_model(vals, log_n, tw, cluster) == want, (log_n, inverse, cluster)


@pytest.mark.parametrize("batch,log_n,plan", [
    (1, 12, ("cluster", 8, False)),       # a sign's trace LDE, one column
    (2, 12, ("cluster", 8, False)),       # the sign's LDE, two columns
    (3, 13, ("cluster", 8, False)),
    (16, 10, ("cluster", 8, False)),      # 128 blocks: the last batch the cluster path takes
    (17, 10, ("persistent", 1, False)),
    (2, 9, ("persistent", 1, False)),     # under 1024 points a block is enough
    (1, 0, ("persistent", 1, False)),
    (4096, 12, ("persistent", 1, True)),  # the four-step's inner transforms at 2^24: staged
    (2048, 11, ("persistent", 1, False)), # ... and at 2^22: two blocks an SM
    (20, 13, ("persistent", 2, False)),   # 1024 threads a transform: two blocks
])
def test_ntt_plan_picks_the_path(batch, log_n, plan):
    assert K.ntt_plan(batch, log_n, SMS) == plan


def test_ntt_plan_launches_fit_the_card():
    for log_n in range(14):
        n = 1 << log_n
        threads = max(n // 8, 1)
        for batch in (1, 2, 3, 16, 17, 64, 4096):
            path, cluster, stage = K.ntt_plan(batch, log_n, SMS)
            assert threads % cluster == 0 and threads // cluster <= 512
            assert n // cluster * 16 + (32 * n if stage else 0) <= SMEM_MAX
            assert not stage or (cluster == 1 and n == K.NTT_STAGE)
            assert (path == "cluster") == (cluster == K.NTT_CLUSTER and batch * cluster <= SMS)


def test_twiddle_words_pack_and_cache():
    powers = DOMAINS.get(64, "cpu")["fwd_powers"].clone()
    words = K.twiddle_words(powers)
    assert words.shape == (64, 4) and words.dtype == torch.int32 and words.is_contiguous()
    assert K.twiddle_words(powers) is words
    limbs = powers.long() & 0xFFFF
    want = (limbs[0::2] | (limbs[1::2] << 16)).t()
    assert torch.equal(words.long() & 0xFFFFFFFF, want)
    powers[:, 1] = powers[:, 2]                  # changed in place: packed again
    again = K.twiddle_words(powers)
    assert again is not words and torch.equal(again[1], again[2])


# ---------------------------------------------------------------------------
# H4: the stages and tickets of one launch
# ---------------------------------------------------------------------------

def _compress_pairs(left, right):
    """Parents of (8, w) int64 digest columns left[:, i], right[:, i]."""
    m = [left[k] for k in range(8)] + [right[k] for k in range(8)]
    return torch.stack(MK.compress_plain(m, 64))


def tree_model(canon, seed, counters=None):
    """H4's flat tree as merkle_kernel builds it: the leaf blocks finish in
    a seeded order; each counts into its group's ticket, and the last of a
    group zeroes the ticket and runs the next stage from the nodes the
    group wrote.  ``counters``: the zeroed tickets, kept from an earlier
    launch (a list, left zeroed), or None for new ones."""
    n = canon.shape[-1]
    flat = torch.full((8, n), -1, dtype=torch.int64)
    leaves = MK.paired_leaves_plain(canon)
    stages = MK.tree_stages(n)
    if counters is None:
        counters = [0] * MK.tree_counters(n)
    assert counters == [0] * MK.tree_counters(n), "a launch started from used tickets"
    taken = []
    cnt_off = [0]
    for width, _, _ in stages[1:]:
        cnt_off.append(cnt_off[-1] + MK.stage_blocks(width))

    def run(stage, blk):
        width, off, levels = stages[stage]
        count = min(width, MK.TREE_THREADS)
        idx = blk * MK.TREE_THREADS + torch.arange(count)
        if stage == 0:
            d = leaves[:, idx]
            flat[:, off + idx] = d
            if blk == 0:
                flat[:, n - 1] = 0                      # the pad column
        else:
            d = flat[:, off + idx]
            assert bool((d >= 0).all()), "a stage read a node no block had written"
        lw, done = width, 0
        while done < levels and count > 32:             # through shared memory
            d = _compress_pairs(d[:, 0::2], d[:, 1::2])
            off, lw, count, done = off + lw, lw // 2, count // 2, done + 1
            flat[:, off + blk * count + torch.arange(count)] = d
        if done < levels:                               # inside warp 0: lane t holds node t
            lanes = torch.cat([d, d[:, :1].expand(8, 32 - count)], dim=1)
            lane = torch.arange(32)
            while done < levels:
                lanes = _compress_pairs(lanes[:, (2 * lane) & 31], lanes[:, (2 * lane + 1) & 31])
                off, lw, count, done = off + lw, lw // 2, count // 2, done + 1
                flat[:, off + blk * count + torch.arange(count)] = lanes[:, :count]
        return off

    order = list(range(MK.stage_blocks(n // 2)))
    random.Random(seed).shuffle(order)
    for blk in order:
        stage = 0
        while True:
            run(stage, blk)
            width = stages[stage][0]
            if width <= MK.TREE_THREADS:
                break
            blocks, levels = width // MK.TREE_THREADS, stages[stage][2]
            group, members = blk >> levels, min(blocks, 1 << levels)
            ticket = cnt_off[stage] + group
            counters[ticket] += 1
            if counters[ticket] < members:
                break
            counters[ticket] = 0                        # zeroed for the next launch
            taken.append(ticket)
            stage, blk = stage + 1, group
    assert sorted(taken) == list(range(len(counters))), "a ticket not taken exactly once"
    assert counters == [0] * len(counters), "a ticket left counted"
    assert bool((flat >= 0).all()), "a flat column left unwritten"
    return torch.where(flat >= 1 << 31, flat - (1 << 32), flat).to(torch.int32)


def _canon(n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 1 << 16, (8, n), dtype=np.int64).astype(np.int32))
    x[7] &= 0x3FFF                                       # every value below p
    return x


@pytest.mark.parametrize("log_n", [1, 2, 6, 9, 10, 12, 14])
def test_tree_model_matches_plain(log_n):
    canon = _canon(1 << log_n, 300 + log_n)
    counters = [0] * MK.tree_counters(1 << log_n)     # kept from one launch to the next
    for seed in (0, 1):
        assert torch.equal(tree_model(canon, seed, counters), MK.merkle_paired_plain(canon))


def test_tree_model_matches_jax_flat_tree():
    n = 1 << 12
    canon = _canon(n, 77)
    vals = [sum(int(canon[k, i]) << (16 * k) for k in range(8)) for i in range(n)]
    _, jflat = JD._commit_paired_core(jfrom(vals))
    want = torch.from_numpy(np.asarray(jflat).astype(np.uint32).view(np.int32).copy())
    assert torch.equal(tree_model(canon, 5)[:, : n - 1], want[:, : n - 1])


@pytest.mark.parametrize("n", [2, 4, 512, 1024, 4096, 1 << 22, 1 << 24])
def test_tree_counters_count_every_later_block(n):
    stages = MK.tree_stages(n)
    assert MK.tree_counters(n) == sum(max(1, w // 256) for w, _, _ in stages[1:])
    for (w, _, levels), (w2, _, _) in zip(stages, stages[1:]):
        assert levels == (MK.STAGE_LEVELS if w > MK.WIDE_STAGE else MK.TREE_LEVELS)
        assert w2 == w >> levels and MK.stage_blocks(w2) == max(1, MK.stage_blocks(w) >> levels)


# ---------------------------------------------------------------------------
# H5: the tile plan of one launch
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
MERKLE_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "stark_anatomy_tpu_torch", "csrc", "merkle.cu")


def _g(v, a, b, c, d, x, y):
    rotr = lambda w, n: ((w >> n) | (w << (32 - n))) & M32
    v[a] = (v[a] + v[b] + x) & M32
    v[d] = rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & M32
    v[b] = rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & M32
    v[d] = rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & M32
    v[b] = rotr(v[b] ^ v[c], 7)


def seed_prefix(key):
    """csrc/merkle.cu:seed_prefix: the state of a 40-byte compression of
    the seed after round 0's column step and three of its diagonal steps
    (message words 10-15 zero)."""
    v = list(MK._H) + list(MK._IV)
    v[12] ^= 40
    v[14] ^= M32
    m = list(key) + [0] * 8
    for a, b, c, d, i in ((0, 4, 8, 12, 0), (1, 5, 9, 13, 2), (2, 6, 10, 14, 4), (3, 7, 11, 15, 6),
                          (1, 6, 11, 12, 10), (2, 7, 8, 13, 12), (3, 4, 9, 14, 14)):
        _g(v, a, b, c, d, m[i], m[i + 1])
    return v


def seed_compress(prefix, key, ctr, tag):
    """csrc/merkle.cu:seed_compress: round 0's step on (0, 5, 10, 15), which
    reads the counter and the round tag, then rounds 1-9."""
    v = list(prefix)
    m = list(key) + [ctr, tag] + [0] * 6
    _g(v, 0, 5, 10, 15, m[8], m[9])
    for s in MK._SIGMA[1:]:
        for k, (a, b, c, d) in enumerate(((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
                                          (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))):
            _g(v, a, b, c, d, m[s[2 * k]], m[s[2 * k + 1]])
    return [MK._H[k] ^ v[k] ^ v[k + 8] for k in range(8)]


def _value(words):
    return sum(w << (32 * k) for k, w in enumerate(words))


def expand_tile_model(key, count, seed):
    """H5's plan: (canonical values, compressions, deepest round tag, the
    queue lengths of each tile by round).  Each block owns EXPAND_TILE
    counters; round 0 hashes all of them and keeps both candidates; a
    counter with a candidate >= p is queued with its mask (bit 0: element
    i, bit 1: element h + i), the warps arriving in a seeded order; each
    later round hashes the queue, keeps the candidates it accepts and
    queues the rest; then element i and h + i are written from the tile."""
    tile, half = MK.EXPAND_TILE, (count + 1) // 2
    prefix = seed_prefix(key)
    rng = random.Random(seed)
    values, compressions, depth, lengths = [None] * count, 0, 0, []
    for first in range(0, half, tile):
        n = min(tile, half - first)
        cand = [[None] * n, [None] * n]
        queue = []
        for c in range(n):
            d = seed_compress(prefix, key, first + c, 0)
            cand[0][c], cand[1][c] = d[:4], d[4:]
            pair = half + first + c < count
            need = (_value(d[:4]) >= P) | (2 if pair and _value(d[4:]) >= P else 0)
            if need:
                queue.append((c, need))
        compressions += n
        rounds, r = [n], 0
        while queue:
            r += 1
            rng.shuffle(queue)
            rounds.append(len(queue))
            compressions += len(queue)
            following = []
            for c, need in queue:
                assert need in (1, 2, 3) and (need < 2 or half + first + c < count)
                d = seed_compress(prefix, key, first + c, r)
                for e in (0, 1):
                    if need >> e & 1 and _value(d[4 * e:4 * e + 4]) < P:
                        cand[e][c] = d[4 * e:4 * e + 4]
                        need &= ~(1 << e)
                if need:
                    following.append((c, need))
            queue = following
        depth, lengths = max(depth, r), lengths + [rounds]
        for c in range(n):
            values[first + c] = _value(cand[0][c])
            if half + first + c < count:
                values[half + first + c] = _value(cand[1][c])
    assert all(v is not None and v < P for v in values)
    return values, compressions, depth, lengths


def _seed(k):
    return hashlib.blake2s(b"tile model seed %d" % k).digest()


def test_expand_tile_matches_the_source():
    text = open(MERKLE_CU).read()
    assert int(re.search(r"constexpr int kExpandTile = (\d+);", text).group(1)) == MK.EXPAND_TILE


@pytest.mark.parametrize("ctr,tag", [(0, 0), (1, 0), (5, 3), (0xFFFFFFFF, 7), (123456, 0xFFFFFFFF)])
def test_seed_compress_split_equals_blake2s(ctr, tag):
    seed = _seed(ctr % 5)
    key = list(np.frombuffer(seed, dtype="<u4").astype(int))
    got = seed_compress(seed_prefix(key), key, ctr, tag)
    msg = seed + ctr.to_bytes(4, "little") + tag.to_bytes(4, "little")
    assert bytes(np.array(got, dtype="<u4").tobytes()) == hashlib.blake2s(msg).digest()


T = MK.EXPAND_TILE


@pytest.mark.parametrize("count", [1, 2, 3, T - 1, T + 1, 2 * T - 1, 2 * T, 2 * T + 1, 2 * T + 2, 4097])
def test_expand_tile_model_matches_jax_and_plain(count):
    seed = _seed(count)
    key = [int(w) for w in np.frombuffer(seed, dtype="<u4")]
    values, compressions, depth, lengths = expand_tile_model(key, count, count)
    want = jints(JR.seed_expand_mont(count, seed))
    assert values == want
    words = torch.from_numpy(np.frombuffer(seed, dtype="<u4").view(np.int32).copy())
    rounds = []
    got = MK.seed_expand_plain(words, count, rounds)
    assert compressions == rounds[0]
    assert tints(got) == values
    # each round's queue is no longer than the one before, and the tiles
    # cover the counters
    assert sum(r[0] for r in lengths) == (count + 1) // 2
    for r in lengths:
        assert all(a >= b for a, b in zip(r[1:], r[2:]))
    if count == 4097:
        assert depth >= 3, "pick a seed for which some counter reaches round 3"
