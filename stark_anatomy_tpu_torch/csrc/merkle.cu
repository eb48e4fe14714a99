// H4 stark_merkle: the blake2s-256 Merkle tree of a codeword, on Hopper.
// H5 stark_seed_expand: field elements from a 32-byte seed by blake2s in
// counter mode, with rejection sampling, in Montgomery form.
//
// Replaces the JAX package's jnp blake2s graphs K11,
// stark_anatomy_tpu/commit/device_merkle.py: _compress_words (one
// blake2s-256 compression), _paired_leaf_digests (leaf i = H(LE16(c[i]) ||
// LE16(c[i + n/2]))), _parent_level and _flat_tree_core (every level of
// the tree in one flat array).  The Montgomery-to-canonical step of
// _commit_paired_core stays an H0 launch (field/ops.py:from_mont): H4
// hashes canonical limbs, it does not convert them.
//
// Layout: the input is canonical limbs, contiguous (batch, 8, n) int32
// lanes holding 16-bit limbs, n a power of two >= 2.  The output is the
// reference's flat tree, contiguous (batch, 8, n) u32 digest words: the
// h = n/2 paired leaves in columns [0, h), each parent level after the
// one below it (level l at columns off(l) = 2h - 2h/2^l), the root in
// column n - 2 and a zero pad in column n - 1.  Word k of a digest is
// little-endian bytes 4k..4k+3 of the hashlib digest.
//
// Design: one blake2s compression per thread, 256 threads a block, the
// whole tree (and R trees, on the grid's y axis) in one launch.
//   * Stage 0: thread t of block b hashes paired leaf i = 256 b + t (it
//     packs the two elements' limbs into message words 0-7; words 8-15
//     are zero, and the compression skips their adds, t = 32 bytes).
//   * A wide stage (more than 8 blocks) takes each block's 256 nodes up
//     kStageLevels = 3 levels through shared memory (8 words x 256 x 4 B
//     = 8 KiB), 128, 64 and 32 parents: every level in full warps.  The
//     first design went up 8 levels a block, the last five in part of one
//     warp: 20 warp-compressions for 511 nodes, where these take 15 for
//     480.  A narrow stage (8 blocks or fewer, where the tree's latency
//     and not the SMs' issue decides) goes up 8 levels a block, as before.
//   * Then a last-block-done ticket: each block fences its nodes and adds
//     one to its group's counter (a group is the 2^levels blocks whose
//     outputs are one block's 256 inputs); the last of the group to
//     arrive runs the next stage from those nodes (read through L2,
//     __ldcg).  The stage that starts from 256 nodes or fewer reduces
//     them to the root; its levels of 32 nodes and fewer run inside warp 0
//     by __shfl_sync of the 8 words, with no block barrier.  So the tail
//     passes of the first design (at 2^24 a pass on 128 blocks and one on
//     a single block) are gone, and a tree is one launch.  The counters,
//     one for each block of each stage after the first, start at zero
//     (the wrapper allocates them zeroed once per device, stream and size
//     and keeps them, commit/kernels.py:tree_counters), and the last block
//     of each group zeroes its counter again as it takes its ticket, so a
//     commit is this one launch.
//   * The 10 rounds are written out with literal SIGMA indices, so the 16
//     message words stay in registers (a SIGMA table read at run time
//     would put them in local memory).
// What bounds it: the compression's integer instructions.  A G step is
// 12 of them (two three-input adds, two adds, four xors, four rotations),
// 8 G a round, 10 rounds: about 960 a compression, one compression per
// tree node, against 32 bytes read per element and 32 written per
// column.  The SASS of the first design (tools/sass_count.py) ran, a
// compression, 332 LOP3 (the xors), 320 SHF (the rotations, funnel
// shifts) and 148 IADD3 on the integer pipe and 196 IMAD.IADD on the FMA
// pipe; an H100 SM partition issues one warp instruction a cycle but each
// of those pipes takes half a warp a cycle, so the integer pipe's 800
// instructions (1600 cycles a warp) set the pace, not the 983 issued.
// Builds that moved the adds to the FMA pipe (products by a one the
// compiler cannot see through), also the rotations by 16 and 8 (both
// halves of a product by 2^16 or 2^24), or those rotations to byte
// permutes measured no gain on the card (PERF.md), so the integer pipe is
// not the limit, and the plain adds and funnel shifts stay.  At 2^24 the kernel runs at
// 2.2x the issue bound with 24 warps an SM (80 registers a thread), each
// compression a chain of four independent G steps; the stall reasons are
// not measured (PERF.md).
// H5 replaces the jnp graph stark_anatomy_tpu/utils/rand.py:_expand_impl
// (seed_expand_mont, bulk_random_mont), bit for bit.  Digest i is the
// blake2s-256 of the 40-byte message (the 8 seed words, counter i, round
// tag r); with h = ceil(count / 2), its words 0-3 and 4-7 are the
// candidates (little-endian 128-bit) for elements i and h + i (the
// reference's reshape of the (4, 2, h) word stack; its comment says 2i
// and 2i + 1, its code gives i and h + i).  A candidate >= p is redrawn
// with the next round tag, and element j keeps the candidate of the first
// round in which it is below p, as the reference's while_loop does.
// P[candidate >= p] = 1 - p/2^128 = 0.2051, so a counter needs 1.472
// compressions on average.  What bounds it: those compressions'
// instructions; the 32 bytes written per element are a few percent.
// Design (one counter a thread, round after round, would keep a warp
// until its slowest counter is done: 3.50 compressions of time for 1.47
// of work, 42% of the lanes busy):
//   * a tile of kExpandTile = 1024 counters a block of 256 threads.
//     Round 0 hashes the whole tile in full warps, 4 counters a thread,
//     and keeps both candidates in shared memory (2 x 1024 x 16 B = 32
//     KiB).  A counter with a candidate >= p goes into a shared queue
//     with a 2-bit mask of its elements still needed, by warp ballot and
//     one shared atomic a warp.  Round r hashes only the queued counters,
//     again in full warps, and queues what is still needed into the
//     other buffer.  Expected queue lengths: 1024, 377, 84, 18, 4, 1,
//     about 50 warp-compressions where the work needs 47; the resident
//     blocks (41 KiB of shared memory, 45 registers a thread: 5 an SM)
//     fill the SM in the short tail rounds.  On an H100 a tile of 1024
//     took 0.196 ms at 2^22 elements, 512 0.202 and 256 0.218 (a probe
//     that timed the three, PERF.md); one counter a thread took 0.369
//     (tools/port_compare.py).
//   * Then the block converts its 2 x 1024 elements to Montgomery form
//     (a product with R^2 mod p) and writes two runs of (8, tile) limbs,
//     [1024 b, 1024 b + tile) and h + the same, coalesced; nothing is
//     stored from the scattered queue.
//   * Round 0's column step reads only the seed, and three of its four
//     diagonal steps zero message words of state the counter has not
//     reached, so 7 of round 0's 8 G steps are the same for every
//     counter and round tag: thread 0 computes them once (seed_prefix)
//     into shared memory, and each compression starts there with round
//     0's last step (4 shared loads).  nvcc had hoisted them out of the
//     one-counter loop by itself, their 16 state words in registers;
//     here they cost no registers (45 a thread, 5 blocks an SM).
//     Whether nvcc would hoist them out of this design's two loops, and
//     at what cost in registers, is not measured.  In SASS a
//     compression is about 900 instructions either way (LOP3 306, SHF
//     292, IMAD 220, IADD3 83, against the model's 960 with nothing
//     hoisted), and the queue adds about 80 (tools/sass_count.py).  The
//     six zero words' adds are left out too (MX), which saves operands,
//     not instructions (an IADD3 adds three inputs or two).
// The bound (chip_smoke.py) counts the work this design does, at the full
// issue rate: the compressions the plain version counts, each the model's
// 960 instructions less the 7 hoisted G steps' 84 (876), and one prefix
// (84) a block.

#include <cstdint>
#include <cuda_runtime.h>

#include "field_arith.cuh"

namespace {

constexpr int kTreeThreads = 256;
constexpr int kStageLevels = 3;      // levels a block of a wide stage reduces in full warps: 256 -> 32
constexpr int64_t kWideStage = 2048; // a stage from more nodes than this (more than 8 blocks) is wide
constexpr int kTreeLevels = 8;       // levels a block of a narrow stage reduces: 256 -> 1
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

constexpr uint32_t kIV0 = 0x6a09e667u, kIV1 = 0xbb67ae85u, kIV2 = 0x3c6ef372u,
                   kIV3 = 0xa54ff53au, kIV4 = 0x510e527fu, kIV5 = 0x9b05688cu,
                   kIV6 = 0x1f83d9abu, kIV7 = 0x5be0cd19u;
constexpr uint32_t kH0 = kIV0 ^ 0x01010020u;   // digest length 32, fanout 1, depth 1

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// MX(s): the add of message word s, or none where word s is known to be
// zero when the code is written out (s >= kWords: words 8-15 of a 32-byte
// leaf, 10-15 of H5's 40-byte message).  In SASS a three-input add is one
// IADD3 either way, so this saves operands, not instructions.
#define MX(a, b, s) ((s) >= kWords ? (a) + (b) : (a) + (b) + m[s])

#define G(a, b, c, d, x, y)     \
  v[a] = MX(v[a], v[b], x);     \
  v[d] = rotr(v[d] ^ v[a], 16); \
  v[c] = v[c] + v[d];           \
  v[b] = rotr(v[b] ^ v[c], 12); \
  v[a] = MX(v[a], v[b], y);     \
  v[d] = rotr(v[d] ^ v[a], 8);  \
  v[c] = v[c] + v[d];           \
  v[b] = rotr(v[b] ^ v[c], 7);

// A round: the column step (G on columns 0-3, message words s0-s7), then
// the diagonal step (s8-s15).
#define COLUMNS(s0, s1, s2, s3, s4, s5, s6, s7) \
  G(0, 4, 8, 12, s0, s1)                        \
  G(1, 5, 9, 13, s2, s3)                        \
  G(2, 6, 10, 14, s4, s5)                       \
  G(3, 7, 11, 15, s6, s7)

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  COLUMNS(s0, s1, s2, s3, s4, s5, s6, s7)                                           \
  G(0, 5, 10, 15, s8, s9)                                                           \
  G(1, 6, 11, 12, s10, s11)                                                         \
  G(2, 7, 8, 13, s12, s13)                                                          \
  G(3, 4, 9, 14, s14, s15)

// Rounds 1-9, after round 0 (whose SIGMA is the identity).
#define ROUNDS_1_TO_9                                          \
  ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3) \
  ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4) \
  ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8) \
  ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13) \
  ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9) \
  ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11) \
  ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10) \
  ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5) \
  ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)

// The first state of a final compression of t bytes, from the initial
// chain value.
__device__ __forceinline__ void init_state(uint32_t t, uint32_t v[16]) {
  const uint32_t v0[16] = {kH0,  kIV1, kIV2, kIV3, kIV4,     kIV5, kIV6,  kIV7,
                           kIV0, kIV1, kIV2, kIV3, kIV4 ^ t, kIV5, ~kIV6, kIV7};
#pragma unroll
  for (int i = 0; i < 16; i++) v[i] = v0[i];
}

// The 8 digest words from the state after round 9.
__device__ __forceinline__ void finish(const uint32_t v[16], uint32_t out[8]) {
  const uint32_t h[8] = {kH0, kIV1, kIV2, kIV3, kIV4, kIV5, kIV6, kIV7};
#pragma unroll
  for (int i = 0; i < 8; i++) out[i] = h[i] ^ v[i] ^ v[i + 8];
}

// One final blake2s-256 compression of the message m (16 words, t bytes
// <= 64) from the initial chain value: the 8 digest words.  Message words
// kWords..15 are zero and are not added.
template <int kWords>
__device__ __forceinline__ void compress(const uint32_t m[16], uint32_t t, uint32_t out[8]) {
  uint32_t v[16];
  init_state(t, v);
  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  ROUNDS_1_TO_9
  finish(v, out);
}

// The tree of codeword blockIdx.y in one launch.  Stage 0: block b hashes
// paired leaves [256 b, 256 b + 256) (all of them when there are fewer)
// and reduces them kStageLevels levels (in full warps: 128, 64 and 32
// parents) through shared memory, writing every level into its columns
// of the flat array.  Then a last-block-done ticket: the block counts
// itself in its group of kGroup blocks (a counter a group, in counters),
// and the last of the group reduces the group's 256 outputs by the next
// kStageLevels levels, and so on up; the block that takes a level of 256
// nodes or fewer reduces it to the root, its levels of 32 nodes and fewer
// inside warp 0 by shuffles, with no block barrier.  counters: per
// codeword, one zeroed counter for each block of each stage after the
// first (commit/kernels.py:tree_stages gives the stages), left zeroed.
__global__ void __launch_bounds__(kTreeThreads)
merkle_kernel(uint32_t* __restrict__ flat, const uint32_t* __restrict__ canon,
              unsigned* __restrict__ counters, int64_t n, int64_t n_counters) {
  __shared__ uint32_t s[8][kTreeThreads];
  __shared__ int last;
  const int t = threadIdx.x;
  const int64_t row = blockIdx.y;
  uint32_t* f = flat + row * 8 * n;
  unsigned* cnt = counters + row * n_counters;
  int64_t width = n / 2;             // nodes of the level this stage starts from
  int64_t off = 0;                   // its first flat column
  int64_t blk = blockIdx.x;          // this block's place in the stage
  int64_t cnt_off = 0;               // the next stage's first counter
  for (bool leaves = true;; leaves = false) {
    int count = width < kTreeThreads ? static_cast<int>(width) : kTreeThreads;
    const int levels = width > kWideStage ? kStageLevels
                       : (width > kTreeThreads ? kTreeLevels : 63 - __clzll(width));
    const int64_t i = blk * kTreeThreads + t;
    uint32_t d[8];
    if (t < count) {
      if (leaves) {
        const uint32_t* c = canon + row * 8 * n;
        uint32_t m[16];
#pragma unroll
        for (int q = 0; q < 4; q++) {
          m[q] = (__ldg(c + 2 * q * n + i) & 0xffffu) | (__ldg(c + (2 * q + 1) * n + i) << 16);
          m[4 + q] = (__ldg(c + 2 * q * n + i + width) & 0xffffu) |
                     (__ldg(c + (2 * q + 1) * n + i + width) << 16);
        }
#pragma unroll
        for (int q = 8; q < 16; q++) m[q] = 0;
        compress<8>(m, 32, d);
#pragma unroll
        for (int q = 0; q < 8; q++) f[q * n + i] = d[q];
        if (i == 0) {
#pragma unroll
          for (int q = 0; q < 8; q++) f[q * n + n - 1] = 0;   // the pad column
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; q++) d[q] = __ldcg(f + q * n + off + i);   // other blocks' nodes
      }
#pragma unroll
      for (int q = 0; q < 8; q++) s[q][t] = d[q];
    }
    int64_t lw = width;              // width of the level just written
    int done = 0;
    // levels of more than 32 nodes: through shared memory, full warps
    for (; done < levels && count > 32; done++) {
      off += lw;
      lw >>= 1;
      count >>= 1;
      __syncthreads();               // the level below is in s
      uint32_t m[16];
      if (t < count) {
#pragma unroll
        for (int q = 0; q < 8; q++) {
          m[q] = s[q][2 * t];
          m[8 + q] = s[q][2 * t + 1];
        }
      }
      __syncthreads();               // every child read before any parent lands
      if (t < count) {
        compress<16>(m, 64, d);
        const int64_t j = blk * count + t;
#pragma unroll
        for (int q = 0; q < 8; q++) {
          s[q][t] = d[q];
          f[q * n + off + j] = d[q];
        }
      }
    }
    // levels of 32 nodes and fewer: inside warp 0, node t in lane t (the
    // other warps only step the level past them)
    if (done < levels) {
      __syncthreads();
      if (t < 32) {
        int64_t o = off, w = lw;
        int c = count;
#pragma unroll
        for (int q = 0; q < 8; q++) d[q] = s[q][t < c ? t : 0];
        for (int l = done; l < levels; l++) {
          o += w;
          w >>= 1;
          c >>= 1;
          uint32_t m[16];
#pragma unroll
          for (int q = 0; q < 8; q++) {
            m[q] = __shfl_sync(kFullWarp, d[q], (2 * t) & 31);
            m[8 + q] = __shfl_sync(kFullWarp, d[q], (2 * t + 1) & 31);
          }
          compress<16>(m, 64, d);
          if (t < c) {
            const int64_t j = blk * c + t;
#pragma unroll
            for (int q = 0; q < 8; q++) f[q * n + o + j] = d[q];
          }
        }
      }
      for (; done < levels; done++) {
        off += lw;
        lw >>= 1;
      }
    }
    if (width <= kTreeThreads) return;   // this block wrote the root
    // the next stage: the last block of each group of 2^levels blocks
    // (whose outputs make 256 nodes) takes it
    const int64_t blocks = width / kTreeThreads;
    const int64_t group = blk >> levels;
    const int members = blocks < (int64_t(1) << levels) ? static_cast<int>(blocks) : 1 << levels;
    __threadfence();                 // this block's nodes, before its ticket
    __syncthreads();
    if (t == 0) {
      unsigned* ticket = cnt + cnt_off + group;
      last = atomicAdd(ticket, 1u) == static_cast<unsigned>(members - 1);
      if (last) *ticket = 0;         // every member has counted: zero for the next launch
      __threadfence();
    }
    __syncthreads();
    if (!last) return;
    cnt_off += (blocks >> levels) > 0 ? (blocks >> levels) : 1;
    width = lw;                      // the level just written (at column off) starts the next stage
    blk = group;
  }
}

constexpr int kExpandThreads = 256;
constexpr int kExpandTile = 1024;    // counters a block (commit/kernels.py:EXPAND_TILE)
constexpr int kSeedWords = 10;       // nonzero words of H5's message: the seed, i, the round tag
constexpr int kSeedBytes = 40;

// R^2 mod p = 2^256 mod p in 32-bit words: the product with it puts a
// canonical value in Montgomery form.
__device__ __forceinline__ uint32_t r2_word(int k) {
  return k == 0 ? 0x0E778236u : (k == 1 ? 0x5BD53A7Fu : (k == 2 ? 0x1A6AEDC2u : 0xAAF4AD9Au));
}

// w (four words, least significant first) < p = kP3 * 2^96 + 1.
__device__ __forceinline__ bool below_p(const uint32_t w[4]) {
  return w[3] < kP3 || (w[3] == kP3 && (w[0] | w[1] | w[2]) == 0u);
}

// The state of every H5 compression of one seed after round 0, but for
// round 0's G step on (0, 5, 10, 15): that step is the only one of the
// round that reads message words 8 and 9 (the counter and the round tag);
// the column step reads the seed (words 0-7) and the other three diagonal
// steps zero words, on state words the counter has not reached (the four
// diagonal steps write disjoint words, so their order is free).  m: the
// message, the seed in words 0-7.
__device__ __forceinline__ void seed_prefix(const uint32_t m[16], uint32_t v[16]) {
  constexpr int kWords = kSeedWords;
  init_state(kSeedBytes, v);
  COLUMNS(0, 1, 2, 3, 4, 5, 6, 7)
  G(1, 6, 11, 12, 10, 11)
  G(2, 7, 8, 13, 12, 13)
  G(3, 4, 9, 14, 14, 15)
}

// The digest of H5's message m (the seed, counter m[8], round tag m[9])
// from the state seed_prefix left: round 0's last step, then rounds 1-9.
__device__ __forceinline__ void seed_compress(const uint4 prefix[4], const uint32_t m[16],
                                              uint32_t out[8]) {
  constexpr int kWords = kSeedWords;
  uint32_t v[16];
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const uint4 w = prefix[q];
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
  G(0, 5, 10, 15, 8, 9)
  ROUNDS_1_TO_9
  finish(v, out);
}

// Element j of out (8, count) from its canonical words w, in Montgomery
// form (the product with R^2).
__device__ __forceinline__ void store_mont(int32_t* out, int64_t j, int64_t count, const uint4& w,
                                           const uint32_t r2[4]) {
  uint32_t v[4] = {w.x, w.y, w.z, w.w};
  mont_mul_words(v, r2, v);
  store4(out, 0, j, count, v);
}

// Appends c | need << 16 to the shared queue q of length *len where
// need != 0: one shared atomic a warp (its lowest such lane adds the
// warp's count), each lane at its place among the warp's entries.  Every
// lane of the warp calls it.  The entries' order is the warps' order of
// arrival, on which nothing depends.
__device__ __forceinline__ void enqueue(uint32_t* q, int* len, int c, unsigned need) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(kFullWarp, need != 0);
  if (ballot == 0) return;
  const int leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == static_cast<unsigned>(leader)) base = atomicAdd(len, __popc(ballot));
  base = __shfl_sync(kFullWarp, base, leader);
  if (need) q[base + __popc(ballot & ((1u << lane) - 1u))] = static_cast<uint32_t>(c) | (need << 16);
}

// out: (8, count) Montgomery elements; seed: the 8 seed words.  Block b
// owns counters [kExpandTile b, kExpandTile b + tile): round 0 hashes all
// of them in full warps (kExpandTile / kExpandThreads a thread) and keeps
// both candidates in shared memory; a counter with a candidate >= p goes
// into a shared queue with the mask of its elements still needed (bit 0:
// element i, bit 1: element h + i).  Round r hashes only the counters round r - 1 queued, in
// full warps, overwrites the candidates it accepts and queues what is
// still needed into the other buffer, until a round queues nothing.  Then
// the block converts its elements to Montgomery form and writes them as
// two coalesced runs, [first, first + tile) and h + the same.
__global__ void __launch_bounds__(kExpandThreads)
seed_expand_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ seed,
                   int64_t count) {
  constexpr int kPer = kExpandTile / kExpandThreads;
  __shared__ uint4 cand[2][kExpandTile];       // the candidates of elements i and h + i
  __shared__ uint32_t queue[2][kExpandTile];   // c | need << 16, c the counter's place in the tile
  __shared__ int qlen[3];                      // the length of round r's queue: qlen[r % 3]
  __shared__ uint4 prefix[4];
  const int t = threadIdx.x;
  const int64_t half = (count + 1) / 2;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kExpandTile;
  const int tile = half - first < kExpandTile ? static_cast<int>(half - first) : kExpandTile;
  uint32_t m[16];
#pragma unroll
  for (int k = 0; k < 8; k++) m[k] = static_cast<uint32_t>(seed[k]);
#pragma unroll
  for (int k = 8; k < 16; k++) m[k] = 0;
  if (t == 0) {
    uint32_t v[16];
    seed_prefix(m, v);
#pragma unroll
    for (int q = 0; q < 4; q++) prefix[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    qlen[0] = 0;
  }
  __syncthreads();
  // round 0: every counter of the tile
#pragma unroll 1
  for (int k = 0; k < kPer; k++) {
    const int c = t + k * kExpandThreads;
    unsigned need = 0;
    if (c < tile) {
      m[8] = static_cast<uint32_t>(first + c);
      m[9] = 0;
      uint32_t d[8];
      seed_compress(prefix, m, d);
      cand[0][c] = make_uint4(d[0], d[1], d[2], d[3]);
      cand[1][c] = make_uint4(d[4], d[5], d[6], d[7]);
      const bool pair = half + first + c < count;
      need = (below_p(d) ? 0u : 1u) | (pair && !below_p(d + 4) ? 2u : 0u);
    }
    enqueue(queue[0], &qlen[0], c, need);
  }
  if (t == 0) qlen[1] = 0;
  __syncthreads();
  // round r: the counters round r - 1 queued
  for (uint32_t r = 1;; r++) {
    const int n = qlen[(r - 1) % 3];
    if (n == 0) break;
    if (t == 0) qlen[(r + 1) % 3] = 0;   // round r + 1's queue, read last in round r - 1
    const uint32_t* in = queue[(r - 1) & 1];
    uint32_t* next = queue[r & 1];
    for (int j0 = 0; j0 < n; j0 += kExpandThreads) {
      const int j = j0 + t;
      unsigned need = 0;
      int c = 0;
      if (j < n) {
        const uint32_t e = in[j];
        c = static_cast<int>(e & 0xFFFFu);
        need = e >> 16;
        m[8] = static_cast<uint32_t>(first + c);
        m[9] = r;
        uint32_t d[8];
        seed_compress(prefix, m, d);
        if ((need & 1u) && below_p(d)) {
          cand[0][c] = make_uint4(d[0], d[1], d[2], d[3]);
          need &= ~1u;
        }
        if ((need & 2u) && below_p(d + 4)) {
          cand[1][c] = make_uint4(d[4], d[5], d[6], d[7]);
          need &= ~2u;
        }
      }
      enqueue(next, &qlen[r % 3], c, need);
    }
    __syncthreads();
  }
  // Montgomery form, and the two runs
  uint32_t r2[4];
#pragma unroll
  for (int k = 0; k < 4; k++) r2[k] = r2_word(k);
#pragma unroll 1
  for (int k = 0; k < kPer; k++) {
    const int c = t + k * kExpandThreads;
    if (c >= tile) break;
    const int64_t i = first + c;
    store_mont(out, i, count, cand[0][c], r2);
    if (half + i < count) store_mont(out, half + i, count, cand[1][c], r2);
  }
}

}  // namespace

extern "C" {

// H4 over `batch` codewords in one launch: canon (batch, 8, n) canonical
// limbs, flat (batch, 8, n) the tree, counters (batch, n_counters) zeroed
// unsigned ints, zeroed again when the launch ends, n_counters the
// tickets of one tree (a counter for each block of each stage after the
// first).
int stark_merkle(void* flat, const void* canon, void* counters, int64_t batch, int64_t n,
                 int64_t n_counters, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  const int64_t blocks = n / 2 > kTreeThreads ? n / 2 / kTreeThreads : 1;
  if (n < 2 || (n & (n - 1)) || blocks > 0x7FFFFFFF || batch > 65535 || n_counters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  merkle_kernel<<<grid, kTreeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(flat), static_cast<const uint32_t*>(canon),
      static_cast<unsigned*>(counters), n, n_counters);
  return static_cast<int>(cudaGetLastError());
}

// H5: out contiguous (8, count) int32, seed 8 int32 words, both on the
// card; 1 <= count <= 2^32 (the counters are 32-bit, as in the reference).
int stark_seed_expand(void* out, const void* seed, int64_t count, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count < 1 || count > (int64_t(1) << 32)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = ((count + 1) / 2 + kExpandTile - 1) / kExpandTile;   // at most 2^21
  seed_expand_kernel<<<static_cast<unsigned>(blocks), kExpandThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(seed), count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
