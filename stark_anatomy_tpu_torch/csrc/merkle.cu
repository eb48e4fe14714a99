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
// and 2i + 1, its code gives i and h + i).  A candidate >= p is redrawn with the next
// round tag, and element j keeps the candidate of the first round in
// which it is below p, as the reference's while_loop does.  So one thread
// runs counter i: it hashes round after round until both its elements
// are accepted (P[candidate >= p] is about 0.205, so mostly one or two
// compressions), converts them to Montgomery form (a product with
// R^2 mod p) and writes them, all in one launch.  It shares compress()
// with H4.  What bounds it: the compressions' instructions, about 960
// each; the 32 bytes written per element are a few percent of that time.
// A warp runs until its slowest thread is done, so a warp of 64 elements
// takes about 3-4 compressions where the average element needs 1.3.

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

// MX(s): the add of message word s, or none for a zero word of the leaf
// (words 8-15 of a 32-byte message), known when the code is written out.
#define MX(a, b, s) (kLeaf && (s) >= 8 ? (a) + (b) : (a) + (b) + m[s])

#define G(a, b, c, d, x, y)     \
  v[a] = MX(v[a], v[b], x);     \
  v[d] = rotr(v[d] ^ v[a], 16); \
  v[c] = v[c] + v[d];           \
  v[b] = rotr(v[b] ^ v[c], 12); \
  v[a] = MX(v[a], v[b], y);     \
  v[d] = rotr(v[d] ^ v[a], 8);  \
  v[c] = v[c] + v[d];           \
  v[b] = rotr(v[b] ^ v[c], 7);

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  G(0, 4, 8, 12, s0, s1)                                                            \
  G(1, 5, 9, 13, s2, s3)                                                            \
  G(2, 6, 10, 14, s4, s5)                                                           \
  G(3, 7, 11, 15, s6, s7)                                                           \
  G(0, 5, 10, 15, s8, s9)                                                           \
  G(1, 6, 11, 12, s10, s11)                                                         \
  G(2, 7, 8, 13, s12, s13)                                                          \
  G(3, 4, 9, 14, s14, s15)

// One final blake2s-256 compression of the message m (16 words, t bytes
// <= 64) from the initial chain value: the 8 digest words.  kLeaf: words
// 8-15 are zero and are not added.
template <bool kLeaf>
__device__ __forceinline__ void compress(const uint32_t m[16], uint32_t t, uint32_t out[8]) {
  uint32_t v[16] = {kH0,  kIV1, kIV2,     kIV3,  kIV4, kIV5, kIV6, kIV7,
                    kIV0, kIV1, kIV2,     kIV3,  kIV4 ^ t, kIV5, ~kIV6, kIV7};
  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  const uint32_t h[8] = {kH0, kIV1, kIV2, kIV3, kIV4, kIV5, kIV6, kIV7};
#pragma unroll
  for (int i = 0; i < 8; i++) out[i] = h[i] ^ v[i] ^ v[i + 8];
}

#undef ROUND
#undef G
#undef MX

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
        compress<true>(m, 32, d);
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
        compress<false>(m, 64, d);
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
          compress<false>(m, 64, d);
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

// R^2 mod p = 2^256 mod p in 32-bit words: the product with it puts a
// canonical value in Montgomery form.
__device__ __forceinline__ uint32_t r2_word(int k) {
  return k == 0 ? 0x0E778236u : (k == 1 ? 0x5BD53A7Fu : (k == 2 ? 0x1A6AEDC2u : 0xAAF4AD9Au));
}

// w (four words, least significant first) < p = kP3 * 2^96 + 1.
__device__ __forceinline__ bool below_p(const uint32_t w[4]) {
  return w[3] < kP3 || (w[3] == kP3 && (w[0] | w[1] | w[2]) == 0u);
}

// out: (8, count) Montgomery elements; seed: the 8 seed words.
__global__ void __launch_bounds__(kExpandThreads)
seed_expand_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ seed,
                   int64_t count) {
  const int64_t half = (count + 1) / 2;
  uint32_t key[8];
#pragma unroll
  for (int k = 0; k < 8; k++) key[k] = static_cast<uint32_t>(seed[k]);
  uint32_t r2[4];
#pragma unroll
  for (int k = 0; k < 4; k++) r2[k] = r2_word(k);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < half;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint32_t m[16];
#pragma unroll
    for (int k = 0; k < 8; k++) m[k] = key[k];
    m[8] = static_cast<uint32_t>(i);
#pragma unroll
    for (int k = 10; k < 16; k++) m[k] = 0;
    const bool pair = half + i < count;
    bool need0 = true, need1 = pair;
    uint32_t v0[4] = {0, 0, 0, 0}, v1[4] = {0, 0, 0, 0};
    for (uint32_t r = 0; need0 || need1; r++) {
      m[9] = r;
      uint32_t d[8];
      compress<false>(m, 40, d);
      if (need0 && below_p(d)) {
#pragma unroll
        for (int k = 0; k < 4; k++) v0[k] = d[k];
        need0 = false;
      }
      if (need1 && below_p(d + 4)) {
#pragma unroll
        for (int k = 0; k < 4; k++) v1[k] = d[4 + k];
        need1 = false;
      }
    }
    mont_mul_words(v0, r2, v0);
    store4(out, 0, i, count, v0);
    if (pair) {
      mont_mul_words(v1, r2, v1);
      store4(out, 0, half + i, count, v1);
    }
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
  int64_t blocks = ((count + 1) / 2 + kExpandThreads - 1) / kExpandThreads;
  if (blocks > (1 << 30)) blocks = 1 << 30;   // the grid-stride loop covers the rest
  seed_expand_kernel<<<static_cast<unsigned>(blocks), kExpandThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(seed), count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
