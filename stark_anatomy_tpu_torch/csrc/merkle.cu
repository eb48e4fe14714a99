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
// Design: one blake2s compression per thread, 256 threads a block.
//   * The first pass (leaves != 0) gives thread t of block b paired leaf
//     i = 256 b + t: it packs the two elements' limbs into message words
//     0-7 (words 8-15 are zero, t = 32 bytes) and hashes them.  A later
//     pass loads one digest of the level its pass starts from instead.
//   * Then the block reduces its 256 digests (or the whole level, when it
//     is narrower) through up to 8 levels in shared memory, 8 words x 256
//     x 4 B = 8 KiB, one parent (t = 64 bytes) per thread per level,
//     writing every level into its columns of the flat array.  The loop
//     count is the same for every thread of the block, and threads
//     without a node still reach each __syncthreads().
//   * The wrapper (commit/kernels.py:merkle_paired) launches passes of up
//     to 8 levels until one digest is left: n = 4096 takes 2 launches,
//     n = 2^22 (2^21 leaves) 3.  Leading axes (R codewords) are the
//     grid's y axis, so R trees take the same launches as one.
//   * The 10 rounds are written out with literal SIGMA indices, so the 16
//     message words stay in registers (a SIGMA table read at run time
//     would put them in local memory); rotations are funnel shifts.
// What bounds it: the compression's integer instructions.  A G step is
// 12 of them (two three-input adds, two adds, four xors, four rotations),
// 8 G a round, 10 rounds: about 960 a compression and one compression per
// tree node, 2^22 - 1 of them at n = 2^22, against 32 bytes read per
// element and 32 bytes written per column.  So the tree levels stay in
// shared memory (each digest is written once and never read back from
// device memory within a pass) and every thread of a live level hashes.
//
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
constexpr int kTreeLevels = 8;       // log2(kTreeThreads): levels one pass reduces

constexpr uint32_t kIV0 = 0x6a09e667u, kIV1 = 0xbb67ae85u, kIV2 = 0x3c6ef372u,
                   kIV3 = 0xa54ff53au, kIV4 = 0x510e527fu, kIV5 = 0x9b05688cu,
                   kIV6 = 0x1f83d9abu, kIV7 = 0x5be0cd19u;
constexpr uint32_t kH0 = kIV0 ^ 0x01010020u;   // digest length 32, fanout 1, depth 1

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

#define G(a, b, c, d, x, y)        \
  v[a] = v[a] + v[b] + (x);        \
  v[d] = rotr(v[d] ^ v[a], 16);    \
  v[c] = v[c] + v[d];              \
  v[b] = rotr(v[b] ^ v[c], 12);    \
  v[a] = v[a] + v[b] + (y);        \
  v[d] = rotr(v[d] ^ v[a], 8);     \
  v[c] = v[c] + v[d];              \
  v[b] = rotr(v[b] ^ v[c], 7);

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  G(0, 4, 8, 12, m[s0], m[s1])                                                      \
  G(1, 5, 9, 13, m[s2], m[s3])                                                      \
  G(2, 6, 10, 14, m[s4], m[s5])                                                     \
  G(3, 7, 11, 15, m[s6], m[s7])                                                     \
  G(0, 5, 10, 15, m[s8], m[s9])                                                     \
  G(1, 6, 11, 12, m[s10], m[s11])                                                   \
  G(2, 7, 8, 13, m[s12], m[s13])                                                    \
  G(3, 4, 9, 14, m[s14], m[s15])

// One final blake2s-256 compression of the message m (16 words, t bytes
// <= 64) from the initial chain value: the 8 digest words.
__device__ __forceinline__ void compress(const uint32_t m[16], uint32_t t,
                                         uint32_t out[8]) {
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
  for (int k = 0; k < 8; k++) out[k] = h[k] ^ v[k] ^ v[k + 8];
}

#undef ROUND
#undef G

// One pass over codeword blockIdx.y: the input level has `width` nodes at
// columns [in_off, in_off + width) (the leaves, hashed here from canon,
// when canon is not null), and the pass writes the next `levels` levels.
__global__ void __launch_bounds__(kTreeThreads)
merkle_kernel(uint32_t* __restrict__ flat, const uint32_t* __restrict__ canon,
              int64_t n, int64_t width, int64_t in_off, int levels) {
  __shared__ uint32_t s[8][kTreeThreads];
  const int t = threadIdx.x;
  const int64_t row = blockIdx.y;
  uint32_t* f = flat + row * 8 * n;
  // nodes of the input level in this block: all 256, or the whole level
  int count = width < kTreeThreads ? static_cast<int>(width) : kTreeThreads;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTreeThreads + t;
  uint32_t d[8];
  if (t < count) {
    if (canon != nullptr) {
      const uint32_t* c = canon + row * 8 * n;
      uint32_t m[16];
#pragma unroll
      for (int k = 0; k < 4; k++) {
        m[k] = (c[2 * k * n + i] & 0xffffu) | (c[(2 * k + 1) * n + i] << 16);
        m[4 + k] = (c[2 * k * n + i + width] & 0xffffu) |
                   (c[(2 * k + 1) * n + i + width] << 16);
      }
#pragma unroll
      for (int k = 8; k < 16; k++) m[k] = 0;
      compress(m, 32, d);
#pragma unroll
      for (int k = 0; k < 8; k++) f[k * n + in_off + i] = d[k];
      if (i == 0) {
#pragma unroll
        for (int k = 0; k < 8; k++) f[k * n + n - 1] = 0;   // the pad column
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; k++) d[k] = f[k * n + in_off + i];
    }
#pragma unroll
    for (int k = 0; k < 8; k++) s[k][t] = d[k];
  }
  int64_t off = in_off, level_width = width;
  for (int q = 0; q < levels; q++) {
    off += level_width;
    level_width >>= 1;
    count >>= 1;
    __syncthreads();                 // the level below is in s
    uint32_t m[16];
    if (t < count) {
#pragma unroll
      for (int k = 0; k < 8; k++) {
        m[k] = s[k][2 * t];
        m[8 + k] = s[k][2 * t + 1];
      }
    }
    __syncthreads();                 // every child read before any parent lands
    if (t < count) {
      compress(m, 64, d);
      const int64_t j = static_cast<int64_t>(blockIdx.x) * count + t;
#pragma unroll
      for (int k = 0; k < 8; k++) {
        s[k][t] = d[k];
        f[k * n + off + j] = d[k];
      }
    }
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
      compress(m, 40, d);
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

// One pass of H4 over `batch` codewords: canon (batch, 8, n) canonical
// limbs for the leaf pass, else null; flat (batch, 8, n) the tree.  The
// input level has `width` nodes (a power of two) at column in_off; the
// pass reduces `levels` <= 8 levels, at most log2(width), or log2(256)
// when the level spans several blocks.
int stark_merkle(void* flat, const void* canon, int64_t batch, int64_t n,
                 int64_t width, int64_t in_off, int levels, void* stream,
                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  const int64_t blocks = width > kTreeThreads ? width / kTreeThreads : 1;
  if (n < 2 || (n & (n - 1)) || width < 1 || (width & (width - 1)) ||
      levels < 0 || levels > kTreeLevels || (width >> levels) < 1 ||
      (width > kTreeThreads && levels != kTreeLevels) ||
      blocks > 0x7FFFFFFF || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  merkle_kernel<<<grid, kTreeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(flat), static_cast<const uint32_t*>(canon), n,
      width, in_off, levels);
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
