// N1: the host blake2s-256 hasher of the port's Merkle commitments.
//
// The port's copy of the blake2s half of the JAX package's
// stark_anatomy_tpu/native/blake2b.cpp: blake2s_block, blake2s_any and the
// four "_s" entry points (stark_hash_batch_s, stark_merkle_level_s,
// stark_leaves_from_limbs_s, stark_leaves_from_limb_pairs_s), with the
// same plain C interface and the same bytes as hashlib.blake2s.
//
// The commitment scheme (commit/hashing.py): blake2s-256, unkeyed, 32-byte
// digests; a field element hashes as its 16-byte little-endian canonical
// value, i.e. its 8 16-bit limbs verbatim.  A paired leaf is one 32-byte
// message, a node one 64-byte message: one compression each.
//
// Built at first use by commit/native.py with the host C++ compiler
// (-O3, no -march flag, so a build made on one machine runs on another).
// The reference splits a batch with OpenMP; this copy splits it over
// std::thread workers instead, so it brings no second OpenMP runtime into
// a process that has PyTorch's.  Batches under kMinPerThread hashes per
// worker run on the calling thread.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t IV_S[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                              0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                              0x1f83d9abu, 0x5be0cd19u};

constexpr uint8_t SIGMA_S[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};

constexpr uint64_t kMinPerThread = 4096;

inline uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// One blake2s compression of the 64-byte block m into the chain value h;
// t is the byte count so far, last marks the final block.
void compress(uint32_t h[8], const uint32_t m[16], uint32_t t, bool last) {
  uint32_t v[16];
  memcpy(v, h, 8 * sizeof(uint32_t));
  memcpy(v + 8, IV_S, sizeof(IV_S));
  v[12] ^= t;
  if (last) v[14] = ~v[14];

#define GS(a, b, c, d, x, y)      \
  v[a] = v[a] + v[b] + (x);       \
  v[d] = rotr32(v[d] ^ v[a], 16); \
  v[c] = v[c] + v[d];             \
  v[b] = rotr32(v[b] ^ v[c], 12); \
  v[a] = v[a] + v[b] + (y);       \
  v[d] = rotr32(v[d] ^ v[a], 8);  \
  v[c] = v[c] + v[d];             \
  v[b] = rotr32(v[b] ^ v[c], 7);

#pragma GCC unroll 10
  for (int r = 0; r < 10; r++) {
    const uint8_t *s = SIGMA_S[r];
    GS(0, 4, 8, 12, m[s[0]], m[s[1]]);
    GS(1, 5, 9, 13, m[s[2]], m[s[3]]);
    GS(2, 6, 10, 14, m[s[4]], m[s[5]]);
    GS(3, 7, 11, 15, m[s[6]], m[s[7]]);
    GS(0, 5, 10, 15, m[s[8]], m[s[9]]);
    GS(1, 6, 11, 12, m[s[10]], m[s[11]]);
    GS(2, 7, 8, 13, m[s[12]], m[s[13]]);
    GS(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#undef GS
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

void init_state(uint32_t h[8]) {
  memcpy(h, IV_S, sizeof(IV_S));
  h[0] ^= 0x01010020u;  // digest_length=32, fanout=1, depth=1
}

void store_digest(const uint32_t h[8], uint8_t *out) {
  memcpy(out, h, 32);  // little-endian host
}

// Single-block blake2s-256: message m (16 words, zero-padded), t = byte
// length (<= 64), always final.  Covers every commitment hash: paired
// leaves are 32 bytes, nodes 64.
void blake2s_block(const uint32_t m[16], uint32_t t, uint8_t *out) {
  uint32_t h[8];
  init_state(h);
  compress(h, m, t, true);
  store_digest(h, out);
}

// General (multi-block) blake2s-256 for variable-length messages.
void blake2s_any(const uint8_t *data, size_t len, uint8_t *out) {
  uint32_t h[8];
  init_state(h);
  uint32_t t = 0;
  size_t off = 0;
  uint32_t m[16];
  while (len - off > 64) {
    memcpy(m, data + off, 64);
    t += 64;
    compress(h, m, t, false);
    off += 64;
  }
  const size_t rem = len - off;
  memset(m, 0, sizeof(m));
  memcpy(m, data + off, rem);
  t += static_cast<uint32_t>(rem);
  compress(h, m, t, true);
  store_digest(h, out);
}

inline uint32_t pack_limbs(const uint32_t *row, int k) {
  return (row[2 * k] & 0xffffu) | ((row[2 * k + 1] & 0xffffu) << 16);
}

// Run body(i) for i in [0, count), split into contiguous ranges over
// worker threads when the batch is large enough to pay for them.
template <typename Body>
void parallel_for(uint64_t count, Body body) {
  uint64_t hw = std::max(1u, std::thread::hardware_concurrency());
  uint64_t workers = std::min<uint64_t>(hw, count / kMinPerThread);
  if (workers <= 1) {
    for (uint64_t i = 0; i < count; i++) body(i);
    return;
  }
  std::vector<std::thread> pool;
  const uint64_t per = (count + workers - 1) / workers;
  for (uint64_t w = 1; w < workers; w++) {
    const uint64_t lo = w * per, hi = std::min(count, lo + per);
    pool.emplace_back([lo, hi, &body] {
      for (uint64_t i = lo; i < hi; i++) body(i);
    });
  }
  for (uint64_t i = 0; i < std::min(count, per); i++) body(i);
  for (auto &t : pool) t.join();
}

}  // namespace

extern "C" {

// Hash n variable-length messages; offsets has n + 1 entries into data.
void stark_hash_batch_s(const uint8_t *data, const uint64_t *offsets,
                        uint64_t n, uint8_t *out) {
  parallel_for(n, [&](uint64_t i) {
    blake2s_any(data + offsets[i], offsets[i + 1] - offsets[i], out + 32 * i);
  });
}

// One Merkle level: n 32-byte digests (n even) -> n/2 parents.
void stark_merkle_level_s(const uint8_t *digests, uint64_t n, uint8_t *out) {
  parallel_for(n / 2, [&](uint64_t i) {
    uint32_t m[16];
    memcpy(m, digests + 64 * i, 64);
    blake2s_block(m, 64, out + 32 * i);
  });
}

// Leaf digests from a canonical limb array (n rows x 8 uint32 limbs,
// each holding a 16-bit limb): message = the 16-byte little-endian value.
void stark_leaves_from_limbs_s(const uint32_t *limbs, uint64_t n,
                               uint8_t *out) {
  parallel_for(n, [&](uint64_t i) {
    uint32_t m[16] = {0};
    const uint32_t *row = limbs + 8 * i;
    for (int k = 0; k < 4; k++) m[k] = pack_limbs(row, k);
    blake2s_block(m, 16, out + 32 * i);
  });
}

// Paired leaves: leaf i covers rows i and i + n/2; message = LE16(row_i)
// || LE16(row_{i+n/2}) (32 bytes).
void stark_leaves_from_limb_pairs_s(const uint32_t *limbs, uint64_t n,
                                    uint8_t *out) {
  const uint64_t half = n / 2;
  parallel_for(half, [&](uint64_t i) {
    uint32_t m[16] = {0};
    const uint32_t *lo = limbs + 8 * i;
    const uint32_t *hi = limbs + 8 * (i + half);
    for (int k = 0; k < 4; k++) {
      m[k] = pack_limbs(lo, k);
      m[4 + k] = pack_limbs(hi, k);
    }
    blake2s_block(m, 32, out + 32 * i);
  });
}

}  // extern "C"
