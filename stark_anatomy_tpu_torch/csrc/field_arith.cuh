// Field arithmetic on four 32-bit words for the STARK field
// p = 1 + 407 * 2^119, shared by the kernels of field.cu and merkle.cu.
//
// An element is 8 little-endian 16-bit limbs held in int32 lanes on a limb
// axis (the JAX package's layout); load4/store4 pack them into four 32-bit
// words, least significant first, and back.  mont_mul_words and
// mont_sqr_words are the Montgomery product a*b*2^-128 mod p (field.cu's
// header says how p's sparse words give a one-step reduction); AddMod and
// SubMod the modular add and subtract.  All are exact: every kernel that
// uses them equals its plain PyTorch version bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// p in 32-bit words, least significant first: p = 407 * 2^119 + 1.
constexpr uint32_t kP3 = 0xCB800000u;
__device__ __forceinline__ uint32_t p_word(int k) {
  return k == 0 ? 1u : (k == 3 ? kP3 : 0u);
}

// The Montgomery one, R mod p = 2^128 - p, in 32-bit words.
__device__ __forceinline__ uint32_t one_mont_word(int k) {
  return k == 3 ? 0x347FFFFFu : 0xFFFFFFFFu;
}

struct Operand {
  const int32_t* ptr;
  int64_t sb, sl, se;
};

__device__ __forceinline__ void load4(const Operand& x, int64_t b, int64_t j,
                                      uint32_t w[4]) {
  const int32_t* base = x.ptr + b * x.sb + j * x.se;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t lo = static_cast<uint32_t>(base[(2 * k) * x.sl]) & 0xFFFFu;
    uint32_t hi = static_cast<uint32_t>(base[(2 * k + 1) * x.sl]) & 0xFFFFu;
    w[k] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void store4(int32_t* out, int64_t b, int64_t j,
                                       int64_t n, const uint32_t w[4]) {
  int32_t* base = out + b * 8 * n + j;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    base[(2 * k) * n] = static_cast<int32_t>(w[k] & 0xFFFFu);
    base[(2 * k + 1) * n] = static_cast<int32_t>(w[k] >> 16);
  }
}

// r (with a 2^128 overflow bit) < 2p  ->  r mod p.
__device__ __forceinline__ void cond_sub_p(uint32_t r[4], uint32_t overflow) {
  uint32_t d[4];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint64_t t = static_cast<uint64_t>(r[k]) - p_word(k) - borrow;
    d[k] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1u;
  }
  if (overflow || !borrow) {
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = d[k];
  }
}

// 32 x 32 -> 64-bit product.
__device__ __forceinline__ uint64_t wide(uint32_t x, uint32_t y) {
  return static_cast<uint64_t>(x) * y;
}

// r = T * 2^-128 mod p for T = t[0..7] < p * 2^128 (a product of two
// values below p).  r may alias nothing in t.
//
// Montgomery with one reduction step instead of four CIOS rounds, which
// p's shape allows.  p = 1 + kP3 * 2^96, so p^-1 = 1 - kP3 * 2^96 and
// -p^-1 = kP3 * 2^96 - 1 (mod 2^128), and for T = T_hi 2^128 + T_lo:
//   m = T * (-p^-1) mod 2^128 = c3 * 2^96 - T_lo,  c3 = t0 * kP3 mod 2^32,
//   T_lo + m = c3 * 2^96 + k * 2^128  (k is the borrow of that subtract),
//   (T + m p) / 2^128 = T_hi + k + (m * kP3 + c3) / 2^32,
// which is < 2p, so one conditional subtract of p finishes: four wide
// products and one narrow one, in two short chains.
__device__ __forceinline__ void mont_reduce(const uint32_t t[8], uint32_t r[4]) {
  // m = c3 * 2^96 - T_lo mod 2^128, and its borrow k.
  const uint32_t c3 = t[0] * kP3;
  uint32_t m[4];
  uint64_t d = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d = static_cast<uint64_t>(j == 3 ? c3 : 0u) - t[j] - ((d >> 32) & 1u);
    m[j] = static_cast<uint32_t>(d);
  }
  const uint64_t k = (d >> 32) & 1u;
  // q = (m * kP3 + c3) / 2^32; the low word of the sum is 0.
  uint32_t q[4];
  uint64_t s = wide(m[0], kP3) + c3;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    s = wide(m[j], kP3) + (s >> 32);
    q[j - 1] = static_cast<uint32_t>(s);
  }
  q[3] = static_cast<uint32_t>(s >> 32);
  // r = T_hi + q + k, with its 2^128 bit, then less p once if needed.
  s = k << 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s = static_cast<uint64_t>(t[4 + j]) + q[j] + (s >> 32);
    r[j] = static_cast<uint32_t>(s);
  }
  cond_sub_p(r, static_cast<uint32_t>(s >> 32));
}

// r = a*b*2^-128 mod p for a, b < p: 16 word products for T = a*b, in
// four independent rows, then the reduction.  r may alias a or b: both
// are read in full before r is written.
__device__ __forceinline__ void mont_mul_words(const uint32_t a[4],
                                               const uint32_t b[4],
                                               uint32_t r[4]) {
  // T = a*b: four independent rows a * b_i, then summed by column.
  uint32_t row[4][5];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t s = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s = wide(a[j], b[i]) + (s >> 32);
      row[i][j] = static_cast<uint32_t>(s);
    }
    row[i][4] = static_cast<uint32_t>(s >> 32);
  }
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k - i >= 0 && k - i <= 4) c += row[i][k - i];
    }
    t[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  mont_reduce(t, r);
}

// r = a*a*2^-128 mod p for a < p, with 10 word products for T = a*a in
// place of 16: T = 2C + D, C = sum_{i<j} a_i a_j 2^(32(i+j)) (6 cross
// products) and D = sum_i a_i^2 2^(64i) (4 squares).  2 a_i a_j does not
// fit 64 bits, so C is summed by column and carried into words c[1..7]
// first, then doubled by a one-bit shift across the words.  This is exact:
// every cross term is below 2^(32(i+j)+64) with i+j <= 5, so C < 2^225 and
// 2C < 2^226 fits the eight words with nothing shifted out; T = a^2 <
// 2^256, so adding D carries nothing out of word 7.  r may alias a.
__device__ __forceinline__ void mont_sqr_words(const uint32_t a[4], uint32_t r[4]) {
  // the cross rows a_i * (a_{i+1} .. a_3), row i starting at word 2i + 1
  uint32_t row0[4], row1[3], row2[2];
  uint64_t s = 0;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    s = wide(a[0], a[j]) + (s >> 32);
    row0[j - 1] = static_cast<uint32_t>(s);
  }
  row0[3] = static_cast<uint32_t>(s >> 32);
  s = wide(a[1], a[2]);
  row1[0] = static_cast<uint32_t>(s);
  s = wide(a[1], a[3]) + (s >> 32);
  row1[1] = static_cast<uint32_t>(s);
  row1[2] = static_cast<uint32_t>(s >> 32);
  s = wide(a[2], a[3]);
  row2[0] = static_cast<uint32_t>(s);
  row2[1] = static_cast<uint32_t>(s >> 32);
  // C by column: words 1..6 and the carry into word 7
  uint32_t c[8];
  c[0] = 0;
  c[1] = row0[0];
  c[2] = row0[1];
  uint64_t col = static_cast<uint64_t>(row0[2]) + row1[0];
  c[3] = static_cast<uint32_t>(col);
  col = static_cast<uint64_t>(row0[3]) + row1[1] + (col >> 32);
  c[4] = static_cast<uint32_t>(col);
  col = static_cast<uint64_t>(row1[2]) + row2[0] + (col >> 32);
  c[5] = static_cast<uint32_t>(col);
  col = static_cast<uint64_t>(row2[1]) + (col >> 32);
  c[6] = static_cast<uint32_t>(col);
  c[7] = static_cast<uint32_t>(col >> 32);
  // T = 2C + D
  uint32_t t[8];
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t sq = wide(a[i], a[i]);
    const uint32_t lo = (c[2 * i] << 1) | (i == 0 ? 0u : c[2 * i - 1] >> 31);
    const uint32_t hi = (c[2 * i + 1] << 1) | (c[2 * i] >> 31);
    acc = static_cast<uint64_t>(lo) + static_cast<uint32_t>(sq) + (acc >> 32);
    t[2 * i] = static_cast<uint32_t>(acc);
    acc = static_cast<uint64_t>(hi) + static_cast<uint32_t>(sq >> 32) + (acc >> 32);
    t[2 * i + 1] = static_cast<uint32_t>(acc);
  }
  mont_reduce(t, r);
}

struct MontMul {
  __device__ __forceinline__ void operator()(const uint32_t a[4],
                                             const uint32_t b[4],
                                             uint32_t r[4]) const {
    mont_mul_words(a, b, r);
  }
};

struct AddMod {
  __device__ __forceinline__ void operator()(const uint32_t a[4],
                                             const uint32_t b[4],
                                             uint32_t r[4]) const {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint64_t s = static_cast<uint64_t>(a[k]) + b[k] + c;
      r[k] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    cond_sub_p(r, static_cast<uint32_t>(c));
  }
};

struct SubMod {
  __device__ __forceinline__ void operator()(const uint32_t a[4],
                                             const uint32_t b[4],
                                             uint32_t r[4]) const {
    uint64_t borrow = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint64_t t = static_cast<uint64_t>(a[k]) - b[k] - borrow;
      r[k] = static_cast<uint32_t>(t);
      borrow = (t >> 32) & 1u;
    }
    if (borrow) {
      uint64_t c = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint64_t s = static_cast<uint64_t>(r[k]) + p_word(k) + c;
        r[k] = static_cast<uint32_t>(s);
        c = s >> 32;
      }
    }
  }
};

}  // namespace
