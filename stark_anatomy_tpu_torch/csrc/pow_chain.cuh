// The power chains on one thread, shared by field.cu (H0's ladder) and
// air.cu (H12, the verifier's inverse and shifts): x^(p-2) by the fixed
// chain INV_CHAIN of field/kernels.py (pow_inv), any other exponent by
// left-to-right square and multiply (mont_pow_words).  Both run on the
// carry-flag products of ntt_passes.cuh (mont_mul_chain, mont_sqr_chain).

#pragma once

#include "field_arith.cuh"
#include "ntt_passes.cuh"

namespace {

// r = a^(2^k), k >= 1 squarings.  r may alias a.
__device__ __forceinline__ void sqr_run(const uint32_t a[4], int k, uint32_t r[4]) {
  mont_sqr_chain(a, r);
#pragma unroll 1
  for (int i = 1; i < k; ++i) mont_sqr_chain(r, r);
}

// acc = x^(p-2), the Fermat inverse (0 gives 0), by the fixed chain
// INV_CHAIN of field/kernels.py, step for step (tests/test_torch_inv_chain.py
// reads this body and holds it against the list): 136 squarings and 18
// products, 154 in all, against the ladder's 127 + 123 = 250.  p - 2 =
// 406 * 2^119 + (2^119 - 1): x^(2^m - 1) for m = 2, 3, 5, 10, 11 first
// (10 squarings, 5 products), then x^203 from x^3 (6 squarings, 2
// products), then the zero bit and the 119 ones as blocks of 10, 10 and
// nine of 11, each m squarings and a product by x^(2^m - 1).  The table
// and the top are independent after x^3, so their chains overlap; the
// dependent chain is about 141 links.  acc must not alias x.
__device__ __forceinline__ void pow_inv(const uint32_t x[4], uint32_t acc[4]) {
  uint32_t x3[4], x7[4], x31[4], x1023[4], x2047[4];
  mont_sqr_chain(x, x3);
  mont_mul_chain(x3, x, x3);              // x^3 = x^(2^2 - 1)
  sqr_run(x3, 1, x7);
  mont_mul_chain(x7, x, x7);              // x^(2^3 - 1)
  sqr_run(x7, 2, x31);
  mont_mul_chain(x31, x3, x31);           // x^(2^5 - 1)
  sqr_run(x31, 5, x1023);
  mont_mul_chain(x1023, x31, x1023);      // x^(2^10 - 1)
  sqr_run(x1023, 1, x2047);
  mont_mul_chain(x2047, x, x2047);        // x^(2^11 - 1)
  sqr_run(x3, 3, acc);
  mont_mul_chain(acc, x, acc);            // x^25
  sqr_run(acc, 3, acc);
  mont_mul_chain(acc, x3, acc);           // x^203
  sqr_run(acc, 11, acc);
  mont_mul_chain(acc, x1023, acc);        // x^(406 * 2^10 + 2^10 - 1)
  sqr_run(acc, 10, acc);
  mont_mul_chain(acc, x1023, acc);        // x^(406 * 2^20 + 2^20 - 1)
#pragma unroll 1
  for (int i = 0; i < 9; ++i) {
    sqr_run(acc, 11, acc);
    mont_mul_chain(acc, x2047, acc);      // 11 more ones
  }
}

// acc = x^e, e = e_hi * 2^64 + e_lo of nbits bits (0 <= nbits <= 128;
// nbits = 0 gives the Montgomery one).  Left-to-right square and multiply
// from the top bit down.  acc must not alias x.
__device__ __forceinline__ void mont_pow_words(const uint32_t x[4], uint64_t e_lo,
                                               uint64_t e_hi, int nbits,
                                               uint32_t acc[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = nbits == 0 ? one_mont_word(k) : x[k];
#pragma unroll 1
  for (int i = nbits - 2; i >= 0; --i) {
    mont_sqr_chain(acc, acc);
    const uint64_t word = i >= 64 ? e_hi >> (i - 64) : e_lo >> i;
    if (word & 1u) mont_mul_chain(acc, x, acc);
  }
}

}  // namespace
