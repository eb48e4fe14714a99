// H3's Stockham passes and the carry-flag Montgomery products, shared by
// the NTT kernels of field.cu (H3: a whole transform of up to 8192 points
// in one launch) and ntt_tiled.cu (H8: a transform of up to 2^24 points in
// two launches, each block running one inner transform by these passes).
// field.cu's header says how the passes run and what bounds them;
// field_arith.cuh holds the word arithmetic.

#pragma once

#include "field_arith.cuh"

namespace {

__device__ __forceinline__ void to_words(const uint4& v, uint32_t w[4]) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ uint4 from_words(const uint32_t w[4]) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The exchange buffer's slot of element i within a block: an XOR swizzle
// of the low three bits by the next three, so that the eight 16-byte
// accesses of a quarter warp fall in eight distinct bank groups both when
// they are consecutive (every read, and the writes of a pass with
// Ns >= 8) and when they stride by 8 (the writes of the first pass).
__device__ __forceinline__ int ntt_slot(int i) { return i ^ ((i >> 3) & 7); }

// The one-step Montgomery reduction of mont_reduce in PTX: from the
// product T in registers t0..t7 to r = T * 2^-128 mod p in operands %0..%3
// (the carry-flag forms below declare t<8>, m<4>, q<4>, d<4>, c3, kk, w,
// ov, bb and the predicate keep).
#define STARK_MONT_REDUCE_PTX \
  /* m = c3 * 2^96 - T_lo mod 2^128, c3 = t0 * kP3; kk = -(its borrow) */ \
  "mul.lo.u32 c3, t0, 0xCB800000;\n\t" \
  "sub.cc.u32 m0, 0, t0;\n\t" \
  "subc.cc.u32 m1, 0, t1;\n\t" \
  "subc.cc.u32 m2, 0, t2;\n\t" \
  "subc.cc.u32 m3, c3, t3;\n\t" \
  "subc.u32 kk, 0, 0;\n\t" \
  /* q = (m * kP3 + c3) / 2^32 (the low word of the sum is 0) */ \
  "mad.lo.cc.u32 w, m0, 0xCB800000, c3;\n\t" \
  "madc.lo.cc.u32 q0, m1, 0xCB800000, 0;\n\t" \
  "madc.lo.cc.u32 q1, m2, 0xCB800000, 0;\n\t" \
  "madc.lo.cc.u32 q2, m3, 0xCB800000, 0;\n\t" \
  "addc.u32 q3, 0, 0;\n\t" \
  "mad.hi.cc.u32 q0, m0, 0xCB800000, q0;\n\t" \
  "madc.hi.cc.u32 q1, m1, 0xCB800000, q1;\n\t" \
  "madc.hi.cc.u32 q2, m2, 0xCB800000, q2;\n\t" \
  "madc.hi.u32 q3, m3, 0xCB800000, q3;\n\t" \
  /* r = T_hi + q + borrow (the carry flag set from kk), with its 2^128 bit */ \
  "add.cc.u32 w, kk, kk;\n\t" \
  "addc.cc.u32 t4, t4, q0;\n\t" \
  "addc.cc.u32 t5, t5, q1;\n\t" \
  "addc.cc.u32 t6, t6, q2;\n\t" \
  "addc.cc.u32 t7, t7, q3;\n\t" \
  "addc.u32 ov, 0, 0;\n\t" \
  /* r - p, kept where r >= p (or r has its 2^128 bit) */ \
  "sub.cc.u32 d0, t4, 1;\n\t" \
  "subc.cc.u32 d1, t5, 0;\n\t" \
  "subc.cc.u32 d2, t6, 0;\n\t" \
  "subc.cc.u32 d3, t7, 0xCB800000;\n\t" \
  "subc.u32 bb, ov, 0;\n\t" \
  "setp.lt.s32 keep, bb, 0;\n\t" \
  "selp.b32 %0, t4, d0, keep;\n\t" \
  "selp.b32 %1, t5, d1, keep;\n\t" \
  "selp.b32 %2, t6, d2, keep;\n\t" \
  "selp.b32 %3, t7, d3, keep;\n\t"

// H3's, H8's and the ladder's Montgomery product: the value of mont_mul_words
// (field_arith.cuh), with the carries of its word sums on the carry flag
// (PTX add.cc / madc chains) in place of 64-bit sums split back into
// words: 65 PTX instructions (more in SASS, where a high half with a
// carry in is an IMAD.HI and an IADD3.X) and no 64-bit temporaries, so fewer live
// registers: at the 128-register cap of H3's 512-thread blocks
// mont_mul_words spilled more and ran slower.  T = a*b row by row (the
// low halves of a*b_i in one carry chain, the high halves in a second),
// then the one-step reduction of mont_reduce and the conditional
// subtract of p.  r may alias a or b: the outputs are written last.
// A host compiler (a g++ build that checks the device code on the CPU)
// takes mont_mul_words.
__device__ __forceinline__ void mont_mul_chain(const uint32_t a[4], const uint32_t b[4],
                                               uint32_t r[4]) {
#ifdef __CUDACC__
  asm("{\n\t"
      ".reg .u32 t<8>, m<4>, q<4>, d<4>, c3, kk, w, ov, bb;\n\t"
      ".reg .pred keep;\n\t"
      // row 0: t0..t4 = a * b0
      "mul.lo.u32 t0, %4, %8;\n\t"
      "mul.lo.u32 t1, %5, %8;\n\t"
      "mul.lo.u32 t2, %6, %8;\n\t"
      "mul.lo.u32 t3, %7, %8;\n\t"
      "mad.hi.cc.u32 t1, %4, %8, t1;\n\t"
      "madc.hi.cc.u32 t2, %5, %8, t2;\n\t"
      "madc.hi.cc.u32 t3, %6, %8, t3;\n\t"
      "madc.hi.u32 t4, %7, %8, 0;\n\t"
      // row 1: t1..t5 += a * b1
      "mad.lo.cc.u32 t1, %4, %9, t1;\n\t"
      "madc.lo.cc.u32 t2, %5, %9, t2;\n\t"
      "madc.lo.cc.u32 t3, %6, %9, t3;\n\t"
      "madc.lo.cc.u32 t4, %7, %9, t4;\n\t"
      "addc.u32 t5, 0, 0;\n\t"
      "mad.hi.cc.u32 t2, %4, %9, t2;\n\t"
      "madc.hi.cc.u32 t3, %5, %9, t3;\n\t"
      "madc.hi.cc.u32 t4, %6, %9, t4;\n\t"
      "madc.hi.u32 t5, %7, %9, t5;\n\t"
      // row 2: t2..t6 += a * b2
      "mad.lo.cc.u32 t2, %4, %10, t2;\n\t"
      "madc.lo.cc.u32 t3, %5, %10, t3;\n\t"
      "madc.lo.cc.u32 t4, %6, %10, t4;\n\t"
      "madc.lo.cc.u32 t5, %7, %10, t5;\n\t"
      "addc.u32 t6, 0, 0;\n\t"
      "mad.hi.cc.u32 t3, %4, %10, t3;\n\t"
      "madc.hi.cc.u32 t4, %5, %10, t4;\n\t"
      "madc.hi.cc.u32 t5, %6, %10, t5;\n\t"
      "madc.hi.u32 t6, %7, %10, t6;\n\t"
      // row 3: t3..t7 += a * b3
      "mad.lo.cc.u32 t3, %4, %11, t3;\n\t"
      "madc.lo.cc.u32 t4, %5, %11, t4;\n\t"
      "madc.lo.cc.u32 t5, %6, %11, t5;\n\t"
      "madc.lo.cc.u32 t6, %7, %11, t6;\n\t"
      "addc.u32 t7, 0, 0;\n\t"
      "mad.hi.cc.u32 t4, %4, %11, t4;\n\t"
      "madc.hi.cc.u32 t5, %5, %11, t5;\n\t"
      "madc.hi.cc.u32 t6, %6, %11, t6;\n\t"
      "madc.hi.u32 t7, %7, %11, t7;\n\t"
      STARK_MONT_REDUCE_PTX
      "}"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]));
#else
  mont_mul_words(a, b, r);
#endif
}

// The squaring product in the same carry-flag form: the value of
// mont_sqr_words (10 word products for T = a*a in place of 16), then the
// reduction of mont_mul_chain.  The six cross products a_i a_j (i < j)
// by rows in carry chains into s1..s6 (their sum C is below 2^224), C
// doubled by one add chain into s1..s7, then the four squares a_i^2 added
// along it.  Every partial sum is a sum of some of T's terms, so no carry
// is lost where a chain ends without .cc.  r may alias a.  A host
// compiler takes mont_sqr_words.
__device__ __forceinline__ void mont_sqr_chain(const uint32_t a[4], uint32_t r[4]) {
#ifdef __CUDACC__
  asm("{\n\t"
      ".reg .u32 t<8>, s<8>, m<4>, q<4>, d<4>, c3, kk, w, ov, bb;\n\t"
      ".reg .pred keep;\n\t"
      // row 0: s1..s4 = a0 * (a1, a2, a3)
      "mul.lo.u32 s1, %4, %5;\n\t"
      "mul.lo.u32 s2, %4, %6;\n\t"
      "mul.lo.u32 s3, %4, %7;\n\t"
      "mad.hi.cc.u32 s2, %4, %5, s2;\n\t"
      "madc.hi.cc.u32 s3, %4, %6, s3;\n\t"
      "madc.hi.u32 s4, %4, %7, 0;\n\t"
      // row 1: s3..s5 += a1 * (a2, a3)
      "mad.lo.cc.u32 s3, %5, %6, s3;\n\t"
      "madc.lo.cc.u32 s4, %5, %7, s4;\n\t"
      "addc.u32 s5, 0, 0;\n\t"
      "mad.hi.cc.u32 s4, %5, %6, s4;\n\t"
      "madc.hi.u32 s5, %5, %7, s5;\n\t"
      // row 2: s5..s6 += a2 * a3
      "mad.lo.cc.u32 s5, %6, %7, s5;\n\t"
      "madc.hi.u32 s6, %6, %7, 0;\n\t"
      // 2C into s1..s7
      "add.cc.u32 s1, s1, s1;\n\t"
      "addc.cc.u32 s2, s2, s2;\n\t"
      "addc.cc.u32 s3, s3, s3;\n\t"
      "addc.cc.u32 s4, s4, s4;\n\t"
      "addc.cc.u32 s5, s5, s5;\n\t"
      "addc.cc.u32 s6, s6, s6;\n\t"
      "addc.u32 s7, 0, 0;\n\t"
      // T = 2C + sum a_i^2 2^(64 i)
      "mul.lo.u32 t0, %4, %4;\n\t"
      "mad.hi.cc.u32 t1, %4, %4, s1;\n\t"
      "madc.lo.cc.u32 t2, %5, %5, s2;\n\t"
      "madc.hi.cc.u32 t3, %5, %5, s3;\n\t"
      "madc.lo.cc.u32 t4, %6, %6, s4;\n\t"
      "madc.hi.cc.u32 t5, %6, %6, s5;\n\t"
      "madc.lo.cc.u32 t6, %7, %7, s6;\n\t"
      "madc.hi.u32 t7, %7, %7, s7;\n\t"
      STARK_MONT_REDUCE_PTX
      "}"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
#else
  mont_sqr_words(a, r);
#endif
}

// The twiddle omega^e from the packed table (one 16-byte load through the
// read-only cache).
__device__ __forceinline__ void twiddle(const uint4* __restrict__ tw, int e, uint32_t w[4]) {
  to_words(__ldg(tw + e), w);
}

// a, b <- a + w b, a - w b (w = 1 where w is null).
__device__ __forceinline__ void butterfly(uint32_t a[4], uint32_t b[4], const uint32_t* w) {
  uint32_t t[4];
  if (w != nullptr) {
    mont_mul_chain(b, w, t);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = b[k];
  }
  AddMod()(a, t, b);      // b holds a + t for now
  SubMod()(a, t, a);      // a = a - t
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t s = b[k];
    b[k] = a[k];
    a[k] = s;
  }
}

// In place, X[s] = sum_r v[r] w_R^(r s) over v[0..R), w_R = omega^(n/R)
// = tw[n/R], natural order in and out: radix-2 decimation in time over
// the even and odd halves, 0 products for R = 2, 1 for R = 4, 5 for R = 8.
template <int R>
__device__ __forceinline__ void dft(uint32_t (*v)[4], const uint4* __restrict__ tw, int log_n) {
  if constexpr (R == 2) {
    butterfly(v[0], v[1], nullptr);
  } else if constexpr (R == 4) {
    uint32_t w4[4];
    twiddle(tw, 1 << (log_n - 2), w4);
    butterfly(v[0], v[2], nullptr);        // v0, v2 = E0, E1 of (x0, x2)
    butterfly(v[1], v[3], nullptr);        // v1, v3 = O0, O1 of (x1, x3)
    butterfly(v[0], v[1], nullptr);        // X0, X2
    butterfly(v[2], v[3], w4);             // X1, X3
#pragma unroll
    for (int k = 0; k < 4; ++k) {          // (X0, X2, X1, X3) -> natural order
      const uint32_t t = v[1][k];
      v[1][k] = v[2][k];
      v[2][k] = t;
    }
  } else {
    uint32_t e[4][4], o[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        e[r][k] = v[2 * r][k];
        o[r][k] = v[2 * r + 1][k];
      }
    }
    dft<4>(e, tw, log_n);
    dft<4>(o, tw, log_n);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t w[4];
      if (s > 0) twiddle(tw, s << (log_n - 3), w);
      butterfly(e[s], o[s], s > 0 ? w : nullptr);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[s][k] = e[s][k];
        v[s + 4][k] = o[s][k];
      }
    }
  }
}

// log2 of a radix.
template <int R>
__host__ __device__ constexpr int lg() {
  return R == 8 ? 3 : (R == 4 ? 2 : 1);
}

// One Stockham pass of radix R after Ns = 2^lg_ns points, on the 8/R
// groups of thread t (group g = t + i T, its elements v[i R + r] read
// from positions g + r n/R = t + (i + r 8/R) T): the twiddles
// omega^(k r n/(Ns R)), k = g mod Ns (none in the first pass), then the
// R-point DFT.  Output s of group g goes to ntt_dest.
template <int R>
__device__ __forceinline__ void ntt_pass(uint32_t (*v)[4], const uint4* __restrict__ tw, int log_n,
                                         int t, int lg_t, int lg_ns) {
#pragma unroll
  for (int i = 0; i < 8 / R; ++i) {
    if (lg_ns > 0) {
      const int k = (t + (i << lg_t)) & ((1 << lg_ns) - 1);
      const int shift = log_n - lg_ns - lg<R>();
#pragma unroll
      for (int r = 1; r < R; ++r) {
        uint32_t w[4];
        twiddle(tw, (k * r) << shift, w);
        mont_mul_chain(v[i * R + r], w, v[i * R + r]);
      }
    }
    dft<R>(v + i * R, tw, log_n);
  }
}

// The position of output s of group g in a pass of radix R after 2^lg_ns
// points: g / Ns * Ns R + g mod Ns + s Ns.
template <int R>
__device__ __forceinline__ int ntt_dest(int g, int s, int lg_ns) {
  return ((g >> lg_ns) << (lg_ns + lg<R>())) + (g & ((1 << lg_ns) - 1)) + (s << lg_ns);
}

// The element (or thread t's group i) a pass of radix R reads into v[i R + r].
template <int R>
__device__ __forceinline__ int ntt_src(int t, int lg_t, int i) {
  return t + ((i / R + (i % R) * (8 / R)) << lg_t);
}

}  // namespace
