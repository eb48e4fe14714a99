// The Rescue-Prime AIR at one point, shared by H10 (the prover's quotients
// on the FRI domain) and H12 (the verifier's recomputation at the query
// points), both in air.cu.  It is the body of the JAX package's
// stark_anatomy_tpu/models/rescue_prime.py:_rescue_air_kernel for m = 2:
//
//   constraint_i = [ sum_k MDS[i][k] cur_k^3 + C1_i(x) ]
//                - [ sum_k MDSinv[i][k] (next_k - C2_k(x)) ]^3
//
// on four-word Montgomery values (field_arith.cuh): 16 products (two
// squarings among them) and 10 adds or subtracts.  Every add and subtract
// ends in [0, p), so the result is the canonical word form the glue gives.

#pragma once

#include "field_arith.cuh"

namespace {

constexpr int kAirM = 2;            // the Rescue state: m = 2 registers, C = 2 constraints

// The 2 x 2 MDS matrix and its inverse in Montgomery form.
struct RescueConsts {
  uint32_t mds[kAirM][kAirM][4];
  uint32_t mds_inv[kAirM][kAirM][4];
};

// From the (m, m, 8, 1) contiguous limb tables.
__device__ __forceinline__ void load_rescue_consts(const int32_t* mds, const int32_t* mds_inv,
                                                   RescueConsts& c) {
#pragma unroll
  for (int i = 0; i < kAirM; ++i) {
#pragma unroll
    for (int k = 0; k < kAirM; ++k) {
      load4(Operand{mds + (i * kAirM + k) * 8, 0, 1, 0}, 0, 0, c.mds[i][k]);
      load4(Operand{mds_inv + (i * kAirM + k) * 8, 0, 1, 0}, 0, 0, c.mds_inv[i][k]);
    }
  }
}

// r = a^3.  r may alias a.
__device__ __forceinline__ void cube_words(const uint32_t a[4], uint32_t r[4]) {
  uint32_t t[4];
  mont_sqr_words(a, t);
  mont_mul_words(t, a, r);
}

// out_i, i < 2: the two transition constraints at a point from the
// current and next rows and the round constants C1(x), C2(x) there.
__device__ __forceinline__ void rescue_air(const uint32_t cur[kAirM][4],
                                           const uint32_t next[kAirM][4],
                                           const uint32_t c1[kAirM][4],
                                           const uint32_t c2[kAirM][4], const RescueConsts& k,
                                           uint32_t out[kAirM][4]) {
  uint32_t cube[kAirM][4], inner[kAirM][4];
#pragma unroll
  for (int r = 0; r < kAirM; ++r) {
    cube_words(cur[r], cube[r]);
    SubMod()(next[r], c2[r], inner[r]);
  }
#pragma unroll
  for (int i = 0; i < kAirM; ++i) {
    uint32_t lhs[4], rhs[4], t[4];
    mont_mul_words(cube[0], k.mds[i][0], lhs);
    mont_mul_words(inner[0], k.mds_inv[i][0], rhs);
#pragma unroll
    for (int r = 1; r < kAirM; ++r) {
      mont_mul_words(cube[r], k.mds[i][r], t);
      AddMod()(lhs, t, lhs);
      mont_mul_words(inner[r], k.mds_inv[i][r], t);
      AddMod()(rhs, t, rhs);
    }
    AddMod()(lhs, c1[i], lhs);
    cube_words(rhs, rhs);
    SubMod()(lhs, rhs, out[i]);
  }
}

}  // namespace
