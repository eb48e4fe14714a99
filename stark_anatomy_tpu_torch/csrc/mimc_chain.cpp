// N2: the MiMC chain on the host, x_{i+1} = x_i^3 + c, in Montgomery form.
//
// A copy of the JAX package's stark_anatomy_tpu/native/mimc_chain.cpp
// (stark_mimc_chain), built for the port by models/mimc.py through
// utils/build.py (one host C++ compiler call into _build/ at first use).
// The chain is sequential by design (a verifiable-delay-function shape),
// so it is scalar host work: 128-bit Montgomery arithmetic on 64-bit
// words, a few tens of nanoseconds a step, and the trace is copied to the
// card once, packed (16 bytes an element), where models/mimc.py unpacks
// it into limbs.  Every wide computation of the proof stays on the card.
//
// Field: p = 0xcb800000000000000000000000000001 (reference algebra.py:16).
// Values are in Montgomery form (R = 2^128) throughout, bit-exact with the
// port's limb kernels (csrc/field.cu).

#include <cstdint>
#include <cstring>

namespace {

using u64 = uint64_t;
using u128 = unsigned __int128;

constexpr u64 P_LO = 0x1ULL;
constexpr u64 P_HI = 0xcb80000000000000ULL;
// -p^{-1} mod 2^128
constexpr u64 NP_LO = 0xffffffffffffffffULL;
constexpr u64 NP_HI = 0xcb7fffffffffffffULL;

struct U256 {
  u64 w[4];  // little-endian 64-bit words
};

// 128x128 -> 256 schoolbook on 64-bit words
inline U256 mul_128(u64 a_lo, u64 a_hi, u64 b_lo, u64 b_hi) {
  U256 r{};
  u128 t = (u128)a_lo * b_lo;
  r.w[0] = (u64)t;
  u64 c = (u64)(t >> 64);
  t = (u128)a_lo * b_hi + c;
  u64 m1 = (u64)t;
  u64 m1c = (u64)(t >> 64);
  t = (u128)a_hi * b_lo + m1;
  r.w[1] = (u64)t;
  t = (u128)a_hi * b_hi + m1c + (u64)(t >> 64);
  r.w[2] = (u64)t;
  r.w[3] = (u64)(t >> 64);
  return r;
}

// 128x128 -> low 128 bits only
inline void mul_128_lo(u64 a_lo, u64 a_hi, u64 b_lo, u64 b_hi, u64 &lo, u64 &hi) {
  u128 t = (u128)a_lo * b_lo;
  lo = (u64)t;
  hi = (u64)(t >> 64) + a_lo * b_hi + a_hi * b_lo;
}

// Montgomery product: a*b*R^{-1} mod p, inputs/outputs in [0, p)
inline void mont_mul(u64 a_lo, u64 a_hi, u64 b_lo, u64 b_hi, u64 &o_lo, u64 &o_hi) {
  U256 t = mul_128(a_lo, a_hi, b_lo, b_hi);
  u64 m_lo, m_hi;
  mul_128_lo(t.w[0], t.w[1], NP_LO, NP_HI, m_lo, m_hi);
  U256 mp = mul_128(m_lo, m_hi, P_LO, P_HI);
  // u = t + mp; result = u >> 128 (low 128 bits cancel by construction)
  u128 acc = (u128)t.w[0] + mp.w[0];
  acc = (acc >> 64) + t.w[1] + mp.w[1];
  u64 carry = (u64)(acc >> 64);
  acc = (u128)t.w[2] + mp.w[2] + carry;
  u64 r_lo = (u64)acc;
  acc = (acc >> 64) + t.w[3] + mp.w[3];
  u64 r_hi = (u64)acc;
  u64 overflow = (u64)(acc >> 64);
  // conditional subtract p (result < 2p, possibly with the 2^128 bit set)
  if (overflow || r_hi > P_HI || (r_hi == P_HI && r_lo >= P_LO)) {
    u128 d = (u128)r_lo - P_LO;
    r_lo = (u64)d;
    r_hi = r_hi - P_HI - (u64)((d >> 64) & 1);
  }
  o_lo = r_lo;
  o_hi = r_hi;
}

// modular add in [0, p)
inline void add_mod(u64 a_lo, u64 a_hi, u64 b_lo, u64 b_hi, u64 &o_lo, u64 &o_hi) {
  u128 s = (u128)a_lo + b_lo;
  u64 r_lo = (u64)s;
  u128 sh = (u128)a_hi + b_hi + (u64)(s >> 64);
  u64 r_hi = (u64)sh;
  u64 carry = (u64)(sh >> 64);
  if (carry || r_hi > P_HI || (r_hi == P_HI && r_lo >= P_LO)) {
    u128 d = (u128)r_lo - P_LO;
    r_lo = (u64)d;
    r_hi = r_hi - P_HI - (u64)((d >> 64) & 1);
  }
  o_lo = r_lo;
  o_hi = r_hi;
}

}  // namespace

extern "C" {

// out: (steps+1) * 16 bytes, little-endian Montgomery-form chain values
// x0, x_1, ..., x_steps with x_{i+1} = x_i^3 + c (all Montgomery form).
void stark_mimc_chain(u64 x0_lo, u64 x0_hi, u64 c_lo, u64 c_hi,
                      u64 steps, uint8_t *out) {
  u64 x_lo = x0_lo, x_hi = x0_hi;
  memcpy(out, &x_lo, 8);
  memcpy(out + 8, &x_hi, 8);
  for (u64 i = 0; i < steps; i++) {
    u64 s_lo, s_hi, t_lo, t_hi;
    mont_mul(x_lo, x_hi, x_lo, x_hi, s_lo, s_hi);
    mont_mul(s_lo, s_hi, x_lo, x_hi, t_lo, t_hi);
    add_mod(t_lo, t_hi, c_lo, c_hi, x_lo, x_hi);
    uint8_t *dst = out + (i + 1) * 16;
    memcpy(dst, &x_lo, 8);
    memcpy(dst + 8, &x_hi, 8);
  }
}

}  // extern "C"
