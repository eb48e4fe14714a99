// Field kernels for the 128-bit STARK field p = 1 + 407 * 2^119 on Hopper.
//
// H0 stark_mont_mul: Montgomery product a*b*2^-128 mod p, elementwise.
//   Replaces the JAX package's only TPU kernel, K0:
//   stark_anatomy_tpu/field/pallas_kernels.py:mont_mul_pallas_core (body
//   _mm_kernel -> _mont_mul_block), whose default TPU lowering is
//   field/ops.py:_mont_mul_rows.
// H0 stark_mont_pow: x^e in Montgomery form for a host exponent e < 2^128,
//   elementwise, the whole square-and-multiply ladder in one launch.
//   Replaces the jnp scan over K0 stark_anatomy_tpu/field/ops.py:mont_pow,
//   which the Rescue S-box x^(1/3) (models/rescue_prime.py) and the
//   Fermat inverse x^(p-2) (ops.py:inv, batch_inv) run.
// H1 stark_add_mod / stark_sub_mod: modular add and subtract in [0, p).
//   Replace the jnp row functions field/limb_arith.py:add_mod_rows and
//   sub_mod_rows behind field/ops.py:add and sub.
//
// Layout: the JAX package's, kept at the port's public functions.  An
// element is 8 little-endian 16-bit limbs held in int32 lanes, on a limb
// axis: a tensor (batch, 8, n) stores limb k of element (b, j) at
// b*sb + k*sl + j*se.  The output is always contiguous (batch, 8, n).
// An operand of the binary kernels may broadcast: sb = 0 shares one (8, n)
// table across the batch, se = 0 one element across a row.  The ladder
// takes a contiguous (batch, 8, n) input.
//
// Design: one thread per element.  Each thread loads its 8 limbs (limb
// rows are strided by n, so neighbouring threads read neighbouring
// addresses and the loads coalesce), packs them into four 32-bit words,
// computes in registers and writes 8 limbs back.
//   * The product (mont_mul_words) uses p's sparse words (1, 0, 0,
//     0xCB800000): since p = 1 + 0xCB800000 * 2^96, the Montgomery
//     reduction takes one step of four 32x32->64 products (m * 0xCB800000)
//     and one 32-bit product, not four rounds of four products: 20 wide
//     products per element in all (16 for a*b) and one narrow one, in
//     short independent chains, then one conditional subtract of p.  H0
//     mont_mul is bound by operations on paper, but on the main path it is
//     launched on small tensors (a Rescue round runs on 2 elements, the
//     NTTs on at most 2 x 4096), so launch overhead sets its time.
//   * The ladder (pow_kernel) runs left-to-right square-and-multiply from
//     the top bit down, the order of the JAX scan and of the plain
//     version (the value is exact either way).  The accumulator and x stay
//     in registers for the whole chain, and the thread stores once.  The
//     exponent is the same for every thread, so the branch on each bit
//     does not diverge.  What bounds it: at the Rescue shape (2, 8, 1) the
//     roofline bound is under a nanosecond (128 bytes moved; 191 products
//     of 41 32-bit multiply operations for each of 2 elements).  Its time
//     is that of one thread's chain of dependent products, 191 for
//     ALPHA_INV and 250 for p - 2, each issued by one warp: about 27 us
//     and 34 us on an H100 SXM at 700 W.  Shared memory, TMA and the tensor cores
//     have no role here: each element's 32 bytes are read once and stay in
//     registers, no data is reused across threads, and the int8 IMMA path
//     would need 16 byte-limbs and a carry pass for every product of a
//     serial chain.  Cutting the chain's latency would take several lanes
//     per element (a warp-cooperative product); that is left to later
//     work.  Blocks are small (kPowThreads) so that a launch of a few
//     thousand elements spreads over many SMs.
//   * H1 is bound by memory: 96 bytes per element (two 32-byte inputs,
//     one 32-byte output) for about a dozen integer operations.
//
// Built by one nvcc call into a shared library with a plain C interface
// (field/kernels.py).  Every entry point launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

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

// r = a*b*2^-128 mod p for a, b < p.  r may alias a or b: both are read in
// full before r is written.
//
// Montgomery with one reduction step instead of four CIOS rounds, which
// p's shape allows.  p = 1 + kP3 * 2^96, so p^-1 = 1 - kP3 * 2^96 and
// -p^-1 = kP3 * 2^96 - 1 (mod 2^128), and for T = a*b = T_hi 2^128 + T_lo:
//   m = T * (-p^-1) mod 2^128 = c3 * 2^96 - T_lo,  c3 = t0 * kP3 mod 2^32,
//   T_lo + m = c3 * 2^96 + k * 2^128  (k is the borrow of that subtract),
//   (T + m p) / 2^128 = T_hi + k + (m * kP3 + c3) / 2^32,
// which is < 2p, so one conditional subtract of p finishes.  The four rows
// of a*b are independent chains, and the reduction is two short ones: the
// dependent path is shorter than that of four interleaved CIOS rounds,
// which matters because the ladder is a chain of these products.
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

template <typename Op>
__global__ void __launch_bounds__(256)
    binary_kernel(int32_t* __restrict__ out, Operand a, Operand b,
                  int64_t batch, int64_t n) {
  const int64_t total = batch * n;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t bi = idx / n;
    const int64_t j = idx - bi * n;
    uint32_t aw[4], bw[4], rw[4];
    load4(a, bi, j, aw);
    load4(b, bi, j, bw);
    Op()(aw, bw, rw);
    store4(out, bi, j, n, rw);
  }
}

constexpr int kPowThreads = 64;

// out = x^e, e = e_hi * 2^64 + e_lo of nbits bits (0 <= nbits <= 128).
__global__ void __launch_bounds__(kPowThreads)
    pow_kernel(int32_t* __restrict__ out, Operand x, int64_t batch, int64_t n,
               uint64_t e_lo, uint64_t e_hi, int nbits) {
  const int64_t total = batch * n;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t bi = idx / n;
    const int64_t j = idx - bi * n;
    uint32_t xw[4], acc[4];
    load4(x, bi, j, xw);
    if (nbits == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = one_mont_word(k);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = xw[k];
    }
#pragma unroll 1
    for (int i = nbits - 2; i >= 0; --i) {
      mont_mul_words(acc, acc, acc);
      const uint64_t word = i >= 64 ? e_hi >> (i - 64) : e_lo >> i;
      if (word & 1u) mont_mul_words(acc, xw, acc);
    }
    store4(out, bi, j, n, acc);
  }
}

int grid_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 30)) blocks = 1 << 30;  // grid-stride loop covers the rest
  return static_cast<int>(blocks);
}

template <typename Op>
int launch(void* out, const void* a, const void* b, int64_t batch, int64_t n,
           int64_t asb, int64_t asl, int64_t ase, int64_t bsb, int64_t bsl,
           int64_t bse, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = batch * n;
  if (total <= 0) return 0;
  constexpr int kThreads = 256;
  Operand oa{static_cast<const int32_t*>(a), asb, asl, ase};
  Operand ob{static_cast<const int32_t*>(b), bsb, bsl, bse};
  binary_kernel<Op><<<grid_for(total, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), oa, ob, batch, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stark_mont_mul(void* out, const void* a, const void* b, int64_t batch,
                   int64_t n, int64_t asb, int64_t asl, int64_t ase,
                   int64_t bsb, int64_t bsl, int64_t bse, void* stream,
                   int device) {
  return launch<MontMul>(out, a, b, batch, n, asb, asl, ase, bsb, bsl, bse,
                         stream, device);
}

int stark_add_mod(void* out, const void* a, const void* b, int64_t batch,
                  int64_t n, int64_t asb, int64_t asl, int64_t ase,
                  int64_t bsb, int64_t bsl, int64_t bse, void* stream,
                  int device) {
  return launch<AddMod>(out, a, b, batch, n, asb, asl, ase, bsb, bsl, bse,
                        stream, device);
}

int stark_sub_mod(void* out, const void* a, const void* b, int64_t batch,
                  int64_t n, int64_t asb, int64_t asl, int64_t ase,
                  int64_t bsb, int64_t bsl, int64_t bse, void* stream,
                  int device) {
  return launch<SubMod>(out, a, b, batch, n, asb, asl, ase, bsb, bsl, bse,
                        stream, device);
}

// x: contiguous (batch, 8, n).  e = e_hi * 2^64 + e_lo, nbits its bit
// length (0 gives the Montgomery one).
int stark_mont_pow(void* out, const void* x, int64_t batch, int64_t n,
                   uint64_t e_lo, uint64_t e_hi, int nbits, void* stream,
                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbits < 0 || nbits > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = batch * n;
  if (total <= 0) return 0;
  Operand ox{static_cast<const int32_t*>(x), 8 * n, n, 1};
  pow_kernel<<<grid_for(total, kPowThreads), kPowThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), ox, batch, n, e_lo, e_hi, nbits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
