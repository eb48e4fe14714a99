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
// H2 stark_rescue_perm: the 27-round Rescue-Prime permutation on a batch of
//   m = 2 states in one launch, optionally writing all 28 states.
//   Replaces stark_anatomy_tpu/models/rescue_prime.py:_permutation_scan
//   (trace_batch, hash_batch), a lax.scan over K0 and the jnp adds.
// H3 stark_ntt: a whole radix-2 NTT of n <= 8192 points in one thread
//   block, with the optional pre-scale, post-scale and 1/n.  Replaces
//   stark_anatomy_tpu/ops/ntt.py:ntt_core/_stages, _lde_core and
//   _coset_interp_core, and ops/stage_ntt.py:staged_ntt_core (the same
//   values).
//
// Layout: the JAX package's, kept at the port's public functions.  An
// element is 8 little-endian 16-bit limbs held in int32 lanes, on a limb
// axis: a tensor (batch, 8, n) stores limb k of element (b, j) at
// b*sb + k*sl + j*se.  The output is always contiguous (batch, 8, n).
// An operand of the binary kernels may broadcast: sb = 0 shares one (8, n)
// table across the batch, se = 0 one element across a row.  The ladder
// takes a contiguous (batch, 8, n) input.
//
// Design of H0 and H1: one thread per element.  Each thread loads its 8
// limbs (limb rows are strided by n, so neighbouring threads read
// neighbouring addresses and the loads coalesce), packs them into four
// 32-bit words, computes in registers and writes 8 limbs back.
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
//   * H2 (rescue_kernel) gives one thread a whole state: its two elements
//     stay in registers for all 27 rounds (x^3, the 2x2 MDS, the forward
//     constants, x^ALPHA_INV by the shared ladder mont_pow_words, the MDS,
//     the backward constants), and the thread stores each round's state
//     (the trace) or only the last (the hash).  The ladder runs both
//     elements' chains in one loop.  What bounds it: 27 * (2 * 193 + 8)
//     = 10,638 products of 41 operations per state, nanoseconds of the
//     card's rate, and 64 bytes in and 28 * 64 bytes out.  Its time is
//     that of one warp running 27 rounds of two 191-product ladders.
//     Measured, a round takes about twice one ladder's time, so the two
//     chains do not overlap.  Why is not measured: either one warp's
//     product already issues about one instruction a cycle, or the
//     compiler serialises the two chains and each product waits out its
//     latency.  A SASS count per product or an issue-slot reading would
//     tell them apart.  As for the ladder,
//     shared memory, TMA and the tensor cores have no role: the main
//     path runs one state (one warp of which one lane works), each step
//     depends on the last, and the round constants and MDS matrix are
//     512 bytes read by every thread alike (broadcast loads that the L1
//     cache serves).  Blocks are small (kRescueThreads) so that a large
//     batch spreads over the SMs.
//   * H3 (ntt_kernel) gives each transform one block of kNttThreads,
//     with the whole transform in dynamic shared memory as four 32-bit
//     words per element, and the n/2 twiddles beside it (24 n bytes:
//     96 KiB at n = 4096, 192 KiB at n = 8192, above the default 48 KiB,
//     so the launch raises the block's limit).  Each thread loads limb
//     rows coalesced, applies the pre-scale, and stores the element at
//     its bit-reversed place (__brev); the block copies the twiddles
//     omega^j, j < n/2, from the (8, n) power table.  Then log2(n)
//     radix-2 stages, each thread taking n/2 / blockDim butterflies, with
//     __syncthreads() between stages; a butterfly at position j of a
//     half-block m takes the twiddle omega^(j * n/(2m)).  On the way out
//     the thread folds in 1/n and the post-scale.  What bounds it: at
//     (2, 8, 4096) the bytes (in and out once, about 0.23 us); its time
//     is the n/2 log2(n) products issued by the one SM that holds a
//     transform.  On the main path a transform was six launches per
//     stage (76 for the LDE at n = 4096): that host time is the gap this
//     closes, not the device time.
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

// acc[w] = x[w]^e for W independent elements, e = e_hi * 2^64 + e_lo of
// nbits bits (0 <= nbits <= 128; nbits = 0 gives the Montgomery one).
// Left-to-right square and multiply from the top bit down.  The W chains
// share each step, so their products interleave.  acc must not alias x.
template <int W>
__device__ __forceinline__ void mont_pow_words(const uint32_t x[W][4],
                                               uint64_t e_lo, uint64_t e_hi,
                                               int nbits, uint32_t acc[W][4]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[w][k] = nbits == 0 ? one_mont_word(k) : x[w][k];
  }
#pragma unroll 1
  for (int i = nbits - 2; i >= 0; --i) {
#pragma unroll
    for (int w = 0; w < W; ++w) mont_mul_words(acc[w], acc[w], acc[w]);
    const uint64_t word = i >= 64 ? e_hi >> (i - 64) : e_lo >> i;
    if (word & 1u) {
#pragma unroll
      for (int w = 0; w < W; ++w) mont_mul_words(acc[w], x[w], acc[w]);
    }
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
    uint32_t xw[1][4], acc[1][4];
    load4(x, bi, j, xw[0]);
    mont_pow_words<1>(xw, e_lo, e_hi, nbits, acc);
    store4(out, bi, j, n, acc[0]);
  }
}

constexpr int kRescueM = 2;
constexpr int kRescueRounds = 27;
constexpr int kRescueThreads = 64;

// s <- MDS * s for the 2x2 matrix mds[i][j] (Montgomery words).
__device__ __forceinline__ void rescue_mds(const uint32_t mds[kRescueM][kRescueM][4],
                                           uint32_t s[kRescueM][4]) {
  uint32_t r[kRescueM][4], t[4];
#pragma unroll
  for (int i = 0; i < kRescueM; ++i) {
    mont_mul_words(s[0], mds[i][0], r[i]);
#pragma unroll
    for (int j = 1; j < kRescueM; ++j) {
      mont_mul_words(s[j], mds[i][j], t);
      AddMod()(r[i], t, r[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRescueM; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[i][k] = r[i][k];
  }
}

// s[i] <- s[i] + rc[(round * 2 + half) * m + i], rc as (N, 2, m, 8) limbs.
__device__ __forceinline__ void rescue_add_constants(const int32_t* rc, int round,
                                                     int half,
                                                     uint32_t s[kRescueM][4]) {
  const Operand table{rc, 8, 1, 0};
#pragma unroll
  for (int i = 0; i < kRescueM; ++i) {
    uint32_t c[4];
    load4(table, (round * 2 + half) * kRescueM + i, 0, c);
    AddMod()(s[i], c, s[i]);
  }
}

// state: contiguous (m, 8, batch).  rc: (N, 2, m, 8) limbs, mds: (m, m, 8)
// limbs, both Montgomery form.  out: (N + 1, m, 8, batch), every state from
// the input on, if collect_trace; else the final state (m, 8, batch).
// x^(1/3) is x^e with e = e_hi * 2^64 + e_lo of nbits bits (ALPHA_INV).
__global__ void __launch_bounds__(kRescueThreads)
    rescue_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ state,
                  int64_t batch, const int32_t* __restrict__ rc,
                  const int32_t* __restrict__ mds_limbs, uint64_t e_lo,
                  uint64_t e_hi, int nbits, int collect_trace) {
  const Operand in{state, 8 * batch, batch, 1};
  const Operand mds_table{mds_limbs, 8, 1, 0};
  uint32_t mds[kRescueM][kRescueM][4];
#pragma unroll
  for (int i = 0; i < kRescueM; ++i) {
#pragma unroll
    for (int j = 0; j < kRescueM; ++j) load4(mds_table, i * kRescueM + j, 0, mds[i][j]);
  }
  for (int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       b < batch; b += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint32_t s[kRescueM][4], root[kRescueM][4];
#pragma unroll
    for (int i = 0; i < kRescueM; ++i) {
      load4(in, i, b, s[i]);
      if (collect_trace) store4(out, i, b, batch, s[i]);
    }
#pragma unroll 1
    for (int r = 0; r < kRescueRounds; ++r) {
      // forward half-round: x^3, MDS, constants
#pragma unroll
      for (int i = 0; i < kRescueM; ++i) {
        uint32_t sq[4];
        mont_mul_words(s[i], s[i], sq);
        mont_mul_words(sq, s[i], s[i]);
      }
      rescue_mds(mds, s);
      rescue_add_constants(rc, r, 0, s);
      // backward half-round: x^(1/3), MDS, constants
      mont_pow_words<kRescueM>(s, e_lo, e_hi, nbits, root);
      rescue_mds(mds, root);
      rescue_add_constants(rc, r, 1, root);
#pragma unroll
      for (int i = 0; i < kRescueM; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) s[i][k] = root[i][k];
        if (collect_trace) store4(out, (r + 1) * kRescueM + i, b, batch, s[i]);
      }
    }
    if (!collect_trace) {
#pragma unroll
      for (int i = 0; i < kRescueM; ++i) store4(out, i, b, batch, s[i]);
    }
  }
}

constexpr int kNttMaxLog = 13;     // n <= 8192: 192 KiB of shared memory
constexpr int kNttThreads = 1024;

__device__ __forceinline__ void to_words(const uint4& v, uint32_t w[4]) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// One block per transform (row) of x, a (batch, 8, n) operand; n = 2^log_n.
// powers: the (8, n) table omega^j (omega^-j for the inverse).  pre and
// post scale the input and output where their ptr is set; n_inv, where
// set, is the (8, 1) constant 1/n of the inverse.  Shared memory: the n
// elements, then the n/2 twiddles omega^j, j < n/2, each 4 words.
__global__ void __launch_bounds__(kNttThreads)
    ntt_kernel(int32_t* __restrict__ out, Operand x, Operand powers, Operand pre,
               Operand post, Operand n_inv, int log_n) {
  extern __shared__ uint4 smem[];
  const int n = 1 << log_n;
  uint4* const twiddle = smem + n;
  const int64_t row = blockIdx.x;
  for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
    uint32_t w[4];
    load4(powers, 0, j, w);
    twiddle[j] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    uint32_t v[4];
    load4(x, row, j, v);
    if (pre.ptr != nullptr) {
      uint32_t c[4];
      load4(pre, row, j, c);
      mont_mul_words(v, c, v);
    }
    const int at = log_n == 0 ? 0 : static_cast<int>(__brev(static_cast<uint32_t>(j)) >> (32 - log_n));
    smem[at] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  for (int s = 0; s < log_n; ++s) {
    const int m = 1 << s;
    for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
      const int j = i & (m - 1);
      const int pos = ((i >> s) << (s + 1)) + j;
      uint32_t u[4], v[4], w[4], t[4];
      to_words(smem[pos], u);
      to_words(smem[pos + m], v);
      to_words(twiddle[j << (log_n - 1 - s)], w);
      mont_mul_words(v, w, t);
      AddMod()(u, t, v);             // u + t
      SubMod()(u, t, u);             // u - t
      smem[pos] = make_uint4(v[0], v[1], v[2], v[3]);
      smem[pos + m] = make_uint4(u[0], u[1], u[2], u[3]);
    }
    __syncthreads();
  }
  uint32_t scale[4];
  if (n_inv.ptr != nullptr) load4(n_inv, 0, 0, scale);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    uint32_t v[4];
    to_words(smem[j], v);
    if (n_inv.ptr != nullptr) mont_mul_words(v, scale, v);
    if (post.ptr != nullptr) {
      uint32_t c[4];
      load4(post, row, j, c);
      mont_mul_words(v, c, v);
    }
    store4(out, row, j, n, v);
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

// state: contiguous (2, 8, batch); rc: contiguous (27, 2, 2, 8) limbs and
// mds: contiguous (2, 2, 8) limbs, Montgomery form.  out: (28, 2, 8, batch)
// if collect_trace, else (2, 8, batch).  x^(1/3) = x^e, e = e_hi * 2^64 +
// e_lo of nbits bits.
int stark_rescue_perm(void* out, const void* state, int64_t batch,
                      const void* rc, const void* mds, uint64_t e_lo,
                      uint64_t e_hi, int nbits, int collect_trace, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbits < 0 || nbits > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  rescue_kernel<<<grid_for(batch, kRescueThreads), kRescueThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(state), batch,
      static_cast<const int32_t*>(rc), static_cast<const int32_t*>(mds), e_lo,
      e_hi, nbits, collect_trace);
  return static_cast<int>(cudaGetLastError());
}

// x and out: contiguous (batch, 8, n), n = 2^log_n <= 8192.  powers:
// contiguous (8, n), omega^j (omega^-j for the inverse).  pre and
// post: null, or operands with strides (sb, sl, se); n_inv: null or a
// contiguous (8, 1) constant.
int stark_ntt(void* out, const void* x, int64_t batch, int log_n,
              const void* powers,
              const void* pre, int64_t pre_sb, int64_t pre_sl, int64_t pre_se,
              const void* post, int64_t post_sb, int64_t post_sl,
              int64_t post_se, const void* n_inv, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (log_n < 0 || log_n > kNttMaxLog || batch > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const int64_t n = int64_t(1) << log_n;
  const int smem = static_cast<int>((n + n / 2) * sizeof(uint4));
  err = cudaFuncSetAttribute(ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = static_cast<int>(n / 2);
  threads = threads < 32 ? 32 : (threads > kNttThreads ? kNttThreads : threads);
  Operand ox{static_cast<const int32_t*>(x), 8 * n, n, 1};
  Operand ow{static_cast<const int32_t*>(powers), 0, n, 1};
  Operand opre{static_cast<const int32_t*>(pre), pre_sb, pre_sl, pre_se};
  Operand opost{static_cast<const int32_t*>(post), post_sb, post_sl, post_se};
  Operand oinv{static_cast<const int32_t*>(n_inv), 0, 1, 0};
  ntt_kernel<<<static_cast<int>(batch), threads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), ox, ow, opre, opost, oinv, log_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
