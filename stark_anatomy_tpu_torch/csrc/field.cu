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
//   values).  Above 8192 points ops/ntt.py runs a four-step transform with
//   H3 as its row pass (the twiddles ride the first pass's post-scale).
// H6 stark_fri_fold: one round of the FRI fold on the card, with the
//   canonical form of the folded codeword (for H4's tree) and the next
//   round's inverse-domain table.  Replaces the jnp graphs
//   stark_anatomy_tpu/protocols/fri.py:_fold_kernel and _square_half, and
//   _fold_commit_padded without its tree (the tree stays H4).
// H7 stark_fri_fold_batched: H6 over a batch of B codewords in one launch,
//   one challenge per proof and the inverse-domain table shared.  Replaces
//   the jnp graph stark_anatomy_tpu/protocols/fri.py:_fold_kernel_batched
//   and _square_half as parallel/batch_prover.py:_fri_batch runs them.
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
//     version (the value is exact either way), each squaring by the
//     squaring product mont_sqr_words (10 word products for a*a, not 16).
//     The accumulator and x stay in registers for the whole chain, and
//     the thread stores once.  The exponent is the same for every thread,
//     so the branch on each bit does not diverge.  What bounds it: at the
//     Rescue shape (2, 8, 1) the roofline bound is under a nanosecond.
//     Its time is that of one warp issuing the chain's instructions: about
//     115 SASS instructions per product, at about 2 cycles each on an H100
//     SXM (PERF.md, tools/sass_count.py), so 190 products for ALPHA_INV
//     and 250 for p - 2 take about 25 us and 33 us at 700 W.  Independent
//     work in the same warp would not overlap: the warp is issue-bound,
//     not latency-bound.  Shared memory, TMA and the tensor cores have no
//     role here: each element's 32 bytes are read once and stay in
//     registers, no data is reused across threads, and the int8 IMMA path
//     would need 16 byte-limbs and a carry pass for every product of a
//     serial chain.  Blocks are small (kPowThreads) so that a launch of a
//     few thousand elements spreads over many SMs.
//   * H1 is bound by memory: 96 bytes per element (two 32-byte inputs,
//     one 32-byte output) for about a dozen integer operations.
//   * H2 (rescue_kernel) gives each state two adjacent lanes of a warp:
//     lane i holds element i in four words for all 27 rounds, runs its
//     own x^3, x^ALPHA_INV and round constants, and gets the other
//     element for the 2x2 MDS by one __shfl_xor_sync of its four words.
//     x^ALPHA_INV is a fixed chain (pow_alpha_inv) of 147 products, 127 of
//     them squarings by mont_sqr_words, in place of the 191-product
//     ladder.  Each lane stores its element of each round's state (the
//     trace) or of the last (the hash).  What bounds it: 27 * 153 = 4,131
//     products per lane, nanoseconds of the card's rate, and 64 bytes in
//     and 28 * 64 out per state.  Its time is that of one warp issuing
//     the chain's instructions, about 2 cycles each (PERF.md): one thread
//     per state ran the two elements' chains interleaved, and the round
//     still took twice one chain, because the warp issued both; in two
//     lanes one warp instruction serves both elements.  As for the
//     ladder, shared memory, TMA and the tensor cores have no role: each
//     step depends on the last, and the round constants and MDS matrix
//     are 512 bytes read by every lane alike (loads that the L1 cache
//     serves).  Blocks are small (kRescueThreads) so that a large batch
//     spreads over the SMs: B = 4096 gives 128 blocks of two warps.
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
//   * H6 (fri_fold_kernel) gives each thread one element i < h of the
//     folded codeword: it reads c[i], c[i + h] and u[i], computes
//     c'[i] = 2^-1 ((c[i] + c[i+h]) + alpha u[i] (c[i] - c[i+h])) (the
//     order of the JAX package's _fold_kernel; field arithmetic is exact,
//     so the order only matters for reading the two side by side), writes
//     it in Montgomery form and, by one more product with 1, in canonical
//     form, and for i < h/2 writes u[i]^2, the next round's table.  alpha
//     and 2^-1 come by value.  What bounds it: bytes.  Per folded element
//     it reads 96 (two codeword elements and u) and writes 80 (two
//     elements and half a u): 176 bytes against four products, an add
//     and a subtract of about 180 instructions.  At h = 2^23, the top
//     round of the 2^20-step MiMC proof, that is 1.48 GB, 0.44 ms at
//     3.35 TB/s.  The limb rows of each operand are read and written
//     coalesced, one pass over each array, nothing staged.
//   * H7 (fri_fold_batched_kernel) runs H6's element (fold_element, the
//     same device function) over a grid of (elements, proofs): blockIdx.y
//     is the proof, whose challenge every thread of the block loads from
//     the (B, 8, 1) tensor (the same 32 bytes for the block, an L1 hit),
//     so the challenges never pass through the host as launch arguments
//     and one launch folds the whole batch.  u is shared by the batch and
//     its square is written once, by proof 0's threads.  What bounds it:
//     bytes, as H6, but u is read by every proof (an L2 hit after the
//     first: 32 h bytes from device memory), so about 128 bytes an output
//     element plus 48 h.  At B = 64 and h = 2048, a production batch's
//     first round, that is 16.9 MB, about 5 us at 3.35 TB/s: under the
//     host time of a launch, which is what a round of the batch pays.
//
// Built by one nvcc call into a shared library with a plain C interface
// (field/kernels.py).  Every entry point launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include "field_arith.cuh"

namespace {

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
    mont_sqr_words(acc, acc);
    const uint64_t word = i >= 64 ? e_hi >> (i - 64) : e_lo >> i;
    if (word & 1u) mont_mul_words(acc, x, acc);
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
    mont_pow_words(xw, e_lo, e_hi, nbits, acc);
    store4(out, bi, j, n, acc);
  }
}

constexpr int kRescueM = 2;
constexpr int kRescueRounds = 27;
constexpr int kRescueThreads = 64;      // two warps: 32 states a block
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// Lane i of a state's pair holds element i; o is the other element,
// fetched from the neighbouring lane.  s <- row i of MDS * (s0, s1).
__device__ __forceinline__ void rescue_mds_lane(const uint32_t m_own[4],
                                                const uint32_t m_other[4],
                                                uint32_t s[4]) {
  uint32_t o[4], t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = __shfl_xor_sync(kFullWarp, s[k], 1);
  mont_mul_words(s, m_own, t);
  mont_mul_words(o, m_other, s);
  AddMod()(t, s, s);
}

// s <- s + rc[(round * 2 + half) * m + i], rc as (N, 2, m, 8) limbs.
__device__ __forceinline__ void rescue_add_constant(const int32_t* rc, int round,
                                                    int half, int i, uint32_t s[4]) {
  const Operand table{rc, 8, 1, 0};
  uint32_t c[4];
  load4(table, (round * 2 + half) * kRescueM + i, 0, c);
  AddMod()(s, c, s);
}

// r = x^ALPHA_INV, ALPHA_INV = (2p - 1) / 3 = 0x87AA...AB, the Rescue
// S-box x^(1/3), by the fixed chain ALPHA_INV_CHAIN of field/kernels.py,
// step for step: 127 squarings and 20 multiplies (147 products, against
// the ladder's 191).  r must not alias x.
__device__ __forceinline__ void pow_alpha_inv(const uint32_t x[4], uint32_t r[4]) {
  uint32_t x5[4], x10[4], x40[4], x85[4], xaa[4], xab[4], t[4];
  mont_sqr_words(x, t);          // x^2
  mont_sqr_words(t, t);          // x^4
  mont_mul_words(t, x, x5);      // x^5
  mont_sqr_words(x5, x10);       // x^10
  mont_sqr_words(x10, t);        // x^20
  mont_sqr_words(t, x40);        // x^40
  mont_sqr_words(x40, t);        // x^80
  mont_mul_words(t, x5, x85);    // x^0x55
  mont_sqr_words(x85, xaa);      // x^0xAA
  mont_mul_words(xaa, x, xab);   // x^0xAB
  mont_mul_words(x85, x40, t);   // x^125
  mont_mul_words(t, x10, r);     // x^0x87, the top byte
  // the 15 lower bytes, 0xAA fourteen times then 0xAB: 8 squarings and a
  // multiply each (the factor is selected word by word, so that both stay
  // in registers).  The squarings stay a loop: unrolled, the kernel's code
  // grew by about 14 KB and H2 ran 5-10% slower (PERF.md).
#pragma unroll 1
  for (int byte = 0; byte < 15; ++byte) {
#pragma unroll 1
    for (int k = 0; k < 8; ++k) mont_sqr_words(r, r);
    uint32_t f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = byte < 14 ? xaa[k] : xab[k];
    mont_mul_words(r, f, r);
  }
}

// state: contiguous (m, 8, batch).  rc: (N, 2, m, 8) limbs, mds: (m, m, 8)
// limbs, both Montgomery form.  out: (N + 1, m, 8, batch), every state from
// the input on, if collect_trace; else the final state (m, 8, batch).
//
// Two adjacent lanes of a warp run one state, lane i its element i, so one
// warp instruction advances both elements' chains.  Every lane of a warp
// runs the same loop trips (the loop advances whole warps: 16 states), so
// the shuffles see a full warp; a lane past the batch runs on the last
// state and stores nothing.
__global__ void __launch_bounds__(kRescueThreads)
    rescue_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ state,
                  int64_t batch, const int32_t* __restrict__ rc,
                  const int32_t* __restrict__ mds_limbs, int collect_trace) {
  const Operand in{state, 8 * batch, batch, 1};
  const Operand mds_table{mds_limbs, 8, 1, 0};
  const int i = threadIdx.x & 1;
  uint32_t m_own[4], m_other[4];
  load4(mds_table, i * kRescueM + i, 0, m_own);
  load4(mds_table, i * kRescueM + (1 - i), 0, m_other);
  const int64_t lane = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t step = (static_cast<int64_t>(gridDim.x) * blockDim.x) / kRescueM;
  const int pair = (threadIdx.x & 31) / kRescueM;     // the state's place in its warp
  for (int64_t first = (lane - (threadIdx.x & 31)) / kRescueM; first < batch; first += step) {
    const int64_t b = first + pair;
    const bool live = b < batch;
    uint32_t s[4], root[4];
    load4(in, i, live ? b : batch - 1, s);
    if (collect_trace && live) store4(out, i, b, batch, s);
#pragma unroll 1
    for (int r = 0; r < kRescueRounds; ++r) {
      // forward half-round: x^3, MDS, constants
      mont_sqr_words(s, root);
      mont_mul_words(root, s, s);
      rescue_mds_lane(m_own, m_other, s);
      rescue_add_constant(rc, r, 0, i, s);
      // backward half-round: x^(1/3), MDS, constants
      pow_alpha_inv(s, root);
      rescue_mds_lane(m_own, m_other, root);
      rescue_add_constant(rc, r, 1, i, root);
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] = root[k];
      if (collect_trace && live) store4(out, (r + 1) * kRescueM + i, b, batch, s);
    }
    if (!collect_trace && live) store4(out, i, b, batch, s);
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

constexpr int kFoldThreads = 256;

// One element of the FRI fold, shared by H6 and H7: from c[i] = a,
// c[i + h] = b and u[i], folded = 2^-1 ((a + b) + alpha u (a - b)) in
// Montgomery form and canon its canonical form (one more product with 1).
__device__ __forceinline__ void fold_element(const uint32_t a[4], const uint32_t b[4],
                                             const uint32_t ui[4], const uint32_t alpha[4],
                                             const uint32_t two_inv[4], uint32_t folded[4],
                                             uint32_t canon[4]) {
  uint32_t s[4], d[4], au[4];
  AddMod()(a, b, s);
  SubMod()(a, b, d);
  mont_mul_words(alpha, ui, au);
  mont_mul_words(au, d, d);
  AddMod()(s, d, s);
  mont_mul_words(two_inv, s, folded);
  const uint32_t one[4] = {1u, 0u, 0u, 0u};
  mont_mul_words(folded, one, canon);
}

// c: contiguous (8, 2h) Montgomery codeword; u: contiguous (8, h).  Writes
// folded and canon (8, h) and u2 (8, h/2).  alpha and two_inv are
// Montgomery words, least significant first.
__global__ void __launch_bounds__(kFoldThreads)
    fri_fold_kernel(int32_t* __restrict__ folded, int32_t* __restrict__ canon,
                    int32_t* __restrict__ u2, const int32_t* __restrict__ c,
                    const int32_t* __restrict__ u, int64_t h, uint4 alpha4,
                    uint4 two_inv4) {
  const Operand cw{c, 0, 2 * h, 1};
  const Operand ut{u, 0, h, 1};
  uint32_t alpha[4], two_inv[4];
  to_words(alpha4, alpha);
  to_words(two_inv4, two_inv);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < h;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint32_t a[4], b[4], ui[4], f[4], cn[4];
    load4(cw, 0, i, a);
    load4(cw, 0, i + h, b);
    load4(ut, 0, i, ui);
    fold_element(a, b, ui, alpha, two_inv, f, cn);
    store4(folded, 0, i, h, f);
    store4(canon, 0, i, h, cn);
    if (i < h / 2) {
      mont_sqr_words(ui, ui);
      store4(u2, 0, i, h / 2, ui);
    }
  }
}

// H7.  c: contiguous (B, 8, 2h) Montgomery codewords; u: contiguous (8, h),
// shared; alphas: contiguous (B, 8, 1) Montgomery challenges, one a proof.
// Writes folded and canon (B, 8, h) and u2 (8, h/2).  blockIdx.y is the
// proof; the x dimension strides over its h elements.  Only proof 0's
// threads write u2, so each of its elements is written once.
__global__ void __launch_bounds__(kFoldThreads)
    fri_fold_batched_kernel(int32_t* __restrict__ folded, int32_t* __restrict__ canon,
                            int32_t* __restrict__ u2, const int32_t* __restrict__ c,
                            const int32_t* __restrict__ u,
                            const int32_t* __restrict__ alphas, int64_t h,
                            uint4 two_inv4) {
  const int64_t proof = blockIdx.y;
  const Operand cw{c, 16 * h, 2 * h, 1};
  const Operand ut{u, 0, h, 1};
  const Operand al{alphas, 8, 1, 0};
  uint32_t alpha[4], two_inv[4];
  load4(al, proof, 0, alpha);
  to_words(two_inv4, two_inv);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < h;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint32_t a[4], b[4], ui[4], f[4], cn[4];
    load4(cw, proof, i, a);
    load4(cw, proof, i + h, b);
    load4(ut, 0, i, ui);
    fold_element(a, b, ui, alpha, two_inv, f, cn);
    store4(folded, proof, i, h, f);
    store4(canon, proof, i, h, cn);
    if (proof == 0 && i < h / 2) {
      mont_sqr_words(ui, ui);
      store4(u2, 0, i, h / 2, ui);
    }
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
// if collect_trace, else (2, 8, batch).  The backward S-box is x^ALPHA_INV
// (pow_alpha_inv); the wrapper refuses any other exponent.
int stark_rescue_perm(void* out, const void* state, int64_t batch,
                      const void* rc, const void* mds, int collect_trace,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0) return 0;
  rescue_kernel<<<grid_for(batch * kRescueM, kRescueThreads), kRescueThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const int32_t*>(state), batch,
      static_cast<const int32_t*>(rc), static_cast<const int32_t*>(mds),
      collect_trace);
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

// c: contiguous (8, 2h) Montgomery codeword, u: contiguous (8, h), h >= 2.
// folded, canon: contiguous (8, h); u2: contiguous (8, h/2).  alpha and
// two_inv: Montgomery form, as low and high 64-bit halves.
int stark_fri_fold(void* folded, void* canon, void* u2, const void* c,
                   const void* u, int64_t h, uint64_t alpha_lo,
                   uint64_t alpha_hi, uint64_t two_inv_lo, uint64_t two_inv_hi,
                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h < 2) return static_cast<int>(cudaErrorInvalidValue);
  const uint4 alpha = make_uint4(static_cast<uint32_t>(alpha_lo),
                                 static_cast<uint32_t>(alpha_lo >> 32),
                                 static_cast<uint32_t>(alpha_hi),
                                 static_cast<uint32_t>(alpha_hi >> 32));
  const uint4 two_inv = make_uint4(static_cast<uint32_t>(two_inv_lo),
                                   static_cast<uint32_t>(two_inv_lo >> 32),
                                   static_cast<uint32_t>(two_inv_hi),
                                   static_cast<uint32_t>(two_inv_hi >> 32));
  fri_fold_kernel<<<grid_for(h, kFoldThreads), kFoldThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(folded), static_cast<int32_t*>(canon),
      static_cast<int32_t*>(u2), static_cast<const int32_t*>(c),
      static_cast<const int32_t*>(u), h, alpha, two_inv);
  return static_cast<int>(cudaGetLastError());
}

// H7.  c: contiguous (batch, 8, 2h) Montgomery codewords, u: contiguous
// (8, h), alphas: contiguous (batch, 8, 1) Montgomery, h >= 2 and
// 1 <= batch <= 65535 (the grid's y dimension).  folded, canon:
// contiguous (batch, 8, h); u2: contiguous (8, h/2).  two_inv: Montgomery
// form, as low and high 64-bit halves.
int stark_fri_fold_batched(void* folded, void* canon, void* u2, const void* c,
                           const void* u, const void* alphas, int64_t batch,
                           int64_t h, uint64_t two_inv_lo, uint64_t two_inv_hi,
                           void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h < 2 || batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const uint4 two_inv = make_uint4(static_cast<uint32_t>(two_inv_lo),
                                   static_cast<uint32_t>(two_inv_lo >> 32),
                                   static_cast<uint32_t>(two_inv_hi),
                                   static_cast<uint32_t>(two_inv_hi >> 32));
  const dim3 grid(grid_for(h, kFoldThreads), static_cast<unsigned>(batch));
  fri_fold_batched_kernel<<<grid, kFoldThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(folded), static_cast<int32_t*>(canon),
      static_cast<int32_t*>(u2), static_cast<const int32_t*>(c),
      static_cast<const int32_t*>(u), static_cast<const int32_t*>(alphas), h, two_inv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
