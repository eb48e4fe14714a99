// Field kernels for the 128-bit STARK field p = 1 + 407 * 2^119 on Hopper.
//
// H0 stark_mont_mul: Montgomery product a*b*2^-128 mod p, elementwise.
//   Replaces the JAX package's only TPU kernel, K0:
//   stark_anatomy_tpu/field/pallas_kernels.py:mont_mul_pallas_core (body
//   _mm_kernel -> _mont_mul_block), whose default TPU lowering is
//   field/ops.py:_mont_mul_rows.
// H0 stark_mont_pow: x^e in Montgomery form for a host exponent e < 2^128,
//   elementwise, the whole chain in one launch: a fixed addition chain
//   for the Fermat inverse's p - 2, square-and-multiply for any other e.
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
// H3 stark_ntt: a whole NTT of n <= 8192 points in one launch, with the
//   optional pre-scale, post-scale and 1/n.  Replaces
//   stark_anatomy_tpu/ops/ntt.py:ntt_core/_stages, _lde_core and
//   _coset_interp_core, and ops/stage_ntt.py:staged_ntt_core (the same
//   values).  Above 8192 points H8 (ntt_tiled.cu) runs the transform in
//   two tiled launches, its blocks running H3's passes (ntt_passes.cuh).
// H6 stark_fri_fold: one round of the FRI fold on the card, with the
//   canonical form of the folded codeword (for H4's tree) and the next
//   round's inverse-domain table.  Replaces the jnp graphs
//   stark_anatomy_tpu/protocols/fri.py:_fold_kernel and _square_half, and
//   _fold_commit_padded without its tree (the tree stays H4).
// H7 stark_fri_fold_batched: H6 over a batch of B codewords in one launch,
//   one challenge per proof and the inverse-domain table shared.  Replaces
//   the jnp graph stark_anatomy_tpu/protocols/fri.py:_fold_kernel_batched
//   and _square_half as parallel/batch_prover.py:_fri_batch runs them.
// H13 stark_sample_mont: a batch's randomness draws, each 17 bytes read as
//   a big-endian integer, to Montgomery field elements in one launch.
//   Replaces the host's Field.sample of each draw and utils/convert.py:
//   device_from_ints of the values (a Python int, a modulo and a re-encode
//   a draw) in parallel/batch_prover.py; the JAX package converts the
//   draws on the host (its parallel/batch_prover.py:prove_batch).
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
//   * The ladder (pow_kernel) computes x^e for a host exponent in one thread
//     per element, the accumulator and x in registers for the whole chain,
//     one store.  Where e = p - 2 (the Fermat inverse, the only exponent of
//     the measured paths above 2^10: batch_inv's root, one launch a verify
//     and one a 2^20 prove) it runs the fixed chain pow_inv, 154 products
//     (136 squarings, 18 multiplies) in place of the 250 of
//     square-and-multiply over p - 2's 124 one bits; every other exponent
//     runs left-to-right square-and-multiply from the top bit down (the
//     order of the JAX scan and of the plain version; the value is exact
//     either way).  Both run on the carry-flag product forms
//     (mont_mul_chain, mont_sqr_chain), which beat the plain-word ones on a
//     dependent chain of x^(p-2) on one thread (PERF.md).  The launcher
//     takes the chain itself when the exponent is p - 2.  The exponent is
//     the same for every thread, so the branch on each bit does not diverge.
//     What bounds it: at (8, 1) and (8, 128), the shapes the paths launch it
//     at, the roofline bound is under a nanosecond; the time is the latency
//     of one thread's dependent chain, its length in products times the
//     latency of one, so the design shortens the chain and each link: on an
//     H100 one x^(p-2) took 34.4 us by square and multiply on the plain-word
//     forms (138 ns a link) and 14.2 us by the fixed chain on the carry-flag
//     forms (92 ns a link; PERF.md).  Shared memory, TMA and the tensor
//     cores have no role here: each element's 32 bytes are read once and
//     stay in registers, no data is reused across threads, and the int8 IMMA
//     path would need 16 byte-limbs and a carry pass for every product of a
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
//   * H3 (ntt_kernel) runs a transform of n = 2^L points as Stockham
//     passes (each pass reads positions t + q n/8 and writes its outputs
//     in place of the bit reversal, so input and output stay in natural
//     order): radix 8 while three bits are left, then one pass of radix 4
//     or 2.  The thread t < n/8 of a transform holds 8 elements in
//     registers through a pass (the twiddles omega^(k r n/(Ns R)), then an
//     R-point DFT with constant twiddles: 5 products for R = 8), so 4096
//     points take 4 passes and 3 exchanges through shared memory (6
//     barriers), not 12 radix-2 stages and 12 barriers.  The first pass
//     reads device memory (its twiddles are all 1) and the last writes
//     it, with 1/n and the post-scale.  Shared memory holds only the
//     elements (16 n bytes, a 16-byte slot each, XOR-swizzled so that a
//     quarter warp's eight slots fall in eight bank groups); the twiddles
//     come through the read-only cache from a packed (n, 4) table (one
//     16-byte load each), which the wrapper packs once per power table.
//     A two-level table (omega^(64a + b) = omega^(64a) omega^b) would
//     cost a product per twiddle, 7 more products on a pass's 12.  The
//     products are mont_mul_chain, the carry-flag form of mont_mul_words.
//     Two paths (field/kernels.py:ntt_plan):
//       - cluster: where the batch would leave SMs idle (batch * 8 <= the
//         SM count, n >= 1024: the sign, the verify, the generic prover),
//         each transform is spread over a cluster of 8 blocks, element i
//         in block i / (n/8) (distributed shared memory:
//         cluster.map_shared_rank, cluster.sync; the cluster syncs once
//         before any block touches another's shared memory, so that every
//         block of it is known to run), so a 4096-point transform runs on
//         8 SMs, not 1;
//       - persistent: otherwise one block a transform (two at n = 8192,
//         whose 1024 threads one block cannot hold), a grid of the blocks
//         resident at once looping over the rows.  Up to n = 4096 the
//         block stages the next row's limbs into shared memory by
//         cp.async (32 n bytes beside the elements) while the current
//         row's passes run, and a per-row post-scale row (the four-step's
//         twiddles) the same way between them.
//     What bounds it: instructions.  At (4096, 8, 4096), the rows of the
//     four-step glue that H8 replaced,
//     the bytes are 1.61 GB with the post-scale (0.48 ms at 3.35 TB/s),
//     while about 6 products a point, some 170 SASS instructions each with
//     their adds, are about 0.53 ms of issue at the card's full rate, on
//     16 warps an SM (128 registers a thread); it ran 1.15 ms (PERF.md).
//     At the sign's (2, 8, 4096) the bytes are 0.2 us and the time is one
//     thread's chain of about 49 products.
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
//   * H13 (sample_mont_kernel) gives each thread one draw: it reads the
//     draw's 17 bytes from the contiguous (n, 17) uint8 upload, the first
//     byte most significant, and reduces the 136-bit value v mod p by p's
//     sparse form: with v = a 2^119 + b (a < 2^17, b < 2^119) and
//     a = 407 q + r (r < 407, q <= 322), 407 2^119 = p - 1 gives
//     v = r 2^119 + b - q (mod p), where r 2^119 + b <= p - 2, so one
//     subtract of q and at most one add of p finish (the division by the
//     constant 407 is a multiply and a shift).  One product by R^2 mod p
//     (mont_mul_words) takes it to Montgomery form; the thread stores its
//     8 limbs into the contiguous (8, n) output, element j of limb row k at
//     k n + j, the layout of device_from_ints.  What bounds it: bytes, 17
//     read and an element written a draw (16 bytes, as every bound here
//     counts an element; its int32 limbs take 32): at n = 98,304, a batch
//     of 64 signatures' draws, 98,304 x (17 + 16) bytes = 3.2 MB, about
//     1 us at 3.35 TB/s, against one product and a few dozen integer
//     operations a draw.  The neighbouring
//     threads' 17-byte reads fall in the same sectors, so the L1 cache
//     serves them; nothing is reused across threads.  The launch replaces
//     98,304 conversions on the host at 0.5-1 us each.
//
// Built by one nvcc call into a shared library with a plain C interface
// (field/kernels.py).  Every entry point launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "field_arith.cuh"
#include "ntt_passes.cuh"
#include "pow_chain.cuh"

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

constexpr int kNttMaxLog = 13;
constexpr int kNttMaxThreads = 512;     // threads a block: n/8 per transform, over C blocks

// Barrier over the threads of one transform: its block, or its cluster.
template <int C>
__device__ __forceinline__ void ntt_sync() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    cooperative_groups::this_cluster().sync();
  }
}

// Element i of a transform's exchange buffer (n/C elements in each block
// of its cluster, block i / (n/C) holding element i at i % (n/C)); a
// pointer into another block's shared memory where C > 1.
template <int C>
__device__ __forceinline__ uint4* ntt_elem(uint4* local, int per_log, int i) {
  if constexpr (C == 1) {
    return local + ntt_slot(i);
  } else {
    return cooperative_groups::this_cluster().map_shared_rank(local, i >> per_log) +
           ntt_slot(i & ((1 << per_log) - 1));
  }
}

// 16-byte asynchronous copies from device memory to shared memory.  A
// host compiler (a g++ build that checks the device code on the CPU) gets
// a plain copy.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
#ifdef __CUDACC__
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
#else
  memcpy(smem, gmem, 16);
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The block's threads copy the (8, n) limb rows at src (32 n bytes) into
// stage, asynchronously; the caller commits the group.
__device__ __forceinline__ void stage_rows(int32_t* stage, const int32_t* src, int n) {
  for (int c = threadIdx.x; c < 2 * n; c += blockDim.x) cp_async16(stage + 4 * c, src + 4 * c);
}

// Element j of a staged (8, n) limb row, as four words.
__device__ __forceinline__ void staged_words(const int32_t* stage, int n, int j, uint32_t w[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = (static_cast<uint32_t>(stage[2 * k * n + j]) & 0xFFFFu) |
           (static_cast<uint32_t>(stage[(2 * k + 1) * n + j]) << 16);
  }
}

constexpr int kPowThreads = 64;

// out = x^e: by the fixed chain pow_inv where kInv (e = p - 2), else by
// the ladder over e = e_hi * 2^64 + e_lo of nbits bits (0 <= nbits <= 128).
template <bool kInv>
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
    if constexpr (kInv) {
      pow_inv(xw, acc);
    } else {
      mont_pow_words(xw, e_lo, e_hi, nbits, acc);
    }
    store4(out, bi, j, n, acc);
  }
}

// Transforms of n <= 8 points: one thread a row, no shared memory.
template <int R>
__device__ __forceinline__ void ntt_tiny(int32_t* __restrict__ out, const Operand& x,
                                         const uint4* __restrict__ tw, const Operand& pre,
                                         const Operand& post, const Operand& n_inv, int log_n,
                                         int64_t row) {
  uint32_t v[8][4], c[4];
  const int n = 1 << log_n;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    load4(x, row, j, v[j]);
    if (pre.ptr != nullptr) {
      load4(pre, row, j, c);
      mont_mul_chain(v[j], c, v[j]);
    }
  }
  if constexpr (R > 1) dft<R>(v, tw, log_n);
  if (n_inv.ptr != nullptr) load4(n_inv, 0, 0, c);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (n_inv.ptr != nullptr) mont_mul_chain(v[j], c, v[j]);
    if (post.ptr != nullptr) {
      uint32_t d[4];
      load4(post, row, j, d);
      mont_mul_chain(v[j], d, v[j]);
    }
    if (j < n) store4(out, row, j, n, v[j]);
  }
}

// H3 for 2^log_n >= 16 points, the last pass of radix RL: the rows from
// `row` on, every `step`.  See ntt_kernel.
template <int C, bool kStage, int RL>
__device__ __forceinline__ void ntt_rows(int32_t* __restrict__ out, const Operand& x,
                                         const uint4* __restrict__ tw, const Operand& pre,
                                         const Operand& post, const Operand& n_inv, int log_n,
                                         int64_t batch, uint4* smem, int64_t row, int64_t step) {
  const int n = 1 << log_n;
  const int lg_t = log_n - 3;
  const int rank = C == 1 ? 0 : static_cast<int>(blockIdx.x % C);
  const int t = rank * blockDim.x + threadIdx.x;
  const int per_log = log_n - (C >= 2) - (C >= 4) - (C >= 8);     // log2(n / C)
  int32_t* const stage = reinterpret_cast<int32_t*>(smem + (n / C));
  const int npass = (log_n + 2) / 3;
  const int lg_last = 3 * (npass - 1);                             // log2 of the last pass's Ns
  uint32_t ninv[4];
  if (n_inv.ptr != nullptr) load4(n_inv, 0, 0, ninv);
  if constexpr (C > 1) ntt_sync<C>();      // every block of the cluster runs
  if (kStage && row < batch) {
    stage_rows(stage, x.ptr + row * x.sb, n);
    cp_async_commit();
  }
  for (; row < batch; row += step) {
    const int64_t next = row + step;
    uint32_t v[8][4];
    // the first pass: radix 8, no twiddles, elements t + r T from device
    // memory or the staged row, with the pre-scale
    if (kStage) {
      cp_async_wait_all();
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = t + (r << lg_t);
      if (kStage) {
        staged_words(stage, n, j, v[r]);
      } else {
        load4(x, row, j, v[r]);
      }
      if (pre.ptr != nullptr) {
        uint32_t c[4];
        load4(pre, row, j, c);
        mont_mul_chain(v[r], c, v[r]);
      }
    }
    ntt_pass<8>(v, tw, log_n, t, lg_t, 0);
#pragma unroll
    for (int s = 0; s < 8; ++s) *ntt_elem<C>(smem, per_log, ntt_dest<8>(t, s, 0)) = from_words(v[s]);
    ntt_sync<C>();
    if (kStage && next < batch) {          // every thread has read the staged input
      stage_rows(stage, x.ptr + next * x.sb, n);
      cp_async_commit();
    }
    // the passes between: radix 8 through the exchange buffer
    for (int lg_ns = 3; lg_ns < lg_last; lg_ns += 3) {
#pragma unroll
      for (int r = 0; r < 8; ++r) to_words(*ntt_elem<C>(smem, per_log, ntt_src<8>(t, lg_t, r)), v[r]);
      ntt_sync<C>();
      ntt_pass<8>(v, tw, log_n, t, lg_t, lg_ns);
#pragma unroll
      for (int s = 0; s < 8; ++s)
        *ntt_elem<C>(smem, per_log, ntt_dest<8>(t, s, lg_ns)) = from_words(v[s]);
      ntt_sync<C>();
    }
    // the last pass: radix RL, to device memory with 1/n and the post-scale
#pragma unroll
    for (int i = 0; i < 8; ++i) to_words(*ntt_elem<C>(smem, per_log, ntt_src<RL>(t, lg_t, i)), v[i]);
    ntt_sync<C>();                         // every input of this pass is read
    ntt_pass<RL>(v, tw, log_n, t, lg_t, lg_last);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = ntt_dest<RL>(t + ((i / RL) << lg_t), i % RL, lg_last);
      if (n_inv.ptr != nullptr) mont_mul_chain(v[i], ninv, v[i]);
      if (post.ptr != nullptr) {
        uint32_t c[4];
        load4(post, row, j, c);
        mont_mul_chain(v[i], c, v[i]);
      }
      store4(out, row, j, n, v[i]);
    }
  }
}

// H3.  One transform (row) of x, a contiguous (batch, 8, n) operand, per
// C blocks (a cluster where C > 1), rows in turn over a persistent grid:
// row blockIdx.x / C, then every gridDim.x / C.  tw: the packed (n, 4)
// word table omega^e, e < n (omega^-e for the inverse).  pre and post
// scale the input and the output where their ptr is set; n_inv, where
// set, is the (8, 1) constant 1/n of the inverse.  From n = 16 up the
// transform runs as Stockham passes of radix 8, then one of radix 8, 4 or
// 2 (ntt_rows), the thread t < T = n/8 of a transform holding 8 elements
// in registers in each: the first pass reads device memory (or the staged
// row), the last writes it, and the passes between exchange through
// shared memory (n/C elements a block).  With kStage (C = 1) the block
// stages the next row's limbs by cp.async (32 n bytes after the exchange
// buffer) while the current row's passes run.  Up to 8 points, one thread
// a row (ntt_tiny).
template <int C, bool kStage>
__global__ void __launch_bounds__(kNttMaxThreads)
    ntt_kernel(int32_t* __restrict__ out, Operand x, const uint4* __restrict__ tw, Operand pre,
               Operand post, Operand n_inv, int log_n, int64_t batch) {
  extern __shared__ uint4 smem[];
  const int64_t step = gridDim.x / C;
  const int64_t row = blockIdx.x / C;
  if (log_n <= 3) {
    if (C == 1 && threadIdx.x == 0) {
      for (int64_t r = row; r < batch; r += step) {
        if (log_n == 0) {
          ntt_tiny<1>(out, x, tw, pre, post, n_inv, log_n, r);
        } else if (log_n == 1) {
          ntt_tiny<2>(out, x, tw, pre, post, n_inv, log_n, r);
        } else if (log_n == 2) {
          ntt_tiny<4>(out, x, tw, pre, post, n_inv, log_n, r);
        } else {
          ntt_tiny<8>(out, x, tw, pre, post, n_inv, log_n, r);
        }
      }
    }
    return;
  }
  if (log_n % 3 == 0) {
    ntt_rows<C, kStage, 8>(out, x, tw, pre, post, n_inv, log_n, batch, smem, row, step);
  } else if (log_n % 3 == 1) {
    ntt_rows<C, kStage, 2>(out, x, tw, pre, post, n_inv, log_n, batch, smem, row, step);
  } else {
    ntt_rows<C, kStage, 4>(out, x, tw, pre, post, n_inv, log_n, batch, smem, row, step);
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

constexpr int kSampleThreads = 256;
constexpr int kSampleBytes = 17;       // a draw: Field.sample's bytes, big-endian

// x = v mod p for v = top 2^128 + w (w in 32-bit words, least significant
// first), v < 2^136: v = a 2^119 + b, a = 407 q + r, and 407 2^119 = p - 1,
// so v = r 2^119 + b - q (mod p) with r 2^119 + b <= p - 2 and q <= 322.
__device__ __forceinline__ void reduce_136(uint32_t top, const uint32_t w[4], uint32_t x[4]) {
  const uint32_t a = (top << 9) | (w[3] >> 23);
  const uint32_t q = a / 407u;
  const uint32_t r = a - 407u * q;
  x[0] = w[0];
  x[1] = w[1];
  x[2] = w[2];
  x[3] = (w[3] & 0x7FFFFFu) | (r << 23);
  uint64_t borrow = q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t t = static_cast<uint64_t>(x[k]) - borrow;
    x[k] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1u;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t s = static_cast<uint64_t>(x[k]) + p_word(k) + c;
      x[k] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
  }
}

// H13.  raw: contiguous (n, 17) bytes, draw j's big-endian value at
// raw[17 j ..]; out: contiguous (8, n), each value mod p in Montgomery
// form.  r2: R^2 mod p in words, least significant first.
__global__ void __launch_bounds__(kSampleThreads)
    sample_mont_kernel(int32_t* __restrict__ out, const uint8_t* __restrict__ raw, int64_t n,
                       uint4 r2_4) {
  uint32_t r2[4];
  to_words(r2_4, r2);
  for (int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; j < n;
       j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint8_t* b = raw + kSampleBytes * j;
    uint32_t w[4], x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint8_t* lo = b + kSampleBytes - 1 - 4 * k;        // the word's least significant byte
      w[k] = static_cast<uint32_t>(lo[0]) | (static_cast<uint32_t>(lo[-1]) << 8) |
             (static_cast<uint32_t>(lo[-2]) << 16) | (static_cast<uint32_t>(lo[-3]) << 24);
    }
    reduce_136(b[0], w, x);
    mont_mul_words(x, r2, x);
    store4(out, 0, j, n, x);
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

// The blocks of ntt_kernel instance `inst` (kernel) resident on the card
// at once with `threads` and `smem` bytes, at this log_n: found on the
// first launch of each (device, instance, log_n) and kept, so that a later
// launch makes no runtime call but cudaLaunchKernelEx.  The dynamic shared
// memory limit of an instance is only ever raised, so a kept count stays
// true.
template <typename F>
cudaError_t ntt_resident(F kernel, int inst, int log_n, int threads, int smem, int device,
                         int64_t* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int64_t> resident;
  static std::map<std::tuple<int, int>, int> smem_limit;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, inst, log_n);
  const auto found = resident.find(key);
  if (found != resident.end()) {
    *blocks = found->second;
    return cudaSuccess;
  }
  int& limit = smem_limit[std::make_tuple(device, inst)];
  cudaError_t err = cudaSuccess;
  if (smem > limit) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    limit = smem;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = resident[key] = static_cast<int64_t>(per_sm) * sms;
  return cudaSuccess;
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
// length (0 gives the Montgomery one).  e = p - 2 runs the fixed chain of
// x^(p-2), any other e the ladder (field/kernels.py:pow_route states the
// same rule).
int stark_mont_pow(void* out, const void* x, int64_t batch, int64_t n,
                   uint64_t e_lo, uint64_t e_hi, int nbits, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbits < 0 || nbits > 128) return static_cast<int>(cudaErrorInvalidValue);
  // p - 2 = 0xCB7FFFFF FFFFFFFF FFFFFFFF FFFFFFFF
  const bool inv = e_lo == ~uint64_t(0) && e_hi == (uint64_t(kP3) << 32) - 1 && nbits == 128;
  const int64_t total = batch * n;
  if (total <= 0) return 0;
  Operand ox{static_cast<const int32_t*>(x), 8 * n, n, 1};
  auto kernel = inv ? pow_kernel<true> : pow_kernel<false>;
  kernel<<<grid_for(total, kPowThreads), kPowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

// x and out: contiguous (batch, 8, n), n = 2^log_n <= 8192.  twiddles:
// contiguous (n, 4) words, omega^e packed (omega^-e for the inverse).  pre
// and post: null, or operands with strides (sb, sl, se); n_inv: null or a
// contiguous (8, 1) constant.  cluster: the blocks a transform is spread
// over, 1, 2 or 8 (with n/8 a multiple of it); stage (cluster 1 only,
// n <= 4096): prefetch each row by cp.async.  The grid holds every row, or
// as many clusters as are resident at once, which then loop over the rows.
int stark_ntt(void* out, const void* x, int64_t batch, int log_n, const void* twiddles,
              const void* pre, int64_t pre_sb, int64_t pre_sl, int64_t pre_se,
              const void* post, int64_t post_sb, int64_t post_sl,
              int64_t post_se, const void* n_inv, int cluster, int stage, void* stream,
              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = int64_t(1) << (log_n < 0 ? 0 : log_n);
  const int64_t threads_all = n >= 8 ? n / 8 : 1;
  if (log_n < 0 || log_n > kNttMaxLog || batch > 0x7FFFFFFF ||
      (cluster != 1 && cluster != 2 && cluster != 8) || threads_all % cluster != 0 ||
      threads_all / cluster > kNttMaxThreads || (stage && (cluster != 1 || n > 4096)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       (post == nullptr || reinterpret_cast<uintptr_t>(post) % 16 == 0);
  const bool staged = stage && aligned;
  const int threads = static_cast<int>(threads_all / cluster);
  const int smem = static_cast<int>((n / cluster) * sizeof(uint4) + (staged ? 32 * n : 0));
  Operand ox{static_cast<const int32_t*>(x), 8 * n, n, 1};
  Operand opre{static_cast<const int32_t*>(pre), pre_sb, pre_sl, pre_se};
  Operand opost{static_cast<const int32_t*>(post), post_sb, post_sl, post_se};
  Operand oinv{static_cast<const int32_t*>(n_inv), 0, 1, 0};
  const uint4* tw = static_cast<const uint4*>(twiddles);
  int32_t* o = static_cast<int32_t*>(out);
  const int inst = cluster == 8 ? 0 : cluster == 2 ? 1 : staged ? 2 : 3;
  auto kernel = inst == 0 ? ntt_kernel<8, false>
                : inst == 1 ? ntt_kernel<2, false>
                : inst == 2 ? ntt_kernel<1, true> : ntt_kernel<1, false>;
  // rows in flight: every row, or the clusters resident at once
  int64_t resident = 0;
  err = ntt_resident(kernel, inst, log_n, threads, smem, device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t rows = resident / cluster;
  if (rows < 1) rows = 1;
  if (rows > batch) rows = batch;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows * cluster));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, o, ox, tw, opre, opost, oinv, log_n, batch);
  if (err != cudaSuccess) return static_cast<int>(err);
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

// H13.  raw: contiguous (n, 17) bytes; out: contiguous (8, n).  r2: R^2
// mod p as low and high 64-bit halves.
int stark_sample_mont(void* out, const void* raw, int64_t n, uint64_t r2_lo, uint64_t r2_hi,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const uint4 r2 = make_uint4(static_cast<uint32_t>(r2_lo), static_cast<uint32_t>(r2_lo >> 32),
                              static_cast<uint32_t>(r2_hi), static_cast<uint32_t>(r2_hi >> 32));
  sample_mont_kernel<<<grid_for(n, kSampleThreads), kSampleThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), static_cast<const uint8_t*>(raw), n, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
