// The AIR kernels: three pointwise jnp graphs that the JAX package compiles
// as one XLA executable each, and that the port ran as dozens of H0/H1
// launches of glue, each in one launch.
//
// H10 stark_rescue_quotients: the boundary quotients and the Rescue AIR's
//   transition quotients of a batch of trace codewords.  Replaces
//   stark_anatomy_tpu/protocols/fast_stark.py:_bq_core and
//   _air_quotient_fn over models/rescue_prime.py:_rescue_air_kernel, and
//   the same lines of the batch core (parallel/batch.py:build_prover_core):
//     bq[b, r, j] = (trace[b, r, j] - interp[(b,) r, j]) inv_bz[(b,) r, j]
//     tq[b, i, j] = AIR_i(trace[b, :, j], next[b, :, j'], C1(x_j), C2(x_j)) inv_tz[j]
//   with j' = (j + shift) mod N: the trace's next cycle is E points on
//   (E the expansion factor), read in place, with no rolled copy; where
//   the caller holds the next rows itself (a sharded prover's exchange)
//   they come as their own operand and shift 0.
// H11 stark_combination: the weighted combination codeword, FRI's input.
//   Replaces fast_stark.py:_combination_core and the batch core's
//   weighted_sum (parallel/batch.py:78-89, field/ops.py:288 over
//   field_sum):
//     combo[b, j] = w0 rand[b, j] + sum_s tq[b, s, j] (w_{2s+1} + w_{2s+2} tq_shift[s, j])
//                 + sum_r bq[b, r, j] (w_{2C+2r+1} + w_{2C+2r+2} bq_shift[r, j]),
//   weights shared by the batch or one set a proof, for any C and R.
// H12 stark_verify_core: the verifier's recomputation of the combination
//   at K query points for the Rescue AIR.  Replaces the jitted
//   fast_stark.py:_verify_core with ops/ntt.py:evaluate_domain_horner,
//   field/ops.py:batch_inv and mont_pow, and the index evaluator
//   models/rescue_prime.py:make_index_air_evaluator: per point the
//   boundary zerofiers and interpolants by Horner at x and at the next
//   cycle's point, the trace values from the opened quotients, the AIR
//   with C1, C2 read at the query's index, 1/tz by the fixed chain
//   pow_inv (0 gives 0, as batch_inv), x^e by square and multiply, and
//   the weighted sum.
//
// Layout: the JAX package's (field_arith.cuh): element (b, k, j) of an
// operand has limb l at ptr + b sb + k sk + l sl + j, so a table shared by
// the batch has sb = 0, and slices of a shard or stacked views load as
// they lie.  Outputs are contiguous.  Every add and subtract ends in
// [0, p), so each output is the canonical word form the glue gives, and
// the proofs stay byte for byte.
//
// Design.  One thread per point (and proof) in a grid-stride loop, as H0:
// it loads its operands' limb rows (neighbouring threads, neighbouring
// addresses: every 32-byte sector read whole), computes in registers and
// stores once.  No shared memory and no barriers: nothing is reused
// across points but the constants (MDS, the weights), which every thread
// of a warp reads at one address, an L1 hit.
//
// What bounds them.
//   * H10: bytes.  A point of one proof reads 2 trace rows, 2 next rows
//     (the same rows E points on: the L2 serves most of them), 2 + 2
//     boundary rows (per proof or shared), 2 + 2 round-constant rows and
//     inv_tz, and writes 2 + 2 quotient rows, 32 bytes a row: 15 rows
//     for the sign's (1, 2, 8, 4096), 1.97 MB, 0.59 us at 3.35 TB/s; at a
//     batch of 64, 645 rows, 84.5 MB, 25.2 us.  20 products and 12 adds
//     a point: 3.96 us of the int32 rate at B = 64.  At the sign's size
//     the launch itself (a few us) sets the time.
//   * H11: bytes.  It reads rand, the C + R quotients and the C + R shift
//     codewords and writes one row: 2(C + R) + 2 rows.  At the 2^20 MiMC
//     prove (C = R = 1, N = 2^24), 6 x 512 MiB, 0.96 ms; the glue it
//     replaces ran 9 launches and a stack of the three 512 MiB terms.
//   * H12: latency.  K = 128 points, one thread each: the work is a few
//     hundred products, under 0.1 us of the card's rate, but each thread
//     runs its 249 products in turn (154 of them the inverse chain, the
//     rest the shifts' square and multiply, the Horner steps, the AIR and
//     the sum), about 150 ns each: 37.6 us on an H100 (PERF.md).  Blocks
//     of 32 threads spread the 128 points over 4 SMs.
//
// Built by one nvcc call into a shared library with a plain C interface
// (field/kernels.py).  Every entry point launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include "field_arith.cuh"
#include "ntt_passes.cuh"
#include "pow_chain.cuh"
#include "rescue_air.cuh"

namespace {

// element (b, k, j) of an operand: limb l at ptr + b sb + k sk + l sl + j
struct Rows {
  const int32_t* ptr;
  int64_t sb, sk, sl;
};

__device__ __forceinline__ void load_at(const Rows& x, int64_t b, int64_t k, int64_t j,
                                        uint32_t w[4]) {
  load4(Operand{x.ptr + b * x.sb + k * x.sk, 0, x.sl, 1}, 0, j, w);
}

// element (b, k) of a (.., K, 8, 1) table: the row's one element
__device__ __forceinline__ void load_const(const Rows& x, int64_t b, int64_t k, uint32_t w[4]) {
  load4(Operand{x.ptr + b * x.sb + k * x.sk, 0, x.sl, 0}, 0, 0, w);
}

constexpr int kQuotientThreads = 128;
constexpr int kCombinationThreads = 256;
constexpr int kVerifyThreads = 32;

int grid_of(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop covers the rest
  return static_cast<int>(blocks);
}

// H10's operands: trace, next, interp, inv_bz (.., 2, 8, n); c1, c2
// (2, 8, n); inv_tz (8, n).  next is read at (j + shift) mod n.
struct QuotientArgs {
  Rows trace, next, interp, inv_bz, c1, c2, inv_tz;
  const int32_t* mds;
  const int32_t* mds_inv;
  int64_t batch, n, shift;
};

// bq: contiguous (batch, 2, 8, n); tq: contiguous (batch, 2, 8, n)
__global__ void __launch_bounds__(kQuotientThreads)
    quotients_kernel(int32_t* __restrict__ bq, int32_t* __restrict__ tq, const QuotientArgs a) {
  RescueConsts k;
  load_rescue_consts(a.mds, a.mds_inv, k);
  const int64_t total = a.batch * a.n;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = idx / a.n;
    const int64_t j = idx - b * a.n;
    int64_t jn = j + a.shift;
    if (jn >= a.n) jn -= a.n;
    uint32_t cur[kAirM][4], next[kAirM][4], c1[kAirM][4], c2[kAirM][4], out[kAirM][4];
#pragma unroll
    for (int r = 0; r < kAirM; ++r) {
      uint32_t ip[4], z[4];
      load_at(a.trace, b, r, j, cur[r]);
      load_at(a.next, b, r, jn, next[r]);
      load_at(a.c1, 0, r, j, c1[r]);
      load_at(a.c2, 0, r, j, c2[r]);
      load_at(a.interp, b, r, j, ip);
      load_at(a.inv_bz, b, r, j, z);
      SubMod()(cur[r], ip, ip);
      mont_mul_words(ip, z, ip);
      store4(bq, b * kAirM + r, j, a.n, ip);
    }
    rescue_air(cur, next, c1, c2, k, out);
    uint32_t itz[4];
    load_at(a.inv_tz, 0, 0, j, itz);
#pragma unroll
    for (int i = 0; i < kAirM; ++i) {
      mont_mul_words(out[i], itz, out[i]);
      store4(tq, b * kAirM + i, j, a.n, out[i]);
    }
  }
}

// H11's operands: rand (.., 8, n); tq (.., C, 8, n); bq (.., R, 8, n);
// tq_shift (C, 8, n); bq_shift (R, 8, n); weights (.., 1 + 2C + 2R, 8, 1).
struct CombinationArgs {
  Rows rand, tq, bq, tq_shift, bq_shift, weights;
  int64_t batch, n;
  int c, r;
};

// acc += q (w_a + w_b s): one term pair of the combination.
__device__ __forceinline__ void add_pair(const Rows& q, const Rows& shift, const Rows& weights,
                                         int64_t b, int s, int64_t j, int w_a, uint32_t acc[4]) {
  uint32_t v[4], sh[4], w[4];
  load_at(q, b, s, j, v);
  load_at(shift, 0, s, j, sh);
  load_const(weights, b, w_a + 1, w);
  mont_mul_words(w, sh, sh);
  load_const(weights, b, w_a, w);
  AddMod()(w, sh, sh);
  mont_mul_words(v, sh, v);
  AddMod()(acc, v, acc);
}

// out: contiguous (batch, 8, n)
__global__ void __launch_bounds__(kCombinationThreads)
    combination_kernel(int32_t* __restrict__ out, const CombinationArgs a) {
  const int64_t total = a.batch * a.n;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = idx / a.n;
    const int64_t j = idx - b * a.n;
    uint32_t acc[4], w[4];
    load_at(a.rand, b, 0, j, acc);
    load_const(a.weights, b, 0, w);
    mont_mul_words(acc, w, acc);
#pragma unroll 1
    for (int s = 0; s < a.c; ++s) add_pair(a.tq, a.tq_shift, a.weights, b, s, j, 1 + 2 * s, acc);
#pragma unroll 1
    for (int s = 0; s < a.r; ++s)
      add_pair(a.bq, a.bq_shift, a.weights, b, s, j, 1 + 2 * a.c + 2 * s, acc);
    store4(out, b, j, a.n, acc);
  }
}

// H12's operands.  vals: contiguous (8, (2m + 4) K), per register K
// current and K next opened quotients, then K randomizer values, K
// zerofier values, K points x and K next points; bz, ip: contiguous
// (m, 8, dz) and (m, 8, di) coefficients, low degree first; c1, c2: the
// (m, 8, N) round-constant codewords, read at idx[k]; weights: contiguous
// (1 + 4m, 8, 1); the shift exponents of the m transition and the m
// boundary quotients, with their bit lengths.
struct VerifyArgs {
  const int32_t* vals;
  const int32_t* bz;
  const int32_t* ip;
  Rows c1, c2;
  const int64_t* idx;
  const int32_t* weights;
  const int32_t* mds;
  const int32_t* mds_inv;
  uint64_t shift[2 * kAirM];
  int shift_bits[2 * kAirM];
  int64_t k, dz, di;
};

// part p of vals at point k
__device__ __forceinline__ void load_part(const VerifyArgs& a, int p, int64_t k, uint32_t w[4]) {
  load4(Operand{a.vals + p * a.k, 0, (2 * kAirM + 4) * a.k, 1}, 0, k, w);
}

// acc = sum_d coeffs[d] x^d, coeffs (8, d) contiguous limbs, by Horner.
__device__ __forceinline__ void horner(const int32_t* coeffs, int64_t d, const uint32_t x[4],
                                       uint32_t acc[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0;
#pragma unroll 1
  for (int64_t i = d - 1; i >= 0; --i) {
    uint32_t c[4];
    load4(Operand{coeffs, 0, d, 1}, 0, i, c);
    mont_mul_chain(acc, x, acc);
    AddMod()(acc, c, acc);
  }
}

// the trace value at a point: the opened quotient q times the zerofier,
// plus the interpolant, both by Horner at x
__device__ __forceinline__ void trace_value(const VerifyArgs& a, int r, const uint32_t q[4],
                                            const uint32_t x[4], uint32_t out[4]) {
  uint32_t z[4], i[4];
  horner(a.bz + r * 8 * a.dz, a.dz, x, z);
  horner(a.ip + r * 8 * a.di, a.di, x, i);
  mont_mul_chain(q, z, out);
  AddMod()(out, i, out);
}

// acc += w_a q + w_b q x^e
__device__ __forceinline__ void add_shifted(const VerifyArgs& a, const uint32_t q[4],
                                            const uint32_t x[4], int e, int w_a, uint32_t acc[4]) {
  uint32_t w[4], t[4], p[4];
  load4(Operand{a.weights + w_a * 8, 0, 1, 0}, 0, 0, w);
  mont_mul_chain(q, w, t);
  AddMod()(acc, t, acc);
  mont_pow_words(x, a.shift[e], 0, a.shift_bits[e], p);
  mont_mul_chain(q, p, t);
  load4(Operand{a.weights + (w_a + 1) * 8, 0, 1, 0}, 0, 0, w);
  mont_mul_chain(t, w, t);
  AddMod()(acc, t, acc);
}

// out: contiguous (8, K)
__global__ void __launch_bounds__(kVerifyThreads)
    verify_kernel(int32_t* __restrict__ out, const VerifyArgs a) {
  RescueConsts consts;
  load_rescue_consts(a.mds, a.mds_inv, consts);
  for (int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; k < a.k;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint32_t x[4], xn[4], bq[kAirM][4], cur[kAirM][4], next[kAirM][4], c1[kAirM][4],
        c2[kAirM][4], con[kAirM][4];
    load_part(a, 2 * kAirM + 2, k, x);
    load_part(a, 2 * kAirM + 3, k, xn);
    const int64_t at = a.idx[k];
#pragma unroll
    for (int r = 0; r < kAirM; ++r) {
      uint32_t q[4];
      load_part(a, 2 * r, k, bq[r]);
      load_part(a, 2 * r + 1, k, q);
      trace_value(a, r, bq[r], x, cur[r]);
      trace_value(a, r, q, xn, next[r]);
      load_at(a.c1, 0, r, at, c1[r]);
      load_at(a.c2, 0, r, at, c2[r]);
    }
    rescue_air(cur, next, c1, c2, consts, con);
    uint32_t tz[4], itz[4], acc[4], w[4];
    load_part(a, 2 * kAirM + 1, k, tz);
    pow_inv(tz, itz);
    load_part(a, 2 * kAirM, k, acc);
    load4(Operand{a.weights, 0, 1, 0}, 0, 0, w);
    mont_mul_chain(acc, w, acc);
#pragma unroll
    for (int s = 0; s < kAirM; ++s) {
      mont_mul_chain(con[s], itz, con[s]);
      add_shifted(a, con[s], x, s, 1 + 2 * s, acc);
    }
#pragma unroll
    for (int r = 0; r < kAirM; ++r) add_shifted(a, bq[r], x, kAirM + r, 1 + 2 * kAirM + 2 * r, acc);
    store4(out, 0, k, a.k, acc);
  }
}

Rows rows_of(const void* const* ptrs, const int64_t* strides, int i) {
  return Rows{static_cast<const int32_t*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
              strides[3 * i + 2]};
}

}  // namespace

extern "C" {

// bq, tq: contiguous (batch, 2, 8, n).  ptrs: the 7 operands trace, next,
// interp, inv_bz, c1, c2, inv_tz; strides: 21 int64, each operand's
// (sb, sk, sl) (the element stride is 1).  mds, mds_inv: contiguous
// (2, 2, 8, 1) limbs.  next is read at (j + shift) mod n, 0 <= shift < n.
int stark_rescue_quotients(void* bq, void* tq, const void* const* ptrs, const int64_t* strides,
                           const void* mds, const void* mds_inv, int64_t batch, int64_t n,
                           int64_t shift, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 0 || n < 0 || shift < 0 || (n > 0 && shift >= n) || mds == nullptr ||
      mds_inv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 7; ++i)
    if (ptrs[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return 0;
  const QuotientArgs a{rows_of(ptrs, strides, 0), rows_of(ptrs, strides, 1),
                       rows_of(ptrs, strides, 2), rows_of(ptrs, strides, 3),
                       rows_of(ptrs, strides, 4), rows_of(ptrs, strides, 5),
                       rows_of(ptrs, strides, 6), static_cast<const int32_t*>(mds),
                       static_cast<const int32_t*>(mds_inv), batch, n, shift};
  quotients_kernel<<<grid_of(batch * n, kQuotientThreads), kQuotientThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<int32_t*>(bq),
                                                          static_cast<int32_t*>(tq), a);
  return static_cast<int>(cudaGetLastError());
}

// out: contiguous (batch, 8, n).  ptrs: the 6 operands rand, tq, bq,
// tq_shift, bq_shift, weights; strides: 18 int64, each operand's (sb, sk,
// sl) (the element stride is 1, the weights' 0).  c, r: the counts of
// transition and boundary quotients, 1 + 2c + 2r weights.
int stark_combination(void* out, const void* const* ptrs, const int64_t* strides, int64_t batch,
                      int64_t n, int c, int r, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 0 || n < 0 || c < 0 || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  // rand and the weights always; the quotients and their shifts where
  // there are any
  if (ptrs[0] == nullptr || ptrs[5] == nullptr ||
      (c > 0 && (ptrs[1] == nullptr || ptrs[3] == nullptr)) ||
      (r > 0 && (ptrs[2] == nullptr || ptrs[4] == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return 0;
  const CombinationArgs a{rows_of(ptrs, strides, 0), rows_of(ptrs, strides, 1),
                          rows_of(ptrs, strides, 2), rows_of(ptrs, strides, 3),
                          rows_of(ptrs, strides, 4), rows_of(ptrs, strides, 5),
                          batch, n, c, r};
  combination_kernel<<<grid_of(batch * n, kCombinationThreads), kCombinationThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<int32_t*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

// out: contiguous (8, k).  vals: contiguous (8, 8k) (m = 2: (2m + 4) k);
// bz, ip: contiguous (2, 8, dz) and (2, 8, di); tables: c1 and c2, with
// table_strides their (sk, sl) (element stride 1); idx: k int64 indices
// into them; weights: contiguous (9, 8, 1); mds, mds_inv: contiguous
// (2, 2, 8, 1); shifts: the 4 exponents (2 transition, 2 boundary), each
// below 2^64.
int stark_verify_core(void* out, const void* vals, int64_t k, const void* bz, int64_t dz,
                      const void* ip, int64_t di, const void* const* tables,
                      const int64_t* table_strides, const void* idx, const void* weights,
                      const void* mds, const void* mds_inv, const uint64_t* shifts,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 0 || dz < 1 || di < 1 || vals == nullptr || bz == nullptr || ip == nullptr ||
      tables[0] == nullptr || tables[1] == nullptr || idx == nullptr || weights == nullptr ||
      mds == nullptr || mds_inv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return 0;
  VerifyArgs a{};
  a.vals = static_cast<const int32_t*>(vals);
  a.bz = static_cast<const int32_t*>(bz);
  a.ip = static_cast<const int32_t*>(ip);
  a.c1 = Rows{static_cast<const int32_t*>(tables[0]), 0, table_strides[0], table_strides[1]};
  a.c2 = Rows{static_cast<const int32_t*>(tables[1]), 0, table_strides[2], table_strides[3]};
  a.idx = static_cast<const int64_t*>(idx);
  a.weights = static_cast<const int32_t*>(weights);
  a.mds = static_cast<const int32_t*>(mds);
  a.mds_inv = static_cast<const int32_t*>(mds_inv);
  for (int i = 0; i < 2 * kAirM; ++i) {
    a.shift[i] = shifts[i];
    int bits = 0;
    while (bits < 64 && (shifts[i] >> bits) != 0) ++bits;
    a.shift_bits[i] = bits;
  }
  a.k = k;
  a.dz = dz;
  a.di = di;
  verify_kernel<<<grid_of(k, kVerifyThreads), kVerifyThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(static_cast<int32_t*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
