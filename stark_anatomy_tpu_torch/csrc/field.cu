// Field kernels for the 128-bit STARK field p = 1 + 407 * 2^119 on Hopper.
//
// H0 stark_mont_mul: Montgomery product a*b*2^-128 mod p, elementwise.
//   Replaces the JAX package's only TPU kernel, K0:
//   stark_anatomy_tpu/field/pallas_kernels.py:mont_mul_pallas_core (body
//   _mm_kernel -> _mont_mul_block), whose default TPU lowering is
//   field/ops.py:_mont_mul_rows.
// H1 stark_add_mod / stark_sub_mod: modular add and subtract in [0, p).
//   Replace the jnp row functions field/limb_arith.py:add_mod_rows and
//   sub_mod_rows behind field/ops.py:add and sub.
//
// Layout: the JAX package's, kept at the port's public functions.  An
// element is 8 little-endian 16-bit limbs held in int32 lanes, on a limb
// axis: a tensor (batch, 8, n) stores limb k of element (b, j) at
// b*sb + k*sl + j*se.  The output is always contiguous (batch, 8, n).
// An operand may broadcast: sb = 0 shares one (8, n) table across the
// batch, se = 0 one element across a row.
//
// Design, simple on purpose for now: one thread per element.  Each thread
// loads its 8 limbs (limb rows are strided by n, so neighbouring threads
// read neighbouring addresses and the loads coalesce), packs them into
// four 32-bit words, computes in registers and writes 8 limbs back.
//   * H0 is bound by operations: CIOS Montgomery with 32x32->64 products,
//     36 wide multiply-adds per element (16 for a*b, 4 for the m words,
//     16 for m*p, of which the compiler drops the ones with p's zero
//     words), then one conditional subtract of p.
//   * H1 is bound by memory: 96 bytes per element (two 32-byte inputs,
//     one 32-byte output) for about a dozen integer operations.
// On the main path both are launched on small tensors (a Rescue round
// runs on 2 elements, the NTTs on at most 2 x 4096), so launch overhead,
// not either bound, sets their time.  A compact 4 x u32 storage layout
// and fused kernels are left to later work.
//
// Built by one nvcc call into a shared library with a plain C interface
// (field/kernels.py).  Every entry point launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// p in 32-bit words, least significant first: p = 407 * 2^119 + 1.
__device__ __forceinline__ uint32_t p_word(int k) {
  return k == 0 ? 1u : (k == 3 ? 0xCB800000u : 0u);
}

// -p^-1 mod 2^32.  p = 1 mod 2^32, so p^-1 = 1 and this is 2^32 - 1.
constexpr uint32_t kNPrime0 = 0xFFFFFFFFu;

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

struct MontMul {
  __device__ __forceinline__ void operator()(const uint32_t a[4],
                                             const uint32_t b[4],
                                             uint32_t r[4]) const {
    // CIOS: t = (t + a * b_i + m * p) / 2^32, four times.
    uint32_t t[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint64_t s = static_cast<uint64_t>(t[j]) +
                     static_cast<uint64_t>(a[j]) * b[i] + c;
        t[j] = static_cast<uint32_t>(s);
        c = s >> 32;
      }
      uint64_t s = static_cast<uint64_t>(t[4]) + c;
      t[4] = static_cast<uint32_t>(s);
      t[5] = static_cast<uint32_t>(s >> 32);

      uint32_t m = t[0] * kNPrime0;
      s = static_cast<uint64_t>(t[0]) + static_cast<uint64_t>(m) * p_word(0);
      c = s >> 32;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        s = static_cast<uint64_t>(t[j]) +
            static_cast<uint64_t>(m) * p_word(j) + c;
        t[j - 1] = static_cast<uint32_t>(s);
        c = s >> 32;
      }
      s = static_cast<uint64_t>(t[4]) + c;
      t[3] = static_cast<uint32_t>(s);
      t[4] = t[5] + static_cast<uint32_t>(s >> 32);
    }
    r[0] = t[0];
    r[1] = t[1];
    r[2] = t[2];
    r[3] = t[3];
    cond_sub_p(r, t[4]);
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

template <typename Op>
int launch(void* out, const void* a, const void* b, int64_t batch, int64_t n,
           int64_t asb, int64_t asl, int64_t ase, int64_t bsb, int64_t bsl,
           int64_t bse, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = batch * n;
  if (total <= 0) return 0;
  constexpr int kThreads = 256;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1 << 30)) blocks = 1 << 30;  // grid-stride loop covers the rest
  Operand oa{static_cast<const int32_t*>(a), asb, asl, ase};
  Operand ob{static_cast<const int32_t*>(b), bsb, bsl, bse};
  binary_kernel<Op><<<static_cast<unsigned>(blocks), kThreads, 0,
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

}  // extern "C"
