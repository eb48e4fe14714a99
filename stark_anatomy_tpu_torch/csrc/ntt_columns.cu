// H9 stark_ntt_columns: step 1 of the distributed NTT on one shard, in one
// launch.  Replaces the column step of the JAX package's K18,
// stark_anatomy_tpu/parallel/ntt_dist.py:make_distributed_ntt (step 1 of
// `body`: the A-point column transforms, the cross twiddles omega_n^(a b)
// gathered by `idx_full`), and the coset pre-scale that
// stark_anatomy_tpu/parallel/sharded_stark.py:_lde applies before it.  The
// port first ran this step as PyTorch glue: a stack of the exchanged
// pieces, two transposes, H3 on rows of A points, an H0 launch for the
// twiddle from a cached (B/A, 8, A) table a shard, and an H0 launch for
// the coset scale.
//
// Notation: n = A B points on A = S shards, w = B / A.  Row a of the A x B
// matrix lies on shard a; the exchange brings shard s the pieces
// piece_a[..., :, t] = x[a B + b] for b = s w + t, t < w, one piece from
// each shard a.  H9 writes, for each lead row, limb and t,
//   out[..., :, k, t] = m_b omega_n^(+-k b) sum_a omega_A^(+-a k) c^(a B) piece_a[..., :, t],
// m_b = (1/A for the inverse) c^b, c the coset offset (1 without one).
// c^(a B + b) = c^(a B) c^b is the pre-scale of element a B + b, and c^b
// leaves the sum, so it rides the output's multiplier.  The output is
// contiguous (..., 8, A, w): the layout step 2's exchange slices, with no
// transpose on either side.  Everything is in Montgomery form, as
// everywhere in the port, and equals the glue value for value.
//
// Design.  One thread per (lead row, t) in a grid-stride loop: it loads
// the A elements a = 0 .. A - 1 of its column (8 int32 limbs each, the
// limb rows strided), pre-scales them, runs the A-point DFT in registers
// (ntt_passes.cuh: dft<A>, radix-2 decimation in time, 0, 1 and 5
// products for A = 2, 4, 8), multiplies output k by m_b u^k, u =
// omega_n^(+-b), and stores the A outputs.  Neighbouring threads take
// neighbouring t, so each limb row's loads and stores are 4 consecutive
// bytes a thread: every 32-byte sector is read or written whole.  The
// pieces are A pointers with their own row and limb strides (a parameter
// of the launch), so the local mesh's views (strided slices of the other
// shards, row stride B) and the slices of one receive buffer under
// torch.distributed both load as they lie: no stack, and no vector load
// that could cross a view's edge.
//
// Twiddles.  No table of n or B entries: omega_n^(+-b) = coarse[b / F]
// fine[b mod F], F = 2^ceil(log2(B) / 2), from the tables of
// (omega_n^(+-F))^i (B / F entries) and omega_n^(+-i) (F entries), as H8
// does (ntt_tiled.cu); its powers over k are A - 1 more products.  c^b
// splits the same way, c^(a B) is a table of A entries.  At n = 2^24 the
// tables hold 2048 + 1024 entries (48 KiB), read through the read-only
// cache.  Only b < B is split, so no exponent reaches n.
//
// What bounds it.  Bytes: a shard reads its B points and writes B (32
// bytes a point each way): at n = 2^24, S = 8, 64 MiB each way, 0.040 ms
// at 3.35 TB/s.  Products: at A = 8 with the pre-scale, 7 + 5 (the DFT) +
// 2 (u and c^b) + 7 (the powers of u) + 8 = 29 a thread, under 4 a point,
// about 700 SASS instructions a point less than H3's: the loads set the
// time.  A thread keeps its 8 elements (32 words) and the product's
// temporaries in registers, 128 threads a block.
//
// Built by one nvcc call into a shared library with a plain C interface
// (field/kernels.py).  The entry point launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include "field_arith.cuh"
#include "ntt_passes.cuh"

namespace {

constexpr int kColumnsMaxLog = 3;                 // A <= 8: the DFT in registers
constexpr int kColumnsMax = 1 << kColumnsMaxLog;
constexpr int kColumnsThreads = 128;

// The A pieces: limb l of element t of lead row r of piece a is at
// ptr[a] + r sb[a] + l sl[a] + t.
struct Pieces {
  const int32_t* ptr[kColumnsMax];
  int64_t sb[kColumnsMax];
  int64_t sl[kColumnsMax];
};

// The packed tables (16 bytes an entry): tw the A-point table
// omega_A^(+-i); coarse and fine (omega_n^(+-F))^i and omega_n^(+-i);
// rows c^(a B) for a < A, scale_coarse and scale_fine (c^F)^i and c^i,
// rows null without a pre-scale; n_inv null or the (8, 1) limbs of 1/A.
struct ColumnTables {
  const uint4* tw;
  const uint4* coarse;
  const uint4* fine;
  const uint4* rows;
  const uint4* scale_coarse;
  const uint4* scale_fine;
  const int32_t* n_inv;
  int log_fine;
};

__device__ __forceinline__ void copy_words(const uint32_t a[4], uint32_t r[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = a[k];
}

// r = base^b from a coarse table of (base^F)^i and a fine one of base^i.
__device__ __forceinline__ void split_power(const uint4* __restrict__ coarse,
                                            const uint4* __restrict__ fine, int log_fine,
                                            int64_t b, uint32_t r[4]) {
  uint32_t f[4];
  twiddle(coarse, static_cast<int>(b >> log_fine), r);
  twiddle(fine, static_cast<int>(b & ((int64_t(1) << log_fine) - 1)), f);
  mont_mul_chain(r, f, r);
}

// R = A.  out: contiguous (batch, 8, A, w), w = 2^log_w; column b = b0 + t.
template <int R>
__global__ void __launch_bounds__(kColumnsThreads)
    columns_kernel(int32_t* __restrict__ out, const Pieces pieces, const ColumnTables tab,
                   int64_t batch, int log_w, int64_t b0) {
  const int64_t w = int64_t(1) << log_w;
  const int64_t total = batch << log_w;
  uint32_t ninv[4];
  if (tab.n_inv != nullptr) load4(Operand{tab.n_inv, 0, 1, 0}, 0, 0, ninv);
  for (int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; g < total;
       g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = g >> log_w;
    const int64_t t = g & (w - 1);
    const int64_t b = b0 + t;
    uint32_t v[R][4];
#pragma unroll
    for (int a = 0; a < R; ++a)
      load4(Operand{pieces.ptr[a], pieces.sb[a], pieces.sl[a], 1}, row, t, v[a]);
    // m: the output's multiplier m_b, where it is not 1
    uint32_t m[4];
    bool scaled = false;
    if (tab.rows != nullptr) {
#pragma unroll
      for (int a = 1; a < R; ++a) {
        uint32_t c[4];
        twiddle(tab.rows, a, c);
        mont_mul_chain(v[a], c, v[a]);
      }
      split_power(tab.scale_coarse, tab.scale_fine, tab.log_fine, b, m);
      scaled = true;
    }
    if constexpr (R > 1) dft<R>(v, tab.tw, lg<R>());
    if (tab.n_inv != nullptr) {
      if (scaled) {
        mont_mul_chain(m, ninv, m);
      } else {
        copy_words(ninv, m);
      }
      scaled = true;
    }
    if (scaled) mont_mul_chain(v[0], m, v[0]);
    if constexpr (R > 1) {
      uint32_t u[4];
      split_power(tab.coarse, tab.fine, tab.log_fine, b, u);
#pragma unroll
      for (int k = 1; k < R; ++k) {
        if (k == 1 && !scaled) {
          copy_words(u, m);
        } else {
          mont_mul_chain(m, u, m);
        }
        mont_mul_chain(v[k], m, v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) store4(out, row, (static_cast<int64_t>(k) << log_w) + t, R * w, v[k]);
  }
}

int columns_grid(int64_t total) {
  int64_t blocks = (total + kColumnsThreads - 1) / kColumnsThreads;
  if (blocks > (1 << 30)) blocks = 1 << 30;  // the grid-stride loop covers the rest
  return static_cast<int>(blocks);
}

}  // namespace

extern "C" {

// out: contiguous (batch, 8, A, w) int32 limbs, A = 2^log_a <= 8, w =
// 2^log_w.  pieces: A device pointers; strides: 2A int64, piece a's lead
// row stride then its limb stride (the element stride is 1).  b0: the
// shard's first column.  tw, coarse, fine, rows, scale_coarse, scale_fine:
// packed (entries, 4) int32 tables, 16-byte aligned (ColumnTables); the
// coarse tables hold coarse_len entries, the fine ones 2^log_fine, and
// b0 + w <= coarse_len 2^log_fine.  rows, scale_coarse and scale_fine are
// all null (no pre-scale) or all set; n_inv null or the (8, 1) limbs of 1/A.
int stark_ntt_columns(void* out, const void* const* pieces, const int64_t* strides, int log_a,
                      int64_t batch, int log_w, int64_t b0, const void* tw, const void* coarse,
                      const void* fine, int log_fine, int64_t coarse_len, const void* rows,
                      const void* scale_coarse, const void* scale_fine, const void* n_inv,
                      void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool scale = rows != nullptr;
  if (log_a < 0 || log_a > kColumnsMaxLog || log_w < 0 || log_w > 40 || batch < 0 || b0 < 0 ||
      log_fine < 0 || log_fine > 30 || coarse_len < 1 || coarse_len > 0x7FFFFFFF ||
      b0 + (int64_t(1) << log_w) > (coarse_len << log_fine) || coarse == nullptr ||
      fine == nullptr || (log_a > 0 && tw == nullptr) ||
      (scale != (scale_coarse != nullptr) || scale != (scale_fine != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Pieces p = {};
  for (int a = 0; a < (1 << log_a); ++a) {
    if (pieces[a] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.ptr[a] = static_cast<const int32_t*>(pieces[a]);
    p.sb[a] = strides[2 * a];
    p.sl[a] = strides[2 * a + 1];
  }
  const ColumnTables tab{static_cast<const uint4*>(tw),
                         static_cast<const uint4*>(coarse),
                         static_cast<const uint4*>(fine),
                         static_cast<const uint4*>(rows),
                         static_cast<const uint4*>(scale_coarse),
                         static_cast<const uint4*>(scale_fine),
                         static_cast<const int32_t*>(n_inv),
                         log_fine};
  int32_t* o = static_cast<int32_t*>(out);
  const int grid = columns_grid(batch << log_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_a) {
    case 0:
      columns_kernel<1><<<grid, kColumnsThreads, 0, s>>>(o, p, tab, batch, log_w, b0);
      break;
    case 1:
      columns_kernel<2><<<grid, kColumnsThreads, 0, s>>>(o, p, tab, batch, log_w, b0);
      break;
    case 2:
      columns_kernel<4><<<grid, kColumnsThreads, 0, s>>>(o, p, tab, batch, log_w, b0);
      break;
    default:
      columns_kernel<8><<<grid, kColumnsThreads, 0, s>>>(o, p, tab, batch, log_w, b0);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
