// H8 stark_ntt_tiled: the NTT of n = n1 * n2 points for n above H3's 8192
// (up to 2^24: n1, n2 <= 4096), in two launches with no copy between
// them.  Replaces stark_anatomy_tpu/ops/stage_ntt.py:staged_ntt (the
// four-step transform: staged_ntt_core, and _staged_jit's pre- and
// post-scale), which the port first ran as PyTorch glue over H3: three
// transposes, a stack, two H0 launches for the scales and a cached
// (n1, 8, n2) twiddle table.
//
// Notation: input index j = j1 + n1 j2, output index k = k2 + n2 k1, w_m a
// primitive m-th root (its inverse for the inverse transform), and
//   X[k2 + n2 k1] = sum_j1 w_n1^(j1 k1) w_n^(j1 k2) sum_j2 w_n2^(j2 k2) x[j1 + n1 j2].
// The input and output are contiguous (batch, 8, n) int32 limb rows in
// Montgomery form, as everywhere in the port.
//   * step 0, the columns (tiled_columns_kernel): for each column j1, the
//     n2-point transform of x[j1 + n1 j2] over j2, the pre-scale applied
//     as the points are loaded and the twiddle w_n^(j1 k2) as they are
//     stored, Y[k2 n1 + j1]: the same kind of slot it was read from.  Y is
//     packed, each element's four 32-bit words side by side (16 bytes a
//     point; a limb row takes 32).
//   * step 1, the rows (tiled_rows_kernel): for each k2, the n1-point
//     transform of the contiguous Y[k2 n1 + j1] over j1, written to
//     X[k2 + n2 k1] in natural order with 1/n and the post-scale applied
//     as it is stored.
//
// Design.  A block runs one inner transform (L = n2 points in step 0, n1
// in step 1) in its shared memory, by H3's radix-8 Stockham passes
// (ntt_passes.cuh: ntt_pass, L/8 threads holding 8 elements each), in
// place: natural order in, natural order out, element i at ntt_slot(i).
// What the design must get right is the strided side.  A limb row is n
// int32 words, so neighbouring columns j1 are 4 bytes apart, and a 32-byte
// sector holds one word of 8 neighbouring transforms: a block that loaded
// its own column alone would use 4 of every 32 bytes it moves.  So a
// cluster of kTile = 8 blocks takes 8 neighbouring transforms (columns
// j1 = 8c .. 8c + 7 in step 0, rows k2 = 8c .. 8c + 7 in step 1), and the
// strided side is loaded and stored by the whole cluster through
// distributed shared memory: block r moves the points [r L/8, (r+1) L/8)
// of all 8 transforms, 8 neighbouring threads on the 8 words of one
// sector of each limb row (step 1's packed Y: 8 neighbouring 16-byte
// elements), each element read from or written to the shared memory of
// the block that transforms it (cluster.map_shared_rank).  Every sector of
// the strided side is read or written whole, once a step.  Step 1's loads
// are a contiguous row of Y a block.  The cluster syncs before any block
// touches another's shared memory, and after the last remote access, so
// that no block leaves while another reads its shared memory.  Clusters of
// 8 blocks of 64 KiB (L = 4096) take 8 SMs each; the grid holds every tile
// of every row of the batch, so one launch runs the whole batch.
//
// Twiddles.  The inner transforms read H3's packed power tables of n2 and
// n1 points (64 KiB at most).  w_n^e, e = j1 k2 < n, is the product
// w_n1^(e / n2) w_n^(e mod n2): an entry of the n1-point table (step 1's)
// and one of a table of the first n2 powers of w_n.  That is one product
// more a point in place of an (n1, 8, n2) table (512 MiB at 2^24) or an
// n-point one.
//
// What bounds it.  Bytes: at n = 2^24 with the coset table (an LDE), step
// 0 reads x and the table (32 bytes a point each) and writes Y (16), step
// 1 reads Y (16) and writes X (32): 128 bytes a point, 2.15 GB, 0.64 ms at
// 3.35 TB/s.  Instructions: the two inner transforms take about 10
// products a point (4 passes of 4096 points each: 5 products an 8-point
// DFT, 7 twiddles a group after the first pass), the scale and the
// twiddle 3 more, about 170 SASS instructions each with their adds:
// about 3.8e10, 1.1 ms of issue at the card's full rate on 16 warps an SM
// (one block of 512 threads an SM at the 128-register cap).  So the
// kernel is bound by instructions, as H3 is; what the design saves is the
// three transposes, the stack, the H0 launches and the table.
//
// Built by one nvcc call into a shared library with a plain C interface
// (field/kernels.py).  The entry point launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>

#include <mutex>
#include <set>
#include <utility>

#include "field_arith.cuh"
#include "ntt_passes.cuh"

namespace {

constexpr int kTileLog = 3;
constexpr int kTile = 1 << kTileLog;   // transforms a cluster holds: one sector of each limb row
constexpr int kTiledMinLog = 3;        // inner transforms of 8 ...
constexpr int kTiledMaxLog = 12;       // ... to 4096 points: L/8 threads, 16 L bytes of shared memory
constexpr int kTiledThreads = 1 << (kTiledMaxLog - 3);
constexpr int kItems = 8;              // a thread's points on the strided side: L of them a block

// Item `item` (= t + i L/8, i < kItems) of cluster block `rank` on the
// strided side of a tile of kTile transforms of 2^log_l points: point j =
// rank L/kTile + item / kTile of transform q = item mod kTile, so that
// kTile neighbouring threads take one point of every transform.
struct TileItem {
  int j, q;
};

__device__ __forceinline__ TileItem tile_item(int rank, int item, int log_l) {
  return {(rank << (log_l - kTileLog)) + (item >> kTileLog), item & (kTile - 1)};
}

// Block `rank`'s exchange buffer, in the cluster's distributed shared memory.
__device__ __forceinline__ uint4* tile_buffer(uint4* smem, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(smem, rank);
}

__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

// One Stockham pass of radix R after 2^lg_ns points over the block's
// transform of 2^log_l points, in place in its shared memory: thread t
// reads its 8 elements (ntt_src), every thread has read before any writes,
// and the outputs go to ntt_dest.
template <int R>
__device__ __forceinline__ void pass_in_place(uint4* smem, const uint4* __restrict__ tw, int log_l,
                                              int lg_ns) {
  const int t = threadIdx.x;
  const int lg_t = log_l - 3;
  uint32_t v[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) to_words(smem[ntt_slot(ntt_src<R>(t, lg_t, i))], v[i]);
  __syncthreads();                        // every input of this pass is read
  ntt_pass<R>(v, tw, log_l, t, lg_t, lg_ns);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    smem[ntt_slot(ntt_dest<R>(t + ((i / R) << lg_t), i % R, lg_ns))] = from_words(v[i]);
  __syncthreads();                        // every output of this pass is written
}

// The block's transform of 2^log_l points (3 <= log_l <= 12), natural order
// in and out: radix 8 while three bits are left, the last pass of radix RL.
template <int RL>
__device__ __forceinline__ void transform_in_place(uint4* smem, const uint4* __restrict__ tw,
                                                   int log_l) {
  const int npass = (log_l + 2) / 3;
  for (int p = 0; p + 1 < npass; ++p) pass_in_place<8>(smem, tw, log_l, 3 * p);
  pass_in_place<RL>(smem, tw, log_l, 3 * (npass - 1));
}

__device__ __forceinline__ void inner_transform(uint4* smem, const uint4* __restrict__ tw,
                                                int log_l) {
  if (log_l % 3 == 0) {
    transform_in_place<8>(smem, tw, log_l);
  } else if (log_l % 3 == 1) {
    transform_in_place<2>(smem, tw, log_l);
  } else {
    transform_in_place<4>(smem, tw, log_l);
  }
}

// Step 0.  x: (batch, 8, n) limbs; y: (batch, n) packed.  Cluster `tile`
// (blockIdx.x / kTile) holds the columns c0 .. c0 + kTile - 1 of batch row b; its
// block `rank` transforms column c0 + rank.  tw: the packed n2-point
// table; coarse, fine: the packed w_n1^i (i < n1) and w_n^i (i < n2).
// pre: the pre-scale where its ptr is set.
__global__ void __launch_bounds__(kTiledThreads)
    tiled_columns_kernel(uint4* __restrict__ y, Operand x, Operand pre,
                         const uint4* __restrict__ tw, const uint4* __restrict__ coarse,
                         const uint4* __restrict__ fine, int log_n1, int log_n2) {
  extern __shared__ uint4 smem[];
  const int rank = static_cast<int>(blockIdx.x % kTile);
  const int64_t tile = blockIdx.x / kTile;
  const int tiles_log = log_n1 - kTileLog;
  const int64_t b = tile >> tiles_log;
  const int c0 = static_cast<int>(tile & ((1 << tiles_log) - 1)) * kTile;
  const int lg_t = log_n2 - 3;            // log2 of the threads: n2 / 8
  uint32_t v[kItems][4];
  cluster_sync();                         // every block of the cluster runs
  // the load: point j2 of column c0 + q (tile_item), so that kTile
  // neighbouring threads read the words of one sector of each limb row
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const TileItem it = tile_item(rank, threadIdx.x + (i << lg_t), log_n2);
    load4(x, b, c0 + it.q + (static_cast<int64_t>(it.j) << log_n1), v[i]);
  }
  if (pre.ptr != nullptr) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const TileItem it = tile_item(rank, threadIdx.x + (i << lg_t), log_n2);
      uint32_t c[4];
      load4(pre, b, c0 + it.q + (static_cast<int64_t>(it.j) << log_n1), c);
      mont_mul_chain(v[i], c, v[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const TileItem it = tile_item(rank, threadIdx.x + (i << lg_t), log_n2);
    tile_buffer(smem, it.q)[ntt_slot(it.j)] = from_words(v[i]);
  }
  cluster_sync();                         // every column is in its block
  inner_transform(smem, tw, log_n2);
  cluster_sync();                         // every column is transformed
  // the store: point k2 of column j1 = c0 + q, times w_n^(j1 k2), to
  // Y[k2 n1 + j1]: kTile neighbouring threads write contiguous elements
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const TileItem it = tile_item(rank, threadIdx.x + (i << lg_t), log_n2);
    to_words(tile_buffer(smem, it.q)[ntt_slot(it.j)], v[i]);
  }
  uint4* const out = y + (b << (log_n1 + log_n2));
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const TileItem it = tile_item(rank, threadIdx.x + (i << lg_t), log_n2);
    const int j1 = c0 + it.q;
    const int e = j1 * it.j;              // < n <= 2^24
    uint32_t w[4], f[4];
    twiddle(coarse, e >> log_n2, w);
    twiddle(fine, e & ((1 << log_n2) - 1), f);
    mont_mul_chain(w, f, w);
    mont_mul_chain(v[i], w, v[i]);
    out[(static_cast<int64_t>(it.j) << log_n1) + j1] = from_words(v[i]);
  }
  cluster_sync();                         // no block leaves while another reads its buffer
}

// Step 1.  y: (batch, n) packed; out: (batch, 8, n) limbs.  Cluster `tile`
// holds the rows k2 = c0 .. c0 + kTile - 1 of batch row b; its block `rank`
// transforms row c0 + rank.  tw: the packed n1-point table.  post: the
// post-scale, n_inv: the (8, 1) constant 1/n, each where its ptr is set.
__global__ void __launch_bounds__(kTiledThreads)
    tiled_rows_kernel(int32_t* __restrict__ out, const uint4* __restrict__ y, Operand post,
                      Operand n_inv, const uint4* __restrict__ tw, int log_n1, int log_n2) {
  extern __shared__ uint4 smem[];
  const int rank = static_cast<int>(blockIdx.x % kTile);
  const int64_t tile = blockIdx.x / kTile;
  const int tiles_log = log_n2 - kTileLog;
  const int64_t b = tile >> tiles_log;
  const int c0 = static_cast<int>(tile & ((1 << tiles_log) - 1)) * kTile;
  const int64_t n = int64_t(1) << (log_n1 + log_n2);
  const int lg_t = log_n1 - 3;            // log2 of the threads: n1 / 8
  // the load: this block's row of Y, contiguous
  const uint4* row = y + b * n + (static_cast<int64_t>(c0 + rank) << log_n1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j1 = threadIdx.x + (i << lg_t);
    smem[ntt_slot(j1)] = row[j1];
  }
  __syncthreads();
  inner_transform(smem, tw, log_n1);
  uint32_t ninv[4];
  if (n_inv.ptr != nullptr) load4(n_inv, 0, 0, ninv);
  cluster_sync();                         // every row of the cluster is transformed
  // the store: point k1 of row k2 = c0 + q (tile_item) to X[k2 + n2 k1],
  // with 1/n and the post-scale: kTile neighbouring threads write the
  // words of one sector of each limb row
  uint32_t v[kItems][4];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const TileItem it = tile_item(rank, threadIdx.x + (i << lg_t), log_n1);
    to_words(tile_buffer(smem, it.q)[ntt_slot(it.j)], v[i]);
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const TileItem it = tile_item(rank, threadIdx.x + (i << lg_t), log_n1);
    const int64_t k = c0 + it.q + (static_cast<int64_t>(it.j) << log_n2);
    if (n_inv.ptr != nullptr) mont_mul_chain(v[i], ninv, v[i]);
    if (post.ptr != nullptr) {
      uint32_t c[4];
      load4(post, b, k, c);
      mont_mul_chain(v[i], c, v[i]);
    }
    store4(out, b, k, n, v[i]);
  }
  cluster_sync();                         // no block leaves while another reads its buffer
}

// Raise the dynamic shared memory limit of `kernel` on `device` to the
// largest inner transform's, once.
template <typename F>
cudaError_t tiled_smem_limit(F kernel, int inst, int device) {
  static std::mutex mu;
  static std::set<std::pair<int, int>> done;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({device, inst})) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (1 << kTiledMaxLog) * static_cast<int>(sizeof(uint4)));
  if (err == cudaSuccess) done.insert({device, inst});
  return err;
}

}  // namespace

extern "C" {

// step 0: x contiguous (batch, 8, n) limbs, out contiguous (batch, n, 4)
// packed words; tw the packed (n2, 4) table, coarse and fine the packed
// (n1, 4) and (n2, 4) twiddle tables; scale the pre-scale.  step 1: x
// contiguous (batch, n, 4) packed, out contiguous (batch, 8, n) limbs; tw
// the packed (n1, 4) table, coarse and fine unused; scale the post-scale,
// n_inv null or the contiguous (8, 1) constant 1/n.  scale: null or a
// (8, n) limb table with batch stride scale_sb (0: shared by the batch).
// n = 2^(log_n1 + log_n2), 3 <= log_n1, log_n2 <= 12.  Packed operands
// must be 16-byte aligned.
int stark_ntt_tiled(void* out, const void* x, int64_t batch, int log_n1, int log_n2, int step,
                    const void* tw, const void* coarse, const void* fine, const void* scale,
                    int64_t scale_sb, const void* n_inv, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (log_n1 < kTiledMinLog || log_n1 > kTiledMaxLog || log_n2 < kTiledMinLog ||
      log_n2 > kTiledMaxLog || (step != 0 && step != 1) || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int log_l = step == 0 ? log_n2 : log_n1;                 // the inner transform
  const int64_t tiles = int64_t(1) << ((step == 0 ? log_n1 : log_n2) - kTileLog);
  if (batch * tiles * kTile > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int64_t n = int64_t(1) << (log_n1 + log_n2);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch * tiles * kTile));
  config.blockDim = dim3(1u << (log_l - 3));
  config.dynamicSmemBytes = (size_t(1) << log_l) * sizeof(uint4);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kTile;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const Operand oscale{static_cast<const int32_t*>(scale), scale_sb, n, 1};
  const uint4* t = static_cast<const uint4*>(tw);
  if (step == 0) {
    err = tiled_smem_limit(tiled_columns_kernel, 0, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Operand ox{static_cast<const int32_t*>(x), 8 * n, n, 1};
    err = cudaLaunchKernelEx(&config, tiled_columns_kernel, static_cast<uint4*>(out), ox, oscale, t,
                             static_cast<const uint4*>(coarse), static_cast<const uint4*>(fine),
                             log_n1, log_n2);
  } else {
    err = tiled_smem_limit(tiled_rows_kernel, 1, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Operand oinv{static_cast<const int32_t*>(n_inv), 0, 1, 0};
    err = cudaLaunchKernelEx(&config, tiled_rows_kernel, static_cast<int32_t*>(out),
                             static_cast<const uint4*>(x), oscale, oinv, t, log_n1, log_n2);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
