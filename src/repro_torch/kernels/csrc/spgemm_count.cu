// Count-only (symbolic) SpGEMM passes (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/spgemm_dense.py:148 `spgemm_count_bin`
//           (Pallas body `_count_kernel`, spgemm_dense.py:100).
//
// Two entry points share one product loop (`for_each_product`):
//
// - ocean_count_rows, the symbolic prediction. For a list of rows of A, each
//   with the base `row_lo` of an output column range at most kRowColumns
//   (4096) wide: the number of distinct columns in [row_lo, row_lo + 4096)
//   among the row's products, which is the row's exact output nnz, stored as
//   int64 at the row's own index of `pred`. It reads A's and B's CSR arrays
//   directly, every listed row in one launch.
// - ocean_count_bin, the TPU contract. Per (row, column tile) of an ELL bin:
//   the number of products in each slot of the tile's W-wide window (written
//   as (R, col_tiles*W) f32 when asked for), and the row's nnz, the number of
//   slots above 0 over all tiles.
//
// Bound on this card: bytes. Each product reads one 4-byte B column; the
// listed rows' A entries, their B rows' offsets and the outputs are the rest.
// Counts are integers, so the order in which products are added or set does
// not matter.
//
// Design of the product loop: a warp takes 32 A entries (CSR entries, or ELL
// slots) at a time, one a lane, scans their B rows' lengths across the lanes
// and walks the chunk's products 32 at a time. Each lane finds its product's
// entry in a 5-step search over the offsets the 32 lanes hold (shuffles: no
// shared memory, no barrier), and loads kUnroll rounds before it visits them,
// so a lane has that many B loads in flight. `step` warps can share one chunk,
// each taking every step-th round.
//
// Design of count_rows: a warp a row. The row's presence bitmap, 4096 bits
// (128 words, 512 B), lives in shared memory, is set with atomicOr and is
// counted with __popc and a warp reduction. No window of counts, no rung: one
// bitmap width serves every listed row. Rows with many products would keep a
// lone warp busy after the rest of the launch is done, so the caller lists
// such rows first ("heavy", descending by products) and each takes a whole
// block: its warps share one bitmap and split the row's chunks (or a chunk's
// rounds, when the row has fewer chunks than the block has warps). The block
// shape comes from the CUDA occupancy API (ocean_count_rows_blocks_per_sm).
//
// Design of count_bin: a block of 256 threads per (row, tile) with the W-slot
// int window in shared memory; its 8 warps take the row's ELL slots through
// the same row loop as count_rows' heavy rows (for_each_row_product), adding 1
// to a slot with a shared atomic.
//
// Limit: a chunk's product count is an int, so 32 B rows must hold fewer than
// 2^31 entries together (CSR offsets are int32 as well).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowColumns = 4096;            // bits of a row's bitmap
constexpr int kRowWords = kRowColumns / 32;  // 128 words, 512 B
constexpr int kMaxThreads = 1024;
constexpr int kBinThreads = 256;
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kUnroll = 4;                   // B loads in flight a lane

// Calls visit(col) for each product of the chunk whose lanes hold one A entry
// each: `start` and `len` locate the entry's B row in b_cols (len 0: no
// entry). This warp takes the chunk's rounds of 32 products first,
// first + step, ... Every lane of the warp calls it.
template <typename Visit>
__device__ __forceinline__ void for_each_product(
    const int* __restrict__ b_cols, int start, int len, int first, int step,
    Visit visit) {
  const int lane = threadIdx.x & 31;
  int incl = len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int excl = incl - len;
  const int total = __shfl_sync(kFull, incl, 31);
  for (int base = first * 32; base < total; base += step * 32 * kUnroll) {
    int col[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = base + u * step * 32 + lane;
      int a = 0;  // the last lane whose products start at or before q
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        if (__shfl_sync(kFull, excl, a + d) <= q) a += d;
      }
      const int s = __shfl_sync(kFull, start, a);
      const int o = __shfl_sync(kFull, excl, a);
      col[u] = q < total ? b_cols[s + (q - o)] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (col[u] >= 0) visit(col[u]);
    }
  }
}

// Calls visit(col) for each product of one row's `n` A entries, which
// `group` warps take together, this one as warp `gw` of them: chunks of 32
// entries in turn or, when the row has fewer chunks than warps, a chunk's
// rounds shared among `group / chunks` warps. entry(e, start, len) sets the
// B row of entry e (len 0: none). Every lane of the group's warps calls it.
template <typename Entry, typename Visit>
__device__ __forceinline__ void for_each_row_product(
    const int* __restrict__ b_cols, int n, int gw, int group, Entry entry,
    Visit visit) {
  const int lane = threadIdx.x & 31;
  const int chunks = (n + 31) >> 5;
  const int share = max(1, group / max(chunks, 1));  // warps a chunk
  for (int j = gw; j < chunks * share; j += group) {
    const int e = (j / share) * 32 + lane;
    int start = 0, len = 0;
    if (e < n) entry(e, start, len);
    for_each_product(b_cols, start, len, j % share, share, visit);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
count_rows_kernel(const int* __restrict__ a_indptr,
                  const int* __restrict__ a_indices,
                  const int* __restrict__ b_indptr,
                  const int* __restrict__ b_indices,
                  const int* __restrict__ rows,
                  const int* __restrict__ row_lo,
                  long long* __restrict__ pred, int n_rows, int n_b,
                  int heavy) {
  extern __shared__ unsigned bits[];  // one bitmap a warp
  __shared__ int s_count;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool whole = static_cast<int>(blockIdx.x) < heavy;  // block-wide
  int i, group, gw;
  unsigned* bm;
  if (whole) {  // one heavy row, every warp of the block on one bitmap
    i = blockIdx.x;
    group = blockDim.x >> 5;
    gw = warp;
    bm = bits;
  } else {
    i = heavy + (blockIdx.x - heavy) * (blockDim.x >> 5) + warp;
    if (i >= n_rows) return;  // whole warps leave together
    group = 1;
    gw = 0;
    bm = bits + warp * kRowWords;
  }
  for (int j = gw * 32 + lane; j < kRowWords; j += group * 32) bm[j] = 0;
  if (whole) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
  } else {
    __syncwarp();
  }

  const int row = rows[i];
  const int lo = row_lo[i];
  const int s = a_indptr[row];
  for_each_row_product(
      b_indices, a_indptr[row + 1] - s, gw, group,
      [&](int e, int& start, int& len) {
        const int k = a_indices[s + e];
        if (k >= 0 && k < n_b) {
          start = b_indptr[k];
          len = b_indptr[k + 1] - start;
        }
      },
      [&](int col) {
        const unsigned local = static_cast<unsigned>(col - lo);
        if (local < kRowColumns) atomicOr(&bm[local >> 5], 1u << (local & 31));
      });
  if (whole) __syncthreads(); else __syncwarp();

  int n = 0;
  for (int j = gw * 32 + lane; j < kRowWords; j += group * 32)
    n += __popc(bm[j]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(kFull, n, d);
  if (!whole) {
    if (lane == 0) pred[row] = n;
    return;
  }
  if (lane == 0) atomicAdd(&s_count, n);
  __syncthreads();
  if (threadIdx.x == 0) pred[row] = s_count;
}

__global__ void __launch_bounds__(kBinThreads)
count_bin_kernel(const int* __restrict__ a_rows,
                 const int* __restrict__ a_starts,
                 const int* __restrict__ a_lens,
                 const int* __restrict__ row_lo,
                 const int* __restrict__ b_cols, float* __restrict__ counts,
                 int* __restrict__ row_nnz, int E, int window) {
  extern __shared__ int cnt[];  // window slots
  __shared__ int s_nnz;

  const int64_t r = blockIdx.x;
  const int t = blockIdx.y;
  const int64_t ebase = r * E;
  const int lo = row_lo[r] + t * window;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int j = threadIdx.x; j < window; j += kBinThreads) cnt[j] = 0;
  if (threadIdx.x == 0) s_nnz = 0;
  __syncthreads();

  for_each_row_product(
      b_cols, E, warp, kBinWarps,
      [&](int e, int& start, int& len) {
        if (a_rows[ebase + e] >= 0) {
          start = a_starts[ebase + e];
          len = a_lens[ebase + e];
        }
      },
      [&](int col) {
        const unsigned local = static_cast<unsigned>(col - lo);
        if (local < static_cast<unsigned>(window)) atomicAdd(&cnt[local], 1);
      });
  __syncthreads();

  int mine = 0;
  const int64_t off = (r * gridDim.y + t) * static_cast<int64_t>(window);
  for (int j = threadIdx.x; j < window; j += kBinThreads) {
    const int c = cnt[j];
    mine += c > 0;
    if (counts != nullptr) counts[off + j] = static_cast<float>(c);
  }
  for (int d = 16; d > 0; d >>= 1) mine += __shfl_xor_sync(kFull, mine, d);
  if (lane == 0) atomicAdd(&s_nnz, mine);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(&row_nnz[r], s_nnz);
}

size_t rows_smem(int warps) {
  return static_cast<size_t>(warps) * kRowWords * sizeof(unsigned);
}

}  // namespace

extern "C" int ocean_count_rows(const void* a_indptr, const void* a_indices,
                                const void* b_indptr, const void* b_indices,
                                const void* rows, const void* row_lo,
                                void* pred, int n_rows, int n_b, int heavy,
                                int warps, void* stream) {
  if (n_rows <= 0) return 0;
  if (warps <= 0 || warps * 32 > kMaxThreads || heavy < 0 || heavy > n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = heavy + (n_rows - heavy + warps - 1) / warps;
  count_rows_kernel<<<blocks, warps * 32, rows_smem(warps),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a_indptr), static_cast<const int*>(a_indices),
      static_cast<const int*>(b_indptr), static_cast<const int*>(b_indices),
      static_cast<const int*>(rows), static_cast<const int*>(row_lo),
      static_cast<long long*>(pred), n_rows, n_b, heavy);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of `warps` warps of count_rows_kernel, as built, one SM
// holds at once (0 when such a block cannot launch).
extern "C" int ocean_count_rows_blocks_per_sm(int warps, int* blocks) {
  *blocks = 0;
  if (warps <= 0 || warps * 32 > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, count_rows_kernel, warps * 32, rows_smem(warps)));
}

extern "C" int ocean_count_bin(const void* a_rows, const void* a_starts,
                               const void* a_lens, const void* row_lo,
                               const void* b_cols, void* counts, void* row_nnz,
                               int R, int E, int window, int col_tiles,
                               void* stream) {
  if (R > 0) {  // E == 0 still writes the zero counts
    const dim3 grid(R, col_tiles);
    const size_t smem = static_cast<size_t>(window) * sizeof(int);
    count_bin_kernel<<<grid, kBinThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a_rows), static_cast<const int*>(a_starts),
        static_cast<const int*>(a_lens), static_cast<const int*>(row_lo),
        static_cast<const int*>(b_cols), static_cast<float*>(counts),
        static_cast<int*>(row_nnz), E, window);
  }
  return static_cast<int>(cudaGetLastError());
}
