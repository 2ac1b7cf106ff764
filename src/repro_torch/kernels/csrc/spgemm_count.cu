// Count-only (symbolic) SpGEMM pass over one bin of output rows (Hopper,
// sm_90a).
//
// Replaces: src/repro/kernels/spgemm_dense.py:148 `spgemm_count_bin`
//           (Pallas body `_count_kernel`, spgemm_dense.py:100).
//
// Computes, for each row r of a bin and each column tile t: the number of
// products a[r,e] * b[k,j] whose column falls in slot
// col - (row_lo[r] + t*W) of the tile's W-wide window, and the row's exact
// output nnz, the number of slots above 0 over all tiles. The counts
// (R, col_tiles*W) f32 are written only when asked for (the TPU contract);
// the symbolic stage asks only for row_nnz (R,) i32.
//
// Bound on this card: bytes. Each product reads one 4-byte B column and does
// one shared-memory atomic; the ELL inputs (a_rows whole, starts and lengths
// at live slots) and row_nnz are the rest. With counts asked for, the R*W*4
// bytes of counts dominate.
//
// Design: one block of 256 threads per (row, tile), the W-slot int window in
// shared memory (16 KB at W = 4096). Counts are integers, so the order of the
// adds does not matter: the block flattens a chunk of 256 A slots' products
// (a block scan of their lengths into shared memory) and strides its threads
// over all of them at once, each thread binary-searching its product's slot,
// with one barrier per chunk rather than one per A slot (the barrier that
// keeps the windowed dense kernel in enumeration order for its float sums).
// A block reduction of count > 0 gives the row's nnz, added into row_nnz
// (zeroed by the caller) once per tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
count_bin_kernel(const int* __restrict__ a_rows,
                 const int* __restrict__ a_starts,
                 const int* __restrict__ a_lens,
                 const int* __restrict__ row_lo,
                 const int* __restrict__ b_cols, float* __restrict__ counts,
                 int* __restrict__ row_nnz, int E, int window) {
  extern __shared__ int cnt[];  // window slots
  __shared__ int s_off[kThreads + 1];  // exclusive prefix of the chunk's lens
  __shared__ int s_start[kThreads];
  __shared__ int s_wsum[kWarps];
  __shared__ int s_nnz;

  const int64_t r = blockIdx.x;
  const int t = blockIdx.y;
  const int64_t ebase = r * E;
  const int lo = row_lo[r] + t * window;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int j = threadIdx.x; j < window; j += kThreads) cnt[j] = 0;
  if (threadIdx.x == 0) {
    s_nnz = 0;
    s_off[0] = 0;
  }
  __syncthreads();

  for (int e0 = 0; e0 < E; e0 += kThreads) {
    const int e = e0 + threadIdx.x;
    int len = 0;
    if (e < E && a_rows[ebase + e] >= 0) {
      len = a_lens[ebase + e];
      s_start[threadIdx.x] = a_starts[ebase + e];
    }
    int x = len;  // inclusive scan of len over the block
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) s_wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kWarps ? s_wsum[lane] : 0;
      for (int d = 1; d < kWarps; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      if (lane < kWarps) s_wsum[lane] = w;
    }
    __syncthreads();
    x += warp ? s_wsum[warp - 1] : 0;
    s_off[threadIdx.x + 1] = x;
    __syncthreads();

    const int n = min(E - e0, kThreads);
    const int total = s_off[n];
    for (int q = threadIdx.x; q < total; q += kThreads) {
      int a = 0, b = n;  // the last slot s with s_off[s] <= q
      while (b - a > 1) {
        const int mid = (a + b) >> 1;
        if (s_off[mid] <= q) a = mid; else b = mid;
      }
      const int col = b_cols[s_start[a] + (q - s_off[a])];
      const int local = col - lo;
      if (col >= 0 && local >= 0 && local < window) atomicAdd(&cnt[local], 1);
    }
    __syncthreads();  // the chunk's adds are done and its stage is free
  }

  int mine = 0;
  const int64_t off = (r * gridDim.y + t) * static_cast<int64_t>(window);
  for (int j = threadIdx.x; j < window; j += kThreads) {
    const int c = cnt[j];
    mine += c > 0;
    if (counts != nullptr) counts[off + j] = static_cast<float>(c);
  }
  for (int d = 16; d > 0; d >>= 1) mine += __shfl_xor_sync(0xffffffffu, mine, d);
  if (lane == 0) atomicAdd(&s_nnz, mine);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(&row_nnz[r], s_nnz);
}

}  // namespace

extern "C" int ocean_count_bin(const void* a_rows, const void* a_starts,
                               const void* a_lens, const void* row_lo,
                               const void* b_cols, void* counts, void* row_nnz,
                               int R, int E, int window, int col_tiles,
                               void* stream) {
  if (R > 0) {  // E == 0 still writes the zero counts
    const dim3 grid(R, col_tiles);
    const size_t smem = static_cast<size_t>(window) * sizeof(int);
    count_bin_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a_rows), static_cast<const int*>(a_starts),
        static_cast<const int*>(a_lens), static_cast<const int*>(row_lo),
        static_cast<const int*>(b_cols), static_cast<float*>(counts),
        static_cast<int*>(row_nnz), E, window);
  }
  return static_cast<int>(cudaGetLastError());
}
