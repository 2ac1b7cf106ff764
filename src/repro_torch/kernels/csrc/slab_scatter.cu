// Row-disjoint sources copied straight into C's CSR arrays (Hopper, sm_90a).
//
// Replaces no TPU kernel: the reference compacts its slabs into C on the
// host, with numpy (src/repro/core/executor.py:287 `_compact_slabs`). Added
// so that the executor's merge stays on the card: each dense or hash bin's
// (cols, vals, nnz) slab and the overflow fallback's ESC CSR are written into
// C where they lie, with no copy to the host and no upload of C.
//
// One launch takes one source. Source row r goes to C row dest[r]: its len
// entries from offset off (r * width and nnz[r] for a slab, ptr[r] and
// ptr[r + 1] - ptr[r] for a CSR) are copied to
// C[c_ptr[dest[r]] : c_ptr[dest[r]] + len], cols and vals alike, in order,
// as 32-bit words: a bit copy. A slab row whose nnz passes the width
// overflowed and is skipped; the fallback's source writes that row. Columns
// are sorted within every source row, so C comes out canonical.
//
// Bound on this card: bytes. Each entry is read once and written once, 4 + 4
// bytes each way, plus 16 bytes of row metadata a row.
//
// Design: a warp a row, 8 rows a block, no shared memory and no scratch. C's
// row starts at any word, so the warp aligns on the destination: up to 3
// words of head one a lane, then whole 16-byte words, then up to 3 words of
// tail. Each lane builds its 16-byte destination word from the one or two
// aligned 16-byte source words that hold it (a funnel shift by the source's
// phase against the destination's), so loads and stores are 16 bytes a lane,
// neighbouring lanes on neighbouring words. A lane keeps kUnroll 16-byte
// words in flight, so on a long row (an ESC row of 10^4 entries) a warp moves
// 2 KB of an array a load latency. An aligned 16-byte load that holds a word
// of the row stays inside the row's allocation, which starts 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // rows a block
constexpr int kUnroll = 4;   // 16-byte words in flight a lane

// Words s..s+3 of the eight words of (lo, hi).
__device__ __forceinline__ uint4 funnel(const uint4& lo, const uint4& hi,
                                        int s) {
  switch (s) {
    case 0: return lo;
    case 1: return make_uint4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_uint4(lo.z, lo.w, hi.x, hi.y);
    default: return make_uint4(lo.w, hi.x, hi.y, hi.z);
  }
}

// Copies n 32-bit words from src to dst, the warp together (lane `lane`).
__device__ __forceinline__ void copy_words(const uint32_t* __restrict__ src,
                                           uint32_t* __restrict__ dst,
                                           int64_t n, int lane) {
  const int64_t to_edge =
      ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  const int64_t head = n < to_edge ? n : to_edge;
  if (lane < head) dst[lane] = src[lane];
  src += head;
  dst += head;
  n -= head;
  const int64_t chunks = n >> 2;
  const int s = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
  const uint4* s4 = reinterpret_cast<const uint4*>(src - s);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int64_t c0 = 0; c0 < chunks; c0 += 32 * kUnroll) {
    uint4 lo[kUnroll], hi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t c = c0 + u * 32 + lane;
      lo[u] = hi[u] = make_uint4(0, 0, 0, 0);
      if (c < chunks) {
        lo[u] = __ldg(s4 + c);
        if (s) hi[u] = __ldg(s4 + c + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t c = c0 + u * 32 + lane;
      if (c < chunks) d4[c] = funnel(lo[u], hi[u], s);
    }
  }
  const int64_t done = chunks << 2;
  if (lane < n - done) dst[done + lane] = src[done + lane];
}

__global__ void __launch_bounds__(kWarps * 32)
slab_scatter_kernel(const uint32_t* __restrict__ cols,
                    const uint32_t* __restrict__ vals,
                    const int* __restrict__ src_ptr,
                    const int* __restrict__ src_nnz, int64_t width,
                    const int64_t* __restrict__ dest,
                    const int* __restrict__ c_ptr,
                    uint32_t* __restrict__ c_cols,
                    uint32_t* __restrict__ c_vals, int n_rows) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int lane = threadIdx.x & 31;
  int64_t off, len;
  if (src_ptr != nullptr) {
    off = src_ptr[r];
    len = src_ptr[r + 1] - off;
  } else {
    len = src_nnz[r];
    if (len > width) return;  // overflowed: the fallback writes this row
    off = r * width;
  }
  if (len <= 0) return;
  const int64_t to = c_ptr[dest[r]];
  copy_words(cols + off, c_cols + to, len, lane);
  copy_words(vals + off, c_vals + to, len, lane);
}

}  // namespace

// One source into C. A slab: src_ptr null, src_nnz its (R,) int32 counts,
// cols/vals (R, width). A CSR: src_ptr its (R + 1,) int32 offsets, src_nnz
// null. dest (R,) int64 C rows; c_ptr C's (m + 1,) int32 offsets; cols and
// C's cols int32, vals and C's vals float32.
extern "C" int ocean_slab_scatter(const void* cols, const void* vals,
                                  const void* src_ptr, const void* src_nnz,
                                  long long width, const void* dest,
                                  const void* c_ptr, void* c_cols,
                                  void* c_vals, int n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  if ((src_ptr == nullptr) == (src_nnz == nullptr) || width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  slab_scatter_kernel<<<blocks, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cols), static_cast<const uint32_t*>(vals),
      static_cast<const int*>(src_ptr), static_cast<const int*>(src_nnz),
      width, static_cast<const int64_t*>(dest),
      static_cast<const int*>(c_ptr), static_cast<uint32_t*>(c_cols),
      static_cast<uint32_t*>(c_vals), n_rows);
  return static_cast<int>(cudaGetLastError());
}
