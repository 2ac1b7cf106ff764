// Dense-window SpGEMM accumulator for one bin of output rows (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/spgemm_dense.py:178 `spgemm_dense_bin`
//           (Pallas body `_dense_kernel`, spgemm_dense.py:41).
//
// Computes, for each row r of a bin and each column tile t: every product
// a[r,e] * b[k,j] whose column falls in [row_lo[r] + t*W, row_lo[r] + (t+1)*W)
// summed into acc[r, t*W + col - lo], plus a per-slot product count (presence
// = count > 0, which keeps structural zeros). col_tiles > 1 is the long-row
// rung: row_lo = 0 and the tiles together span every column.
//
// Bound on this card: bytes. Each product reads 8 bytes of B (column + value)
// and does two atomics; each row writes 8*W*col_tiles bytes of window. For
// narrow windows the B stream and the ELL inputs dominate; for long rows
// (W*col_tiles = n) the window write does, R*n*8 bytes per launch.
//
// Design, windowed rung (col_tiles == 1): one block of 256 threads per row.
// The window acc[W] (f32) and cnt[W] (i32) live in shared memory (32 KB at
// W = 4096). The TPU kernel scattered through one-hot MXU matmuls for want of
// atomics; here threads stride over B row k's entries and atomicAdd into
// shared memory. A slots are taken in order with a barrier between them: B
// rows have distinct columns, so within one slot no two threads hit the same
// window slot, and each slot's sum is taken in product-enumeration order, the
// plain version's order. The atomics stay so that a B with duplicate columns
// is still summed correctly.
//
// Long-row rung (col_tiles > 1): the window is the whole column range, too
// wide for shared memory, and a block per (row, tile) would walk every A slot
// of the row once per tile. Instead one block per row zeroes the row's window
// in global memory and streams the row's products once, adding them into it
// with global atomics. Slots are staged in chunks: their metadata and then
// all of their products (up to kStage) are loaded into shared memory in one
// parallel pass, so the loop that applies them slot by slot, with the same
// barrier between slots, waits on no global load. A barrier orders atomics to
// one address from one block, so the sums keep enumeration order here too.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 4096;  // products staged in shared memory per chunk

// One past the last live A slot of the row at ebase (padding is skipped; it
// may sit anywhere). Every thread of the block gets the same value.
__device__ int live_slot_end(const int* __restrict__ a_rows, int64_t ebase,
                             int E) {
  __shared__ int e_end;
  if (threadIdx.x == 0) e_end = 0;
  __syncthreads();
  int last = 0;
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    if (a_rows[ebase + e] >= 0) last = e + 1;
  if (last) atomicMax(&e_end, last);
  __syncthreads();
  return e_end;
}

__global__ void __launch_bounds__(kThreads)
dense_bin_kernel(const int* __restrict__ a_rows, const float* __restrict__ a_vals,
                 const int* __restrict__ a_starts, const int* __restrict__ a_lens,
                 const int* __restrict__ row_lo, const int* __restrict__ b_cols,
                 const float* __restrict__ b_vals, float* __restrict__ acc_out,
                 float* __restrict__ cnt_out, int E, int window) {
  extern __shared__ unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  int* cnt = reinterpret_cast<int*>(acc + window);

  const int64_t r = blockIdx.x;
  const int64_t ebase = r * E;
  const int lo = row_lo[r];

  for (int j = threadIdx.x; j < window; j += blockDim.x) {
    acc[j] = 0.f;
    cnt[j] = 0;
  }
  const int n_e = live_slot_end(a_rows, ebase, E);  // syncs the zeroing too

  for (int e = 0; e < n_e; ++e) {
    const int k = a_rows[ebase + e];  // same value in every thread
    if (k >= 0) {
      const float av = a_vals[ebase + e];
      const int start = a_starts[ebase + e];
      const int len = a_lens[ebase + e];
      for (int i = threadIdx.x; i < len; i += blockDim.x) {
        const int col = b_cols[start + i];
        const int local = col - lo;
        if (col >= 0 && local >= 0 && local < window) {
          atomicAdd(&acc[local], av * b_vals[start + i]);
          atomicAdd(&cnt[local], 1);
        }
      }
    }
    __syncthreads();  // slot e is complete before slot e + 1 adds
  }

  const int64_t off = r * window;
  for (int j = threadIdx.x; j < window; j += blockDim.x) {
    acc_out[off + j] = acc[j];
    cnt_out[off + j] = static_cast<float>(cnt[j]);
  }
}

// Adds one product into the row's global window (acc, cnt hold its base).
__device__ __forceinline__ void add_product(float* acc, float* cnt, int col,
                                            float v, int lo, int width) {
  const int local = col - lo;
  if (col >= 0 && local >= 0 && local < width) {
    atomicAdd(&acc[local], v);
    atomicAdd(&cnt[local], 1.f);
  }
}

__global__ void __launch_bounds__(kThreads)
dense_longrow_kernel(const int* __restrict__ a_rows,
                     const float* __restrict__ a_vals,
                     const int* __restrict__ a_starts,
                     const int* __restrict__ a_lens,
                     const int* __restrict__ row_lo,
                     const int* __restrict__ b_cols,
                     const float* __restrict__ b_vals,
                     float* __restrict__ acc_out, float* __restrict__ cnt_out,
                     int E, int width) {
  __shared__ int s_col[kStage];
  __shared__ float s_val[kStage];
  __shared__ int s_off[kThreads + 1];  // exclusive prefix of the chunk's lens
  __shared__ int s_start[kThreads];
  __shared__ float s_av[kThreads];
  __shared__ int s_wsum[kWarps];

  const int64_t r = blockIdx.x;
  const int64_t ebase = r * E;
  const int lo = row_lo[r];
  float* acc = acc_out + r * width;
  float* cnt = cnt_out + r * width;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // width is a multiple of 2048 and the outputs are 16-byte aligned
  float4* acc4 = reinterpret_cast<float4*>(acc);
  float4* cnt4 = reinterpret_cast<float4*>(cnt);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = threadIdx.x; j < width / 4; j += blockDim.x) {
    acc4[j] = zero;
    cnt4[j] = zero;
  }
  const int n_e = live_slot_end(a_rows, ebase, E);  // syncs the zeroing too

  for (int e0 = 0; e0 < n_e; ) {
    // stage the metadata of slots e0 .. e0 + kThreads - 1
    const int e = e0 + threadIdx.x;
    int len = 0;
    if (e < n_e && a_rows[ebase + e] >= 0) {
      len = a_lens[ebase + e];
      s_start[threadIdx.x] = a_starts[ebase + e];
      s_av[threadIdx.x] = a_vals[ebase + e];
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
    if (threadIdx.x == 0) s_off[0] = 0;
    // slots of this chunk whose products all fit in the stage
    const int c = __syncthreads_count(e < n_e && x <= kStage);

    if (c == 0) {
      // slot e0 alone has more than kStage products: stream it from global
      const int n = s_off[1];
      const int start = s_start[0];
      const float av = s_av[0];
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        add_product(acc, cnt, b_cols[start + i], av * b_vals[start + i], lo,
                    width);
      e0 += 1;
      __syncthreads();
      continue;
    }

    // load every product of slots 0 .. c-1 of the chunk in one parallel pass
    const int total = s_off[c];
    for (int p = threadIdx.x; p < total; p += blockDim.x) {
      int a = 0, b = c;  // the slot s with s_off[s] <= p < s_off[s + 1]
      while (b - a > 1) {
        const int m = (a + b) >> 1;
        if (s_off[m] <= p) a = m; else b = m;
      }
      const int pos = s_start[a] + (p - s_off[a]);
      s_col[p] = b_cols[pos];
      s_val[p] = s_av[a] * b_vals[pos];
    }
    __syncthreads();

    // apply them slot by slot, in order
    for (int s = 0; s < c; ++s) {
      const int o = s_off[s], n = s_off[s + 1] - o;
      if (n == 0) continue;  // the same for every thread
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        add_product(acc, cnt, s_col[o + i], s_val[o + i], lo, width);
      __syncthreads();  // slot s is complete before slot s + 1 adds
    }
    e0 += c;
    __syncthreads();  // the stage is free before the next chunk fills it
  }
}

}  // namespace

extern "C" int ocean_dense_bin(const void* a_rows, const void* a_vals,
                               const void* a_starts, const void* a_lens,
                               const void* row_lo, const void* b_cols,
                               const void* b_vals, void* acc, void* cnt, int R,
                               int E, int window, int col_tiles, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > 0 && col_tiles == 1) {
    const size_t smem = (size_t)window * (sizeof(float) + sizeof(int));
    dense_bin_kernel<<<R, kThreads, smem, s>>>(
        static_cast<const int*>(a_rows), static_cast<const float*>(a_vals),
        static_cast<const int*>(a_starts), static_cast<const int*>(a_lens),
        static_cast<const int*>(row_lo), static_cast<const int*>(b_cols),
        static_cast<const float*>(b_vals), static_cast<float*>(acc),
        static_cast<float*>(cnt), E, window);
  } else if (R > 0 && col_tiles > 1) {
    dense_longrow_kernel<<<R, kThreads, 0, s>>>(
        static_cast<const int*>(a_rows), static_cast<const float*>(a_vals),
        static_cast<const int*>(a_starts), static_cast<const int*>(a_lens),
        static_cast<const int*>(row_lo), static_cast<const int*>(b_cols),
        static_cast<const float*>(b_vals), static_cast<float*>(acc),
        static_cast<float*>(cnt), E, window * col_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
