// Hash-table SpGEMM accumulator for one bin of output rows (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/spgemm_hash.py:170 `spgemm_hash_bin`
//           (Pallas bodies `_hash_kernel` :97 and `_probe_insert` :64).
//
// Computes, per output row: an open-addressing table of `table` slots
// (keys i32, -1 = empty; values f32) filled with the row's products by
// Fibonacci hashing h = (u32(col) * 2654435769) >> (32 - p) and linear
// probing, accumulating on a hit. When the primary table has no free slot the
// product goes to a spill table of `spill` slots (same hash at the spill's p);
// when both are full the row's fail counter counts the failed insert, so
// fail > 0 iff the row has more distinct columns than table + spill.
//
// Bound on this card: latency of the dependent probe loads and atomics rather
// than bytes: each product reads 8 bytes of B and does one or a few
// shared-memory probes; the tables write 8*(table + spill) bytes per row.
//
// Design: the paper's hybrid accumulator. One block per row; the primary
// table (at most 2048 slots, 16 KB) lives in shared memory with atomicCAS on
// keys and atomicAdd on values; the spill table lives in global memory, in the
// row's own skeys/svals output, and the block initialises it. The TPU kernel
// probed the whole table as one vector op for want of atomics; here each
// thread probes for its own product. A slots are taken in order with a barrier
// between them, so each column's sum is taken in product-enumeration order.
// Slot positions may differ from run to run (inserts within a slot race for
// empty slots); the extracted, column-sorted rows do not.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFibMult = 2654435769u;

__device__ __forceinline__ int log2_pow2(int size) { return 31 - __clz(size); }

// Insert (col, v) into a pow2 table; returns false when the table is full and
// does not hold col. Works on shared or global memory (generic addressing).
__device__ bool probe_insert(int* keys, float* vals, int size, int col, float v) {
  const int p = log2_pow2(size);
  const unsigned h = (static_cast<unsigned>(col) * kFibMult) >> (32 - p);
  for (int d = 0; d < size; ++d) {
    const int s = static_cast<int>((h + d) & (size - 1));
    int cur = *reinterpret_cast<volatile int*>(&keys[s]);
    if (cur == -1) cur = atomicCAS(&keys[s], -1, col);
    if (cur == -1 || cur == col) {
      atomicAdd(&vals[s], v);
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
hash_bin_kernel(const int* __restrict__ a_rows, const float* __restrict__ a_vals,
                const int* __restrict__ a_starts, const int* __restrict__ a_lens,
                const int* __restrict__ b_cols, const float* __restrict__ b_vals,
                int* __restrict__ keys_out, float* __restrict__ vals_out,
                int* skeys_out, float* svals_out, int* __restrict__ fail_out,
                int E, int table, int spill) {
  extern __shared__ unsigned char smem[];
  int* keys = reinterpret_cast<int*>(smem);
  float* vals = reinterpret_cast<float*>(keys + table);
  __shared__ int fail;
  __shared__ int e_end;

  const int64_t r = blockIdx.x;
  const int64_t ebase = r * E;
  int* skeys = skeys_out + r * spill;
  float* svals = svals_out + r * spill;

  for (int j = threadIdx.x; j < table; j += blockDim.x) {
    keys[j] = -1;
    vals[j] = 0.f;
  }
  for (int j = threadIdx.x; j < spill; j += blockDim.x) {
    skeys[j] = -1;
    svals[j] = 0.f;
  }
  if (threadIdx.x == 0) {
    fail = 0;
    e_end = 0;
  }
  __syncthreads();
  int last = 0;
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    if (a_rows[ebase + e] >= 0) last = e + 1;
  if (last) atomicMax(&e_end, last);
  __syncthreads();
  const int n_e = e_end;

  for (int e = 0; e < n_e; ++e) {
    const int k = a_rows[ebase + e];  // same value in every thread
    if (k >= 0) {
      const float av = a_vals[ebase + e];
      const int start = a_starts[ebase + e];
      const int len = a_lens[ebase + e];
      for (int i = threadIdx.x; i < len; i += blockDim.x) {
        const int col = b_cols[start + i];
        if (col < 0) continue;
        const float v = av * b_vals[start + i];
        if (!probe_insert(keys, vals, table, col, v) &&
            !probe_insert(skeys, svals, spill, col, v))
          atomicAdd(&fail, 1);
      }
    }
    __syncthreads();  // slot e is complete before slot e + 1 inserts
  }

  const int64_t off = r * table;
  for (int j = threadIdx.x; j < table; j += blockDim.x) {
    keys_out[off + j] = keys[j];
    vals_out[off + j] = vals[j];
  }
  if (threadIdx.x == 0) fail_out[r] = fail;
}

}  // namespace

extern "C" int ocean_hash_bin(const void* a_rows, const void* a_vals,
                              const void* a_starts, const void* a_lens,
                              const void* b_cols, const void* b_vals, void* keys,
                              void* vals, void* skeys, void* svals, void* fail,
                              int R, int E, int table, int spill, void* stream) {
  if (R > 0) {
    const size_t smem = (size_t)table * (sizeof(int) + sizeof(float));
    hash_bin_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a_rows), static_cast<const float*>(a_vals),
        static_cast<const int*>(a_starts), static_cast<const int*>(a_lens),
        static_cast<const int*>(b_cols), static_cast<const float*>(b_vals),
        static_cast<int*>(keys), static_cast<float*>(vals),
        static_cast<int*>(skeys), static_cast<float*>(svals),
        static_cast<int*>(fail), E, table, spill);
  }
  return static_cast<int>(cudaGetLastError());
}
