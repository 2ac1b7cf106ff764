// HyperLogLog sketch construction per row of B (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/hll.py:64 `hll_sketch` (Pallas body
//           `_sketch_kernel`, hll.py:42; hash `_hash32_u32`, hll.py:32).
//
// Computes, per row r of a CSR matrix: m registers, register j the largest
// rho = clz(h >> p) - p + 1 over the row's column ids whose hash
// h = fmix32(col * 0x9E3779B9 + seed) has h & (m - 1) == j (0 when none),
// with p = log2(m). This is the seeded hash of src/repro/core/hll.py:25, so
// the registers equal core.hll.sketch_registers_impl for any seed, and the
// TPU kernel's unseeded `_hash32_u32` at seed 0.
//
// Bound on this card: bytes. Each column id is read once (4 bytes) and each
// row writes m * 4 bytes; the hash is a dozen integer operations per id.
//
// Design: one warp per row, a grid-stride loop over rows. The warp's m <= 128
// registers live in shared memory; lanes stride over the row's ids, coalesced,
// and fold each rho in with a shared-memory atomicMax (the paper's §3.1
// update, which the TPU replaced by a one-hot max-reduction for want of
// atomics). The kernel reads B's CSR directly: the TPU kernel took an
// (R, max row length rounded to 128) ELL, which for a power-law B at 2^20 rows
// would be gigabytes of padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRegs = 128;
constexpr int kMaxBlocks = 8192;

__device__ __forceinline__ uint32_t hash32(uint32_t x, uint32_t seed) {
  uint32_t h = x * 0x9E3779B9u + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(kWarps * 32)
hll_sketch_kernel(const int* __restrict__ indptr,
                  const int* __restrict__ indices, int* __restrict__ regs,
                  int R, int m, int p, uint32_t seed) {
  __shared__ int s_reg[kWarps][kMaxRegs];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* reg = s_reg[warp];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       row < R; row += stride) {  // whole warps take the same rows
    for (int j = lane; j < m; j += 32) reg[j] = 0;
    __syncwarp();
    const int s = indptr[row], e = indptr[row + 1];
    for (int i = s + lane; i < e; i += 32) {
      const uint32_t h = hash32(static_cast<uint32_t>(indices[i]), seed);
      const int rho = __clz(static_cast<int>(h >> p)) - p + 1;
      atomicMax(&reg[h & (m - 1)], rho);
    }
    __syncwarp();
    for (int j = lane; j < m; j += 32) regs[row * m + j] = reg[j];
    __syncwarp();  // the row's registers are out before the next row zeroes
  }
}

}  // namespace

extern "C" int ocean_hll_sketch(const void* indptr, const void* indices,
                                void* regs, int R, int m, unsigned seed,
                                void* stream) {
  if (m <= 0 || m > kMaxRegs || (m & (m - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0) {
    int p = 0;
    while ((1 << p) < m) ++p;
    const int64_t want = (static_cast<int64_t>(R) + kWarps - 1) / kWarps;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
    hll_sketch_kernel<<<blocks, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<int*>(regs), R, m, p, seed);
  }
  return static_cast<int>(cudaGetLastError());
}
