// HyperLogLog sketch merge and estimate per A row (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/hll.py:108 `hll_merge` (Pallas body
//           `_merge_kernel`, hll.py:84).
//
// Computes, per row i of A: merged[i] = register-wise max of the B-row
// sketches the row's column ids select, then the fused HLL estimate
// alpha*m^2 / sum(2^-reg), switched to the linear-counting m*ln(m/V) when
// V > 0 registers are zero and that value is <= 2.5m (the gate of
// src/repro/core/hll.py:136). The caller clips the estimate to n_cols.
//
// Bound on this card: bytes. Each A entry gathers one m*4-byte sketch row
// (128 or 256 bytes, coalesced across the warp); merged rows write m*4 bytes.
//
// Design: one warp per A row, registers spread across the lanes (m = 32*P, P
// per lane). The warp reads 32 of the row's column ids at a time, coalesced,
// and broadcasts each with a shuffle. It reads A's CSR directly, where the TPU
// kernel needed an (RA, max_row_len) ELL of ids, which for a power-law A at
// 2^20 rows reaches gigabytes. The estimate uses a shuffle reduction of 2^-reg
// (built exactly from the exponent bits) and __ballot_sync/__popc for V. Ids
// outside [0, NB1) act as the all-zero sentinel row and are skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hll_merge_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                 const int* __restrict__ sketches, int* __restrict__ merged,
                 float* __restrict__ est, int RA, int nb1, float am2) {
  constexpr int m = 32 * P;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= RA) return;  // whole warps leave together

  int reg[P];
#pragma unroll
  for (int q = 0; q < P; ++q) reg[q] = 0;

  const int s = indptr[row];
  const int e = indptr[row + 1];
  for (int base = s; base < e; base += 32) {
    const int mine = (base + lane < e) ? indices[base + lane] : -1;
    const int n = min(32, e - base);
    for (int q = 0; q < n; ++q) {
      const int k = __shfl_sync(kFull, mine, q);
      if (k < 0 || k >= nb1) continue;
      const int* sk = sketches + static_cast<int64_t>(k) * m;
#pragma unroll
      for (int p = 0; p < P; ++p) reg[p] = max(reg[p], sk[p * 32 + lane]);
    }
  }

  float inv = 0.f;
  int zeros = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    merged[row * m + p * 32 + lane] = reg[p];
    inv += __int_as_float((127 - reg[p]) << 23);  // exactly 2^-reg
    zeros += __popc(__ballot_sync(kFull, reg[p] == 0));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) inv += __shfl_xor_sync(kFull, inv, off);
  if (lane == 0) {
    const float e_raw = am2 / inv;
    const float v = static_cast<float>(zeros);
    const float e_small = m * logf(v > 0.f ? m / fmaxf(v, 1e-9f) : 1.f);
    est[row] = (e_small <= 2.5f * m && v > 0.f) ? e_small : e_raw;
  }
}

}  // namespace

extern "C" int ocean_hll_merge(const void* indptr, const void* indices,
                               const void* sketches, void* merged, void* est,
                               int RA, int nb1, int m, float am2, void* stream) {
  if (RA > 0) {
    const int blocks = (RA + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* ip = static_cast<const int*>(indptr);
    const auto* ix = static_cast<const int*>(indices);
    const auto* sk = static_cast<const int*>(sketches);
    auto* mg = static_cast<int*>(merged);
    auto* es = static_cast<float*>(est);
    switch (m) {
      case 32: hll_merge_kernel<1><<<blocks, kWarpsPerBlock * 32, 0, st>>>(ip, ix, sk, mg, es, RA, nb1, am2); break;
      case 64: hll_merge_kernel<2><<<blocks, kWarpsPerBlock * 32, 0, st>>>(ip, ix, sk, mg, es, RA, nb1, am2); break;
      case 128: hll_merge_kernel<4><<<blocks, kWarpsPerBlock * 32, 0, st>>>(ip, ix, sk, mg, es, RA, nb1, am2); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
