// HyperLogLog sketch merge and estimate per A row (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/hll.py:108 `hll_merge` (Pallas body
//           `_merge_kernel`, hll.py:84).
//
// Computes, per row i of A: merged[i] = register-wise max of the B-row
// sketches (m registers of one byte) the row's column ids select, then the
// fused HLL estimate alpha*m^2 / sum(2^-reg), switched to the
// linear-counting m*ln(m/V) when V > 0 registers are zero and that value is
// <= 2.5m (the gate of src/repro/core/hll.py:136). The caller clips the
// estimate to n_cols.
//
// Bound on this card: bytes. Each A entry gathers one m-byte sketch row (32
// bytes at m 32: one sector), mostly from L2 and L1, since neighbouring rows
// share B rows; the bound counts the sketch table once, A's arrays once and
// the m-byte merged rows and the estimates once.
//
// Design: a sketch row is m/16 lanes of 16 bytes, and a group of that many
// lanes takes an A row (16 rows a warp at m 32), a block 8 warps of
// consecutive rows, so that the sketches neighbouring rows share hit the
// block's L1. A lane folds its 16 bytes of 8 sketches a round with
// __vmaxu4, the next 8 ids loading meanwhile; with the whole sketch in one
// group no shuffle is needed to fold a row. Ids outside [0, NB1) read the
// all-zero sentinel row, the last, so every gather is an unconditional load
// (a load under a condition was issued only once the one before it had
// come back). The kernel reads A's CSR directly, where the TPU kernel
// needed an (RA, max_row_len) ELL of ids. A row of more than 32 rounds is
// left to the whole block after the others: the block's groups split its
// ids and meet in shared memory, so a k-hop frontier of 10^5 ids does not
// hold one group for the whole launch. The estimate is taken from the
// bytes: 2^-reg exactly from exponent bits, V by a byte compare
// (__vcmpeq4) and __popc.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kUnroll = 8;        // ids (one 16-byte gather each) a lane a round
constexpr int kHeavyRounds = 32;  // beyond: the row is the whole block's

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y),
                    __vmaxu4(a.z, b.z), __vmaxu4(a.w, b.w));
}

__device__ __forceinline__ uint4 shfl_xor4(uint4 a, int off) {
  return make_uint4(__shfl_xor_sync(kFull, a.x, off),
                    __shfl_xor_sync(kFull, a.y, off),
                    __shfl_xor_sync(kFull, a.z, off),
                    __shfl_xor_sync(kFull, a.w, off));
}

// The sketch row of id k: ids outside [0, nb1) read the zero sentinel row
// nb1 - 1.
__device__ __forceinline__ int64_t sketch_row(int k, int nb1) {
  return static_cast<unsigned>(k) < static_cast<unsigned>(nb1) ? k : nb1 - 1;
}

// Folds into acc part `part` (16 bytes) of the sketches of ids [from, e):
// a round takes kUnroll consecutive ids from i0, and the next round starts
// `stride` ids on. The next round's ids load while this round's gathers are
// in flight.
template <int L>
__device__ __forceinline__ uint4 gather_max(const int* __restrict__ indices,
                                            const uint4* __restrict__ sk,
                                            int nb1, int from, int e,
                                            int stride, int part, uint4 acc) {
  int k[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    k[u] = from + u < e ? __ldg(indices + from + u) : -1;
  for (int i0 = from; i0 < e; i0 += stride) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      w[u] = __ldg(sk + sketch_row(k[u], nb1) * L + part);
    const int i1 = i0 + stride;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      k[u] = i1 + u < e ? __ldg(indices + i1 + u) : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = vmax4(acc, w[u]);
  }
  return acc;
}

// Every lane of the warp calls it; the L lanes of each group hold the
// group's row, 16 bytes each. They write its m bytes and the first of them
// the estimate when `write`.
template <int L>
__device__ __forceinline__ void finish(uint4 acc, int part, int64_t row,
                                       bool write, uint8_t* merged,
                                       float* est, float am2) {
  constexpr int M = 16 * L;
  const uint32_t w[4] = {acc.x, acc.y, acc.z, acc.w};
  float inv = 0.f;
  int zero_bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b)  // exactly 2^-reg
      inv += __int_as_float((127 - static_cast<int>((w[q] >> (8 * b)) & 0xffu)) << 23);
    zero_bits += __popc(__vcmpeq4(w[q], 0u));  // 8 bits a zero register
  }
#pragma unroll
  for (int off = 1; off < L; off <<= 1) {
    inv += __shfl_xor_sync(kFull, inv, off);
    zero_bits += __shfl_xor_sync(kFull, zero_bits, off);
  }
  if (!write) return;
  reinterpret_cast<uint4*>(merged + row * M)[part] = acc;
  if (part == 0) {
    const float e_raw = am2 / inv;
    const float v = static_cast<float>(zero_bits >> 3);
    const float e_small = M * logf(v > 0.f ? M / fmaxf(v, 1e-9f) : 1.f);
    est[row] = (e_small <= 2.5f * M && v > 0.f) ? e_small : e_raw;
  }
}

template <int L>
__global__ void __launch_bounds__(kWarps * 32)
hll_merge_kernel(const int* __restrict__ indptr,
                 const int* __restrict__ indices,
                 const uint4* __restrict__ sk, uint8_t* __restrict__ merged,
                 float* __restrict__ est, int RA, int nb1, float am2) {
  constexpr int kRows = kWarps * 32 / L;  // rows a block, a group of L lanes each
  __shared__ int s_heavy[kRows];
  __shared__ int s_n_heavy;
  __shared__ uint4 s_part[kWarps][L];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = lane % L;
  const int gid = threadIdx.x / L;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + gid;
  if (threadIdx.x == 0) s_n_heavy = 0;
  __syncthreads();

  int s = 0, e = 0;
  if (row < RA) {
    s = indptr[row];
    e = indptr[row + 1];
  }
  const bool heavy = e - s > kUnroll * kHeavyRounds;
  if (heavy && part == 0) s_heavy[atomicAdd(&s_n_heavy, 1)] = static_cast<int>(row);
  uint4 acc = make_uint4(0, 0, 0, 0);
  if (!heavy) acc = gather_max<L>(indices, sk, nb1, s, e, kUnroll, part, acc);
  finish<L>(acc, part, row, row < RA && !heavy, merged, est, am2);
  __syncthreads();

  // the block's long rows, one at a time: every group a share of its ids
  const int n_heavy = s_n_heavy;
  for (int h = 0; h < n_heavy; ++h) {
    const int64_t hr = s_heavy[h];
    const int hs = indptr[hr], he = indptr[hr + 1];
    uint4 a = gather_max<L>(indices, sk, nb1, hs + gid * kUnroll, he,
                            kRows * kUnroll, part, make_uint4(0, 0, 0, 0));
#pragma unroll
    for (int off = L; off < 32; off <<= 1) a = vmax4(a, shfl_xor4(a, off));
    if (lane < L) s_part[warp][lane] = a;
    __syncthreads();
    if (warp == 0) {
      a = s_part[0][part];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) a = vmax4(a, s_part[w][part]);
      finish<L>(a, part, hr, lane < L, merged, est, am2);
    }
    __syncthreads();
  }
}

template <int L>
void launch(const void* indptr, const void* indices, const void* sketches,
            void* merged, void* est, int RA, int nb1, float am2,
            cudaStream_t stream) {
  constexpr int kRows = kWarps * 32 / L;
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(RA) + kRows - 1) / kRows);
  hll_merge_kernel<L><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const uint4*>(sketches), static_cast<uint8_t*>(merged),
      static_cast<float*>(est), RA, nb1, am2);
}

}  // namespace

// sketches: (nb1, m) bytes and merged (RA, m) bytes, both 16-byte aligned.
extern "C" int ocean_hll_merge(const void* indptr, const void* indices,
                               const void* sketches, void* merged, void* est,
                               int RA, int nb1, int m, float am2, void* stream) {
  if (RA > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    switch (m) {
      case 32: launch<2>(indptr, indices, sketches, merged, est, RA, nb1, am2, st); break;
      case 64: launch<4>(indptr, indices, sketches, merged, est, RA, nb1, am2, st); break;
      case 128: launch<8>(indptr, indices, sketches, merged, est, RA, nb1, am2, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
