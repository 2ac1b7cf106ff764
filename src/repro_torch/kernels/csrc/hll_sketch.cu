// HyperLogLog sketch construction per row of B (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/hll.py:64 `hll_sketch` (Pallas body
//           `_sketch_kernel`, hll.py:42; hash `_hash32_u32`, hll.py:32).
//
// Computes, per row r of a CSR matrix: m registers of one byte, register j
// the largest rho = clz(h >> p) - p + 1 over the row's column ids whose hash
// h = fmix32(col * 0x9E3779B9 + seed) has h & (m - 1) == j (0 when none),
// with p = log2(m), so rho <= 32 - p + 1 <= 28. This is the seeded hash of
// src/repro/core/hll.py:25, so the registers equal
// core.hll.sketch_registers_impl for any seed, and the TPU kernel's unseeded
// `_hash32_u32` at seed 0.
//
// Bound on this card: bytes. Each column id is read once (4 bytes), each
// row's offset once, and each row writes m bytes; the hash is about 15
// integer operations an id.
//
// Design: the work is cut into chunks of equal weight, each row weighing its
// ids plus m/4 (a merge path over the rows and the ids), so a chunk holds at
// most one and a half rounds of 8 ids a thread (rows of up to half a chunk
// are not cut) and a bounded number of rows however the long rows lie:
// power-law B keeps 10.8 M of its 12.3 M ids in rows of more than 1,024
// ids, and the low vertices of an R-MAT graph hold 10^5 ids in a few dozen
// rows. A first kernel, a thread a row, writes the first row and first id
// of each chunk that begins in its row. A block then takes one chunk: its
// threads load the chunk's ids 8 at a time in two 16-byte loads, find the
// row of their first id by a binary search over the chunk's offsets in
// shared memory and walk forward, and fold rho into the row's registers, an
// int each in shared memory, with a shared atomicMax. The rows the chunk
// holds whole leave as bytes in one coalesced store; a long row cut by a
// chunk boundary (at most two a chunk) is zeroed by the first kernel and merged
// into by each of its chunks with a compare-and-swap of __vmaxu4 on each
// 4-byte word. The block size is the one that lets an SM hold the most
// threads (occupancy API: ocean_hll_sketch_blocks_per_sm).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSegs = 2;  // 16-byte segments of ids a thread a round
constexpr int kIdsAThread = 4 * kSegs;
constexpr int kSmemCap = 48 * 1024;

__device__ __forceinline__ uint32_t hash32(uint32_t x, uint32_t seed) {
  uint32_t h = x * 0x9E3779B9u + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The largest j in [0, n) with ptr[j] <= pos, given ptr[0] <= pos < ptr[n].
__device__ __forceinline__ int row_of(const int* ptr, int n, int pos) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ptr[mid] <= pos) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A chunk's weight (keys), a row's weight besides its ids, and the rows a
// chunk can hold: keys grow by at least row_keys a row, so rows r0 < r1 of
// one chunk have key(r1) - key(r0 + 1) < chunk_keys.
__host__ __device__ __forceinline__ int chunk_keys(int threads) {
  return threads * kIdsAThread;
}
__host__ __device__ __forceinline__ int row_keys(int m) { return m / 4; }
__host__ __device__ __forceinline__ int chunk_rows(int threads, int m) {
  return chunk_keys(threads) / row_keys(m) + 2;
}
// Ints of a chunk's offsets, rounded up so that the registers start at 16 B.
__host__ __device__ __forceinline__ int ptr_words(int rows) {
  return (rows + 1 + 3) / 4 * 4;
}

size_t chunk_smem(int threads, int m) {
  const int rows = chunk_rows(threads, m);
  return static_cast<size_t>(ptr_words(rows)) * sizeof(int) +
         static_cast<size_t>(rows) * m * sizeof(int);
}

// Chunk boundaries, one thread a row: boundary k, for k in [0, n_chunks],
// lies in row r when key(r) <= k * keys < key(r + 1), and in row R when
// k * keys >= key(R); each boundary has exactly one row, since a row holds
// at least c keys. For each of its boundaries the row's thread writes the
// row and the id position there. A row of at most keys / 2 ids is not cut:
// the boundary moves to its end (or stays at its start), so it stays whole
// in the chunk of its first key, which then holds fewer than 1.5 * keys
// ids. A longer row is cut, and its thread zeroes its registers, before any
// chunk merges into them. Every load is independent, where a search over
// the offsets for each boundary is a chain of dependent loads; a chunk's
// keys are a power of two, so the thread divides by a shift.
__global__ void hll_sketch_bounds_kernel(const int* __restrict__ indptr,
                                         int R, int c, int keys,
                                         int n_chunks, int m,
                                         int* __restrict__ rows_at,
                                         int* __restrict__ pos_at,
                                         uint8_t* __restrict__ regs) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int beg = indptr[r], end = indptr[r + 1];
  const long long key0 = static_cast<long long>(beg) +
                         static_cast<long long>(c) * r;
  const long long key1 = static_cast<long long>(end) +
                         static_cast<long long>(c) * (r + 1);
  const int shift = __ffs(keys) - 1;  // keys is a power of two
  const long long k1 = (key1 + keys - 1) >> shift;  // first boundary past r
  bool cut = false;
  for (long long k = (key0 + keys - 1) >> shift; k < k1 && k <= n_chunks;
       ++k) {
    const long long off = (k << shift) - key0;
    int pos;
    if (end - beg <= keys / 2) {
      pos = off > 0 ? end : beg;
    } else {
      pos = static_cast<int>(min(beg + off, static_cast<long long>(end)));
      cut = cut || (pos > beg && pos < end);
    }
    rows_at[k] = r;
    pos_at[k] = pos;
  }
  if (cut) {
    uint4* row = reinterpret_cast<uint4*>(regs + static_cast<int64_t>(r) * m);
    for (int q = 0; q < m / 16; ++q) row[q] = make_uint4(0, 0, 0, 0);
  }
  if (r == R - 1) {  // boundaries past the last row
    for (long long k = k1; k <= n_chunks; ++k) {
      rows_at[k] = R;
      pos_at[k] = end;
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kMaxThreads)
hll_sketch_kernel(const int* __restrict__ indptr,
                  const int* __restrict__ indices, uint8_t* __restrict__ regs,
                  const int* __restrict__ rows_at,
                  const int* __restrict__ pos_at, int R, long long n_ids,
                  uint32_t seed) {
  constexpr int P = M == 32 ? 5 : M == 64 ? 6 : 7;
  constexpr int W = M / 4;  // 4-byte words of a row's registers
  extern __shared__ int4 smem4[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x;
  const int r0 = rows_at[b];
  if (r0 >= R) return;  // a chunk past the last row
  const int rows = min(rows_at[b + 1], R - 1) - r0 + 1;
  const int beg = pos_at[b], end = pos_at[b + 1];
  int* s_ptr = reinterpret_cast<int*>(smem4);
  int* s_reg = s_ptr + ptr_words(chunk_rows(nt, M));

  for (int j = tid; j <= rows; j += nt) s_ptr[j] = indptr[r0 + j];
  int4* reg4 = reinterpret_cast<int4*>(s_reg);
  for (int j = tid; j < rows * W; j += nt) reg4[j] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int64_t seg_end = (static_cast<int64_t>(end) + 3) >> 2;
  for (int64_t sg = (beg >> 2) + static_cast<int64_t>(tid) * kSegs;
       sg < seg_end; sg += static_cast<int64_t>(nt) * kSegs) {
    // positions 4*sg .. 4*sg + kIdsAThread - 1, all inside the array; those
    // outside [beg, end) belong to other chunks and are skipped below
    int v[kIdsAThread];
#pragma unroll
    for (int u = 0; u < kSegs; ++u) {
      const int64_t q = (sg + u) * 4;
      if (q + 4 <= n_ids) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(indices + q));
        v[4 * u] = w.x;
        v[4 * u + 1] = w.y;
        v[4 * u + 2] = w.z;
        v[4 * u + 3] = w.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[4 * u + c] = q + c < n_ids ? __ldg(indices + q + c) : 0;
      }
    }
    const int p0 = static_cast<int>(sg * 4);
    int row = row_of(s_ptr, rows, max(p0, beg));
    int next = s_ptr[row + 1];
    if (p0 >= beg && p0 + kIdsAThread <= min(end, next)) {
      // the common case: all 8 ids in this chunk and in one row
      int* reg = s_reg + row * M;
#pragma unroll
      for (int c = 0; c < kIdsAThread; ++c) {
        const uint32_t h = hash32(static_cast<uint32_t>(v[c]), seed);
        atomicMax(&reg[h & (M - 1)], __clz(static_cast<int>(h >> P)) - P + 1);
      }
      continue;
    }
#pragma unroll
    for (int c = 0; c < kIdsAThread; ++c) {
      const int p = p0 + c;
      if (p < beg || p >= end) continue;
      while (p >= next) next = s_ptr[++row + 1];
      const uint32_t h = hash32(static_cast<uint32_t>(v[c]), seed);
      const int rho = __clz(static_cast<int>(h >> P)) - P + 1;
      atomicMax(&s_reg[row * M + (h & (M - 1))], rho);
    }
  }
  __syncthreads();

  // Rows this chunk owns (their first key lies in it) and holds whole leave
  // with plain 16-byte stores: every row but the first when that began in
  // an earlier chunk, and the last when it goes on into the next chunk (or
  // is the next chunk's). Those two merge their registers atomically.
  const long long k0 = static_cast<long long>(b) * chunk_keys(nt);
  const long long k1 = k0 + chunk_keys(nt);
  auto owned = [&](int j) {
    const long long key = static_cast<long long>(s_ptr[j]) +
                          static_cast<long long>(row_keys(M)) * (r0 + j);
    return key >= k0 && key < k1;
  };
  const int lj = rows - 1;
  const int p_lo = owned(0) ? 0 : 1;
  int p_hi = rows;
  if (lj >= p_lo && (!owned(lj) || s_ptr[lj + 1] > end)) p_hi = lj;
  const int4* src = reinterpret_cast<const int4*>(s_reg);
  auto pack = [&](int word) {  // 4 registers (ints <= 28) as 4 bytes
    const int4 a = src[word];
    return static_cast<uint32_t>(a.x) | static_cast<uint32_t>(a.y) << 8 |
           static_cast<uint32_t>(a.z) << 16 | static_cast<uint32_t>(a.w) << 24;
  };
  if (p_hi > p_lo) {
    uint4* out4 = reinterpret_cast<uint4*>(
        regs + (static_cast<int64_t>(r0) + p_lo) * M);
    const int base = p_lo * W;
    for (int j = tid; j < (p_hi - p_lo) * (M / 16); j += nt) {
      const int w = base + 4 * j;
      out4[j] = make_uint4(pack(w), pack(w + 1), pack(w + 2), pack(w + 3));
    }
  }
  for (int idx = tid; idx < (lj > 0 ? 2 : 1) * W; idx += nt) {
    const int j = idx < W ? 0 : lj;
    if (j >= p_lo && j < p_hi) continue;
    if (max(s_ptr[j], beg) >= min(s_ptr[j + 1], end)) continue;  // no ids here
    const int w = idx % W;
    const uint32_t val = pack(j * W + w);
    unsigned* addr = reinterpret_cast<unsigned*>(
        regs + (static_cast<int64_t>(r0) + j) * M) + w;
    unsigned old = *addr, assumed;
    do {
      assumed = old;
      old = atomicCAS(addr, assumed, __vmaxu4(assumed, val));
    } while (old != assumed);
  }
}

template <int M>
int launch(const void* indptr, const void* indices, void* regs, void* bounds,
           int R, long long n_ids, int n_chunks, unsigned seed, int threads,
           cudaStream_t stream) {
  int* rows_at = static_cast<int*>(bounds);
  int* pos_at = rows_at + n_chunks + 1;
  hll_sketch_bounds_kernel<<<(R + 255) / 256, 256, 0, stream>>>(
      static_cast<const int*>(indptr), R, row_keys(M), chunk_keys(threads),
      n_chunks, M, rows_at, pos_at, static_cast<uint8_t*>(regs));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hll_sketch_kernel<M><<<n_chunks, threads, chunk_smem(threads, M), stream>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<uint8_t*>(regs), rows_at, pos_at, R, n_ids, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many blocks of `threads` threads of the m-register kernel, as built,
// one SM holds at once (0 when such a block cannot launch).
extern "C" int ocean_hll_sketch_blocks_per_sm(int m, int threads,
                                              int* blocks) {
  *blocks = 0;
  if (threads <= 0 || threads % 32 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = chunk_smem(threads, m);
  if (smem > static_cast<size_t>(kSmemCap))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 32: return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, hll_sketch_kernel<32>, threads, smem));
    case 64: return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, hll_sketch_kernel<64>, threads, smem));
    case 128: return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, hll_sketch_kernel<128>, threads, smem));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// regs: (R, m) bytes and `indices` (n_ids ints), both 16-byte aligned;
// bounds: 2 * (n_chunks + 1) ints of scratch, n_chunks the chunks of
// threads * 8 keys that n_ids + R * m / 4 keys need; threads a power of
// two.
extern "C" int ocean_hll_sketch(const void* indptr, const void* indices,
                                void* regs, void* bounds, int R,
                                long long n_ids, int n_chunks, int m,
                                unsigned seed, int threads, void* stream) {
  if (threads <= 0 || threads % 32 || threads > kMaxThreads ||
      (threads & (threads - 1)) || (m != 32 && m != 64 && m != 128) ||
      chunk_smem(threads, m) > static_cast<size_t>(kSmemCap) ||
      static_cast<long long>(n_chunks) * chunk_keys(threads) <
          n_ids + static_cast<long long>(R) * row_keys(m))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 32: return launch<32>(indptr, indices, regs, bounds, R, n_ids, n_chunks, seed, threads, st);
    case 64: return launch<64>(indptr, indices, regs, bounds, R, n_ids, n_chunks, seed, threads, st);
    default: return launch<128>(indptr, indices, regs, bounds, R, n_ids, n_chunks, seed, threads, st);
  }
}
