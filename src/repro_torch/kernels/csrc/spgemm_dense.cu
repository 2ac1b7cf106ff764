// Dense-window SpGEMM accumulator for one bin of output rows, writing each
// row's compacted slab (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/spgemm_dense.py:178 `spgemm_dense_bin`
//           (Pallas body `_dense_kernel`, spgemm_dense.py:41) together with
//           its XLA epilogue `extract_window_rows` (src/repro/kernels/ops.py:101):
//           the reference's `dense_bin_op` (ops.py:162).
//
// Computes, for each row r of a bin: every product a[r,e] * b[k,j] whose
// column lies in [row_lo[r], row_lo[r] + window*col_tiles), summed per column
// in product-enumeration order (A slot major, B position minor). A column is
// present when it has at least one product (structural zeros are kept).
// Per row it writes nnz[r], the number of present columns (it may exceed
// cap), and the slab: cols[r, :cap] the first cap present columns in column
// order as global ids, PAD_COL past min(nnz, cap); vals[r, :cap] their sums,
// 0 past it. col_tiles > 1 is the long-row rung: row_lo = 0 and the range is
// every column.
//
// Bound on this card: bytes. The ELL inputs (a_rows whole, the other three at
// live slots), the B rows the bin references, and the slab, R*(cap*8 + 4)
// bytes. No (R, window*col_tiles) window reaches device memory: each row's
// window lives in shared memory and only its slab is written.
//
// Windowed rung (col_tiles == 1, window <= 4096): one warp per row, up to 8
// rows per block (by the window's shared memory); the warp is the unit, so
// no block barrier is needed. The warp's window is an f32 sum and a presence
// byte per column (plain stores: a bit per column would take atomics that
// the whole warp aims at one word). The warp takes its row's A slots 32 at a
// time: each lane reads one slot's metadata, a warp scan of their lengths
// lays their products out, and kWarpStage products at a time are loaded in
// one pass (kUnroll loads in flight per lane, each lane finding its
// product's slot by a shuffle search; presence set there, order-free), then
// added slot by slot with __syncwarp between slots, which keeps each
// column's sum in enumeration order. The adds are shared-memory atomics (a
// CAS loop for f32 on this card): a B row's columns are distinct, so they
// never contend, but a B row holding one column twice is still summed
// right. At the end a ballot over 32 presence bytes at a time ranks the
// columns (popc of those below), so the slab is written in column order
// with no prefix-sum array.
//
// Long-row rung (col_tiles > 1): the range is too wide for an f32 window in
// shared memory, but one presence bit per column fits (2^20 columns: 128 KB).
// One block of 512 threads per row (1 per SM) takes a segment of the range
// at a time:
//   1. sets the presence bit of every product's column: order-free, so a
//      chunk of 512 slots' products is spread over all threads (a binary
//      search of the chunk's offsets per product, kUnroll in flight), with
//      no barrier per slot;
//   2. scans the popcounts of the 64-column words into a rank per word
//      (uint16, clamped to cap; 32 KB at 2^20 columns);
//   3. writes cols from the set bits whose rank is below cap;
//   4. streams the products again, kLongStage at a time: each warp loads a
//      share of 256 consecutive products with their ranks (rank = word rank
//      + popc(bits below)) and sorts it stably by rank mod 16, one bucket per
//      warp; after a barrier warp b adds bucket b from every share in share
//      order into the slab's copy in shared memory, 32 products at a time,
//      the lowest lane of each rank summing its peers (__match_any_sync) in
//      lane order. So all 16 warps add at once, each column's sum keeps
//      enumeration order, and no two lanes write one address.
// Ranges wider than one shared-memory bitmap are taken in segments, the
// products re-streamed per segment; segments wholly past cap skip steps 3-4.
// The cap may be any width whose slots fit beside the smallest segment; an
// exact plan sizes each long-row launch from its rows' exact sizes, up to
// the cap at which one segment holds the range (ocean_longrow_max_cap).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadCol = 0x7fffffff;  // core.formats.PAD_COL

// windowed rung
constexpr int kWarpStage = 512;       // products staged per warp
constexpr int kRowsPerBlockMax = 8;   // warps (= rows) per block
constexpr int kWindowSmemTarget = 48 * 1024;
constexpr int kUnroll = 4;            // products a lane loads at once

// long-row rung
constexpr int kLongThreads = 512;
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kLongStage = 4096;      // products staged at a time
constexpr int kLongSub = kLongStage / kLongWarps;  // a warp's share of it
constexpr int kSubPerLane = kLongSub / 32;
constexpr int kBucketBits = 4;
constexpr int kBuckets = 1 << kBucketBits;  // rank buckets, one warp each
static_assert(kBuckets == kLongWarps, "one rank bucket per warp");
constexpr int kWordAlign = 32 * kLongWarps;  // segment words: warp-aligned

__device__ __forceinline__ int warp_incl_scan(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// ---------------------------------------------------------------------------
// Windowed rung
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int window_pres_bytes(int window) {
  return (window + 3) & ~3;
}

__host__ __device__ constexpr int window_warp_bytes(int window) {
  return window * 4 + window_pres_bytes(window) + kWarpStage * 8;
}

// The last of a warp's 32 slots whose exclusive product offset is <= p.
__device__ __forceinline__ int slot_of(int excl, int p) {
  int j = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int v = __shfl_sync(kFull, excl, j + step);
    if (v <= p) j += step;
  }
  return j;
}

__global__ void __launch_bounds__(kRowsPerBlockMax * 32)
window_slab_kernel(const int* __restrict__ a_rows,
                   const float* __restrict__ a_vals,
                   const int* __restrict__ a_starts,
                   const int* __restrict__ a_lens,
                   const int* __restrict__ row_lo,
                   const int* __restrict__ b_cols,
                   const float* __restrict__ b_vals, int* __restrict__ cols_out,
                   float* __restrict__ vals_out, int* __restrict__ nnz_out,
                   int R, int E, int window, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;  // no block barrier below: the warp is the unit
  float* acc = reinterpret_cast<float*>(smem + (size_t)warp *
                                        window_warp_bytes(window));
  // presence: one byte per column, set by plain stores (a bit per column
  // would take atomics that a whole warp aims at one word)
  unsigned char* pres = reinterpret_cast<unsigned char*>(acc + window);
  int* s_loc = reinterpret_cast<int*>(pres + window_pres_bytes(window));
  float* s_val = reinterpret_cast<float*>(s_loc + kWarpStage);

  const int lo = row_lo[r];
  for (int j = lane; j < window; j += 32) acc[j] = 0.f;
  for (int j = lane; j < window_pres_bytes(window) / 4; j += 32)
    reinterpret_cast<unsigned*>(pres)[j] = 0u;
  __syncwarp();

  const int64_t ebase = r * E;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    int len = 0, start = 0;
    float av = 0.f;
    if (e < E && a_rows[ebase + e] >= 0) {
      len = a_lens[ebase + e];
      start = a_starts[ebase + e];
      av = a_vals[ebase + e];
    }
    if (__ballot_sync(kFull, len > 0) == 0) continue;
    const int incl = warp_incl_scan(len, lane);
    const int excl = incl - len;
    const int total = __shfl_sync(kFull, incl, 31);

    // the 32 slots' products, kWarpStage at a time, in enumeration order
    for (int p0 = 0; p0 < total; p0 += kWarpStage) {
      const int n = min(kWarpStage, total - p0);
      // load them in one pass (every lane runs every iteration: the slot
      // search shuffles), presence set as they come (order-free)
      for (int q0 = 0; q0 < n; q0 += 32 * kUnroll) {
        int pos[kUnroll];
        float as[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = p0 + q0 + u * 32 + lane;
          const int j = slot_of(excl, p);
          pos[u] = __shfl_sync(kFull, start, j) + p -
                   __shfl_sync(kFull, excl, j);
          as[u] = __shfl_sync(kFull, av, j);
        }
        int col[kUnroll];
        float bv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (q0 + u * 32 + lane < n) {
            col[u] = b_cols[pos[u]];
            bv[u] = b_vals[pos[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + u * 32 + lane;
          if (q < n) {
            const int local = col[u] - lo;
            const bool ok = col[u] >= 0 && local >= 0 && local < window;
            if (ok) pres[local] = 1;
            s_loc[q] = ok ? local : -1;
            s_val[q] = as[u] * bv[u];
          }
        }
      }
      __syncwarp();
      // add them slot by slot: a B row's columns are distinct, so the
      // lanes of one slot add to distinct addresses, and __syncwarp between
      // slots keeps each column's sum in enumeration order
      const int j_end = slot_of(excl, p0 + n - 1);
      for (int j = slot_of(excl, p0); j <= j_end; ++j) {
        const int q_lo = max(__shfl_sync(kFull, excl, j), p0) - p0;
        const int q_hi = min(__shfl_sync(kFull, incl, j), p0 + n) - p0;
        if (q_lo >= q_hi) continue;  // the same in every lane
        for (int q = q_lo + lane; q < q_hi; q += 32) {
          const int l = s_loc[q];
          if (l >= 0) atomicAdd(&acc[l], s_val[q]);
        }
        __syncwarp();
      }
      __syncwarp();  // the stage is read before the next pass fills it
    }
  }

  // the slab: present columns in column order, rank = popc of those below
  const int64_t obase = r * cap;
  int rank = 0;
  for (int c0 = 0; c0 < window; c0 += 32) {
    const int local = c0 + lane;
    const bool here = local < window && pres[local];
    const unsigned word = __ballot_sync(kFull, here);
    const int rk = rank + __popc(word & below);
    if (here && rk < cap) {
      cols_out[obase + rk] = lo + local;
      vals_out[obase + rk] = acc[local];
    }
    rank += __popc(word);
  }
  for (int j = min(rank, cap) + lane; j < cap; j += 32) {
    cols_out[obase + j] = kPadCol;
    vals_out[obase + j] = 0.f;
  }
  if (lane == 0) nnz_out[r] = rank;
}

// ---------------------------------------------------------------------------
// Long-row rung
// ---------------------------------------------------------------------------

struct LongShared {
  int off[kLongThreads + 1];  // exclusive prefix of the chunk's lens
  int start[kLongThreads];
  float av[kLongThreads];
  int wsum[kLongWarps];
  int wbase[kLongWarps];
  // per warp's share of the stage: where each rank bucket starts (its
  // counts while they are taken); [kBuckets] is the share's kept products
  int bucket[kLongWarps][kBuckets + 1];
  int n_e;
  int seg_cnt;
};

// Adds the values of 32 lanes (enumeration order = lane order; idx < 0:
// none) into acc[idx] in lane order: the lowest lane of each group of
// peers (the lanes with its idx) sums their values, so no two lanes write
// one address and each sum keeps enumeration order.
__device__ __forceinline__ void add_in_order(float* acc, int idx,
                                             unsigned peers,
                                             const float* vals,
                                             unsigned below) {
  if (idx >= 0 && (peers & below) == 0) {
    float sum = acc[idx];
    for (unsigned m = peers; m; m &= m - 1) sum += vals[__ffs(m) - 1];
    acc[idx] = sum;
  }
}

// Stages the metadata of slots e0 .. e0 + kLongThreads - 1 of the row at
// ebase (padding as 0 products). Ends with a barrier: sh.off is readable,
// sh.off[kLongThreads] the chunk's products.
__device__ void stage_slots(const int* __restrict__ a_rows,
                            const float* __restrict__ a_vals,
                            const int* __restrict__ a_starts,
                            const int* __restrict__ a_lens, int64_t ebase,
                            int e0, int E, LongShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = e0 + threadIdx.x;
  int len = 0, start = 0;
  float av = 0.f;
  if (e < E && a_rows[ebase + e] >= 0) {
    len = a_lens[ebase + e];
    start = a_starts[ebase + e];
    av = a_vals[ebase + e];
  }
  int x = warp_incl_scan(len, lane);
  if (lane == 31) sh.wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kLongWarps ? sh.wsum[lane] : 0;
    w = warp_incl_scan(w, lane);
    if (lane < kLongWarps) sh.wsum[lane] = w;
  }
  __syncthreads();
  x += warp ? sh.wsum[warp - 1] : 0;
  sh.off[threadIdx.x + 1] = x;
  sh.start[threadIdx.x] = start;
  sh.av[threadIdx.x] = av;
  if (threadIdx.x == 0) sh.off[0] = 0;
  __syncthreads();
}

// The slot a of the staged chunk with off[a] <= p < off[a + 1].
__device__ __forceinline__ int find_slot(const int* off, int p) {
  int a = 0;
  for (int step = kLongThreads / 2; step > 0; step >>= 1)
    if (off[a + step] <= p) a += step;
  return a;
}

// Rank of column col in the row (-1 when outside the segment or at or past
// cap).
__device__ __forceinline__ int rank_of(int col, int seg_lo, int seg_n,
                                       const unsigned long long* bits,
                                       const uint16_t* rank16, int cap) {
  const int local = col - seg_lo;
  if (col < 0 || local < 0 || local >= seg_n) return -1;
  const int w = local >> 6;
  const unsigned long long below = (1ull << (local & 63)) - 1ull;
  const int rk = rank16[w] + __popcll(bits[w] & below);
  return rk < cap ? rk : -1;
}

__global__ void __launch_bounds__(kLongThreads, 1)
longrow_slab_kernel(const int* __restrict__ a_rows,
                    const float* __restrict__ a_vals,
                    const int* __restrict__ a_starts,
                    const int* __restrict__ a_lens,
                    const int* __restrict__ row_lo,
                    const int* __restrict__ b_cols,
                    const float* __restrict__ b_vals,
                    int* __restrict__ cols_out, float* __restrict__ vals_out,
                    int* __restrict__ nnz_out, int E, int width, int seg_words,
                    int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ LongShared sh;
  unsigned long long* bits = reinterpret_cast<unsigned long long*>(smem);
  unsigned* bits32 = reinterpret_cast<unsigned*>(smem);
  uint16_t* rank16 = reinterpret_cast<uint16_t*>(bits + seg_words);
  float* s_acc = reinterpret_cast<float*>(rank16 + seg_words);
  int* s_rank = reinterpret_cast<int*>(s_acc + ((cap + 3) & ~3));
  float* s_val = reinterpret_cast<float*>(s_rank + kLongStage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t r = blockIdx.x;
  const int64_t ebase = r * E;
  const int lo = row_lo[r];
  const int64_t obase = r * cap;
  const int seg_cols = seg_words * 64;

  // one past the last live slot (padding is skipped; it may sit anywhere)
  if (tid == 0) sh.n_e = 0;
  for (int j = tid; j < cap; j += kLongThreads) s_acc[j] = 0.f;
  __syncthreads();
  int last = 0;
  for (int e = tid; e < E; e += kLongThreads)
    if (a_rows[ebase + e] >= 0) last = e + 1;
  if (last) atomicMax(&sh.n_e, last);
  __syncthreads();
  const int n_e = sh.n_e;
  int done = 0;  // present columns of the earlier segments (block-uniform)

  for (int seg0 = 0; seg0 < width; seg0 += seg_cols) {
    const int seg_n = min(seg_cols, width - seg0);
    const int nw = (seg_n + 63) >> 6;
    const int seg_lo = lo + seg0;
    for (int j = tid; j < nw; j += kLongThreads) bits[j] = 0ull;
    __syncthreads();

    // 1. presence bits: order-free, a chunk's products over all threads
    for (int e0 = 0; e0 < n_e; e0 += kLongThreads) {
      stage_slots(a_rows, a_vals, a_starts, a_lens, ebase, e0, E, sh);
      const int total = sh.off[kLongThreads];
      for (int p0 = 0; p0 < total; p0 += kLongThreads * kUnroll) {
        int pos[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = p0 + u * kLongThreads + tid;
          const int a = find_slot(sh.off, p < total ? p : 0);
          pos[u] = sh.start[a] + (p - sh.off[a]);
        }
        int col[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          col[u] = p0 + u * kLongThreads + tid < total ? b_cols[pos[u]] : -1;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int local = col[u] - seg_lo;
          if (col[u] >= 0 && local >= 0 && local < seg_n)  // 32-bit: native
            atomicOr(&bits32[local >> 5], 1u << (local & 31));
        }
      }
      __syncthreads();  // the chunk is read before the next one is staged
    }

    // 2. ranks: warp w scans words [w*wpw, (w+1)*wpw) with a carry
    const int wpw = (nw + kWordAlign - 1) / kWordAlign * 32;
    const int w_lo = warp * wpw, w_hi = min(nw, w_lo + wpw);
    int cnt = 0;
    for (int i = w_lo + lane; i < w_hi; i += 32) cnt += __popcll(bits[i]);
    for (int d = 16; d > 0; d >>= 1) cnt += __shfl_xor_sync(kFull, cnt, d);
    if (lane == 0) sh.wsum[warp] = cnt;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < kLongWarps ? sh.wsum[lane] : 0;
      const int incl = warp_incl_scan(w, lane);
      if (lane < kLongWarps) sh.wbase[lane] = done + incl - w;
      if (lane == kLongWarps - 1) sh.seg_cnt = incl;
    }
    __syncthreads();
    int carry = sh.wbase[warp];
    for (int i0 = w_lo; i0 < w_hi; i0 += 32) {
      const int i = i0 + lane;
      if (carry >= cap) {  // the rest rank at or past cap (the same in
        for (int k = i; k < w_hi; k += 32) rank16[k] = (uint16_t)cap;
        break;             // every lane)
      }
      const int x = i < w_hi ? __popcll(bits[i]) : 0;
      const int incl = warp_incl_scan(x, lane);
      if (i < w_hi) rank16[i] = (uint16_t)min(carry + incl - x, cap);
      carry += __shfl_sync(kFull, incl, 31);
    }
    const int seg_cnt = sh.seg_cnt;
    __syncthreads();

    if (done < cap) {
      // 3. cols: the set bits whose rank is below cap, in column order
      for (int i = tid; i < nw; i += kLongThreads) {
        int rk = rank16[i];
        unsigned long long word = bits[i];
        while (word && rk < cap) {
          const int b = __ffsll(word) - 1;
          cols_out[obase + rk] = seg_lo + i * 64 + b;
          ++rk;
          word &= word - 1ull;
        }
      }

      // 4. values in enumeration order, kLongStage products at a time
      for (int e0 = 0; e0 < n_e; e0 += kLongThreads) {
        stage_slots(a_rows, a_vals, a_starts, a_lens, ebase, e0, E, sh);
        const int total = sh.off[kLongThreads];
        for (int p0 = 0; p0 < total; p0 += kLongStage) {
          // warp w loads the stage's share [w*kLongSub, (w+1)*kLongSub)
          const int base = p0 + warp * kLongSub;
          int rk[kSubPerLane];
          float v[kSubPerLane];
          {
            int pos[kSubPerLane];
            float a[kSubPerLane];
#pragma unroll
            for (int i = 0; i < kSubPerLane; ++i) {
              const int p = base + i * 32 + lane;
              const int s = find_slot(sh.off, p < total ? p : 0);
              pos[i] = sh.start[s] + (p - sh.off[s]);
              a[i] = sh.av[s];
            }
            int col[kSubPerLane];
            float bv[kSubPerLane];
#pragma unroll
            for (int i = 0; i < kSubPerLane; ++i) {
              const bool in = base + i * 32 + lane < total;
              col[i] = in ? b_cols[pos[i]] : -1;
              bv[i] = in ? b_vals[pos[i]] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < kSubPerLane; ++i) {
              rk[i] = rank_of(col[i], seg_lo, seg_n, bits, rank16, cap);
              v[i] = a[i] * bv[i];
            }
          }
          // stable counting sort of the share by rank bucket (rk mod
          // kBuckets; rk < 0 dropped): each bucket keeps enumeration order
          int* bucket = sh.bucket[warp];
          if (lane <= kBuckets) bucket[lane] = 0;
          __syncwarp();
          int dst[kSubPerLane];
#pragma unroll
          for (int i = 0; i < kSubPerLane; ++i) {
            const int bk = rk[i] >= 0 ? (rk[i] & (kBuckets - 1)) : kBuckets;
            const unsigned peers = __match_any_sync(kFull, bk);
            const int before = bucket[bk];
            __syncwarp();
            if ((peers & below) == 0) bucket[bk] = before + __popc(peers);
            __syncwarp();
            dst[i] = before + __popc(peers & below);
          }
          const int c = lane < kBuckets ? bucket[lane] : 0;
          const int incl = warp_incl_scan(c, lane);
          __syncwarp();
          if (lane < kBuckets) bucket[lane] = incl - c;
          if (lane == kBuckets - 1) bucket[kBuckets] = incl;
          __syncwarp();
          int* srk = s_rank + warp * kLongSub;
          float* sv = s_val + warp * kLongSub;
#pragma unroll
          for (int i = 0; i < kSubPerLane; ++i) {
            if (rk[i] >= 0) {
              const int d = bucket[rk[i] & (kBuckets - 1)] + dst[i];
              srk[d] = rk[i];
              sv[d] = v[i];
            }
          }
          __syncthreads();
          // warp b adds bucket b: the warps' shares in order, each share's
          // bucket in its order, 32 at a time
          for (int w = 0; w < kLongWarps; ++w) {
            const int b_lo = sh.bucket[w][warp], b_hi = sh.bucket[w][warp + 1];
            const int* wrk = s_rank + w * kLongSub;
            const float* wv = s_val + w * kLongSub;
            for (int b0 = b_lo; b0 < b_hi; b0 += 32) {
              const int rk = b0 + lane < b_hi ? wrk[b0 + lane] : -1;
              add_in_order(s_acc, rk, __match_any_sync(kFull, rk), wv + b0,
                           below);
              __syncwarp();
            }
          }
          __syncthreads();  // the stage is free before the next one fills
        }
      }
    }
    done += seg_cnt;
    __syncthreads();  // bits and ranks are free before the next segment
  }

  const int kept = min(done, cap);
  for (int j = tid; j < cap; j += kLongThreads) {
    vals_out[obase + j] = s_acc[j];
    if (j >= kept) cols_out[obase + j] = kPadCol;
  }
  if (tid == 0) nnz_out[r] = done;
}

// Dynamic shared memory of the long-row kernel for a segment of seg_words
// 64-column words.
size_t longrow_smem(int seg_words, int cap) {
  return (size_t)seg_words * (8 + 2) + (size_t)((cap + 3) & ~3) * 4 +
         (size_t)kLongStage * 8;
}

// The most warp-aligned 64-column words one segment of the long-row kernel
// holds at this cap on the current device (<= 0 when none fit).
cudaError_t longrow_fit_words(int cap, int64_t* words) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, longrow_slab_kernel);
  if (err != cudaSuccess) return err;
  const int64_t room = (int64_t)optin - (int64_t)attr.sharedSizeBytes -
                       (int64_t)longrow_smem(0, cap);
  *words = room / 10 / kWordAlign * kWordAlign;
  return cudaSuccess;
}

}  // namespace

// The largest cap (a multiple of 4, at most 65535; 0 when none) at which one
// segment of the long-row kernel holds `width` columns on the current device:
// longrow_smem of that segment and the cap, and the static shared memory,
// within the opt-in limit. Up to 32,768 columns (one smallest segment) it is
// the largest cap the kernel launches at all.
extern "C" int ocean_longrow_max_cap(int width, int* cap) {
  *cap = 0;
  if (width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, longrow_slab_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t words = ((int64_t)(width + 63) / 64 + kWordAlign - 1) /
                        kWordAlign * kWordAlign;
  // the cap's slots take ((cap + 3) & ~3) * 4 bytes of what is left
  const int64_t room = (int64_t)optin - (int64_t)attr.sharedSizeBytes -
                       (int64_t)longrow_smem((int)words, 0);
  *cap = (int)std::min<int64_t>(65535, std::max<int64_t>(0, room / 4 & ~3));
  return 0;
}

extern "C" int ocean_dense_slab(const void* a_rows, const void* a_vals,
                                const void* a_starts, const void* a_lens,
                                const void* row_lo, const void* b_cols,
                                const void* b_vals, void* cols, void* vals,
                                void* nnz, int R, int E, int window,
                                int col_tiles, int cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0) return 0;
  if (cap <= 0 || cap > 65535 || window <= 0 || col_tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ar = static_cast<const int*>(a_rows);
  const float* av = static_cast<const float*>(a_vals);
  const int* as = static_cast<const int*>(a_starts);
  const int* al = static_cast<const int*>(a_lens);
  const int* lo = static_cast<const int*>(row_lo);
  const int* bc = static_cast<const int*>(b_cols);
  const float* bv = static_cast<const float*>(b_vals);
  int* co = static_cast<int*>(cols);
  float* vo = static_cast<float*>(vals);
  int* no = static_cast<int*>(nnz);

  if (col_tiles == 1) {
    if (window > 4096) return static_cast<int>(cudaErrorInvalidValue);
    const int wb = window_warp_bytes(window);
    const int rows =
        std::max(1, std::min(kRowsPerBlockMax, kWindowSmemTarget / wb));
    const unsigned blocks = (unsigned)((R + rows - 1) / rows);
    window_slab_kernel<<<blocks, rows * 32, (size_t)rows * wb, s>>>(
        ar, av, as, al, lo, bc, bv, co, vo, no, R, E, window, cap);
    return static_cast<int>(cudaGetLastError());
  }

  // long-row: the widest warp-aligned segment the shared memory holds
  const int64_t width = (int64_t)window * col_tiles;
  if (width > (int64_t)1 << 30) return static_cast<int>(cudaErrorInvalidValue);
  int64_t fit = 0;
  cudaError_t err = longrow_fit_words(cap, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < kWordAlign) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t need = ((width + 63) / 64 + kWordAlign - 1) / kWordAlign *
                       kWordAlign;
  const int seg_words = (int)(need < fit ? need : fit);
  const size_t smem = longrow_smem(seg_words, cap);
  err = cudaFuncSetAttribute(longrow_slab_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  longrow_slab_kernel<<<R, kLongThreads, smem, s>>>(
      ar, av, as, al, lo, bc, bv, co, vo, no, E, (int)width, seg_words, cap);
  return static_cast<int>(cudaGetLastError());
}
