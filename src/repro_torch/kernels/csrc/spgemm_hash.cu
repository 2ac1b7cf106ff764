// Hash-table SpGEMM accumulator for one bin of output rows, writing each
// row's column-sorted slab (Hopper, sm_90a).
//
// Replaces: src/repro/kernels/spgemm_hash.py:170 `spgemm_hash_bin`
//           (Pallas bodies `_hash_kernel` :97 and `_probe_insert` :64)
//           together with its XLA epilogue `extract_hash_rows`
//           (src/repro/kernels/ops.py:197): the reference's `hash_bin_op`
//           (ops.py:283).
//
// Computes, for each row r of a bin: its products a[r,e] * b[k,j] inserted
// into an open-addressing table of `table` slots (key = column, -1 empty;
// f32 value) from the Fibonacci hash h = (u32(col) * 2654435769) >> (32 - p),
// summing on a hit (the reference probes linearly; here the probe sequence
// is triangular, which moves slots only: the slab is sorted). A product
// whose column finds no slot in the full primary table goes to a spill
// table of `spill` slots (the same hash at the spill's p); when both are
// full it counts as a failed insert.
// Each column's sum is taken in product-enumeration order (A slot major, B
// position minor). Per row it writes nnz[r] = occupied slots + failed
// inserts (the distinct count when the row fits; above table + spill iff the
// row overflowed), and the slab: cols[r, :] the occupied columns in column
// order, PAD_COL past them; vals[r, :] their sums, 0 past them.
//
// Bound on this card: bytes. The ELL inputs (a_rows whole, the other three
// at live slots), the B rows the bin references, and the slab,
// R*((table + spill)*8 + 4) bytes. No (R, table) key/value table reaches
// device memory: the primary lives in shared memory, and a row touches its
// spill only after its primary has refused an insert.
//
// Design:
// - A group of G lanes per row (G = 8, 16 or 32 by the table's size, so a
//   t32 row's few products do not idle a warp), several rows per block
//   (`launch_shape` in kernels/spgemm_hash.py picks G, the rows and the
//   shared memory: the count of rows that lets an SM hold the most).
//   Control flow is warp-uniform (loop counts are maxima over the warp's
//   groups), so every warp collective takes the full mask and no block
//   barrier is needed.
// - The group loads the metadata of 4*G A slots at once (a lane one slot
//   of each chunk of G), then takes the chunks in turn: a group scan of the
//   lengths lays a chunk's products out, and each lane loads kUnroll
//   products at once (its slot found by a shuffle search).
// - Keys first: a lane's kUnroll products probe together (atomicCAS on the
//   key; triangular probing, so runs stay shorter than linear probing's
//   clusters). Keys never change once set, so products of one column meet
//   in one slot whatever the order. Then values, round by round in
//   enumeration order (round u holds the batch's products u*G .. u*G+G-1):
//   the lanes of a round on one slot (__match_any_sync) hand their values
//   to the lowest, which adds them in lane order, and __syncwarp separates
//   rounds. So each column's sum keeps enumeration order with no float
//   atomics, also when a B row holds a column twice.
// - The spill is the paper's global-memory overflow region, in scratch the
//   wrapper allocates. A group initialises it the first time its primary
//   refuses an insert (a warp ballot), and only then reads it.
// - The slab: the occupied primary slots are compacted in place to the
//   front by ballot/popc ranks, padded with empty keys (0xffffffff as
//   unsigned, so they sort last) to a power of two, and sorted by a bitonic
//   sort whose stages up to G, and partners below G, run in registers by
//   shuffles; from kSplitMin entries on, as two runs (the largest power of
//   two and the rest), which halves the sort's work at worst. A spilled
//   row sorts its spill the same way, in global memory. Each entry's place in
//   the slab is its index in its run plus the number of the other runs'
//   keys below it (binary searches), so the runs merge as they are written;
//   a single run is written straight out, coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kFibMult = 2654435769u;
constexpr int kPadCol = 0x7fffffff;  // core.formats.PAD_COL
constexpr int kUnroll = 4;           // products a lane loads at once
constexpr int kMaxThreads = 256;     // kernels/spgemm_hash.py MAX_BLOCK_THREADS
constexpr int kSplitMin = 512;       // occupied slots sorted as two runs

// A table slot: the key in the low word (-1 = empty), the value's bits in
// the high word. Empty slots hold key -1 and value +0.0f.
typedef unsigned long long Slot;
constexpr Slot kEmpty = 0x00000000ffffffffull;

__device__ __forceinline__ unsigned key_u(Slot s) { return (unsigned)s; }
__device__ __forceinline__ float val_of(Slot s) {
  return __uint_as_float((unsigned)(s >> 32));
}
__device__ __forceinline__ volatile int* key_ptr(volatile Slot* t, int s) {
  return reinterpret_cast<volatile int*>(t + s);
}
__device__ __forceinline__ volatile float* val_ptr(volatile Slot* t, int s) {
  return reinterpret_cast<volatile float*>(t + s) + 1;
}

__device__ __forceinline__ int log2_pow2(int size) { return 31 - __clz(size); }

__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? n : 1 << (32 - __clz(n - 1));
}

// The slots of a lane's kUnroll columns in a pow2 table (-1 in col: none),
// each inserted at its first empty slot in probe order (the slot layout is
// free: the slab is sorted); loc[u] = -1 when
// the table is full and does not hold col[u] (or there is none). The
// probes step together, so their loads are in flight at once. Keys never
// change once set, so lanes (or one lane's products) inserting one column
// meet in one slot. Works on shared or global memory (generic addressing,
// volatile: a global table is read past L1, where atomicCAS writes).
__device__ void probe_batch(volatile Slot* t, int size,
                            const int (&col)[kUnroll], int (&loc)[kUnroll]) {
  const int shift = 32 - log2_pow2(size);
  unsigned h[kUnroll];
  unsigned pending = 0u;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    loc[u] = -1;
    h[u] = ((unsigned)col[u] * kFibMult) >> shift;
    if (col[u] >= 0) pending |= 1u << u;
  }
  // triangular probing, h + d(d+1)/2: every slot of a pow2 table in `size`
  // steps, with shorter runs than linear probing's clusters
  unsigned off = 0u;
  for (int d = 0; pending && d < size; off += ++d) {
    int cur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (pending >> u & 1u) cur[u] = *key_ptr(t, (h[u] + off) & (size - 1));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!(pending >> u & 1u)) continue;
      const int s = (int)((h[u] + off) & (unsigned)(size - 1));
      if (cur[u] == -1)
        cur[u] = atomicCAS(const_cast<int*>(key_ptr(t, s)), -1, col[u]);
      if (cur[u] == -1 || cur[u] == col[u]) {
        loc[u] = s;
        pending &= ~(1u << u);
      }
    }
  }
}

// Number of keys below `key` in the first n slots of a sorted table.
template <typename T>
__device__ int lower_bound(T* t, int n, unsigned key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_u(t[mid]) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// x[c] for a c known only at run time, by selects (no local memory).
template <typename V>
__device__ __forceinline__ V pick(const V (&x)[kUnroll], int c) {
  V v = x[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u)
    if (c == u) v = x[u];
  return v;
}

template <int G>
__device__ __forceinline__ unsigned group_ballot(bool pred, int gbase) {
  const unsigned bits = __ballot_sync(kFull, pred) >> gbase;
  return G == 32 ? bits : bits & ((1u << G) - 1u);
}

template <int G>
__device__ __forceinline__ int group_incl_scan(int x, int gl) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d, G);
    if (gl >= d) x += y;
  }
  return x;
}

template <int G>
__device__ __forceinline__ int group_sum(int x) {
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d, G);
  return x;
}

// The last of the group's G slots whose exclusive product offset is <= p.
template <int G>
__device__ __forceinline__ int group_slot_of(int excl, int p) {
  int j = 0;
#pragma unroll
  for (int step = G / 2; step > 0; step >>= 1) {
    const int v = __shfl_sync(kFull, excl, j + step, G);
    if (v <= p) j += step;
  }
  return j;
}

// Moves the occupied slots of t[0, size) to its front, in slot order, and
// pads them with empty slots to the next power of two; returns how many are
// occupied (the same in every lane of the group). `use` false: the group's
// table is not read and counts 0. kUnroll chunks of G slots are read before
// any is written (every write lands below the last slot read).
template <int G, typename T>
__device__ int compact(T* t, int size, bool use, int gl, int gbase) {
  const unsigned below = (1u << gl) - 1u;
  int occ = 0;
  for (int c0 = 0; c0 < size; c0 += kUnroll * G) {
    Slot s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = kEmpty;
      if (use && c0 + u * G < size) s[u] = t[c0 + u * G + gl];
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool here = key_u(s[u]) != 0xffffffffu;
      const unsigned bits = group_ballot<G>(here, gbase);
      if (here) t[occ + __popc(bits & below)] = s[u];
      occ += __popc(bits);
    }
    __syncwarp();
  }
  const int n = pow2_at_least(occ);
  for (int j = occ + gl; j < n; j += G) t[j] = kEmpty;
  __syncwarp();
  return occ;
}

// Bitonic stages k0 .. k1 (doubling) of a sort of t[0, n), each over its
// partners j < G, which lie in the lane's group: every chunk of G slots in
// registers, compare-exchanged by shuffles (kUnroll chunks at once). Slots
// at and past n read as empty (key 0xffffffff, sorting last) and are not
// written.
template <int G, typename T>
__device__ void sort_in_lanes(T* t, int n, int chunks, int k0, int k1,
                              int gl) {
  for (int c0 = 0; c0 < chunks; c0 += kUnroll) {
    Slot x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = (c0 + u) * G + gl;
      x[u] = kEmpty;
      if (c0 + u < chunks && i < n) x[u] = t[i];
    }
    for (int k = k0; k <= k1; k <<= 1) {
      for (int j = min(k >> 1, G >> 1); j > 0; j >>= 1) {
        const bool lower = (gl & j) == 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const Slot y = __shfl_xor_sync(kFull, x[u], j, G);
          const bool up = (((c0 + u) * G + gl) & k) == 0;
          // the lower slot keeps the smaller key when ascending
          if ((key_u(x[u]) <= key_u(y)) != (lower == up)) x[u] = y;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = (c0 + u) * G + gl;
      if (c0 + u < chunks && i < n) t[i] = x[u];
    }
  }
}

// Bitonic sort of t[0, n) by key (unsigned), n 0 or a power of two. Stages
// up to G, and the partners j < G of every later stage, run in registers
// (sort_in_lanes); only the partners j >= G take a pass over shared (or
// global) memory, where a lane loads kUnroll pairs before it compares and
// stores any (the pairs of one pass are disjoint). Loop counts are the
// warp's largest, so the shuffles stay warp-uniform.
template <int G, typename T>
__device__ void bitonic_sort(T* t, int n, int gl) {
  const int len = n <= 1 ? 0 : max(n, G);  // padded with empties to G
  const int most = __reduce_max_sync(kFull, len);
  if (most == 0) return;
  const int chunks = most / G;
  sort_in_lanes<G>(t, n, chunks, 2, G, gl);
  __syncwarp();
  for (int k = 2 * G; k <= most; k <<= 1) {
    for (int j = k >> 1; j >= G; j >>= 1) {
      if (k <= n) {
        const int half = n >> 1;
        for (int q0 = gl; q0 < half; q0 += kUnroll * G) {
          Slot x[kUnroll], y[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int q = q0 + u * G;
            const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
            if (q < half) {
              x[u] = t[i];
              y[u] = t[i | j];
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int q = q0 + u * G;
            const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
            if (q < half &&
                (key_u(x[u]) > key_u(y[u])) == ((i & k) == 0)) {
              t[i] = y[u];
              t[i | j] = x[u];
            }
          }
        }
      }
      __syncwarp();
    }
    sort_in_lanes<G>(t, n, chunks, k, k, gl);
    __syncwarp();
  }
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
hash_slab_kernel(const int* __restrict__ a_rows,
                 const float* __restrict__ a_vals,
                 const int* __restrict__ a_starts,
                 const int* __restrict__ a_lens,
                 const int* __restrict__ b_cols,
                 const float* __restrict__ b_vals, Slot* spill_scratch,
                 int* __restrict__ cols_out, float* __restrict__ vals_out,
                 int* __restrict__ nnz_out, int R, int E, int table,
                 int spill) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr unsigned kGroupMask = G == 32 ? kFull : (1u << G) - 1u;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // lane in the row's group
  const int gbase = lane - gl;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int rows_per_block = blockDim.x / G;
  const int local = threadIdx.x / G;  // the row's index in the block
  const int64_t r = (int64_t)blockIdx.x * rows_per_block + local;
  if ((int64_t)blockIdx.x * rows_per_block + (threadIdx.x & ~31) / G >= R)
    return;  // the warp holds no row (the warp is the unit: no barrier)
  const bool live = r < R;
  // the primary in shared memory; the spill in global memory, read volatile
  // (past L1, where atomicCAS writes)
  Slot* prim = reinterpret_cast<Slot*>(smem) + (size_t)local * table;
  volatile Slot* spl = spill_scratch + (live ? r : 0) * (int64_t)spill;

  for (int j = gl; j < table; j += G) prim[j] = kEmpty;
  __syncwarp();

  bool spill_on = false;  // the same in every lane of the group
  int fail = 0;           // this lane's failed inserts
  const int64_t ebase = r * E;
  for (int e00 = 0; e00 < E; e00 += kUnroll * G) {
    // the metadata of kUnroll chunks of G slots, loaded together
    int ar[kUnroll], lens[kUnroll], starts[kUnroll];
    float avs[kUnroll];
#pragma unroll
    for (int c = 0; c < kUnroll; ++c) {
      const int e = e00 + c * G + gl;
      ar[c] = live && e < E ? a_rows[ebase + e] : -1;
    }
#pragma unroll
    for (int c = 0; c < kUnroll; ++c) {
      const int e = e00 + c * G + gl;
      lens[c] = starts[c] = 0;
      avs[c] = 0.f;
      if (ar[c] >= 0) {
        lens[c] = a_lens[ebase + e];
        starts[c] = a_starts[ebase + e];
        avs[c] = a_vals[ebase + e];
      }
    }
#pragma unroll 1
    for (int c = 0; c < kUnroll; ++c) {
      const int len = pick(lens, c), start = pick(starts, c);
      const float av = pick(avs, c);
      if (__ballot_sync(kFull, len > 0) == 0) continue;
      const int incl = group_incl_scan<G>(len, gl);
      const int excl = incl - len;
      const int total = __shfl_sync(kFull, incl, G - 1, G);
      const int most = __reduce_max_sync(kFull, total);

      for (int p0 = 0; p0 < most; p0 += G * kUnroll) {
        // load kUnroll products a lane (every lane runs every step: the slot
        // search shuffles)
        int pos[kUnroll];
        float as[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = p0 + u * G + gl;
          const int j = group_slot_of<G>(excl, p);
          pos[u] = __shfl_sync(kFull, start, j, G) + p -
                   __shfl_sync(kFull, excl, j, G);
          as[u] = __shfl_sync(kFull, av, j, G);
        }
        int col[kUnroll];
        float bv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          col[u] = -1;
          bv[u] = 0.f;
          if (p0 + u * G + gl < total) {
            col[u] = b_cols[pos[u]];
            bv[u] = b_vals[pos[u]];
          }
        }
        // keys: the lane's products probe together (order-free)
        int loc[kUnroll];  // primary slot, table + spill slot, or -1
        probe_batch(prim, table, col, loc);
        bool refused = false;
        int scol[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          scol[u] = col[u] >= 0 && loc[u] < 0 ? col[u] : -1;
          refused |= scol[u] >= 0;
        }
        const unsigned want = __ballot_sync(kFull, refused);
        if (want) {
          // the primary refused: a group opens its spill the first time
          const bool grp = (want >> gbase) & kGroupMask;
          if (grp && !spill_on) {
            for (int j = gl; j < spill; j += G) spl[j] = kEmpty;
            spill_on = true;
          }
          __syncwarp();
          int sloc[kUnroll];
          probe_batch(spl, spill, scol, sloc);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (scol[u] < 0) continue;
            if (sloc[u] < 0) ++fail;
            else loc[u] = table + sloc[u];
          }
        }
        // values: round u holds the batch's products u*G .. u*G + G - 1, in
        // enumeration order; the round's lanes on one slot hand their values
        // to the lowest, which adds them in lane order (= enumeration order)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p0 + u * G >= most) break;  // the same in every lane
          // a product rounded on its own, as the plain version's (no FMA)
          const float v = __fmul_rn(as[u], bv[u]);
          const int key = loc[u] < 0 ? -1 : local * (table + spill) + loc[u];
          const unsigned peers = __match_any_sync(kFull, key);
          const bool leader = loc[u] >= 0 && (peers & lanes_below) == 0;
          unsigned rest = leader ? peers & ~(1u << lane) : 0u;
          volatile float* dst =
              loc[u] < 0 ? nullptr
                         : (loc[u] < table ? val_ptr(prim, loc[u])
                                           : val_ptr(spl, loc[u] - table));
          float sum = leader ? *dst + v : 0.f;
          while (__any_sync(kFull, rest != 0)) {
            const int src = rest ? __ffs(rest) - 1 : lane;
            const float w = __shfl_sync(kFull, v, src);
            if (rest) {
              sum += w;
              rest &= rest - 1u;
            }
          }
          if (leader) *dst = sum;
          __syncwarp();  // the round is written before the next one reads
        }
      }
    }
  }

  // the slab: the primary's occupied slots compacted and sorted, from
  // kSplitMin of them up as two runs, [0, big) with big the largest power
  // of two <= occ and the rest (padded to a power of two: at most half the
  // work of one sort over pow2(occ)); the spill's likewise as a third run;
  // the runs merge as written
  const int occ = compact<G>(prim, table, true, gl, gbase);
  const bool split = occ >= kSplitMin;
  const int big = split ? 1 << (31 - __clz(occ)) : pow2_at_least(occ);
  const int rest = split ? occ - big : 0;
  bitonic_sort<G>(prim, big, gl);
  bitonic_sort<G>(prim + big, pow2_at_least(rest), gl);
  int occ_s = 0;
  if (__any_sync(kFull, spill_on)) {
    occ_s = compact<G>(spl, spill, spill_on, gl, gbase);
    bitonic_sort<G>(spl, pow2_at_least(occ_s), gl);
  }
  fail = group_sum<G>(fail);
  if (!live) return;
  const int width = table + spill;
  int* cols = cols_out + r * width;
  float* vals = vals_out + r * width;
  // an entry's place: its index in its run plus the keys below it in the
  // other runs
  for (int i = gl; i < min(occ, big); i += G) {
    const Slot s = prim[i];
    const unsigned key = key_u(s);
    const int at = i + lower_bound(prim + big, rest, key) +
                   (occ_s ? lower_bound(spl, occ_s, key) : 0);
    cols[at] = (int)key;
    vals[at] = val_of(s);
  }
  for (int i = big + gl; i < occ; i += G) {
    const Slot s = prim[i];
    const unsigned key = key_u(s);
    const int at = i - big + lower_bound(prim, big, key) +
                   (occ_s ? lower_bound(spl, occ_s, key) : 0);
    cols[at] = (int)key;
    vals[at] = val_of(s);
  }
  for (int i = gl; i < occ_s; i += G) {
    const Slot s = spl[i];
    const unsigned key = key_u(s);
    const int at = i + lower_bound(prim, big, key) +
                   lower_bound(prim + big, rest, key);
    cols[at] = (int)key;
    vals[at] = val_of(s);
  }
  for (int j = occ + occ_s + gl; j < width; j += G) {
    cols[j] = kPadCol;
    vals[j] = 0.f;
  }
  if (gl == 0) nnz_out[r] = occ + occ_s + fail;
}

template <int G>
cudaError_t launch(const int* ar, const float* av, const int* as,
                   const int* al, const int* bc, const float* bv, Slot* sc,
                   int* co, float* vo, int* no, int R, int E, int table,
                   int spill, int rows, cudaStream_t s) {
  const size_t smem = (size_t)rows * table * sizeof(Slot);
  auto kernel = hash_slab_kernel<G>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((R + rows - 1) / rows);
  kernel<<<blocks, rows * G, smem, s>>>(ar, av, as, al, bc, bv, sc, co, vo,
                                        no, R, E, table, spill);
  return cudaGetLastError();
}

// Blocks of `rows` rows of G lanes, with `smem` bytes of shared memory, that
// one SM of the current device holds at once (the occupancy API, which counts
// the kernel's registers as built); 0 when such a block cannot launch.
template <int G>
cudaError_t blocks_per_sm(int rows, int smem, int* blocks) {
  *blocks = 0;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess || smem > optin || rows * G > kMaxThreads)
    return err;
  auto kernel = hash_slab_kernel<G>;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       rows * G, smem);
}

bool pow2_in(int x, int lo, int hi) {
  return x >= lo && x <= hi && (x & (x - 1)) == 0;
}

}  // namespace

// One hash bin into slabs. `lanes` (8, 16 or 32) lanes a row and `rows`
// rows a block, as kernels/spgemm_hash.py `launch_shape` gives them;
// `spill_scratch` holds R * spill slots of 8 bytes (read only where used).
extern "C" int ocean_hash_slab(const void* a_rows, const void* a_vals,
                               const void* a_starts, const void* a_lens,
                               const void* b_cols, const void* b_vals,
                               void* spill_scratch, void* cols, void* vals,
                               void* nnz, int R, int E, int table, int spill,
                               int lanes, int rows, void* stream) {
  if (R <= 0) return 0;
  if (!pow2_in(table, 16, 4096) || !pow2_in(spill, 16, 4096) ||
      (lanes != 8 && lanes != 16 && lanes != 32) || table % lanes ||
      spill % lanes || rows <= 0 || rows * lanes % 32 ||
      rows * lanes > kMaxThreads || E < 0 || spill_scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ar = static_cast<const int*>(a_rows);
  const float* av = static_cast<const float*>(a_vals);
  const int* as = static_cast<const int*>(a_starts);
  const int* al = static_cast<const int*>(a_lens);
  const int* bc = static_cast<const int*>(b_cols);
  const float* bv = static_cast<const float*>(b_vals);
  Slot* sc = static_cast<Slot*>(spill_scratch);
  int* co = static_cast<int*>(cols);
  float* vo = static_cast<float*>(vals);
  int* no = static_cast<int*>(nnz);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OCEAN_HASH_LAUNCH(G)                                            \
  return static_cast<int>(launch<G>(ar, av, as, al, bc, bv, sc, co, vo, \
                                    no, R, E, table, spill, rows, s))
  if (lanes == 8) OCEAN_HASH_LAUNCH(8);
  if (lanes == 16) OCEAN_HASH_LAUNCH(16);
  OCEAN_HASH_LAUNCH(32);
#undef OCEAN_HASH_LAUNCH
}

// Blocks of `rows` rows of `lanes` lanes with `smem` bytes of shared memory
// that one SM of the current device holds at once, into *blocks (0: such a
// block cannot launch); kernels/spgemm_hash.py `launch_shape` picks the
// rows from it.
extern "C" int ocean_hash_blocks_per_sm(int lanes, int rows, int smem,
                                        int* blocks) {
  cudaError_t err = cudaErrorInvalidValue;
  if (lanes == 8) err = blocks_per_sm<8>(rows, smem, blocks);
  if (lanes == 16) err = blocks_per_sm<16>(rows, smem, blocks);
  if (lanes == 32) err = blocks_per_sm<32>(rows, smem, blocks);
  return static_cast<int>(err);
}
