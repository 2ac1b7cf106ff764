// Fingerprint of two sparsity patterns, the plan cache's key (Hopper, sm_90a).
//
// Replaces no TPU kernel: the reference keys its plan cache with blake2b over
// both patterns on the host (src/repro/core/planner.py:304 `structure_key`).
// Added so that a plan-cache replay copies no pattern to the host: one
// launch reads A's indptr and indices[:nnz] and B's, and 16 bytes come back.
//
// The fingerprint: the element at position p of array t (0..3), its value v
// widened to 64 bits with its sign, adds fmix64(v ^ fmix64(p + kSalt[t][k]))
// to lane k (0, 1), mod 2^64; fmix64 is MurmurHash3's finaliser. Every
// element of the four arrays is read, each once. Integer addition commutes,
// so the lanes come out the same bits whatever order the blocks finish in,
// and equal the plain version's (kernels/pattern_fingerprint.py).
//
// Bound on this card: the integer pipes, not the bytes. An element costs
// four finalisers, each two 64-bit multiplies (three 32-bit multiply-adds
// each) and three xor-shifts by 33 (a shift and an xor of the low word: the
// high word keeps its bits), about 60 integer instructions for the 4 or 8
// bytes it brings. MurmurHash3's shift of 33 rather than splitmix64's 30,
// 27 and 31 is what keeps the xor-shifts to one 32-bit word.
//
// Design: the wrapper sizes the grid to a few blocks an SM; each thread walks
// the four arrays in turn with a grid stride, by 16-byte loads (4 int32 or 2
// int64 elements). The elements before an array's first 16-byte boundary
// and after its last are taken one a thread. A thread sums its terms in two
// 64-bit registers; warp shuffles and one shared-memory pass reduce a block,
// whose thread 0 adds the block's two sums to `out` by 64-bit atomicAdd.
// The entry zeroes `out` on the stream before the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kArrays = 4;   // A.indptr, A.indices, B.indptr, B.indices
constexpr int kLanes = 2;

// one salt an array and lane: the first hex digits of pi's fraction
__constant__ u64 kSalt[kArrays][kLanes] = {
    {0x243f6a8885a308d3ULL, 0x13198a2e03707344ULL},
    {0xa4093822299f31d0ULL, 0x082efa98ec4e6c89ULL},
    {0x452821e638d01377ULL, 0xbe5466cf34e90c6cULL},
    {0xc0ac29b7c97c50ddULL, 0x3f84d5b5b5470917ULL}};

struct Arrays {
  const void* ptr[kArrays];
  long long n[kArrays];
  int width[kArrays];  // bytes an element: 4 or 8
};

__device__ __forceinline__ u64 fmix64(u64 z) {
  z = (z ^ (z >> 33)) * 0xff51afd7ed558ccdULL;
  z = (z ^ (z >> 33)) * 0xc4ceb9fe1a85ec53ULL;
  return z ^ (z >> 33);
}

__device__ __forceinline__ void add_terms(long long v, u64 p, u64 salt0,
                                          u64 salt1, u64& s0, u64& s1) {
  const u64 u = static_cast<u64>(v);
  s0 += fmix64(u ^ fmix64(p + salt0));
  s1 += fmix64(u ^ fmix64(p + salt1));
}

// Element j of a 16-byte word of T, widened with its sign.
template <typename T>
__device__ __forceinline__ long long element(const uint4& w, int j) {
  if constexpr (sizeof(T) == 4) {
    const unsigned x = j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
    return static_cast<int>(x);
  } else {
    const u64 x = j == 0 ? (static_cast<u64>(w.y) << 32) | w.x
                         : (static_cast<u64>(w.w) << 32) | w.z;
    return static_cast<long long>(x);
  }
}

// This thread's terms of one array of n elements.
template <typename T>
__device__ __forceinline__ void fold(const T* __restrict__ x, long long n,
                                     u64 salt0, u64 salt1, long long tid,
                                     long long stride, u64& s0, u64& s1) {
  constexpr int kPer = 16 / sizeof(T);
  long long head = static_cast<long long>(
      ((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  const long long words = (n - head) / kPer;
  const long long tail = head + words * kPer;
  if (tid < head) {
    add_terms(x[tid], static_cast<u64>(tid), salt0, salt1, s0, s1);
  } else if (tid - head < n - tail) {
    const long long p = tail + (tid - head);
    add_terms(x[p], static_cast<u64>(p), salt0, salt1, s0, s1);
  }
  const uint4* w = reinterpret_cast<const uint4*>(x + head);
  for (long long i = tid; i < words; i += stride) {
    const uint4 q = __ldg(w + i);
    const u64 p = static_cast<u64>(head + i * kPer);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      add_terms(element<T>(q, j), p + j, salt0, salt1, s0, s1);
  }
}

__global__ void __launch_bounds__(kThreads)
pattern_fingerprint_kernel(Arrays arrays, u64* __restrict__ out) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  u64 s0 = 0, s1 = 0;
#pragma unroll
  for (int t = 0; t < kArrays; ++t) {
    if (arrays.width[t] == 4)
      fold(static_cast<const int*>(arrays.ptr[t]), arrays.n[t], kSalt[t][0],
           kSalt[t][1], tid, stride, s0, s1);
    else
      fold(static_cast<const long long*>(arrays.ptr[t]), arrays.n[t],
           kSalt[t][0], kSalt[t][1], tid, stride, s0, s1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, o);
    s1 += __shfl_down_sync(0xffffffffu, s1, o);
  }
  constexpr int kWarps = kThreads / 32;
  __shared__ u64 part[kLanes][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = s0;
    part[1][warp] = s1;
  }
  __syncthreads();
  if (warp != 0) return;
  s0 = lane < kWarps ? part[0][lane] : 0;
  s1 = lane < kWarps ? part[1][lane] : 0;
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, o);
    s1 += __shfl_down_sync(0xffffffffu, s1, o);
  }
  if (lane == 0) {
    atomicAdd(out, s0);
    atomicAdd(out + 1, s1);
  }
}

}  // namespace

// The two lanes of A's and B's patterns into out (2,) 64-bit, zeroed here
// first. Array t: ptr_t, n_t elements of width_t bytes (4 or 8; ignored when
// n_t is 0), contiguous. blocks: the grid, at least 1.
extern "C" int ocean_pattern_fingerprint(
    const void* ptr0, long long n0, int width0, const void* ptr1,
    long long n1, int width1, const void* ptr2, long long n2, int width2,
    const void* ptr3, long long n3, int width3, void* out, int blocks,
    void* stream) {
  const Arrays arrays = {{ptr0, ptr1, ptr2, ptr3},
                         {n0, n1, n2, n3},
                         {width0, width1, width2, width3}};
  for (int t = 0; t < kArrays; ++t)
    if (arrays.n[t] < 0 ||
        (arrays.n[t] > 0 && arrays.width[t] != 4 && arrays.width[t] != 8))
      return static_cast<int>(cudaErrorInvalidValue);
  if (blocks <= 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(out, 0, kLanes * sizeof(u64), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  pattern_fingerprint_kernel<<<blocks, kThreads, 0, s>>>(
      arrays, static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}
