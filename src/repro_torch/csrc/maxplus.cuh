// Segmented max-plus scan building blocks shared by the scan and the
// fixpoint kernels.
//
// Every element is the affine max-plus map c -> max(c + a, b) with
// a = svc (the padding sentinel at segment heads, which drops the carry)
// and b = start + svc.  Two maps compose as
//     (a1, b1) . (a2, b2) = (a1 + a2, max(b1 + a2, b2)),
// earlier map first; the composition is associative, so a row scans in
// parallel.  A row is processed in chunks of blockDim.x elements, one per
// thread: a warp-shuffle inclusive scan (the same doubling ladder as the
// TPU kernels, 5 steps), then one pass over the per-warp totals in shared
// memory, then the chunk carry c = max(carry + A, B).
#pragma once

#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ T tmax(T x, T y) { return x > y ? x : y; }

// (pa, pb) is the earlier map, (a, b) the current one; b folds the
// current a before a accumulates the earlier one.
template <typename T>
__device__ __forceinline__ void compose_into(T pa, T pb, T& a, T& b) {
  b = tmax(pb + a, b);
  a = pa + a;
}

// Inclusive block-wide scan of the (a, b) pairs held one per thread.
// blockDim.x must be a multiple of 32 and at most 1024.  sh_a / sh_b hold
// 32 entries each.  Ends with every thread past its last shared-memory
// read, so the caller may reuse the arrays after one __syncthreads().
template <typename T>
__device__ __forceinline__ void block_scan(T& a, T& b, T* sh_a, T* sh_b,
                                           T ident_b) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    T pa = __shfl_up_sync(full, a, k);
    T pb = __shfl_up_sync(full, b, k);
    if (lane >= k) compose_into(pa, pb, a, b);
  }
  if (lane == 31) {
    sh_a[warp] = a;
    sh_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    T wa = lane < nwarps ? sh_a[lane] : T(0);
    T wb = lane < nwarps ? sh_b[lane] : ident_b;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      T pa = __shfl_up_sync(full, wa, k);
      T pb = __shfl_up_sync(full, wb, k);
      if (lane >= k) compose_into(pa, pb, wa, wb);
    }
    if (lane < nwarps) {
      sh_a[lane] = wa;
      sh_b[lane] = wb;
    }
  }
  __syncthreads();
  if (warp > 0) compose_into(sh_a[warp - 1], sh_b[warp - 1], a, b);
}

// Threads per block for rows of length n: one chunk of up to 1024.
static inline int scan_threads(long long n) {
  if (n >= 1024) return 1024;
  int t = (int)((n + 31) / 32) * 32;
  return t < 32 ? 32 : t;
}
