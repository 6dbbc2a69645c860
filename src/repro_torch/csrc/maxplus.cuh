// Segmented max-plus scan building blocks shared by the scan and the
// fixpoint kernels: a grid-wide tiled scan.
//
// Every element is the affine max-plus map c -> max(c + a, b) with
// a = svc (the padding sentinel at segment heads, which drops the carry)
// and b = start + svc.  Two maps compose as
//     (a1, b1) . (a2, b2) = (a1 + a2, max(b1 + a2, b2)),
// earlier map first; the composition is associative, so a row scans in
// parallel.  Padding past a row's end is the identity map (0, sentinel).
//
// A row is cut into tiles of THREADS threads x ITEMS elements (256 x 8
// for the scan, 512 x 8 for the fixpoint), staged in shared memory as
// (a, b) pairs.  Global memory is read and written warp-striped (element
// j of lane l of warp w is 32 ITEMS w + 32 j + l, so a warp touches 32
// consecutive elements at once); the scan runs blocked (thread t owns
// elements ITEMS t .. ITEMS t + ITEMS - 1, inside its warp's 32 ITEMS, so
// the transposes need only __syncwarp).  An XOR swizzle of the slots keeps
// both patterns free of bank conflicts for 16-byte pairs.  A tile is
// scanned in two phases around one grid-wide barrier:
//   A. each thread composes its ITEMS elements, a 5-step shuffle ladder
//      scans the 32 thread totals of a warp, and the warp totals give
//      the tile's aggregate map, which the block publishes
//      (tile_aggregate);
//   B. after the barrier, tile k of a row composes the aggregates of
//      tiles 0..k-1 of its row into its carry-in value (tile_carry),
//      recomposes the thread and warp prefixes the same way, and walks
//      each thread's ITEMS elements from its carry, leaving every
//      element's value in its slot (tile_apply).
// Every association depends only on an element's position in its row,
// never on the grid or the block that ran the tile, so a row gives the
// same bits in any batch and in every call.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

template <typename T>
struct PairOf;
template <>
struct PairOf<double> { using type = double2; };
template <>
struct PairOf<float> { using type = float2; };
template <typename T>
using pair_t = typename PairOf<T>::type;

template <typename T>
__device__ __forceinline__ T tmax(T x, T y) { return x > y ? x : y; }

// (pa, pb) is the earlier map, (a, b) the current one; b folds the
// current a before a accumulates the earlier one.
template <typename T>
__device__ __forceinline__ void compose_into(T pa, T pb, T& a, T& b) {
  b = tmax(pb + a, b);
  a = pa + a;
}

// Position in its tile of this thread's warp-striped element j.
template <int ITEMS>
__device__ __forceinline__ int tile_pos(int j) {
  return (threadIdx.x >> 5) * (32 * ITEMS) + 32 * j + (threadIdx.x & 31);
}

// Shared-memory slot of tile element e: an XOR swizzle inside each
// aligned group of 8.
__device__ __forceinline__ int tile_slot(int e) { return e ^ ((e >> 3) & 7); }

// Stage this thread's warp-striped element j.
template <int ITEMS, typename T>
__device__ __forceinline__ void tile_put(pair_t<T>* tile, int j, T a, T b) {
  pair_t<T> p;
  p.x = a;
  p.y = b;
  tile[tile_slot(tile_pos<ITEMS>(j))] = p;
}

// The value tile_apply left at this thread's warp-striped element j.
template <int ITEMS, typename T>
__device__ __forceinline__ T tile_get(const pair_t<T>* tile, int j) {
  return tile[tile_slot(tile_pos<ITEMS>(j))].x;
}

// This thread's blocked elements composed in order, and that composition
// scanned over the lanes of its warp (inclusive, in (a, b)).
template <int ITEMS, typename T>
__device__ __forceinline__ void thread_scan(const pair_t<T>* tile, T& a,
                                            T& b) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int e0 = ITEMS * threadIdx.x;
  pair_t<T> p = tile[tile_slot(e0)];
  a = p.x;
  b = p.y;
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) {
    p = tile[tile_slot(e0 + i)];
    compose_into(a, b, p.x, p.y);
    a = p.x;
    b = p.y;
  }
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const T pa = __shfl_up_sync(full, a, k);
    const T pb = __shfl_up_sync(full, b, k);
    if (lane >= k) compose_into(pa, pb, a, b);
  }
}

// Phase A: the tile's aggregate map (all threads), from the staged
// elements.  sh_a / sh_b hold one entry a warp; ends with a
// __syncthreads(), so the caller may reuse them.
template <int THREADS, int ITEMS, typename T>
__device__ __forceinline__ void tile_aggregate(const pair_t<T>* tile, T& ta,
                                               T& tb, T* sh_a, T* sh_b) {
  constexpr int WARPS = THREADS / 32;
  __syncwarp();
  T a, b;
  thread_scan<ITEMS>(tile, a, b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 31) {
    sh_a[warp] = a;
    sh_b[warp] = b;
  }
  __syncthreads();
  ta = sh_a[0];
  tb = sh_b[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    T pa = sh_a[w], pb = sh_b[w];
    compose_into(ta, tb, pa, pb);
    ta = pa;
    tb = pb;
  }
  __syncthreads();
}

// Phase B: every element's value from the tile's carry-in value c,
// written over the element's a in its slot (read it with tile_get).
// Ends with a __syncthreads(), so the caller may reuse sh_a / sh_b.
template <int THREADS, int ITEMS, typename T>
__device__ __forceinline__ void tile_apply(pair_t<T>* tile, T c, T* sh_a,
                                           T* sh_b) {
  constexpr int WARPS = THREADS / 32;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncwarp();
  T a, b;
  thread_scan<ITEMS>(tile, a, b);
  if (lane == 31) {
    sh_a[warp] = a;
    sh_b[warp] = b;
  }
  // the exclusive prefix of the lanes before this one
  const T ea = __shfl_up_sync(full, a, 1);
  const T eb = __shfl_up_sync(full, b, 1);
  __syncthreads();
  // the value entering this warp's elements, then this thread's
#pragma unroll
  for (int w = 0; w < WARPS - 1; ++w)
    if (w < warp) c = tmax(c + sh_a[w], sh_b[w]);
  if (lane > 0) c = tmax(c + ea, eb);
  const int e0 = ITEMS * threadIdx.x;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    pair_t<T>& p = tile[tile_slot(e0 + i)];
    c = tmax(c + p.x, p.y);
    p.x = c;
  }
  __syncthreads();
}

// Phase B's carry-in of tile k of a row: the value c after the row's
// tiles 0..k-1, i.e. max(ninf + A, B) of the composition of their
// aggregates agg_a/agg_b[first .. first + k), starting from the sentinel
// (ninf itself for k = 0).  Thread i composes the i-th run of
// ceil(k / THREADS) aggregates, in order, and a block scan composes the
// runs: an order fixed by k (and THREADS) alone.  Aggregates written by
// other blocks before a grid barrier are read through L2 (__ldcg).
// Returns the value to every thread; sh_a / sh_b hold one entry a warp
// and sh_c one.
template <int THREADS, typename T>
__device__ __forceinline__ T tile_carry(const T* agg_a, const T* agg_b,
                                        long long first, long long k,
                                        T* sh_a, T* sh_b, T* sh_c, T ninf) {
  constexpr int WARPS = THREADS / 32;
  if (k == 0) return ninf;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long run = (k + THREADS - 1) / THREADS;
  const long long j0 = threadIdx.x * run;
  const long long j1 = j0 + run < k ? j0 + run : k;
  T A = T(0), B = ninf;
  for (long long j = j0; j < j1; j += 4) {
    T pa[4], pb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {     // four loads in flight
      pa[u] = T(0);
      pb[u] = ninf;
      if (j + u < j1) {
        pa[u] = __ldcg(agg_a + first + j + u);
        pb[u] = __ldcg(agg_b + first + j + u);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j + u < j1) {
        compose_into(A, B, pa[u], pb[u]);
        A = pa[u];
        B = pb[u];
      }
    }
  }
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const T pa = __shfl_up_sync(full, A, s);
    const T pb = __shfl_up_sync(full, B, s);
    if (lane >= s) compose_into(pa, pb, A, B);
  }
  if (lane == 31) {
    sh_a[warp] = A;
    sh_b[warp] = B;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T wa = sh_a[0], wb = sh_b[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      T pa = sh_a[w], pb = sh_b[w];
      compose_into(wa, wb, pa, pb);
      wa = pa;
      wb = pb;
    }
    *sh_c = tmax(ninf + wa, wb);
  }
  __syncthreads();
  const T c = *sh_c;
  __syncthreads();
  return c;
}

// Blocks of `threads` threads of `kernel` that fit on the card at once
// with `smem` bytes of dynamic shared memory (the cooperative launch's
// co-residency limit), and the kernel's registers a thread; the answer
// is kept for each kernel, device and size, as the query costs
// microseconds.  Above 48 KB of dynamic shared memory the kernel is
// opted into the most a block may hold, once, so that no later size is
// refused.
// Returns a CUDA error code, or cudaErrorCooperativeLaunchTooLarge when
// the card takes no cooperative launch or no block fits on an SM.
template <typename K>
static int resident_blocks(K kernel, int threads, size_t smem, int* blocks,
                           int* regs) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int blocks, regs;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : seen) {
    if (e.kernel == (const void*)kernel && e.dev == dev &&
        e.threads == threads && e.smem == smem) {
      *blocks = e.blocks;
      *regs = e.regs;
      return 0;
    }
  }
  int sms = 0, coop = 0, per_sm = 0, optin = 0;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (!err) err = (int)cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // one opt-in to the most a block may hold, so that every size fits
  if (!err && smem > 48 * 1024)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - (int)attr.sharedSizeBytes);
  if (!err) err = (int)cudaDeviceGetAttribute(&coop,
                                              cudaDevAttrCooperativeLaunch,
                                              dev);
  if (!err) err = (int)cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err) return err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  *regs = attr.numRegs;
  seen.push_back({(const void*)kernel, dev, threads, smem, *blocks, *regs});
  return 0;
}
