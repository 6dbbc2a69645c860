// Segmented max-plus scan over independent rows, for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/zns_event_scan.py
// (zns_event_scan: _kernel / _block_scan, and zns_event_scan_batched:
// _kernel_batched).  c_i = max(c_{i-1}, issue_i) + svc_i per row, with
// the carry dropped at segment heads; the 1-D scan is the one-row case.
//
// Bound on the card: memory.  Each element is read once (issue, svc: one
// word each; seg: one byte) and written once (out), 25 bytes in float64,
// with a handful of adds and maxes per element.  The TPU kernel walked a
// row in 1024-element blocks on a sequential grid with the carry in SMEM.
// Here every row is cut into tiles of 2,048 elements (maxplus.cuh) and
// the tiles of all rows are spread over one cooperative grid of at most
// the card's resident blocks (6 an SM: 32 KB of shared memory and at most
// 40 registers a thread): phase A stages each tile in shared memory,
// scans it and publishes its aggregate map, one grid-wide barrier, phase
// B composes the earlier tiles' aggregates of the row into the tile's
// carry-in and writes out once.  A block that owns more than one tile
// (more tiles than resident blocks) keeps its last tile staged across the
// barrier and reloads the others in phase B.  The association is fixed
// by the element's position in its row, so a row's bits do not depend on
// the batch or the call (no look-back: its order would depend on timing).
#include <cooperative_groups.h>

#include <cstdint>
#include <limits>

#include "maxplus.cuh"

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                    // elements a thread
constexpr int TILE = THREADS * ITEMS;       // 2,048 elements a tile

// Stage tile t (row t / tpr, tile t % tpr of that row) in shared memory.
template <typename T>
__device__ __forceinline__ void scan_stage(const T* __restrict__ issue,
                                           const T* __restrict__ svc,
                                           const uint8_t* __restrict__ seg,
                                           long long n, long long tpr,
                                           long long t, pair_t<T>* tile,
                                           T ninf) {
  const long long row = t / tpr;
  const long long base = row * n;
  const long long i0 = (t - row * tpr) * TILE;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = i0 + tile_pos<ITEMS>(j);
    T a = T(0), b = ninf;            // identity map past the row end
    if (i < n) {
      const T v = __ldg(svc + base + i);
      a = __ldg(seg + base + i) ? ninf : v;
      b = __ldg(issue + base + i) + v;
    }
    tile_put<ITEMS>(tile, j, a, b);
  }
}

// Phase B of the staged tile t: its carry-in, then out once.
template <typename T>
__device__ __forceinline__ void scan_finish(T* __restrict__ out, long long n,
                                            long long tpr, long long t,
                                            const T* agg_a, const T* agg_b,
                                            pair_t<T>* tile, T* sh_a,
                                            T* sh_b, T* sh_c, T ninf) {
  const long long row = t / tpr;
  const long long k = t - row * tpr;
  tile_apply<THREADS, ITEMS>(
      tile,
      tile_carry<THREADS>(agg_a, agg_b, row * tpr, k, sh_a, sh_b, sh_c, ninf),
      sh_a, sh_b);
  const long long base = row * n;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = k * TILE + tile_pos<ITEMS>(j);
    if (i < n) out[base + i] = tile_get<ITEMS, T>(tile, j);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 6)
    scan_tiles_kernel(const T* __restrict__ issue, const T* __restrict__ svc,
                      const uint8_t* __restrict__ seg, T* __restrict__ out,
                      long long n, long long tpr, long long ntiles, T* agg_a,
                      T* agg_b, T ninf) {
  __shared__ pair_t<T> tile[TILE];
  __shared__ T sh_a[THREADS / 32];
  __shared__ T sh_b[THREADS / 32];
  __shared__ T sh_c[1];
  long long held = -1;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    scan_stage(issue, svc, seg, n, tpr, t, tile, ninf);
    T ta, tb;
    tile_aggregate<THREADS, ITEMS>(tile, ta, tb, sh_a, sh_b);
    if (threadIdx.x == 0) {
      agg_a[t] = ta;
      agg_b[t] = tb;
    }
    held = t;
  }
  // rows of one tile need no carry-in; tpr is the same in every block
  if (tpr > 1) cg::this_grid().sync();
  if (held < 0) return;
  // the last tile is still staged; the block's earlier ones are reloaded
  scan_finish(out, n, tpr, held, agg_a, agg_b, tile, sh_a, sh_b, sh_c,
              ninf);
  for (long long t = blockIdx.x; t < held; t += gridDim.x) {
    __syncwarp();
    scan_stage(issue, svc, seg, n, tpr, t, tile, ninf);
    scan_finish(out, n, tpr, t, agg_a, agg_b, tile, sh_a, sh_b, sh_c, ninf);
  }
}

// agg: 2 * rows * ceil(n / TILE) elements of scratch.  info (host, 3
// ints): the grid, the resident-block capacity and the registers a thread.
template <typename T>
static int launch_rows(const void* issue, const void* svc, const void* seg,
                       void* out, void* agg, long long rows, long long n,
                       void* stream, int* info, T ninf) {
  if (rows <= 0 || n <= 0) return 0;
  auto kernel = scan_tiles_kernel<T>;
  int cap = 0, regs = 0;
  const int err = resident_blocks(kernel, THREADS, 0, &cap, &regs);
  if (err) return err;
  long long tpr = (n + TILE - 1) / TILE;
  long long ntiles = rows * tpr;
  const int grid = ntiles < cap ? (int)ntiles : cap;
  info[0] = grid;
  info[1] = cap;
  info[2] = regs;
  const T* p_issue = (const T*)issue;
  const T* p_svc = (const T*)svc;
  const uint8_t* p_seg = (const uint8_t*)seg;
  T* p_out = (T*)out;
  T* agg_a = (T*)agg;
  T* agg_b = agg_a + ntiles;
  void* args[] = {&p_issue, &p_svc, &p_seg, &p_out, &n, &tpr, &ntiles,
                  &agg_a, &agg_b, &ninf};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, grid,
                                          THREADS, args, 0,
                                          (cudaStream_t)stream);
}

extern "C" int zns_scan_tile() { return TILE; }

extern "C" const char* zns_scan_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int zns_scan_rows_f32(const void* issue, const void* svc,
                                 const void* seg, void* out, void* agg,
                                 long long rows, long long n, void* stream,
                                 int* info) {
  return launch_rows<float>(issue, svc, seg, out, agg, rows, n, stream, info,
                            -1e30f);
}

extern "C" int zns_scan_rows_f64(const void* issue, const void* svc,
                                 const void* seg, void* out, void* agg,
                                 long long rows, long long n, void* stream,
                                 int* info) {
  return launch_rows<double>(issue, svc, seg, out, agg, rows, n, stream,
                             info, -std::numeric_limits<double>::infinity());
}
