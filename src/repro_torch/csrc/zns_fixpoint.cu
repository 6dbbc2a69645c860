// Chain-program Gauss-Seidel fixpoint, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/zns_fixpoint.py::zns_fixpoint
// (_kernel / _fixpoint_core / _rows_maxplus).  Per sweep and per family
// block f, in order: gather comp[gidx], run the segmented max-plus scan
// along each row on (cur - svc, svc), write max(cur, out) back, and flag
// movement with the early-exit test out > cur * (1 + rtol) + atol on real
// lanes.  An active-set mask over the block adjacency skips converged
// blocks: a moving block re-activates later neighbours within the sweep
// and earlier ones in the next; the solve ends when no block is active.
//
// The stacked form (fp_stack_kernel, zns_fixpoint_sharded_*) replaces
// src/repro/kernels/zns_fixpoint.py::zns_fixpoint_sharded (lax.map of
// _fixpoint_core over a stack of shard programs inside shard_map): S
// independent fixpoints, each with its own blocks, adjacency, sweep count,
// active set and convergence, in one launch.  It is a kernel of its own
// beside the single solve's fp_solve_kernel, sharing the tile helpers, so
// the single solve pays nothing for the shard bookkeeping.
//
// Bound on the card: memory, about 29 bytes per lane of every active
// block per sweep in float64 (4 gidx + 1 head + 8 comp gather + 8 svc
// gather + 8 store), with a few adds and maxes per lane.  The gathers
// and stores follow the chains, so where a family's lanes are scattered
// over the event vector each one moves a 32-byte sector.
//
// Design.  The whole solve is one persistent cooperative launch, like the
// TPU kernel's single program: the sweep loop, the active set and the
// early exit run on the device, and the kernel returns as soon as no
// block is active.  Gauss-Seidel order is a serial dependence between
// families (family f + 1 reads what f wrote), while the rows of one
// family are independent (every real index appears at most once in a
// block), so a family pass is the tiled scan of maxplus.cuh over all of
// the family's tiles at once, in tiles of 512 threads x 4 lanes (2 blocks
// an SM, 540K lanes a round on 132 SMs).  A row longer than a tile spans
// several; shorter rows pack TILE / L to a tile (fp_shape), each row's
// first lane made a segment head so that no carry crosses rows: a family
// of many short chains (33,094 rows of one lane in the experiment
// runner's program) takes a few tiles, not a tile a row.  Phase A gathers
// each tile and stages its maps, its gathered completions and its indices
// in shared memory (56 KB a block in float64; in registers they would
// spill), grid barrier, phase B composes the carry, stores max(cur, c) on real lanes
// without atomics (only where it grew: the stores are scattered too) and
// ORs the movement test into one flag tagged with the pass number (no
// reset pass), grid barrier.  Every block then applies the adjacency
// rule itself to its own copy of the active set in shared memory, so all
// blocks take the same branches.  Two grid barriers an active family
// pass, none for an inactive one.  A family with more tiles than resident
// blocks runs in rounds: a block keeps its last tile staged and gathers
// the others again in phase B.  Built with -DFP_TRACE, block 0 stamps the
// time at every barrier (scripts/fixpoint_phases.py reads them).
//
// Shards.  Shard s owns lanes base[s] .. base[s] + n_s of the completion
// vector (its dead slot last) and its own (F, 3) rows of the block table;
// its gather indices are its own (0 .. n_s).  The stack runs global sweeps:
// in sweep k every shard still running does its own sweep k, and at family
// slot f the tile space is the concatenation of the tiles of every running
// shard whose block f is active, in shard order (a per-pass prefix of tile
// counts in shared memory maps a tile to its shard).  Rows never cross
// shards, so the carry rule is unchanged: a tile composes the aggregates of
// its own row's earlier tiles.  Each shard keeps its own sweep count,
// movement flag and active set (S * F flags in shared memory), and stops
// when its active set empties or its budget runs out; the launch ends when
// no shard runs.  One barrier pair serves a slot for every shard, so a
// sweep of the stack costs max_s F_s family passes.
#include <cooperative_groups.h>

#include <cstdint>
#include <limits>

#include "maxplus.cuh"

namespace cg = cooperative_groups;

constexpr int THREADS = 512;
constexpr int ITEMS = 4;                    // lanes a thread
constexpr int TILE = THREADS * ITEMS;       // 2,048 lanes a tile

// One solve: its inputs, its output and its device state.
template <typename T>
struct FpSolve {
  T* comp;                  // (n + 1,) completions, the dead slot last
  const T* comp0;           // (n,) initial completions
  const T* svc;             // (n,) service times
  const int32_t* gidx;      // the blocks' rows, back to back
  const uint8_t* heads;
  const long long* table;   // (F, 3): offset, rows, length of each block
  const uint8_t* adj;       // (F, F) block adjacency
  T* agg_a;                 // per-tile aggregates of one family pass
  T* agg_b;
  int* state;               // ST_USED, ST_MOVED, then the active set
  long long n;              // events; the dead slot's index
  int F;                    // blocks
  int sweeps;               // the sweep budget
};

// A stack of S solves: shard s's lanes of comp, comp0 and svc start at
// base[s], its blocks are row s of the (S, F, 3) table and the (S, F, F)
// adjacency, its state words start at s * (2 + F).  n is unused.
template <typename T>
struct FpStack : FpSolve<T> {
  const long long* base;    // (S + 1,) shard starts in comp
  int S;                    // shards
};

// What a tile of shard s reads and writes: the shard's lanes, with its own
// gather indices (0 .. n; n is its dead slot).
template <typename T>
struct FpView {
  T* comp;
  const T* svc;
  const int32_t* gidx;
  const uint8_t* heads;
  long long n;
};

template <typename T>
__device__ __forceinline__ FpView<T> fp_view(const FpStack<T>& p, int s) {
  const long long b = __ldg(p.base + s);
  return FpView<T>{p.comp + b, p.svc + b, p.gidx, p.heads,
                   __ldg(p.base + s + 1) - b - 1};
}

// How a block of `rows` rows of length L at offset `off` cuts into tiles:
// a row longer than a tile spans tpr tiles; shorter rows pack rpt =
// TILE / L to a tile.  nt: the block's tiles.
struct FpShape {
  long long off, rows, L;
  long long tpr;   // tiles a row (1 when rows pack)
  long long rpt;   // rows a tile (1 when a row spans tiles)
  long long nt;
};

__host__ __device__ inline FpShape fp_shape(long long off, long long rows,
                                            long long L) {
  FpShape s;
  s.off = off;
  s.rows = rows;
  s.L = L;
  if (L >= 1 && L <= TILE) {
    s.tpr = 1;
    s.rpt = TILE / L;
    s.nt = (rows + s.rpt - 1) / s.rpt;
  } else {
    s.tpr = (L + TILE - 1) / TILE;   // 0 for an empty row: no tile
    s.rpt = 1;
    s.nt = rows * s.tpr;
  }
  return s;
}

#define ST_USED 0    // sweeps run
#define ST_MOVED 1   // number of the last pass that moved
#define ST_ACTIVE 2  // F flags: blocks active after the last sweep

// Dynamic shared memory: the staged tile, then each lane's gathered
// completion and index (read back by the thread that wrote them), then
// the two active-set copies.
template <typename T>
constexpr size_t fp_smem(int F) {
  return TILE * (sizeof(pair_t<T>) + sizeof(T) + sizeof(int)) + 2 * F;
}

// The stack's: the same tile, then the pass's tile prefix over the shards,
// the tiles of every shard's blocks, each shard's sweeps run and whether
// it still runs, and the shards' two active-set copies.
template <typename T>
constexpr size_t fp_stack_smem(int S, int F) {
  return TILE * (sizeof(pair_t<T>) + sizeof(T) + sizeof(int)) +
         sizeof(long long) * (S + 1) + (sizeof(int) + 2) * S * F +
         (sizeof(int) + 1) * S;
}

// The most shards, and blocks over all shards, a stack may hold: its
// shared memory then stays under 100 KB and the kernel at 2 blocks an SM
// (the library and the wrappers refuse larger stacks).
constexpr int FP_MAX_SHARDS = 1024;
constexpr int FP_MAX_FLAGS = 4096;    // S * F

#ifdef FP_TRACE
__device__ unsigned long long g_trace[1024];
__device__ __forceinline__ void fp_trace(int& k) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && k < 1024) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[k] = t;
  }
  ++k;
}
extern "C" int fp_trace_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
#define TRACE() fp_trace(tk)
#else
#define TRACE()
#endif

// Stage tile t of a block (its FpShape s): gather each lane's completion
// and service time, four lanes' loads in flight at a time.  Lanes past a
// row's end or on the dead slot get g = -1 and never store.  The rows of a
// packed tile lie back to back, so lane i of the tile is lane i after the
// tile's first row's start; a packed row's first lane is a segment head
// (the carry entering a row is the sentinel, as for a row of its own).
// P: the single solve's FpSolve or a shard's FpView.
template <typename T, typename P>
__device__ __forceinline__ void fp_stage(const P& p, const FpShape& s,
                                         long long t, pair_t<T>* tile,
                                         T* cur_s, int* g_s, T ninf) {
  const bool packed = s.rpt > 1;
  const long long row = packed ? t * s.rpt : t / s.tpr;
  const long long base = s.off + row * s.L;
  const long long i0 = packed ? 0 : (t - row * s.tpr) * TILE;
  const int Lp = packed ? (int)s.L : TILE;     // a packed row's length
#pragma unroll
  for (int h = 0; h < ITEMS; h += 4) {
    int g[4];
    bool head[4], real[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pos = tile_pos<ITEMS>(h + u);
      const long long i = i0 + pos;
      const int r = pos / Lp;                  // the row within the tile
      real[u] = packed ? (r < s.rpt && row + r < s.rows) : i < s.L;
      g[u] = -1;
      head[u] = false;
      if (real[u]) {
        g[u] = __ldg(p.gidx + base + i);
        head[u] = __ldg(p.heads + base + i) != 0 || (packed && pos == r * Lp);
      }
    }
    T cur[4], sv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      cur[u] = ninf;                 // the dead slot: sentinel, no service
      sv[u] = T(0);
      if (g[u] == p.n) g[u] = -1;
      if (g[u] >= 0) {
        cur[u] = __ldcg(p.comp + g[u]);  // written by earlier passes
        sv[u] = __ldg(p.svc + g[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pos = tile_pos<ITEMS>(h + u);
      // identity map past the row end
      tile_put<ITEMS>(tile, h + u,
                      real[u] ? (head[u] ? ninf : sv[u]) : T(0),
                      real[u] ? (cur[u] - sv[u]) + sv[u] : ninf);
      cur_s[pos] = cur[u];
      g_s[pos] = g[u];
    }
  }
}

// Phase B of the staged tile t of its block (the block's tiles begin at
// index t0 of the pass's aggregates): carry-in, store, movement test.
// Returns 1 if a lane of this thread moved.
template <typename T, typename P>
__device__ __forceinline__ int fp_finish(const P& p, const T* agg_a,
                                         const T* agg_b, long long t0,
                                         long long tpr, long long t,
                                         pair_t<T>* tile, const T* cur_s,
                                         const int* g_s, T* sh_a, T* sh_b,
                                         T* sh_c, T ninf, T one_plus_rtol,
                                         T atol) {
  const long long row = t / tpr;
  tile_apply<THREADS, ITEMS>(
      tile,
      tile_carry<THREADS>(agg_a, agg_b, t0 + row * tpr, t - row * tpr, sh_a,
                          sh_b, sh_c, ninf),
      sh_a, sh_b);
  int moved = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int pos = tile_pos<ITEMS>(j);
    const int g = g_s[pos];
    if (g < 0) continue;
    const T v = tile_get<ITEMS, T>(tile, j);
    const T cur = cur_s[pos];
    if (v > cur) p.comp[g] = v;      // max(cur, v): unchanged lanes skip
    if (v > cur * one_plus_rtol + atol) moved = 1;
  }
  return moved;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    fp_solve_kernel(FpSolve<T> p, T ninf, T one_plus_rtol, T atol) {
  cg::grid_group grid = cg::this_grid();
#ifdef FP_TRACE
  int tk = 0;
#endif
  TRACE();
  extern __shared__ __align__(16) uint8_t smem[];
  pair_t<T>* tile = (pair_t<T>*)smem;
  T* cur_s = (T*)(tile + TILE);
  int* g_s = (int*)(cur_s + TILE);
  uint8_t* act_now = (uint8_t*)(g_s + TILE);
  uint8_t* act_next = act_now + p.F;
  __shared__ T sh_a[THREADS / 32];
  __shared__ T sh_b[THREADS / 32];
  __shared__ T sh_c[1];
  for (int f = threadIdx.x; f < p.F; f += blockDim.x) {
    act_now[f] = 1;
    act_next[f] = 0;
  }
  // comp = comp0, four loads in flight a thread
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i0 < p.n; i0 += 4 * stride) {
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * stride < p.n) v[u] = __ldg(p.comp0 + i0 + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * stride < p.n) p.comp[i0 + u * stride] = v[u];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.comp[p.n] = ninf;
    p.state[ST_MOVED] = -1;
  }
  TRACE();
  grid.sync();
  TRACE();

  int pass = 0, used = 0, any = 1;          // the first sweep always runs
  while (used < p.sweeps && any) {
    for (int f = 0; f < p.F; ++f) {
      if (!act_now[f]) continue;
      const FpShape s = fp_shape(__ldg(p.table + 3 * f),
                                 __ldg(p.table + 3 * f + 1),
                                 __ldg(p.table + 3 * f + 2));
      if (s.nt == 0) continue;              // an empty block never moves
      long long held = -1;
      for (long long t = blockIdx.x; t < s.nt; t += gridDim.x) {
        fp_stage(p, s, t, tile, cur_s, g_s, ninf);
        T ta, tb;
        tile_aggregate<THREADS, ITEMS>(tile, ta, tb, sh_a, sh_b);
        if (threadIdx.x == 0) {
          p.agg_a[t] = ta;
          p.agg_b[t] = tb;
        }
        held = t;
      }
      TRACE();
      grid.sync();
      TRACE();
      int moved = 0;
      if (held >= 0) {
        // the last tile is still staged; the block's earlier ones are
        // gathered again (no other tile of the block writes their lanes)
        moved = fp_finish(p, (const T*)p.agg_a, (const T*)p.agg_b, 0, s.tpr,
                          held, tile, cur_s, g_s, sh_a, sh_b, sh_c, ninf,
                          one_plus_rtol, atol);
        for (long long t = blockIdx.x; t < held; t += gridDim.x) {
          __syncwarp();
          fp_stage(p, s, t, tile, cur_s, g_s, ninf);
          moved |= fp_finish(p, (const T*)p.agg_a, (const T*)p.agg_b, 0,
                             s.tpr, t, tile, cur_s, g_s, sh_a, sh_b, sh_c,
                             ninf, one_plus_rtol, atol);
        }
      }
      if (__syncthreads_or(moved) && threadIdx.x == 0)
        p.state[ST_MOVED] = pass;
      TRACE();
      grid.sync();
      TRACE();
      // a moving block re-activates neighbours: later blocks see the
      // write within this sweep, earlier ones on the next
      if (__ldcg(p.state + ST_MOVED) == pass) {
        for (int h = threadIdx.x; h < p.F; h += blockDim.x) {
          if (!__ldg(p.adj + (long long)f * p.F + h)) continue;
          if (h > f)
            act_now[h] = 1;
          else
            act_next[h] = 1;
        }
      }
      __syncthreads();
      ++pass;
    }
    ++used;
    int mine = 0;
    for (int h = threadIdx.x; h < p.F; h += blockDim.x) {
      act_now[h] = act_next[h];
      act_next[h] = 0;
      mine |= act_now[h];
    }
    any = __syncthreads_or(mine);
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) p.state[ST_USED] = used;
    for (int h = threadIdx.x; h < p.F; h += blockDim.x)
      p.state[ST_ACTIVE + h] = act_now[h];
  }
}

// The shard of tile t of a pass: the last s with pre[s] <= t (a shard that
// takes no tile this pass has pre[s] == pre[s + 1]).
__device__ __forceinline__ int fp_shard_of(const long long* pre, int S,
                                           long long t) {
  int lo = 0, hi = S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ FpShape fp_block(const FpStack<T>& p, int s,
                                            int f) {
  const long long* e = p.table + 3 * ((long long)s * p.F + f);
  return fp_shape(__ldg(e), __ldg(e + 1), __ldg(e + 2));
}

// Phase B of tile t of a stack's pass over family slot f, staged again
// first when `stage`; a tile whose lanes moved tags its shard's movement
// flag.
template <typename T>
__device__ __forceinline__ void fp_stack_b(const FpStack<T>& p, int f,
                                           const long long* pre, long long t,
                                           bool stage, int pass,
                                           pair_t<T>* tile, T* cur_s,
                                           int* g_s, T* sh_a, T* sh_b,
                                           T* sh_c, T ninf, T one_plus_rtol,
                                           T atol) {
  const int s = fp_shard_of(pre, p.S, t);
  const long long t0 = pre[s];
  const FpShape sh = fp_block(p, s, f);
  const FpView<T> v = fp_view(p, s);
  if (stage) {
    __syncwarp();
    fp_stage(v, sh, t - t0, tile, cur_s, g_s, ninf);
  }
  const int moved =
      fp_finish(v, (const T*)p.agg_a, (const T*)p.agg_b, t0, sh.tpr, t - t0,
                tile, cur_s, g_s, sh_a, sh_b, sh_c, ninf, one_plus_rtol,
                atol);
  if (__syncthreads_or(moved) && threadIdx.x == 0)
    p.state[s * (2 + p.F) + ST_MOVED] = pass;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    fp_stack_kernel(FpStack<T> p, T ninf, T one_plus_rtol, T atol) {
  cg::grid_group grid = cg::this_grid();
  const int S = p.S, F = p.F, SF = S * F;
#ifdef FP_TRACE
  int tk = 0;
#endif
  TRACE();
  extern __shared__ __align__(16) uint8_t smem[];
  pair_t<T>* tile = (pair_t<T>*)smem;
  T* cur_s = (T*)(tile + TILE);
  int* g_s = (int*)(cur_s + TILE);
  long long* pre = (long long*)(g_s + TILE);  // the pass's tile prefix
  int* ntile = (int*)(pre + S + 1);         // (S, F) tiles of each block
  int* used = ntile + SF;                   // sweeps run, a shard
  uint8_t* running = (uint8_t*)(used + S);
  uint8_t* act_now = running + S;           // (S, F) active sets
  uint8_t* act_next = act_now + SF;
  __shared__ T sh_a[THREADS / 32];
  __shared__ T sh_b[THREADS / 32];
  __shared__ T sh_c[1];
  for (int i = threadIdx.x; i < SF; i += blockDim.x) {
    act_now[i] = 1;
    act_next[i] = 0;
    ntile[i] = (int)fp_block(p, i / F, i % F).nt;
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    used[s] = 0;
    running[s] = 1;                         // the first sweep always runs
  }
  // comp = comp0 on every shard's real lanes, four loads in flight a
  // thread
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int s = 0; s < S; ++s) {
    const long long b = __ldg(p.base + s), n = __ldg(p.base + s + 1) - b - 1;
    for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i0 < n; i0 += 4 * stride) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * stride < n) v[u] = __ldg(p.comp0 + b + i0 + u * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * stride < n) p.comp[b + i0 + u * stride] = v[u];
    }
  }
  if (blockIdx.x == 0) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      p.comp[__ldg(p.base + s + 1) - 1] = ninf;
      p.state[s * (2 + F) + ST_MOVED] = -1;
    }
  }
  TRACE();
  grid.sync();
  TRACE();

  int pass = 0, any = 1;
  while (any) {
    for (int f = 0; f < F; ++f) {
      // this pass's tiles: those of block f of every running shard in
      // which it is active, shard after shard
      if (threadIdx.x == 0) {
        long long sum = 0;
        for (int s = 0; s < S; ++s) {
          pre[s] = sum;
          if (running[s] && act_now[s * F + f]) sum += ntile[s * F + f];
        }
        pre[S] = sum;
      }
      __syncthreads();
      const long long nt = pre[S];
      if (nt == 0) {                        // nothing to do: no barrier
        __syncthreads();                    // pre is written again next
        continue;
      }
      long long held = -1;
      for (long long t = blockIdx.x; t < nt; t += gridDim.x) {
        const int s = fp_shard_of(pre, S, t);
        fp_stage(fp_view(p, s), fp_block(p, s, f), t - pre[s], tile, cur_s,
                 g_s, ninf);
        T ta, tb;
        tile_aggregate<THREADS, ITEMS>(tile, ta, tb, sh_a, sh_b);
        if (threadIdx.x == 0) {
          p.agg_a[t] = ta;
          p.agg_b[t] = tb;
        }
        held = t;
      }
      TRACE();
      grid.sync();
      TRACE();
      if (held >= 0) {
        // the last tile is still staged; the block's earlier ones are
        // gathered again (no other tile of the block writes their lanes)
        fp_stack_b(p, f, pre, held, false, pass, tile, cur_s, g_s, sh_a,
                   sh_b, sh_c, ninf, one_plus_rtol, atol);
        for (long long t = blockIdx.x; t < held; t += gridDim.x)
          fp_stack_b(p, f, pre, t, true, pass, tile, cur_s, g_s, sh_a, sh_b,
                     sh_c, ninf, one_plus_rtol, atol);
      }
      TRACE();
      grid.sync();
      TRACE();
      // a moving block re-activates its shard's neighbours: later blocks
      // see the write within this sweep, earlier ones on the next (one
      // read of a shard's movement flag, then its adjacency row)
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        if (pre[s + 1] == pre[s]) continue;  // block f of s did not run
        if (__ldcg(p.state + s * (2 + F) + ST_MOVED) != pass) continue;
        const uint8_t* row = p.adj + ((long long)s * F + f) * F;
        for (int h = 0; h < F; ++h) {
          if (!__ldg(row + h)) continue;
          if (h > f)
            act_now[s * F + h] = 1;
          else
            act_next[s * F + h] = 1;
        }
      }
      __syncthreads();
      ++pass;
    }
    // every running shard ends its sweep: its next active set, and whether
    // it runs another
    int mine = 0;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      if (!running[s]) continue;
      int act = 0;
      for (int h = s * F; h < (s + 1) * F; ++h) {
        act_now[h] = act_next[h];
        act_next[h] = 0;
        act |= act_now[h];
      }
      used[s] += 1;
      running[s] = act && used[s] < p.sweeps;
      mine |= running[s];
    }
    any = __syncthreads_or(mine);
  }
  if (blockIdx.x == 0) {
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      p.state[s * (2 + F) + ST_USED] = used[s];
    for (int i = threadIdx.x; i < SF; i += blockDim.x)
      p.state[(i / F) * (2 + F) + ST_ACTIVE + i % F] = act_now[i];
  }
}

// A page-locked host buffer of at least n ints for this thread (the
// state read back each solve), grown as needed; nullptr if it cannot be
// allocated.
static int* pinned_ints(size_t n) {
  thread_local int* buf = nullptr;
  thread_local size_t have = 0;
  if (n > have) {
    if (buf != nullptr) cudaFreeHost(buf);
    buf = nullptr;
    have = 0;
    if (cudaHostAlloc((void**)&buf, n * sizeof(int), cudaHostAllocDefault))
      return nullptr;
    have = n;
  }
  return buf;
}

// Launch `kernel` on p as one cooperative grid of at most `most` tiles'
// blocks (the most tiles of a pass) and the resident capacity, with agg
// (2 * max(1, most) elements) as the aggregates' scratch; wait for it and
// read `words` state ints back into *host (pinned).  info[0..2]: the grid,
// the resident-block capacity, the registers a thread.
template <typename T, typename P>
static int fp_launch(void (*kernel)(P, T, T, T), P& p, size_t smem,
                     long long most, void* agg, size_t words, void* stream,
                     int* info, int** host, T ninf, double rtol,
                     double atol) {
  int cap = 0, regs = 0;
  int err = resident_blocks(kernel, THREADS, smem, &cap, &regs);
  if (err) return err;
  const int grid = most < 1 ? 1 : (most < cap ? (int)most : cap);
  info[0] = grid;
  info[1] = cap;
  info[2] = regs;
  p.agg_a = (T*)agg;
  p.agg_b = p.agg_a + (most < 1 ? 1 : most);
  T one_plus_rtol = (T)(1.0 + rtol), at = (T)atol;
  void* args[] = {&p, &ninf, &one_plus_rtol, &at};
  cudaStream_t st = (cudaStream_t)stream;
  err = (int)cudaLaunchCooperativeKernel((const void*)kernel, grid, THREADS,
                                         args, smem, st);
  if (err) return err;
  *host = pinned_ints(words);
  if (*host == nullptr) return (int)cudaErrorMemoryAllocation;
  err = (int)cudaMemcpyAsync(*host, p.state, words * sizeof(int),
                             cudaMemcpyDeviceToHost, st);
  if (!err) err = (int)cudaStreamSynchronize(st);
  return err;
}

template <typename T>
static void fp_fill(FpSolve<T>& p, void* comp, const void* comp0,
                    const void* svc, const void* gidx, const void* heads,
                    const void* table_dev, const void* adj, void* state,
                    long long n, int F, int sweeps) {
  p.comp = (T*)comp;
  p.comp0 = (const T*)comp0;
  p.svc = (const T*)svc;
  p.gidx = (const int32_t*)gidx;
  p.heads = (const uint8_t*)heads;
  p.table = (const long long*)table_dev;
  p.adj = (const uint8_t*)adj;
  p.state = (int*)state;
  p.n = n;
  p.F = F;
  p.sweeps = sweeps;
}

// table: host copy of table_dev, F (offset, rows, length) triples.  agg:
// 2 * max(1, the largest block's tile count) elements of scratch; state:
// 2 + F ints.  Waits for the solve and reads its state back.  info (host,
// 5 ints): the grid, the resident-block capacity, the registers a thread,
// the sweeps used and whether the solve converged.
template <typename T>
static int run_fixpoint(void* comp, const void* comp0, const void* svc,
                        const void* gidx, const void* heads,
                        const void* table_dev, const long long* table,
                        const void* adj, int F, int sweeps, long long n,
                        void* agg, void* state, void* stream, int* info,
                        T ninf, double rtol, double atol) {
  long long most = 0;
  for (int f = 0; f < F; ++f) {
    const long long nt =
        fp_shape(table[3 * f], table[3 * f + 1], table[3 * f + 2]).nt;
    if (nt > most) most = nt;
  }
  FpSolve<T> p;
  fp_fill(p, comp, comp0, svc, gidx, heads, table_dev, adj, state, n, F,
          sweeps);
  int* host = nullptr;
  int err = fp_launch(fp_solve_kernel<T>, p, fp_smem<T>(F), most, agg,
                      2 + F, stream, info, &host, ninf, rtol, atol);
  if (err) return err;
  int active = 0;
  for (int f = 0; f < F; ++f) active |= host[ST_ACTIVE + f];
  info[3] = host[ST_USED];
  info[4] = !active;
  return 0;
}

// The stacked solve: table (host copy of table_dev) S * F triples; base
// (device) S + 1 shard starts; agg: 2 * max(1, the most tiles of any slot
// summed over the shards) elements; state: S * (2 + F) ints.  info as
// run_fixpoint's, its sweeps and convergence shard 0's; used / conv
// (host, S ints each): every shard's.
template <typename T>
static int run_stack(void* comp, const void* comp0, const void* svc,
                     const void* gidx, const void* heads,
                     const void* table_dev, const long long* table,
                     const void* adj, const void* base, int S, int F,
                     int sweeps, void* agg, void* state, void* stream,
                     int* info, int* used, int* conv, T ninf, double rtol,
                     double atol) {
  if (S < 1 || S > FP_MAX_SHARDS || (long long)S * F > FP_MAX_FLAGS)
    return (int)cudaErrorInvalidValue;
  long long most = 0;
  for (int f = 0; f < F; ++f) {
    long long nt = 0;
    for (int s = 0; s < S; ++s) {
      const long long* e = table + 3 * ((long long)s * F + f);
      nt += fp_shape(e[0], e[1], e[2]).nt;
    }
    if (nt > most) most = nt;
  }
  FpStack<T> p;
  fp_fill<T>(p, comp, comp0, svc, gidx, heads, table_dev, adj, state, 0, F,
             sweeps);
  p.base = (const long long*)base;
  p.S = S;
  int* host = nullptr;
  int err = fp_launch(fp_stack_kernel<T>, p, fp_stack_smem<T>(S, F), most,
                      agg, (size_t)S * (2 + F), stream, info, &host, ninf,
                      rtol, atol);
  if (err) return err;
  for (int s = 0; s < S; ++s) {
    const int* w = host + (size_t)s * (2 + F);
    int active = 0;
    for (int f = 0; f < F; ++f) active |= w[ST_ACTIVE + f];
    used[s] = w[ST_USED];
    conv[s] = !active;
  }
  info[3] = used[0];
  info[4] = conv[0];
  return 0;
}

extern "C" int zns_fixpoint_tile() { return TILE; }

extern "C" int zns_fixpoint_max_shards() { return FP_MAX_SHARDS; }

extern "C" int zns_fixpoint_max_flags() { return FP_MAX_FLAGS; }

extern "C" const char* zns_fixpoint_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int zns_fixpoint_f32(void* comp, const void* comp0,
                                const void* svc, const void* gidx,
                                const void* heads, const void* table_dev,
                                const long long* table, const void* adj,
                                int F, int sweeps, long long n, void* agg,
                                void* state, void* stream, int* info) {
  return run_fixpoint<float>(comp, comp0, svc, gidx, heads, table_dev, table,
                             adj, F, sweeps, n, agg, state, stream, info,
                             -1e30f, 1e-5, 1e-3);
}

extern "C" int zns_fixpoint_f64(void* comp, const void* comp0,
                                const void* svc, const void* gidx,
                                const void* heads, const void* table_dev,
                                const long long* table, const void* adj,
                                int F, int sweeps, long long n, void* agg,
                                void* state, void* stream, int* info) {
  return run_fixpoint<double>(comp, comp0, svc, gidx, heads, table_dev,
                              table, adj, F, sweeps, n, agg, state, stream,
                              info, -std::numeric_limits<double>::infinity(),
                              1e-12, 1e-9);
}

// The stacked solve: S shards, shard s at base[s] of comp / comp0 / svc
// (device, S + 1 entries), its (F, 3) table rows and (F, F) adjacency at
// s.  used / conv: host, S ints each.
extern "C" int zns_fixpoint_sharded_f32(
    void* comp, const void* comp0, const void* svc, const void* gidx,
    const void* heads, const void* table_dev, const long long* table,
    const void* adj, const void* base, int S, int F, int sweeps, void* agg,
    void* state, void* stream, int* info, int* used, int* conv) {
  return run_stack<float>(comp, comp0, svc, gidx, heads, table_dev, table,
                          adj, base, S, F, sweeps, agg, state, stream, info,
                          used, conv, -1e30f, 1e-5, 1e-3);
}

extern "C" int zns_fixpoint_sharded_f64(
    void* comp, const void* comp0, const void* svc, const void* gidx,
    const void* heads, const void* table_dev, const long long* table,
    const void* adj, const void* base, int S, int F, int sweeps, void* agg,
    void* state, void* stream, int* info, int* used, int* conv) {
  return run_stack<double>(comp, comp0, svc, gidx, heads, table_dev, table,
                           adj, base, S, F, sweeps, agg, state, stream, info,
                           used, conv,
                           -std::numeric_limits<double>::infinity(), 1e-12,
                           1e-9);
}
