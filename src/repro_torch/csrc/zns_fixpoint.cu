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
template <typename T>
__device__ __forceinline__ void fp_stage(const FpSolve<T>& p,
                                         const FpShape& s, long long t,
                                         pair_t<T>* tile, T* cur_s, int* g_s,
                                         T ninf) {
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

// Phase B of the staged tile t: carry-in, store, movement test.  Returns
// 1 if a lane of this thread moved.
template <typename T>
__device__ __forceinline__ int fp_finish(const FpSolve<T>& p, long long tpr,
                                         long long t, pair_t<T>* tile,
                                         const T* cur_s, const int* g_s,
                                         T* sh_a, T* sh_b, T* sh_c, T ninf,
                                         T one_plus_rtol, T atol) {
  const long long row = t / tpr;
  tile_apply<THREADS, ITEMS>(
      tile,
      tile_carry<THREADS>((const T*)p.agg_a, (const T*)p.agg_b, row * tpr,
                          t - row * tpr, sh_a, sh_b, sh_c, ninf),
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
        moved = fp_finish(p, s.tpr, held, tile, cur_s, g_s, sh_a, sh_b,
                          sh_c, ninf, one_plus_rtol, atol);
        for (long long t = blockIdx.x; t < held; t += gridDim.x) {
          __syncwarp();
          fp_stage(p, s, t, tile, cur_s, g_s, ninf);
          moved |= fp_finish(p, s.tpr, t, tile, cur_s, g_s, sh_a, sh_b,
                             sh_c, ninf, one_plus_rtol, atol);
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
  auto kernel = fp_solve_kernel<T>;
  const size_t smem = fp_smem<T>(F);
  int cap = 0, regs = 0;
  int err = resident_blocks(kernel, THREADS, smem, &cap, &regs);
  if (err) return err;
  long long most = 0;
  for (int f = 0; f < F; ++f) {
    const long long nt =
        fp_shape(table[3 * f], table[3 * f + 1], table[3 * f + 2]).nt;
    if (nt > most) most = nt;
  }
  const int grid = most < 1 ? 1 : (most < cap ? (int)most : cap);
  info[0] = grid;
  info[1] = cap;
  info[2] = regs;
  FpSolve<T> p;
  p.comp = (T*)comp;
  p.comp0 = (const T*)comp0;
  p.svc = (const T*)svc;
  p.gidx = (const int32_t*)gidx;
  p.heads = (const uint8_t*)heads;
  p.table = (const long long*)table_dev;
  p.adj = (const uint8_t*)adj;
  p.agg_a = (T*)agg;
  p.agg_b = p.agg_a + (most < 1 ? 1 : most);
  p.state = (int*)state;
  p.n = n;
  p.F = F;
  p.sweeps = sweeps;
  T one_plus_rtol = (T)(1.0 + rtol), at = (T)atol;
  void* args[] = {&p, &ninf, &one_plus_rtol, &at};
  cudaStream_t st = (cudaStream_t)stream;
  err = (int)cudaLaunchCooperativeKernel((const void*)kernel, grid, THREADS,
                                         args, smem, st);
  if (err) return err;
  int* host = pinned_ints(2 + F);
  if (host == nullptr) return (int)cudaErrorMemoryAllocation;
  err = (int)cudaMemcpyAsync(host, state, (2 + F) * sizeof(int),
                             cudaMemcpyDeviceToHost, st);
  if (!err) err = (int)cudaStreamSynchronize(st);
  if (err) return err;
  int active = 0;
  for (int f = 0; f < F; ++f) active |= host[ST_ACTIVE + f];
  info[3] = host[ST_USED];
  info[4] = !active;
  return 0;
}

extern "C" int zns_fixpoint_tile() { return TILE; }

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
