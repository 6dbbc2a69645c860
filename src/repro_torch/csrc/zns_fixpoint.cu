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
// gather + 8 store), with a few adds and maxes per lane.
//
// Design.  Gauss-Seidel order is a serial dependence between families
// (family f + 1 reads what f wrote in the same sweep), while the rows of
// one family are independent: every real index appears at most once per
// block, so one thread block per row writes back with no atomics.  The
// TPU kernel ran the whole loop in one program with comp resident in
// VMEM; here the host enqueues, on one stream and without any host sync,
// for every sweep and family one scan launch (one block per row, each
// block reads the device-side done / active flags and returns at once
// when idle) and one single-thread launch that applies the adjacency
// rule, plus one launch per sweep that advances the active set and sets
// the done flag.  The caller reads sweeps_used and the active set back
// once at the end.  Weaknesses: a family of few long rows (16 rows of
// 50,000 lanes in a 16-device fleet) fills only 16 of 132 SMs and walks
// each row serially in chunks; a solve that converges early still runs
// its remaining no-op launches (a few microseconds each).  A persistent
// cooperative kernel is the later fix for both.
#include <cstdint>
#include <limits>

#include "maxplus.cuh"

// Device state, int32: [0] done, [1] sweeps used, then act_now[F],
// act_next[F], moved[F].
#define ST_DONE 0
#define ST_USED 1
#define ST_ACT(F) 2
#define ST_NEXT(F) (2 + (F))
#define ST_MOVED(F) (2 + 2 * (F))

__global__ void fp_init(int* state, int F) {
  if (threadIdx.x == 0) {
    state[ST_DONE] = 0;
    state[ST_USED] = 0;
  }
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    state[ST_ACT(F) + f] = 1;
    state[ST_NEXT(F) + f] = 0;
    state[ST_MOVED(F) + f] = 0;
  }
}

template <typename T>
__global__ void fp_family(T* __restrict__ comp, const T* __restrict__ svc,
                          const int32_t* __restrict__ gidx,
                          const uint8_t* __restrict__ heads, long long L,
                          int dead, int f, int F, int* __restrict__ state,
                          T ninf, T one_plus_rtol, T atol) {
  if (state[ST_DONE] || !state[ST_ACT(F) + f]) return;
  __shared__ T sh_a[32];
  __shared__ T sh_b[32];
  __shared__ T sh_carry;
  const long long base = (long long)blockIdx.x * L;
  T carry = ninf;
  int moved = 0;
  for (long long s = 0; s < L; s += blockDim.x) {
    const long long i = s + threadIdx.x;
    int g = dead;
    bool head = true;
    if (i < L) {
      g = gidx[base + i];
      head = heads[base + i] != 0;
    }
    const T cur = comp[g];        // the dead slot holds the sentinel
    const T sv = svc[g];          // ... and a zero service time
    T a = head ? ninf : sv;
    T b = (cur - sv) + sv;
    block_scan(a, b, sh_a, sh_b, ninf);
    const T c = tmax(carry + a, b);
    if (g != dead) {
      comp[g] = tmax(cur, c);      // padding lanes never store
      if (c > cur * one_plus_rtol + atol) moved = 1;
    }
    if (threadIdx.x == blockDim.x - 1) sh_carry = c;
    __syncthreads();
    carry = sh_carry;
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0)
    state[ST_MOVED(F) + f] = 1;
}

__global__ void fp_after_family(const uint8_t* __restrict__ adj, int F,
                                int f, int* state) {
  if (state[ST_DONE]) return;
  if (state[ST_ACT(F) + f] && state[ST_MOVED(F) + f]) {
    for (int g = 0; g < F; ++g) {
      if (!adj[(long long)f * F + g]) continue;
      if (g > f)
        state[ST_ACT(F) + g] = 1;    // later: this sweep (Gauss-Seidel)
      else
        state[ST_NEXT(F) + g] = 1;   // earlier: next sweep
    }
  }
  state[ST_MOVED(F) + f] = 0;
}

__global__ void fp_after_sweep(int* state, int F) {
  if (state[ST_DONE]) return;
  state[ST_USED] += 1;
  int any = 0;
  for (int f = 0; f < F; ++f) {
    const int v = state[ST_NEXT(F) + f];
    state[ST_ACT(F) + f] = v;
    state[ST_NEXT(F) + f] = 0;
    any |= v;
  }
  if (!any) state[ST_DONE] = 1;
}

// table: host array of F (offset, rows, length) triples into gidx/heads.
template <typename T>
static int run_fixpoint(void* comp, const void* svc, const void* gidx,
                        const void* heads, const long long* table,
                        const void* adj, int F, int sweeps, int dead,
                        void* state, void* stream, T ninf, double rtol,
                        double atol) {
  cudaStream_t st = (cudaStream_t)stream;
  int* stt = (int*)state;
  fp_init<<<1, 32, 0, st>>>(stt, F);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const T one_plus_rtol = (T)(1.0 + rtol);
  for (int s = 0; s < sweeps; ++s) {
    for (int f = 0; f < F; ++f) {
      const long long off = table[3 * f], rows = table[3 * f + 1],
                      len = table[3 * f + 2];
      if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
      if (rows > 0 && len > 0) {
        fp_family<T><<<(unsigned)rows, scan_threads(len), 0, st>>>(
            (T*)comp, (const T*)svc, (const int32_t*)gidx + off,
            (const uint8_t*)heads + off, len, dead, f, F, stt, ninf,
            one_plus_rtol, (T)atol);
        err = (int)cudaGetLastError();
        if (err) return err;
      }
      fp_after_family<<<1, 1, 0, st>>>((const uint8_t*)adj, F, f, stt);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
    fp_after_sweep<<<1, 1, 0, st>>>(stt, F);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

extern "C" int zns_fixpoint_f32(void* comp, const void* svc, const void* gidx,
                                const void* heads, const long long* table,
                                const void* adj, int F, int sweeps, int dead,
                                void* state, void* stream) {
  return run_fixpoint<float>(comp, svc, gidx, heads, table, adj, F, sweeps,
                             dead, state, stream, -1e30f, 1e-5, 1e-3);
}

extern "C" int zns_fixpoint_f64(void* comp, const void* svc, const void* gidx,
                                const void* heads, const long long* table,
                                const void* adj, int F, int sweeps, int dead,
                                void* state, void* stream) {
  return run_fixpoint<double>(comp, svc, gidx, heads, table, adj, F, sweeps,
                              dead, state, stream,
                              -std::numeric_limits<double>::infinity(),
                              1e-12, 1e-9);
}
