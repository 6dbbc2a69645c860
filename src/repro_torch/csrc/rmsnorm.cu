// Row-wise RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm: _kernel).
// Per row of a (rows, D) view: y = x * rsqrt(mean(x^2) + eps) * (1 + w),
// computed in float32 and written in the input type (float or bfloat16);
// w is float32 (D,).
//
// Bound on the card: memory.  Each element is read once and written once
// (4 bytes a value in bf16, 8 in f32) for about four flops; w stays in L1.
// The TPU kernel normalised 256-row blocks resident in VMEM.  Here each
// thread loads its share of a row once, as 16-byte vectors (8 bf16 or 4
// f32) held in registers, with the matching float4s of w (so that their
// latency overlaps the reduction), reduces the sum of squares, normalises
// from the registers and stores 16-byte vectors: one pass over device
// memory.
//   * Rows of at most 32 vectors (bf16 D <= 256: the (B*S*H, 128) q/k-norm
//     rows): LPR = 2..32 lanes a row, one vector a lane, 32 / LPR rows a
//     warp (16 lanes and two rows a warp at D = 128 bf16), 256-thread
//     blocks; the sum is a shuffle over the row's lanes.
//   * Longer rows, up to 2,048 vectors (16,384 bf16): a block a row of at
//     most 256 threads (a multiple of 32), NV = 2, 4 or 8 vectors a thread:
//     2,560 bf16 is 320 vectors, 160 threads x 2; 4,096 bf16 is 256 x 2.
//     Warp shuffles, then each thread sums the warp totals from shared
//     memory after one barrier.  More, shorter warps a row keep more
//     loads in flight than a warp a row with ten vectors a lane.
//   Registers (ptxas -v): 32 (bf16 rows of 128) and 40 (bf16 rows of
//   2,560), at most 125 (bf16, 8 vectors a thread); no spills.
// Rows whose length or base is not 16-byte aligned (x, w or out), or longer
// than 2,048 vectors, take the scalar two-pass kernels: a warp a row for
// D <= 256, a block a row above.
#include <cuda_bf16.h>

#include <climits>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as XLA's astype
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int WARP_ROWS = 8;        // rows per block on the warp path
constexpr int BLOCK_THREADS = 256;  // threads per row on the block path

// ---------------------------------------------------------------------------
// Vector path: 16-byte loads and stores, the row held in registers.

// Elements of T in 16 bytes, and their conversion to and from float.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ float2 pair(uint32_t u) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ uint32_t word(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const float2 a = pair(u.x), b = pair(u.y), c = pair(u.z), d = pair(u.w);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(word(f[0], f[1]), word(f[2], f[3]), word(f[4], f[5]),
                      word(f[6], f[7]));
  }
};

// Sum of squares of the vectors a thread holds (absent ones are zero).
template <typename T, int NV>
__device__ __forceinline__ float sum_squares(const uint4 (&raw)[NV]) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float f[Vec<T>::N];
    Vec<T>::unpack(raw[i], f);
#pragma unroll
    for (int e = 0; e < Vec<T>::N; ++e) ss = fmaf(f[e], f[e], ss);
  }
  return ss;
}

// The N weights of vector v, loaded with x so that their latency
// overlaps the reduction.
template <typename T>
struct Weights {
  float4 g[Vec<T>::N / 4];
  __device__ __forceinline__ void load(const float* __restrict__ w, int v) {
#pragma unroll
    for (int i = 0; i < Vec<T>::N / 4; ++i)
      g[i] = __ldg(reinterpret_cast<const float4*>(w + v * Vec<T>::N) + i);
  }
};

// y = x * r * (1 + w) for one held vector v of the row, stored to yr.
template <typename T>
__device__ __forceinline__ void normalise_store(const uint4& raw,
                                                const Weights<T>& wv, int v,
                                                T* yr, float r) {
  constexpr int N = Vec<T>::N;
  float f[N];
  Vec<T>::unpack(raw, f);
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    f[4 * g + 0] = f[4 * g + 0] * r * (1.f + wv.g[g].x);
    f[4 * g + 1] = f[4 * g + 1] * r * (1.f + wv.g[g].y);
    f[4 * g + 2] = f[4 * g + 2] * r * (1.f + wv.g[g].z);
    f[4 * g + 3] = f[4 * g + 3] * r * (1.f + wv.g[g].w);
  }
  *reinterpret_cast<uint4*>(yr + v * N) = Vec<T>::pack(f);
}

// LPR lanes a row (32 / LPR rows a warp), NV vectors a lane: vector
// li + LPR * i of the row for lane li of its group.
template <typename T, int LPR, int NV>
__global__ void __launch_bounds__(BLOCK_THREADS)
    rmsnorm_vec_warp(const T* __restrict__ x, const float* __restrict__ w,
                     T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int N = Vec<T>::N, RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, li = lane % LPR;
  const long long row =
      ((long long)blockIdx.x * (BLOCK_THREADS / 32) + (threadIdx.x >> 5)) *
          RPW + lane / LPR;
  const bool live = row < rows;  // dead lanes still join the shuffles
  const int nvec = d / N;
  const T* xr = x + (live ? row : 0) * d;
  uint4 raw[NV];
  Weights<T> wv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = li + LPR * i;
    raw[i] = live && v < nvec
                 ? __ldg(reinterpret_cast<const uint4*>(xr + v * N))
                 : make_uint4(0, 0, 0, 0);
    if (v < nvec) wv[i].load(w, v);
  }
  float ss = sum_squares<T, NV>(raw);
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (!live) return;
  const float r = rsqrtf(ss / (float)d + eps);
  T* yr = out + row * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = li + LPR * i;
    if (v < nvec) normalise_store<T>(raw[i], wv[i], v, yr, r);
  }
}

// A block a row: blockDim.x threads (a multiple of 32, at most 256), NV
// vectors a thread (vector tid + blockDim.x * i).
template <typename T, int NV>
__global__ void __launch_bounds__(BLOCK_THREADS)
    rmsnorm_vec_block(const T* __restrict__ x, const float* __restrict__ w,
                      T* __restrict__ out, int d, float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float warp_tot[BLOCK_THREADS / 32];
  const int tid = threadIdx.x, nt = blockDim.x, nvec = d / N;
  const T* xr = x + (long long)blockIdx.x * d;
  uint4 raw[NV];
  Weights<T> wv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = tid + nt * i;
    raw[i] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(xr + v * N))
                      : make_uint4(0, 0, 0, 0);
    if (v < nvec) wv[i].load(w, v);
  }
  const float ss = warp_sum(sum_squares<T, NV>(raw));
  if ((tid & 31) == 0) warp_tot[tid >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < nt / 32; ++i) tot += warp_tot[i];
  const float r = rsqrtf(tot / (float)d + eps);
  T* yr = out + (long long)blockIdx.x * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = tid + nt * i;
    if (v < nvec) normalise_store<T>(raw[i], wv[i], v, yr, r);
  }
}

// ---------------------------------------------------------------------------
// Scalar path (any length and alignment): two passes over the row.

template <typename T>
__global__ void rmsnorm_warp_rows(const T* __restrict__ x,
                                  const float* __restrict__ w,
                                  T* __restrict__ out, long long rows, int d,
                                  float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  T* yr = out + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int i = lane; i < d; i += 32)
    store(yr + i, to_f32(xr[i]) * r * (1.f + w[i]));
}

template <typename T>
__global__ void rmsnorm_block_rows(const T* __restrict__ x,
                                   const float* __restrict__ w,
                                   T* __restrict__ out, int d, float eps) {
  __shared__ float warp_tot[BLOCK_THREADS / 32];
  __shared__ float s_r;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + (long long)blockIdx.x * d;
  T* yr = out + (long long)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += BLOCK_THREADS) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_tot[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < BLOCK_THREADS / 32 ? warp_tot[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) s_r = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = s_r;
  for (int i = threadIdx.x; i < d; i += BLOCK_THREADS)
    store(yr + i, to_f32(xr[i]) * r * (1.f + w[i]));
}

// ---------------------------------------------------------------------------

template <typename T, int LPR, int NV>
int launch_warp(const T* x, const float* w, T* out, long long rows, int d,
                float eps, cudaStream_t s) {
  constexpr long long per_block = (BLOCK_THREADS / 32) * (32 / LPR);
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  rmsnorm_vec_warp<T, LPR, NV>
      <<<(unsigned)blocks, BLOCK_THREADS, 0, s>>>(x, w, out, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
int launch_block(const T* x, const float* w, T* out, long long rows, int d,
                 float eps, cudaStream_t s) {
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  const int nvec = d / Vec<T>::N;
  const int threads = (nvec + 32 * NV - 1) / (32 * NV) * 32;
  rmsnorm_vec_block<T, NV>
      <<<(unsigned)rows, threads, 0, s>>>(x, w, out, d, eps);
  return (int)cudaGetLastError();
}

// The vector path for nvec = d / Vec<T>::N vectors a row; -1 when the row
// is too long for it.
template <typename T>
int launch_vec(const T* x, const float* w, T* out, long long rows, int d,
               float eps, cudaStream_t s) {
  const int nvec = d / Vec<T>::N;
  if (nvec <= 2) return launch_warp<T, 2, 1>(x, w, out, rows, d, eps, s);
  if (nvec <= 4) return launch_warp<T, 4, 1>(x, w, out, rows, d, eps, s);
  if (nvec <= 8) return launch_warp<T, 8, 1>(x, w, out, rows, d, eps, s);
  if (nvec <= 16) return launch_warp<T, 16, 1>(x, w, out, rows, d, eps, s);
  if (nvec <= 32) return launch_warp<T, 32, 1>(x, w, out, rows, d, eps, s);
  if (nvec <= 2 * BLOCK_THREADS)
    return launch_block<T, 2>(x, w, out, rows, d, eps, s);
  if (nvec <= 4 * BLOCK_THREADS)
    return launch_block<T, 4>(x, w, out, rows, d, eps, s);
  if (nvec <= 8 * BLOCK_THREADS)
    return launch_block<T, 8>(x, w, out, rows, d, eps, s);
  return -1;
}

template <typename T>
int launch(const void* x, const void* w, void* out, long long rows, int d,
           float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  if (d % Vec<T>::N == 0 && bases % 16 == 0) {
    const int rc = launch_vec<T>((const T*)x, (const float*)w, (T*)out, rows,
                                 d, eps, s);
    if (rc >= 0) return rc;
  }
  if (d <= 256) {
    const long long blocks = (rows + WARP_ROWS - 1) / WARP_ROWS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    rmsnorm_warp_rows<T><<<(unsigned)blocks, WARP_ROWS * 32, 0, s>>>(
        (const T*)x, (const float*)w, (T*)out, rows, d, eps);
  } else {
    if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
    rmsnorm_block_rows<T><<<(unsigned)rows, BLOCK_THREADS, 0, s>>>(
        (const T*)x, (const float*)w, (T*)out, d, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* w, void* out,
                           long long rows, int d, float eps, void* stream) {
  return launch<float>(x, w, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* w, void* out,
                            long long rows, int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, rows, d, eps, stream);
}

// ---------------------------------------------------------------------------
// Backward (the TPU package has no backward kernel: its gradients are XLA's
// autodiff of the plain RMSNorm).  With r = rsqrt(mean(x^2) + eps), per row:
//   dx = r (1 + w) dy - x r^3 / D * sum_d (dy (1 + w) x)     (x's dtype)
//   dw = sum_rows dy x r                                      (float32)
// Bound on the card: memory.  x and dy are read once and dx is written once
// (6 bytes an element in bf16, 12 in f32) for about ten flops; dw's
// per-block partial rows add 2-4% at the main path's shapes.
//
// Vector path (D fills whole 16-byte vectors, every base is 16-byte aligned,
// at most 2,048 vectors a row): one pass over device memory.  Every block
// is persistent and walks the rows slot + k * stride.  A thread always holds
// the same columns, so it keeps their (1 + w) and their dw in float32
// registers across every row it sees: no shared-memory traffic a row.  It
// issues the next row's x and dy loads (16-byte vectors) before it reduces
// the current row, reduces sum x^2 and sum dy (1 + w) x together, and
// writes dx as 16-byte vectors from its registers.  The layouts, as the
// forward's:
//   * rows of at most 32 vectors (the (..., 128) q/k-norm rows): LPR lanes
//     a row, one vector a lane, 32 / LPR rows a warp (two at D = 128 bf16);
//     the sums are shuffles over the row's lanes.  256-thread blocks, 4 an
//     SM (at most 64 registers): 1,024 threads an SM with the next row in
//     flight keep 32 KB of loads in flight, above the ~25 KB that HBM3's
//     bandwidth times its latency asks of an SM.
//   * longer rows, up to 512 vectors (tinyllama's 2,048 bf16): TPR = 32..256
//     threads a row (a multiple of 32), two vectors a thread, 256 / TPR rows
//     side by side in a block (two at 2,048 bf16); warp shuffles, then the
//     row's warp totals through shared memory after one barrier a row (the
//     totals double-buffered).  Blocks of 256 threads, 2 an SM (at most 128
//     registers; 121 in bf16): 512 threads with the next row in flight
//     hold 32 KB.  3 an SM would cap the registers at 85, where the bf16
//     kernel spills 24 bytes (ptxas -v) and ran slower on an H100.  Fewer,
//     wider blocks keep the partial rows few: 264 of 8 KB at D = 2,048
//     (2.2 MB written and read, 2% of the bound's bytes), where 1,056
//     blocks of 128 threads would write 8.6 MB.
//   * up to 2,048 vectors: 4 or 8 vectors a thread, w read from L1 each row
//     and no prefetch (the registers hold the dw of 32-64 columns).
// At the end the lanes and rows of a block that share columns combine their
// dw in a fixed order into the block's partial row (part[block]).
// rmsnorm_dw_sum then adds the partial rows column by column: RL row lanes
// of CW columns a block, lane l summing parts l, l + RL, ... in order, then
// a halving tree over the lanes in shared memory, on ceil(D / CW) blocks
// (128 at D = 2,048), not one serial chain a column.  No atomics, and both
// grids depend on the shape only, so the same inputs give the same bits.
//
// Scalar path (any length and alignment, up to 16,384): rmsnorm_bwd_rows, a
// warp a row at a time, two passes over the row (the sums, then dx), each
// lane adding its columns' dw into its warp's row of shared memory (no two
// threads update one element); the block then sums its warps' rows in order
// into its partial row.  The launcher picks the path from D and the
// pointers, as the forward's does.

namespace {

constexpr int BWD_THREADS = 256;
// The H100's SMs.  The persistent grids are multiples of it, fixed here so
// that the grid, and so the order of every sum, depends on the shape only.
constexpr int BWD_SMS = 132;
constexpr int BWD_WARP_BPS = 4;       // warp layout: 256-thread blocks an SM
// Block layout with two vectors a thread: 256-thread blocks an SM (the
// launch bounds hold the kernel to the registers that allow them).
constexpr int BWD_BLOCK_BPS = 2;
constexpr int BWD_MAX_VEC = 2048;     // vectors a row on the vector path
constexpr int BWD_MAX_BLOCKS = 264;   // scalar path: 2 an SM
constexpr int BWD_SMEM = 64 * 1024;   // scalar path: the warps' dw rows

// Block layout: 256-thread blocks an SM that the registers allow.
template <int NV>
constexpr int bwd_block_bps() {
  return NV <= 2 ? BWD_BLOCK_BPS : NV == 4 ? 2 : 1;
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// (1 + w) for the N columns of vector v.
template <typename T>
__device__ __forceinline__ void load_w1(const float* __restrict__ w, int v,
                                        float (&w1)[Vec<T>::N]) {
  Weights<T> wv;
  wv.load(w, v);
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) w1[e] = 1.f + lane4(wv.g[e / 4], e % 4);
}

// ss += x^2 and dot += dy (1 + w) x over one held vector.
template <typename T>
__device__ __forceinline__ void add_sums(const uint4& xr, const uint4& gr,
                                         const float (&w1)[Vec<T>::N],
                                         float& ss, float& dot) {
  constexpr int N = Vec<T>::N;
  float xf[N], gf[N];
  Vec<T>::unpack(xr, xf);
  Vec<T>::unpack(gr, gf);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    ss = fmaf(xf[e], xf[e], ss);
    dot = fmaf(gf[e] * w1[e], xf[e], dot);
  }
}

// dx of one held vector, stored as vector v of the row dxr, and its dw
// terms dy x r added to acc.
template <typename T>
__device__ __forceinline__ void dx_store(const uint4& xr, const uint4& gr,
                                         const float (&w1)[Vec<T>::N],
                                         float r, float k, T* dxr, int v,
                                         float (&acc)[Vec<T>::N]) {
  constexpr int N = Vec<T>::N;
  float xf[N], gf[N], o[N];
  Vec<T>::unpack(xr, xf);
  Vec<T>::unpack(gr, gf);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    o[e] = r * (gf[e] * w1[e]) - xf[e] * k;
    acc[e] += gf[e] * xf[e] * r;
  }
  *reinterpret_cast<uint4*>(dxr + v * N) = Vec<T>::pack(o);
}

template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, bool live) {
  return live ? __ldg(reinterpret_cast<const uint4*>(p))
              : make_uint4(0, 0, 0, 0);
}

// LPR lanes a row, one vector a lane (vector li = lane % LPR), 32 / LPR
// rows a warp; the warp's rows are first + sub + k * stride.
template <typename T, int LPR>
__global__ void __launch_bounds__(BWD_THREADS, BWD_WARP_BPS)
    rmsnorm_bwd_vec_warp(const T* __restrict__ x, const float* __restrict__ w,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ part, long long rows, int d,
                         float eps) {
  constexpr int N = Vec<T>::N, RPW = 32 / LPR, WARPS = BWD_THREADS / 32;
  __shared__ float sdw[WARPS][LPR * N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % LPR, sub = lane / LPR;
  const bool col = li < d / N;
  const long long first = ((long long)blockIdx.x * WARPS + warp) * RPW;
  const long long stride = (long long)gridDim.x * WARPS * RPW;
  float w1[N], acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) w1[e] = acc[e] = 0.f;
  if (col) load_w1<T>(w, li, w1);
  long long row = first + sub;
  uint4 xc = load_vec(x + row * d + li * N, col && row < rows);
  uint4 gc = load_vec(dy + row * d + li * N, col && row < rows);
  // the loop's bound is the warp's first row: every lane joins the shuffles
  for (long long base = first; base < rows; base += stride, row += stride) {
    const long long next = row + stride;
    const uint4 xn = load_vec(x + next * d + li * N, col && next < rows);
    const uint4 gn = load_vec(dy + next * d + li * N, col && next < rows);
    float ss = 0.f, dot = 0.f;
    add_sums<T>(xc, gc, w1, ss, dot);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (col && row < rows) {
      const float r = rsqrtf(ss / (float)d + eps);
      const float k = dot * r * r * r / (float)d;
      dx_store<T>(xc, gc, w1, r, k, dx + row * d, li, acc);
    }
    xc = xn;
    gc = gn;
  }
  // the warp's rows that share columns, then the block's warps, in order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (sub == 0 && col) {
#pragma unroll
    for (int e = 0; e < N; ++e) sdw[warp][li * N + e] = acc[e];
  }
  __syncthreads();
  float* pr = part + (long long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += BWD_THREADS) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) t += sdw[i][c];
    pr[c] = t;
  }
}

// tpr threads a row (a multiple of 32), NV vectors a thread (vector tid +
// tpr * i), blockDim.x / tpr rows side by side; the block's rows are
// first + sub + k * stride.  PF (NV <= 2): (1 + w) held in registers and
// the next row loaded ahead.
template <typename T, int NV, bool PF = (NV <= 2)>
__global__ void __launch_bounds__(BWD_THREADS, bwd_block_bps<NV>())
    rmsnorm_bwd_vec_block(const T* __restrict__ x,
                          const float* __restrict__ w,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ part, long long rows, int d,
                          float eps, int tpr) {
  constexpr int N = Vec<T>::N, WARPS = BWD_THREADS / 32;
  // the rows' dw side by side: rb * d <= 2 * BWD_THREADS * N when NV = 2
  // (rb = 1 above)
  constexpr int SDW = PF ? 2 * BWD_THREADS * N : 4;
  __shared__ float2 tot[2][WARPS];
  __shared__ __align__(16) float sdw[SDW];
  const int sub = threadIdx.x / tpr, tid = threadIdx.x - sub * tpr;
  const int rb = blockDim.x / tpr, wpr = tpr >> 5, warp = threadIdx.x >> 5;
  const int nvec = d / N;
  const long long first = (long long)blockIdx.x * rb;
  const long long stride = (long long)gridDim.x * rb;
  float acc[NV][N];
  float w1[PF ? NV : 1][N];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[i][e] = 0.f;
    if constexpr (PF) {
#pragma unroll
      for (int e = 0; e < N; ++e) w1[i][e] = 0.f;
      if (tid + tpr * i < nvec) load_w1<T>(w, tid + tpr * i, w1[i]);
    }
  }
  long long row = first + sub;
  uint4 xc[NV], gc[NV];
  auto load_row = [&](long long rr, uint4 (&xa)[NV], uint4 (&ga)[NV]) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = tid + tpr * i;
      const bool live = rr < rows && v < nvec;
      xa[i] = load_vec(x + rr * d + v * N, live);
      ga[i] = load_vec(dy + rr * d + v * N, live);
    }
  };
  if constexpr (PF) load_row(row, xc, gc);
  int par = 0;
  // the loop's bound is the block's first row: every thread reaches the
  // barrier
  for (long long base = first; base < rows;
       base += stride, row += stride, par ^= 1) {
    uint4 xn[PF ? NV : 1], gn[PF ? NV : 1];
    if constexpr (PF) {
      load_row(row + stride, xn, gn);
    } else {
      load_row(row, xc, gc);
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = tid + tpr * i;
      if (v < nvec) {
        if constexpr (PF) {
          add_sums<T>(xc[i], gc[i], w1[i], ss, dot);
        } else {
          float wl[N];
          load_w1<T>(w, v, wl);
          add_sums<T>(xc[i], gc[i], wl, ss, dot);
        }
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if ((threadIdx.x & 31) == 0) tot[par][warp] = make_float2(ss, dot);
    __syncthreads();
    float s2 = 0.f, d2 = 0.f;
    for (int i = 0; i < wpr; ++i) {
      const float2 t = tot[par][sub * wpr + i];
      s2 += t.x;
      d2 += t.y;
    }
    if (row < rows) {
      const float r = rsqrtf(s2 / (float)d + eps);
      const float k = d2 * r * r * r / (float)d;
      T* dxr = dx + row * d;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = tid + tpr * i;
        if (v < nvec) {
          if constexpr (PF) {
            dx_store<T>(xc[i], gc[i], w1[i], r, k, dxr, v, acc[i]);
          } else {
            float wl[N];
            load_w1<T>(w, v, wl);
            dx_store<T>(xc[i], gc[i], wl, r, k, dxr, v, acc[i]);
          }
        }
      }
    }
    if constexpr (PF) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        xc[i] = xn[i];
        gc[i] = gn[i];
      }
    }
  }
  // the block's rows that share columns, in order
  float* pr = part + (long long)blockIdx.x * d;
  float* dst = rb == 1 ? pr : sdw + sub * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = tid + tpr * i;
    if (v < nvec) {
#pragma unroll
      for (int g = 0; g < N / 4; ++g)
        reinterpret_cast<float4*>(dst + v * N)[g] =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
    }
  }
  if (rb > 1) {
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float t = 0.f;
      for (int s = 0; s < rb; ++s) t += sdw[s * d + c];
      pr[c] = t;
    }
  }
}

// Scalar path: WARPS warps a block, a warp a row at a time over the rows
// blockIdx.x * WARPS + warp + k * gridDim.x * WARPS.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ w,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ part, long long rows, int d,
                     float eps) {
  extern __shared__ float sdw_rows[];  // warps x d
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* mine = sdw_rows + (long long)warp * d;
  for (int c = lane; c < d; c += 32) mine[c] = 0.f;
  const long long stride = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + warp; row < rows;
       row += stride) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.f, dot = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xv = to_f32(xr[c]), gv = to_f32(gr[c]);
      ss = fmaf(xv, xv, ss);
      dot = fmaf(gv * (1.f + w[c]), xv, dot);
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float r = rsqrtf(ss / (float)d + eps);
    const float k = dot * r * r * r / (float)d;
    T* dr = dx + row * d;
    for (int c = lane; c < d; c += 32) {
      const float xv = to_f32(xr[c]), gv = to_f32(gr[c]);
      store(dr + c, r * (1.f + w[c]) * gv - xv * k);
      mine[c] += gv * xv * r;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float t = 0.f;
    for (int i = 0; i < warps; ++i) t += sdw_rows[i * d + c];
    part[(long long)blockIdx.x * d + c] = t;
  }
}

// dw[c] = the sum of part[p][c] over the nparts partial rows: RL = 256 / CW
// row lanes of CW columns a block, lane l adding parts l, l + RL, ... in
// order, then a halving tree over the lanes.  nparts = 0 writes zeros.
template <int CW>
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_dw_sum(const float* __restrict__ part, float* __restrict__ dw,
                   int nparts, int d) {
  constexpr int RL = BWD_THREADS / CW;
  __shared__ float s[RL][CW];
  const int cl = threadIdx.x % CW, rl = threadIdx.x / CW;
  const int c = blockIdx.x * CW + cl;
  float t = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int p = rl; p < nparts; p += RL) t += part[(long long)p * d + c];
  }
  s[rl][cl] = t;
  __syncthreads();
#pragma unroll
  for (int h = RL / 2; h > 0; h >>= 1) {
    if (rl < h) s[rl][cl] += s[rl + h][cl];
    __syncthreads();
  }
  if (rl == 0 && c < d) dw[c] = s[0][cl];
}

// Columns a block of the dw sum: the widest of 32, 16, 8 that still gives
// 128 blocks, else 4.
inline int dw_columns(int d) {
  for (int cw = 32; cw > 4; cw >>= 1)
    if ((d + cw - 1) / cw >= 128) return cw;
  return 4;
}

int launch_dw_sum(const float* part, float* dw, int nparts, int d,
                  cudaStream_t s) {
  const int cw = dw_columns(d);
  const unsigned blocks = (unsigned)((d + cw - 1) / cw);
  switch (cw) {
    case 32:
      rmsnorm_dw_sum<32><<<blocks, BWD_THREADS, 0, s>>>(part, dw, nparts, d);
      break;
    case 16:
      rmsnorm_dw_sum<16><<<blocks, BWD_THREADS, 0, s>>>(part, dw, nparts, d);
      break;
    case 8:
      rmsnorm_dw_sum<8><<<blocks, BWD_THREADS, 0, s>>>(part, dw, nparts, d);
      break;
    default:
      rmsnorm_dw_sum<4><<<blocks, BWD_THREADS, 0, s>>>(part, dw, nparts, d);
  }
  return (int)cudaGetLastError();
}

// The warp layout's grid: 8 * 32 / LPR rows a block at a time.
template <int LPR>
inline long long warp_grid(long long rows) {
  constexpr long long per = (BWD_THREADS / 32) * (32 / LPR);
  const long long need = (rows + per - 1) / per;
  return need < BWD_SMS * BWD_WARP_BPS ? need : BWD_SMS * BWD_WARP_BPS;
}

struct BlockShape {
  int tpr, threads;
  long long blocks;
};

// The block layout for rows of nvec vectors, NV a thread.
template <int NV>
inline BlockShape block_shape(long long rows, int nvec) {
  const int tpr = (nvec + 32 * NV - 1) / (32 * NV) * 32;
  const int rb = BWD_THREADS / tpr;
  const int threads = rb * tpr;
  const int per_sm = bwd_block_bps<NV>() * BWD_THREADS / threads;
  const long long cap = (long long)BWD_SMS * (per_sm > 1 ? per_sm : 1);
  const long long need = (rows + rb - 1) / rb;
  return {tpr, threads, need < cap ? need : cap};
}

// The vector path's grid (its partial rows) for rows of nvec vectors.
inline long long vec_grid(long long rows, int nvec) {
  if (nvec <= 2) return warp_grid<2>(rows);
  if (nvec <= 4) return warp_grid<4>(rows);
  if (nvec <= 8) return warp_grid<8>(rows);
  if (nvec <= 16) return warp_grid<16>(rows);
  if (nvec <= 32) return warp_grid<32>(rows);
  if (nvec <= 2 * BWD_THREADS) return block_shape<2>(rows, nvec).blocks;
  if (nvec <= 4 * BWD_THREADS) return block_shape<4>(rows, nvec).blocks;
  return block_shape<8>(rows, nvec).blocks;
}

template <typename T, int LPR>
int bwd_warp(const T* x, const float* w, const T* dy, T* dx, float* part,
             long long rows, int d, float eps, cudaStream_t s) {
  rmsnorm_bwd_vec_warp<T, LPR><<<(unsigned)warp_grid<LPR>(rows), BWD_THREADS,
                                 0, s>>>(x, w, dy, dx, part, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
int bwd_block(const T* x, const float* w, const T* dy, T* dx, float* part,
              long long rows, int d, float eps, cudaStream_t s) {
  const BlockShape b = block_shape<NV>(rows, d / Vec<T>::N);
  rmsnorm_bwd_vec_block<T, NV><<<(unsigned)b.blocks, b.threads, 0, s>>>(
      x, w, dy, dx, part, rows, d, eps, b.tpr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec_bwd(const T* x, const float* w, const T* dy, T* dx,
                   float* part, long long rows, int d, float eps,
                   cudaStream_t s) {
  const int nvec = d / Vec<T>::N;
  if (nvec <= 2) return bwd_warp<T, 2>(x, w, dy, dx, part, rows, d, eps, s);
  if (nvec <= 4) return bwd_warp<T, 4>(x, w, dy, dx, part, rows, d, eps, s);
  if (nvec <= 8) return bwd_warp<T, 8>(x, w, dy, dx, part, rows, d, eps, s);
  if (nvec <= 16)
    return bwd_warp<T, 16>(x, w, dy, dx, part, rows, d, eps, s);
  if (nvec <= 32)
    return bwd_warp<T, 32>(x, w, dy, dx, part, rows, d, eps, s);
  if (nvec <= 2 * BWD_THREADS)
    return bwd_block<T, 2>(x, w, dy, dx, part, rows, d, eps, s);
  if (nvec <= 4 * BWD_THREADS)
    return bwd_block<T, 4>(x, w, dy, dx, part, rows, d, eps, s);
  return bwd_block<T, 8>(x, w, dy, dx, part, rows, d, eps, s);
}

// Whether rows of d elements of size bytes take the vector path.
inline bool vec_rows(int d, int size) {
  const int n = 16 / size;
  return d % n == 0 && d / n <= BWD_MAX_VEC;
}

// The scalar path's warps a block for rows of d: 8, or fewer so that their
// dw rows fit BWD_SMEM; 0 when one row does not.
inline int scalar_warps(int d) {
  int warps = BWD_THREADS / 32;
  while (warps > 0 && (long long)warps * d * 4 > BWD_SMEM) warps >>= 1;
  return warps;
}

inline long long scalar_grid(long long rows, int d) {
  const int warps = scalar_warps(d);
  if (warps == 0) return 0;
  const long long need = (rows + warps - 1) / warps;
  return need < BWD_MAX_BLOCKS ? need : BWD_MAX_BLOCKS;
}

// Opts the scalar kernel in to BWD_SMEM of dynamic shared memory, once a
// device.
template <typename T>
int scalar_opt_in() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < 64 && done[dev]) return 0;
  e = cudaFuncSetAttribute(rmsnorm_bwd_rows<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BWD_SMEM);
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return (int)e;
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               float* part, float* dw, long long rows, int d, float eps,
               void* stream) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long nparts = 0;
  if (rows > 0) {
    const uintptr_t bases =
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx);
    int rc;
    if (vec_rows(d, sizeof(T)) && bases % 16 == 0) {
      nparts = vec_grid(rows, d / Vec<T>::N);
      rc = launch_vec_bwd<T>((const T*)x, (const float*)w, (const T*)dy,
                             (T*)dx, part, rows, d, eps, s);
    } else {
      const int warps = scalar_warps(d);
      if (warps == 0) return (int)cudaErrorInvalidValue;
      rc = scalar_opt_in<T>();
      if (rc != 0) return rc;
      nparts = scalar_grid(rows, d);
      rmsnorm_bwd_rows<T><<<(unsigned)nparts, warps * 32,
                            (size_t)warps * d * 4, s>>>(
          (const T*)x, (const float*)w, (const T*)dy, (T*)dx, part, rows, d,
          eps);
      rc = (int)cudaGetLastError();
    }
    if (rc != 0) return rc;
  }
  return launch_dw_sum(part, dw, (int)nparts, d, s);
}

}  // namespace

// The number of float32 partial rows of d the backward needs: the most that
// either path takes for either dtype (the path depends on the pointers);
// 0 when rows of d are too long for the kernels.
extern "C" long long rmsnorm_bwd_parts(long long rows, int d) {
  long long n = scalar_grid(rows, d);
  if (n == 0 || rows <= 0) return 0;
  const long long f32 = vec_rows(d, 4) ? vec_grid(rows, d / 4) : 0;
  const long long bf16 = vec_rows(d, 2) ? vec_grid(rows, d / 8) : 0;
  if (f32 > n) n = f32;
  return bf16 > n ? bf16 : n;
}

// x, dy, dx: contiguous (rows, d) of one dtype; w: float32 (d,); part:
// float32 (rmsnorm_bwd_parts(rows, d), d) scratch; dw: float32 (d,), written
// in full.
extern "C" int rmsnorm_bwd_f32(const void* x, const void* w, const void* dy,
                               void* dx, float* part, float* dw,
                               long long rows, int d, float eps,
                               void* stream) {
  return launch_bwd<float>(x, w, dy, dx, part, dw, rows, d, eps, stream);
}

extern "C" int rmsnorm_bwd_bf16(const void* x, const void* w, const void* dy,
                                void* dx, float* part, float* dw,
                                long long rows, int d, float eps,
                                void* stream) {
  return launch_bwd<__nv_bfloat16>(x, w, dy, dx, part, dw, rows, d, eps,
                                   stream);
}

// ---------------------------------------------------------------------------
// Rows cut over ranks.  Under tensor parallelism a rank holds d of each row's
// D columns (Mamba2's gated norm on a rank's heads), and the row's mean of
// squares needs the other ranks' sums.  Three entries, a warp a row, with
// 16-byte vectors where d fills whole vectors and every base is 16-byte
// aligned, scalars otherwise:
//   rmsnorm_row_sums_*: each row's partial sum over the rank's columns,
//     sum x^2 (dy null) or sum dy (1 + w) x: one float32 a row, which the
//     caller all-reduces over the ranks;
//   rmsnorm_cut_*: y = x * rsqrt(ss / D + eps) * (1 + w) from each row's
//     all-reduced ss;
//   rmsnorm_cut_bwd_*: dx = r (1 + w) dy - x r^3 / D * dot from each row's
//     all-reduced ss and dot; dw through per-block partial rows (each warp
//     adds its rows into its own row of shared memory, the block then sums
//     its warps' rows in order), then rmsnorm_dw_sum.  No atomics, and the
//     grids depend on the shape only: the same inputs give the same bits.
// Bound on the card: memory, as the whole-row kernels' (the sums add 4 bytes
// a row).

namespace {

// A warp's sum over the d columns of one row: x^2, or with g, g (1 + w) x.
template <typename T, bool VEC>
__device__ __forceinline__ float row_part(const T* __restrict__ xr,
                                          const T* __restrict__ gr,
                                          const float* __restrict__ w, int d,
                                          int lane) {
  float s = 0.f;
  if constexpr (VEC) {
    constexpr int N = Vec<T>::N;
    for (int v = lane; v < d / N; v += 32) {
      float xf[N];
      Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(xr + v * N)), xf);
      if (gr == nullptr) {
#pragma unroll
        for (int e = 0; e < N; ++e) s = fmaf(xf[e], xf[e], s);
      } else {
        float gf[N], w1[N];
        Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(gr + v * N)), gf);
        load_w1<T>(w, v, w1);
#pragma unroll
        for (int e = 0; e < N; ++e) s = fmaf(gf[e] * w1[e], xf[e], s);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float xv = to_f32(xr[c]);
      s = gr == nullptr ? fmaf(xv, xv, s)
                        : fmaf(to_f32(gr[c]) * (1.f + w[c]), xv, s);
    }
  }
  return warp_sum(s);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_row_sums(const T* __restrict__ x, const float* __restrict__ w,
                     const T* __restrict__ dy, float* __restrict__ out,
                     long long rows, int d) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (BWD_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const float s = row_part<T, VEC>(
      x + row * d, dy == nullptr ? nullptr : dy + row * d, w, d, lane);
  if (lane == 0) out[row] = s;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_cut_rows(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ ss, T* __restrict__ out,
                     long long rows, int d, float width, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (BWD_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float r = rsqrtf(ss[row] / width + eps);
  const T* xr = x + row * d;
  T* yr = out + row * d;
  if constexpr (VEC) {
    constexpr int N = Vec<T>::N;
    for (int v = lane; v < d / N; v += 32) {
      Weights<T> wv;
      wv.load(w, v);
      normalise_store<T>(__ldg(reinterpret_cast<const uint4*>(xr + v * N)),
                         wv, v, yr, r);
    }
  } else {
    for (int c = lane; c < d; c += 32)
      store(yr + c, to_f32(xr[c]) * r * (1.f + w[c]));
  }
}

// WARPS warps a block (blockDim.x / 32), a warp a row at a time over the rows
// blockIdx.x * warps + warp + k * gridDim.x * warps.
template <typename T, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_cut_bwd_rows(const T* __restrict__ x, const float* __restrict__ w,
                         const T* __restrict__ dy,
                         const float* __restrict__ ss,
                         const float* __restrict__ dot, T* __restrict__ dx,
                         float* __restrict__ part, long long rows, int d,
                         float width, float eps) {
  extern __shared__ float sdw_cut[];  // warps x d
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* mine = sdw_cut + (long long)warp * d;
  for (int c = lane; c < d; c += 32) mine[c] = 0.f;
  const long long stride = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + warp; row < rows;
       row += stride) {
    const float r = rsqrtf(ss[row] / width + eps);
    const float k = dot[row] * r * r * r / width;
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    T* dr = dx + row * d;
    if constexpr (VEC) {
      constexpr int N = Vec<T>::N;
      for (int v = lane; v < d / N; v += 32) {
        float w1[N], acc[N];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = 0.f;
        load_w1<T>(w, v, w1);
        dx_store<T>(__ldg(reinterpret_cast<const uint4*>(xr + v * N)),
                    __ldg(reinterpret_cast<const uint4*>(gr + v * N)), w1, r,
                    k, dr, v, acc);
#pragma unroll
        for (int e = 0; e < N; ++e) mine[v * N + e] += acc[e];
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float xv = to_f32(xr[c]), gv = to_f32(gr[c]);
        store(dr + c, r * (1.f + w[c]) * gv - xv * k);
        mine[c] += gv * xv * r;
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float t = 0.f;
    for (int i = 0; i < warps; ++i) t += sdw_cut[i * d + c];
    part[(long long)blockIdx.x * d + c] = t;
  }
}

// Opts a kernel in to BWD_SMEM of dynamic shared memory, once a device.
template <typename K>
int cut_opt_in(K kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < 64 && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BWD_SMEM);
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return (int)e;
}

template <typename T>
bool cut_vec(int d, uintptr_t bases) {
  return d % Vec<T>::N == 0 && bases % 16 == 0;
}

inline unsigned warp_blocks(long long rows) {
  return (unsigned)((rows + BWD_THREADS / 32 - 1) / (BWD_THREADS / 32));
}

template <typename T>
int launch_row_sums(const void* x, const void* w, const void* dy, float* out,
                    long long rows, int d, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || (rows + 7) / 8 > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(dy) |
                          reinterpret_cast<uintptr_t>(w);
  if (cut_vec<T>(d, bases))
    rmsnorm_row_sums<T, true><<<warp_blocks(rows), BWD_THREADS, 0, s>>>(
        (const T*)x, (const float*)w, (const T*)dy, out, rows, d);
  else
    rmsnorm_row_sums<T, false><<<warp_blocks(rows), BWD_THREADS, 0, s>>>(
        (const T*)x, (const float*)w, (const T*)dy, out, rows, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cut(const void* x, const void* w, const float* ss, void* out,
               long long rows, int d, float width, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || (rows + 7) / 8 > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  if (cut_vec<T>(d, bases))
    rmsnorm_cut_rows<T, true><<<warp_blocks(rows), BWD_THREADS, 0, s>>>(
        (const T*)x, (const float*)w, ss, (T*)out, rows, d, width, eps);
  else
    rmsnorm_cut_rows<T, false><<<warp_blocks(rows), BWD_THREADS, 0, s>>>(
        (const T*)x, (const float*)w, ss, (T*)out, rows, d, width, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int cut_bwd(const void* x, const void* w, const void* dy, const float* ss,
            const float* dot, void* dx, float* part, long long rows, int d,
            float width, float eps, cudaStream_t s, long long nparts,
            int warps) {
  static bool done[64] = {};
  const int rc = cut_opt_in(rmsnorm_cut_bwd_rows<T, VEC>, done);
  if (rc != 0) return rc;
  rmsnorm_cut_bwd_rows<T, VEC><<<(unsigned)nparts, warps * 32,
                                 (size_t)warps * d * 4, s>>>(
      (const T*)x, (const float*)w, (const T*)dy, ss, dot, (T*)dx, part, rows,
      d, width, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cut_bwd(const void* x, const void* w, const void* dy,
                   const float* ss, const float* dot, void* dx, float* part,
                   float* dw, long long rows, int d, float width, float eps,
                   void* stream) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long nparts = 0;
  if (rows > 0) {
    const int warps = scalar_warps(d);
    if (warps == 0) return (int)cudaErrorInvalidValue;
    nparts = scalar_grid(rows, d);
    const uintptr_t bases =
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx);
    const int rc =
        cut_vec<T>(d, bases)
            ? cut_bwd<T, true>(x, w, dy, ss, dot, dx, part, rows, d, width,
                               eps, s, nparts, warps)
            : cut_bwd<T, false>(x, w, dy, ss, dot, dx, part, rows, d, width,
                                eps, s, nparts, warps);
    if (rc != 0) return rc;
  }
  return launch_dw_sum(part, dw, (int)nparts, d, s);
}

}  // namespace

// x, dy: contiguous (rows, d) of one dtype (dy null: sum x^2); w: float32
// (d,); out: float32 (rows,).
extern "C" int rmsnorm_row_sums_f32(const void* x, const void* w,
                                    const void* dy, float* out,
                                    long long rows, int d, void* stream) {
  return launch_row_sums<float>(x, w, dy, out, rows, d, stream);
}

extern "C" int rmsnorm_row_sums_bf16(const void* x, const void* w,
                                     const void* dy, float* out,
                                     long long rows, int d, void* stream) {
  return launch_row_sums<__nv_bfloat16>(x, w, dy, out, rows, d, stream);
}

// ss: float32 (rows,), each row's sum of squares over its whole width.
extern "C" int rmsnorm_cut_f32(const void* x, const void* w, const float* ss,
                               void* out, long long rows, int d, float width,
                               float eps, void* stream) {
  return launch_cut<float>(x, w, ss, out, rows, d, width, eps, stream);
}

extern "C" int rmsnorm_cut_bf16(const void* x, const void* w,
                                const float* ss, void* out, long long rows,
                                int d, float width, float eps, void* stream) {
  return launch_cut<__nv_bfloat16>(x, w, ss, out, rows, d, width, eps,
                                   stream);
}

// ss, dot: float32 (rows,), each row's sums over its whole width; part:
// float32 (rmsnorm_bwd_parts(rows, d), d) scratch; dw: float32 (d,).
extern "C" int rmsnorm_cut_bwd_f32(const void* x, const void* w,
                                   const void* dy, const float* ss,
                                   const float* dot, void* dx, float* part,
                                   float* dw, long long rows, int d,
                                   float width, float eps, void* stream) {
  return launch_cut_bwd<float>(x, w, dy, ss, dot, dx, part, dw, rows, d,
                               width, eps, stream);
}

extern "C" int rmsnorm_cut_bwd_bf16(const void* x, const void* w,
                                    const void* dy, const float* ss,
                                    const float* dot, void* dx, float* part,
                                    float* dw, long long rows, int d,
                                    float width, float eps, void* stream) {
  return launch_cut_bwd<__nv_bfloat16>(x, w, dy, ss, dot, dx, part, dw, rows,
                                       d, width, eps, stream);
}
