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
// `rmsnorm_bwd_rows`: WARPS warps a block, a warp a row at a time over the
// rows blockIdx.x * WARPS + warp + k * gridDim.x * WARPS; two passes over the
// row (the sums, then dx), each lane accumulating its columns' dw into the
// warp's own row of shared memory (no two threads update one element).  The
// block then sums its warps' rows in order into its partial row.
// `rmsnorm_dw_sum` sums the partial rows in block order.  No atomics, and
// the grid depends on the shape only, so the same inputs give the same bits.
// Bound on the card: memory (x and dy read, dx written; the second pass
// hits L1 / L2 for rows of a few KB).

namespace {

constexpr int BWD_THREADS = 256;
constexpr int BWD_MAX_BLOCKS = 264;          // 2 an SM
constexpr int BWD_SMEM = 64 * 1024;          // the warps' dw rows, at most

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ w,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ part, long long rows, int d,
                     float eps) {
  extern __shared__ float sdw[];  // warps x d
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* mine = sdw + (long long)warp * d;
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
    for (int i = 0; i < warps; ++i) t += sdw[i * d + c];
    part[(long long)blockIdx.x * d + c] = t;
  }
}

__global__ void rmsnorm_dw_sum(const float* __restrict__ part,
                               float* __restrict__ dw, int nparts, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float t = 0.f;
  for (int i = 0; i < nparts; ++i) t += part[(long long)i * d + c];
  dw[c] = t;
}

// Warps a block of the backward for rows of d: 8, or fewer so that their
// dw rows fit BWD_SMEM; 0 when one row does not.
inline int bwd_warps(int d) {
  int warps = BWD_THREADS / 32;
  while (warps > 0 && (long long)warps * d * 4 > BWD_SMEM) warps >>= 1;
  return warps;
}

// Blocks of the backward's grid (the partial rows the wrapper allocates).
inline long long bwd_blocks(long long rows, int d) {
  const int warps = bwd_warps(d);
  if (warps == 0) return 0;
  const long long need = (rows + warps - 1) / warps;
  return need < BWD_MAX_BLOCKS ? need : BWD_MAX_BLOCKS;
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               float* part, float* dw, long long rows, int d, float eps,
               void* stream) {
  if (rows <= 0) return 0;
  const int warps = bwd_warps(d);
  if (d <= 0 || warps == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto kern = rmsnorm_bwd_rows<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = bwd_blocks(rows, d);
  kern<<<(unsigned)blocks, warps * 32, (size_t)warps * d * 4, s>>>(
      (const T*)x, (const float*)w, (const T*)dy, (T*)dx, part, rows, d, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_dw_sum<<<(d + 255) / 256, 256, 0, s>>>(part, dw, (int)blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of float32 partial rows of d the backward needs (its grid).
extern "C" long long rmsnorm_bwd_parts(long long rows, int d) {
  return bwd_blocks(rows, d);
}

// x, dy, dx: contiguous (rows, d) of one dtype; w: float32 (d,); part:
// float32 (rmsnorm_bwd_parts(rows, d), d) scratch; dw: float32 (d,).
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
