// Row-wise RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm: _kernel).
// Per row of a (rows, D) view: y = x * rsqrt(mean(x^2) + eps) * (1 + w),
// computed in float32 and written in the input type (float or bfloat16);
// w is float32 (D,).
//
// Bound on the card: memory.  Each element is read once and written once
// (4 bytes a value in bf16, 8 in f32) for about four flops; w stays in L1.
// The TPU kernel normalised 256-row blocks resident in VMEM.  Here a warp
// owns a row when D <= 256 (the q/k-norm rows of 128: eight rows to a
// block), and a block of 256 threads owns a row otherwise (D = 2048..4096:
// 8-16 elements a thread).  The sum of squares is a warp-shuffle reduction,
// then (block path) one pass over the warp totals in shared memory.  The
// second pass re-reads the row, which the first left in L1.  Weakness:
// scalar loads (2 bytes a thread in bf16); 16-byte vector loads are the
// next step.
#include <cuda_bf16.h>

#include <climits>

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

template <typename T>
int launch(const void* x, const void* w, void* out, long long rows, int d,
           float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
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
