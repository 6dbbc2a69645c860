// Diagonal linear recurrence (the RG-LRU core) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/linear_recurrence.py
// (linear_recurrence: _kernel).  a, b, out: (B, T, D), contiguous, float32
// or bfloat16 (a and b of one type); h_t = a_t * h_{t-1} + b_t from h_0 = 0
// in float32, written in the input type.  With the shared -fmad=false the
// step is a rounded multiply then a rounded add, as the sequential oracle
// (repro_torch.kernels.ref.linear_recurrence_ref) computes it.
//
// Bound on the card: memory.  Each element of a and b is read once and of
// out written once (12 bytes a step in float32) for two flops.  The TPU
// kernel scanned 256-step time blocks in VMEM (Hillis-Steele, log2(256)
// passes over the block) and carried h across the sequential time grid.
// Here the carry is a register: one thread owns one (batch, channel) and
// walks T, so the only serial chain is one multiply-add a step.  Loads do
// not depend on h, so each thread issues the next U steps' loads before it
// computes the current U (a register double buffer), keeping 2 * U loads
// in flight per thread; neighbouring threads own neighbouring channels, so
// every load and store coalesces along D.  Steps past T are the identity
// map (a = 1, b = 0), the TPU wrapper's padding, and are not stored.
// Weakness: B * D threads (8,192 at recurrentgemma-9b's width) are few
// for the card, so the memory pipe is not full; a chunked scan over T
// with a carry pass is the next step.
#include <cuda_bf16.h>

namespace {

constexpr int TPB = 32;  // threads (channels) per block
constexpr int U = 16;    // time steps per prefetch group

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ a,
                                           const T* __restrict__ b, int t0,
                                           int t_len, long long d,
                                           float* ga, float* gb) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    const bool in = t < t_len;
    ga[u] = in ? to_f32(a[t * d]) : 1.f;
    gb[u] = in ? to_f32(b[t * d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(TPB)
    linear_recurrence_kernel(const T* __restrict__ a,
                             const T* __restrict__ b, T* __restrict__ out,
                             int t_len, int d) {
  const int c = blockIdx.x * TPB + threadIdx.x;
  if (c >= d) return;
  const long long base = (long long)blockIdx.y * t_len * d + c;
  const T* ap = a + base;
  const T* bp = b + base;
  T* op = out + base;
  float ca[U], cb[U], na[U], nb[U];
  load_group(ap, bp, 0, t_len, d, ca, cb);
  float h = 0.f;
  for (int t0 = 0; t0 < t_len; t0 += U) {
    load_group(ap, bp, t0 + U, t_len, d, na, nb);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = ca[u] * h + cb[u];
      if (t0 + u < t_len) store(op + (long long)(t0 + u) * d, h);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int batch, int t_len,
           int d, void* stream) {
  if (batch <= 0 || t_len <= 0 || d <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((d + TPB - 1) / TPB, batch);
  linear_recurrence_kernel<T><<<grid, TPB, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (T*)out, t_len, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int linear_recurrence_f32(const void* a, const void* b, void* out,
                                     int batch, int t_len, int d,
                                     void* stream) {
  return launch<float>(a, b, out, batch, t_len, d, stream);
}

extern "C" int linear_recurrence_bf16(const void* a, const void* b, void* out,
                                      int batch, int t_len, int d,
                                      void* stream) {
  return launch<__nv_bfloat16>(a, b, out, batch, t_len, d, stream);
}
