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
// row in 1024-element blocks on a sequential grid with the carry in SMEM;
// here one thread block owns one row and walks it in chunks of up to 1024
// elements (coalesced loads, warp-shuffle scan, carry in a register), so
// rows scan in parallel across SMs.  Weakness: a single long row runs
// serially on one SM; a decoupled look-back scan across blocks is the fix.
#include <cstdint>
#include <limits>

#include "maxplus.cuh"

template <typename T>
__global__ void scan_rows_kernel(const T* __restrict__ issue,
                                 const T* __restrict__ svc,
                                 const uint8_t* __restrict__ seg,
                                 T* __restrict__ out, long long n, T ninf) {
  __shared__ T sh_a[32];
  __shared__ T sh_b[32];
  __shared__ T sh_carry;
  const long long base = (long long)blockIdx.x * n;
  T carry = ninf;
  for (long long s = 0; s < n; s += blockDim.x) {
    const long long i = s + threadIdx.x;
    T a = T(0), b = ninf;          // identity map past the row end
    if (i < n) {
      const T v = svc[base + i];
      a = seg[base + i] ? ninf : v;
      b = issue[base + i] + v;
    }
    block_scan(a, b, sh_a, sh_b, ninf);
    const T c = tmax(carry + a, b);
    if (i < n) out[base + i] = c;
    if (threadIdx.x == blockDim.x - 1) sh_carry = c;
    __syncthreads();
    carry = sh_carry;
  }
}

template <typename T>
static int launch_rows(const void* issue, const void* svc, const void* seg,
                       void* out, long long rows, long long n, void* stream,
                       T ninf) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  scan_rows_kernel<T><<<(unsigned)rows, scan_threads(n), 0,
                        (cudaStream_t)stream>>>(
      (const T*)issue, (const T*)svc, (const uint8_t*)seg, (T*)out, n, ninf);
  return (int)cudaGetLastError();
}

extern "C" int zns_scan_rows_f32(const void* issue, const void* svc,
                                 const void* seg, void* out, long long rows,
                                 long long n, void* stream) {
  return launch_rows<float>(issue, svc, seg, out, rows, n, stream, -1e30f);
}

extern "C" int zns_scan_rows_f64(const void* issue, const void* svc,
                                 const void* seg, void* out, long long rows,
                                 long long n, void* stream) {
  return launch_rows<double>(issue, svc, seg, out, rows, n, stream,
                             -std::numeric_limits<double>::infinity());
}
