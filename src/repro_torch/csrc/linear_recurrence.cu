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
// out written once (12 bytes a step in float32) for two flops: 302 MB at
// recurrentgemma-9b's (2, 3072, 4096), 0.090 ms at 3.35 TB/s.  The TPU
// kernel scanned 256-step time blocks in VMEM (Hillis-Steele, log2(256)
// passes over the block) and carried h across the sequential time grid.
// Here one thread owns one (batch, channel) and walks T, so the only
// serial chain is one multiply and one add a step, in the oracle's order:
// the float32 kernel equals it bit for bit.  A chunked scan over T (more
// threads, a carry pass) was not taken: it reorders the products and loses
// that equality, and the thread count is not what bounds the kernel.
//
// What bounds it is Little's law: streaming at 3.35 TB/s with ~600 ns of
// latency needs ~2 MB of loads in flight.  A register prefetch of 16 steps
// of a and b a thread is 128 bytes, ~1 MB over the 8,192 threads of the
// model's shape, and registers cannot hold much more (two arrays, double
// buffered, at 64 steps is 256 registers).  So the bytes wait in shared
// memory: a block of CH = 64 channels stages tiles of (TS steps x 64
// channels) of a and b, 32 KB a tile (TS = 64 in float32, 128 in
// bfloat16), into a ring of 4 stages with 16-byte cp.async copies
// coalesced along D, issued by all 64 threads.  Three tiles are in flight
// while the fourth is consumed: 96 KB a block, 12 MB over the 128 blocks
// at the model's shape.  The threads read their steps from shared memory
// and store h straight to out (coalesced along D).
// Rows that are not 16-byte aligned (D * element size not a multiple of
// 16, or an offset view) are copied element by element in the same place.
// Steps past T are the identity map and are neither computed nor stored.
//
// The backward (linear_recurrence_bwd_kernel; the TPU package has no
// backward kernel, its gradients are XLA's autodiff of the sequential
// oracle): from the forward's h and the output gradient dh, the reverse
// scan g_t = dh_t + a_{t+1} g_{t+1} (a_{T+1} = 0), then db_t = g_t and
// da_t = g_t h_{t-1} (h_0 = 0), in float32, written in the input type.
// The forward's layout walked the other way: one thread per (batch,
// channel) walks T from the end, fed from a ring of 4 stages of tiles
// holding a_t, dh_t and h_{t-1} (the h rows shifted by one step, so a tile
// holds all a step needs; row -1 is zero-filled), issued last tile first.
// a_{t+1} and g_{t+1} are carried in registers.  Bound: memory, 20 bytes a
// step in float32 (a, h, dh read, da, db written): 336 MB at
// recurrentgemma-9b's training shape (1, 4096, 4096), 0.100 ms at 3.35
// TB/s.  A block is one warp of channels (BCH = 32), so batch 1 at D 4,096
// still gives 128 blocks; a tile is 48 KB (128 float32 or 256 bfloat16
// steps of three arrays), the ring 192 KB a block.
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int CH = 64;                // channels (threads) a block
constexpr int STAGES = 4;             // tiles in the ring
constexpr int TILE_BYTES = 32768;     // a and b of one tile
constexpr int SMEM = STAGES * TILE_BYTES;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(CH)
    linear_recurrence_kernel(const T* __restrict__ a,
                             const T* __restrict__ b, T* __restrict__ out,
                             int t_len, int d, int vec) {
  constexpr int TS = TILE_BYTES / (2 * CH * (int)sizeof(T));  // steps
  constexpr int VEC = 16 / (int)sizeof(T);   // elements a 16-byte copy
  constexpr int CPR = CH / VEC;              // copies a tile row
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);     // stage s: a (TS x CH), b
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CH;
  const long long base = (long long)blockIdx.y * t_len * d;
  const int ntiles = (t_len + TS - 1) / TS;

  // Tile k into stage k % STAGES; one copy group a tile, empty past the end.
  auto issue = [&](int k) {
    if (k < ntiles) {
      T* sa = ring + (k % STAGES) * 2 * TS * CH;
      T* sb = sa + TS * CH;
      const int t0 = k * TS;
      if (vec) {
        for (int i = tid; i < TS * CPR; i += CH) {
          const int r = i / CPR, q = (i - r * CPR) * VEC;
          const int t = t0 + r, c = c0 + q;
          if (t < t_len && c < d) {  // d % VEC == 0: the copy is in range
            const long long off = base + (long long)t * d + c;
            cp_async16(smem_u32(sa + r * CH + q), a + off);
            cp_async16(smem_u32(sb + r * CH + q), b + off);
          }
        }
      } else {  // rows not 16-byte aligned: element by element
        const int c = c0 + tid;
        for (int r = 0; r < TS; ++r) {
          const int t = t0 + r;
          if (t < t_len && c < d) {
            const long long off = base + (long long)t * d + c;
            sa[r * CH + tid] = a[off];
            sb[r * CH + tid] = b[off];
          }
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  const int c = c0 + tid;
  T* op = out + base + c;
  float h = 0.f;
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile k landed
    __syncthreads();              // everyone's; and tile k - 1 is consumed
    issue(k + STAGES - 1);        // into tile k - 1's stage
    const T* sa = ring + (k % STAGES) * 2 * TS * CH + tid;
    const T* sb = sa + TS * CH;
    const int t0 = k * TS;
    if (c < d) {
      if (t0 + TS <= t_len) {
#pragma unroll 16
        for (int u = 0; u < TS; ++u) {
          h = to_f32(sa[u * CH]) * h + to_f32(sb[u * CH]);
          store(op + (long long)(t0 + u) * d, h);
        }
      } else {
        for (int u = 0; u < t_len - t0; ++u) {
          h = to_f32(sa[u * CH]) * h + to_f32(sb[u * CH]);
          store(op + (long long)(t0 + u) * d, h);
        }
      }
    }
  }
}

constexpr int BCH = 32;                // channels (threads) a backward block
constexpr int BWD_TILE_BYTES = 49152;  // a, dh and h_{t-1} of one tile
constexpr int BWD_SMEM = STAGES * BWD_TILE_BYTES;

template <typename T>
__global__ void __launch_bounds__(BCH)
    linear_recurrence_bwd_kernel(const T* __restrict__ a,
                                 const T* __restrict__ h,
                                 const T* __restrict__ dh,
                                 T* __restrict__ da, T* __restrict__ db,
                                 int t_len, int d, int vec) {
  constexpr int TS = BWD_TILE_BYTES / (3 * BCH * (int)sizeof(T));  // steps
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CPR = BCH / VEC;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);  // stage s: a, dh, h_prev (TS x BCH)
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BCH;
  const long long base = (long long)blockIdx.y * t_len * d;
  const int ntiles = (t_len + TS - 1) / TS;

  // The r-th tile from the end into stage r % STAGES; one copy group.
  auto issue = [&](int r) {
    if (r < ntiles) {
      T* sa = ring + (r % STAGES) * 3 * TS * BCH;
      T* sg = sa + TS * BCH;
      T* sh = sg + TS * BCH;
      const int t0 = (ntiles - 1 - r) * TS;
      if (vec) {
        for (int i = tid; i < TS * CPR; i += BCH) {
          const int row = i / CPR, q = (i - row * CPR) * VEC;
          const int t = t0 + row, c = c0 + q;
          if (t < t_len && c < d) {
            const long long off = base + (long long)t * d + c;
            cp_async16(smem_u32(sa + row * BCH + q), a + off);
            cp_async16(smem_u32(sg + row * BCH + q), dh + off);
            if (t > 0)
              cp_async16(smem_u32(sh + row * BCH + q), h + off - d);
            else
              *reinterpret_cast<float4*>(sh + row * BCH + q) =
                  make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      } else {  // rows not 16-byte aligned: element by element
        const int c = c0 + tid;
        for (int row = 0; row < TS; ++row) {
          const int t = t0 + row;
          if (t < t_len && c < d) {
            const long long off = base + (long long)t * d + c;
            sa[row * BCH + tid] = a[off];
            sg[row * BCH + tid] = dh[off];
            if (t > 0)
              sh[row * BCH + tid] = h[off - d];
            else
              store(sh + row * BCH + tid, 0.f);
          }
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int r = 0; r < STAGES - 1; ++r) issue(r);
  const int c = c0 + tid;
  float g = 0.f, an = 0.f;  // g_{t+1} and a_{t+1}
  for (int r = 0; r < ntiles; ++r) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile r landed
    __syncthreads();              // everyone's; and tile r - 1 is consumed
    issue(r + STAGES - 1);        // into tile r - 1's stage
    const T* sa = ring + (r % STAGES) * 3 * TS * BCH + tid;
    const T* sg = sa + TS * BCH;
    const T* sh = sg + TS * BCH;
    const int t0 = (ntiles - 1 - r) * TS;
    T* pa = da + base + (long long)t0 * d + c;
    T* pb = db + base + (long long)t0 * d + c;
    if (c < d) {
      if (t0 + TS <= t_len) {
#pragma unroll 16
        for (int u = TS - 1; u >= 0; --u) {
          g = to_f32(sg[u * BCH]) + an * g;
          an = to_f32(sa[u * BCH]);
          store(pb + (long long)u * d, g);
          store(pa + (long long)u * d, g * to_f32(sh[u * BCH]));
        }
      } else {
        for (int u = t_len - t0 - 1; u >= 0; --u) {
          g = to_f32(sg[u * BCH]) + an * g;
          an = to_f32(sa[u * BCH]);
          store(pb + (long long)u * d, g);
          store(pa + (long long)u * d, g * to_f32(sh[u * BCH]));
        }
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* dh, void* da,
               void* db, int batch, int t_len, int d, void* stream) {
  if (batch <= 0 || t_len <= 0 || d <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   (((uintptr_t)a | (uintptr_t)h | (uintptr_t)dh) & 15) == 0;
  auto kern = linear_recurrence_bwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((d + BCH - 1) / BCH, batch);
  kern<<<grid, BCH, BWD_SMEM, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)h, (const T*)dh, (T*)da, (T*)db, t_len, d,
      vec ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, void* out, int batch, int t_len,
           int d, void* stream) {
  if (batch <= 0 || t_len <= 0 || d <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
  auto kern = linear_recurrence_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((d + CH - 1) / CH, batch);
  kern<<<grid, CH, SMEM, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)b, (T*)out, t_len, d, vec ? 1 : 0);
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

// The backward: da, db (B, T, D) in the input type from a, the forward's
// h and the output gradient dh, all contiguous and of one type.
extern "C" int linear_recurrence_bwd_f32(const void* a, const void* h,
                                         const void* dh, void* da, void* db,
                                         int batch, int t_len, int d,
                                         void* stream) {
  return launch_bwd<float>(a, h, dh, da, db, batch, t_len, d, stream);
}

extern "C" int linear_recurrence_bwd_bf16(const void* a, const void* h,
                                          const void* dh, void* da, void* db,
                                          int batch, int t_len, int d,
                                          void* stream) {
  return launch_bwd<__nv_bfloat16>(a, h, dh, da, db, batch, t_len, d,
                                   stream);
}
