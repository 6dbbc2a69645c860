// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk_scan.py
// (ssd_chunk_scan: _kernel).  x, y (Bb, T, H, P); dt (Bb, T, H) float32;
// A (H,) float32; B, C (Bb, T, G, N); all contiguous.  x, B, C, y are
// float32 or bfloat16; the state out (Bb, H, P, N) is float32.  Head h
// reads group h / (H / G).  Per chunk of L steps, cum = inclusive cumsum
// of dt * A:
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//       + (C_i exp(cum_i)) . S_prev^T                             (inter)
//   S   = exp(cum_L) S_prev + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T
// Terms j > i are selected away before the exp, never multiplied by a 0
// mask: exp(cum_i - cum_j) overflows there (cum falls along the chunk).
// For the same reason the decay is never factored into the operands as
// e^{cum_i} on C and e^{-cum_j} on B: e^{-cum_j} overflows float32 once
// cum < -88 (dt ~ 1, |A| >= 0.7 over a 128-step chunk).
//
// Two kernels, both one block of 256 threads per (batch, head) walking
// the chunks in order, so the (P, N) state never leaves the SM and the
// scan moves no bytes beyond x, dt, B, C, y and the final state (76 MB at
// mamba2-370m's prefill, x (4, 2048, 32, 64) bf16: 0.0228 ms at 3.35
// TB/s).  Its 15.1 GFLOP take 0.015 ms on the bf16 tensor cores but 0.225
// ms on the float32 cores, so only the tensor cores can reach the bound.
//
// ssd_mma_kernel, the bfloat16 instance: the four products on the tensor
// cores (mma.sync m16n8k16, bf16 in, float32 accumulators), P and N
// padded with zeros in shared memory to PP, NP in {16, 32, 64, 128}.
// What bounded the float32-core kernel, and what this one does about it:
//  1. float32 SIMT products -> mma.sync.  Warp w owns a 16-row block of
//     the chunk (at L < 128 several warps share a row block and split the
//     P columns, each recomputing its C B^T); the two warps of an SM
//     sub-partition (w, w + 4) take row blocks of equal total causal
//     length.  C B^T runs only over the causal 16 x 16 tiles; each tile's
//     float32 accumulator gets exp(cum_i - cum_j) dt_j element by element
//     (select before exp; ex2.approx of pre-scaled cum, as the tile is
//     rounded to bf16 next) and becomes, in registers, the bf16 A operand
//     of scores x X (FlashAttention-2's reuse: the accumulator layout of
//     m16n8k16 is its A layout).  C S^T is accumulated first and its rows
//     scaled by e^{cum_i} <= 1 (an exact factoring).  The state is a
//     float32 register accumulator spread over the 8 warps (32 floats a
//     thread at P = 64, N = 128): S <- e^{cum_L} S + (x w)^T B, with x w
//     formed in registers from the x fragments and split into bf16 hi +
//     lo (two products), so the state keeps ~16 bits a term (one bf16
//     rounding of x w misses the state's atol 1e-3 under strong decay).
//     Its k-steps are issued between the causal tiles' steps, which wait
//     on their own products and exps.  Each chunk leaves a bf16 copy of S
//     in shared memory as the operand of the next chunk's C S^T.
//  2. one thread's cumsum -> warp 0 scans the chunk with shuffles (L / 32
//     steps a lane, then a 5-step warp scan) while the other warps run
//     C S^T.  The chunk's sum is taken in another order than the TPU
//     kernel's jnp.cumsum; the tolerances (atol 1e-3 on the float32
//     state) cover that.
//  3. no overlap of loads with compute -> the next chunk's x, B, C (16-byte
//     cp.async) and dt (4-byte cp.async) go into a second shared-memory
//     stage while the current chunk computes; two block barriers a chunk.
//     Shapes whose two stages do not fit (P = N = 128 at L = 128) run one
//     stage and load after the chunk (a third barrier).  Rows that are
//     not 16-byte aligned (P or N not a multiple of 8, or an offset view)
//     are copied element by element in the same place.
//  4. one block an SM (Bb * H = 128 blocks) stays: a chunk-parallel split
//     would write and read (Bb, H, chunks, P, N) float32 states (~270 MB
//     at the model's shape, >= 0.08 ms).
// What holds it back now: ~2,400 mma.sync a chunk (the state's hi/lo split
// is 512 of them) issued by 8 warps an SM, 2 a sub-partition, with little
// to hide their latency; wgmma (its operands in the layouts it reads) is
// the next step.
// Rows padded by 8 bf16 keep ldmatrix free of bank conflicts.
//
// ssd_chunk_scan_kernel, the float32 instance (and bfloat16 at N > 128):
// the products on the float32 cores, as the float32 model is held to
// float32 logits and tf32 would not be float32.  Each chunk is done in
// row tiles of 32: the tile's C rows and its 32 x L score tile live in
// shared memory, and only the columns j < i0 + 32 that the causal mask
// keeps are computed.  Warp w owns rows 4w..4w+3 of a tile; its lanes own
// score columns (lane + 32k) and output columns (lane + 32k), so C and
// score reads are broadcasts and B, x and state reads are conflict-free
// (rows padded to N + 4 floats, float4 along N).  The state update gives
// each thread 4 rows of P x 4 columns of N.
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int RT = 32;        // rows per tile: 8 warps x 4 rows
constexpr int MAX_SMEM = 232448;

struct Dims {
  int t_len, h, p, g, n, l;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void lds4(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}

// Shared memory, in floats (every part a multiple of 4, so each starts
// 16-byte aligned): x (L x P), B (L x NB), C tile (RT x NB), state
// (P x NB), score tile (RT x L), dt, cum, w = exp(cum_L - cum) dt and
// e = exp(cum) (L each); NB = N + 4.
__host__ __device__ inline long long smem_floats(int l, int p, int n) {
  const int nb = n + 4;
  return (long long)l * p + (long long)l * nb + RT * nb + (long long)p * nb +
         RT * l + 4 * l;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_chunk_scan_kernel(const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const T* __restrict__ B, const T* __restrict__ C,
                          T* __restrict__ y, float* __restrict__ s_out,
                          Dims dm) {
  const int H = dm.h, P = dm.p, N = dm.n, L = dm.l, G = dm.g;
  const int NB = N + 4;
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);
  float* sB = sx + L * P;
  float* sC = sB + L * NB;
  float* sS = sC + RT * NB;
  float* sP = sS + P * NB;
  float* sdt = sP + RT * L;
  float* scum = sdt + L;
  float* sw = scum + L;
  float* se = sw + L;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float a_h = A[h];
  const long long x_t = (long long)H * P;   // x / y stride along T
  const long long bc_t = (long long)G * N;  // B / C stride along T
  const T* xb = x + (long long)b * dm.t_len * x_t + (long long)h * P;
  T* yb = y + (long long)b * dm.t_len * x_t + (long long)h * P;
  const T* Bb = B + (long long)b * dm.t_len * bc_t + (long long)g * N;
  const T* Cb = C + (long long)b * dm.t_len * bc_t + (long long)g * N;
  const float* dtb = dt + (long long)b * dm.t_len * H + h;

  for (int i = tid; i < P * NB; i += THREADS) sS[i] = 0.f;

  const int nchunks = dm.t_len / L;
  for (int ci = 0; ci < nchunks; ++ci) {
    const long long c0 = (long long)ci * L;
    __syncthreads();  // the last chunk's readers of sx, sB, sS are done
    for (int i = tid; i < L * P; i += THREADS) {
      const int j = i / P, q = i - j * P;
      sx[i] = to_f32(xb[(c0 + j) * x_t + q]);
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int j = i / N, q = i - j * N;
      sB[j * NB + q] = to_f32(Bb[(c0 + j) * bc_t + q]);
    }
    for (int j = tid; j < L; j += THREADS) sdt[j] = dtb[(c0 + j) * H];
    __syncthreads();
    if (tid == 0) {  // the TPU kernel's cumsum(dt * A), in order
      float c = 0.f;
      for (int j = 0; j < L; ++j) {
        c += sdt[j] * a_h;
        scum[j] = c;
      }
    }
    __syncthreads();
    const float cum_last = scum[L - 1];
    for (int j = tid; j < L; j += THREADS) {
      sw[j] = expf(cum_last - scum[j]) * sdt[j];
      se[j] = expf(scum[j]);
    }

    for (int i0 = 0; i0 < L; i0 += RT) {
      __syncthreads();  // sw / se written; the last tile's readers done
      for (int i = tid; i < RT * N; i += THREADS) {
        const int r = i / N, q = i - r * N;
        sC[r * NB + q] = to_f32(Cb[(c0 + i0 + r) * bc_t + q]);
      }
      __syncthreads();

      // Score tile: rows i0 + 4 warp + i, columns j = lane + 32 k < lc.
      const int lc = i0 + RT;
      const int kc = lc / 32;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
      for (int q = 0; q < N; q += 4) {
        float cv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) lds4(sC + (4 * warp + i) * NB + q, cv[i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < kc) {
            float bv[4];
            lds4(sB + (lane + 32 * k) * NB + q, bv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][k] = fmaf(cv[i][e], bv[e], acc[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i0 + 4 * warp + i;
        const float cr = scum[row];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < kc) {
            const int j = lane + 32 * k;
            float s = 0.f;
            if (j <= row) s = acc[i][k] * expf(cr - scum[j]) * sdt[j];
            sP[(4 * warp + i) * L + j] = s;
          }
        }
      }
      __syncthreads();

      // Output tile: rows as above, columns p = lane + 32 k < P.
      float yi[4][4], ye[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) yi[i][k] = ye[i][k] = 0.f;
      for (int j = 0; j < lc; ++j) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = sP[(4 * warp + i) * L + j];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pp = lane + 32 * k;
          if (pp < P) {
            const float xv = sx[j * P + pp];
#pragma unroll
            for (int i = 0; i < 4; ++i) yi[i][k] = fmaf(pv[i], xv, yi[i][k]);
          }
        }
      }
      float er[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) er[i] = se[i0 + 4 * warp + i];
      for (int q = 0; q < N; q += 4) {
        float cv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lds4(sC + (4 * warp + i) * NB + q, cv[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) cv[i][e] *= er[i];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pp = lane + 32 * k;
          if (pp < P) {
            float sv[4];
            lds4(sS + pp * NB + q, sv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                ye[i][k] = fmaf(cv[i][e], sv[e], ye[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T* yrow = yb + (c0 + i0 + 4 * warp + i) * x_t;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pp = lane + 32 * k;
          if (pp < P) store(yrow + pp, yi[i][k] + ye[i][k]);
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // State update: rows p = 4 pg + i, columns n = q0 + e.
    const float el = expf(cum_last);
    for (int pg = warp; pg < P / 4; pg += THREADS / 32) {
      for (int q0 = 4 * lane; q0 < N; q0 += 128) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
        for (int j = 0; j < L; ++j) {
          const float wj = sw[j];
          float xw[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xw[i] = sx[j * P + 4 * pg + i] * wj;
          lds4(sB + j * NB + q0, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(xw[i], bv[e], acc[i][e]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* srow = sS + (4 * pg + i) * NB + q0;
#pragma unroll
          for (int e = 0; e < 4; ++e) srow[e] = srow[e] * el + acc[i][e];
        }
      }
    }
  }
  __syncthreads();
  float* so = s_out + ((long long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS) {
    const int pp = i / N, q = i - pp * N;
    so[i] = sS[pp * NB + q];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* s_out, int batch, const Dims& dm,
           cudaStream_t stream) {
  const long long smem = 4 * smem_floats(dm.l, dm.p, dm.n);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = ssd_chunk_scan_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(dm.h, batch);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (T*)y, (float*)s_out, dm);
  return (int)cudaGetLastError();
}


// ---- the bfloat16 tensor-core instance -------------------------------------

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ldmatrix: lane l gives the address of row (l & 7) of matrix l >> 3.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}
// d (16 x 8, float32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x, one MUFU.EX2 (relative error ~2^-22): the scores' decay, which is
// rounded to bf16 next.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x * w) of a bf16 pair, split as hi + lo in bf16 (hi the rounded
// product, lo the rounded rest).
__device__ __forceinline__ void split_scaled(uint32_t xv, float2 w,
                                             uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&xv));
  const float px = f.x * w.x, py = f.y * w.y;
  const bf162 h = __floats2bfloat162_rn(px, py);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(px - hf.x, py - hf.y);
}

// cumsum(dt * a_h) of a chunk of L = 32, 64 or 128 steps by one warp: L /
// 32 steps a lane, then a 5-step shuffle scan.  v[e] (e < L / 32) is cum
// at step (L / 32) lane + e; returns cum at the chunk's last step, in
// every lane.
__device__ __forceinline__ float warp_cumsum(const float* sdt, float a_h,
                                             int L, int lane, float (&v)[4]) {
  const int E = L / 32;
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < E) {
      run += sdt[E * lane + e] * a_h;
      v[e] = run;
    }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < E) v[e] = excl + v[e];
  float mine = v[0];
#pragma unroll
  for (int e = 1; e < 4; ++e)
    if (e < E) mine = v[e];
  return __shfl_sync(0xffffffffu, mine, 31);
}

struct MmaDims {
  int t_len, h, p, g, n, l, stages, vec;
};

// Shared memory, in bytes, rows padded by 8 bf16 (XS = PP + 8, BS = NP +
// 8): `stages` x [x (L x XS) | B (L x BS) | C (L x BS) | dt (L floats)],
// then the bf16 state (PP x BS), cum, cum log2(e), e^cum and w (L floats
// each).  Every part is a multiple of 16 bytes.
__host__ __device__ inline long long mma_stage_bytes(int l, int pp, int np) {
  return 2LL * l * (pp + 8) + 4LL * l * (np + 8) + 4LL * l;
}
__host__ __device__ inline long long mma_smem_bytes(int l, int pp, int np,
                                                    int stages) {
  return stages * mma_stage_bytes(l, pp, np) + 2LL * pp * (np + 8) +
         16LL * l;
}

template <int PP, int NP>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ B,
                   const bf16* __restrict__ C, bf16* __restrict__ y,
                   float* __restrict__ s_out, MmaDims dm) {
  constexpr int XS = PP + 8, BS = NP + 8;
  constexpr int KC = NP / 16;   // k-steps of C B^T and C S^T
  constexpr int PT = PP / 8;    // 8-column tiles of y
  constexpr int NT = NP / 8;    // 8-column tiles of the state
  constexpr int WM = PP / 16;   // state: warps along P ...
  constexpr int WN = 8 / WM;    // ... and along N
  constexpr int ST = (NT + WN - 1) / WN;  // state tiles a warp
  const int H = dm.h, P = dm.p, N = dm.n, L = dm.l, G = dm.g;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int stage_bytes = (int)mma_stage_bytes(L, PP, NP);
  bf16* sS = reinterpret_cast<bf16*>(base + dm.stages * stage_bytes);
  float* scum = reinterpret_cast<float*>(sS + PP * BS);
  float* scum2 = scum + L;  // cum log2(e)
  float* se = scum2 + L;
  float* sw = se + L;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;  // accumulator row, column pair
  const float a_h = A[h];
  const long long x_t = (long long)H * P;
  const long long bc_t = (long long)G * N;
  const bf16* xb = x + (long long)b * dm.t_len * x_t + (long long)h * P;
  bf16* yb = y + (long long)b * dm.t_len * x_t + (long long)h * P;
  const bf16* Bb = B + (long long)b * dm.t_len * bc_t + (long long)g * N;
  const bf16* Cb = C + (long long)b * dm.t_len * bc_t + (long long)g * N;
  const float* dtb = dt + (long long)b * dm.t_len * H + h;

  // Padding columns of x, B, C and the state stay 0: loads write only
  // columns < P, N.
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < dm.stages * stage_bytes / 16; i += THREADS)
    smem4[i] = z4;
  float4* sS4 = reinterpret_cast<float4*>(sS);
  for (int i = tid; i < PP * BS * 2 / 16; i += THREADS) sS4[i] = z4;
  __syncthreads();

  auto stage_x = [&](int st) {
    return reinterpret_cast<bf16*>(base + st * stage_bytes);
  };
  auto load_chunk = [&](int ci, int st) {
    bf16* sx = stage_x(st);
    bf16* sB = sx + L * XS;
    bf16* sC = sB + L * BS;
    float* sdt = reinterpret_cast<float*>(sC + L * BS);
    const long long c0 = (long long)ci * L;
    if (dm.vec) {  // 16-byte pieces over the padded widths, skipping pads
      for (int i = tid; i < L * (PP / 8); i += THREADS) {
        const int j = i / (PP / 8), c = 8 * (i % (PP / 8));
        if (c < P)
          cp_async16(smem_u32(sx + j * XS + c), xb + (c0 + j) * x_t + c);
      }
      for (int i = tid; i < L * (NP / 8); i += THREADS) {
        const int j = i / (NP / 8), c = 8 * (i % (NP / 8));
        if (c < N) {
          cp_async16(smem_u32(sB + j * BS + c), Bb + (c0 + j) * bc_t + c);
          cp_async16(smem_u32(sC + j * BS + c), Cb + (c0 + j) * bc_t + c);
        }
      }
    } else {  // rows not 16-byte aligned: element by element
      for (int i = tid; i < L * P; i += THREADS) {
        const int j = i / P, q = i - j * P;
        sx[j * XS + q] = xb[(c0 + j) * x_t + q];
      }
      for (int i = tid; i < L * N; i += THREADS) {
        const int j = i / N, q = i - j * N;
        sB[j * BS + q] = Bb[(c0 + j) * bc_t + q];
        sC[j * BS + q] = Cb[(c0 + j) * bc_t + q];
      }
    }
    for (int j = tid; j < L; j += THREADS)
      cp_async4(smem_u32(sdt + j), dtb + (c0 + j) * H);
    cp_async_commit();
  };

  // This warp's state tiles: rows 16 smt.., column tiles snt0 + s.
  const int smt = warp % WM, snt0 = (warp / WM) * ST;
  constexpr bool SFULL = NT % WN == 0;  // every warp's ST tiles exist
  float st[ST][4];
#pragma unroll
  for (int s = 0; s < ST; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[s][e] = 0.f;

  // One chunk for this warp: y for its 16 rows (products 1-3) and its
  // tiles of the state (product 4).  WPC warps share a row block (WPC = 8
  // / (L / 16)) and split y's column tiles; each recomputes the row
  // block's C B^T.  The two warps of an SM sub-partition (w, w + 4) take
  // row blocks whose causal lengths add up to the same total.  The state
  // update does not depend on products 1-2, so its k-steps are issued
  // between theirs and fill their latency.
  auto chunk = [&](auto wp_c, const bf16* sx, const bf16* sB,
                   const bf16* sC, const float* sdt, long long c0) {
    constexpr int WPC = decltype(wp_c)::value;
    constexpr int YT = (PT + WPC - 1) / WPC;  // y column tiles a warp
    constexpr bool YFULL = PT % WPC == 0;     // every warp's YT tiles exist
    int rb, cg;
    if (WPC == 1) {
      rb = warp < 4 ? warp : 11 - warp;
      cg = 0;
    } else if (WPC == 2) {
      rb = warp < 4 ? warp : 7 - warp;
      cg = warp >> 2;
    } else {
      rb = (warp + (warp >> 2)) & 1;
      cg = warp >> 1;
    }
    const int i0 = 16 * rb, pt0 = cg * YT;

    // C fragments of rows i0..i0+15 over all of N (A of C B^T and C S^T)
    uint32_t cf[KC][4];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
      ldsm_x4(smem_u32(sC + (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * BS +
                       16 * kk + (lane >> 4) * 8),
              cf[kk]);
    float yacc[YT][4];
#pragma unroll
    for (int s = 0; s < YT; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[s][e] = 0.f;

    // inter-chunk: y = e^{cum_i} (C S_prev^T), while warp 0 scans; a
    // k-step's operands are loaded before its products, which go to
    // different accumulators
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t bb[YT][2];
#pragma unroll
      for (int s = 0; s < YT; ++s)
        if (YFULL || pt0 + s < PT)
          ldsm_x2(smem_u32(sS + (8 * (pt0 + s) + (lane & 7)) * BS + 16 * kk +
                           ((lane >> 3) & 1) * 8),
                  bb[s]);
#pragma unroll
      for (int s = 0; s < YT; ++s)
        if (YFULL || pt0 + s < PT)
          mma16816(yacc[s], cf[kk], bb[s][0], bb[s][1]);
    }
    __syncthreads();  // warp 0's cum, e^cum and w written; sS reads done
    const int ilo = i0 + gr, ihi = ilo + 8;
    const float cum_lo = scum2[ilo], cum_hi = scum2[ihi];
    {
      const float e_lo = se[ilo], e_hi = se[ihi];
#pragma unroll
      for (int s = 0; s < YT; ++s) {
        yacc[s][0] *= e_lo;
        yacc[s][1] *= e_lo;
        yacc[s][2] *= e_hi;
        yacc[s][3] *= e_hi;
      }
    }
    // state: S = e^{cum_L} S + (x w)^T B, x w = x_j exp(cum_L - cum_j) dt_j
    // split into bf16 hi + lo in registers, so the sum keeps ~16 bits
    {
      const float el = expf(scum[L - 1]);
#pragma unroll
      for (int s = 0; s < ST; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[s][e] *= el;
    }

    // step kb: the causal 16 x 16 score tile (kb <= rb), decayed in
    // float32 (j > i selected to 0 before the exp), then times x; and
    // the state's k-step kb
    for (int kb = 0; kb < L / 16; ++kb) {
      const bool intra = kb <= rb;
      float sc[2][2][4];  // [8-column tile][k-step parity]
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[u][v][e] = 0.f;
      if (intra) {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          uint32_t bb[4];
          ldsm_x4(smem_u32(sB + (16 * kb + (lane & 7) + (lane >> 4) * 8) * BS +
                           16 * kk + ((lane >> 3) & 1) * 8),
                  bb);
          mma16816(sc[0][kk & 1], cf[kk], bb[0], bb[1]);
          mma16816(sc[1][kk & 1], cf[kk], bb[2], bb[3]);
        }
      }
      {  // the state's k-step kb: rows j = 16 kb .. 16 kb + 15
        uint32_t xf[4], hi[4], lo[4];
        ldsm_x4_t(smem_u32(sx + (16 * kb + (lane & 7) + (lane >> 4) * 8) * XS +
                           16 * smt + ((lane >> 3) & 1) * 8),
                  xf);
        const float2 w0 =
            *reinterpret_cast<const float2*>(sw + 16 * kb + 2 * tq);
        const float2 w1 =
            *reinterpret_cast<const float2*>(sw + 16 * kb + 8 + 2 * tq);
        split_scaled(xf[0], w0, hi[0], lo[0]);
        split_scaled(xf[1], w0, hi[1], lo[1]);
        split_scaled(xf[2], w1, hi[2], lo[2]);
        split_scaled(xf[3], w1, hi[3], lo[3]);
        const bf16* br = sB + (16 * kb + (lane & 15)) * BS;
        uint32_t bq[ST][2];
        if constexpr (SFULL && ST % 2 == 0) {
#pragma unroll
          for (int s = 0; s < ST; s += 2) {  // two column tiles a load
            uint32_t t4[4];
            ldsm_x4_t(smem_u32(br + 8 * (snt0 + s) + (lane >> 4) * 8), t4);
            bq[s][0] = t4[0];
            bq[s][1] = t4[1];
            bq[s + 1][0] = t4[2];
            bq[s + 1][1] = t4[3];
          }
        } else {
#pragma unroll
          for (int s = 0; s < ST; ++s)
            if (SFULL || snt0 + s < NT)
              ldsm_x2_t(smem_u32(br + 8 * (snt0 + s)), bq[s]);
        }
        // all hi products, then all lo: no two neighbours share an
        // accumulator
#pragma unroll
        for (int s = 0; s < ST; ++s)
          if (SFULL || snt0 + s < NT) mma16816(st[s], hi, bq[s][0], bq[s][1]);
#pragma unroll
        for (int s = 0; s < ST; ++s)
          if (SFULL || snt0 + s < NT) mma16816(st[s], lo, bq[s][0], bq[s][1]);
      }
      if (intra) {
        float q[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = 16 * kb + 8 * u + 2 * tq;
          const float2 cj = *reinterpret_cast<const float2*>(scum2 + j);
          const float2 dj = *reinterpret_cast<const float2*>(sdt + j);
          float a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = sc[u][0][e] + sc[u][1][e];
          q[u][0] = j <= ilo ? a[0] * ex2(cum_lo - cj.x) * dj.x : 0.f;
          q[u][1] = j < ilo ? a[1] * ex2(cum_lo - cj.y) * dj.y : 0.f;
          q[u][2] = j <= ihi ? a[2] * ex2(cum_hi - cj.x) * dj.x : 0.f;
          q[u][3] = j < ihi ? a[3] * ex2(cum_hi - cj.y) * dj.y : 0.f;
        }
        const uint32_t pa[4] = {pack_bf16(q[0][0], q[0][1]),
                                pack_bf16(q[0][2], q[0][3]),
                                pack_bf16(q[1][0], q[1][1]),
                                pack_bf16(q[1][2], q[1][3])};
        const bf16* xr = sx + (16 * kb + (lane & 15)) * XS;
        if constexpr (YFULL && YT % 2 == 0) {
          uint32_t bb[YT / 2][4];  // two column tiles a load
#pragma unroll
          for (int s = 0; s < YT; s += 2)
            ldsm_x4_t(smem_u32(xr + 8 * (pt0 + s) + (lane >> 4) * 8),
                      bb[s / 2]);
#pragma unroll
          for (int s = 0; s < YT; s += 2) {
            mma16816(yacc[s], pa, bb[s / 2][0], bb[s / 2][1]);
            mma16816(yacc[s + 1], pa, bb[s / 2][2], bb[s / 2][3]);
          }
        } else {
#pragma unroll
          for (int s = 0; s < YT; ++s)
            if (YFULL || pt0 + s < PT) {
              uint32_t bb[2];
              ldsm_x2_t(smem_u32(xr + 8 * (pt0 + s)), bb);
              mma16816(yacc[s], pa, bb[0], bb[1]);
            }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < YT; ++s) {
      const int p = 8 * (pt0 + s) + 2 * tq;
      if ((YFULL || pt0 + s < PT) && p < P) {
        *reinterpret_cast<bf162*>(yb + (c0 + ilo) * x_t + p) =
            __floats2bfloat162_rn(yacc[s][0], yacc[s][1]);
        *reinterpret_cast<bf162*>(yb + (c0 + ihi) * x_t + p) =
            __floats2bfloat162_rn(yacc[s][2], yacc[s][3]);
      }
    }
  };

  const int nch = dm.t_len / L;
  if (nch > 0) load_chunk(0, 0);
  for (int ci = 0; ci < nch; ++ci) {
    const int cur = dm.stages == 2 ? (ci & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // chunk ci landed; every reader of chunk ci-1 done
    if (dm.stages == 2 && ci + 1 < nch) load_chunk(ci + 1, cur ^ 1);
    const bf16* sx = stage_x(cur);
    const bf16* sB = sx + L * XS;
    const bf16* sC = sB + L * BS;
    const float* sdt = reinterpret_cast<const float*>(sC + L * BS);
    const long long c0 = (long long)ci * L;

    if (warp == 0) {  // cumsum(dt * A)
      const int E = L / 32;
      float v[4];
      const float last = warp_cumsum(sdt, a_h, L, lane, v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < E) {
          const int j = E * lane + e;
          scum[j] = v[e];
          scum2[j] = v[e] * 1.4426950408889634f;
          se[j] = expf(v[e]);
          sw[j] = expf(last - v[e]) * sdt[j];
        }
    }

    const int RB = L / 16;  // 16-row blocks of the chunk: 8, 4 or 2
    if (RB == 8)
      chunk(std::integral_constant<int, 1>{}, sx, sB, sC, sdt, c0);
    else if (RB == 4)
      chunk(std::integral_constant<int, 2>{}, sx, sB, sC, sdt, c0);
    else
      chunk(std::integral_constant<int, 4>{}, sx, sB, sC, sdt, c0);
    // the bf16 copy of the new state, the next chunk's C S^T operand (every
    // reader of the old copy passed the barrier inside chunk())
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      const int nt = snt0 + s;
      if (SFULL || nt < NT) {
        const int n = 8 * nt + 2 * tq, p = 16 * smt + gr;
        *reinterpret_cast<bf162*>(sS + p * BS + n) =
            __floats2bfloat162_rn(st[s][0], st[s][1]);
        *reinterpret_cast<bf162*>(sS + (p + 8) * BS + n) =
            __floats2bfloat162_rn(st[s][2], st[s][3]);
      }
    }
    if (dm.stages == 1 && ci + 1 < nch) {
      __syncthreads();  // every reader of the one stage done
      load_chunk(ci + 1, 0);
    }
  }

  float* so = s_out + ((long long)b * H + h) * P * N;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int nt = snt0 + s;
    const int n = 8 * nt + 2 * tq, p = 16 * smt + gr;
    if (nt < NT && n < N) {
      if (p < P)
        *reinterpret_cast<float2*>(so + (long long)p * N + n) =
            make_float2(st[s][0], st[s][1]);
      if (p + 8 < P)
        *reinterpret_cast<float2*>(so + (long long)(p + 8) * N + n) =
            make_float2(st[s][2], st[s][3]);
    }
  }
}

// P and N padded to the tile: 16, 32, 64 or 128.
inline int padded(int v) {
  return v <= 16 ? 16 : v <= 32 ? 32 : v <= 64 ? 64 : 128;
}

// Two stages where they fit, else one; 0 where one does not fit either.
inline int mma_stages(int l, int p, int n) {
  const int pp = padded(p), np = padded(n);
  if (mma_smem_bytes(l, pp, np, 2) <= MAX_SMEM) return 2;
  return mma_smem_bytes(l, pp, np, 1) <= MAX_SMEM ? 1 : 0;
}

template <int PP, int NP>
int launch_mma(const void* x, const void* dt, const void* A, const void* B,
               const void* C, void* y, void* s_out, int batch,
               const MmaDims& dm, cudaStream_t stream) {
  const long long smem = mma_smem_bytes(dm.l, PP, NP, dm.stages);
  auto kern = ssd_mma_kernel<PP, NP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(dm.h, batch);
  kern<<<grid, THREADS, smem, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (bf16*)y, (float*)s_out, dm);
  return (int)cudaGetLastError();
}

template <int PP>
int launch_mma_n(int np, const void* x, const void* dt, const void* A,
                 const void* B, const void* C, void* y, void* s_out,
                 int batch, const MmaDims& dm, cudaStream_t s) {
  switch (np) {
    case 16:
      return launch_mma<PP, 16>(x, dt, A, B, C, y, s_out, batch, dm, s);
    case 32:
      return launch_mma<PP, 32>(x, dt, A, B, C, y, s_out, batch, dm, s);
    case 64:
      return launch_mma<PP, 64>(x, dt, A, B, C, y, s_out, batch, dm, s);
    default:
      return launch_mma<PP, 128>(x, dt, A, B, C, y, s_out, batch, dm, s);
  }
}


// ---- the backward --------------------------------------------------------
//
// From the output gradient dy and the final state's dS_final: dx, ddt, dA,
// dB, dC of the chunked maths above (repro_torch.kernels.ssd_chunk_scan.
// ssd_bwd_torch is the same maths as batched products).  Per chunk, with
// u_j = dt_j x_j, E_ij = exp(cum_i - cum_j) for i >= j (selected away
// before the exp elsewhere), S_prev the state entering the chunk and dS
// the gradient of the state leaving it:
//   du_j = sum_{i>=j} (C_i.B_j) E_ij dy_i + exp(cum_L - cum_j) dS B_j
//   dC_i = sum_{j<=i} E_ij (dy_i.u_j) B_j + exp(cum_i) S_prev^T dy_i
//   dB_j = sum_{i>=j} E_ij (dy_i.u_j) C_i + exp(cum_L - cum_j) dS^T u_j
//   dS entering = exp(cum_L) dS + sum_i exp(cum_i) dy_i C_i^T
// dcum, through every exponent, gives ddt_j = x_j.du_j + A rc_j and dA =
// sum_j dt_j rc_j, rc the reverse cumsum of dcum within the chunk.  Both
// instances run in this order, with no atomics (every sum in a fixed
// order, so two runs give the same bits): the state walks (the state
// entering each chunk and dS leaving it, to float32 scratch (Bb, H,
// chunks, P, N)), a chunk kernel (every chunk independent once both states
// are known: dx, dB and dC per head to float32 scratch (Bb, T, H, N), and
// dcum's parts and x.du a step to `rows`), then
//  - ssd_bwd_finish: a thread per (batch, chunk, head) sums dcum's parts
//    and takes the reverse cumsum: ddt, and dA's partial per chunk;
//  - ssd_bwd_reduce: dB and dC summed over the heads of a group (32 heads
//    at mamba2-370m's G = 1), dA over batch and chunks, in order.
// The least work per chunk and head is, in multiply-adds over the L (L +
// 1) / 2 causal pairs, the C.B and dy.u scores (N + P) and their three
// products (P + 2 N), then five products of L P N (S_prev^T dy, dS B, dS^T
// u, dS's update and the state's recompute): 38.8 GFLOP at mamba2-370m's
// training shape (4, 2048, 32, 64), N 128: 0.58 ms on the float32 cores at
// 67 TFLOP/s, 0.039 ms on the bf16 tensor cores at 989.
//
// The float32 instance (ssd_bwd_f32_walk<WT>, ssd_bwd_f32_chunk<PP, NP,
// TO>): the products on the float32 cores, as the float32 model is held to
// float32 (TF32 would not be), at 67 TFLOP/s, so their least work above
// takes 0.58 ms.  Shared memory, not the FMA units, is the first limit on
// those cores: a warp's 16-byte shared load costs four cycles of the SM's
// port, so a product only keeps the FMA units busy where a thread does 64
// multiply-adds for every four float4 it reads.  What held the earlier
// float32 kernels back (4.12 ms at mamba2-370m's training shape: the walks
// 0.99 ms in two launches, the chunk kernel 2.87), and what these do:
//  1. two serial walk launches of a block per (head, batch), a one-thread
//     cumsum -> one launch of a (head, batch, direction) grid (the forward
//     and the reverse walk side by side, 256 blocks at the training shape;
//     128 threads a block and two blocks an SM at P <= 64, each loading
//     its next chunk while the other computes; 256 threads and the next
//     chunk by cp.async into a second stage above), the cumsum by one
//     warp's shuffles (warp_cumsum).  The state lives in registers, 8 x 8
//     elements a thread.
//  2. 32-row tiles of the other side loaded after the products that wait
//     for them, products of 4 x 4 outputs a thread on scalar or broadcast
//     loads -> the other side's whole chunk held in shared memory (TO = L,
//     loaded once; 32-row tiles streamed through two stages where it does
//     not fit: PP = NP = 128, or P above the chunk), the own side's 32-row
//     tiles through two stages by cp.async.  Every product gives a thread
//     an 8 x 8 block of outputs: the 32 x L scores (C.B over N, dy.x over
//     P) with 512 / L lanes a block, each over a slice of the contraction
//     in float4, the other products as an outer product a contraction step
//     (two float4 of each operand, laid out along the outputs: Q^T, M and
//     Q go to shared memory transposed, and the own X tile once an own
//     tile); lanes sharing a block fold by shuffles (Fold), each element
//     summed in one fixed order.  Score blocks the causal mask clears are
//     not computed.  The roles stay split: x, dy, B and C of a 128-step
//     chunk in float32 take 192 KB.  The column role's du (P columns) and
//     dB (N columns) run side by side in warps 0-3 and 4-7.  P and N are
//     padded with zeros to 32, 64 or 128 (23 chunk instances).
// At the training shape on an H100 (scripts/ssd_bwd_ab.py --dtype float32):
// the walks 0.37 ms, the chunk kernel 2.15 ms (26% of the float32 rate),
// the whole backward 2.85-2.98 ms against 4.05-4.26 before.  Streaming
// 32-row tiles there instead of holding the whole chunk takes the chunk
// kernel to 2.37 ms; the whole-chunk instances spill a few bytes at 255
// registers (12 stored, 24 loaded at PP 64, NP 128) and are still the
// faster layout.  What holds the chunk kernel back now: it runs one block
// of 8 warps an SM at 255 registers, two warps a scheduler, so the
// latency of its shared loads and shuffles is exposed.
//
// The bfloat16 instance (ssd_bwd_walk, ssd_bwd_mma_chunk: the products on
// the tensor cores, mma.sync m16n8k16 with float32 accumulators, P and N
// padded with zeros to PP, NP in {16, 32, 64, 128}, the forward's
// fragments and helpers).  What bounded the float32 instance on bfloat16
// inputs (4.11 ms at mamba2-370m's training shape, 9 TFLOP/s), and what
// this one does about it:
//  1. float32 SIMT products: every bf16 element was widened to float32 in
//     shared memory and the products ran on the float32 cores -> every
//     product on mma.sync from bf16 operands that are either inputs (x,
//     dy, B, C, exact) or rounded once (the decayed score tiles, as the
//     forward's scores); each row scale (dt_j, e^{cum_i}, e^{cum_L -
//     cum_j}) is applied to a float32 accumulator, never to an operand, so
//     u = dt x is never rounded.  The states enter products as bf16 hi +
//     lo pairs (two products, ~16 bits a term): by estimate, one rounding
//     of S_prev or dS would put an error of 2^-9 of a term's size on every
//     gradient element, enough for a few near-zero elements of a
//     million-element dB or dC to leave BWD_TOL's atol; the forward's
//     state update measured the same.
//  2. the chunk kernel's split roles and streamed 32-row tiles (2.87 of
//     4.0 ms): a block of L / 16 warps per (chunk, head, batch) holds the
//     whole chunk's x, dy, B and C in bf16 (rows padded by 8 for
//     ldmatrix, pad columns zeroed; 106 KB at P 64, N 128, L 128), loaded
//     once by 16-byte cp.async.  Warp w takes row block w for dC (dy S_prev,
//     then Q = E (dy.x^T) dt_j over the causal tiles, then Q B) and column
//     block w for du and dB (B dS^T and x dS, then M^T and Q^T over the
//     causal tiles, then M^T dy and Q^T C): (w + 1) + (8 - w) tiles a warp.
//     The transposed tiles M^T = E (B C^T) and Q^T are formed directly in
//     their own orientation (rows j), not stored and read back with
//     ldmatrix.trans: the 36 causal bf16 tiles of M and Q would take 37 KB
//     beside the chunk, the state and dS (213 KB at P 64) and a block
//     barrier between the sides, while forming them costs the score
//     products again (3.5 of ~26 MFLOP a chunk) and keeps each warp's work
//     its own.  dcum's sums use the float32 accumulators (R = (C.B) Q, its
//     sums over j in each lane and over i across the quad, its sums over
//     a column block's rows by shuffles into a (block, step) table summed
//     in order).  S_prev and then dS come in by cp.async through a float32
//     staging buffer where it fits (not at P = N = 128); dS replaces
//     S_prev in the state's bf16 buffer right after the rows' state term,
//     so no barrier separates the row tiles from the column tiles (one
//     there would chain the longest row block's tiles to the longest
//     column block's: 960 mma.sync a warp against 792).
//  3. two serial walks of 128 blocks on the float32 cores, a one-thread
//     cumsum -> one launch of a (head, batch, direction) grid, the forward
//     and the reverse walk side by side (256 blocks): the forward kernel's
//     state update (its tiling, hi + lo split and order: the forward walk's
//     states are the forward kernel's), the next chunk by cp.async into a
//     second stage, the cumsum by one warp's shuffles (warp_cumsum, as the
//     forward and the chunk kernel take it).
// At the training shape on an H100 (chip_smoke.py phase 2, scripts/
// ssd_bwd_ab.py): 0.64-0.70 ms against 4.03-4.26 before; the walks 0.116
// ms, about twice the 0.06 ms of their bytes (x or dy in, the 67 MB
// states out); the chunk kernel 0.34 ms (0.41 with the barrier between
// its sides), 140 TFLOP/s of mma.sync.  What holds it back now: the
// float32 scratch between the kernels (the states, and dB and dC per
// head, 134 MB each) moves ~0.5 GB through device memory, and
// ssd_bwd_finish and ssd_bwd_reduce take 0.18 ms of the total; the chunk
// kernel runs one block of 8 warps an SM (182 KB of shared memory), so
// its loads are not overlapped with its products; mma.sync, not wgmma.

constexpr int TR = 32;  // rows of a float32 backward tile

struct BwdDims {
  int t_len, h, p, g, n, l, nc;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- the backward's float32 instance (float32 cores) -----------------------

struct F32BwdDims {
  int t_len, h, p, g, n, l, nc, vec, stages;
};

// P and N padded to the float32 chunk kernel's tiles: 32, 64 or 128.
__host__ __device__ inline int padded32(int v) {
  return v <= 32 ? 32 : v <= 64 ? 64 : 128;
}

// Shared memory of ssd_bwd_f32_walk: `stages` x [X (L x XS) | Y (L x YS)
// | dt (L)], then beta (L) and e^{cum_L} (4), in floats; XS and YS are P
// and N rounded up to 8.  Every part a multiple of 4 floats.
__host__ __device__ inline long long f32_walk_stage_floats(int l, int p,
                                                           int n) {
  return (long long)l * ((p + 7) / 8 * 8) + (long long)l * ((n + 7) / 8 * 8) +
         l;
}
__host__ __device__ inline long long f32_walk_bytes(int l, int p, int n,
                                                    int stages) {
  return 4 * (stages * f32_walk_stage_floats(l, p, n) + l + 4);
}
inline int f32_walk_stages(int l, int p, int n) {
  if (p <= 64) return 1;  // two blocks an SM: one loads while one computes
  return f32_walk_bytes(l, p, n, 2) <= MAX_SMEM ? 2 : 1;
}

// Shared memory of ssd_bwd_f32_chunk, in floats.  Streaming (to = 32): two
// stages of the own side's 32-row tiles and two of the other side's
// ([32 x (NP + 4) | 32 x (PP + 4)] each), the own X tile transposed (PP x
// 36), two 32 x 36 tiles (the pair's decayed scores, then the epilogue's
// partial sums), the state (PP x (NP + 4)), dt, cum and e (L each).  The
// whole chunk (to = L, 64 or 128): the other side's L rows once, and two L
// x 36 tiles, the second of which holds the own X tile transposed in the
// epilogue (PP <= L).  The whole chunk where it fits, else streaming:
// 231,936 bytes at PP = NP = 128, L = 128, the most.
__host__ __device__ inline long long f32_chunk_bytes(int l, int pp, int np,
                                                     int to) {
  const long long row = (np + 4) + (pp + 4);
  if (to == 32)
    return 4 * (4 * 32 * row + (long long)pp * 36 + 2 * 32 * 36 +
                (long long)pp * (np + 4) + 3LL * l);
  return 4 * (2 * 32 * row + (long long)l * row + 2LL * l * 36 +
              (long long)pp * (np + 4) + 3LL * l);
}
__host__ __device__ inline int f32_chunk_rows(int l, int pp, int np) {
  return l >= 64 && pp <= l && f32_chunk_bytes(l, pp, np, l) <= MAX_SMEM ? l
                                                                          : 32;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc (8 x 8, row-major) += A . B^T over the float4 chunks c = s, s + KS,
// ... < k4 of 8 rows of A (stride lda) and 8 rows of B (stride ldb): the
// k-slice s of a block that KS lanes share.
template <int KS>
__device__ __forceinline__ void nt_acc(float (&acc)[64], const float* a,
                                       int lda, const float* bt, int ldb,
                                       int k4, int s) {
#pragma unroll 1
  for (int c = s; c < k4; c += KS) {
    float4 av[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) av[m] = ld4(a + m * lda + 4 * c);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float4 bv = ld4(bt + n * ldb + 4 * c);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float v = acc[8 * m + n];
        v = fmaf(av[m].x, bv.x, v);
        v = fmaf(av[m].y, bv.y, v);
        v = fmaf(av[m].z, bv.z, v);
        v = fmaf(av[m].w, bv.w, v);
        acc[8 * m + n] = v;
      }
    }
  }
}

// acc (8 x 8) += AT^T . B over the rows k = k0 + s, k0 + s + KS, ... < k1:
// 8 consecutive values of row k of AT (stride lda) times 8 of row k of B
// (stride ldb), an outer product a k.
template <int KS>
__device__ __forceinline__ void nn_acc(float (&acc)[64], const float* at,
                                       int lda, const float* b, int ldb,
                                       int k0, int k1, int s) {
#pragma unroll 2
  for (int k = k0 + s; k < k1; k += KS) {
    const float4 a0 = ld4(at + k * lda), a1 = ld4(at + k * lda + 4);
    const float4 b0 = ld4(b + k * ldb), b1 = ld4(b + k * ldb + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        acc[8 * m + n] = fmaf(av[m], bv[n], acc[8 * m + n]);
  }
}

// The KS lanes of a block (lane % KS its slice s) fold their partial 8 x
// 8 blocks by shuffles, halving what each keeps a step: lane s ends with
// elements [64 / KS s, 64 / KS (s + 1)) of the row-major block in v[0 ..
// 64 / KS).  Every element is summed in one fixed order.
template <int KS, int O>
struct Fold {
  static __device__ __forceinline__ void run(float (&v)[64], int lane) {
    constexpr int HALF = 64 * O / KS;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int t = 0; t < HALF; ++t) {
      const float send = up ? v[t] : v[t + HALF];
      const float keep = up ? v[t + HALF] : v[t];
      v[t] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    Fold<KS, O / 2>::run(v, lane);
  }
};
template <int KS>
struct Fold<KS, 0> {
  static __device__ __forceinline__ void run(float (&)[64], int) {}
};
template <int KS>
__device__ __forceinline__ void fold(float (&v)[64], int lane) {
  Fold<KS, KS / 2>::run(v, lane);
}

__device__ __forceinline__ void zero64(float (&v)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] = 0.f;
}

// Both float32 state walks, a block per (head, batch, direction): S <-
// e^{cum_L} S + (X beta)^T Y over the chunks, the state entering each
// chunk written to out (Bb, H, chunks, P, N) first.  Forward (z = 0): X =
// x, Y = B, beta_j = e^{cum_L - cum_j} dt_j, S from 0; reverse (z = 1): X =
// dy, Y = C, beta_i = e^{cum_i}, S from dstate, the chunks last first.  A
// block of WT threads (128 at P <= 64, two blocks an SM; 256 above): lane
// l of warp w holds rows 8 (2 w + l / 16) .. + 7 and columns 8 (l % 16) ..
// + 7 of S in registers, and each step reads 8 values of X and 8 of Y for
// 64 multiply-adds.  Each element sums its chunk's terms over the steps in
// order and then takes S e^{cum_L} + sum, the float32 forward kernel's
// update (its states, up to the cumsum's order of sum).  X is scaled by
// beta in shared memory once a chunk, the product the forward forms a
// step.
template <int WT>
__global__ void __launch_bounds__(WT, WT == 128 ? 2 : 1)
    ssd_bwd_f32_walk(const float* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ B, const float* __restrict__ C,
                     const float* __restrict__ dstate,
                     float* __restrict__ states, float* __restrict__ dstates,
                     F32BwdDims dm) {
  const int H = dm.h, P = dm.p, N = dm.n, L = dm.l, G = dm.g, nc = dm.nc;
  const int XS = (P + 7) / 8 * 8, YS = (N + 7) / 8 * 8;
  const bool rev = blockIdx.z != 0;
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const int stage = (int)f32_walk_stage_floats(L, P, N);
  float* sbeta = base + dm.stages * stage;
  float* sel = sbeta + L;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float a_h = A[h];
  const long long x_t = (long long)H * P, y_t = (long long)G * N;
  const float* Xb =
      (rev ? dy : x) + (long long)b * dm.t_len * x_t + (long long)h * P;
  const float* Yb =
      (rev ? C : B) + (long long)b * dm.t_len * y_t + (long long)g * N;
  const float* dtb = dt + (long long)b * dm.t_len * H + h;
  const long long pn = (long long)P * N;
  float* ob = (rev ? dstates : states) + ((long long)b * H + h) * nc * pn;

  // the padding columns of X (P .. XS) and Y (N .. YS) stay 0: loads
  // write columns < P, < N only
  for (int i = tid; i < dm.stages * stage / 4; i += WT)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  auto load_chunk = [&](int ci, int st) {
    float* sX = base + st * stage;
    float* sY = sX + L * XS;
    float* sdt = sY + L * YS;
    const long long c0 = (long long)ci * L;
    if (dm.vec) {
      const int P4 = P / 4, N4 = N / 4;
      for (int i = tid; i < L * P4; i += WT) {
        const int j = i / P4, c = 4 * (i - j * P4);
        cp_async16(smem_u32(sX + j * XS + c), Xb + (c0 + j) * x_t + c);
      }
      for (int i = tid; i < L * N4; i += WT) {
        const int j = i / N4, c = 4 * (i - j * N4);
        cp_async16(smem_u32(sY + j * YS + c), Yb + (c0 + j) * y_t + c);
      }
    } else {
      for (int i = tid; i < L * P; i += WT) {
        const int j = i / P, q = i - j * P;
        sX[j * XS + q] = Xb[(c0 + j) * x_t + q];
      }
      for (int i = tid; i < L * N; i += WT) {
        const int j = i / N, q = i - j * N;
        sY[j * YS + q] = Yb[(c0 + j) * y_t + q];
      }
    }
    for (int j = tid; j < L; j += WT)
      cp_async4(smem_u32(sdt + j), dtb + (c0 + j) * H);
    cp_async_commit();
  };

  const int p0 = 8 * (2 * warp + (lane >> 4)), n0 = 8 * (lane & 15);
  const bool live = p0 < P && n0 < N;
  const float* init = rev ? dstate + ((long long)b * H + h) * pn : nullptr;
  float st[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      st[i][e] = (init && p0 + i < P && n0 + e < N)
                     ? init[(long long)(p0 + i) * N + n0 + e]
                     : 0.f;

  if (nc > 0) load_chunk(rev ? nc - 1 : 0, 0);
  for (int k = 0; k < nc; ++k) {
    const int ci = rev ? nc - 1 - k : k;
    const int cur = dm.stages == 2 ? (k & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // chunk k landed; every reader of chunk k-1 done
    if (dm.stages == 2 && k + 1 < nc)
      load_chunk(rev ? ci - 1 : ci + 1, cur ^ 1);
    float* sX = base + cur * stage;
    const float* sY = sX + L * XS;
    const float* sdt = sY + L * YS;

    float* oc = ob + (long long)ci * pn;
    if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (p0 + i >= P) continue;
        float* orow = oc + (long long)(p0 + i) * N + n0;
        *reinterpret_cast<float4*>(orow) =
            make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
        if (n0 + 4 < N)
          *reinterpret_cast<float4*>(orow + 4) =
              make_float4(st[i][4], st[i][5], st[i][6], st[i][7]);
      }
    }
    if (warp == 0) {  // cumsum(dt * A), beta and e^{cum_L}
      const int E = L / 32;
      float v[4];
      const float last = warp_cumsum(sdt, a_h, L, lane, v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < E) {
          const int j = E * lane + e;
          sbeta[j] = rev ? expf(v[e]) : expf(last - v[e]) * sdt[j];
        }
      if (lane == 0) sel[0] = expf(last);
    }
    __syncthreads();  // beta and e^{cum_L} written
    for (int i = tid; i < L * P; i += WT) {
      const int j = i / P, q = i - j * P;
      sX[j * XS + q] *= sbeta[j];
    }
    __syncthreads();  // X scaled
    const float el = sel[0];
    if (live) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
#pragma unroll 2
      for (int j = 0; j < L; ++j) {
        const float4 x0 = ld4(sX + j * XS + p0), x1 = ld4(sX + j * XS + p0 + 4);
        const float4 y0 = ld4(sY + j * YS + n0), y1 = ld4(sY + j * YS + n0 + 4);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[i][e] = fmaf(xv[i], yv[e], acc[i][e]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) st[i][e] = st[i][e] * el + acc[i][e];
    }
    if (dm.stages == 1 && k + 1 < nc) {
      __syncthreads();  // every reader of the single stage done
      load_chunk(rev ? ci - 1 : ci + 1, 0);
    }
  }
}

// The float32 chunk kernel: a block of 256 threads per (chunk, role,
// head, batch).  The row role (role 0) takes its own row tiles i of 32
// steps (C_i, dy_i) against the column steps j <= i (B_j, x_j): dC_i and
// R's row sums, then e^{cum_i} S_prev^T dy_i.  The column role (role 1)
// takes its own column tiles j of 32 steps (B_j, x_j) against the row
// steps i >= j (C_i, dy_i): du_j (dx_j, x_j.du_j), dB_j and R's column
// sums, then w_j dS B_j and w_j dS^T u_j.  The other side is held whole
// (TO = L, loaded once) where it fits, else streamed in 32-row tiles (TO =
// 32).  A step is one (own, other) pair of tiles; the next step's tiles
// (and the next own tile) arrive by 16-byte cp.async while this one
// computes.  Every product
// is register-tiled, 8 x 8 outputs a thread: the scores (C.B and dy.x, 32
// x TO) with 256 / (TO / 2) lanes a block over the contraction (float4
// along N or P), the others an outer product a contraction step over 2 + 2
// float4 of operands laid out along the outputs; lanes sharing a block
// fold by shuffles (Fold).  Blocks of a pair's scores that the causal mask
// clears are not computed, and the products over the pair's steps stop at
// the mask.  The column role's du and dB run side by side in warps 0-3
// and 4-7.  P and N are padded with zeros to PP, NP in {32, 64, 128}.
template <int PP, int NP, int TO>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_f32_chunk(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ B,
                      const float* __restrict__ C, const float* __restrict__ dy,
                      const float* __restrict__ states,
                      const float* __restrict__ dstates,
                      float* __restrict__ dBp, float* __restrict__ dCp,
                      float* __restrict__ rows, float* __restrict__ dx,
                      F32BwdDims dm, int batch) {
  constexpr int NS = NP + 4, PS = PP + 4, TS = 36, RS = 48;
  constexpr bool WHOLE = TO > TR;        // the other side held whole
  constexpr int OWN_F = TR * (NS + PS);  // an own A tile and X tile
  constexpr int OTH_F = TO * (NS + PS);  // the other side's
  constexpr int SKS = 512 / TO;          // the scores' slices: 16, 8 or 4
  constexpr int SCNT = 64 / SKS;         // a lane's scores after the fold
  constexpr int RPLS = SCNT >= 8 ? SCNT / 8 : 1;  // its rows
  constexpr int LPRS = SCNT < 8 ? 8 / SCNT : 1;   // lanes a row of a block
  constexpr int SSLOTS = TO / 8 * LPRS;           // partial sums a row
  constexpr int KS2 = 512 / NP;  // row role's slices of dC (4 x NP / 8 blocks)
  constexpr int KSD = 256 / PP;  // column role's of du (warps 0-3)
  constexpr int KSB = 256 / NP;  // and of dB (warps 4-7)
  const int H = dm.h, P = dm.p, N = dm.n, L = dm.l, G = dm.g;
  const int nt = L / TR, nto = L / TO;
  extern __shared__ float4 smem4[];
  float* own = reinterpret_cast<float*>(smem4);  // 2 stages
  float* oth = own + 2 * OWN_F;                  // 2 stages, or 1 whole
  float* sT1 = oth + (WHOLE ? 1 : 2) * OTH_F;    // TO x TS
  float* sT2 = sT1 + TO * TS;                    // TO x TS
  // own X^T (PP x TS): past T2 when streaming, in T2 when whole (built in
  // the epilogue, when T2 is free)
  float* sT = WHOLE ? sT2 : sT2 + TO * TS;
  float* sS = sT + (WHOLE ? TO * TS : PP * TS);  // PP x NS
  float* sdt = sS + PP * NS;
  float* scum = sdt + L;
  float* sev = scum + L;  // row role e^{cum}, column role e^{cum_L - cum}
  float* red = sT1;       // the epilogue's partial sums: TR rows of RS

  const int ci = blockIdx.x >> 1, role = blockIdx.x & 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long x_t = (long long)H * P, bc_t = (long long)G * N;
  const long long T_ = dm.t_len, c0 = (long long)ci * L;
  const float* xc = x + ((long long)b * T_ + c0) * x_t + (long long)h * P;
  const float* dyc = dy + ((long long)b * T_ + c0) * x_t + (long long)h * P;
  const float* Bc = B + ((long long)b * T_ + c0) * bc_t + (long long)g * N;
  const float* Cc = C + ((long long)b * T_ + c0) * bc_t + (long long)g * N;
  const long long sidx = (((long long)b * H + h) * dm.nc + ci) * P * N;
  const long long bth = (long long)batch * T_ * H;
  // the own side's rows: row role C_i, dy_i; column role B_j, x_j
  const float* ownA = role ? Bc : Cc;
  const float* ownX = role ? xc : dyc;
  const float* othA = role ? Cc : Bc;
  const float* othX = role ? dyc : xc;

  // padding rows and columns stay 0: loads write only p < P, n < N
  if (P < PP || N < NP) {
    const int total4 = (int)(sS + PP * NS + 3 * L -
                             reinterpret_cast<float*>(smem4)) / 4;
    for (int i = tid; i < total4; i += THREADS)
      smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

  // rows [r0, r0 + rows) of a (T, cols) view of row stride ld into shared
  // rows of stride ls
  auto load_tile = [&](float* dst, int ls, const float* src, long long ld,
                       int r0, int rows, int cols) {
    if (dm.vec) {
      const int c4 = cols / 4;
      for (int i = tid; i < rows * c4; i += THREADS) {
        const int r = i / c4, c = 4 * (i - r * c4);
        cp_async16(smem_u32(dst + r * ls + c),
                   src + (long long)(r0 + r) * ld + c);
      }
    } else {
      for (int i = tid; i < rows * cols; i += THREADS) {
        const int r = i / cols, c = i - r * cols;
        dst[r * ls + c] = src[(long long)(r0 + r) * ld + c];
      }
    }
  };
  // step k's tiles: the other side's tile q into stage k & 1, and the own
  // tile o into stage o & 1 when the step starts it
  auto load_step = [&](int o, int q, int k, bool own_new) {
    if (!WHOLE || k == 0) {  // the whole other side once
      float* t = oth + (WHOLE ? 0 : (k & 1)) * OTH_F;
      load_tile(t, NS, othA, bc_t, TO * q, TO, N);
      load_tile(t + TO * NS, PS, othX, x_t, TO * q, TO, P);
    }
    if (own_new) {
      float* w = own + (o & 1) * OWN_F;
      load_tile(w, NS, ownA, bc_t, TR * o, TR, N);
      load_tile(w + TR * NS, PS, ownX, x_t, TR * o, TR, P);
    }
    cp_async_commit();
  };
  // the other side's tiles a step of own tile o takes: row role q <= its
  // last row's, column role q >= its first row's
  auto q_first = [&](int o) { return role ? TR * o / TO : 0; };
  auto q_last = [&](int o) { return role ? nto - 1 : (TR * o + TR - 1) / TO; };

  {  // the state (row role S_prev, column role dS), dt, the first step
    const float* st = (role ? dstates : states) + sidx;
    const int n4 = N / 4;
    for (int i = tid; i < P * n4; i += THREADS) {
      const int p = i / n4, c = 4 * (i - p * n4);
      cp_async16(smem_u32(sS + p * NS + c), st + (long long)p * N + c);
    }
    const float* dtc = dt + ((long long)b * T_ + c0) * H + h;
    for (int j = tid; j < L; j += THREADS)
      cp_async4(smem_u32(sdt + j), dtc + (long long)j * H);
    load_step(0, 0, 0, true);
  }

  // the scores' blocks: 4 x TO / 8 of 8 x 8, SKS lanes each; after the
  // fold a lane holds elements SCNT ss .. SCNT (ss + 1) - 1 of its block,
  // RPLS rows from sr, columns from scl, and its partial row sums go to
  // slot sslot of each row's SSLOTS
  const int ss = tid % SKS, sb = tid / SKS, sbm = sb & 3, sbn = sb >> 2;
  const int sr = 8 * sbm + SCNT * ss / 8, scl = 8 * sbn + SCNT * ss % 8;
  const int sslot = sbn * LPRS + SCNT * ss % 8 / SCNT;
  float acc[64];       // row role dC, column role du (warps 0-3) or dB
  float rsum[RPLS];    // R's row (row role) or column (column role) sums
  float tsum = 0.f;   // column role, threads < 32: T_j over the own tiles
  zero64(acc);
#pragma unroll
  for (int r = 0; r < RPLS; ++r) rsum[r] = 0.f;

  int o = 0, q = 0;
  for (int k = 0;; ++k) {
    cp_async_wait_all();
    __syncthreads();  // step k landed; every reader of step k - 1 done
    if (k == 0) {
      if (warp == 0) {
        float v[4];
        const int E = L / 32;
        const float last = warp_cumsum(sdt, A[h], L, lane, v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < E) {
            const int j = E * lane + e;
            scum[j] = v[e];
            sev[j] = role ? expf(last - v[e]) : expf(v[e]);
          }
      }
      __syncthreads();  // cum and e written
    }
    const bool last = q == q_last(o);
    const int o2 = last ? o + 1 : o;  // the next step, its tiles issued now
    const int q2 = last ? (o2 < nt ? q_first(o2) : 0) : q + 1;
    if (o2 < nt) load_step(o2, q2, k + 1, o2 != o);
    const float* oA = own + (o & 1) * OWN_F;
    const float* oX = oA + TR * NS;
    const float* tA = oth + (WHOLE ? 0 : (k & 1)) * OTH_F;
    const float* tX = tA + TO * NS;
    // the other tile's steps the causal mask keeps: row role j <= its own
    // tile's last row, column role i >= its first
    const int klo = role ? max(0, TR * o - TO * q) : 0;
    const int khi = role ? TO : min(TO, TR * (o + 1) - TO * q);

    // X^T of the own tile: row role dy_i^T, column role u_j^T = (dt_j
    // x_j)^T (its first step when streaming, its epilogue when whole)
    auto build_t = [&]() {
      for (int i = tid; i < PP * TR; i += THREADS) {
        const int p = i / TR, r = i - p * TR;
        float v = oX[r * PS + p];
        if (role) v *= sdt[TR * o + r];
        sT[p * TS + r] = v;
      }
    };
    if (q == q_first(o)) {  // the own tile's first step
      if (!WHOLE) build_t();
      zero64(acc);
#pragma unroll
      for (int r = 0; r < RPLS; ++r) rsum[r] = 0.f;
    }

    // the pair's scores: C.B over N and dy.x over P (row role rows i of
    // its own tile, columns j; column role rows j, columns i)
    float cb[SCNT], gx[SCNT];
    {
      // a block the mask clears: j > i on all of it (row role), or i < j
      const bool live = role ? TO * q + 8 * sbn + 7 >= TR * o + 8 * sbm
                             : TO * q + 8 * sbn <= TR * o + 8 * sbm + 7;
      float sacc[64];
      zero64(sacc);
      if (live)
        nt_acc<SKS>(sacc, oA + 8 * sbm * NS, NS, tA + 8 * sbn * NS, NS,
                    NP / 4, ss);
      fold<SKS>(sacc, lane);
#pragma unroll
      for (int e = 0; e < SCNT; ++e) cb[e] = sacc[e];
      zero64(sacc);
      if (live)
        nt_acc<SKS>(sacc, oX + 8 * sbm * PS, PS, tX + 8 * sbn * PS, PS,
                    PP / 4, ss);
      fold<SKS>(sacc, lane);
#pragma unroll
      for (int e = 0; e < SCNT; ++e) gx[e] = sacc[e];
    }
#pragma unroll
    for (int e = 0; e < SCNT; ++e) {
      const int rl = sr + e / 8, cl = scl + e % 8;  // own row, other column
      const int r = SCNT >= 8 ? e / 8 : 0;
      if (role == 0) {
        const int i = TR * o + rl, j = TO * q + cl;
        const float ee = j <= i ? expf(scum[i] - scum[j]) : 0.f;
        const float qv = gx[e] * sdt[j] * ee;  // e (dy_i . u_j)
        rsum[r] = fmaf(cb[e], qv, rsum[r]);
        sT1[cl * TS + rl] = qv;                // Q^T (j, i)
      } else {
        const int j = TR * o + rl, i = TO * q + cl;
        const float ee = j <= i ? expf(scum[i] - scum[j]) : 0.f;
        const float qv = gx[e] * sdt[j] * ee;
        rsum[r] = fmaf(cb[e], qv, rsum[r]);
        sT1[cl * TS + rl] = cb[e] * ee;        // M (i, j)
        sT2[cl * TS + rl] = qv;                // Q (i, j)
      }
    }
    __syncthreads();  // the pair's decayed scores written
    if (role == 0) {  // dC_i += Q_ij B_j
      const int s = tid % KS2, bb = tid / KS2;
      nn_acc<KS2>(acc, sT1 + 8 * (bb & 3), TS, tA + 8 * (bb >> 2), NS, klo,
                  khi, s);
    } else if (warp < 4) {  // du_j += M_ij dy_i
      const int s = tid % KSD, bb = tid / KSD;
      nn_acc<KSD>(acc, sT1 + 8 * (bb & 3), TS, tX + 8 * (bb >> 2), PS, klo,
                  khi, s);
    } else {  // dB_j += Q_ij C_i
      const int t = tid - 128, s = t % KSB, bb = t / KSB;
      nn_acc<KSB>(acc, sT2 + 8 * (bb & 3), TS, tA + 8 * (bb >> 2), NS, klo,
                  khi, s);
    }

    if (WHOLE && last) {  // X^T into T2, free once every product read it
      __syncthreads();
      build_t();
      __syncthreads();
    }
    if (role == 0 && last) {
      // the row tile's end: dC_i = sum_j Q_ij B_j + e^{cum_i} S_prev^T dy_i
      constexpr int CNT = 64 / KS2, RPL = CNT >= 8 ? CNT / 8 : 1;
      constexpr int LPR = CNT < 8 ? 8 / CNT : 1;
      const int s = tid % KS2, bb = tid / KS2, bm = bb & 3, bn = bb >> 2;
      const int e0 = CNT * s;
      fold<KS2>(acc, lane);
      float v3[64];
      zero64(v3);
      nn_acc<KS2>(v3, sT + 8 * bm, TS, sS + 8 * bn, NS, 0, PP, s);
      fold<KS2>(v3, lane);
      float part[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r) part[r] = 0.f;
#pragma unroll
      for (int e = 0; e < CNT; e += 4) {
        const int rr = 8 * bm + (e0 + e) / 8, col = 8 * bn + (e0 + e) % 8;
        if (col < N) {
          const float ev = sev[TR * o + rr];
          const long long row = (long long)b * T_ + c0 + TR * o + rr;
          float out[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float v = ev * v3[e + u];
            out[u] = acc[e + u] + v;
            part[e / 8] = fmaf(oA[rr * NS + col + u], v, part[e / 8]);
          }
          *reinterpret_cast<float4*>(dCp + (row * H + h) * N + col) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      }
      __syncthreads();  // every reader of T1 done
#pragma unroll
      for (int r = 0; r < RPLS; ++r) red[(sr + r) * RS + sslot] = rsum[r];
#pragma unroll
      for (int r = 0; r < RPL; ++r)
        red[(8 * bm + e0 / 8 + r) * RS + 16 + bn * LPR + (e0 % 8) / CNT] =
            part[r];
      __syncthreads();
      if (tid < TR) {
        float s1 = 0.f, s2 = 0.f;
        for (int u = 0; u < SSLOTS; ++u) s1 += red[tid * RS + u];
        for (int u = 0; u < (NP / 8) * LPR; ++u) s2 += red[tid * RS + 16 + u];
        rows[((long long)b * T_ + c0 + TR * o + tid) * H + h] = s1 + s2;
      }
    } else if (role == 1 && last) {
      // the column tile's end: du_j += w_j dS B_j (warps 0-3), dB_j +=
      // w_j dS^T u_j (warps 4-7), and the steps' sums
      constexpr int CNTD = 64 / KSD, RPL = CNTD / 8;
      const int sd = tid % KSD, bd = tid / KSD, e0 = CNTD * sd;
      const int bmd = bd & 3, bnd = bd >> 2;
      float tp[RPL], xd[RPL];
#pragma unroll
      for (int r = 0; r < RPL; ++r) tp[r] = xd[r] = 0.f;
      if (warp < 4) {
        fold<KSD>(acc, lane);
        float v4[64];
        zero64(v4);
        nt_acc<KSD>(v4, oA + 8 * bmd * NS, NS, sS + 8 * bnd * NS, NS,
                    NP / 4, sd);
        fold<KSD>(v4, lane);
#pragma unroll
        for (int e = 0; e < CNTD; e += 4) {
          const int rr = 8 * bmd + (e0 + e) / 8;
          const int col = 8 * bnd + (e0 + e) % 8;
          if (col < P) {
            const int j = TR * o + rr;
            const float wj = sev[j], dtj = sdt[j];
            const long long row = (long long)b * T_ + c0 + j;
            float out[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float sv = wj * v4[e + u];
              const float d = acc[e + u] + sv;
              const float xv = oX[rr * PS + col + u];
              tp[e / 8] = fmaf(xv * dtj, sv, tp[e / 8]);
              xd[e / 8] = fmaf(xv, d, xd[e / 8]);
              out[u] = dtj * d;
            }
            *reinterpret_cast<float4*>(dx + row * x_t + (long long)h * P +
                                       col) =
                make_float4(out[0], out[1], out[2], out[3]);
          }
        }
      } else {
        constexpr int CNT = 64 / KSB;
        const int t = tid - 128, s = t % KSB, bb = t / KSB;
        const int bm = bb & 3, bn = bb >> 2, e1 = CNT * s;
        fold<KSB>(acc, lane);
        float v5[64];
        zero64(v5);
        nn_acc<KSB>(v5, sT + 8 * bm, TS, sS + 8 * bn, NS, 0, PP, s);
        fold<KSB>(v5, lane);
#pragma unroll
        for (int e = 0; e < CNT; e += 4) {
          const int rr = 8 * bm + (e1 + e) / 8, col = 8 * bn + (e1 + e) % 8;
          if (col < N) {
            const int j = TR * o + rr;
            const float wj = sev[j];
            const long long row = (long long)b * T_ + c0 + j;
            float out[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) out[u] = acc[e + u] + wj * v5[e + u];
            *reinterpret_cast<float4*>(dBp + (row * H + h) * N + col) =
                make_float4(out[0], out[1], out[2], out[3]);
          }
        }
      }
      __syncthreads();  // every reader of T1, T2 done
#pragma unroll
      for (int r = 0; r < RPLS; ++r) red[(sr + r) * RS + sslot] = rsum[r];
      if (warp < 4) {
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          red[(8 * bmd + e0 / 8 + r) * RS + 16 + bnd] = tp[r];
          red[(8 * bmd + e0 / 8 + r) * RS + 32 + bnd] = xd[r];
        }
      }
      __syncthreads();
      if (tid < TR) {
        float cs = 0.f, tpv = 0.f, xdv = 0.f;
        for (int u = 0; u < SSLOTS; ++u) cs += red[tid * RS + u];
        for (int u = 0; u < PP / 8; ++u) {
          tpv += red[tid * RS + 16 + u];
          xdv += red[tid * RS + 32 + u];
        }
        const long long row = (long long)b * T_ + c0 + TR * o + tid;
        rows[bth + row * H + h] = -cs - tpv;
        rows[2 * bth + row * H + h] = xdv;
        tsum += tpv;
      }
    }
    if (o2 >= nt) break;
    o = o2;
    q = q2;
  }

  if (role == 1) {
    // the chunk's last step: dcum_L += sum_j T_j + e^{cum_L} <dS, S_prev>
    const float* sp = states + sidx;
    float dot = 0.f;
    for (int i = tid; i < P * N; i += THREADS)
      dot = fmaf(sS[(i / N) * NS + i % N], sp[i], dot);
    dot = warp_sum(dot);
    __syncthreads();  // the last tile's sums read
    if (lane == 0) red[warp] = dot;
    if (tid < TR) red[8 + tid] = tsum;
    __syncthreads();  // and the lane-0 writes of rows are visible
    if (tid == 0) {
      float ts = 0.f, d = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) d += red[w];
      for (int r = 0; r < TR; ++r) ts += red[8 + r];
      rows[bth + ((long long)b * T_ + c0 + L - 1) * H + h] +=
          ts + expf(scum[L - 1]) * d;
    }
  }
}

// A thread per (batch, chunk, head): rc = reverse cumsum of dcum (its row
// and column parts), ddt_j = x_j.du_j + A rc_j, dA's part sum_j dt_j rc_j.
__global__ void __launch_bounds__(128)
    ssd_bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
                   const float* __restrict__ rows, float* __restrict__ ddt,
                   float* __restrict__ dAp, BwdDims dm, int batch) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int H = dm.h, L = dm.l, nc = dm.nc;
  if (item >= (long long)batch * nc * H) return;
  const int h = (int)(item % H);
  const long long bc = item / H;
  const int c = (int)(bc % nc), b = (int)(bc / nc);
  const long long bth = (long long)batch * dm.t_len * H;
  const float a_h = A[h];
  float rc = 0.f, da = 0.f;
  for (int j = L - 1; j >= 0; --j) {
    const long long o = ((long long)b * dm.t_len + (long long)c * L + j) * H + h;
    rc += rows[o] + rows[bth + o];
    ddt[o] = rows[2 * bth + o] + a_h * rc;
    da = fmaf(dt[o], rc, da);
  }
  dAp[((long long)b * H + h) * nc + c] = da;
}

// dB, dC (Bb, T, G, N) in the input type: the heads of each group summed
// in order; dA (H,) over batch and chunks in order (block 0).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_reduce(const float* __restrict__ dBp, const float* __restrict__ dCp,
                   const float* __restrict__ dAp, T* __restrict__ dB,
                   T* __restrict__ dC, float* __restrict__ dA, BwdDims dm,
                   int batch) {
  const int H = dm.h, G = dm.g, N = dm.n, rep = H / G;
  const long long total = (long long)batch * dm.t_len * G * N;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int n = (int)(i % N);
    const long long rg = i / N;
    const int g = (int)(rg % G);
    const long long bt = rg / G;
    const long long o = (bt * H + (long long)g * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < rep; ++k) {
      sb += dBp[o + (long long)k * N];
      sc += dCp[o + (long long)k * N];
    }
    store(dB + i, sb);
    store(dC + i, sc);
  }
  if (blockIdx.x == 0)
    for (int hh = threadIdx.x; hh < H; hh += THREADS) {
      float s = 0.f;
      for (int b = 0; b < batch; ++b)
        for (int c = 0; c < dm.nc; ++c)
          s += dAp[((long long)b * H + hh) * dm.nc + c];
      dA[hh] = s;
    }
}

// ---- the backward's bfloat16 instance (tensor cores) ------------------------

struct MmaBwdDims {
  int t_len, h, p, g, n, l, nc, vec;
};

// Shared memory of ssd_bwd_walk, in bytes: two stages of [X (L x XS bf16)
// | Y (L x BS bf16) | dt (L floats)], then beta and e^{cum_L} (L floats
// each).  XS = PP + 8, BS = NP + 8; every part a multiple of 16 bytes.
__host__ __device__ inline long long walk_stage_bytes(int l, int pp, int np) {
  return 2LL * l * (pp + 8) + 2LL * l * (np + 8) + 4LL * l;
}
__host__ __device__ inline long long walk_smem_bytes(int l, int pp, int np) {
  return 2 * walk_stage_bytes(l, pp, np) + 8LL * l;
}

// Shared memory of ssd_bwd_mma_chunk, in bytes, without the float32
// staging of S_prev and then dS (PP x NP floats after the bf16 parts,
// where it fits): x and dy
// (L x XS bf16 each), B and C (L x BS), the state's bf16 hi and lo (PP x
// BS each), then dt, cum log2(e), e^cum and e^{cum_L - cum} (L floats
// each), the column blocks' parts of R's row sums (L / 16 x L), three sums
// a step (L each) and 32 floats.
__host__ __device__ inline long long chunk_core_bytes(int l, int pp, int np) {
  return 4LL * l * (pp + 8) + 4LL * l * (np + 8) + 4LL * pp * (np + 8) +
         4LL * (7 + l / 16) * l + 128;
}
__host__ __device__ inline bool chunk_stages_f32(int l, int pp, int np) {
  return chunk_core_bytes(l, pp, np) + 4LL * pp * np <= MAX_SMEM;
}
__host__ __device__ inline long long chunk_smem_bytes(int l, int pp, int np) {
  return chunk_core_bytes(l, pp, np) +
         (chunk_stages_f32(l, pp, np) ? 4LL * pp * np : 0);
}

// Rows [0, L) of a (T, cols) bf16 view with row stride ld into shared rows
// of stride ls, columns [cols, CP) zeroed: 16-byte cp.async where vec,
// else element by element.
template <int CP>
__device__ __forceinline__ void load_rows(bf16* dst, int ls, const bf16* src,
                                          long long ld, int cols, int L,
                                          bool vec, int tid, int nthr) {
  if (vec) {
    for (int i = tid; i < L * (CP / 8); i += nthr) {
      const int r = i / (CP / 8), c = 8 * (i % (CP / 8));
      bf16* d = dst + r * ls + c;
      if (c < cols)
        cp_async16(smem_u32(d), src + r * ld + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < L * CP; i += nthr) {
      const int r = i / CP, q = i - r * CP;
      dst[r * ls + q] = q < cols ? src[r * ld + q] : __float2bfloat16(0.f);
    }
  }
}

// A (P x N) float32 state into bf16 hi + lo (PP rows of stride NP + 8,
// zero outside P x N).  With `dot`, each element's old hi + lo (the state
// it replaces) times the new value is summed, in the thread's order, into
// the result.
template <int PP, int NP>
__device__ __forceinline__ float split_state(bf16* hi, bf16* lo,
                                             const float* src, int P, int N,
                                             bool dot, int tid, int nthr) {
  constexpr int BS = NP + 8, G4 = NP / 4;
  float acc = 0.f;
  for (int i = tid; i < PP * G4; i += nthr) {
    const int p = i / G4, n = 4 * (i % G4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < P && n < N)
      v = *reinterpret_cast<const float4*>(src + (long long)p * N + n);
    uint2* ph = reinterpret_cast<uint2*>(hi + p * BS + n);
    uint2* pl = reinterpret_cast<uint2*>(lo + p * BS + n);
    if (dot) {
      const uint2 oh = *ph, ol = *pl;
      const float2 h0 =
          __bfloat1622float2(*reinterpret_cast<const bf162*>(&oh.x));
      const float2 h1 =
          __bfloat1622float2(*reinterpret_cast<const bf162*>(&oh.y));
      const float2 l0 =
          __bfloat1622float2(*reinterpret_cast<const bf162*>(&ol.x));
      const float2 l1 =
          __bfloat1622float2(*reinterpret_cast<const bf162*>(&ol.y));
      acc = fmaf(h0.x + l0.x, v.x, acc);
      acc = fmaf(h0.y + l0.y, v.y, acc);
      acc = fmaf(h1.x + l1.x, v.z, acc);
      acc = fmaf(h1.y + l1.y, v.w, acc);
    }
    const bf162 a = __floats2bfloat162_rn(v.x, v.y);
    const bf162 c = __floats2bfloat162_rn(v.z, v.w);
    const float2 af = __bfloat1622float2(a), cf = __bfloat1622float2(c);
    uint2 hv, lv;
    hv.x = *reinterpret_cast<const uint32_t*>(&a);
    hv.y = *reinterpret_cast<const uint32_t*>(&c);
    lv.x = pack_bf16(v.x - af.x, v.y - af.y);
    lv.y = pack_bf16(v.z - cf.x, v.w - cf.y);
    *ph = hv;
    *pl = lv;
  }
  return acc;
}

// acc (16 x 8 NTT) += a (16 x 16 KS) . S, S (16 KS x 8 NTT) stored by rows
// k of stride ls: transposed ldmatrix, two column tiles a load.
template <int KS, int NTT>
__device__ __forceinline__ void mma_rows_k(float (&acc)[NTT][4],
                                           const uint32_t (&a)[KS][4],
                                           const bf16* s, int ls, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int nt = 0; nt < NTT; nt += 2) {
      uint32_t t4[4];
      ldsm_x4_t(smem_u32(s + (16 * kk + (lane & 15)) * ls + 8 * nt +
                         (lane >> 4) * 8),
                t4);
      mma16816(acc[nt], a[kk], t4[0], t4[1]);
      mma16816(acc[nt + 1], a[kk], t4[2], t4[3]);
    }
}

// acc (16 x 8 NTT) += a (16 x 16 KS) . M^T, M (8 NTT x 16 KS) stored by
// rows n of stride ls: ldmatrix, two column tiles a load.
template <int KS, int NTT>
__device__ __forceinline__ void mma_rows_n(float (&acc)[NTT][4],
                                           const uint32_t (&a)[KS][4],
                                           const bf16* m, int ls, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int nt = 0; nt < NTT; nt += 2) {
      uint32_t t4[4];
      ldsm_x4(smem_u32(m + (8 * nt + (lane & 7) + (lane >> 4) * 8) * ls +
                       16 * kk + ((lane >> 3) & 1) * 8),
              t4);
      mma16816(acc[nt], a[kk], t4[0], t4[1]);
      mma16816(acc[nt + 1], a[kk], t4[2], t4[3]);
    }
}

// A fragments (16 x 16 KS) of rows r0.. of a shared bf16 matrix of stride
// ls.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* m,
                                       int ls, int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(smem_u32(m + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ls +
                     16 * kk + (lane >> 4) * 8),
            a[kk]);
}

// The 16 x 16 score tile a . m^T over rows m0.. of m (16 KS wide): two
// column tiles, each summed over two accumulators (k-step parity).
template <int KS>
__device__ __forceinline__ void score_tile(float (&sc)[2][4],
                                           const uint32_t (&a)[KS][4],
                                           const bf16* m, int ls, int m0,
                                           int lane) {
  float acc[2][2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][v][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t bb[4];
    ldsm_x4(smem_u32(m + (m0 + (lane & 7) + (lane >> 4) * 8) * ls + 16 * kk +
                     ((lane >> 3) & 1) * 8),
            bb);
    mma16816(acc[0][kk & 1], a[kk], bb[0], bb[1]);
    mma16816(acc[1][kk & 1], a[kk], bb[2], bb[3]);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[u][e] = acc[u][0][e] + acc[u][1][e];
}

// The bf16 A fragment of a 16 x 16 tile held as two accumulator tiles
// (FlashAttention-2's reuse: m16n8k16's accumulator layout is its A
// layout).
__device__ __forceinline__ void tile_as_a(uint32_t (&a)[1][4],
                                          const float (&t)[2][4]) {
  a[0][0] = pack_bf16(t[0][0], t[0][1]);
  a[0][1] = pack_bf16(t[0][2], t[0][3]);
  a[0][2] = pack_bf16(t[1][0], t[1][1]);
  a[0][3] = pack_bf16(t[1][2], t[1][3]);
}

// The sum over the four lanes of an accumulator row (lanes 4 r .. 4 r + 3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Both state walks, a block per (head, batch, direction): S <- e^{cum_L} S
// + (X beta)^T Y over the chunks, the state entering each step written to
// out (Bb, H, chunks, P, N) first.  Forward (z = 0): X = x, Y = B, beta_j =
// e^{cum_L - cum_j} dt_j, S from 0 (the forward kernel's update: its warp
// tiling, hi + lo split and order).  Reverse (z = 1): X = dy, Y = C,
// beta_i = e^{cum_i}, S from dstate, the chunks last first.
template <int PP, int NP>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_bwd_walk(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const bf16* __restrict__ B, const bf16* __restrict__ C,
                 const float* __restrict__ dstate, float* __restrict__ states,
                 float* __restrict__ dstates, MmaBwdDims dm) {
  constexpr int XS = PP + 8, BS = NP + 8;
  constexpr int NT = NP / 8;
  constexpr int WM = PP / 16, WN = 8 / WM;
  constexpr int ST = (NT + WN - 1) / WN;
  constexpr bool SFULL = NT % WN == 0;
  const int H = dm.h, P = dm.p, N = dm.n, L = dm.l, G = dm.g, nc = dm.nc;
  const bool rev = blockIdx.z != 0;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int stage_bytes = (int)walk_stage_bytes(L, PP, NP);
  float* sbeta = reinterpret_cast<float*>(base + 2 * stage_bytes);
  float* sel = sbeta + L;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const float a_h = A[h];
  const long long x_t = (long long)H * P, y_t = (long long)G * N;
  const bf16* Xb =
      (rev ? dy : x) + (long long)b * dm.t_len * x_t + (long long)h * P;
  const bf16* Yb =
      (rev ? C : B) + (long long)b * dm.t_len * y_t + (long long)g * N;
  const float* dtb = dt + (long long)b * dm.t_len * H + h;
  const long long pn = (long long)P * N;
  float* ob = (rev ? dstates : states) + ((long long)b * H + h) * nc * pn;

  // padding columns of X and Y stay 0: loads write only columns < P, N
  // (not load_rows, which zeroes them at every load: its registers make
  // this kernel spill under its 128-register bound)
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < 2 * stage_bytes / 16; i += THREADS) smem4[i] = z4;
  __syncthreads();

  auto stage_x = [&](int st) {
    return reinterpret_cast<bf16*>(base + st * stage_bytes);
  };
  auto load_chunk = [&](int ci, int st) {
    bf16* sX = stage_x(st);
    bf16* sY = sX + L * XS;
    float* sdt = reinterpret_cast<float*>(sY + L * BS);
    const long long c0 = (long long)ci * L;
    if (dm.vec) {
      for (int i = tid; i < L * (PP / 8); i += THREADS) {
        const int j = i / (PP / 8), c = 8 * (i % (PP / 8));
        if (c < P)
          cp_async16(smem_u32(sX + j * XS + c), Xb + (c0 + j) * x_t + c);
      }
      for (int i = tid; i < L * (NP / 8); i += THREADS) {
        const int j = i / (NP / 8), c = 8 * (i % (NP / 8));
        if (c < N)
          cp_async16(smem_u32(sY + j * BS + c), Yb + (c0 + j) * y_t + c);
      }
    } else {
      for (int i = tid; i < L * P; i += THREADS) {
        const int j = i / P, q = i - j * P;
        sX[j * XS + q] = Xb[(c0 + j) * x_t + q];
      }
      for (int i = tid; i < L * N; i += THREADS) {
        const int j = i / N, q = i - j * N;
        sY[j * BS + q] = Yb[(c0 + j) * y_t + q];
      }
    }
    for (int j = tid; j < L; j += THREADS)
      cp_async4(smem_u32(sdt + j), dtb + (c0 + j) * H);
    cp_async_commit();
  };

  // this warp's state tiles: rows 16 smt.., column tiles snt0 + s
  const int smt = warp % WM, snt0 = (warp / WM) * ST;
  const float* init = rev ? dstate + ((long long)b * H + h) * pn : nullptr;
  float st[ST][4];
#pragma unroll
  for (int s = 0; s < ST; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int nt = snt0 + s;
      const int p = 16 * smt + gr + 8 * (e >> 1);
      const int n = 8 * nt + 2 * tq + (e & 1);
      st[s][e] = (init && (SFULL || nt < NT) && p < P && n < N)
                     ? init[(long long)p * N + n]
                     : 0.f;
    }

  if (nc > 0) load_chunk(rev ? nc - 1 : 0, 0);
  for (int k = 0; k < nc; ++k) {
    const int ci = rev ? nc - 1 - k : k, cur = k & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk k landed; every reader of chunk k-1, beta done
    if (k + 1 < nc) load_chunk(rev ? ci - 1 : ci + 1, cur ^ 1);
    const bf16* sX = stage_x(cur);
    const bf16* sY = sX + L * XS;
    const float* sdt = reinterpret_cast<const float*>(sY + L * BS);

    float* oc = ob + (long long)ci * pn;
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      const int nt = snt0 + s;
      const int n = 8 * nt + 2 * tq, p = 16 * smt + gr;
      if ((SFULL || nt < NT) && n < N) {
        if (p < P)
          *reinterpret_cast<float2*>(oc + (long long)p * N + n) =
              make_float2(st[s][0], st[s][1]);
        if (p + 8 < P)
          *reinterpret_cast<float2*>(oc + (long long)(p + 8) * N + n) =
              make_float2(st[s][2], st[s][3]);
      }
    }
    if (warp == 0) {  // cumsum(dt * A), beta and e^{cum_L}
      const int E = L / 32;
      float v[4];
      const float last = warp_cumsum(sdt, a_h, L, lane, v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < E) {
          const int j = E * lane + e;
          sbeta[j] = rev ? expf(v[e]) : expf(last - v[e]) * sdt[j];
        }
      if (lane == 0) sel[0] = expf(last);
    }
    __syncthreads();  // beta and e^{cum_L} written
    const float el = sel[0];
#pragma unroll
    for (int s = 0; s < ST; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[s][e] *= el;
    for (int kb = 0; kb < L / 16; ++kb) {  // rows j = 16 kb .. 16 kb + 15
      uint32_t xf[4], hi[4], lo[4];
      ldsm_x4_t(smem_u32(sX + (16 * kb + (lane & 7) + (lane >> 4) * 8) * XS +
                         16 * smt + ((lane >> 3) & 1) * 8),
                xf);
      const float2 w0 =
          *reinterpret_cast<const float2*>(sbeta + 16 * kb + 2 * tq);
      const float2 w1 =
          *reinterpret_cast<const float2*>(sbeta + 16 * kb + 8 + 2 * tq);
      split_scaled(xf[0], w0, hi[0], lo[0]);
      split_scaled(xf[1], w0, hi[1], lo[1]);
      split_scaled(xf[2], w1, hi[2], lo[2]);
      split_scaled(xf[3], w1, hi[3], lo[3]);
      const bf16* yr = sY + (16 * kb + (lane & 15)) * BS;
      uint32_t bq[ST][2];
      if constexpr (SFULL && ST % 2 == 0) {
#pragma unroll
        for (int s = 0; s < ST; s += 2) {
          uint32_t t4[4];
          ldsm_x4_t(smem_u32(yr + 8 * (snt0 + s) + (lane >> 4) * 8), t4);
          bq[s][0] = t4[0];
          bq[s][1] = t4[1];
          bq[s + 1][0] = t4[2];
          bq[s + 1][1] = t4[3];
        }
      } else {
#pragma unroll
        for (int s = 0; s < ST; ++s)
          if (SFULL || snt0 + s < NT)
            ldsm_x2_t(smem_u32(yr + 8 * (snt0 + s)), bq[s]);
      }
#pragma unroll
      for (int s = 0; s < ST; ++s)
        if (SFULL || snt0 + s < NT) mma16816(st[s], hi, bq[s][0], bq[s][1]);
#pragma unroll
      for (int s = 0; s < ST; ++s)
        if (SFULL || snt0 + s < NT) mma16816(st[s], lo, bq[s][0], bq[s][1]);
    }
  }
}

// The chunk kernel of the bfloat16 instance: a block of L / 16 warps per
// (chunk, head, batch), the whole chunk in shared memory.  Warp w takes
// row block w (dC_i = e^{cum_i} dy_i S_prev + sum_j Q_ij B_j, and dcum's
// y_inter part), then column block w (du_j, dx_j, x_j.du_j, dB_j, T_j and
// R's sums); then dcum's parts and x.du a step go to rows.
template <int PP, int NP>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_mma_chunk(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ B,
                      const bf16* __restrict__ C, const bf16* __restrict__ dy,
                      const float* __restrict__ states,
                      const float* __restrict__ dstates,
                      float* __restrict__ dBp, float* __restrict__ dCp,
                      float* __restrict__ rows, bf16* __restrict__ dx,
                      MmaBwdDims dm, int batch) {
  constexpr int XS = PP + 8, BS = NP + 8;
  constexpr int KP = PP / 16, KN = NP / 16;  // k-steps over P and N
  constexpr int PT = PP / 8, NT = NP / 8;    // 8-column tiles of P and N
  const int H = dm.h, P = dm.p, N = dm.n, L = dm.l, G = dm.g;
  const int RB = L / 16, nthr = 32 * RB;
  extern __shared__ float4 smem4[];
  bf16* sx = reinterpret_cast<bf16*>(smem4);
  bf16* sdy = sx + L * XS;
  bf16* sB = sdy + L * XS;
  bf16* sC = sB + L * BS;
  bf16* sSh = sC + L * BS;
  bf16* sSl = sSh + PP * BS;
  // S_prev, then dS, in float32 by cp.async where it fits
  const bool staged = chunk_stages_f32(L, PP, NP);
  float* sF = reinterpret_cast<float*>(sSl + PP * BS);
  float* sdt = sF + (staged ? PP * NP : 0);
  float* scum2 = sdt + L;  // cum log2(e)
  float* se = scum2 + L;   // e^{cum}
  float* sw = se + L;      // e^{cum_L - cum}
  float* sRr = sw + L;     // [column block][step i]: sum_j R_ij in the block
  float* sPart = sRr + RB * L;
  float* sCol = sPart + L;
  float* sXd = sCol + L;
  float* sred = sXd + L;  // T by warp [0, 8), <dS, S_prev> by warp [8, 16),
                          // e^{cum_L} [16]

  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const long long x_t = (long long)H * P, bc_t = (long long)G * N;
  const long long T_ = dm.t_len, c0 = (long long)ci * L;
  const long long xo = ((long long)b * T_ + c0) * x_t + (long long)h * P;
  const long long bo = ((long long)b * T_ + c0) * bc_t + (long long)g * N;
  const long long sidx = (((long long)b * H + h) * dm.nc + ci) * P * N;
  const long long bth = (long long)batch * T_ * H;

  // the chunk: x, dy, B, C (pads zeroed), dt and S_prev by cp.async, then
  // S_prev into the state's hi + lo; dS comes in while the rows' state
  // term runs
  auto stage = [&](const float* src) {
    for (int i = tid; i < P * N / 4; i += nthr)
      cp_async16(smem_u32(sF + 4 * i), src + 4 * i);
    cp_async_commit();
  };
  load_rows<PP>(sx, XS, x + xo, x_t, P, L, dm.vec, tid, nthr);
  load_rows<PP>(sdy, XS, dy + xo, x_t, P, L, dm.vec, tid, nthr);
  load_rows<NP>(sB, BS, B + bo, bc_t, N, L, dm.vec, tid, nthr);
  load_rows<NP>(sC, BS, C + bo, bc_t, N, L, dm.vec, tid, nthr);
  const float* dtc = dt + ((long long)b * T_ + c0) * H + h;
  for (int j = tid; j < L; j += nthr)
    cp_async4(smem_u32(sdt + j), dtc + (long long)j * H);
  if (staged) stage(states + sidx);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  split_state<PP, NP>(sSh, sSl, staged ? sF : states + sidx, P, N,
                      false, tid, nthr);
  __syncthreads();  // S_prev's hi + lo written, its float32 copy read
  if (staged) stage(dstates + sidx);

  if (warp == 0) {  // cumsum(dt * A)
    const int E = L / 32;
    float v[4];
    const float last = warp_cumsum(sdt, A[h], L, lane, v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E) {
        const int j = E * lane + e;
        scum2[j] = v[e] * 1.4426950408889634f;
        se[j] = expf(v[e]);
        sw[j] = expf(last - v[e]);
      }
    if (lane == 0) sred[16] = expf(last);
  }

  // -- row block w: dC_i.  dy_i S_prev first (hi + lo), while warp 0 scans
  // and dS lands
  {
    const int i0 = 16 * warp, ilo = i0 + gr, ihi = ilo + 8;
    uint32_t af[KP][4];
    load_a<KP>(af, sdy, XS, i0, lane);
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    mma_rows_k<KP, NT>(acc, af, sSh, BS, lane);
    mma_rows_k<KP, NT>(acc, af, sSl, BS, lane);
    // dS replaces S_prev in the state's buffer here, not after the rows'
    // tiles: a barrier there would put the longest row block's tiles and
    // the longest column block's in one critical path
    cp_async_wait_all();
    __syncthreads();  // warp 0's cum, e^cum and w written; S_prev read; dS
                      // staged
    {  // dS into the state's hi + lo; <dS, S_prev> in float32
      float d = split_state<PP, NP>(sSh, sSl,
                                    staged ? sF : dstates + sidx, P,
                                    N, true, tid, nthr);
      d = warp_sum(d);
      if (lane == 0) sred[8 + warp] = d;
    }
    __syncthreads();
    // dcum's y_inter part e^{cum_i} C_i . (dy_i S_prev); dC starts at
    // e^{cum_i} dy_i S_prev
    const float e_lo = se[ilo], e_hi = se[ihi];
    float plo = 0.f, phi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + 2 * tq;
      const float2 cl = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(sC + ilo * BS + n));
      const float2 ch = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(sC + ihi * BS + n));
      plo = fmaf(cl.x, acc[nt][0], plo);
      plo = fmaf(cl.y, acc[nt][1], plo);
      phi = fmaf(ch.x, acc[nt][2], phi);
      phi = fmaf(ch.y, acc[nt][3], phi);
      acc[nt][0] *= e_lo;
      acc[nt][1] *= e_lo;
      acc[nt][2] *= e_hi;
      acc[nt][3] *= e_hi;
    }
    plo = quad_sum(plo);
    phi = quad_sum(phi);
    if (tq == 0) {
      sPart[ilo] = e_lo * plo;
      sPart[ihi] = e_hi * phi;
    }
    // Q_ij = (dy_i . x_j) dt_j E_ij over the causal tiles (j > i selected
    // to 0 before the exp), then dC_i += Q_ij B_j
    const float cum_lo = scum2[ilo], cum_hi = scum2[ihi];
    for (int kb = 0; kb <= warp; ++kb) {
      float sc[2][4];
      score_tile<KP>(sc, af, sx, XS, 16 * kb, lane);
      float q[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 16 * kb + 8 * u + 2 * tq;
        const float2 cj = *reinterpret_cast<const float2*>(scum2 + j);
        const float2 dj = *reinterpret_cast<const float2*>(sdt + j);
        q[u][0] = j <= ilo ? sc[u][0] * ex2(cum_lo - cj.x) * dj.x : 0.f;
        q[u][1] = j < ilo ? sc[u][1] * ex2(cum_lo - cj.y) * dj.y : 0.f;
        q[u][2] = j <= ihi ? sc[u][2] * ex2(cum_hi - cj.x) * dj.x : 0.f;
        q[u][3] = j < ihi ? sc[u][3] * ex2(cum_hi - cj.y) * dj.y : 0.f;
      }
      uint32_t qa[1][4];
      tile_as_a(qa, q);
      mma_rows_k<1, NT>(acc, qa, sB + 16 * kb * BS, BS, lane);
    }
    float* d_lo = dCp + (((long long)b * T_ + c0 + ilo) * H + h) * N;
    float* d_hi = dCp + (((long long)b * T_ + c0 + ihi) * H + h) * N;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + 2 * tq;
      if (n < N) {
        *reinterpret_cast<float2*>(d_lo + n) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(d_hi + n) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }

  // -- column block w: du_j, dB_j.  B_j dS^T and x_j dS first (hi + lo)
  {
    const int j0 = 16 * warp, jlo = j0 + gr, jhi = jlo + 8;
    uint32_t xf[KP][4];
    load_a<KP>(xf, sx, XS, j0, lane);
    float du[PT][4], db[NT][4];
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) du[pt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) db[nt][e] = 0.f;
    {
      uint32_t bf[KN][4];
      load_a<KN>(bf, sB, BS, j0, lane);
      mma_rows_n<KN, PT>(du, bf, sSh, BS, lane);
      mma_rows_n<KN, PT>(du, bf, sSl, BS, lane);
    }
    mma_rows_k<KP, NT>(db, xf, sSh, BS, lane);
    mma_rows_k<KP, NT>(db, xf, sSl, BS, lane);
    // T_j = dt_j w_j (x_j . dS B_j); du_j starts at w_j dS B_j, dB_j at
    // w_j dt_j x_j dS
    const float w_lo = sw[jlo], w_hi = sw[jhi];
    const float t_lo = sdt[jlo], t_hi = sdt[jhi];
    float tlo = 0.f, thi = 0.f;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      const int p = 8 * pt + 2 * tq;
      const float2 xl = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(sx + jlo * XS + p));
      const float2 xh = __bfloat1622float2(
          *reinterpret_cast<const bf162*>(sx + jhi * XS + p));
      tlo = fmaf(xl.x, du[pt][0], tlo);
      tlo = fmaf(xl.y, du[pt][1], tlo);
      thi = fmaf(xh.x, du[pt][2], thi);
      thi = fmaf(xh.y, du[pt][3], thi);
      du[pt][0] *= w_lo;
      du[pt][1] *= w_lo;
      du[pt][2] *= w_hi;
      du[pt][3] *= w_hi;
    }
    const float s_lo = w_lo * t_lo, s_hi = w_hi * t_hi;
    tlo = quad_sum(tlo) * s_lo;
    thi = quad_sum(thi) * s_hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      db[nt][0] *= s_lo;
      db[nt][1] *= s_lo;
      db[nt][2] *= s_hi;
      db[nt][3] *= s_hi;
    }
    // the transposed tiles (rows j, columns i >= j selected before the
    // exp): M^T = E (B_j . C_i), Q^T = E (x_j . dy_i) dt_j, R = (B_j . C_i)
    // Q^T; then du_j += M^T dy_i and dB_j += Q^T C_i
    const float cj_lo = scum2[jlo], cj_hi = scum2[jhi];
    float rlo = 0.f, rhi = 0.f;
    for (int ib = warp; ib < RB; ++ib) {
      float mt[2][4], gt[2][4];
      {
        uint32_t bf[KN][4];
        load_a<KN>(bf, sB, BS, j0, lane);
        score_tile<KN>(mt, bf, sC, BS, 16 * ib, lane);
      }
      score_tile<KP>(gt, xf, sdy, XS, 16 * ib, lane);
      float m[2][4], q[2][4], cs[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 16 * ib + 8 * u + 2 * tq;
        const float2 c2 = *reinterpret_cast<const float2*>(scum2 + i);
        const float e0 = i >= jlo ? ex2(c2.x - cj_lo) : 0.f;
        const float e1 = i + 1 >= jlo ? ex2(c2.y - cj_lo) : 0.f;
        const float e2 = i >= jhi ? ex2(c2.x - cj_hi) : 0.f;
        const float e3 = i + 1 >= jhi ? ex2(c2.y - cj_hi) : 0.f;
        m[u][0] = mt[u][0] * e0;
        m[u][1] = mt[u][1] * e1;
        m[u][2] = mt[u][2] * e2;
        m[u][3] = mt[u][3] * e3;
        q[u][0] = gt[u][0] * e0 * t_lo;
        q[u][1] = gt[u][1] * e1 * t_lo;
        q[u][2] = gt[u][2] * e2 * t_hi;
        q[u][3] = gt[u][3] * e3 * t_hi;
        const float r0 = mt[u][0] * q[u][0], r1 = mt[u][1] * q[u][1];
        const float r2 = mt[u][2] * q[u][2], r3 = mt[u][3] * q[u][3];
        rlo += r0 + r1;
        rhi += r2 + r3;
        cs[u][0] = r0 + r2;
        cs[u][1] = r1 + r3;
      }
      // R's sums over this block's rows j, for each column i
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float c = cs[u][v];
          c += __shfl_xor_sync(0xffffffffu, c, 4);
          c += __shfl_xor_sync(0xffffffffu, c, 8);
          c += __shfl_xor_sync(0xffffffffu, c, 16);
          if (gr == 0) sRr[warp * L + 16 * ib + 8 * u + 2 * tq + v] = c;
        }
      uint32_t ma[1][4], qa[1][4];
      tile_as_a(ma, m);
      tile_as_a(qa, q);
      mma_rows_k<1, PT>(du, ma, sdy + 16 * ib * XS, XS, lane);
      mma_rows_k<1, NT>(db, qa, sC + 16 * ib * BS, BS, lane);
    }
    rlo = quad_sum(rlo);
    rhi = quad_sum(rhi);
    // dx_j = dt_j du_j in bf16, x_j . du_j in float32
    const long long r_lo = (long long)b * T_ + c0 + jlo, r_hi = r_lo + 8;
    bf16* dx_lo = dx + (r_lo * H + h) * P;
    bf16* dx_hi = dx + (r_hi * H + h) * P;
    float xlo = 0.f, xhi = 0.f;
#pragma unroll
    for (int pt = 0; pt < PT; ++pt) {
      const int p = 8 * pt + 2 * tq;
      if (p < P) {
        const float2 xl = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(sx + jlo * XS + p));
        const float2 xh = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(sx + jhi * XS + p));
        xlo = fmaf(xl.x, du[pt][0], xlo);
        xlo = fmaf(xl.y, du[pt][1], xlo);
        xhi = fmaf(xh.x, du[pt][2], xhi);
        xhi = fmaf(xh.y, du[pt][3], xhi);
        *reinterpret_cast<bf162*>(dx_lo + p) =
            __floats2bfloat162_rn(t_lo * du[pt][0], t_lo * du[pt][1]);
        *reinterpret_cast<bf162*>(dx_hi + p) =
            __floats2bfloat162_rn(t_hi * du[pt][2], t_hi * du[pt][3]);
      }
    }
    xlo = quad_sum(xlo);
    xhi = quad_sum(xhi);
    float* b_lo = dBp + (r_lo * H + h) * N;
    float* b_hi = dBp + (r_hi * H + h) * N;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + 2 * tq;
      if (n < N) {
        *reinterpret_cast<float2*>(b_lo + n) =
            make_float2(db[nt][0], db[nt][1]);
        *reinterpret_cast<float2*>(b_hi + n) =
            make_float2(db[nt][2], db[nt][3]);
      }
    }
    if (tq == 0) {
      sCol[jlo] = -rlo - tlo;
      sCol[jhi] = -rhi - thi;
      sXd[jlo] = xlo;
      sXd[jhi] = xhi;
    }
    float ts = tlo + thi;  // the warp's sum of T_j over its 16 rows
    ts += __shfl_xor_sync(0xffffffffu, ts, 4);
    ts += __shfl_xor_sync(0xffffffffu, ts, 8);
    ts += __shfl_xor_sync(0xffffffffu, ts, 16);
    if (lane == 0) sred[warp] = ts;
  }
  __syncthreads();

  // dcum's row part, its column part (at the chunk's last step also sum_j
  // T_j + e^{cum_L} <dS, S_prev>) and x.du, a step each, in order
  for (int t = tid; t < L; t += nthr) {
    const long long o = ((long long)b * T_ + c0 + t) * H + h;
    float r = 0.f;
    for (int cb = 0; cb <= t / 16; ++cb) r += sRr[cb * L + t];
    float c = sCol[t];
    if (t == L - 1) {
      float ts = 0.f, d = 0.f;
      for (int w = 0; w < RB; ++w) {
        ts += sred[w];
        d += sred[8 + w];
      }
      c += ts + sred[16] * d;
    }
    rows[o] = r + sPart[t];
    rows[bth + o] = c;
    rows[2 * bth + o] = sXd[t];
  }
}

template <int PP, int NP>
int launch_bwd_mma(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* dy,
                   const void* dstate, void* states, void* dstates,
                   void* dBp, void* dCp, void* rows, void* dx, int batch,
                   const MmaBwdDims& dm, cudaStream_t stream) {
  const long long w_smem = walk_smem_bytes(dm.l, PP, NP);
  const long long c_smem = chunk_smem_bytes(dm.l, PP, NP);
  auto walk = ssd_bwd_walk<PP, NP>;
  auto chunk = ssd_bwd_mma_chunk<PP, NP>;
  cudaError_t e = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)w_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(walk,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)c_smem);
  if (e != cudaSuccess) return (int)e;
  walk<<<dim3(dm.h, batch, 2), THREADS, w_smem, stream>>>(
      (const bf16*)x, (const bf16*)dy, (const float*)dt, (const float*)A,
      (const bf16*)B, (const bf16*)C, (const float*)dstate, (float*)states,
      (float*)dstates, dm);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  chunk<<<dim3(dm.nc, dm.h, batch), 2 * dm.l, c_smem, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)B,
      (const bf16*)C, (const bf16*)dy, (const float*)states,
      (const float*)dstates, (float*)dBp, (float*)dCp, (float*)rows,
      (bf16*)dx, dm, batch);
  return (int)cudaGetLastError();
}

template <int PP>
int launch_bwd_mma_n(int np, const void* x, const void* dt, const void* A,
                     const void* B, const void* C, const void* dy,
                     const void* dstate, void* states, void* dstates,
                     void* dBp, void* dCp, void* rows, void* dx, int batch,
                     const MmaBwdDims& dm, cudaStream_t s) {
  switch (np) {
    case 16:
      return launch_bwd_mma<PP, 16>(x, dt, A, B, C, dy, dstate, states,
                                    dstates, dBp, dCp, rows, dx, batch, dm, s);
    case 32:
      return launch_bwd_mma<PP, 32>(x, dt, A, B, C, dy, dstate, states,
                                    dstates, dBp, dCp, rows, dx, batch, dm, s);
    case 64:
      return launch_bwd_mma<PP, 64>(x, dt, A, B, C, dy, dstate, states,
                                    dstates, dBp, dCp, rows, dx, batch, dm, s);
    default:
      return launch_bwd_mma<PP, 128>(x, dt, A, B, C, dy, dstate, states,
                                     dstates, dBp, dCp, rows, dx, batch, dm,
                                     s);
  }
}

// ssd_bwd_finish, then ssd_bwd_reduce: the last two kernels of either
// instance.
template <typename T>
int launch_bwd_tail(const void* dt, const void* A, const void* rows,
                    const void* dBp, const void* dCp, void* dAp, void* ddt,
                    void* dA, void* dB, void* dC, int batch,
                    const BwdDims& dm, cudaStream_t stream) {
  const long long items = (long long)batch * dm.nc * dm.h;
  ssd_bwd_finish<<<(unsigned)((items + 127) / 128), 128, 0, stream>>>(
      (const float*)dt, (const float*)A, (const float*)rows, (float*)ddt,
      (float*)dAp, dm, batch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)batch * dm.t_len * dm.g * dm.n;
  const long long blocks = (total + THREADS - 1) / THREADS;
  ssd_bwd_reduce<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0,
                      stream>>>((const float*)dBp, (const float*)dCp,
                                (const float*)dAp, (T*)dB, (T*)dC,
                                (float*)dA, dm, batch);
  return (int)cudaGetLastError();
}

template <int PP, int NP, int TO>
int launch_bwd_f32_chunk_to(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* dy,
                            const void* states, const void* dstates,
                            void* dBp, void* dCp, void* rows, void* dx,
                            int batch, const F32BwdDims& dm,
                            cudaStream_t stream) {
  const long long smem = f32_chunk_bytes(dm.l, PP, NP, TO);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto chunk = ssd_bwd_f32_chunk<PP, NP, TO>;
  cudaError_t e = cudaFuncSetAttribute(
      chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  chunk<<<dim3(2 * dm.nc, dm.h, batch), THREADS, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)B,
      (const float*)C, (const float*)dy, (const float*)states,
      (const float*)dstates, (float*)dBp, (float*)dCp, (float*)rows,
      (float*)dx, dm, batch);
  return (int)cudaGetLastError();
}

// The chunk kernel holds the other side's whole chunk where it fits
// (f32_chunk_rows), else streams 32-row tiles of it.
template <int PP, int NP>
int launch_bwd_f32_chunk(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, const void* dy,
                         const void* states, const void* dstates, void* dBp,
                         void* dCp, void* rows, void* dx, int batch,
                         const F32BwdDims& dm, cudaStream_t s) {
  const int to = f32_chunk_rows(dm.l, PP, NP);
  if constexpr (PP <= 64) {
    if (to == 64)
      return launch_bwd_f32_chunk_to<PP, NP, 64>(x, dt, A, B, C, dy, states,
                                                 dstates, dBp, dCp, rows, dx,
                                                 batch, dm, s);
  }
  if constexpr (PP < 128 || NP < 128) {
    if (to == 128)
      return launch_bwd_f32_chunk_to<PP, NP, 128>(x, dt, A, B, C, dy, states,
                                                  dstates, dBp, dCp, rows, dx,
                                                  batch, dm, s);
  }
  if (to != 32) return (int)cudaErrorInvalidValue;
  return launch_bwd_f32_chunk_to<PP, NP, 32>(x, dt, A, B, C, dy, states,
                                             dstates, dBp, dCp, rows, dx,
                                             batch, dm, s);
}

template <int PP>
int launch_bwd_f32_chunk_n(int np, const void* x, const void* dt,
                           const void* A, const void* B, const void* C,
                           const void* dy, const void* states,
                           const void* dstates, void* dBp, void* dCp,
                           void* rows, void* dx, int batch,
                           const F32BwdDims& dm, cudaStream_t s) {
  switch (np) {
    case 32:
      return launch_bwd_f32_chunk<PP, 32>(x, dt, A, B, C, dy, states,
                                          dstates, dBp, dCp, rows, dx, batch,
                                          dm, s);
    case 64:
      return launch_bwd_f32_chunk<PP, 64>(x, dt, A, B, C, dy, states,
                                          dstates, dBp, dCp, rows, dx, batch,
                                          dm, s);
    default:
      return launch_bwd_f32_chunk<PP, 128>(x, dt, A, B, C, dy, states,
                                           dstates, dBp, dCp, rows, dx,
                                           batch, dm, s);
  }
}

// The float32 instance: one launch of both walks, the chunk kernel, then
// ssd_bwd_finish and ssd_bwd_reduce.
int launch_bwd_f32(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* dy,
                   const void* dstate, void* states, void* dstates, void* dBp,
                   void* dCp, void* rows, void* dAp, void* dx, void* ddt,
                   void* dA, void* dB, void* dC, int batch, const BwdDims& bd,
                   cudaStream_t stream) {
  const bool vec = (((uintptr_t)x | (uintptr_t)B | (uintptr_t)C |
                     (uintptr_t)dy) & 15) == 0;
  const int stages = f32_walk_stages(bd.l, bd.p, bd.n);
  const long long w_smem = f32_walk_bytes(bd.l, bd.p, bd.n, stages);
  if (w_smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const F32BwdDims dm{bd.t_len, bd.h, bd.p, bd.g,  bd.n,
                      bd.l,     bd.nc, vec ? 1 : 0, stages};
  const int wt = bd.p > 64 ? 256 : 128;
  auto walk = wt == 256 ? ssd_bwd_f32_walk<256> : ssd_bwd_f32_walk<128>;
  cudaError_t e = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)w_smem);
  if (e != cudaSuccess) return (int)e;
  walk<<<dim3(bd.h, batch, 2), wt, w_smem, stream>>>(
      (const float*)x, (const float*)dy, (const float*)dt, (const float*)A,
      (const float*)B, (const float*)C, (const float*)dstate, (float*)states,
      (float*)dstates, dm);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int np = padded32(bd.n);
  int rc;
  switch (padded32(bd.p)) {
    case 32:
      rc = launch_bwd_f32_chunk_n<32>(np, x, dt, A, B, C, dy, states, dstates,
                                      dBp, dCp, rows, dx, batch, dm, stream);
      break;
    case 64:
      rc = launch_bwd_f32_chunk_n<64>(np, x, dt, A, B, C, dy, states, dstates,
                                      dBp, dCp, rows, dx, batch, dm, stream);
      break;
    default:
      rc = launch_bwd_f32_chunk_n<128>(np, x, dt, A, B, C, dy, states,
                                       dstates, dBp, dCp, rows, dx, batch, dm,
                                       stream);
  }
  if (rc != 0) return rc;
  return launch_bwd_tail<float>(dt, A, rows, dBp, dCp, dAp, ddt, dA, dB, dC,
                                batch, bd, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y).  chunk in 32 / 64 / 128
// and dividing t_len; p <= 128 and p, n multiples of 4; h a multiple of g.
extern "C" int ssd_chunk_scan_fwd(int dtype, const void* x, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  void* y, void* s_out, int batch, int t_len,
                                  int h, int p, int g, int n, int chunk,
                                  void* stream) {
  if (batch <= 0 || h <= 0) return 0;
  if (chunk <= 0 || chunk % 32 != 0 || chunk > 128 || t_len % chunk != 0 ||
      p <= 0 || p % 4 != 0 || p > 128 || n <= 0 || n % 4 != 0 || g <= 0 ||
      h % g != 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Dims dm{t_len, h, p, g, n, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, dt, A, B, C, y, s_out, batch, dm, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, s_out, batch, dm, s);
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 tensor-core instance: x, B, C, y bfloat16; same shapes as
// ssd_chunk_scan_fwd, and n <= 128.  Two shared-memory stages where they
// fit (ssd_chunk_scan_mma_stages), else one.
extern "C" int ssd_chunk_scan_mma_stages(int chunk, int p, int n) {
  return mma_stages(chunk, p, n);
}

extern "C" int ssd_chunk_scan_mma_fwd(const void* x, const void* dt,
                                      const void* A, const void* B,
                                      const void* C, void* y, void* s_out,
                                      int batch, int t_len, int h, int p,
                                      int g, int n, int chunk, void* stream) {
  if (batch <= 0 || h <= 0) return 0;
  if (chunk <= 0 || chunk % 32 != 0 || chunk > 128 || t_len % chunk != 0 ||
      p <= 0 || p % 4 != 0 || p > 128 || n <= 0 || n % 4 != 0 || n > 128 ||
      g <= 0 || h % g != 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int stages = mma_stages(chunk, p, n);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const bool vec = p % 8 == 0 && n % 8 == 0 &&
                   (((uintptr_t)x | (uintptr_t)B | (uintptr_t)C) & 15) == 0;
  const MmaDims dm{t_len, h, p, g, n, chunk, stages, vec ? 1 : 0};
  cudaStream_t s = (cudaStream_t)stream;
  const int np = padded(n);
  switch (padded(p)) {
    case 16:
      return launch_mma_n<16>(np, x, dt, A, B, C, y, s_out, batch, dm, s);
    case 32:
      return launch_mma_n<32>(np, x, dt, A, B, C, y, s_out, batch, dm, s);
    case 64:
      return launch_mma_n<64>(np, x, dt, A, B, C, y, s_out, batch, dm, s);
    default:
      return launch_mma_n<128>(np, x, dt, A, B, C, y, s_out, batch, dm, s);
  }
}

// The backward's shared memory per block, in bytes: the larger of the
// bfloat16 instance's two kernels (its state walks and its chunk kernel).
extern "C" long long ssd_chunk_scan_mma_bwd_smem(int chunk, int p, int n) {
  const int pp = padded(p), np = padded(n);
  const long long w = walk_smem_bytes(chunk, pp, np);
  const long long c = chunk_smem_bytes(chunk, pp, np);
  return w > c ? w : c;
}

// The float32 backward's shared memory per block, in bytes: the larger of
// its two kernels (the state walks, at the stages they take, and the chunk
// kernel).
extern "C" long long ssd_chunk_scan_f32_bwd_smem(int chunk, int p, int n) {
  const long long w = f32_walk_bytes(chunk, p, n, f32_walk_stages(chunk, p, n));
  const int pp = padded32(p), np = padded32(n);
  const long long c =
      f32_chunk_bytes(chunk, pp, np, f32_chunk_rows(chunk, pp, np));
  return w > c ? w : c;
}

// The backward: dtype 0 float32 (the float32-core kernels), 1 bfloat16 (x,
// B, C, dy, and dx, dB, dC; the tensor-core kernels); dt, A, dstate (Bb, H,
// P, N), ddt and dA float32.  Scratch, all float32: states and dstates (Bb,
// H, T / chunk, P, N), dBp and dCp (Bb, T, H, N), rows (3, Bb, T, H), dAp
// (Bb, H, T / chunk).  Shapes as ssd_chunk_scan_fwd, and n <= 128.
extern "C" int ssd_chunk_scan_bwd(int dtype, const void* x, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  const void* dy, const void* dstate,
                                  void* states, void* dstates, void* dBp,
                                  void* dCp, void* rows, void* dAp, void* dx,
                                  void* ddt, void* dA, void* dB, void* dC,
                                  int batch, int t_len, int h, int p, int g,
                                  int n, int chunk, void* stream) {
  if (batch <= 0 || h <= 0) return 0;
  if (chunk <= 0 || chunk % 32 != 0 || chunk > 128 || t_len % chunk != 0 ||
      p <= 0 || p % 4 != 0 || p > 128 || n <= 0 || n % 4 != 0 || n > 128 ||
      g <= 0 || h % g != 0 || batch > 65535 || t_len / chunk > 32767)
    return (int)cudaErrorInvalidValue;
  const BwdDims dm{t_len, h, p, g, n, chunk, t_len / chunk};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd_f32(x, dt, A, B, C, dy, dstate, states, dstates, dBp,
                          dCp, rows, dAp, dx, ddt, dA, dB, dC, batch, dm, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int pp = padded(p), np = padded(n);
  const bool vec = p % 8 == 0 && n % 8 == 0 &&
                   (((uintptr_t)x | (uintptr_t)B | (uintptr_t)C |
                     (uintptr_t)dy) & 15) == 0;
  const MmaBwdDims md{t_len, h, p, g, n, chunk, dm.nc, vec ? 1 : 0};
  int rc;
  switch (pp) {
    case 16:
      rc = launch_bwd_mma_n<16>(np, x, dt, A, B, C, dy, dstate, states,
                                dstates, dBp, dCp, rows, dx, batch, md, s);
      break;
    case 32:
      rc = launch_bwd_mma_n<32>(np, x, dt, A, B, C, dy, dstate, states,
                                dstates, dBp, dCp, rows, dx, batch, md, s);
      break;
    case 64:
      rc = launch_bwd_mma_n<64>(np, x, dt, A, B, C, dy, dstate, states,
                                dstates, dBp, dCp, rows, dx, batch, md, s);
      break;
    default:
      rc = launch_bwd_mma_n<128>(np, x, dt, A, B, C, dy, dstate, states,
                                 dstates, dBp, dCp, rows, dx, batch, md, s);
  }
  if (rc != 0) return rc;
  return launch_bwd_tail<__nv_bfloat16>(dt, A, rows, dBp, dCp, dAp, ddt, dA,
                                        dB, dC, batch, dm, s);
}
