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
// All products and sums in float32, in the TPU kernel's order of the
// scalar factors.  Terms j > i are skipped, never multiplied by a 0 mask:
// exp(cum_i - cum_j) overflows there (cum falls along the chunk).
//
// Bound on the card: at mamba2-370m's shapes (L = N = 128, P = 64) about
// 10.5 MFLOP per chunk and head against 50 KB read and 16 KB written, so
// the operations bound it (tensor-core rate in bf16).  This first kernel
// runs on the float32 cores.  Design: the TPU kernel's grid was (batch,
// head, chunk) with the chunk axis sequential and the (P, N) state in VMEM
// scratch.  Here one block of 256 threads owns one (batch, head) and walks
// the chunks itself, the state in shared memory.  The L x L score matrix
// does not fit beside x, B and the state in float32 (227 KB), so each
// chunk is done in row tiles of 32: the tile's C rows and its 32 x L
// score tile live in shared memory, and only the columns j < i0 + 32 that
// the causal mask keeps are computed.  Warp w owns rows 4w..4w+3 of a
// tile; its lanes own score columns (lane + 32k) and output columns
// (lane + 32k), so C and score reads are broadcasts and B, x and state
// reads are conflict-free (rows padded to N + 4 floats, float4 along N).
// The state update gives each thread 4 rows of P x 4 columns of N.
// Weakness: float32 SIMT products and one block an SM (Bb * H = 128 blocks
// at the model's shape); bf16 mma for the four products is the next step.
#include <cuda_bf16.h>

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
