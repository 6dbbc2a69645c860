// Blocked (flash) attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention: _kernel).  q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D), any
// strides with the last one 1; out has q's shape.  Online softmax in
// float32 (running max, denominator and accumulator per query row), with
// the reference's semantics:
//   * scale multiplies q.k (the wrapper passes 1/sqrt(D) by default);
//   * the query at index i has position i + (Tk - Tq) (ends aligned);
//     causal keeps keys kpos <= qpos, a window keeps kpos > qpos - window;
//   * masked scores are the finite -1e30, never -inf, and their weights are
//     0, so a row with no visible key has l == 0 and writes 0;
//   * GQA reads KV head h / (Hq / Hkv) without repeating K/V.
// Inputs are float32 or bfloat16, converted to float32 in shared memory;
// the products and sums are float32 as in the TPU kernel.
//
// Bound on the card: at the main path's shapes (Tq = Tk = 1024..2048,
// D = 128) the bf16 tensor-core rate bounds the work; this first kernel
// runs on the float32 cores instead (the TPU kernel's float32 dots), so it
// sits far above that bound.  Design: one block of 256 threads per
// (q tile of 64 rows, head, batch); K/V tiles of 32 keys staged in shared
// memory; each thread owns 4 query rows x 2 keys of the score tile (float4
// shared-memory reads along D) and the same 4 rows x D/16 columns of the
// output, so the row max and sum are 16-lane shuffles and the rescale of
// the accumulator needs no exchange.  Key tiles wholly outside the causal
// or window band are skipped.  Head dims 16-128 run two blocks an SM
// (__launch_bounds__(256, 2): at most 128 registers a thread).  D = 256
// (recurrentgemma-9b) holds 4 x 16 accumulators a thread and 139,776 bytes
// of shared memory a block, so it is compiled for one block an SM, which
// lifts the register cap to 255 and avoids spills.  Next steps: bf16 mma
// (wgmma) for the two products, cp.async/TMA double buffering of the K/V
// tiles.
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: ty owns rows, tx owns keys/columns
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16-lane reductions: the 16 threads sharing ty are lanes 0-15 or 16-31.
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 4) + BK * D + BQ * BK);
}

// Blocks an SM the instance is compiled for (caps registers a thread).
template <int D>
constexpr int min_blocks() {
  return D > 128 ? 1 : 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Strides st, int hq,
              int hkv, int tq, int tk, int causal, int window, float scale) {
  constexpr int KS = D + 4;               // padded K row: conflict-free float4
  constexpr int NC = D / 16;              // output columns per thread
  constexpr int VEC = NC < 4 ? NC : 4;    // their vector width
  constexpr int NG = NC / VEC;            // column groups of VEC
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // BQ x D
  float* sK = sQ + BQ * D;                      // BK x KS
  float* sV = sK + BK * KS;                     // BK x D
  float* sP = sV + BK * D;                      // BQ x BK

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int off = tk - tq;
  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + hk * st.k_h;
  const T* vb = v + b * st.v_b + hk * st.v_h;
  T* ob = o + b * st.o_b + h * st.o_h;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = q0 + r;
    sQ[idx] = row < tq ? to_f32(qb[row * st.q_s + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // Key range that any row of this tile can see.
  const int last_row = min(q0 + BQ, tq) - 1;
  int kend = tk;
  if (causal) kend = min(tk, last_row + off + 1);
  int kbeg = 0;
  if (window > 0) {
    const int kmin = q0 + off - window + 1;
    kbeg = kmin > 0 ? (kmin / BK) * BK : 0;
  }

  for (int kt = kbeg; kt < kend; kt += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D, row = kt + r;
      const bool in = row < tk;
      sK[r * KS + c] = in ? to_f32(kb[row * st.k_s + c]) : 0.f;
      sV[idx] = in ? to_f32(vb[row * st.v_s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qv[4][4], kv[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds<4>(sQ + (ty + 16 * i) * D + d, qv[i]);
#pragma unroll
      for (int j = 0; j < 2; ++j) lds<4>(sK + (tx + 16 * j) * KS + d, kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i, qpos = qi + off;
      bool ok[2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = kt + tx + 16 * j;
        ok[j] = qi < tq && kpos < tk && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
      ps = half_warp_sum(ps);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 2; ++j) sP[(ty + 16 * i) * BK + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds<4>(sP + (ty + 16 * i) * BK + kk, pv[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[NC];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          lds<VEC>(sV + (kk + e) * D + g * 16 * VEC + tx * VEC, vv + g * VEC);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i][e], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= tq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = ob + qi * st.o_s;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(orow + g * 16 * VEC + tx * VEC + e, acc[i][g * VEC + e] / safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int b, int hq, int hkv, int tq, int tk,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((tq + BQ - 1) / BQ, hq, b);
  kern<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k,
                                        (const T*)v, (T*)o, st, hq, hkv, tq,
                                        tk, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             const Strides& st, int b, int hq, int hkv, int tq, int tk,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, st, b, hq, hkv, tq, tk, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, st, b, hq, hkv, tq, tk, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, st, b, hq, hkv, tq, tk, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, b, hq, hkv, tq, tk, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, st, b, hq, hkv, tq, tk, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (batch, head,
// sequence) of q, k, v and out in turn.  window <= 0: no window.
extern "C" int flash_attention_fwd(int dtype, int d, const void* q,
                                   const void* k, const void* v, void* o,
                                   const long long* strides, int b, int hq,
                                   int hkv, int tq, int tk, int causal,
                                   int window, float scale, void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, st, b, hq, hkv, tq, tk, causal,
                           window, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, st, b, hq, hkv, tq, tk,
                                   causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
