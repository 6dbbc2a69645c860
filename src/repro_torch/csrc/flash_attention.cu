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
//   * masked keys weigh 0 (the reference's scores are the finite -1e30;
//     the bf16 kernel uses -inf with guards), so a row with no visible key
//     has l == 0 and writes 0;
//   * GQA reads KV head h / (Hq / Hkv) without repeating K/V.
//
// Bound on the card: the bf16 tensor-core rate (989 TFLOP/s dense): at the
// main path's shapes (Tq = Tk = 2,048-3,072, D = 128 or 256) a head's work
// is 4 * D flops per visible (query, key) pair against 2 * D * 2 bytes per
// key read once, far above the card's 295 flops a byte.
//
// bfloat16 inputs: `flash_fwd_wgmma`, FlashAttention-3's basic structure
// without its warp specialisation or ping-pong.
//   * Two consumer warpgroups (128 threads each) a block, 64 query rows
//     each (BQ = 128), sharing every K/V tile.  Tiles of BK = 128 keys at
//     D = 128, 64 at D <= 64 and 32 at D = 256 (see Cfg).  Two warpgroups
//     sharing a tile halve the K/V traffic from L2 a flop, which bounds a
//     block of one warpgroup at D = 256.
//   * The Q tile is loaded once; K/V tiles stream through a ring of STAGES
//     (3 at D = 128, else 4) with 16-byte cp.async.cg copies straight from
//     the strided views: tile j + STAGES - 2 is issued while tile j is
//     used.  The ring runs on mbarriers (full: every thread's copies of
//     the stage landed; empty: every thread is done with it), not on block
//     barriers.  Every tile is stored as 64-column panels of 128-byte rows
//     with the 128-byte swizzle (chunk ^ row % 8) that the wgmma
//     descriptors name.  Rows past Tq / Tk are zero-filled by the copy;
//     head dims below 64 are zero-padded to one panel (zeroed once).
//   * S = Q K^T: wgmma m64n{BK}k16, Q and K both K-major from shared
//     memory, float32 accumulators (bf16 products are exact in float32).
//   * O += P V: P is rounded to bf16 in registers and is the register A
//     operand of wgmma m64n{64,128}k16 (the S fragment's layout is the A
//     fragment's); V (keys x D, MN-major) is B from shared memory with the
//     transpose bit.  Rounding P to bf16 adds about 2^-9 relative error
//     per weight against the TPU kernel's float32 p.
//   * Pipeline a warpgroup: S_j and the previous tile's PV are issued
//     together; the online softmax of S_j waits only for S_j and overlaps
//     PV_{j-1}; then O is rescaled by 2^(m_old - m_new) per row.
//   * Online softmax on the accumulator fragment: a thread holds rows r and
//     r + 8 of its warp's 16, each row in the 4 lanes of a quad, so the row
//     max is two xor-shuffles; the row sum is kept per thread and reduced
//     once at the end.  Scores are scaled by scale * log2(e) in one multiply
//     and exponentiated on the SFU (ex2.approx).  Only tiles that straddle
//     the causal diagonal, the window's edge or the end of Tk evaluate the
//     mask (two compares an element); tiles outside the block's band are
//     never loaded.
//   * No branch depends on the thread: ptxas serialises every wgmma of a
//     kernel (a wait after each, warning C7518) once it must place a wgmma
//     wait in divergent code.  So both warpgroups walk all of the block's
//     tiles (a tile one cannot see is masked whole), tile 0 issues a PV of
//     P = 0, and the copy loops are unrolled.
//   * Descriptors are built once a tile; k-steps add constants to them.
//   * Epilogue: O / l (1 where l == 0), rounded to bf16, staged through the
//     Q tile's shared memory and stored as 16-byte row chunks by q's
//     strides (the wrapper makes every row start 16-byte aligned).
//   * Grid (q tiles, Hq, B), q tiles visited heaviest first.
//   Shared memory a block (+1 KB to align to 1,024 bytes): Q + STAGES x
//   (K + V) = 224 KB at D = 128, 192 KB at D = 256, 80 KB at D <= 64.
//   Registers (ptxas -v, sm_90a, no spills): 234 at D = 128 and 194 at
//   D = 256 (one block an SM), 113-115 at D <= 64 (two blocks an SM).
//
// float32 inputs run a SIMT kernel on the float32 cores (`flash_fwd`,
// namespace simt): TF32 wgmma would keep about three decimal digits, which
// cannot meet the float32 checks (atol 2e-4 per kernel call, 1e-3 on a
// model's logits); the float32 path serves only those checks.  One block of
// 256 threads per (q tile of 64 rows, head, batch); K/V tiles of 32 keys
// staged in shared memory as float32; each thread owns 4 query rows x 2
// keys of the score tile and the same 4 rows x D/16 columns of the output.
// D = 256 is compiled for one block an SM (206 registers, no spills), D
// 16-128 for two (at most 128 registers).
//
// Either forward can also write each row's natural log-sum-exp of its
// scaled scores, lse (float32 (B, Hq, Tq); -inf for a row that sees no
// key), which the backward takes; serving passes a null pointer.
//
// The backward (`flash_attention_bwd`; the TPU package has no backward
// kernel: its gradients are XLA's autodiff of the plain attention) is
// FlashAttention-2's scheme, head dims 16-256, with the forward's masks
// (causal, window, ends aligned); a row that sees no key has lse = -inf,
// P = 0 and contributes nothing.  No floating-point atomics: every gradient
// element is summed by one thread in a fixed order (the GQA sum inside the
// dK/dV block), so a backward gives the same bits in every run.
// Bound on the card: the bf16 tensor-core rate; the least work is 10 D
// flops a visible pair (2.5x the forward's), this design does 14 D (S and
// dP are computed in both the dK/dV and the dQ kernel).
//
// bfloat16 (namespace wgb): all five products on wgmma with float32
// accumulators, built from the forward's pieces (swizzled panels, the
// cp.async ring on mbarriers, qk_issue / pv_issue):
//   * `bwd_delta_vec`: delta_i = sum_d dO_i,d O_i,d, D / 8 threads a row,
//     16-byte loads;
//   * `bwd_dkdv_wgmma`: a block a (key tile of 128, KV head, batch), two
//     warpgroups of 64 keys; K and V stay in shared memory, Q and dO tiles
//     of 64 rows with their lse and delta stream through a ring of 4
//     stages.  The keys are the M rows: S^T = K Q^T and dP^T = V dO^T are
//     ss wgmma with both operands K-major (the forward's S with the roles
//     swapped); P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T = P^T
//     (dP^T - delta) on the accumulator fragment, lse and delta indexed by
//     column; dV += bf16(P^T) dO and dK += bf16(dS^T) Q are rs wgmma with
//     the fragment as the register A operand and dO / Q the MN-major B
//     operand (the forward's P V).  The block walks the Hq / Hkv query
//     heads of its group and the query tiles that see its keys; key tiles
//     are the slowest grid dimension, so causal key tile 0 (seen by every
//     query tile) starts first;
//   * `bwd_dq_wgmma`: a block a (query tile of 128, head, batch), two
//     warpgroups of 64 rows; Q and dO loaded once, K and V tiles of 64 keys
//     stream through the ring over the forward's key range; S = Q K^T and
//     dP = dO V^T ss, dQ += bf16(dS) K rs with K the MN-major B;
//   * rounding points are FlashAttention-2/3's: only P and dS are rounded
//     to bf16 (as A operands); S and dP are exact products summed in
//     float32; dK and dQ are scaled in the epilogue, rounded to bf16 and
//     stored through shared memory as 16-byte row chunks;
//   * masks are selects on the fragment (a masked element is 0 whatever
//     2^(s - lse) gives there), both warpgroups walk the same tiles and the
//     copy loops are unrolled, so no wgmma wait sits in divergent code
//     (ptxas warning C7518);
//   * shared memory (+1 KB to align): dK/dV 2 x 128 x DP + 4 x 2 x 64 x
//     DP bf16 + lse/delta (195 KB at D = 128, 99 KB below); dQ 2 x 128 x
//     DP + 4 x 2 x 64 x DP (193 KB, 97 KB); one block an SM (the dK/dV
//     warpgroup holds dK, dV, S^T and dP^T: 255 registers at D = 128);
//   * D = 256 (recurrentgemma-9b, MQA with a window of 2,048) has its own
//     tiles (wgb::Cfg): 64 keys x 256 columns of dK and dV would be 256
//     float32 registers a thread, so both warpgroups of a dK/dV block take
//     the same 64 keys, each computes S^T and dP^T (repeated: 12 D flops
//     a visible pair in that kernel), and each holds dK and dV for its
//     128 columns; Q and dO stream in tiles of 32 rows, 4 stages (194 KB
//     with K and V).  The dQ block keeps 128 rows of Q and dO (128 KB) and
//     streams 32-key tiles through 3 stages (225 KB), as the forward does
//     at D = 256.  Every block of an MQA dK/dV grid walks all the query
//     heads of its KV head.
// float32 (namespace bwd) runs on the float32 cores (TF32 wgmma could not
// meet the float32 checks, as for the forward), D 16-256: `bwd_delta` a
// warp a row;
// `bwd_dkdv` a block a (key tile of 32, KV head, batch) holding K and V,
// walking the group's heads and the query tiles of 64 rows that see it
// (P = exp(S scale - lse), dS = P (dP - delta), dV += P^T dO, dK += dS^T
// Q scale); `bwd_dq` a block a (query tile of 64, head, batch) over the
// forward's key tiles (dQ += dS K scale).  Shared memory 2 x 64 x D + 2 x
// 32 x (D + 4) + 2 x 64 x 33 floats (113 KB at D = 128, 210 KB at D =
// 256), one block an SM.
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
};

// ---------------------------------------------------------------------------
// float32: the SIMT kernel.
namespace simt {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: ty owns rows, tx owns keys/columns

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

template <int D>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, Strides st, int hq, int hkv, int tq,
              int tk, int causal, int window, float scale) {
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
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + hk * st.k_h;
  const float* vb = v + b * st.v_b + hk * st.v_h;
  float* ob = o + b * st.o_b + h * st.o_h;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = q0 + r;
    sQ[idx] = row < tq ? qb[row * st.q_s + c] : 0.f;
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
      sK[r * KS + c] = in ? kb[row * st.k_s + c] : 0.f;
      sV[idx] = in ? vb[row * st.v_s + c] : 0.f;
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
    if (lse != nullptr && tx == 0)  // -inf: the row sees no key
      lse[((long long)b * hq + h) * tq + qi] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    float* orow = ob + qi * st.o_s;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[g * 16 * VEC + tx * VEC + e] = acc[i][g * VEC + e] / safe;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides& st, int b, int hq, int hkv, int tq, int tk,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((tq + BQ - 1) / BQ, hq, b);
  kern<<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, st,
      hq, hkv, tq, tk, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel.
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int ROW_BYTES = 128;  // one swizzled row of a panel: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int DP = D < 64 ? 64 : D;  // head dim padded to a panel
  static constexpr int THREADS = 256;         // two warpgroups
  static constexpr int BQ = 128;              // query rows a block
  // Keys a K/V tile: 128 at D = 128 (S = Q K^T as m64n128 halves the
  // shared-memory reads of Q a flop against m64n64, which reads Q and K
  // at the full 128 bytes a cycle); 32 at D = 256 (registers, shared
  // memory); 64 below.
  static constexpr int BK = D > 128 ? 32 : D == 128 ? 128 : 64;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or one V tile
  // K/V ring: tile j + STAGES - 2 is issued while tile j is used.
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + STAGES * 2 * 8 + 1024;
  static constexpr int MIN_BLOCKS = D > 64 ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 bf16 along the row) of row r in a tile
// of ROWS rows, stored as 64-column panels of ROWS x 128 bytes with the
// 128-byte swizzle.  Tiles start 1,024-byte aligned.
template <int ROWS>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)((c >> 3) * ROWS * ROW_BYTES + r * ROW_BYTES +
                    (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
// Waits for every cp.async copy this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// Arrives on bar once all of this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
      ::"r"(bar)
      : "memory");
}
// Waits until the phase with the given parity of bar has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Makes this thread's generic-proxy (and cp.async) writes to shared memory
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of a (T, D) bf16 view with row stride ld
// (elements) into the swizzled tile at dst; rows >= limit are zero-filled.
// Branch-free: surplus threads repeat a chunk another thread copies.
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int row0, int limit,
                                          int tid) {
  constexpr int CPR = D / 8, N = ROWS * CPR;  // 16-byte chunks a row, a tile
  constexpr int STEP = NTHREADS / CPR;           // rows an iteration
  if constexpr (N % NTHREADS == 0 && NTHREADS % CPR == 0 && STEP % 8 == 0) {
    // A thread keeps its chunk column; its row advances by STEP, a
    // multiple of the swizzle's 8 rows, so the offsets are hoisted.
    const int c = tid % CPR, r0 = tid / CPR;
    const bf16* g = src + (row0 + r0) * ld + c * 8;
    const uint32_t d0 = dst + sw128<ROWS>(r0, c);
#pragma unroll
    for (int it = 0; it < N / NTHREADS; ++it) {
      const bool in = row0 + r0 + it * STEP < limit;
      cp_async16(d0 + it * STEP * ROW_BYTES, in ? g + it * STEP * ld : src,
                 in);
    }
  } else {
#pragma unroll
    for (int it = 0; it < (N + NTHREADS - 1) / NTHREADS; ++it) {
      const int idx = (tid + it * NTHREADS) % N;
      const int r = idx / CPR, c = idx % CPR, row = row0 + r;
      const bool in = row < limit;
      cp_async16(dst + sw128<ROWS>(r, c), in ? src + row * ld + c * 8 : src,
                 in);
    }
  }
}

// Shared-memory matrix descriptor, 128-byte swizzle.  lbo: byte stride
// between 64-column panels along M/N (MN-major operands only); sbo: byte
// stride between groups of 8 rows (1,024).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving register reads or writes of a wgmma
// operand across the asynchronous wgmma that owns it, and from reusing an
// A-operand register while the wgmma still reads it.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&p)[K][4]) {
#pragma unroll
  for (int i = 0; i < 4 * K; ++i)
    asm volatile("" : "+r"(p[i / 4][i % 4])::"memory");
}

#define FA_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_R16                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15"
#define FA_R32                                                            \
  FA_R16 ", "                                                             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define FA_R64                                                            \
  FA_R32 ", "                                                             \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// d[64] += A (64 x 16, K-major, smem) . B (128 x 16, K-major, smem)^T.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" FA_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
        FA_D8(48), FA_D8(56)
      : "l"(da), "l"(db), "r"(1));
}

// d[16] += A (64 x 16, K-major, smem) . B (32 x 16, K-major, smem)^T.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" FA_R16 "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8)
      : "l"(da), "l"(db), "r"(1));
}

// d[32] += A (64 x 16, K-major, smem) . B (64 x 16, K-major, smem)^T.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" FA_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d[32] += A (64 x 16, registers) . B (16 x 64, MN-major, smem).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" FA_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (64 x 16, registers) . B (16 x 128, MN-major, smem).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" FA_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40),
        FA_D8(48), FA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_D8
#undef FA_R16
#undef FA_R32
#undef FA_R64

// Issues s = Q_wg . K^T as one wgmma group (qw: the warpgroup's first row
// in a Q tile of QROWS rows; sk: a K tile of BK keys).  s is valid after
// the group's wait.
template <int DP, int QROWS, int BK>
__device__ __forceinline__ void qk_issue(float (&s)[BK / 2], uint32_t qw,
                                         uint32_t sk) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  fence_regs<BK / 2>(s);
  wgmma_fence();
  // k-step kk starts (kk >> 2) panels and (kk & 3) * 32 bytes in: constant
  // additions to the address field (addresses stay below 2^18 bytes).
  const uint64_t da0 = desc_sw128(qw, 16, 1024);
  const uint64_t db0 = desc_sw128(sk, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int step = (kk & 3) * 32;
    const uint64_t da = da0 + (((kk >> 2) * QROWS * ROW_BYTES + step) >> 4);
    const uint64_t db = db0 + (((kk >> 2) * BK * ROW_BYTES + step) >> 4);
    if constexpr (BK == 128)
      wgmma_ss_n128(s, da, db);
    else if constexpr (BK == 64)
      wgmma_ss_n64(s, da, db);
    else
      wgmma_ss_n32(s, da, db);
  }
  wgmma_commit();
}

// Issues o += P . V as one wgmma group: p holds the bf16 A fragments of
// the BK / 16 key steps (left untouched until the group's wait); sv is a
// (BK keys x DP) V tile.
template <int DP, int BK>
__device__ __forceinline__ void pv_issue(float (&o)[DP / 2],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t sv) {
  constexpr int NCH = DP < 128 ? DP : 128;  // columns a wgmma
  fence_regs<DP / 2>(o);
  wgmma_fence();
  const uint64_t db0 = desc_sw128(sv, BK * ROW_BYTES, 1024);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int n0 = 0; n0 < DP; n0 += NCH) {
      const uint64_t db =
          db0 + (((n0 / 64) * BK * ROW_BYTES + kk * 16 * ROW_BYTES) >> 4);
      if constexpr (NCH == 128)
        wgmma_rs_n128(o + n0 / 2, p[kk], db);
      else
        wgmma_rs_n64(o + n0 / 2, p[kk], db);
    }
  }
  wgmma_commit();
}

// 2^x on the SFU (ex2.approx: relative error about 2^-22; 2^-1e30 is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of P for the BK / 16 key steps, from the S fragment.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// Accumulator fragment of wgmma m64nNk16 (f32): register i of thread t
// (warp w = t / 32 of the warpgroup, lane l) holds row
// 16 w + l / 4 + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 (l & 3) + (i & 1).
__device__ __forceinline__ int frag_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + (i & 1);
}

// Aligns the dynamic shared memory to 1,024 bytes (the swizzle's period).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// Rows [row0, row0 + ROWS) of a staged swizzled tile (ROWS x D bf16 at
// smem) out to a (T, D) view with row stride ld, as 16-byte chunks; rows
// >= limit are not written.
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void store_tile(bf16* dst, long long ld,
                                           const uint8_t* smem, int row0,
                                           int limit, int tid) {
  constexpr int CPR = D / 8;
  for (int idx = tid; idx < ROWS * CPR; idx += NTHREADS) {
    const int r = idx / CPR, c = idx % CPR, row = row0 + r;
    if (row < limit)
      *reinterpret_cast<uint4*>(dst + row * ld + c * 8) =
          *reinterpret_cast<const uint4*>(smem + sw128<ROWS>(r, c));
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
    flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, Strides st, int hq, int hkv,
                    int tq, int tk, int causal, int window,
                    float scale_log2) {
  using C = Cfg<D>;
  constexpr int DP = C::DP, BQ = C::BQ, BK = C::BK, THREADS = C::THREADS;
  constexpr int NS = BK / 2;  // S registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sKV = sQ + C::Q_BYTES;  // stage s: K, then V

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int off = tk - tq;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + hk * st.k_h;
  const bf16* vb = v + b * st.v_b + hk * st.v_h;
  bf16* ob = o + b * st.o_b + h * st.o_h;

  if constexpr (DP != D) {  // zero the pad columns of every tile once
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < C::BAR_OFF / 16; i += THREADS)
      p[i] = make_uint4(0, 0, 0, 0);
  }
  // full[s]: stage s holds its tile (every thread's copies landed);
  // empty[s]: every thread is done with the tile in stage s.
  const uint32_t full = sQ + C::BAR_OFF, empty = full + 8 * C::STAGES;
  if (tid == 0)
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full + 8 * i, THREADS);
      mbar_init(empty + 8 * i, THREADS);
    }
  __syncthreads();

  load_tile<BQ, D, THREADS>(sQ, qb, st.q_s, q0, tq, tid);

  // Key tiles any row of the block can see ...
  const int last_row = min(q0 + BQ, tq) - 1;
  const int kend = causal ? min(tk, last_row + off + 1) : tk;
  int kbeg = 0;
  if (window > 0) {
    const int kmin = q0 + off - window + 1;
    kbeg = kmin > 0 ? (kmin / BK) * BK : 0;
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const int wq0 = q0 + 64 * wgi;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int r_q = wq0 + 16 * warp + (lane >> 2);  // this thread's first row
  const int c_k = 2 * (lane & 3);                 // and first column

  constexpr int S = C::STAGES;
  auto stage = [&](int j) { return sKV + (j % S) * 2 * C::KV_BYTES; };
  auto load_kv = [&](int j) {  // tile j into its stage; arrives on full
    if (j < ntiles) {
      if (j >= S)  // the stage's previous tile, j - S, is done everywhere
        mbar_wait(empty + 8 * (j % S), ((j - S) / S) & 1);
      const int kt = kbeg + j * BK;
      load_tile<BK, D, THREADS>(stage(j), kb, st.k_s, kt, tk, tid);
      load_tile<BK, D, THREADS>(stage(j) + C::KV_BYTES, vb, st.v_s, kt, tk,
                                tid);
      cp_async_arrive(full + 8 * (j % S));
    }
  };
#pragma unroll
  for (int j = 0; j < S - 2; ++j) load_kv(j);

  // Software pipeline of one warpgroup: at tile j, S_j = Q K_j^T and the
  // previous tile's O += P_{j-1} V_{j-1} run on the tensor cores while the
  // softmax of S_j waits only for the first; O is rescaled once both are
  // done.  The K/V ring runs on mbarriers, not on block barriers, so the
  // two warpgroups drift apart and one's softmax overlaps the other's
  // products: tile j + S - 2 is issued at tile j, into the stage of tile
  // j - 2, once every thread has arrived on that stage's empty barrier.
  // No branch depends on the thread (ptxas serialises every wgmma of a
  // kernel whose waits it must place in divergent code): both warpgroups
  // walk all of the block's tiles, a tile a warpgroup cannot see is masked
  // whole, and tile 0 issues a PV of P = 0.
  uint32_t p[BK / 16][4] = {};  // P_{-1} = 0: the first PV adds nothing
  const uint32_t qw = sQ + wgi * 64 * ROW_BYTES;
  for (int j = 0; j < ntiles; ++j) {
    const int kt = kbeg + j * BK;
    mbar_wait(full + 8 * (j % S), (j / S) & 1);  // tile j (and Q) landed
    fence_async_smem();
    load_kv(j + S - 2);

    float s[NS];
    qk_issue<DP, BQ, BK>(s, qw, stage(j));
    pv_issue<DP, BK>(acc, p, stage(j > 0 ? j - 1 : 0) + C::KV_BYTES);
    wgmma_wait<1>();
    fence_regs<NS>(s);

    // Scores in units of scale * log2(e): p = 2^(s - m).  A masked score
    // is -inf here, so its weight 2^(-inf - m) is 0 with no select; m stays
    // -inf while a row has seen no key, and then stands in as 0.
    const bool need_mask = kt + BK > tk ||
                           (causal && kt + BK - 1 > q0 + off) ||
                           (window > 0 && kt <= q0 + BQ - 1 + off - window);
    if (need_mask) {
      // Visible columns of this thread's two rows, relative to its first
      // column of the tile: lo[r] <= frag_col(i) <= hi[r].
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = r_q + 8 * r + off, base = kt + c_k;
        hi[r] = (causal ? min(qpos, tk - 1) : tk - 1) - base;
        lo[r] = window > 0 ? qpos - window + 1 - base : -BK;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1, c = frag_col(i);
        s[i] = c >= lo[r] && c <= hi[r] ? s[i] * scale_log2 : -INFINITY;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= scale_log2;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float corr[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // O and l are 0 until a row sees a key: any finite factor will do
      corr[r] = m[r] == -INFINITY ? 0.f : exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2_approx(s[i] - base[r]);
      l[r] += s[i];
    }

    wgmma_wait<0>();  // PV_{j-1}: O is final for the old max, p is free
    fence_regs(p);
    fence_regs<DP / 2>(acc);
    if (j > 0) mbar_arrive(empty + 8 * ((j - 1) % S));
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    pack_p<BK>(s, p);
  }
  if (ntiles > 0) {  // the last tile's PV (its stage is never refilled)
    pv_issue<DP, BK>(acc, p, stage(ntiles - 1) + C::KV_BYTES);
    wgmma_wait<0>();
    fence_regs(p);
    fence_regs<DP / 2>(acc);
  }

  // Epilogue: O / l in bf16, staged through this warpgroup's Q rows.
  cp_async_wait_all();  // Q's copies, when no tile was loaded
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // the natural log-sum-exp of the row's scaled scores (m is in units of
    // log2); -inf for a row that sees no key
    const int row = r_q + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && row < tq)
      lse[((long long)b * hq + h) * tq + row] =
          l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : -INFINITY;
    l[r] = l[r] == 0.f ? 1.f : l[r];
  }
  const int r_local = 64 * wgi + 16 * warp + (lane >> 2);
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = r_local + frag_row(i), c = frag_col(i) + c_k;
    const float dl = l[(i >> 1) & 1];
    *reinterpret_cast<uint32_t*>(smem + sw128<BQ>(r, c >> 3) +
                                 2 * (c & 7)) =
        pack_bf16(acc[i] / dl, acc[i + 1] / dl);
  }
  __syncthreads();
  store_tile<BQ, D, THREADS>(ob, st.o_s, smem, q0, tq, tid);
}

// Rows of the K and V tiles of tile_products.
template <int D>
constexpr int TILE_KEYS = Cfg<D>::BK > 64 ? Cfg<D>::BK : 64;

// One warpgroup's two products on a single 64-row tile, for the card
// tests: q, k, v contiguous (64, D) bf16; s = q k^T (64 x 64 float32),
// o = bf16(s) v (64 x D float32), through the kernel's own loads and wgmma
// calls, over the 64 keys in K/V tiles of the instance's BK.
template <int D>
__global__ void __launch_bounds__(128)
    tile_products(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, float* __restrict__ s_out,
                  float* __restrict__ o_out) {
  // K/V tiles of BK keys cover the 64 keys (a tile of 128 has 64 zero
  // rows, whose columns of s are not written).
  constexpr int DP = Cfg<D>::DP, BK = Cfg<D>::BK;
  constexpr int NT = BK < 64 ? 64 / BK : 1, TB = TILE_KEYS<D> * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem), sK = sQ + 64 * DP * 2, sV = sK + TB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (DP != D) {
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < (64 * DP * 2 + 2 * TB) / 16; i += 128)
      p[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  load_tile<64, D, 128>(sQ, q, D, 0, 64, tid);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    load_tile<BK, D, 128>(sK + t * BK * DP * 2, k, D, t * BK, 64, tid);
    load_tile<BK, D, 128>(sV + t * BK * DP * 2, v, D, t * BK, 64, tid);
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float s[BK / 2];
    qk_issue<DP, 64, BK>(s, sQ, sK + t * BK * DP * 2);
    wgmma_wait<0>();
    fence_regs<BK / 2>(s);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int c = t * BK + frag_col(i) + c0;
      if (c < 64) s_out[(r0 + frag_row(i)) * 64 + c] = s[i];
    }
    uint32_t p[BK / 16][4];
    pack_p<BK>(s, p);
    pv_issue<DP, BK>(acc, p, sV + t * BK * DP * 2);
    wgmma_wait<0>();
    fence_regs(p);
    fence_regs<DP / 2>(acc);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int c = frag_col(i) + c0;
    if (c < D) o_out[(r0 + frag_row(i)) * D + c] = acc[i];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides& st, int b, int hq, int hkv, int tq, int tk,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_fwd_wgmma<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((tq + C::BQ - 1) / C::BQ, hq, b);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, st, hq,
      hkv, tq, tk, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tile(const void* q, const void* k, const void* v, void* s,
                void* o, cudaStream_t stream) {
  constexpr int smem = (64 + 2 * TILE_KEYS<D>) * Cfg<D>::DP * 2 + 1024;
  auto kern = tile_products<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, 128, smem, stream>>>((const bf16*)q, (const bf16*)k,
                                 (const bf16*)v, (float*)s, (float*)o);
  return (int)cudaGetLastError();
}

}  // namespace wg


// ---------------------------------------------------------------------------
// Backward, float32: FlashAttention-2's scheme on the float32 cores.
namespace bwd {

constexpr int BQ = 64;        // query rows a tile
constexpr int BK = 32;        // keys a tile
constexpr int THREADS = 256;  // 16 x 16 for the score tile (ty rows, tx keys)
constexpr int PS = BK + 1;    // padded row of the P / dS tiles

struct Strides {  // (batch, head, sequence) of each tensor, in elements
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s,
      do_b, do_h, do_s, dq_b, dq_h, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h,
      dv_s;
};

// delta_i = sum_d dO_i,d O_i,d (float32), a warp a row of (B, Hq, Tq).
__global__ void __launch_bounds__(THREADS)
    bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ delta, Strides s, int hq, int tq, int d,
              long long rows) {
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31, i = (int)(row % tq);
  const long long bh = row / tq;
  const int h = (int)(bh % hq), b = (int)(bh / hq);
  const float* orow = o + b * s.o_b + h * s.o_h + i * s.o_s;
  const float* grow = dout + b * s.do_b + h * s.do_h + i * s.do_s;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(orow[c], grow[c], acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

// Rows [row0, row0 + ROWS) of a (T, D) view with row stride ls into a
// float tile of row stride LDS; rows outside [0, limit) are zero.
template <int ROWS, int D, int LDS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ls, int row0, int limit,
                                          int tid) {
  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    dst[r * LDS + c] = row < limit ? src[row * ls + c] : 0.f;
  }
}

// The tile's shared memory, in floats: Q and dO (BQ x D), K and V (BK x
// (D + 4), conflict-free float4 rows), P and dS (BQ x PS), lse and delta.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * BQ * D + 2 * BK * (D + 4) + 2 * BQ * PS + 2 * BQ);
}

// One (query tile q0, key tile k0) pair: S = Q K^T and dP = dO V^T for the
// thread's rows ty + 16 i and keys tx + 16 j, then P = exp(S scale - lse)
// (0 where masked) and dS = P (dP - delta) into sP and sdS.
template <int D>
__device__ __forceinline__ void p_ds(const float* sQ, const float* sdO,
                                     const float* sK, const float* sV,
                                     const float* sL, const float* sDl,
                                     float* sP, float* sdS, int ty, int tx,
                                     int q0, int k0, int tq, int tk, int off,
                                     int causal, int window, float scale) {
  constexpr int KS = D + 4;
  float s[4][2], dp[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float qv[4][4], gv[4][4], kv[2][4], vv[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      simt::lds<4>(sQ + (ty + 16 * i) * D + d, qv[i]);
      simt::lds<4>(sdO + (ty + 16 * i) * D + d, gv[i]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      simt::lds<4>(sK + (tx + 16 * j) * KS + d, kv[j]);
      simt::lds<4>(sV + (tx + 16 * j) * KS + d, vv[j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
          dp[i][j] = fmaf(gv[i][e], vv[j][e], dp[i][j]);
        }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r, qpos = qi + off;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      // a visible key implies a finite lse for its row
      const bool ok = qi < tq && kpos < tk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
      sP[r * PS + c] = p;
      sdS[r * PS + c] = p * (dp[i][j] - sDl[r]);
    }
  }
}

// dK and dV of one key tile of one KV head: one block a (key tile, KV head,
// batch).  It walks the Hq / Hkv query heads of its group and, for each, the
// query tiles that see the tile, so the GQA sum stays in the block (no
// atomics: the same inputs give the same bits).  Thread t accumulates key
// t / 8 and columns t % 8 + 8 c of both.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, Strides s, int hq,
             int hkv, int tq, int tk, int causal, int window, float scale) {
  constexpr int KS = D + 4, NC = D / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + BQ * D;
  float* sK = sdO + BQ * D;
  float* sV = sK + BK * KS;
  float* sP = sV + BK * KS;
  float* sdS = sP + BQ * PS;
  float* sL = sdS + BQ * PS;
  float* sDl = sL + BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kk = tid >> 3, c0 = tid & 7;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv, off = tk - tq;
  load_rows<BK, D, KS>(sK, k + b * s.k_b + hk * s.k_h, s.k_s, k0, tk, tid);
  load_rows<BK, D, KS>(sV, v + b * s.v_b + hk * s.v_h, s.v_s, k0, tk, tid);

  float adk[NC], adv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adk[c] = adv[c] = 0.f;
  // query rows that see a key of the tile: qpos >= k0 (causal) and
  // qpos < last key + window
  const int klast = min(k0 + BK, tk) - 1;
  const int qbeg = causal ? max(0, k0 - off) / BQ * BQ : 0;
  const int qend = window > 0 ? min(tq, klast + window - off) : tq;
  for (int hi = 0; hi < rep; ++hi) {
    const int h = hk * rep + hi;
    const float* qb = q + b * s.q_b + h * s.q_h;
    const float* gb = dout + b * s.do_b + h * s.do_h;
    const float* lb = lse + ((long long)b * hq + h) * tq;
    const float* db = delta + ((long long)b * hq + h) * tq;
    for (int q0 = qbeg; q0 < qend; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<BQ, D, D>(sQ, qb, s.q_s, q0, tq, tid);
      load_rows<BQ, D, D>(sdO, gb, s.do_s, q0, tq, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < tq;
        sL[tid] = in ? lb[q0 + tid] : 0.f;
        sDl[tid] = in ? db[q0 + tid] : 0.f;
      }
      __syncthreads();
      p_ds<D>(sQ, sdO, sK, sV, sL, sDl, sP, sdS, ty, tx, q0, k0, tq, tk, off,
              causal, window, scale);
      __syncthreads();
      for (int r = 0; r < BQ; ++r) {
        const float p = sP[r * PS + kk], ds = sdS[r * PS + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          adv[c] = fmaf(p, sdO[r * D + c0 + 8 * c], adv[c]);
          adk[c] = fmaf(ds, sQ[r * D + c0 + 8 * c], adk[c]);
        }
      }
    }
  }
  const int key = k0 + kk;
  if (key < tk) {
    float* kr = dk + b * s.dk_b + hk * s.dk_h + key * s.dk_s;
    float* vr = dv + b * s.dv_b + hk * s.dv_h + key * s.dv_s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      kr[c0 + 8 * c] = adk[c] * scale;
      vr[c0 + 8 * c] = adv[c];
    }
  }
}

// dQ of one query tile of one head: one block a (query tile, head, batch),
// over the key tiles the tile sees (the forward's range).  Thread t
// accumulates row t / 4 and columns t % 4 + 4 c.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, Strides s, int hq, int hkv, int tq, int tk,
           int causal, int window, float scale) {
  constexpr int KS = D + 4, NC = D / 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + BQ * D;
  float* sK = sdO + BQ * D;
  float* sV = sK + BK * KS;
  float* sP = sV + BK * KS;
  float* sdS = sP + BQ * PS;
  float* sL = sdS + BQ * PS;
  float* sDl = sL + BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int row = tid >> 2, c0 = tid & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv), off = tk - tq;
  const float* kb = k + b * s.k_b + hk * s.k_h;
  const float* vb = v + b * s.v_b + hk * s.v_h;
  load_rows<BQ, D, D>(sQ, q + b * s.q_b + h * s.q_h, s.q_s, q0, tq, tid);
  load_rows<BQ, D, D>(sdO, dout + b * s.do_b + h * s.do_h, s.do_s, q0, tq,
                      tid);
  if (tid < BQ) {
    const bool in = q0 + tid < tq;
    const long long i = ((long long)b * hq + h) * tq + q0 + tid;
    sL[tid] = in ? lse[i] : 0.f;
    sDl[tid] = in ? delta[i] : 0.f;
  }
  float adq[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adq[c] = 0.f;
  const int last_row = min(q0 + BQ, tq) - 1;
  const int kend = causal ? min(tk, last_row + off + 1) : tk;
  int kbeg = 0;
  if (window > 0) kbeg = max(0, q0 + off - window + 1) / BK * BK;
  for (int kt = kbeg; kt < kend; kt += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<BK, D, KS>(sK, kb, s.k_s, kt, tk, tid);
    load_rows<BK, D, KS>(sV, vb, s.v_s, kt, tk, tid);
    __syncthreads();
    p_ds<D>(sQ, sdO, sK, sV, sL, sDl, sP, sdS, ty, tx, q0, kt, tq, tk, off,
            causal, window, scale);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float ds = sdS[row * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        adq[c] = fmaf(ds, sK[j * KS + c0 + 4 * c], adq[c]);
    }
  }
  if (q0 + row < tq) {
    float* qr = dq + b * s.dq_b + h * s.dq_h + (q0 + row) * s.dq_s;
#pragma unroll
    for (int c = 0; c < NC; ++c) qr[c0 + 4 * c] = adq[c] * scale;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const Strides& s, int b, int hq, int hkv,
           int tq, int tk, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const long long rows = (long long)b * hq * tq;
  const long long dblocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (dblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_delta<<<(unsigned)dblocks, THREADS, 0, stream>>>(
      (const float*)o, (const float*)dout, delta, s, hq, tq, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kv_kern = bwd_dkdv<D>;
  auto q_kern = bwd_dq<D>;
  e = cudaFuncSetAttribute(kv_kern,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  kv_kern<<<dim3((tk + BK - 1) / BK, hkv, b), THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, s, hq, hkv, tq, tk, causal, window,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q_kern<<<dim3((tq + BQ - 1) / BQ, hq, b), THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, s, hq, hkv, tq, tk, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// Backward, bfloat16: FlashAttention-2/3's scheme on the tensor cores, built
// from the forward's pieces (swizzled panels, the cp.async ring on
// mbarriers, qk_issue / pv_issue and their fragment rules).
namespace wgb {

using namespace wg;

constexpr int THREADS = 256;  // two consumer warpgroups

// Rings of KV_STAGES / DQ_STAGES tiles: tile j + STAGES - 2 is in flight
// while tile j is used.
template <int D>
struct Cfg {
  static constexpr int DP = D < 64 ? 64 : D;  // head dim padded to a panel
  // D 256 splits the head dim of dK and dV between the two warpgroups:
  // 64 keys x 256 columns of dK and dV would be 256 float32 registers a
  // thread, so both warpgroups take the same 64 keys, each computes S^T
  // and dP^T for them (the products are repeated), and each holds dK and
  // dV for its 128 columns.
  static constexpr bool SPLIT = D > 128;
  static constexpr int DH = SPLIT ? DP / 2 : DP;  // dK/dV columns a wg
  // dK/dV: a block a (key tile of BKV, KV head, batch), 64 keys a
  // warpgroup (the same 64 under SPLIT); Q and dO tiles of BQ rows (with
  // their lse and delta) stream through the ring.  At D 256, K and V
  // take 64 KB and a stage of Q and dO 32 KB.
  static constexpr int BKV = SPLIT ? 64 : 128, BQ = SPLIT ? 32 : 64;
  static constexpr int KV_STAGES = 4;
  static constexpr int KV_BYTES = BKV * DP * 2;  // K or V
  static constexpr int QT_BYTES = BQ * DP * 2;   // a streamed Q or dO tile
  static constexpr int KV_RING = 2 * KV_BYTES;   // stage s: Q, then dO
  static constexpr int KV_ROWS =
      KV_RING + KV_STAGES * 2 * QT_BYTES;        // lse, delta
  static constexpr int KV_BAR = KV_ROWS + KV_STAGES * 2 * BQ * 4;
  static constexpr int KV_SMEM = KV_BAR + KV_STAGES * 2 * 8 + 1024;
  // dQ: a block a (query tile of BQ_DQ, head, batch), 64 rows a
  // warpgroup; K and V tiles of BK keys stream through the ring (at D 256
  // Q and dO take 128 KB, so 3 stages of 32 keys, as the forward's tile).
  static constexpr int BQ_DQ = 128, BK = SPLIT ? 32 : 64;
  static constexpr int DQ_STAGES = SPLIT ? 3 : 4;
  static constexpr int Q_BYTES = BQ_DQ * DP * 2;  // Q or dO
  static constexpr int KT_BYTES = BK * DP * 2;    // a streamed K or V tile
  static constexpr int DQ_RING = 2 * Q_BYTES;     // stage s: K, then V
  static constexpr int DQ_BAR = DQ_RING + DQ_STAGES * 2 * KT_BYTES;
  static constexpr int DQ_SMEM = DQ_BAR + DQ_STAGES * 2 * 8 + 1024;
  static_assert(KV_SMEM <= 232448 && DQ_SMEM <= 232448, "shared memory");
};

// 4-byte async copy (zero-filled when !in): lse and delta rows, whose
// starts need not be 16-byte aligned.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

// delta_i = sum_d dO_i,d O_i,d in float32: D / 8 threads a row, each one
// 16-byte chunk of both rows.
template <int D>
__global__ void __launch_bounds__(THREADS)
    bwd_delta_vec(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  float* __restrict__ delta, bwd::Strides s, int hq, int tq,
                  long long rows) {
  constexpr int CPR = D / 8, RPB = THREADS / CPR;
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / CPR;
  const int c = threadIdx.x % CPR;
  float acc = 0.f;
  if (row < rows) {
    const int i = (int)(row % tq);
    const long long bh = row / tq;
    const int h = (int)(bh % hq), b = (int)(bh / hq);
    const uint4 a = *reinterpret_cast<const uint4*>(
        o + b * s.o_b + h * s.o_h + i * s.o_s + c * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(
        dout + b * s.do_b + h * s.do_h + i * s.do_s + c * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(g2[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int w = CPR / 2; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (row < rows && c == 0) delta[row] = acc;
}

// Stages a warpgroup's (64 x DP) float32 accumulator, times mul and
// rounded to bf16, into rows [64 wgi, 64 wgi + 64) of a swizzled tile of
// ROWS rows at smem.
template <int ROWS, int DP>
__device__ __forceinline__ void stage_acc(uint8_t* smem, const float* acc,
                                          float mul, int r_local, int c0) {
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = r_local + frag_row(i), c = frag_col(i) + c0;
    *reinterpret_cast<uint32_t*>(smem + sw128<ROWS>(r, c >> 3) +
                                 2 * (c & 7)) =
        pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
}

// dK and dV of one key tile of one KV head, on the transposed scores: a
// warpgroup's 64 keys are the M rows of S^T = K Q^T and dP^T = V dO^T
// (ss wgmma, both operands K-major), P^T and dS^T are formed on the
// accumulator fragment (lse and delta indexed by column, so by query),
// and dV += bf16(P^T) dO, dK += bf16(dS^T) Q run as rs wgmma with dO and
// Q the MN-major B operand (the forward's P V).  The block walks the
// Hq / Hkv query heads of its group and the query tiles that see its keys
// (the GQA sum stays in registers).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, bwd::Strides s, int hq, int hkv,
                   int tq, int tk, int causal, int window, float scale,
                   float scale_log2) {
  using C = Cfg<D>;
  constexpr int DP = C::DP, DH = C::DH, BKV = C::BKV, BQ = C::BQ;
  constexpr int S = C::KV_STAGES;
  constexpr int NS = BQ / 2;  // S^T registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + C::KV_BYTES;
  const float* rows_f = reinterpret_cast<const float*>(smem + C::KV_ROWS);
  const uint32_t full = sK + C::KV_BAR, empty = full + 8 * S;

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  // key tiles in the slowest grid dimension: causal key tile 0, which
  // every query tile sees, runs first
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int rep = hq / hkv, off = tk - tq;

  if constexpr (DP != D) {  // zero the pad columns of every tile once
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < C::KV_ROWS / 16; i += THREADS)
      p[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0)
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, THREADS);
      mbar_init(empty + 8 * i, THREADS);
    }
  fence_async_smem();
  __syncthreads();

  load_tile<BKV, D, THREADS>(sK, k + b * s.k_b + hk * s.k_h, s.k_s, k0, tk,
                             tid);
  load_tile<BKV, D, THREADS>(sV, v + b * s.v_b + hk * s.v_h, s.v_s, k0, tk,
                             tid);

  // Query rows that see a key of the tile: qpos >= k0 (causal) and
  // qpos < last key + window; every head of the group walks them.
  const int klast = min(k0 + BKV, tk) - 1;
  const int qbeg = causal ? max(0, k0 - off) / BQ * BQ : 0;
  const int qend = window > 0 ? min(tq, klast + window - off) : tq;
  const int nq = qend > qbeg ? (qend - qbeg + BQ - 1) / BQ : 0;
  const int n = rep * nq;

  auto stage = [&](int j) {
    return sK + C::KV_RING + (j % S) * 2 * C::QT_BYTES;
  };
  auto load_q = [&](int j) {  // tile j into its stage; arrives on full
    if (j < n) {
      if (j >= S)  // the stage's previous tile, j - S, is done everywhere
        mbar_wait(empty + 8 * (j % S), ((j - S) / S) & 1);
      const int hi = j / nq, q0 = qbeg + (j - hi * nq) * BQ;
      const int h = hk * rep + hi;
      load_tile<BQ, D, THREADS>(stage(j), q + b * s.q_b + h * s.q_h, s.q_s,
                                q0, tq, tid);
      load_tile<BQ, D, THREADS>(stage(j) + C::QT_BYTES,
                                dout + b * s.do_b + h * s.do_h, s.do_s, q0,
                                tq, tid);
      // lse, then delta: 2 BQ floats (surplus threads repeat a copy)
      const int e = tid % (2 * BQ), r = e % BQ;
      const bool in = q0 + r < tq;
      const float* src = (e < BQ ? lse : delta) +
                         ((long long)b * hq + h) * tq + q0 + r;
      cp_async4(smem_u32(rows_f + (j % S) * 2 * BQ + e), in ? src : lse, in);
      cp_async_arrive(full + 8 * (j % S));
    }
  };
#pragma unroll
  for (int j = 0; j < S - 2; ++j) load_q(j);

  float dka[DH / 2], dva[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  // the warpgroup's keys (rows of the K and V tiles) and, under SPLIT, its
  // columns of dK and dV: panels col0 / 64 on of the Q and dO tiles
  const int key0 = C::SPLIT ? 0 : 64 * wgi;
  const int col0 = C::SPLIT ? DH * wgi : 0;
  const uint32_t kw = sK + key0 * ROW_BYTES;
  const uint32_t vw = sV + key0 * ROW_BYTES;
  const uint32_t half = (col0 / 64) * BQ * ROW_BYTES;
  const int r_k = k0 + key0 + 16 * warp + (lane >> 2);  // first key
  const int c_q = 2 * (lane & 3);                       // first column

  // No branch depends on the thread (ptxas serialises every wgmma of a
  // kernel whose waits it must place in divergent code): both warpgroups
  // walk every tile of the block, and masks are selects.
  for (int j = 0; j < n; ++j) {
    mbar_wait(full + 8 * (j % S), (j / S) & 1);  // tile j (and K/V) landed
    fence_async_smem();
    load_q(j + S - 2);
    const int hi = j / nq, q0 = qbeg + (j - hi * nq) * BQ;
    const uint32_t sq = stage(j), sdo = sq + C::QT_BYTES;
    const float* lrow = rows_f + (j % S) * 2 * BQ;
    const float* drow = lrow + BQ;

    float st[NS], dpt[NS];
    qk_issue<DP, BKV, BQ>(st, kw, sq);    // S^T = K Q^T
    qk_issue<DP, BKV, BQ>(dpt, vw, sdo);  // dP^T = V dO^T
    wgmma_wait<1>();
    fence_regs<NS>(st);

    // P^T = 2^(S^T scale log2 e - lse log2 e); masked elements are 0 by a
    // select (a row that sees no key has lse = -inf).
    const bool need_mask = q0 + BQ > tq || k0 + BKV > tk ||
                           (causal && k0 + BKV - 1 > q0 + off) ||
                           (window > 0 && k0 <= q0 + BQ - 1 + off - window);
    int lo[2], hi_[2];  // visible columns of the thread's two keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = r_k + 8 * r, base = q0 + c_q;
      // query qi sees key kpos: qi < tq, kpos < tk, qi + off >= kpos
      // (causal) and qi + off < kpos + window
      const int last = window > 0 ? min(tq - 1, kpos - off + window - 1)
                                  : tq - 1;
      lo[r] = (causal ? kpos - off : q0) - base;
      hi_[r] = kpos < tk ? last - base : lo[r] - 1;
    }
#pragma unroll
    for (int g = 0; g < NS / 4; ++g) {
      const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * g + c_q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * g + e, r = (e >> 1) & 1, c = frag_col(i);
        const float l = (e & 1) ? l2.y : l2.x;
        const float p = exp2_approx(fmaf(st[i], scale_log2, -l * LOG2E));
        st[i] = !need_mask || (c >= lo[r] && c <= hi_[r]) ? p : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs<NS>(dpt);
#pragma unroll
    for (int g = 0; g < NS / 4; ++g) {
      const float2 d2 = *reinterpret_cast<const float2*>(drow + 8 * g + c_q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * g + e;
        dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x));  // dS^T
      }
    }
    uint32_t pp[BQ / 16][4], pds[BQ / 16][4];
    pack_p<BQ>(st, pp);
    pack_p<BQ>(dpt, pds);
    pv_issue<DH, BQ>(dva, pp, sdo + half);  // dV += bf16(P^T) dO
    pv_issue<DH, BQ>(dka, pds, sq + half);  // dK += bf16(dS^T) Q
    wgmma_wait<0>();
    fence_regs(pp);
    fence_regs(pds);
    fence_regs<DH / 2>(dva);
    fence_regs<DH / 2>(dka);
    mbar_arrive(empty + 8 * (j % S));
  }

  // Epilogue: dK scale and dV in bf16, staged through the K and V tiles.
  cp_async_wait_all();  // K/V's copies, when no query tile sees the keys
  __syncthreads();
  const int r_local = key0 + 16 * warp + (lane >> 2);
  stage_acc<BKV, DH>(smem, dka, scale, r_local, col0 + c_q);
  stage_acc<BKV, DH>(smem + C::KV_BYTES, dva, 1.f, r_local, col0 + c_q);
  __syncthreads();
  store_tile<BKV, D, THREADS>(dk + b * s.dk_b + hk * s.dk_h, s.dk_s, smem,
                             k0, tk, tid);
  store_tile<BKV, D, THREADS>(dv + b * s.dv_b + hk * s.dv_h, s.dv_s,
                             smem + C::KV_BYTES, k0, tk, tid);
}

// dQ of one query tile of one head: S = Q K^T and dP = dO V^T (ss wgmma),
// P and dS on the fragment as the forward's softmax (lse and delta by
// row), dQ += bf16(dS) K as rs wgmma with K the MN-major B operand (the
// forward's P V); over the forward's key tiles.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 bwd::Strides s, int hq, int hkv, int tq, int tk, int causal,
                 int window, float scale, float scale_log2) {
  using C = Cfg<D>;
  constexpr int DP = C::DP, BQ = C::BQ_DQ, BK = C::BK, S = C::DQ_STAGES;
  constexpr int NS = BK / 2;  // S registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem), sdO = sQ + C::Q_BYTES;
  const uint32_t full = sQ + C::DQ_BAR, empty = full + 8 * S;

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int hk = h / (hq / hkv), off = tk - tq;
  const bf16* kb = k + b * s.k_b + hk * s.k_h;
  const bf16* vb = v + b * s.v_b + hk * s.v_h;

  if constexpr (DP != D) {
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < C::DQ_BAR / 16; i += THREADS)
      p[i] = make_uint4(0, 0, 0, 0);
  }
  if (tid == 0)
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, THREADS);
      mbar_init(empty + 8 * i, THREADS);
    }
  fence_async_smem();
  __syncthreads();

  load_tile<BQ, D, THREADS>(sQ, q + b * s.q_b + h * s.q_h, s.q_s, q0, tq,
                            tid);
  load_tile<BQ, D, THREADS>(sdO, dout + b * s.do_b + h * s.do_h, s.do_s, q0,
                            tq, tid);

  // the forward's key range
  const int last_row = min(q0 + BQ, tq) - 1;
  const int kend = causal ? min(tk, last_row + off + 1) : tk;
  const int kbeg = window > 0 ? max(0, q0 + off - window + 1) / BK * BK : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  auto stage = [&](int j) {
    return sQ + C::DQ_RING + (j % S) * 2 * C::KT_BYTES;
  };
  auto load_kv = [&](int j) {
    if (j < ntiles) {
      if (j >= S) mbar_wait(empty + 8 * (j % S), ((j - S) / S) & 1);
      const int kt = kbeg + j * BK;
      load_tile<BK, D, THREADS>(stage(j), kb, s.k_s, kt, tk, tid);
      load_tile<BK, D, THREADS>(stage(j) + C::KT_BYTES, vb, s.v_s, kt, tk,
                                tid);
      cp_async_arrive(full + 8 * (j % S));
    }
  };
#pragma unroll
  for (int j = 0; j < S - 2; ++j) load_kv(j);

  const int r_q = q0 + 64 * wgi + 16 * warp + (lane >> 2);  // first row
  const int c_k = 2 * (lane & 3);                           // first column
  float l2[2], dl[2];  // lse log2 e and delta of the thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_q + 8 * r;
    const long long i = ((long long)b * hq + h) * tq + row;
    l2[r] = row < tq ? lse[i] * LOG2E : 0.f;
    dl[r] = row < tq ? delta[i] : 0.f;
  }
  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
  const uint32_t qw = sQ + wgi * 64 * ROW_BYTES;
  const uint32_t dow = sdO + wgi * 64 * ROW_BYTES;

  for (int j = 0; j < ntiles; ++j) {
    const int kt = kbeg + j * BK;
    mbar_wait(full + 8 * (j % S), (j / S) & 1);  // tile j (and Q, dO) landed
    fence_async_smem();
    load_kv(j + S - 2);

    float sc[NS], dp[NS];
    qk_issue<DP, BQ, BK>(sc, qw, stage(j));                // S = Q K^T
    qk_issue<DP, BQ, BK>(dp, dow, stage(j) + C::KT_BYTES);  // dP = dO V^T
    wgmma_wait<1>();
    fence_regs<NS>(sc);

    const bool need_mask = kt + BK > tk ||
                           (causal && kt + BK - 1 > q0 + off) ||
                           (window > 0 && kt <= q0 + BQ - 1 + off - window);
    int lo[2], hi[2];  // visible columns of the thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r_q + 8 * r + off, base = kt + c_k;
      hi[r] = (causal ? min(qpos, tk - 1) : tk - 1) - base;
      lo[r] = window > 0 ? qpos - window + 1 - base : -BK;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1, c = frag_col(i);
      const float p = exp2_approx(fmaf(sc[i], scale_log2, -l2[r]));
      sc[i] = !need_mask || (c >= lo[r] && c <= hi[r]) ? p : 0.f;
    }
    wgmma_wait<0>();
    fence_regs<NS>(dp);
#pragma unroll
    for (int i = 0; i < NS; ++i) dp[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]);
    uint32_t pds[BK / 16][4];
    pack_p<BK>(dp, pds);
    pv_issue<DP, BK>(dqa, pds, stage(j));  // dQ += bf16(dS) K
    wgmma_wait<0>();
    fence_regs(pds);
    fence_regs<DP / 2>(dqa);
    mbar_arrive(empty + 8 * (j % S));
  }

  // Epilogue: dQ scale in bf16, staged through the Q tile.
  cp_async_wait_all();  // Q's and dO's copies, when no key tile was loaded
  __syncthreads();
  stage_acc<BQ, DP>(smem, dqa, scale, 64 * wgi + 16 * warp + (lane >> 2),
                    c_k);
  __syncthreads();
  store_tile<BQ, D, THREADS>(dq + b * s.dq_b + h * s.dq_h, s.dq_s, smem, q0,
                            tq, tid);
}

// bf16(a) (64 x 64, float32) . b (64 x D, bf16) in float32, through the
// backward's rs product: a in the accumulator fragment's layout rounded to
// the A fragment (pack_p), b a 64-row swizzled tile read MN-major
// (P^T dO, dS^T Q and dS K have this shape a warpgroup at D <= 128; at D
// 256 they run at depth 32, dK and dV over 128 of the columns, with the
// same descriptors per k-step).
template <int D>
__global__ void __launch_bounds__(128)
    bwd_tile_products(const float* __restrict__ a, const bf16* __restrict__ bm,
                      float* __restrict__ out) {
  constexpr int DP = Cfg<D>::DP, KD = 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sB = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (DP != D) {
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < KD * DP * 2 / 16; i += 128)
      p[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  load_tile<KD, D, 128>(sB, bm, D, 0, KD, tid);
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  float f[KD / 2];
#pragma unroll
  for (int i = 0; i < KD / 2; ++i)
    f[i] = a[(r0 + frag_row(i)) * KD + frag_col(i) + c0];
  uint32_t p[KD / 16][4];
  pack_p<KD>(f, p);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  pv_issue<DP, KD>(acc, p, sB);
  wgmma_wait<0>();
  fence_regs(p);
  fence_regs<DP / 2>(acc);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int c = frag_col(i) + c0;
    if (c < D) out[(r0 + frag_row(i)) * D + c] = acc[i];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const bwd::Strides& s, int b, int hq, int hkv,
           int tq, int tk, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr int RPB = THREADS / (D / 8);  // delta rows a block
  const long long rows = (long long)b * hq * tq;
  const long long dblocks = (rows + RPB - 1) / RPB;
  const int kv_tiles = (tk + C::BKV - 1) / C::BKV;
  const int q_tiles = (tq + C::BQ_DQ - 1) / C::BQ_DQ;
  if (dblocks > 0x7fffffffLL || kv_tiles > 65535 || q_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  bwd_delta_vec<D><<<(unsigned)dblocks, THREADS, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, delta, s, hq, tq, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kv_kern = bwd_dkdv_wgmma<D>;
  auto q_kern = bwd_dq_wgmma<D>;
  e = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * LOG2E;
  kv_kern<<<dim3(hkv, b, kv_tiles), THREADS, C::KV_SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dk, (bf16*)dv, s, hq, hkv, tq, tk, causal, window, scale,
      scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q_kern<<<dim3(hq, b, q_tiles), THREADS, C::DQ_SMEM, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dq, s, hq, hkv, tq, tk, causal, window, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tile(const void* a, const void* bm, void* out,
                cudaStream_t stream) {
  constexpr int smem = 64 * Cfg<D>::DP * 2 + 1024;
  auto kern = bwd_tile_products<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, 128, smem, stream>>>((const float*)a, (const bf16*)bm,
                                 (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace wgb

// One switch over the head dims for every launcher (L::run<D>).
template <typename L, typename... A>
int dispatch_d(int d, A... args) {
  switch (d) {
    case 16: return L::template run<16>(args...);
    case 32: return L::template run<32>(args...);
    case 64: return L::template run<64>(args...);
    case 128: return L::template run<128>(args...);
    case 256: return L::template run<256>(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

struct SimtLaunch {
  template <int D, typename... A>
  static int run(A... args) { return simt::launch<D>(args...); }
};
struct WgmmaLaunch {
  template <int D, typename... A>
  static int run(A... args) { return wg::launch<D>(args...); }
};
struct TileLaunch {
  template <int D, typename... A>
  static int run(A... args) { return wg::launch_tile<D>(args...); }
};
struct BwdLaunch {
  template <int D, typename... A>
  static int run(A... args) { return bwd::launch<D>(args...); }
};
struct BwdWgmmaLaunch {
  template <int D, typename... A>
  static int run(A... args) { return wgb::launch<D>(args...); }
};
struct BwdTileLaunch {
  template <int D, typename... A>
  static int run(A... args) { return wgb::launch_tile<D>(args...); }
};

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (batch, head,
// sequence) of q, k, v and out in turn.  window <= 0: no window.  bfloat16
// needs every row start 16-byte aligned (pointers and the three strides).
// lse: null, or a contiguous float32 (B, Hq, Tq) that receives each row's
// natural log-sum-exp of its scaled scores (-inf where it sees no key),
// which the backward takes.
extern "C" int flash_attention_fwd(int dtype, int d, const void* q,
                                   const void* k, const void* v, void* o,
                                   float* lse, const long long* strides,
                                   int b, int hq,
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
    return dispatch_d<SimtLaunch>(d, q, k, v, o, lse, st, b, hq, hkv, tq,
                                  tk, causal, window, scale, s);
  if (dtype == 1) {
    for (int i = 0; i < 12; ++i)
      if (strides[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
    if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
    return dispatch_d<WgmmaLaunch>(d, q, k, v, o, lse, st, b, hq, hkv, tq,
                                   tk, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's two wgmma products on one (64, d) tile (card tests):
// s = q k^T (64, 64) and o = bf16(s) v (64, d), both float32.
extern "C" int flash_attention_tile_products(int d, const void* q,
                                             const void* k, const void* v,
                                             void* s, void* o, void* stream) {
  return dispatch_d<TileLaunch>(d, q, k, v, s, o, (cudaStream_t)stream);
}

// The backward: dq in q's layout, dk / dv in k's / v's (24 element strides,
// (batch, head, sequence) of q, k, v, o, dout, dq, dk, dv in turn), in the
// input dtype, from the forward's o and lse (contiguous float32 (B, Hq, Tq)).
// delta: float32 (B, Hq, Tq) scratch.  Head dims 16-256.
// bfloat16 needs every row start 16-byte aligned (the eight pointers and
// the 24 strides).
extern "C" int flash_attention_bwd(int dtype, int d, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv,
                                   const long long* strides, int b, int hq,
                                   int hkv, int tq, int tk, int causal,
                                   int window, float scale, void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  static_assert(sizeof(bwd::Strides) == 24 * sizeof(long long), "strides");
  bwd::Strides st;
  memcpy(&st, strides, sizeof st);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<BwdLaunch>(d, q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 st, b, hq, hkv, tq, tk, causal, window,
                                 scale, s);
  if (dtype == 1) {
    for (int i = 0; i < 24; ++i)
      if (strides[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
    const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
    uintptr_t any = 0;
    for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
    if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
    return dispatch_d<BwdWgmmaLaunch>(d, q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, st, b, hq, hkv, tq, tk, causal,
                                      window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 backward's rs product on one tile (card tests): out = bf16(a)
// b in float32, a (64, 64) float32 and b (64, d) bf16, both contiguous;
// head dims 16-256.
extern "C" int flash_attention_bwd_tile_products(int d, const void* a,
                                                 const void* b, void* out,
                                                 void* stream) {
  return dispatch_d<BwdTileLaunch>(d, a, b, out, (cudaStream_t)stream);
}
