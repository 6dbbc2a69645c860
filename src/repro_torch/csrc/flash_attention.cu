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
// dK/dV block, or over G blocks by one kernel in group order), so a
// backward gives the same bits in every run.  Bound on the card: the bf16
// tensor-core rate (the float32 rate for float32 inputs); the least work
// is 10 D flops a visible pair (2.5x the forward's), this design does 14 D
// (S and dP are computed in both the dK/dV and the dQ kernel).
//
// Query-head groups.  A dK/dV block walks the query heads of its KV head;
// where the grid (key tiles x Hkv x B) would leave SMs idle (MQA at batch
// 1: recurrentgemma-9b's 64 key tiles at D 256), the host plan splits
// those heads into G groups, a block each, G the largest divisor of Hq /
// Hkv that keeps the grid within one wave.  With G > 1 the blocks write
// float32 partial dK and dV to scratch (2 G B Hkv Tk D floats: 16.8 MB at
// that shape) and `bwd_dkdv_sum` adds them in group order, scales dK and
// rounds to the output dtype.  bf16 at D <= 128 takes no groups.
//
// bfloat16 (namespace wgb): all five products on wgmma with float32
// accumulators, built from the forward's pieces (swizzled panels, the
// cp.async ring on mbarriers, qk_issue / pv_issue):
//   * `bwd_delta_vec`: delta_i = sum_d dO_i,d O_i,d, D / 8 threads a row,
//     16-byte loads;
//   * `bwd_dkdv_wgmma` (D <= 128): a block a (key tile of 128, KV head,
//     batch), two warpgroups of 64 keys; K and V stay in shared memory, Q
//     and dO tiles of 64 rows with their lse and delta stream through a
//     ring of 4 stages.  The keys are the M rows: S^T = K Q^T and dP^T = V
//     dO^T are ss wgmma with both operands K-major (the forward's S with
//     the roles swapped); P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T
//     = P^T (dP^T - delta) on the accumulator fragment, lse and delta
//     indexed by column; dV += bf16(P^T) dO and dK += bf16(dS^T) Q are rs
//     wgmma with the fragment as the register A operand and dO / Q the
//     MN-major B operand (the forward's P V).  The block walks the Hq /
//     Hkv query heads of its group and the query tiles that see its keys;
//     key tiles are the slowest grid dimension, so causal key tile 0 (seen
//     by every query tile) starts first;
//   * `bwd_dkdv_wgmma_pair` (D 256, recurrentgemma-9b: MQA with a window of
//     2,048): 64 keys x 256 columns of both dK and dV would be 256 float32
//     registers a thread, so both warpgroups take the same 64 keys and
//     split the products: warpgroup 0 issues S^T = K Q^T and warpgroup 1
//     dP^T = V dO^T (m64n32, the operands picked by the warpgroup index,
//     so both run one instruction stream), the two float32 fragments cross
//     through shared memory behind a named barrier, each warpgroup forms
//     P^T and dS^T, and warpgroup 0 accumulates dV += bf16(P^T) dO,
//     warpgroup 1 dK += bf16(dS^T) Q over all 256 columns (128 registers).
//     Every product runs once (8 D flops a visible pair in this kernel);
//     tile j's S^T / dP^T is issued beside tile j - 1's rs product, whose
//     run the exchange and softmax overlap.  Q and dO stream in tiles of
//     32 rows through 4 stages; K, V, the ring and the exchange (two tiles'
//     fragments) take 226 KB.  With G = 2 its grid is 128 blocks;
//   * `bwd_dq_wgmma`: a block a (query tile of 128, head, batch), two
//     warpgroups of 64 rows; Q and dO loaded once, K and V tiles of 64 keys
//     (32 in 3 stages at D 256, as the forward's tile) stream through the
//     ring over the forward's key range; S = Q K^T and dP = dO V^T ss, dQ
//     += bf16(dS) K rs with K the MN-major B;
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
//     warpgroup holds dK, dV, S^T and dP^T: 255 registers at D = 128).
// float32 (namespace bwd) runs on the float32 cores (TF32 wgmma could not
// meet the float32 checks, as for the forward), D 16-256, register-tiled:
// `bwd_delta` a warp a row, then one launch of `bwd_fused` whose first
// blocks compute dK/dV, one a (key tile of 32, KV head x group, batch)
// holding K and V, walking its heads' query tiles that see the keys (64
// rows, 32 at D 256) through two stages of 16-byte cp.async copies (tile
// j + 1 lands while tile j is used), and whose other blocks compute dQ,
// one a (query tile, head, batch) holding Q and dO, streaming the
// forward's key tiles the same way; in one launch the dQ blocks fill the
// SMs that light dK/dV blocks free (the window's last key tiles, the
// causal mask's last).  What bounds them is the shared-
// memory port: a warp's 16-byte load takes 4 of its cycles against 4
// FMA instructions a cycle on the SM, so each word loaded must feed 4
// FMAs.  Every product therefore runs on 8 x 8 outputs a thread: one
// half of the block computes S = Q K^T and the other dP = dO V^T (at D
// 256 eight lanes share an 8 x 8 block, each over its own float4 columns
// of D, and fold their sums by shuffles); half 0 writes P = exp(S scale -
// lse), half 1 reads it (a named barrier) and writes dS = P (dP - delta);
// then dV += P^T dO and dK += dS^T Q (a half each) or dQ += dS K, lanes
// sharing a block over their own rows or keys, folded once at the end.
// Shared memory 205 KB at D 256 and 184 KB (dK/dV) at D 128; one block
// (8 warps) an SM.
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
// 4-byte async copy (zero-filled when !in): lse and delta rows, whose
// starts need not be 16-byte aligned.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
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

// Named barrier 1 over N threads (0 is __syncthreads): bar1_arrive counts
// this thread in without waiting (its earlier shared-memory writes are
// seen by the threads that wait), bar1_sync counts it in and waits.
template <int N>
__device__ __forceinline__ void bar1_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bar1_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
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
// Backward, float32: FlashAttention-2's scheme on the float32 cores,
// register-tiled.
namespace bwd {

using wg::cp_async16;
using wg::cp_async4;
using wg::smem_u32;
using simt::lds;

constexpr int THREADS = 256;  // two halves of 128 threads

struct Strides {  // (batch, head, sequence) of each tensor, in elements
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s,
      do_b, do_h, do_s, dq_b, dq_h, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h,
      dv_s;
};

// The float32 instance at head dim D.  On the float32 cores a warp-wide
// 16-byte shared-memory load takes four cycles of the SM's shared-memory
// port while the four schedulers issue four FMA instructions a cycle, so
// an operand word must feed at least four FMAs: every product runs on
// 8 x 8 blocks of outputs a thread (the 16 words of a step of the sum
// feed 64 FMAs), and where a product has too few such blocks for its threads,
// lanes of a warp share a block, each over its own share of the sum, and
// add their shares by shuffles at the end (a butterfly that leaves each
// lane 64 / lanes of the sums).
//   * S = Q K^T and dP = dO V^T (a half-block each, in both kernels): SK
//     lanes share a block, each summing every SK-th run of float4 columns
//     of D, and fold their sums per tile.  Half 0 writes P = exp(S scale -
//     lse) (0 where masked), then half 1, whose threads hold dP at the
//     same elements, reads it and writes dS = P (dP - delta).
//   * dV += P^T dO and dK += dS^T Q (a half each, dkdv_block): SB lanes
//     share a block of 8 keys x 8 columns, each over its own rows of the
//     query tile (runs of 4); folded once, at the end of the block.
//   * dQ += dS K (the whole block, dq_block): SQ lanes share a block of TRQ
//     rows x 8 columns, each over its own runs of 4 keys; folded at the
//     end.
template <int D>
struct Cfg {
  static constexpr int BK = 32;                 // keys a K/V tile
  static constexpr int BQ = D > 128 ? 32 : 64;  // rows a Q/dO tile
  static constexpr int LD = D + 4;  // padded rows of Q, dO, K, V
  static constexpr int LP = BK + 4;  // padded rows of P and dS
  // S / dP: RB x KB blocks of 8 x 8 (rows rb + RB i, keys kb + KB j)
  static constexpr int RB = BQ / 8, KB = BK / 8;
  static constexpr int SK = 128 / (RB * KB);
  // its float4 columns: lane p of SK takes G8 / SK of every G8
  static constexpr int G8 = D / 4 < 8 ? D / 4 : 8;
  // dK / dV: KBB x CBB blocks of 8 keys x 8 columns (a half)
  static constexpr int KBB = BK / 8, CBB = D / 8;
  static constexpr int SB = 128 / (KBB * CBB);
  // dQ: RBQ x CBQ blocks of TRQ rows x 8 columns (the block)
  static constexpr int TRQ = D >= 32 ? 8 : 4;
  static constexpr int RBQ = BQ / TRQ, CBQ = D / 8;
  static constexpr int SQ = THREADS / (RBQ * CBQ);
  // a streamed stage: dK/dV's Q, dO, lse, delta; dQ's K, V
  static constexpr int Q_STAGE = 2 * BQ * LD + 2 * BQ;
  static constexpr int K_STAGE = 2 * BK * LD;
  // shared memory, bytes: dK/dV holds K, V, two Q stages, P, dS; dQ holds
  // Q, dO, lse, delta, two K stages, P, dS
  static constexpr int KV_SMEM = 4 * (2 * BK * LD + 2 * Q_STAGE + 2 * BQ * LP);
  static constexpr int DQ_SMEM = 4 * (Q_STAGE + 2 * K_STAGE + 2 * BQ * LP);
  static constexpr int SMEM = KV_SMEM > DQ_SMEM ? KV_SMEM : DQ_SMEM;
  static_assert(SK >= 1 && SK <= 8 && G8 % SK == 0, "S blocks");
  static_assert(SB >= 1 && SB <= 16 && BQ % (4 * SB) == 0, "dK/dV blocks");
  static_assert(SQ >= 1 && SQ <= 8 && TRQ * 8 % SQ == 0, "dQ blocks");
  static_assert(KV_SMEM <= 232448 && DQ_SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st4(float* p, const float* v, float mul) {
  *reinterpret_cast<float4*>(p) =
      make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
}

// Rows [row0, row0 + ROWS) of a (T, D) view with row stride ls (16-byte
// aligned rows) into a tile of row stride LD, as 16-byte cp.async copies;
// rows >= limit are zero-filled.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ls, int row0, int limit,
                                          int tid) {
  constexpr int CPR = D / 4, N = ROWS * CPR;
#pragma unroll
  for (int it = 0; it < (N + THREADS - 1) / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    if (N % THREADS == 0 || idx < N) {
      const int r = idx / CPR, c = idx % CPR, row = row0 + r;
      const bool in = row < limit;
      cp_async16(smem_u32(dst + r * LD + 4 * c),
                 in ? src + row * ls + 4 * c : src, in);
    }
  }
}

// ROWS floats of lse, then of delta, of rows [row0, row0 + ROWS) of one
// head into dst (zero past limit).
template <int ROWS>
__device__ __forceinline__ void load_lse(float* dst, const float* lse,
                                         const float* delta, long long base,
                                         int row0, int limit, int tid) {
  if (tid < 2 * ROWS) {
    const int r = tid % ROWS;
    const bool in = row0 + r < limit;
    const float* src = (tid < ROWS ? lse : delta) + base + row0 + r;
    cp_async4(smem_u32(dst + tid), in ? src : lse, in);
  }
}

// One butterfly step: the lanes l and l ^ M each keep half of v's N
// values (l & M: the upper half) and add the partner's copy of it.
template <int N, int M>
__device__ __forceinline__ void fold_step(const float* v, float* out,
                                          int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float send = up ? v[k] : v[k + N / 2];
    const float keep = up ? v[k + N / 2] : v[k];
    out[k] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}
// Sums v's N values over the S lanes that differ in their low log2(S)
// bits; lane l keeps out[k] = the sum of v[(N / S) (l % S) + k].
template <int N, int S>
__device__ __forceinline__ void fold(const float* v, float* out, int lane) {
  if constexpr (S == 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = v[k];
  } else {
    float half[N / 2];
    fold_step<N, S / 2>(v, half, lane);
    fold<N / 2, S / 2>(half, out, lane);
  }
}

// One half-block's product of a (BQ x BK) tile, folded over its SK lanes:
// out[8 ii + j] = sum_d xr[rb + RB i][d] xk[kb + KB j][d] for the
// thread's rows i = (8 / SK) p + ii.
template <int D>
__device__ __forceinline__ void tile_product(const float* xr, const float* xk,
                                             int rb, int kb, int p, int lane,
                                             float (&out)[64 / Cfg<D>::SK]) {
  using C = Cfg<D>;
  constexpr int RUN = C::G8 / C::SK;
  float acc[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) acc[k] = 0.f;
#pragma unroll 1
  for (int g = 0; g < D / 4; g += C::G8) {
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      const int c = 4 * (g + RUN * p + u);
      float b[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        lds<4>(xk + (kb + C::KB * j) * C::LD + c, b[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a[4];
        lds<4>(xr + (rb + C::RB * i) * C::LD + c, a);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[8 * i + j] = fmaf(a[e], b[j][e], acc[8 * i + j]);
      }
    }
  }
  fold<64, C::SK>(acc, out, lane);
}

// S (half 0) or dP (half 1) of the thread's rows into P = exp(S scale -
// lse) (0 where masked; a visible key implies a finite lse for its row)
// in sP, then dS = P (dP - delta) in sX; the tile at query row q0, key k0.
template <int D>
__device__ __forceinline__ void scores_out(const float (&v)[64 / Cfg<D>::SK],
                                           int half, int rb, int kb, int p,
                                           const float* sL, const float* sDl,
                                           float* sP, float* sX, int q0,
                                           int k0, int tq, int tk, int off,
                                           int causal, int window,
                                           float scale) {
  using C = Cfg<D>;
  constexpr int NR = 8 / C::SK;
  if (half == 0) {
#pragma unroll
    for (int ii = 0; ii < NR; ++ii) {
      const int r = rb + C::RB * (NR * p + ii), qi = q0 + r, qpos = qi + off;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kb + C::KB * j, kpos = k0 + c;
        const bool ok = qi < tq && kpos < tk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        sP[r * C::LP + c] = ok ? expf(v[8 * ii + j] * scale - sL[r]) : 0.f;
      }
    }
    wg::bar1_arrive<THREADS>();
  } else {
    wg::bar1_sync<THREADS>();  // half 0's P of the same elements
#pragma unroll
    for (int ii = 0; ii < NR; ++ii) {
      const int r = rb + C::RB * (NR * p + ii);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = kb + C::KB * j;
        sX[r * C::LP + c] = sP[r * C::LP + c] * (v[8 * ii + j] - sDl[r]);
      }
    }
  }
}

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

// dK and dV of one key tile (kt) of one KV head for one group of its
// query heads (hg = KV head x groups + group), batch b.  K and V stay in
// shared memory; the Q, dO, lse and delta tiles of the group's heads and
// the query rows that see the keys stream through two stages (tile j + 1
// copied while tile j is used).  Half 0 accumulates dV += P^T dO, half 1
// dK += dS^T Q.  groups 1 writes dK scale and dV; more write float32
// partial sums to part ([dK, dV][group][batch][KV head][key][D]), which
// bwd_dkdv_sum adds in group order.  No atomics: the same inputs give the
// same bits.
template <int D>
__device__ __forceinline__ void dkdv_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
    const Strides& s, int hq, int hkv, int tq, int tk, int causal,
    int window, float scale, int groups, int kt, int hg, int b, int nb) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LP = C::LP;
  constexpr int SK = C::SK, SB = C::SB, NB = 64 / SB;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * LD;
  float* ring = sV + BK * LD;
  float* sP = ring + 2 * C::Q_STAGE;
  float* sX = sP + BQ * LP;
  const int tid = threadIdx.x, half = tid >> 7, lane = tid & 31;
  const int w = (tid >> 5) & 3;
  const int k0 = kt * BK, hk = hg / groups, g = hg % groups;
  const int rep = hq / hkv, hpg = rep / groups, off = tk - tq;
  // the thread's S / dP block: rows rb + RB i, keys kb + KB j, lane p of SK
  const int p = lane % SK, slot = lane / SK + (32 / SK) * w;
  const int kb = slot % C::KB, rb = slot / C::KB;
  // its dK / dV block: keys 8 kbb + e, columns 4 cbb + D / 2 u, rows of
  // the query tile in runs of 4, lane pb of SB
  const int pb = lane % SB, bslot = lane / SB + (32 / SB) * w;
  const int cbb = bslot % C::CBB, kbb = bslot / C::CBB;

  load_rows<BK, D, LD>(sK, k + b * s.k_b + hk * s.k_h, s.k_s, k0, tk, tid);
  load_rows<BK, D, LD>(sV, v + b * s.v_b + hk * s.v_h, s.v_s, k0, tk, tid);
  // query rows that see a key of the tile: qpos >= k0 (causal) and
  // qpos < last key + window; every head of the group walks them
  const int klast = min(k0 + BK, tk) - 1;
  const int qbeg = causal ? max(0, k0 - off) / BQ * BQ : 0;
  const int qend = window > 0 ? min(tq, klast + window - off) : tq;
  const int nq = qend > qbeg ? (qend - qbeg + BQ - 1) / BQ : 0;
  const int n = hpg * nq;
  auto load_q = [&](int j) {  // tile j into stage j % 2
    float* st = ring + (j & 1) * C::Q_STAGE;
    const int h = hk * rep + g * hpg + j / nq, q0 = qbeg + (j % nq) * BQ;
    load_rows<BQ, D, LD>(st, q + b * s.q_b + h * s.q_h, s.q_s, q0, tq, tid);
    load_rows<BQ, D, LD>(st + BQ * LD, dout + b * s.do_b + h * s.do_h,
                         s.do_s, q0, tq, tid);
    load_lse<BQ>(st + 2 * BQ * LD, lse, delta, ((long long)b * hq + h) * tq,
                 q0, tq, tid);
  };
  if (n > 0) load_q(0);
  cp_async_commit();

  float acc[64];  // [e][c]: key 8 kbb + e, column c of the block
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; tile j - 1's readers are done
    if (j + 1 < n) load_q(j + 1);
    cp_async_commit();
    const float* sQ = ring + (j & 1) * C::Q_STAGE;
    const float* sdO = sQ + BQ * LD;
    const float* sL = sdO + BQ * LD;
    float sc[64 / SK];
    tile_product<D>(half ? sdO : sQ, half ? sV : sK, rb, kb, p, lane, sc);
    scores_out<D>(sc, half, rb, kb, p, sL, sL + BQ, sP, sX,
                  qbeg + (j % nq) * BQ, k0, tq, tk, off, causal, window,
                  scale);
    __syncthreads();
    // dV += P^T dO (half 0), dK += dS^T Q (half 1)
    const float* a_src = (half ? sX : sP) + 8 * kbb;
    const float* b_src = (half ? sQ : sdO) + 4 * cbb;
#pragma unroll 2
    for (int m = 0; m < BQ / SB; ++m) {
      const int r = (m & 3) + 4 * pb + 4 * SB * (m >> 2);
      float a[8], bv[8];
      lds<4>(a_src + r * LP, a);
      lds<4>(a_src + r * LP + 4, a + 4);
      lds<4>(b_src + r * LD, bv);
      lds<4>(b_src + r * LD + D / 2, bv + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[8 * e + c] = fmaf(a[e], bv[c], acc[8 * e + c]);
    }
  }
  cp_async_wait<0>();  // K/V's copies, when no query tile sees the keys

  float red[NB];  // keys and columns (NB / 8 rows of acc) of this lane
  fold<64, SB>(acc, red, lane);
  float* out;
  long long ls;
  float mul = 1.f;
  if (groups == 1) {
    out = half ? dk + b * s.dk_b + hk * s.dk_h : dv + b * s.dv_b + hk * s.dv_h;
    ls = half ? s.dk_s : s.dv_s;
    mul = half ? scale : 1.f;
  } else {
    out = part + (((long long)(1 - half) * groups + g) * nb * hkv +
                  (long long)b * hkv + hk) * tk * D;
    ls = D;
  }
#pragma unroll
  for (int kk = 0; kk < NB; kk += 4) {
    const int fl = NB * pb + kk, e = fl / 8, c = fl % 8;
    const int key = k0 + 8 * kbb + e;
    if (key < tk)
      st4(out + key * ls + 4 * cbb + (D / 2) * (c / 4), red + kk, mul);
  }
}

// dQ of one query tile (rows q0 on) of head h, batch b.  Q, dO, lse and
// delta stay in shared
// memory; the K and V tiles of the forward's key range stream through
// two stages; every thread accumulates dQ += dS K on its block.
template <int D>
__device__ __forceinline__ void dq_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, const Strides& s, int hq, int hkv, int tq,
    int tk, int causal, int window, float scale, int q0, int h, int b) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LP = C::LP;
  constexpr int SK = C::SK, SQ = C::SQ, TRQ = C::TRQ;
  constexpr int NQ = 8 * TRQ / SQ;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + BQ * LD;
  float* sL = sdO + BQ * LD;  // lse, then delta
  float* ring = sQ + C::Q_STAGE;
  float* sP = ring + 2 * C::K_STAGE;
  float* sX = sP + BQ * LP;
  const int tid = threadIdx.x, half = tid >> 7, lane = tid & 31;
  const int w = (tid >> 5) & 3, w8 = tid >> 5;
  const int hk = h / (hq / hkv), off = tk - tq;
  const int p = lane % SK, slot = lane / SK + (32 / SK) * w;
  const int kb = slot % C::KB, rb = slot / C::KB;
  // the thread's dQ block: rows rbq + RBQ i, columns 4 cbq + D / 2 u, runs
  // of 4 keys pq, pq + SQ, ...
  const int pq = lane % SQ, qslot = lane / SQ + (32 / SQ) * w8;
  const int cbq = qslot % C::CBQ, rbq = qslot / C::CBQ;
  const float* kbase = k + b * s.k_b + hk * s.k_h;
  const float* vbase = v + b * s.v_b + hk * s.v_h;

  load_rows<BQ, D, LD>(sQ, q + b * s.q_b + h * s.q_h, s.q_s, q0, tq, tid);
  load_rows<BQ, D, LD>(sdO, dout + b * s.do_b + h * s.do_h, s.do_s, q0, tq,
                       tid);
  load_lse<BQ>(sL, lse, delta, ((long long)b * hq + h) * tq, q0, tq, tid);
  // the forward's key range
  const int last_row = min(q0 + BQ, tq) - 1;
  const int kend = causal ? min(tk, last_row + off + 1) : tk;
  const int kbeg = window > 0 ? max(0, q0 + off - window + 1) / BK * BK : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  auto load_kv = [&](int j) {  // tile j into stage j % 2
    float* st = ring + (j & 1) * C::K_STAGE;
    const int kt = kbeg + j * BK;
    load_rows<BK, D, LD>(st, kbase, s.k_s, kt, tk, tid);
    load_rows<BK, D, LD>(st + BK * LD, vbase, s.v_s, kt, tk, tid);
  };
  if (ntiles > 0) load_kv(0);
  cp_async_commit();

  float acc[8 * TRQ];  // [i][c]: row rbq + RBQ i, column c of the block
#pragma unroll
  for (int i = 0; i < 8 * TRQ; ++i) acc[i] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; tile j - 1's readers are done
    if (j + 1 < ntiles) load_kv(j + 1);
    cp_async_commit();
    const float* sK = ring + (j & 1) * C::K_STAGE;
    const float* sV = sK + BK * LD;
    float sc[64 / SK];
    tile_product<D>(half ? sdO : sQ, half ? sV : sK, rb, kb, p, lane, sc);
    scores_out<D>(sc, half, rb, kb, p, sL, sL + BQ, sP, sX, q0,
                  kbeg + j * BK, tq, tk, off, causal, window, scale);
    __syncthreads();
    // dQ += dS K over this lane's runs of 4 keys
#pragma unroll
    for (int m = 0; m < BK / (4 * SQ); ++m) {
      const int c0 = 4 * (pq + SQ * m);
      float ds[TRQ][4];
#pragma unroll
      for (int i = 0; i < TRQ; ++i)
        lds<4>(sX + (rbq + C::RBQ * i) * LP + c0, ds[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kv[8];
        lds<4>(sK + (c0 + e) * LD + 4 * cbq, kv);
        lds<4>(sK + (c0 + e) * LD + 4 * cbq + D / 2, kv + 4);
#pragma unroll
        for (int i = 0; i < TRQ; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[8 * i + c] = fmaf(ds[i][e], kv[c], acc[8 * i + c]);
      }
    }
  }
  cp_async_wait<0>();  // Q's copies, when no key tile was loaded

  float red[NQ];
  fold<8 * TRQ, SQ>(acc, red, lane);
#pragma unroll
  for (int kk = 0; kk < NQ; kk += 4) {
    const int fl = NQ * pq + kk, i = fl / 8, c = fl % 8;
    const int row = q0 + rbq + C::RBQ * i;
    if (row < tq)
      st4(dq + b * s.dq_b + h * s.dq_h + row * s.dq_s + 4 * cbq +
              (D / 2) * (c / 4),
          red + kk, scale);
  }
}

// Both in one launch, so that dQ blocks fill the SMs that dK/dV blocks of
// little work (the window's last key tiles, causal's last) leave idle:
// blocks [0, kv_tiles x Hkv x groups x B) take dK/dV (key tiles fastest,
// heaviest first), the rest dQ (query tiles fastest, heaviest first).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_fused(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ part, Strides s,
              int nb, int hq, int hkv, int tq, int tk, int causal, int window,
              float scale, int groups, int kv_tiles, int q_tiles) {
  const int kv_blocks = kv_tiles * hkv * groups * nb;
  int id = blockIdx.x;
  if (id < kv_blocks) {
    const int kt = id % kv_tiles, hg = id / kv_tiles % (hkv * groups);
    dkdv_block<D>(q, k, v, dout, lse, delta, dk, dv, part, s, hq, hkv, tq,
                  tk, causal, window, scale, groups, kt, hg,
                  id / kv_tiles / (hkv * groups), nb);
  } else {
    id -= kv_blocks;
    const int qt = id % q_tiles, h = id / q_tiles % hq;
    dq_block<D>(q, k, v, dout, lse, delta, dq, s, hq, hkv, tq, tk, causal,
                window, scale, (q_tiles - 1 - qt) * Cfg<D>::BQ, h,
                id / q_tiles / hq);
  }
}

// dK = scale sum_g part[0][g], dV = sum_g part[1][g], the G partial sums
// of bwd_dkdv / bwd_dkdv_wgmma_pair added in group order (no atomics: the
// same bits in every run), into the output dtype T.  A thread a float4 of
// a (batch, KV head, key) row of dK or dV.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv_sum(const float* __restrict__ part, T* __restrict__ dk,
                 T* __restrict__ dv, Strides s, int groups, int hkv, int tk,
                 int d, long long rows, float scale) {
  const long long n4 = rows * (d / 4);  // float4s of dK (or dV)
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= 2 * n4) return;
  const int which = i >= n4;  // 0: dK, 1: dV
  const long long e = i - which * n4, row = e / (d / 4);
  const int c = (int)(e % (d / 4)) * 4;
  const float4* src =
      reinterpret_cast<const float4*>(part + which * groups * rows * d) + e;
  float4 acc = src[0];
  for (int g = 1; g < groups; ++g) {
    const float4 x = src[g * n4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mul = which ? 1.f : scale;
  acc.x *= mul;
  acc.y *= mul;
  acc.z *= mul;
  acc.w *= mul;
  const int key = (int)(row % tk);
  const long long bh = row / tk;
  const int hk = (int)(bh % hkv), b = (int)(bh / hkv);
  T* dst = which ? dv + b * s.dv_b + hk * s.dv_h + key * s.dv_s
                 : dk + b * s.dk_b + hk * s.dk_h + key * s.dk_s;
  store4(dst + c, acc);
}

// Adds the partial sums (groups > 1) into dk and dv.
template <typename T>
int launch_sum(const float* part, void* dk, void* dv, const Strides& s,
               int groups, int b, int hkv, int tk, int d, float scale,
               cudaStream_t stream) {
  const long long rows = (long long)b * hkv * tk;
  const long long blocks = (2 * rows * (d / 4) + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_dkdv_sum<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      part, (T*)dk, (T*)dv, s, groups, hkv, tk, d, rows, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, float* part, int groups, const Strides& s,
           int b, int hq, int hkv, int tq, int tk, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const long long rows = (long long)b * hq * tq;
  const long long dblocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (dblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_delta<<<(unsigned)dblocks, THREADS, 0, stream>>>(
      (const float*)o, (const float*)dout, delta, s, hq, tq, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kern = bwd_fused<D>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int kv_tiles = (tk + C::BK - 1) / C::BK;
  const int q_tiles = (tq + C::BQ - 1) / C::BQ;
  const long long blocks =
      (long long)kv_tiles * hkv * groups * b + (long long)q_tiles * hq * b;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, C::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, (float*)dk, (float*)dv, part, s, b, hq, hkv,
      tq, tk, causal, window, scale, groups, kv_tiles, q_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess || groups == 1) return (int)e;
  return launch_sum<float>(part, dk, dv, s, groups, b, hkv, tk, D, scale,
                           stream);
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
  // D 256 runs bwd_dkdv_wgmma_pair: 64 keys x 256 columns of both dK and
  // dV would be 256 float32 registers a thread, so both warpgroups take
  // the same 64 keys, one computes S^T and the other dP^T, the two
  // fragments cross through shared memory (KV_XCH: two tiles' worth), and
  // each holds one of dK and dV.
  static constexpr bool PAIR = D > 128;
  // dK/dV: a block a (key tile of BKV, KV head, batch), 64 keys a
  // warpgroup (the same 64 under PAIR); Q and dO tiles of BQ rows (with
  // their lse and delta) stream through the ring.  At D 256, K and V
  // take 64 KB, a stage of Q and dO 32 KB and the exchange 32 KB.
  static constexpr int BKV = PAIR ? 64 : 128, BQ = PAIR ? 32 : 64;
  static constexpr int KV_STAGES = 4;
  static constexpr int KV_BYTES = BKV * DP * 2;  // K or V
  static constexpr int QT_BYTES = BQ * DP * 2;   // a streamed Q or dO tile
  static constexpr int KV_RING = 2 * KV_BYTES;   // stage s: Q, then dO
  static constexpr int KV_ROWS =
      KV_RING + KV_STAGES * 2 * QT_BYTES;        // lse, delta
  static constexpr int KV_XCH = KV_ROWS + KV_STAGES * 2 * BQ * 4;
  static constexpr int KV_BAR = KV_XCH + (PAIR ? 2 * 2 * 64 * BQ * 4 : 0);
  static constexpr int KV_SMEM = KV_BAR + KV_STAGES * 2 * 8 + 1024;
  // dQ: a block a (query tile of BQ_DQ, head, batch), 64 rows a
  // warpgroup; K and V tiles of BK keys stream through the ring (at D 256
  // Q and dO take 128 KB, so 3 stages of 32 keys, as the forward's tile).
  static constexpr int BQ_DQ = 128, BK = PAIR ? 32 : 64;
  static constexpr int DQ_STAGES = PAIR ? 3 : 4;
  static constexpr int Q_BYTES = BQ_DQ * DP * 2;  // Q or dO
  static constexpr int KT_BYTES = BK * DP * 2;    // a streamed K or V tile
  static constexpr int DQ_RING = 2 * Q_BYTES;     // stage s: K, then V
  static constexpr int DQ_BAR = DQ_RING + DQ_STAGES * 2 * KT_BYTES;
  static constexpr int DQ_SMEM = DQ_BAR + DQ_STAGES * 2 * 8 + 1024;
  static_assert(KV_SMEM <= 232448 && DQ_SMEM <= 232448, "shared memory");
};

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

// dK and dV of one key tile of one KV head at D <= 128, on the transposed
// scores: a warpgroup's 64 keys are the M rows of S^T = K Q^T and dP^T = V dO^T
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
  static_assert(!C::PAIR, "D 256 runs bwd_dkdv_wgmma_pair");
  constexpr int DP = C::DP, BKV = C::BKV, BQ = C::BQ;
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

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  // the warpgroup's keys (rows of the K and V tiles)
  const int key0 = 64 * wgi;
  const uint32_t kw = sK + key0 * ROW_BYTES;
  const uint32_t vw = sV + key0 * ROW_BYTES;
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
    pv_issue<DP, BQ>(dva, pp, sdo);  // dV += bf16(P^T) dO
    pv_issue<DP, BQ>(dka, pds, sq);  // dK += bf16(dS^T) Q
    wgmma_wait<0>();
    fence_regs(pp);
    fence_regs(pds);
    fence_regs<DP / 2>(dva);
    fence_regs<DP / 2>(dka);
    mbar_arrive(empty + 8 * (j % S));
  }

  // Epilogue: dK scale and dV in bf16, staged through the K and V tiles.
  cp_async_wait_all();  // K/V's copies, when no query tile sees the keys
  __syncthreads();
  const int r_local = key0 + 16 * warp + (lane >> 2);
  stage_acc<BKV, DP>(smem, dka, scale, r_local, c_q);
  stage_acc<BKV, DP>(smem + C::KV_BYTES, dva, 1.f, r_local, c_q);
  __syncthreads();
  store_tile<BKV, D, THREADS>(dk + b * s.dk_b + hk * s.dk_h, s.dk_s, smem,
                             k0, tk, tid);
  store_tile<BKV, D, THREADS>(dv + b * s.dv_b + hk * s.dv_h, s.dv_s,
                             smem + C::KV_BYTES, k0, tk, tid);
}

// qk_issue with the k-steps alternating between two accumulators, s0 and
// s1 (two independent wgmma chains); s = s0 + s1 after the group's wait.
template <int DP, int QROWS, int BK>
__device__ __forceinline__ void qk_issue2(float (&s0)[BK / 2],
                                          float (&s1)[BK / 2], uint32_t qw,
                                          uint32_t sk) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s0[i] = s1[i] = 0.f;
  fence_regs<BK / 2>(s0);
  fence_regs<BK / 2>(s1);
  wgmma_fence();
  const uint64_t da0 = desc_sw128(qw, 16, 1024);
  const uint64_t db0 = desc_sw128(sk, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int step = (kk & 3) * 32;
    const uint64_t da = da0 + (((kk >> 2) * QROWS * ROW_BYTES + step) >> 4);
    const uint64_t db = db0 + (((kk >> 2) * BK * ROW_BYTES + step) >> 4);
    static_assert(BK == 32, "the pair's m64n32 products");
    wgmma_ss_n32(kk & 1 ? s1 : s0, da, db);
  }
  wgmma_commit();
}

// dK and dV of one key tile of 64 at D 256 (recurrentgemma-9b: MQA at
// batch 1 with a window), for one group of the KV head's query heads.
// Both warpgroups take the same 64 keys and split the products, not D:
// warpgroup 0 issues S^T = K Q^T and warpgroup 1 dP^T = V dO^T (ss wgmma
// m64n32, the operands picked by the warpgroup index, so both run one
// instruction stream and no wgmma wait sits in divergent code), the two
// float32 fragments cross through shared memory behind a named barrier
// (thread t of either warpgroup holds the same elements), and each forms
// P^T and dS^T = P^T (dP^T - delta); warpgroup 0 then accumulates dV +=
// bf16(P^T) dO and warpgroup 1 dK += bf16(dS^T) Q over all 256 columns
// (rs wgmma, 128 float32 registers a thread).  So every product runs
// once: 8 D flops a visible pair.  Tile j's S^T / dP^T is issued with
// tile j - 1's rs product, and the exchange and softmax of tile j overlap
// the latter (tile 0 issues one of A = 0); the 16 narrow k-steps of S^T /
// dP^T alternate between two accumulators, two chains in place of one.
// Q and dO tiles of 32 rows stream through a ring of 4 stages.  groups 1 stores dK scale and dV in
// bf16; more write float32 partial sums to part, which bwd::bwd_dkdv_sum
// adds in group order.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_dkdv_wgmma_pair(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ part, bwd::Strides s, int hq,
                        int hkv, int tq, int tk, int causal, int window,
                        float scale, float scale_log2, int groups) {
  using C = Cfg<D>;
  static_assert(C::PAIR, "the D 256 tiles");
  constexpr int DP = C::DP, BKV = C::BKV, BQ = C::BQ, S = C::KV_STAGES;
  constexpr int NS = BQ / 2;  // S^T (or dP^T) registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const float* rows_f = reinterpret_cast<const float*>(smem + C::KV_ROWS);
  float4* xch = reinterpret_cast<float4*>(smem + C::KV_XCH);
  const uint32_t full = sK + C::KV_BAR, empty = full + 8 * S;

  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, tw = tid & 127;
  const int hk = blockIdx.x / groups, g = blockIdx.x % groups;
  const int b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int rep = hq / hkv, hpg = rep / groups, off = tk - tq;

  if (tid == 0)
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, THREADS);
      mbar_init(empty + 8 * i, THREADS);
    }
  fence_async_smem();
  __syncthreads();

  load_tile<BKV, D, THREADS>(sK, k + b * s.k_b + hk * s.k_h, s.k_s, k0, tk,
                             tid);
  load_tile<BKV, D, THREADS>(sK + C::KV_BYTES, v + b * s.v_b + hk * s.v_h,
                             s.v_s, k0, tk, tid);

  // Query rows that see a key of the tile: qpos >= k0 (causal) and
  // qpos < last key + window; every head of the group walks them.
  const int klast = min(k0 + BKV, tk) - 1;
  const int qbeg = causal ? max(0, k0 - off) / BQ * BQ : 0;
  const int qend = window > 0 ? min(tq, klast + window - off) : tq;
  const int nq = qend > qbeg ? (qend - qbeg + BQ - 1) / BQ : 0;
  const int n = hpg * nq;

  auto stage = [&](int j) {
    return sK + C::KV_RING + (j % S) * 2 * C::QT_BYTES;
  };
  auto load_q = [&](int j) {  // tile j into its stage; arrives on full
    if (j < n) {
      if (j >= S)  // the stage's previous tile, j - S, is done everywhere
        mbar_wait(empty + 8 * (j % S), ((j - S) / S) & 1);
      const int hi = j / nq, q0 = qbeg + (j - hi * nq) * BQ;
      const int h = hk * rep + g * hpg + hi;
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

  // The operands, by warpgroup: S^T from K and Q, or dP^T from V and dO;
  // then dV from dO, or dK from Q (a stage holds Q, then dO).
  const uint32_t xa = sK + wgi * C::KV_BYTES;
  const uint32_t xb = wgi * C::QT_BYTES;
  const uint32_t rb = (1 - wgi) * C::QT_BYTES;
  const int r_k = k0 + 16 * warp + (lane >> 2);  // the thread's first key
  const int c_q = 2 * (lane & 3);                // and first column
  float acc[DP / 2];  // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  uint32_t a[BQ / 16][4] = {};  // tile j - 1's A fragments; 0 before tile 0

  for (int j = 0; j < n; ++j) {
    mbar_wait(full + 8 * (j % S), (j / S) & 1);  // tile j (and K/V) landed
    fence_async_smem();
    load_q(j + S - 2);
    const int hi = j / nq, q0 = qbeg + (j - hi * nq) * BQ;
    const float* lrow = rows_f + (j % S) * 2 * BQ;
    const float* drow = lrow + BQ;

    float x[NS], x1[NS];
    qk_issue2<DP, BKV, BQ>(x, x1, xa, stage(j) + xb);  // S^T or dP^T
    pv_issue<DP, BQ>(acc, a, stage(j > 0 ? j - 1 : 0) + rb);
    wgmma_wait<1>();
    fence_regs<NS>(x);
    fence_regs<NS>(x1);
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] += x1[i];

    // the other warpgroup's fragment, through a buffer of tile parity
    float4* mine = xch + ((j & 1) * 2 + wgi) * (NS / 4) * 128 + tw;
    const float4* other = xch + ((j & 1) * 2 + 1 - wgi) * (NS / 4) * 128 + tw;
#pragma unroll
    for (int i = 0; i < NS / 4; ++i)
      mine[i * 128] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    bar1_sync<THREADS>();  // both warpgroups' fragments are in
    float y[NS];
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
      const float4 f = other[i * 128];
      y[4 * i] = f.x;
      y[4 * i + 1] = f.y;
      y[4 * i + 2] = f.z;
      y[4 * i + 3] = f.w;
    }

    // P^T = 2^(S^T scale log2 e - lse log2 e); masked elements are 0 by a
    // select (a row that sees no key has lse = -inf); dS^T = P^T (dP^T -
    // delta).  Warpgroup 0 keeps P^T, warpgroup 1 dS^T.
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
    float f[NS];
#pragma unroll
    for (int gi = 0; gi < NS / 4; ++gi) {
      const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * gi + c_q);
      const float2 d2 = *reinterpret_cast<const float2*>(drow + 8 * gi + c_q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * gi + e, r = (e >> 1) & 1, c = frag_col(i);
        const float st = wgi ? y[i] : x[i], dpt = wgi ? x[i] : y[i];
        const float l = (e & 1) ? l2.y : l2.x;
        const float p0 = exp2_approx(fmaf(st, scale_log2, -l * LOG2E));
        const float p = !need_mask || (c >= lo[r] && c <= hi_[r]) ? p0 : 0.f;
        const float ds = p * (dpt - ((e & 1) ? d2.y : d2.x));
        f[i] = wgi ? ds : p;
      }
    }
    wgmma_wait<0>();  // tile j - 1's rs product: a and its stage are free
    fence_regs(a);
    fence_regs<DP / 2>(acc);
    if (j > 0) mbar_arrive(empty + 8 * ((j - 1) % S));
    pack_p<BQ>(f, a);
  }
  if (n > 0) {  // the last tile's rs product (its stage is never refilled)
    pv_issue<DP, BQ>(acc, a, stage(n - 1) + rb);
    wgmma_wait<0>();
    fence_regs(a);
    fence_regs<DP / 2>(acc);
  }

  cp_async_wait_all();  // K/V's copies, when no query tile sees the keys
  __syncthreads();
  const int r_local = 16 * warp + (lane >> 2);
  if (groups == 1) {
    // dK scale and dV in bf16, staged through the K and V tiles
    stage_acc<BKV, DP>(smem + (1 - wgi) * C::KV_BYTES, acc,
                       wgi ? scale : 1.f, r_local, c_q);
    __syncthreads();
    store_tile<BKV, D, THREADS>(dk + b * s.dk_b + hk * s.dk_h, s.dk_s, smem,
                               k0, tk, tid);
    store_tile<BKV, D, THREADS>(dv + b * s.dv_b + hk * s.dv_h, s.dv_s,
                               smem + C::KV_BYTES, k0, tk, tid);
  } else {
    float* out = part + (((long long)(1 - wgi) * groups + g) * gridDim.y * hkv +
                         (long long)b * hkv + hk) * tk * D;
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int key = k0 + r_local + frag_row(i);
      if (key < tk)
        *reinterpret_cast<float2*>(out + (long long)key * D + frag_col(i) +
                                   c_q) = make_float2(acc[i], acc[i + 1]);
    }
  }
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
// 256 they run at depth 32, with the same descriptors per k-step).
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
           void* dk, void* dv, float* part, int groups,
           const bwd::Strides& s, int b, int hq, int hkv, int tq, int tk,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr int RPB = THREADS / (D / 8);  // delta rows a block
  const long long rows = (long long)b * hq * tq;
  const long long dblocks = (rows + RPB - 1) / RPB;
  const int kv_tiles = (tk + C::BKV - 1) / C::BKV;
  const int q_tiles = (tq + C::BQ_DQ - 1) / C::BQ_DQ;
  if (dblocks > 0x7fffffffLL || kv_tiles > 65535 || q_tiles > 65535 ||
      (long long)hkv * groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  bwd_delta_vec<D><<<(unsigned)dblocks, THREADS, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, delta, s, hq, tq, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto q_kern = bwd_dq_wgmma<D>;
  e = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * LOG2E;
  if constexpr (C::PAIR) {
    auto kv_kern = bwd_dkdv_wgmma_pair<D>;
    e = cudaFuncSetAttribute(
        kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::KV_SMEM);
    if (e != cudaSuccess) return (int)e;
    kv_kern<<<dim3(hkv * groups, b, kv_tiles), THREADS, C::KV_SMEM,
              stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                        (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv,
                        part, s, hq, hkv, tq, tk, causal, window, scale,
                        scale_log2, groups);
  } else {
    if (groups != 1) return (int)cudaErrorInvalidValue;
    auto kv_kern = bwd_dkdv_wgmma<D>;
    e = cudaFuncSetAttribute(
        kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::KV_SMEM);
    if (e != cudaSuccess) return (int)e;
    kv_kern<<<dim3(hkv, b, kv_tiles), THREADS, C::KV_SMEM, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        lse, delta, (bf16*)dk, (bf16*)dv, s, hq, hkv, tq, tk, causal, window,
        scale, scale_log2);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (groups > 1) {
    const int rc = bwd::launch_sum<bf16>(part, dk, dv, s, groups, b, hkv, tk,
                                         D, scale, stream);
    if (rc != 0) return rc;
  }
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
struct BwdSmem {
  template <int D>
  static int run(int dtype, int which) {
    if (dtype == 0) return which ? bwd::Cfg<D>::DQ_SMEM : bwd::Cfg<D>::KV_SMEM;
    return which ? wgb::Cfg<D>::DQ_SMEM : wgb::Cfg<D>::KV_SMEM;
  }
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
// delta: float32 (B, Hq, Tq) scratch.  Head dims 16-256.  groups: the dK/dV
// kernel splits each KV head's Hq / Hkv query heads into that many groups,
// a block each (it must divide Hq / Hkv; bfloat16 at D <= 128 takes 1), and
// part, float32 scratch of 2 x groups x B x Hkv x Tk x D (null for 1),
// holds their partial sums.  Every row starts 16-byte aligned (the eight
// pointers and the 24 strides): the kernels copy with 16-byte cp.async.
extern "C" int flash_attention_bwd(int dtype, int d, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, float* part,
                                   int groups, const long long* strides,
                                   int b, int hq, int hkv, int tq, int tk,
                                   int causal, int window, float scale,
                                   void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b > 65535 || hq > 65535 || groups < 1 ||
      (hq / hkv) % groups != 0 || (groups > 1 && part == nullptr) ||
      (dtype == 1 && d <= 128 && groups != 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  static_assert(sizeof(bwd::Strides) == 24 * sizeof(long long), "strides");
  const int vec = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  for (int i = 0; i < 24; ++i)
    if (strides[i] % vec != 0) return (int)cudaErrorMisalignedAddress;
  const void* ptrs[9] = {q, k, v, o, dout, dq, dk, dv, part};
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  if (any % 16 != 0) return (int)cudaErrorMisalignedAddress;
  bwd::Strides st;
  memcpy(&st, strides, sizeof st);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<BwdLaunch>(d, q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 part, groups, st, b, hq, hkv, tq, tk, causal,
                                 window, scale, s);
  return dispatch_d<BwdWgmmaLaunch>(d, q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, part, groups, st, b, hq, hkv, tq, tk,
                                    causal, window, scale, s);
}

// Shared memory a block of the backward's dK/dV kernel (which 0) or dQ
// kernel (which 1) takes at head dim d, dtype 0 float32 or 1 bfloat16.
extern "C" int flash_attention_bwd_smem(int dtype, int d, int which) {
  return dispatch_d<BwdSmem>(d, dtype, which);
}

// The bf16 backward's rs product on one tile (card tests): out = bf16(a)
// b in float32, a (64, 64) float32 and b (64, d) bf16, both contiguous;
// head dims 16-256.
extern "C" int flash_attention_bwd_tile_products(int d, const void* a,
                                                 const void* b, void* out,
                                                 void* stream) {
  return dispatch_d<BwdTileLaunch>(d, a, b, out, (cudaStream_t)stream);
}
