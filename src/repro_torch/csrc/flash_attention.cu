// Blockwise fused attention (forward) for Hopper (sm_90a): two kernels.
//
// Port of the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:103, body _flash_kernel :31):
// online-softmax attention with GQA, causal and sliding-window masks,
// fully masked kv blocks skipped, the logit softcap fused and an explicit
// scale.  It computes what the TPU kernel computes; it is not carried
// over block by block.
//
// Layout.  q [b, t, h, d], k/v [b, s, kv, d] and out [b, t, h, d] are
// read and written in place (no transposes).  The g = h / kv query heads
// of one kv head are folded into query rows position-major, as in the
// TPU kernel: row R = pos * g + group.  One CTA takes consecutive rows
// of one (batch, kv head), so all g heads share each K/V tile, and
// walks the kv tiles in order, keeping float32 m / l / acc per row in
// registers.  Masks compare positions (R / g), not rows.
// A tile that no row of the CTA can see (all future under the causal
// mask, or entirely behind the window of the CTA's first position) is
// skipped; a skipped tile would only have added exact zeros.
//
// Semantics kept from the TPU kernel, each a place where a different
// answer hides: logits are dot * scale, then tanh(x / cap) * cap, then
// the mask; masked logits are NEG_INF = -1e30, not -inf; corr is frozen
// at 1 while m_prev == NEG_INF and the exponentials are multiplied by the
// mask, so a row with nothing valid yet gains no phantom mass; K/V rows
// past seq_k read as zero (no 0 * inf); the result is acc / max(l, 1e-30)
// in q's dtype.
//
// Two routes, chosen by the wrapper (kernels/flash_attention.py::_route)
// from q's dtype and head_dim, both computing the above:
//
// * Tensor cores (fa_flash_attention_tc): bfloat16 at d in {64, 128,
//   256}: every bf16 call of the served prefills (gemma2, deepseek,
//   mixtral, internvl2 at d 128; whisper at 64; recurrentgemma at 256).
//   Bound on this card: operations (4 * visible pairs * h * d flops at
//   989 TFLOP/s; at the serve cell also the SFU: one ex2 and, with a
//   softcap, one tanh per visible logit at 16 a clock per SM).
//   Common to both kernels: a CTA of 384 threads -- a producer warpgroup
//   and two consumer warpgroups of 64 folded rows each (one wgmma M) --
//   takes TC_BM = 128 rows of one (batch, kv head).  Q sits in
//   128-byte-swizzled shared memory; K and V tiles of BK keys (bk_of: 128
//   at d 64 / 128, 64 at d 256) stream through a 2-stage ring filled by
//   TMA (4-D maps (d, kv, s, b), box (64, 1, BK, 1), 128-byte swizzle;
//   rows past s arrive as zeros) with full/empty mbarriers.  S = Q K^T is
//   wgmma m64nBKk16 from shared memory; scale, softcap (tanh.approx.f32)
//   and masks act on the float32 accumulator fragments, in log2 units so
//   the softmax is one ex2.approx a logit; row max / sum over the 4 lanes
//   of a row.  P is rounded to bf16 in registers (as the plain version
//   rounds the weights to q's dtype) and is wgmma's A operand for O += P
//   V (m64n{d}k16), V read MN-major (the transpose bit).  tanh.approx has
//   a relative error of about 2^-11; the error it adds is measured by
//   chip_smoke at caps 2, 5 and 50 against the 2e-2 bound.
//   - d 64 and 256 (flash_tc_kernel): one CTA a q block, heavy causal
//     blocks first; each consumer runs S, softmax and P V of a tile in
//     series.  Registers set the tile: a consumer thread holds S (BK / 2
//     floats), O (d / 2) and P (BK / 4 pairs), so d 256 takes 64-key
//     tiles (32 + 128 + 16) and setmaxnreg gives the consumers 240 and
//     the producer 24 (232 / 40 at d 64).
//   - d 128 (flash_tc128_kernel), the served width where the serial walk
//     lost to SDPA: the softmax runs beside the products.  A consumer
//     issues S of tile i and P V of tile i - 1 together and runs the
//     softmax of S_i while P_{i-1} V_{i-1} is in flight (S 64 + P 32 + O
//     64 floats a thread, setmaxnreg 240 / 24); the two consumers take
//     turns to issue (named barriers 3 and 4), so one's softmax runs
//     beside the other's products.  The grid is persistent, one CTA an
//     SM, each walking a fixed list of (q block, batch x kv head) items,
//     heaviest first in a snake over rounds (item_of), as one stream of
//     tiles: the first S of an item is issued beside the last P V of the
//     item before, and each item's Q rows load by cp.async one item ahead
//     into a second Q buffer (197,696 B of shared memory).  Every float
//     operation of a row is flash_tc_kernel's at d 128, in its order, so
//     the output is that kernel's bit for bit.  What holds it back on the
//     card (PERF.md): a wgmma issue waits for the tensor cores, so a
//     consumer's period is its own S, its softmax and the P pack, and the
//     softmax (64 ex2 a thread a tile at 16 a clock per SM) is longer than
//     the other consumer's products.
//
// * CUDA cores (fa_flash_attention): float32 at any d (one-pass TF32
//   wgmma would break the 3e-5 float32 bound; the 3xTF32 split would
//   triple the operand tiles and leave no room for a ring) and bfloat16
//   at d outside {64, 128, 256} (the smoke configs' 8-16, the edge
//   shapes' 32); it still takes bf16 at any d when called directly, and
//   chip_smoke times it at recurrentgemma's d 256 beside the tensor-core
//   route.  Bound on this card: float32 operations,
//   4 * visible pairs * h * d flops at 67 TFLOP/s (128 FMA lanes an SM);
//   the bytes are 6-7x below that at serve_f32's prefill.  So the design
//   keeps the FMA pipe fed and spends few other instructions:
//   - One CTA of NT = 256 threads takes BR folded rows (128, or 64 at
//     d 256) and keeps them for the whole walk: Q, a ring of RING = 3
//     K/V slots of BK keys and the P tile live in shared memory as
//     float32 rows padded by 4 floats (an odd count of 16-byte chunks a
//     row, so the 16-byte loads of consecutive rows hit distinct banks).
//     The ring holds K_j, V_j and the next tile's K or V: K_{j+1} is
//     issued before S_j = Q K_j^T is computed, V_{j+1} into K_j's slot
//     before O += P V_j, each with 16-byte cp.async.cg (float32 at d % 4
//     == 0; rows past s zero-filled) one commit group apart, so loads
//     overlap both products.  bfloat16 (and ragged float32) tiles take
//     the same slots through registers, converted to float32 on the way.
//   - Both products are register tiled, with operands read as float4
//     along the contiguous dimension (no transposed copies): a thread
//     holds TR rows x TK keys of S (rows rg + RG*i, keys kg + KG*j) and
//     TR rows x TC columns of O (16-byte chunks kg + KG*jc).  A warp's
//     load touches at most 8 distinct 16-byte chunks of Q, K or P rows
//     (4 rows x 8 keys of S at d 128) or 128 contiguous bytes of a V row,
//     so it is one bank wavefront, against 128 FMAs a d-chunk in S and
//     256 a key-quad in O.  Every multiply-add is an explicit fmaf (the
//     build's -fmad=false would split a*b + c in two).
//   - One block of 8 warps an SM at d 128 (203,776 B of shared memory,
//     TR*TK + TR*TC = 96 accumulators a thread), 1-2 at the narrower
//     buckets; the ring, not a second block, hides the loads (two blocks
//     of half the rows measured slower: their smaller register tiles
//     cost more than the extra warps hide).  What is left is latency:
//     at 8 warps the products wait on their shared loads, and the
//     softmax phase (tanhf, exp2f) runs between the barriers, not beside
//     the products (PERF.md).
//   - Per logit: one multiply by scale / cap (a reciprocal formed on the
//     host, no division), the softcap's tanhf (libdevice, about 2 ulp; on
//     the card it measured faster than an exp2f-and-fast-divide form and
//     half its error), one multiply by cap * log2 e, and the softmax in
//     log2 units with exp2f.  Masks are evaluated only in tiles that
//     cross the diagonal, the window's edge or s.
//   - Heavy causal q blocks launch first, as on the tensor-core route.
//   Head dims are bucketed (Tile<DB>, DB = 16, 32, 64, 128, 256); a
//   ragged d is zero-padded in shared memory to its bucket.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 256;           // threads a CTA
constexpr int RING = 3;           // K/V slots: K_j, V_j, the next K or V
constexpr float NEG_INF = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Tile shape of a head-dim bucket DB: a thread owns TR rows x TK keys of
// the logit tile and TR rows x TC columns of the output; KG threads (one
// row group, adjacent lanes) share a row.  So BR = NT / KG * TR rows a
// CTA, BK = KG * TK keys a tile, and DB = KG * TC.
template <int DB> struct Tile;
template <> struct Tile<16> {
  static constexpr int TR = 2, TK = 8, TC = 4, KG = 4;
};
template <> struct Tile<32> {
  static constexpr int TR = 4, TK = 8, TC = 4, KG = 8;
};
template <> struct Tile<64> {
  static constexpr int TR = 4, TK = 8, TC = 8, KG = 8;
};
template <> struct Tile<128> {
  static constexpr int TR = 4, TK = 8, TC = 16, KG = 8;
};
template <> struct Tile<256> {
  static constexpr int TR = 4, TK = 2, TC = 16, KG = 16;
};

template <int DB> struct Geo {
  static constexpr int KG = Tile<DB>::KG, RG = NT / KG;
  static constexpr int BR = RG * Tile<DB>::TR, BK = KG * Tile<DB>::TK;
  static constexpr int QS = DB + 4, PS = BK + 4;   // padded row strides
  // dynamic shared memory in floats: Q, the K/V ring, P
  static constexpr int SMEM_FLOATS = BR * QS + RING * BK * QS + BR * PS;
  static_assert(KG * Tile<DB>::TC == DB && Tile<DB>::TC % 4 == 0, "bucket");
  static_assert(RG * KG == NT && 32 % KG == 0, "row groups");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One 16-byte chunk (4 floats) of a shared row from the n <= 4 elements
// at src (zeros where !valid or past n).  float32 whole chunks (vec) go
// by cp.async, the rest through registers.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       const float* base, bool valid, int n,
                                       bool vec) {
  if (vec) {
    cp_async16(dst, valid ? src : base, valid);
    return;
  }
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (valid) {
    x.x = src[0];
    if (n > 1) x.y = src[1];
    if (n > 2) x.z = src[2];
    if (n > 3) x.w = src[3];
  }
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src,
                                       const __nv_bfloat16*, bool valid,
                                       int n, bool vec) {
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (valid && vec) {              // 4 bf16 = one 8-byte load
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x = make_float4(a.x, a.y, b.x, b.y);
  } else if (valid) {
    x.x = to_f(src[0]);
    if (n > 1) x.y = to_f(src[1]);
    if (n > 2) x.z = to_f(src[2]);
    if (n > 3) x.w = to_f(src[3]);
  }
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void store4(float* dst, float4 x, int n,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = x;
    return;
  }
  dst[0] = x.x;
  if (n > 1) dst[1] = x.y;
  if (n > 2) dst[2] = x.z;
  if (n > 3) dst[3] = x.w;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x, int n,
                                       bool) {
  dst[0] = __float2bfloat16_rn(x.x);
  if (n > 1) dst[1] = __float2bfloat16_rn(x.y);
  if (n > 2) dst[2] = __float2bfloat16_rn(x.z);
  if (n > 3) dst[3] = __float2bfloat16_rn(x.w);
}

__device__ __forceinline__ float comp(float4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// qk_mul = scale / cap with a softcap (y = dot * qk_mul, logit2 =
// tanh(y) * cap2, cap2 = cap * log2 e), else scale * log2 e (logit2 =
// dot * qk_mul, cap2 = 0): logits in log2 units.
template <typename T, int DB>
__global__ void __launch_bounds__(NT, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int t, int s,
             int h, int kv, int d, int causal, int window, float qk_mul,
             float cap2) {
  using G = Geo<DB>;
  constexpr int TR = Tile<DB>::TR, TK = Tile<DB>::TK;
  constexpr int TC4 = Tile<DB>::TC / 4, DB4 = DB / 4;
  constexpr int KG = G::KG, RG = G::RG, BR = G::BR, BK = G::BK;
  constexpr int QS = G::QS, PS = G::PS;
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);   // [BR][QS]
  float* const ring = Qs + BR * QS;                     // [RING][BK][QS]
  float* const Ps = ring + RING * BK * QS;              // [BR][PS]

  const int tid = threadIdx.x, kg = tid % KG, rg = tid / KG;
  const int g = h / kv;
  const int bb = blockIdx.y / kv, kh = blockIdx.y % kv;
  const long long nrows = (long long)t * g;
  // the heaviest q blocks (last positions, most keys) launch first
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * BR;
  const long long rlast = (r0 + BR < nrows ? r0 + BR : nrows) - 1;
  const long long qfirst = r0 / g, qlast = rlast / g;
  const int nc = (d + 3) / 4;         // chunks of a row that hold data
  const bool vec = d % 4 == 0;        // whole chunks: vector loads
  // kv tiles [jlo, jhi): stop at the first all-future tile, skip the
  // tiles entirely behind the window of the first position
  const int ntiles = (s + BK - 1) / BK;
  int jhi = ntiles;
  if (causal && qlast / BK + 1 < jhi) jhi = (int)(qlast / BK + 1);
  int jlo = 0;
  if (window >= 0) {
    const long long x = qfirst - window - BK + 1;
    if (x >= 0) jlo = (int)(x / BK + 1);
  }

  // zeros: the pad columns past d (never written again) and rows past s
  for (int i = tid; i < G::SMEM_FLOATS / 4; i += NT)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  // a thread stages chunk tid % DB4 of every (NT / DB4)-th row of a tile
  auto stage_kv = [&](const T* src, int j, int slot) {
    const int c = tid % DB4;
    if (c >= nc) return;
    const long long k0 = (long long)j * BK;
    const long long step = (long long)(NT / DB4) * kv * d;
    const T* p = src + ((bb * (long long)s + k0 + tid / DB4) * kv + kh) * d
                 + 4 * c;
    float* dst = ring + slot * BK * QS + 4 * c;
    for (int kk = tid / DB4; kk < BK; kk += NT / DB4, p += step)
      stage4(dst + kk * QS, p, src, k0 + kk < s, d - 4 * c, vec);
  };

  if (jlo < jhi) {
    for (int i = tid; i < BR * DB4; i += NT) {
      const int r = i / DB4, c = i % DB4;
      if (c >= nc) continue;
      const long long R = r0 + r;
      const long long pos = R / g;
      const int gi = (int)(R - pos * g);
      stage4(Qs + r * QS + 4 * c,
             q + (((bb * (long long)t + pos) * h + kh * g + gi) * d + 4 * c),
             q, R < nrows, d - 4 * c, vec);
    }
    stage_kv(k, jlo, 0);
    cp_async_commit();                  // group: Q + K_jlo
    stage_kv(v, jlo, 1);
    cp_async_commit();                  // group: V_jlo
  }

  int qpos[TR];
  float m[TR], l[TR];
  float4 o[TR][TC4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    qpos[i] = (int)((r0 + rg + RG * i) / g);
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TC4; ++c) o[i][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float4* const Q4 = reinterpret_cast<const float4*>(Qs);
  const float4* const P4 = reinterpret_cast<const float4*>(Ps);

  for (int j = jlo, it = 0; j < jhi; ++j, ++it) {
    const int slot_k = (2 * it) % RING, slot_v = (2 * it + 1) % RING;
    // K_j has landed (V_j may be in flight); every thread is past the
    // previous tile's P V, so V_{j-1}'s slot and P are free
    cp_async_wait<1>();
    __syncthreads();
    if (j + 1 < jhi) stage_kv(k, j + 1, (2 * it + 2) % RING);
    cp_async_commit();                  // group: K_{j+1} (maybe empty)

    // S = Q K_j^T over float4 chunks of the head dim
    const float4* const K4 =
        reinterpret_cast<const float4*>(ring + slot_k * BK * QS);
    float sc[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int jj = 0; jj < TK; ++jj) sc[i][jj] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      float4 a[TR], b[TK];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = Q4[(rg + RG * i) * (QS / 4) + c];
#pragma unroll
      for (int jj = 0; jj < TK; ++jj)
        b[jj] = K4[(kg + KG * jj) * (QS / 4) + c];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int jj = 0; jj < TK; ++jj) {
          sc[i][jj] = fmaf(a[i].x, b[jj].x, sc[i][jj]);
          sc[i][jj] = fmaf(a[i].y, b[jj].y, sc[i][jj]);
          sc[i][jj] = fmaf(a[i].z, b[jj].z, sc[i][jj]);
          sc[i][jj] = fmaf(a[i].w, b[jj].w, sc[i][jj]);
        }
    }

    // scale, softcap and masks (only where the tile crosses the
    // diagonal, the window's edge or s), then the online softmax in log2
    // units; P to shared memory
    const long long k0 = (long long)j * BK;
    const bool full = k0 + BK <= s && (!causal || k0 + BK - 1 <= qfirst) &&
                      (window < 0 || k0 > qlast - window);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float rmax = NEG_INF;
      unsigned okm = 0;
#pragma unroll
      for (int jj = 0; jj < TK; ++jj) {
        float x = sc[i][jj] * qk_mul;
        if (cap2 > 0.0f) x = tanhf(x) * cap2;
        bool ok = true;
        if (!full) {
          const long long kpos = k0 + kg + KG * jj;
          ok = kpos < s && (!causal || kpos <= qpos[i]) &&
               (window < 0 || kpos > qpos[i] - window);
        }
        okm |= (unsigned)ok << jj;
        sc[i][jj] = ok ? x : NEG_INF;
        rmax = fmaxf(rmax, sc[i][jj]);
      }
#pragma unroll
      for (int off = KG / 2; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = m[i] == NEG_INF ? 1.0f : exp2f(m[i] - m_new);
      float rsum = 0.0f;
      float* const prow = Ps + (rg + RG * i) * PS + kg;
#pragma unroll
      for (int jj = 0; jj < TK; ++jj) {
        const float p = (okm >> jj) & 1u ? exp2f(sc[i][jj] - m_new) : 0.0f;
        prow[KG * jj] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = KG / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = fmaf(l[i], corr, rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TC4; ++c) {
        o[i][c].x *= corr;
        o[i][c].y *= corr;
        o[i][c].z *= corr;
        o[i][c].w *= corr;
      }
    }

    // V_j has landed (K_{j+1} may be in flight); P is complete and every
    // thread is past S, so K_j's slot takes V_{j+1}
    cp_async_wait<1>();
    __syncthreads();
    if (j + 1 < jhi) stage_kv(v, j + 1, slot_k);
    cp_async_commit();                  // group: V_{j+1} (maybe empty)

    // O += P V_j, four keys a step
    const float4* const V4 =
        reinterpret_cast<const float4*>(ring + slot_v * BK * QS);
#pragma unroll 4
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      float4 p[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) p[i] = P4[(rg + RG * i) * (PS / 4) + k4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4* const vrow = V4 + (4 * k4 + kk) * (QS / 4) + kg;
        float4 w[TC4];
#pragma unroll
        for (int c = 0; c < TC4; ++c) w[c] = vrow[KG * c];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float pk = comp(p[i], kk);
#pragma unroll
          for (int c = 0; c < TC4; ++c) fma4(o[i][c], pk, w[c]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const long long R = r0 + rg + RG * i;
    if (R >= nrows) continue;
    const long long pos = R / g;
    const int gi = (int)(R - pos * g);
    const float denom = fmaxf(l[i], 1e-30f);
    T* const orow = out + ((bb * (long long)t + pos) * h + kh * g + gi) * d;
#pragma unroll
    for (int c = 0; c < TC4; ++c) {
      const int ch = kg + KG * c;
      if (ch >= nc) continue;
      const float4 a = o[i][c];
      store4(orow + 4 * ch,
             make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom),
             d - 4 * ch, vec);
    }
  }
}

template <int DB>
constexpr long long bucket_smem_bytes() {
  return (long long)Geo<DB>::SMEM_FLOATS * (long long)sizeof(float);
}

// dynamic shared memory of the CUDA-core kernel at head dim d
long long cc_smem_bytes(int d) {
  return d <= 16 ? bucket_smem_bytes<16>() : d <= 32 ? bucket_smem_bytes<32>()
       : d <= 64 ? bucket_smem_bytes<64>()
       : d <= 128 ? bucket_smem_bytes<128>() : bucket_smem_bytes<256>();
}

template <typename T, int DB>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int t, int s, int h, int kv, int D, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  using G = Geo<DB>;
  const int bytes = (int)bucket_smem_bytes<DB>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const long long nrows = (long long)t * (h / kv);
  dim3 grid((unsigned)((nrows + G::BR - 1) / G::BR), (unsigned)(b * kv));
  const float qk_mul = softcap > 0.0f ? scale / softcap : scale * kLog2e;
  const float cap2 = softcap > 0.0f ? softcap * kLog2e : 0.0f;
  flash_kernel<T, DB><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, t, s, h, kv, D,
      causal, window, qk_mul, cap2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int t, int s, int h, int kv, int D, int causal, int window,
             float softcap, float scale, cudaStream_t st) {
  // the head-dim bucket: d zero-padded to DB in shared memory
  if (D <= 16)
    return launch<T, 16>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                         softcap, scale, st);
  if (D <= 32)
    return launch<T, 32>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                         softcap, scale, st);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                         softcap, scale, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                          softcap, scale, st);
  return launch<T, 256>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                        softcap, scale, st);
}

}  // namespace

// ===========================================================================
// Tensor-core route: bfloat16, d in {64, 128, 256}, wgmma + TMA ring
// ===========================================================================

namespace tc {

constexpr int TC_BM = 128;        // folded query rows per CTA (2 x 64)
constexpr int TC_BK = 128;        // keys per kv tile at d 64 and 128
constexpr int TC_BK_D256 = 64;    // keys per kv tile at d 256
constexpr int TC_STAGES = 2;      // depth of the K/V ring
constexpr int TC_ALIGN = 1024;    // slack to align the ring to the swizzle
constexpr int TC_THREADS = 384;   // producer warpgroup + 2 consumers
constexpr int ROW_BYTES = 128;    // one swizzled row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;     // NEG_INF, in log2 units here

// Keys per kv tile at head dim D.  At d 256 a consumer thread holds O as
// 128 float32 (wgmma m64n256), so S takes 64-key tiles (m64n64, 32
// registers) and P 16 bf16 pairs: 176 beside the addresses, inside the
// 240 that setmaxnreg gives.  At 128 keys S alone would take 64 more.
__host__ __device__ constexpr int bk_of(int D) {
  return D == 256 ? TC_BK_D256 : TC_BK;
}
// setmaxnreg's counts: two consumer warpgroups and the producer share
// the SM's 65,536 registers (2 * 128 * 240 + 128 * 24 = 64,512 at d 256)
__host__ __device__ constexpr int producer_regs(int D) {
  return D == 256 ? 24 : 40;
}
__host__ __device__ constexpr int consumer_regs(int D) {
  return D == 256 ? 240 : 232;
}

// Dynamic shared memory at head dim D: alignment slack, Q (TC_BM rows),
// TC_STAGES x (K tile + V tile) of bk_of(D) rows, and 3 mbarriers a
// stage.  At d 256: 1,024 + 65,536 + 2 * 2 * 32,768 + 48 = 197,680 B of
// the 232,448 a block may use, so a third stage (+65,536) does not fit.
__host__ __device__ constexpr int q_bytes(int D) { return TC_BM * D * 2; }
__host__ __device__ constexpr int tile_bytes(int D) { return bk_of(D) * D * 2; }
__host__ __device__ constexpr int smem_bytes(int D) {
  return TC_ALIGN + q_bytes(D) + TC_STAGES * 2 * tile_bytes(D)
         + TC_STAGES * 3 * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one TMA box (c0 = d offset, c1 = kv head, c2 = key, c3 = batch) into
// shared memory at dst; completion counted on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (B128) in bits
// 62-63.  K-major operands (Q, K): 8-row groups 1024 B apart (SBO), LBO
// unused.  MN-major V: SBO 1024 B between 8-key groups, LBO between the
// 64-column panels of d.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keep the compiler from moving accesses of wgmma's registers across
// the asynchronous start and wait of a wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0:64] (+)= A . B, A and B in shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] (+)= A . B, A and B in shared memory (both K-major): S at
// 64-key tiles (d 256)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:64] (+)= A . B, A (four bf16x2 registers a thread) from
// registers, B in shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[0:32] (+)= A . B, A (four bf16x2 registers a thread) from
// registers, B in shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


// d[0:128] (+)= A . B, A (four bf16x2 registers a thread) from
// registers, B in shared memory MN-major (the transpose bit): O += P V
// at d 256, the four 64-column panels of V LBO apart
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// S (+)= Q K^T over one 16-wide slice of d: a 128- or 64-key tile
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BK == 128) wgmma_ss_n128(s, da, db, accumulate);
  else wgmma_ss_n64(s, da, db, accumulate);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 256) wgmma_rs_n256(o, a, db, 1);
  else wgmma_rs_n64(o, a, db, 1);
}

// grid (q blocks, b * kv); block TC_THREADS; dynamic smem smem_bytes(D).
// qk_mul = scale / softcap (softcap > 0) or scale * log2(e); cap2 =
// softcap * log2(e) or 0: the logit in log2 units is cap2 * tanh(dot *
// qk_mul) or dot * qk_mul.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ out, int t, int s, int h, int kv,
                int causal, int window, float qk_mul, float cap2) {
  static_assert(D == 64 || D == 256,
                "tensor-core route: d 64 or 256 (d 128: flash_tc128_kernel)");
  constexpr int BK = bk_of(D);               // keys per kv tile
  constexpr int PANELS = D / 64;             // 64-column panels of d
  constexpr int QW_BYTES = 64 * D * 2;       // one consumer's Q rows
  constexpr int PANEL_Q = 64 * ROW_BYTES;    // a panel of 64 Q rows
  constexpr int PANEL_KV = BK * ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + TC_ALIGN - 1) & ~(uint32_t)(TC_ALIGN - 1);
  const uint32_t sk = sq + q_bytes(D);
  const uint32_t sv = sk + TC_STAGES * tile_bytes(D);
  const uint32_t sbar = sv + TC_STAGES * tile_bytes(D);
  // mbarriers: K full, V full, stage empty
  auto full_k = [&](int st) { return sbar + 8 * st; };
  auto full_v = [&](int st) { return sbar + 8 * (TC_STAGES + st); };
  auto empty = [&](int st) { return sbar + 8 * (2 * TC_STAGES + st); };

  const int g = h / kv;
  const int bb = blockIdx.y / kv, kh = blockIdx.y % kv;
  const long long nrows = (long long)t * g;
  // the heaviest q blocks (last positions, most keys) launch first
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * TC_BM;
  const long long rlast = (r0 + TC_BM < nrows ? r0 + TC_BM : nrows) - 1;
  const long long qfirst = r0 / g, qlast = rlast / g;
  // kv tiles [jlo, jhi): stop at the first all-future tile, skip the
  // tiles entirely behind the window of the first position
  const int ntiles = (s + BK - 1) / BK;
  int jhi = ntiles;
  if (causal && qlast / BK + 1 < jhi) jhi = (int)(qlast / BK + 1);
  int jlo = 0;
  if (window >= 0) {
    const long long x = qfirst - window - BK + 1;
    if (x >= 0) jlo = (int)(x / BK + 1);
  }

  if (threadIdx.x == 0) {
    for (int st = 0; st < TC_STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 256);           // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(producer_regs(D)));
    if (threadIdx.x == 0) {
      for (int j = jlo; j < jhi; ++j) {
        const int i = j - jlo, st = i % TC_STAGES;
        mbar_wait(empty(st), ((i / TC_STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k(st), tile_bytes(D));
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sk + st * tile_bytes(D) + p * PANEL_KV, &tmk, full_k(st),
                      p * 64, kh, j * BK, bb);
        mbar_expect_tx(full_v(st), tile_bytes(D));
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sv + st * tile_bytes(D) + p * PANEL_KV, &tmv, full_v(st),
                      p * 64, kh, j * BK, bb);
      }
    }
    return;
  }

  // ---- consumers: 64 rows each --------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(consumer_regs(D)));
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32, lane = tid % 32;
  const long long rw = r0 + 64 * cw;         // this warpgroup's first row
  const uint32_t qs = sq + cw * QW_BYTES;

  // Q rows -> shared memory in the layout TMA's 128-byte swizzle gives:
  // panel p of 64 columns, row r at r * 128 B, 16-byte chunk c at
  // (c ^ (r % 8)) * 16 B; rows past t * g are zero
  for (int i = tid; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i % (D / 8);
    const long long R = rw + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (R < nrows) {
      const long long pos = R / g;
      const int gi = (int)(R - pos * g);
      val = *reinterpret_cast<const uint4*>(
          q + ((bb * (long long)t + pos) * h + kh * g + gi) * D + c * 8);
    }
    const uint32_t dst = qs + (c / 8) * PANEL_Q + r * ROW_BYTES
                         + (((c % 8) ^ (r % 8)) * 16);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(dst), "r"(val.x), "r"(val.y), "r"(val.z), "r"(val.w)
                 : "memory");
  }
  // generic-proxy stores -> visible to wgmma (async proxy), then the
  // warpgroup's threads meet (named barrier 1 + cw)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");

  // this thread's rows of the m64 fragments: rl and rl + 8
  const int rl = warp * 16 + lane / 4, c2 = (lane % 4) * 2;
  long long pos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) pos[e] = (rw + rl + 8 * e) / g;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  const uint64_t qdesc = make_desc(qs, 16, 1024);

  for (int j = jlo; j < jhi; ++j) {
    const int i = j - jlo, st = i % TC_STAGES;
    const uint32_t ph = (i / TC_STAGES) & 1;
    const long long k0 = (long long)j * BK;

    // S = Q K^T  (64 x BK a warpgroup, float32)
    float sc[BK / 2];
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] = 0.0f;
    const uint64_t kdesc = make_desc(sk + st * tile_bytes(D), 16, 1024);
    mbar_wait(full_k(st), ph);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk<BK>(sc,
                   qdesc + (((kk / 4) * PANEL_Q + (kk % 4) * 32) >> 4),
                   kdesc + (((kk / 4) * PANEL_KV + (kk % 4) * 32) >> 4),
                   kk > 0);
    wg_commit();
    wg_wait0();
    reg_fence(sc);

    // logits in log2 units: scale, softcap, then the masks (NEG)
    if (cap2 > 0.0f) {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x)
        sc[x] = cap2 * tanh_fast(sc[x] * qk_mul);
    } else {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) sc[x] *= qk_mul;
    }
    const bool all_visible = k0 + BK <= s
                             && (!causal || k0 + BK - 1 <= qfirst)
                             && (window < 0 || k0 > qlast - window);
    if (!all_visible) {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        const long long kpos = k0 + 8 * (x / 4) + c2 + (x & 1);
        const long long p = pos[(x / 2) & 1];
        bool ok = kpos < s;
        if (causal) ok = ok && kpos <= p;
        if (window >= 0) ok = ok && kpos > p - window;
        if (!ok) sc[x] = NEG;
      }
    }
    // online softmax: fragment element x is row (x / 2) & 1, and the 4
    // lanes of a quad hold one row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      mx[(x / 2) & 1] = fmaxf(mx[(x / 2) & 1], sc[x]);
    float corr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      corr[e] = m[e] == NEG ? 1.0f : ex2(m[e] - mx[e]);
      m[e] = mx[e];
      l[e] *= corr[e];
    }
    uint32_t pa[BK / 4];            // P as bf16 pairs: wgmma's A
#pragma unroll
    for (int x = 0; x < BK / 2; x += 2) {
      const int e = (x / 2) & 1;
      const float p0 = sc[x] == NEG ? 0.0f : ex2(sc[x] - m[e]);
      const float p1 = sc[x + 1] == NEG ? 0.0f : ex2(sc[x + 1] - m[e]);
      l[e] += p0 + p1;
      pa[x / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] *= corr[(x / 2) & 1];

    // O += P V  (V MN-major: 64-column panels of d, LBO apart)
    const uint64_t vdesc = make_desc(sv + st * tile_bytes(D), PANEL_KV, 1024);
    mbar_wait(full_v(st), ph);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      wgmma_pv<D>(o, a, vdesc + ((kk * 16 * ROW_BYTES) >> 4));
    }
    wg_commit();
    wg_wait0();
    reg_fence(o);
    mbar_arrive(empty(st));
  }

  // out = acc / max(l, 1e-30): l summed over the quad, in q's dtype
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const long long R = rw + rl + 8 * e;
    if (R >= nrows) continue;
    const float inv = 1.0f / fmaxf(l[e], 1e-30f);
    const int gi = (int)(R - pos[e] * g);
    __nv_bfloat16* dst =
        out + ((bb * (long long)t + pos[e]) * h + kh * g + gi) * D + c2;
#pragma unroll
    for (int x = 0; x < D / 8; ++x)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * x) = __floats2bfloat162_rn(
          o[4 * x + 2 * e] * inv, o[4 * x + 2 * e + 1] * inv);
  }
}

// ---- d 128: the products of one tile overlap the softmax of the next --------

constexpr int T128_STAGES = 2;    // depth of the K/V ring at d 128
constexpr int SCHED_BAR = 3;      // named barriers 3, 4: whose turn to issue

// Dynamic shared memory at d 128: alignment slack, two Q buffers of
// TC_BM rows (an item's and the next item's), T128_STAGES x (K tile + V
// tile) of 128 keys, and 4 mbarriers a stage (K full, V full, K empty, V
// empty): 1,024 + 65,536 + 131,072 + 64 = 197,696 B.
__host__ __device__ constexpr int smem128_bytes() {
  return TC_ALIGN + 2 * q_bytes(128) + T128_STAGES * 2 * tile_bytes(128)
         + T128_STAGES * 4 * 8;
}

// S = Q K^T (64 x 128 keys, float32) over d 128, as one commit group
__device__ __forceinline__ void qk128(float (&sc)[64], uint64_t qdesc,
                                      uint64_t kdesc) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_n128(sc, qdesc + (((kk / 4) * 64 * ROW_BYTES + (kk % 4) * 32) >> 4),
                  kdesc + (((kk / 4) * 128 * ROW_BYTES + (kk % 4) * 32) >> 4),
                  kk > 0);
  wg_commit();
}

// O += P V (V MN-major, its two 64-column panels LBO apart), one group
__device__ __forceinline__ void pv128(float (&o)[64], const uint32_t (&pa)[32],
                                      uint64_t vdesc) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    wgmma_rs_n128(o, a, vdesc + ((kk * 16 * ROW_BYTES) >> 4), 1);
  }
  wg_commit();
}

// The softmax of one 128-key tile starting at key k0, as flash_tc_kernel
// computes it: logits in log2 units (scale, softcap, then the masks:
// NEG), the row max over the quad, corr = ex2(m_old - m_new) (1 while
// m_old == NEG), l *= corr, then sc becomes the weights ex2(x - m) (0
// where masked) and l gains them pair by pair.  Masks compare 32-bit
// positions and are evaluated only where the tile is not all visible.
__device__ __forceinline__ void softmax128(
    float (&sc)[64], float (&m)[2], float (&l)[2], float (&corr)[2], int k0,
    const int (&pos)[2], int c2, int s, int causal, int window, int qfirst,
    int qlast, float qk_mul, float cap2) {
  if (cap2 > 0.0f) {
#pragma unroll
    for (int x = 0; x < 64; ++x) sc[x] = cap2 * tanh_fast(sc[x] * qk_mul);
  } else {
#pragma unroll
    for (int x = 0; x < 64; ++x) sc[x] *= qk_mul;
  }
  const bool all_visible = k0 + 128 <= s
                           && (!causal || k0 + 127 <= qfirst)
                           && (window < 0 || k0 > qlast - window);
  if (!all_visible) {
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      const int kpos = k0 + 8 * (x / 4) + c2 + (x & 1);
      const int p = pos[(x / 2) & 1];
      bool ok = kpos < s;
      if (causal) ok = ok && kpos <= p;
      if (window >= 0) ok = ok && kpos > p - window;
      if (!ok) sc[x] = NEG;
    }
  }
  // the row max as a tree (a max does not depend on the order)
  float mt[2][16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      mt[e][j] = fmaxf(sc[4 * j + 2 * e], sc[4 * j + 2 * e + 1]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mt[e][j] = fmaxf(mt[e][j], mt[e][j + 8]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mt[e][j] = fmaxf(mt[e][j], mt[e][j + 4]);
#pragma unroll
    for (int j = 0; j < 2; ++j) mt[e][j] = fmaxf(mt[e][j], mt[e][j + 2]);
    mt[e][0] = fmaxf(mt[e][0], mt[e][1]);
  }
  float mx[2] = {fmaxf(m[0], mt[0][0]), fmaxf(m[1], mt[1][0])};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    corr[e] = m[e] == NEG ? 1.0f : ex2(m[e] - mx[e]);
    m[e] = mx[e];
    l[e] *= corr[e];
  }
  // the weights, with no select: a masked logit (NEG) gives ex2(NEG - m)
  // = +0 where m is finite, and ex2(NEG - 0) = +0 on a row with nothing
  // visible yet (m == NEG, every logit NEG): the parent's 0 either way,
  // while a visible logit always has a finite m
  float mv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) mv[e] = m[e] == NEG ? 0.0f : m[e];
#pragma unroll
  for (int x = 0; x < 64; x += 2) {
    const int e = (x / 2) & 1;
    const float p0 = ex2(sc[x] - mv[e]);
    const float p1 = ex2(sc[x + 1] - mv[e]);
    l[e] += p0 + p1;
    sc[x] = p0;
    sc[x + 1] = p1;
  }
}

// P to bf16 pairs (as the plain version rounds the weights to q's dtype)
// and O carried to the new row max
__device__ __forceinline__ void pack_rescale128(const float (&sc)[64],
                                                uint32_t (&pa)[32],
                                                float (&o)[64],
                                                const float (&corr)[2]) {
#pragma unroll
  for (int x = 0; x < 64; x += 2) pa[x / 2] = pack_bf16(sc[x], sc[x + 1]);
#pragma unroll
  for (int x = 0; x < 64; ++x) o[x] *= corr[(x / 2) & 1];
}

// The work of one launch at d 128: item w in [0, nqb * nbkv) is q block
// nqb - 1 - w / nbkv (TC_BM folded rows) of (batch, kv head) w % nbkv, so
// the heaviest causal blocks come first.  CTA c of G takes item r * G + c
// of round r, or r * G + G - 1 - c in odd rounds: a snake, so that the
// heavy and light ends of consecutive rounds pair up on one CTA.  The
// order is fixed by (c, G) alone, and an item's arithmetic does not
// depend on which CTA runs it, so reruns are bitwise equal.
__host__ __device__ constexpr int item_of(int c, int r, int G) {
  return r * G + ((r & 1) ? G - 1 - c : c);
}

struct Item128 {
  long long r0;                    // first folded row
  int bb, kh;                      // batch, kv head
  int qfirst, qlast;               // positions of the first and last row
  int jlo, n;                      // kv tiles [jlo, jlo + n)
};

// kv tiles [jlo, jhi): stop at the first all-future tile, skip the tiles
// entirely behind the window of the block's first position
__device__ __forceinline__ Item128 item128(int w, int nbkv, int nqb, int kv,
                                           long long nrows, int g, int s,
                                           int causal, int window) {
  Item128 x;
  const int qb = nqb - 1 - w / nbkv, bkv = w % nbkv;
  x.bb = bkv / kv;
  x.kh = bkv % kv;
  x.r0 = (long long)qb * TC_BM;
  const long long rlast = (x.r0 + TC_BM < nrows ? x.r0 + TC_BM : nrows) - 1;
  // positions fit 32 bits (t < 2^31): masks compare ints
  x.qfirst = (int)(x.r0 / g);
  x.qlast = (int)(rlast / g);
  int jhi = (s + 127) / 128;
  if (causal && x.qlast / 128 + 1 < jhi) jhi = x.qlast / 128 + 1;
  x.jlo = 0;
  if (window >= 0) {
    const int y = x.qfirst - window - 127;
    if (y >= 0) x.jlo = y / 128 + 1;
  }
  x.n = jhi > x.jlo ? jhi - x.jlo : 0;
  return x;
}

// One warpgroup's 64 rows of item x -> out: acc / max(l, 1e-30), l
// summed over the quad, in q's dtype (rows past t * g are not written).
// With zero set, zeros: the output of an item that sees no key.
__device__ __forceinline__ void store128(__nv_bfloat16* __restrict__ out,
                                         const float (&o)[64],
                                         const float (&lsum)[2],
                                         const Item128& x, int cw, int rl,
                                         int c2, int t, int h, int g,
                                         long long nrows, bool zero) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float l = lsum[e];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const long long R = x.r0 + 64 * cw + rl + 8 * e;
    if (R >= nrows) continue;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const long long pos = R / g;
    const int gi = (int)(R - pos * g);
    __nv_bfloat16* dst =
        out + ((x.bb * (long long)t + pos) * h + x.kh * g + gi) * 128 + c2;
#pragma unroll
    for (int y = 0; y < 16; ++y)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * y) =
          zero ? __floats2bfloat162_rn(0.0f, 0.0f)
               : __floats2bfloat162_rn(o[4 * y + 2 * e] * inv,
                                       o[4 * y + 2 * e + 1] * inv);
  }
}

// One warpgroup's 64 Q rows of item x -> its half of a Q buffer at qs, in
// the layout TMA's 128-byte swizzle gives (as flash_tc_kernel), by
// cp.async so a thread's 8 chunks are in flight together; rows past t * g
// are zero-filled
__device__ __forceinline__ void load_q128(const __nv_bfloat16* __restrict__ q,
                                          uint32_t qs, const Item128& x,
                                          int cw, int tid, int t, int h,
                                          int g, long long nrows) {
#pragma unroll
  for (int i = tid; i < 64 * 16; i += 128) {
    const int r = i / 16, ch = i % 16;
    const long long R = x.r0 + 64 * cw + r;
    const bool ok = R < nrows;
    const long long pos = ok ? R / g : 0;
    const int gi = ok ? (int)(R - pos * g) : 0;
    const __nv_bfloat16* src =
        q + ((x.bb * (long long)t + pos) * h + x.kh * g + gi) * 128 + ch * 8;
    const uint32_t dst = qs + (ch / 8) * (64 * ROW_BYTES) + r * ROW_BYTES
                         + (((ch % 8) ^ (r % 8)) * 16);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
  }
}

// grid min(items, SMs), persistent; block TC_THREADS; dynamic smem
// smem128_bytes().  The function of flash_tc_kernel at D = 128, every
// float operation of a row in the same order, so the output is that
// kernel's, bit for bit.  What differs is when:
// - a consumer warpgroup issues S_i = Q K_i^T and O += P_{i-1} V_{i-1}
//   together and runs the softmax of S_i while P_{i-1} V_{i-1} is in
//   flight;
// - the two warpgroups take turns to issue (named barriers SCHED_BAR +
//   cw), so one warpgroup's softmax runs beside the other's products;
// - a CTA walks its items (item_of) as one stream of kv tiles: the
//   producer fills one ring without a break; a consumer issues the first
//   S of an item beside the last P V of the one before, stores that
//   item's rows once its P V is done and restarts O by a rescale with
//   corr = 0; each item's Q rows load one item ahead into the second Q
//   buffer.
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc128_kernel(const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv,
                   const __nv_bfloat16* __restrict__ q,
                   __nv_bfloat16* __restrict__ out, int b, int t, int s,
                   int h, int kv, int causal, int window, float qk_mul,
                   float cap2) {
  constexpr int D = 128, BK = 128, ST = T128_STAGES;
  constexpr int QW_BYTES = 64 * D * 2;       // one consumer's Q rows
  constexpr int PANEL_KV = BK * ROW_BYTES;
  constexpr int TILE = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + TC_ALIGN - 1) & ~(uint32_t)(TC_ALIGN - 1);
  const uint32_t sk = sq + 2 * q_bytes(D);
  const uint32_t sv = sk + ST * TILE;
  const uint32_t sbar = sv + ST * TILE;
  auto full_k = [&](int st) { return sbar + 8 * st; };
  auto full_v = [&](int st) { return sbar + 8 * (ST + st); };
  auto empty_k = [&](int st) { return sbar + 8 * (2 * ST + st); };
  auto empty_v = [&](int st) { return sbar + 8 * (3 * ST + st); };

  const int G = gridDim.x, c = blockIdx.x;
  const int g = h / kv, nbkv = b * kv;
  const long long nrows = (long long)t * g;
  const int nqb = (int)((nrows + TC_BM - 1) / TC_BM);
  const int total = nqb * nbkv;
  auto item = [&](int w) {
    return item128(w, nbkv, nqb, kv, nrows, g, s, causal, window);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 256);         // every consumer thread
      mbar_init(empty_v(st), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, item after item ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;                  // tiles through the ring so far
      for (int r = 0; r * G < total; ++r) {
        const int w = item_of(c, r, G);
        if (w >= total) continue;
        const Item128 x = item(w);
        for (int i = 0; i < x.n; ++i, ++it) {
          const int key = (x.jlo + i) * BK, st = it % ST;
          const uint32_t par = ((it / ST) & 1) ^ 1;
          mbar_wait(empty_k(st), par);
          mbar_expect_tx(full_k(st), TILE);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            tma_load_4d(sk + st * TILE + p * PANEL_KV, &tmk, full_k(st),
                        p * 64, x.kh, key, x.bb);
          mbar_wait(empty_v(st), par);
          mbar_expect_tx(full_v(st), TILE);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            tma_load_4d(sv + st * TILE + p * PANEL_KV, &tmv, full_v(st),
                        p * 64, x.kh, key, x.bb);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows each --------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32, lane = tid % 32;
  // this thread's rows of the m64 fragments: rl and rl + 8
  const int rl = warp * 16 + lane / 4, c2 = (lane % 4) * 2;
  auto qs = [&](int sel) { return sq + sel * q_bytes(D) + cw * QW_BYTES; };
  // this warpgroup's Q copies have landed (generic-proxy writes ->
  // visible to wgmma) and its threads meet: every S it issued before has
  // finished reading the other Q buffer
  auto q_ready = [&]() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
  };
  // the next item of the walk with kv tiles to visit, from round r on;
  // the rows of an item with none are zeros (no key is visible there)
  auto next = [&](int& r, Item128& x) {
    for (; r * G < total; ++r) {
      const int w = item_of(c, r, G);
      if (w >= total) continue;
      x = item(w);
      if (x.n > 0) {
        ++r;
        return true;
      }
      const float none[2] = {}, zeros[64] = {};
      store128(out, zeros, none, x, cw, rl, c2, t, h, g, nrows, true);
    }
    return false;
  };

  // Turns: warpgroup 0 issues first, then each passes to the other; both
  // walk the same tiles and take the same turns, and warpgroup 0 takes
  // one more at the end, so every arrival is matched
  auto take_turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" :: "r"(SCHED_BAR + cw) : "memory");
  };
  auto pass_turn = [&]() {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(SCHED_BAR + 1 - cw)
                 : "memory");
  };
  if (cw == 0)
    asm volatile("bar.arrive %0, 256;\n" :: "r"(SCHED_BAR) : "memory");

  auto kdesc = [&](int st) { return make_desc(sk + st * TILE, 16, 1024); };
  auto vdesc = [&](int st) {
    return make_desc(sv + st * TILE, PANEL_KV, 1024);
  };
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float sc[BK / 2];                // S_i, then its weights P_i in float32
  uint32_t pa[BK / 4];             // P_{i-1} as bf16 pairs: wgmma's A
  float corr[2];
  int pos[2];                      // positions of this thread's two rows
  auto rows_of = [&](const Item128& x) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      pos[e] = (int)((x.r0 + 64 * cw + rl + 8 * e) / g);
  };

  int r = 0;
  Item128 cur, nxt;                // the item of the S in hand, the next
  if (next(r, cur)) {
    load_q128(q, qs(0), cur, cw, tid, t, h, g, nrows);
    bool more = next(r, nxt);
    q_ready();
    if (more) load_q128(q, qs(1), nxt, cw, tid, t, h, g, nrows);
    rows_of(cur);
    // turn 0: S of the first tile alone
    mbar_wait(full_k(0), 0);
    __syncwarp();
    take_turn();
    wg_fence();
    qk128(sc, make_desc(qs(0), 16, 1024), kdesc(0));
    pass_turn();
    wg_wait0();
    reg_fence(sc);
    mbar_arrive(empty_k(0));
    softmax128(sc, m, l, corr, cur.jlo * BK, pos, c2, s, causal, window,
               cur.qfirst, cur.qlast, qk_mul, cap2);
    pack_rescale128(sc, pa, o, corr);
    Item128 prev = cur;            // the item O accumulates
    int i = 0, sel = 0, it = 0;    // tile of cur, its Q buffer, ring index
    // turn it: S of tile it and P V of tile it - 1, then the softmax of
    // S while P V runs
    while (true) {
      bool first = false;          // tile it is an item's first
      if (i + 1 < cur.n) {
        ++i;
      } else if (more) {
        cur = nxt;
        more = next(r, nxt);
        i = 0;
        sel ^= 1;
        first = true;
        rows_of(cur);
      } else {
        break;
      }
      ++it;
      if (first) {
        q_ready();
        if (more) load_q128(q, qs(sel ^ 1), nxt, cw, tid, t, h, g, nrows);
      }
      const int st = it % ST, pst = (it - 1) % ST;
      mbar_wait(full_k(st), (it / ST) & 1);
      mbar_wait(full_v(pst), ((it - 1) / ST) & 1);
      __syncwarp();
      take_turn();
      wg_fence();
      qk128(sc, make_desc(qs(sel), 16, 1024), kdesc(st));
      pv128(o, pa, vdesc(pst));
      pass_turn();
      wg_wait1();
      reg_fence(sc);
      mbar_arrive(empty_k(st));
      const float lp[2] = {l[0], l[1]};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m[e] = first ? NEG : m[e];
        l[e] = first ? 0.0f : l[e];
      }
      softmax128(sc, m, l, corr, (cur.jlo + i) * BK, pos, c2, s, causal,
                 window, cur.qfirst, cur.qlast, qk_mul, cap2);
      wg_wait0();
      reg_fence(o);
      reg_fence(pa);
      mbar_arrive(empty_v(pst));
      if (first) {                 // prev is done: its rows, then O = 0
        store128(out, o, lp, prev, cw, rl, c2, t, h, g, nrows, false);
        corr[0] = corr[1] = 0.0f;
        prev = cur;
      }
      pack_rescale128(sc, pa, o, corr);
    }
    // the last P V
    const int pst = it % ST;
    mbar_wait(full_v(pst), (it / ST) & 1);
    __syncwarp();
    take_turn();
    wg_fence();
    pv128(o, pa, vdesc(pst));
    pass_turn();
    wg_wait0();
    reg_fence(o);
    reg_fence(pa);
    mbar_arrive(empty_v(pst));
    store128(out, o, l, prev, cw, rl, c2, t, h, g, nrows, false);
  }
  if (cw == 0) take_turn();        // warpgroup 1's last pass
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda of its own
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int ERR_NO_ENCODER = -1, ERR_ENCODE = -2, ERR_HEAD_DIM = -3;

// K or V [b, s, kv, d] as a 4-D map (d, kv, s, b), box (64, 1, bk_of(d), 1)
int encode_kv(CUtensorMap* map, const void* base, int b, int s, int kv, int D) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)kv, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)kv * D * 2,
                                 (cuuint64_t)s * kv * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)bk_of(D), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(base), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int t, int s, int h, int kv, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  CUtensorMap tmk, tmv;
  memset(&tmk, 0, sizeof(tmk));
  memset(&tmv, 0, sizeof(tmv));
  if (s > 0) {                     // s == 0: no tile is loaded
    int err = encode_kv(&tmk, k, b, s, kv, D);
    if (err == 0) err = encode_kv(&tmv, v, b, s, kv, D);
    if (err != 0) return err;
  }
  const float qk_mul = softcap > 0.0f ? scale / softcap : scale * LOG2E;
  const float cap2 = softcap > 0.0f ? softcap * LOG2E : 0.0f;
  const long long nrows = (long long)t * (h / kv);
  const int nqb = (int)((nrows + TC_BM - 1) / TC_BM);
  if constexpr (D == 128) {
    // one persistent CTA an SM (at most one item each)
    const int bytes = smem128_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long items = (long long)nqb * b * kv;
    const int grid = (int)(items < sms ? items : sms);
    flash_tc128_kernel<<<grid, TC_THREADS, bytes, stream>>>(
        tmk, tmv, (const __nv_bfloat16*)q, (__nv_bfloat16*)out, b, t, s, h,
        kv, causal, window, qk_mul, cap2);
  } else {
    const int bytes = smem_bytes(D);
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)nqb, (unsigned)(b * kv));
    flash_tc_kernel<D><<<grid, TC_THREADS, bytes, stream>>>(
        tmk, tmv, (const __nv_bfloat16*)q, (__nv_bfloat16*)out, t, s, h, kv,
        causal, window, qk_mul, cap2);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---- plain C entry points (loaded with ctypes) ---------------------------
// q [b, t, h, d], k/v [b, s, kv, d], out [b, t, h, d], all contiguous, of
// one dtype: dtype 0 = float32, 1 = bfloat16.  window < 0 = no window.
// The caller checks 1 <= d <= fa_max_head_dim(), h % kv == 0 and that
// the tensors are 16-byte aligned (both routes load 16 bytes at a time),
// and for the tensor-core route that they are bfloat16 and d is 64, 128
// or 256.  Launches on the caller's stream; returns the cudaError_t (0 =
// success) or a negative code of fa_error_string.  fa_smem_bytes is the
// CUDA-core kernel's dynamic shared memory at head dim d.

extern "C" int fa_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int dtype, int b, int t, int s,
                                  int h, int kv, int d, int causal,
                                  int window, float softcap, float scale,
                                  void* stream) {
  if (b <= 0 || t <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, t, s, h, kv, d, causal,
                                   window, softcap, scale, st);
  return dispatch<float>(q, k, v, out, b, t, s, h, kv, d, causal, window,
                         softcap, scale, st);
}

extern "C" int fa_flash_attention_tc(const void* q, const void* k,
                                     const void* v, void* out, int b, int t,
                                     int s, int h, int kv, int d, int causal,
                                     int window, float softcap, float scale,
                                     void* stream) {
  if (b <= 0 || t <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 256)
    return tc::launch<256>(q, k, v, out, b, t, s, h, kv, causal, window,
                           softcap, scale, st);
  if (d == 128)
    return tc::launch<128>(q, k, v, out, b, t, s, h, kv, causal, window,
                           softcap, scale, st);
  if (d == 64)
    return tc::launch<64>(q, k, v, out, b, t, s, h, kv, causal, window,
                          softcap, scale, st);
  return tc::ERR_HEAD_DIM;
}

extern "C" int fa_max_head_dim() { return 256; }

extern "C" long long fa_smem_bytes(int d) { return cc_smem_bytes(d); }

extern "C" const char* fa_error_string(int err) {
  switch (err) {
    case tc::ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled not found through the driver entry point";
    case tc::ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused the K/V tensor map";
    case tc::ERR_HEAD_DIM:
      return "the tensor-core kernel takes head_dim 64, 128 or 256 only";
    default:
      return cudaGetErrorString((cudaError_t)err);
  }
}
