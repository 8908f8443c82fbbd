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
// * Tensor cores (fa_flash_attention_tc): bfloat16 at d in {64, 128},
//   every bf16 call of gemma2's prefill.  Bound on this card: operations
//   (4 * visible pairs * h * d flops at 989 TFLOP/s; at the serve cell
//   also the SFU: one ex2 and, with a softcap, one tanh per visible
//   logit at 16 a clock per SM).  Design, for Hopper: one CTA of 384
//   threads takes 128 folded rows of one (batch, kv head) -- a producer
//   warpgroup and two consumer warpgroups of 64 rows (one wgmma M each).
//   Q is loaded once by the consumers into 128-byte-swizzled shared
//   memory; K and V tiles of 128 keys stream through a 2-stage ring
//   filled by TMA (4-D maps (d, kv, s, b), box (64, 1, 128, 1), 128-byte
//   swizzle; out-of-bounds rows past s arrive as zeros) with full/empty
//   mbarriers.  S = Q K^T is wgmma m64n128k16 from shared memory;
//   scale, softcap (tanh.approx.f32) and masks act on the float32
//   accumulator fragments, in log2 units so the softmax is one
//   ex2.approx a logit; row max / sum over the 4 lanes of a row.  P is
//   rounded to bf16 in registers (as the plain version rounds the
//   weights to q's dtype) and is wgmma's A operand for O += P V, V read
//   MN-major (the transpose bit).  setmaxnreg gives the consumers 232
//   registers (S and O are 64 floats a thread each at d = 128).  Heavy
//   causal q blocks launch first.  tanh.approx has a relative error of
//   about 2^-11; the error it adds is measured by chip_smoke at caps 2,
//   5 and 50 against the 2e-2 bound.
//
// * CUDA cores (fa_flash_attention): float32 at any d (TF32 wgmma would
//   break the 3e-5 float32 bound) and bfloat16 at d outside {64, 128}
//   (the smoke configs' 8-16, the edge shapes' 32, recurrentgemma's 256,
//   whose O accumulator would take 128 registers a thread).  One CTA of
//   256 threads takes 64 rows; each thread owns a 4 x 4 micro-tile of
//   the 64 x 64 logit tile and a 4 x NC micro-tile of the 64 x d
//   accumulator, fed from float32 tiles in shared memory, with explicit
//   fmaf so the build's -fmad=false does not split the multiply-adds,
//   and tanhf per logit.  It is far from its bound: the numbers are in
//   PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BR = 64;    // query rows per CTA
constexpr int BK = 64;    // keys per kv tile
constexpr int NT = 256;   // threads: a 16 x 16 grid of micro-tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// floats of dynamic shared memory for head dim D
__host__ __device__ constexpr long long smem_floats(int D) {
  return 2LL * BR * (D + 1)            // Qs [BR][D+1], Vs [BK][D+1]
         + (long long)D * (BK + 1)     // Kt [D][BK+1]
         + (long long)BR * (BK + 1);   // Ps [BR][BK+1]
}

template <typename T, int NC>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int t, int s,
             int h, int kv, int D, int causal, int window, float softcap,
             float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;                    // [BR][DP]
  float* Vs = Qs + BR * DP;            // [BK][DP]
  float* Kt = Vs + BK * DP;            // [D][BK + 1]  (transposed)
  float* Ps = Kt + D * (BK + 1);       // [BR][BK + 1]

  const int g = h / kv;
  const int bb = blockIdx.y / kv, kh = blockIdx.y % kv;
  const long long nrows = (long long)t * g;
  const long long r0 = (long long)blockIdx.x * BR;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < BR * D; i += NT) {
    const int r = i / D, dd = i - r * D;
    const long long R = r0 + r;
    float x = 0.0f;
    if (R < nrows) {
      const long long pos = R / g;
      const int gi = (int)(R - pos * g);
      x = to_f(q[((bb * (long long)t + pos) * h + kh * g + gi) * D + dd]);
    }
    Qs[r * DP + dd] = x;
  }
  const long long rlast = (r0 + BR < nrows ? r0 + BR : nrows) - 1;
  const long long qfirst = r0 / g, qlast = rlast / g;

  long long qpos[4];
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = (r0 + ty + 16 * i) / g;
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int ntiles = (s + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const long long k0 = (long long)kt * BK;
    if (causal && k0 > qlast) break;                       // all future
    if (window >= 0 && k0 + BK - 1 <= qfirst - window) continue;  // behind
    __syncthreads();                  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int kk = i / D, dd = i - kk * D;
      const long long key = k0 + kk;
      float kx = 0.0f, vx = 0.0f;
      if (key < s) {
        const long long off = ((bb * (long long)s + key) * kv + kh) * D + dd;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Kt[dd * (BK + 1) + kk] = kx;
      Vs[kk * DP + dd] = vx;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int dd = 0; dd < D; ++dd) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Kt[dd * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + tx + 16 * j;
        ok[j] = kpos < s;
        if (causal) ok[j] = ok[j] && kpos <= qpos[i];
        if (window >= 0) ok[j] = ok[j] && kpos > qpos[i] - window;
        float x = sc[i][j] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        sc[i][j] = ok[j] ? x : NEG_INF;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      // the 16 lanes holding one row share a half-warp (lane = 16*(ty%2)+tx)
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = (m[i] == NEG_INF) ? 1.0f : expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.0f;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int dd = tx + 16 * c;
        vv[c] = dd < D ? Vs[kk * DP + dd] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long R = r0 + ty + 16 * i;
    if (R >= nrows) continue;
    const long long pos = R / g;
    const int gi = (int)(R - pos * g);
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((bb * (long long)t + pos) * h + kh * g + gi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int dd = tx + 16 * c;
      if (dd < D) o[dd] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int t, int s, int h, int kv, int D, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long nrows = (long long)t * (h / kv);
  dim3 grid((unsigned)((nrows + BR - 1) / BR), (unsigned)(b * kv));
  flash_kernel<T, NC><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, t, s, h, kv, D,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int t, int s, int h, int kv, int D, int causal, int window,
             float softcap, float scale, cudaStream_t st) {
  // NC = accumulator columns per thread: the d columns over 16 lanes
  if (D <= 16)
    return launch<T, 1>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                        softcap, scale, st);
  if (D <= 32)
    return launch<T, 2>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                        softcap, scale, st);
  if (D <= 64)
    return launch<T, 4>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                        softcap, scale, st);
  if (D <= 128)
    return launch<T, 8>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                        softcap, scale, st);
  return launch<T, 16>(q, k, v, out, b, t, s, h, kv, D, causal, window,
                       softcap, scale, st);
}

}  // namespace

// ===========================================================================
// Tensor-core route: bfloat16, d in {64, 128}, wgmma + TMA ring
// ===========================================================================

namespace tc {

constexpr int TC_BM = 128;        // folded query rows per CTA (2 x 64)
constexpr int TC_BK = 128;        // keys per kv tile
constexpr int TC_STAGES = 2;      // depth of the K/V ring
constexpr int TC_ALIGN = 1024;    // slack to align the ring to the swizzle
constexpr int TC_THREADS = 384;   // producer warpgroup + 2 consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ROW_BYTES = 128;    // one swizzled row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;     // NEG_INF, in log2 units here

// Dynamic shared memory at head dim D: alignment slack, Q (TC_BM rows),
// TC_STAGES x (K tile + V tile) of TC_BK rows, and 3 mbarriers a stage.
__host__ __device__ constexpr int q_bytes(int D) { return TC_BM * D * 2; }
__host__ __device__ constexpr int tile_bytes(int D) { return TC_BK * D * 2; }
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
// keep the compiler from moving accesses of wgmma's registers across
// the asynchronous start and wait of a wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
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


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) wgmma_rs_n128(o, a, db, 1);
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
  static_assert(D == 64 || D == 128, "tensor-core route: d in {64, 128}");
  constexpr int PANELS = D / 64;             // 64-column panels of d
  constexpr int QW_BYTES = 64 * D * 2;       // one consumer's Q rows
  constexpr int PANEL_Q = 64 * ROW_BYTES;    // a panel of 64 Q rows
  constexpr int PANEL_KV = TC_BK * ROW_BYTES;
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
  const int ntiles = (s + TC_BK - 1) / TC_BK;
  int jhi = ntiles;
  if (causal && qlast / TC_BK + 1 < jhi) jhi = (int)(qlast / TC_BK + 1);
  int jlo = 0;
  if (window >= 0) {
    const long long x = qfirst - window - TC_BK + 1;
    if (x >= 0) jlo = (int)(x / TC_BK + 1);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int j = jlo; j < jhi; ++j) {
        const int i = j - jlo, st = i % TC_STAGES;
        mbar_wait(empty(st), ((i / TC_STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k(st), tile_bytes(D));
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sk + st * tile_bytes(D) + p * PANEL_KV, &tmk, full_k(st),
                      p * 64, kh, j * TC_BK, bb);
        mbar_expect_tx(full_v(st), tile_bytes(D));
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(sv + st * tile_bytes(D) + p * PANEL_KV, &tmv, full_v(st),
                      p * 64, kh, j * TC_BK, bb);
      }
    }
    return;
  }

  // ---- consumers: 64 rows each --------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
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
    const long long k0 = (long long)j * TC_BK;

    // S = Q K^T  (64 x 128 a warpgroup, float32)
    float sc[TC_BK / 2];
#pragma unroll
    for (int x = 0; x < TC_BK / 2; ++x) sc[x] = 0.0f;
    const uint64_t kdesc = make_desc(sk + st * tile_bytes(D), 16, 1024);
    mbar_wait(full_k(st), ph);
    __syncwarp();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(sc,
                    qdesc + (((kk / 4) * PANEL_Q + (kk % 4) * 32) >> 4),
                    kdesc + (((kk / 4) * PANEL_KV + (kk % 4) * 32) >> 4),
                    kk > 0);
    wg_commit();
    wg_wait0();
    reg_fence(sc);

    // logits in log2 units: scale, softcap, then the masks (NEG)
    if (cap2 > 0.0f) {
#pragma unroll
      for (int x = 0; x < TC_BK / 2; ++x)
        sc[x] = cap2 * tanh_fast(sc[x] * qk_mul);
    } else {
#pragma unroll
      for (int x = 0; x < TC_BK / 2; ++x) sc[x] *= qk_mul;
    }
    const bool all_visible = k0 + TC_BK <= s
                             && (!causal || k0 + TC_BK - 1 <= qfirst)
                             && (window < 0 || k0 > qlast - window);
    if (!all_visible) {
#pragma unroll
      for (int x = 0; x < TC_BK / 2; ++x) {
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
    for (int x = 0; x < TC_BK / 2; ++x)
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
    uint32_t pa[TC_BK / 4];            // P as bf16 pairs: wgmma's A
#pragma unroll
    for (int x = 0; x < TC_BK / 2; x += 2) {
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
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
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

// K or V [b, s, kv, d] as a 4-D map (d, kv, s, b), box (64, 1, TC_BK, 1)
int encode_kv(CUtensorMap* map, const void* base, int b, int s, int kv, int D) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)kv, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)kv * D * 2,
                                 (cuuint64_t)s * kv * D * 2};
  const cuuint32_t box[4] = {64, 1, TC_BK, 1};
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
  const int bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long nrows = (long long)t * (h / kv);
  dim3 grid((unsigned)((nrows + TC_BM - 1) / TC_BM), (unsigned)(b * kv));
  const float qk_mul = softcap > 0.0f ? scale / softcap : scale * LOG2E;
  const float cap2 = softcap > 0.0f ? softcap * LOG2E : 0.0f;
  flash_tc_kernel<D><<<grid, TC_THREADS, bytes, stream>>>(
      tmk, tmv, (const __nv_bfloat16*)q, (__nv_bfloat16*)out, t, s, h, kv,
      causal, window, qk_mul, cap2);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---- plain C entry points (loaded with ctypes) ---------------------------
// q [b, t, h, d], k/v [b, s, kv, d], out [b, t, h, d], all contiguous, of
// one dtype: dtype 0 = float32, 1 = bfloat16.  window < 0 = no window.
// The caller checks 1 <= d <= fa_max_head_dim() and h % kv == 0, and for
// the tensor-core route that the tensors are bfloat16, 16-byte aligned
// and d is 64 or 128.  Launches on the caller's stream; returns the
// cudaError_t (0 = success) or a negative code of fa_error_string.

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
  if (d == 128)
    return tc::launch<128>(q, k, v, out, b, t, s, h, kv, causal, window,
                           softcap, scale, st);
  if (d == 64)
    return tc::launch<64>(q, k, v, out, b, t, s, h, kv, causal, window,
                          softcap, scale, st);
  return tc::ERR_HEAD_DIM;
}

extern "C" int fa_max_head_dim() { return 256; }

extern "C" long long fa_smem_bytes(int d) {
  return smem_floats(d) * (long long)sizeof(float);
}

extern "C" const char* fa_error_string(int err) {
  switch (err) {
    case tc::ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled not found through the driver entry point";
    case tc::ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused the K/V tensor map";
    case tc::ERR_HEAD_DIM:
      return "the tensor-core kernel takes head_dim 64 or 128 only";
    default:
      return cudaGetErrorString((cudaError_t)err);
  }
}
