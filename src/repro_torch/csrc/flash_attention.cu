// Blockwise fused attention (forward) for Hopper (sm_90a).
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
// TPU kernel: row R = pos * g + group.  One CTA takes BR = 64 consecutive
// rows of one (batch, kv head), so all g heads share each K/V tile, and
// walks the kv tiles of BK = 64 keys in order, keeping float32 m / l /
// acc per row in registers.  Masks compare positions (R / g), not rows.
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
// Bound on this card: operations.  At gemma2's prefill shapes the work
// is 4 * t * s_visible * h * d flops against bytes of order (t + s) * h *
// d, far above the card's flops-per-byte line.  This first design runs
// on the CUDA cores in float32 (tensor cores, wgmma and TMA come later):
// each thread owns a 4 x 4 micro-tile of the 64 x 64 logit tile and a
// 4 x NC micro-tile of the 64 x d accumulator, fed from shared memory,
// with explicit fmaf so the build's -fmad=false does not split the
// multiply-adds.  It is far from the bound and slower than a library's
// tensor-core attention: the numbers are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// ---- plain C entry points (loaded with ctypes) ---------------------------
// q [b, t, h, d], k/v [b, s, kv, d], out [b, t, h, d], all contiguous, of
// one dtype: dtype 0 = float32, 1 = bfloat16.  window < 0 = no window.
// The caller checks 1 <= d <= fa_max_head_dim() and h % kv == 0.
// Launches on the caller's stream; returns the cudaError_t (0 = success).

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

extern "C" int fa_max_head_dim() { return 256; }

extern "C" long long fa_smem_bytes(int d) {
  return smem_floats(d) * (long long)sizeof(float);
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
