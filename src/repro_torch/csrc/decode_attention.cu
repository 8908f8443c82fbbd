// Single-token GQA decode attention for Hopper (sm_90a).
//
// Port of the Pallas TPU kernel decode_attention
// (src/repro/kernels/decode_attention.py:71, body _decode_kernel :27):
// one query token per sequence against a KV cache under a valid mask
// (ring-buffer caches have arbitrary valid-slot patterns), online
// softmax over the keys, the logit softcap fused and an explicit scale.
//
// Bound on this card: bytes.  Each launch streams the cache's K and V
// once (b * s * kv * d elements each) and does about 4 * g flops per
// element, far below the card's flops-per-byte line.  The TPU kernel
// walks the kv tiles of one (batch, kv head) in a sequential grid; one
// CTA per (batch, kv head) would leave most of the 132 SMs idle at
// serving batch sizes (64 CTAs at gemma2's b = 4, kv = 16).  So the keys
// are split: CTA (split, batch * kv head) takes DCH = 256 consecutive
// keys, and each of its DW = 4 warps walks every DW-th of them, one key
// at a time, keeping its own online-softmax state (m, l, acc) for the g
// query heads of the kv head.  A lane holds d / 32 elements of each K
// and V row (coalesced), the g dot products are warp reductions, and
// each warp writes its partial (m, l, acc) to scratch.  A second kernel
// merges the partials of one (batch, query head) and writes the output.
//
// Semantics kept from the TPU kernel: logits are dot * scale, then
// tanh(x / cap) * cap; invalid slots take no part at all (the TPU kernel
// gives them NEG_INF logits, zero weight and zeroed V rows, which is the
// same), so a row with no valid slot yields 0 = acc / max(l, 1e-30); the
// running max starts at NEG_INF = -1e30 and a partial that saw no valid
// slot merges with weight 0.  Exponentials are expf, multiply-adds
// explicit fmaf (the build's -fmad=false would otherwise split them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DW = 4;       // warps per CTA
constexpr int DCH = 256;    // keys per CTA
constexpr int MAXC = 8;     // d / 32 elements a lane holds (d <= 256)
constexpr int CT = 128;     // threads of the merge kernel
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

// floats of dynamic shared memory of the split kernel
__host__ __device__ constexpr long long split_smem_floats(int g, int D) {
  return (long long)g * D * (1 + DW) + 2LL * DW * g;
}

template <typename T>
__global__ void __launch_bounds__(DW * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int s, int h, int kv,
                    int D, float softcap, float scale, int nparts) {
  extern __shared__ float smem[];
  const int g = h / kv;
  float* qs = smem;                      // [g][D]
  float* accs = qs + g * D;              // [DW][g][D]
  float* ms = accs + DW * g * D;         // [DW][g]
  float* ls = ms + DW * g;               // [DW][g]
  const int bkv = blockIdx.y, bb = bkv / kv, kh = bkv % kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // q [b, h, D]: the g heads of kv head kh are contiguous
  const T* qrow = q + ((long long)bb * h + (long long)kh * g) * D;
  for (int i = threadIdx.x; i < g * D; i += DW * 32) qs[i] = to_f(qrow[i]);
  for (int i = threadIdx.x; i < DW * g * D; i += DW * 32) accs[i] = 0.0f;
  for (int i = threadIdx.x; i < DW * g; i += DW * 32) {
    ms[i] = NEG_INF;
    ls[i] = 0.0f;
  }
  __syncthreads();

  float* acc = accs + warp * g * D;
  float* mw = ms + warp * g;
  float* lw = ls + warp * g;
  const long long key0 = (long long)blockIdx.x * DCH;
  const long long key1 = key0 + DCH < s ? key0 + DCH : s;
  for (long long key = key0 + warp; key < key1; key += DW) {
    if (!valid[(long long)bb * s + key]) continue;        // warp-uniform
    const long long base = (((long long)bb * s + key) * kv + kh) * D;
    float kr[MAXC], vr[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int dd = lane + 32 * c;
      kr[c] = dd < D ? to_f(k[base + dd]) : 0.0f;
      vr[c] = dd < D ? to_f(v[base + dd]) : 0.0f;
    }
    for (int gi = 0; gi < g; ++gi) {
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int dd = lane + 32 * c;
        if (dd < D) dot = fmaf(qs[gi * D + dd], kr[c], dot);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      float x = dot * scale;
      if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
      const float m_prev = mw[gi];
      const float m_new = fmaxf(m_prev, x);
      const float corr = (m_prev == NEG_INF) ? 1.0f : expf(m_prev - m_new);
      const float p = expf(x - m_new);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int dd = lane + 32 * c;
        if (dd < D) acc[gi * D + dd] = fmaf(p, vr[c], acc[gi * D + dd] * corr);
      }
      const float l_new = lw[gi] * corr + p;
      __syncwarp();
      if (lane == 0) {
        mw[gi] = m_new;
        lw[gi] = l_new;
      }
      __syncwarp();
    }
  }
  __syncwarp();

  const long long pbase =
      ((long long)bkv * nparts + (long long)blockIdx.x * DW + warp) * g;
  for (int gi = 0; gi < g; ++gi)
    for (int dd = lane; dd < D; dd += 32)
      part_acc[(pbase + gi) * D + dd] = acc[gi * D + dd];
  if (lane == 0)
    for (int gi = 0; gi < g; ++gi) {
      part_m[pbase + gi] = mw[gi];
      part_l[pbase + gi] = lw[gi];
    }
}

template <typename T>
__global__ void __launch_bounds__(CT)
decode_merge_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out,
                    int h, int kv, int D, int nparts) {
  const int g = h / kv;
  const int row = blockIdx.x;                 // (batch * kv + kh) * g + gi
  const int bkv = row / g, gi = row % g;
  const int bb = bkv / kv, kh = bkv % kv;
  const long long p0 = (long long)bkv * nparts;
  float M = NEG_INF;
  for (int p = 0; p < nparts; ++p) M = fmaxf(M, part_m[(p0 + p) * g + gi]);
  float L = 0.0f;
  for (int p = 0; p < nparts; ++p) {
    const float mp = part_m[(p0 + p) * g + gi];
    const float w = (mp == NEG_INF) ? 0.0f : expf(mp - M);
    L = fmaf(part_l[(p0 + p) * g + gi], w, L);
  }
  const float denom = fmaxf(L, 1e-30f);
  T* o = out + ((long long)bb * h + (long long)kh * g + gi) * D;
  for (int dd = threadIdx.x; dd < D; dd += CT) {
    float a = 0.0f;
    for (int p = 0; p < nparts; ++p) {
      const float mp = part_m[(p0 + p) * g + gi];
      const float w = (mp == NEG_INF) ? 0.0f : expf(mp - M);
      a = fmaf(part_acc[((p0 + p) * g + gi) * D + dd], w, a);
    }
    o[dd] = from_f<T>(a / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* valid, float* pm, float* pl, float* pacc,
           void* out, int b, int s, int h, int kv, int D, float softcap,
           float scale, cudaStream_t st) {
  const int g = h / kv;
  const int nsplit = (s + DCH - 1) / DCH;
  const int nparts = nsplit * DW;
  const size_t bytes = (size_t)split_smem_floats(g, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<T><<<dim3(nsplit, b * kv), DW * 32, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, valid, pm, pl, pacc, s, h, kv,
      D, softcap, scale, nparts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T><<<b * h, CT, 0, st>>>(pm, pl, pacc, (T*)out, h, kv,
                                               D, nparts);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- plain C entry points (loaded with ctypes) ---------------------------
// q [b, h, d], k/v [b, s, kv, d], out [b, h, d] contiguous, of one dtype
// (0 = float32, 1 = bfloat16); valid [b, s] bytes (0 / 1); scratch
// part_m / part_l [b * kv * da_parts(s) * g] and part_acc [... * d]
// float32, allocated by the caller.  s >= 1; the caller checks
// 1 <= d <= da_max_head_dim(), h % kv == 0 and da_smem_bytes(g, d).
// Launches both kernels on the caller's stream; returns the cudaError_t
// (0 = success).

extern "C" int da_decode_attention(const void* q, const void* k,
                                   const void* v, const void* valid,
                                   void* part_m, void* part_l,
                                   void* part_acc, void* out, int dtype,
                                   int b, int s, int h, int kv, int d,
                                   float softcap, float scale,
                                   void* stream) {
  if (b <= 0 || s <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* vm = (const unsigned char*)valid;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, vm, (float*)part_m,
                                 (float*)part_l, (float*)part_acc, out, b, s,
                                 h, kv, d, softcap, scale, st);
  return launch<float>(q, k, v, vm, (float*)part_m, (float*)part_l,
                       (float*)part_acc, out, b, s, h, kv, d, softcap, scale,
                       st);
}

extern "C" int da_parts(int s) { return ((s + DCH - 1) / DCH) * DW; }

extern "C" int da_max_head_dim() { return 32 * MAXC; }

extern "C" long long da_smem_bytes(int g, int d) {
  return split_smem_floats(g, d) * (long long)sizeof(float);
}

extern "C" const char* da_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
