// Single-token GQA decode attention for Hopper (sm_90a).
//
// Port of the Pallas TPU kernel decode_attention
// (src/repro/kernels/decode_attention.py:71, body _decode_kernel :27):
// one query token per sequence against a KV cache under a valid mask
// (ring-buffer caches have arbitrary valid-slot patterns), online
// softmax over the keys, the logit softcap fused and an explicit scale.
//
// Bound on this card: bytes.  Each launch streams the valid slots' K and
// V rows once and does about 4 * g flops a cache element, far below the
// card's ~295 flops a byte.  So the only lever is to keep enough K/V
// bytes in flight from every SM, and the design is built around that:
//
//  * Loads of 16 bytes a lane.  A key's row of one kv head (d elements)
//    is cut into 16-byte chunks; LPR lanes (a power of two, at most 32)
//    cover one row, so a warp covers 32 / LPR keys with one load (two
//    keys at gemma2's bf16 d = 128).  Each lane issues the loads of TR
//    such rows of K and of V before it uses any: a tile of
//    TR * 32 / LPR keys (8 keys, 4 KB of K and V in flight a warp at the
//    serve shape), with 16 warps resident an SM (two CTAs of 8 warps,
//    <= 128 registers, TR chosen so that nothing spills): 64 KB an SM.
//  * Per-tile online softmax in registers.  The tile's GC x TR logits
//    come first (partial dots, then a shuffle reduction over the LPR
//    lanes of a row), then one max and one rescale a tile, then P.V.
//    m, l and acc live in registers; tanhf and expf as in the reference.
//  * The valid mask is read once a tile, one tile ahead (so its latency
//    hides behind the current tile's loads); a tile with no valid slot
//    is skipped without loading its K/V, and an invalid row's K/V is
//    never loaded.
//  * Grid.  A warp is one unit of work: (batch, split of the keys, kv
//    head, chunk of GC of its g query heads).  The host's plan
//    (kernels/decode_attention.py::decode_plan) picks the split length,
//    a multiple of the tile, so that the units fill every SM once (132
//    SMs x 16 warps); a CTA's 8 warps are neighbouring kv heads of one
//    (batch, split), which read one contiguous span of the cache.
//  * Merge.  Each unit writes its partial (m, l, acc) for its GC heads;
//    a second kernel walks the partials of one (batch, query head) in
//    split order (no atomics: two runs give the same bits) and writes
//    the output.  One wrapper launch counts one.
//
// Semantics kept from the TPU kernel: logits are dot * scale, then
// tanh(x / cap) * cap; invalid slots take no part at all (the TPU kernel
// gives them NEG_INF logits, zero weight and zeroed V rows, which is the
// same), so a row with no valid slot yields 0 = acc / max(l, 1e-30); the
// running max starts at NEG_INF = -1e30 and a partial that saw no valid
// slot merges with weight 0.  Multiply-adds are explicit fmaf (the
// build's -fmad=false would otherwise split them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WPC = 8;          // warps per CTA of the split kernel
constexpr int MAX_HEAD_DIM = 256;
constexpr int CT = 128;         // threads of the merge kernel
constexpr float NEG_INF = -1e30f;

// elements of one 16-byte chunk
template <typename T> __host__ __device__ constexpr int vec_of() {
  return 16 / (int)sizeof(T);
}

// rows a lane loads a tile (its share of TR * 32 / LPR keys): as many
// as 128 registers hold without spilling (measured with -Xptxas -v)
__host__ __device__ constexpr int rows_of(int gc, int vpl) {
  return (gc >= 2 ? 4 : 8) / vpl;
}

// element e of a 16-byte chunk, as float
template <typename T> __device__ __forceinline__ float elem(const uint4& u,
                                                            int e);
template <> __device__ __forceinline__ float elem<float>(const uint4& u,
                                                         int e) {
  const unsigned w = e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w;
  return __uint_as_float(w);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(
    const uint4& u, int e) {
  const int i = e >> 1;
  const unsigned w = i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// n_ok (<= the chunk's width) elements from p: one 16-byte load when
// the chunk is whole and aligned, else element by element (zero fill)
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int n_ok,
                                            bool vec) {
  constexpr int VEC = vec_of<T>();
  if (vec && n_ok == VEC) return __ldcs(reinterpret_cast<const uint4*>(p));
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (sizeof(T) == 4) {
    const unsigned* b = reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n_ok) w[e] = b[e];
  } else {
    const unsigned short* b = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n_ok) w[e >> 1] |= (unsigned)b[e] << ((e & 1) * 16);
  }
  u.x = w[0];
  u.y = w[1];
  u.z = w[2];
  u.w = w[3];
  return u;
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
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

// the valid bytes of a lane's TR rows of the tile at t0 (0 past k1)
template <int TR>
__device__ __forceinline__ void load_valid(
    const unsigned char* __restrict__ vrow, long long t0, long long k1,
    int kpw, int grp, unsigned char* vb) {
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const long long key = t0 + (long long)r * kpw + grp;
    vb[r] = key < k1 ? vrow[key] : (unsigned char)0;
  }
}

// One warp = one unit (batch bb, split sp, kv head kh, head chunk ch):
// the online softmax of GC query heads over the split's keys.
template <typename T, int GC, int VPL>
__global__ void __launch_bounds__(WPC * 32, 2)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int b, int s, int h,
                    int kv, int D, int lpr, int ks, int nsplit, int vec,
                    float softcap, float scale) {
  constexpr int VEC = vec_of<T>();
  constexpr int TR = rows_of(GC, VPL);
  const int g = h / kv, nchunk = g / GC;
  const int items = kv * nchunk;
  const long long unit =
      (long long)blockIdx.x * WPC + threadIdx.x / 32;
  if (unit >= (long long)b * nsplit * items) return;       // whole warp
  const int item = (int)(unit % items);
  const long long rest = unit / items;
  const int sp = (int)(rest % nsplit), bb = (int)(rest / nsplit);
  const int kh = item / nchunk, head0 = kh * g + (item % nchunk) * GC;
  const int lane = threadIdx.x % 32, lig = lane % lpr, grp = lane / lpr;
  const int kpw = 32 / lpr;
  const bool vok = vec != 0;

  // this lane's chunks of the row: chunk lig + c * lpr, elements
  // [e0, e0 + VEC) of which n_ok[c] lie inside the head dim
  int e0[VPL], n_ok[VPL];
#pragma unroll
  for (int c = 0; c < VPL; ++c) {
    e0[c] = (lig + c * lpr) * VEC;
    n_ok[c] = min(max(D - e0[c], 0), VEC);
  }
  float qf[GC][VPL][VEC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    const T* qrow = q + ((long long)bb * h + head0 + gi) * D;
#pragma unroll
    for (int c = 0; c < VPL; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qf[gi][c][e] = e < n_ok[c] ? to_f<T>(qrow[e0[c] + e]) : 0.0f;
  }
  float m[GC], l[GC], acc[GC][VPL][VEC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.0f;
#pragma unroll
    for (int c = 0; c < VPL; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[gi][c][e] = 0.0f;
  }

  const long long k0 = (long long)sp * ks;
  const long long k1 = min(k0 + ks, (long long)s);
  const int tile = kpw * TR;
  const unsigned char* vrow = valid + (long long)bb * s;
  const long long stride = (long long)kv * D;               // one key
  const T* kbase = k + (long long)bb * s * stride + (long long)kh * D;
  const T* vbase = v + (long long)bb * s * stride + (long long)kh * D;
  unsigned char vb[TR], nb[TR];
  load_valid<TR>(vrow, k0, k1, kpw, grp, vb);
  for (long long t0 = k0; t0 < k1; t0 += tile) {
    load_valid<TR>(vrow, t0 + tile, k1, kpw, grp, nb);      // one ahead
    bool any = false;
#pragma unroll
    for (int r = 0; r < TR; ++r) any = any || vb[r] != 0;
    if (__any_sync(0xffffffffu, any)) {
      uint4 kr[TR][VPL], vr[TR][VPL];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const long long off = (t0 + (long long)r * kpw + grp) * stride;
#pragma unroll
        for (int c = 0; c < VPL; ++c) {
          if (vb[r] && n_ok[c] > 0) {
            kr[r][c] = load_chunk<T>(kbase + off + e0[c], n_ok[c], vok);
            vr[r][c] = load_chunk<T>(vbase + off + e0[c], n_ok[c], vok);
          } else {
            kr[r][c] = make_uint4(0u, 0u, 0u, 0u);
            vr[r][c] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      // the tile's logits: partial dots, then a sum over a row's lanes
      float x[GC][TR];
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int gi = 0; gi < GC; ++gi) {
          float dot = 0.0f;
#pragma unroll
          for (int c = 0; c < VPL; ++c)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot = fmaf(qf[gi][c][e], elem<T>(kr[r][c], e), dot);
          x[gi][r] = dot;
        }
      for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int gi = 0; gi < GC; ++gi)
            x[gi][r] += __shfl_xor_sync(0xffffffffu, x[gi][r], o);
      // one max and one rescale a tile
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        float mt = NEG_INF;
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          float xv = x[gi][r] * scale;
          if (softcap > 0.0f) xv = tanhf(xv / softcap) * softcap;
          x[gi][r] = xv;
          if (vb[r]) mt = fmaxf(mt, xv);
        }
        for (int o = lpr; o < 32; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[gi], mt);
        const float corr = (m[gi] == NEG_INF) ? 1.0f : expf(m[gi] - m_new);
        float psum = 0.0f;
#pragma unroll
        for (int c = 0; c < VPL; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[gi][c][e] *= corr;
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const float p = vb[r] ? expf(x[gi][r] - m_new) : 0.0f;
          psum += p;
#pragma unroll
          for (int c = 0; c < VPL; ++c)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[gi][c][e] = fmaf(p, elem<T>(vr[r][c], e), acc[gi][c][e]);
        }
        l[gi] = fmaf(l[gi], corr, psum);
        m[gi] = m_new;
      }
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) vb[r] = nb[r];
  }

  // the lanes of one row position hold the same chunk for different
  // keys: sum l and acc over the 32 / lpr row groups
  for (int o = lpr; o < 32; o <<= 1)
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], o);
#pragma unroll
      for (int c = 0; c < VPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[gi][c][e] += __shfl_xor_sync(0xffffffffu, acc[gi][c][e], o);
    }
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    const long long pr = ((long long)bb * h + head0 + gi) * nsplit + sp;
    if (grp == 0) {
#pragma unroll
      for (int c = 0; c < VPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (e < n_ok[c]) part_acc[pr * D + e0[c] + e] = acc[gi][c][e];
    }
    if (lane == 0) {
      part_m[pr] = m[gi];
      part_l[pr] = l[gi];
    }
  }
}

// One CTA per (batch, query head): the partials in split order.  The
// split weights exp(m_p - M) are computed once into shared memory; the
// denominator and each output element are then sums in split order.
template <typename T>
__global__ void __launch_bounds__(CT)
decode_merge_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out,
                    int D, int nsplit) {
  extern __shared__ float wsm[];                    // [nsplit] weights
  __shared__ float red[CT / 32];
  __shared__ float denom_s;
  const long long row = blockIdx.x;                 // bb * h + head
  const long long p0 = row * nsplit;
  float mx = NEG_INF;
  for (int p = threadIdx.x; p < nsplit; p += CT)
    mx = fmaxf(mx, part_m[p0 + p]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = mx;
  __syncthreads();
  float M = red[0];
  for (int w = 1; w < CT / 32; ++w) M = fmaxf(M, red[w]);
  for (int p = threadIdx.x; p < nsplit; p += CT) {
    const float mp = part_m[p0 + p];
    wsm[p] = (mp == NEG_INF) ? 0.0f : expf(mp - M);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float L = 0.0f;
    for (int p = 0; p < nsplit; ++p) L = fmaf(part_l[p0 + p], wsm[p], L);
    denom_s = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const float denom = denom_s;
  T* o = out + row * D;
  for (int dd = threadIdx.x; dd < D; dd += CT) {
    float a = 0.0f;
    for (int p = 0; p < nsplit; ++p)
      a = fmaf(part_acc[(p0 + p) * D + dd], wsm[p], a);
    o[dd] = from_f<T>(a / denom);
  }
}

// lanes a row takes: the chunks of a row, rounded up to a power of two,
// at most 32 (then each lane holds vpl = chunks / 32 chunks)
__host__ __device__ inline int lanes_per_row(int d, int vec) {
  const int nch = (d + vec - 1) / vec;
  int lpr = 1;
  while (lpr < nch && lpr < 32) lpr <<= 1;
  return lpr;
}

template <typename T, int GC, int VPL>
int launch_split(const void* q, const void* k, const void* v,
                 const unsigned char* valid, float* pm, float* pl,
                 float* pacc, int b, int s, int h, int kv, int D, int lpr,
                 int ks, int nsplit, int vec, float softcap, float scale,
                 cudaStream_t st) {
  const long long units = (long long)b * nsplit * kv * (h / kv / GC);
  const long long blocks = (units + WPC - 1) / WPC;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  decode_split_kernel<T, GC, VPL><<<(unsigned)blocks, WPC * 32, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, valid, pm, pl, pacc, b, s, h,
      kv, D, lpr, ks, nsplit, vec, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, int VPL>
int launch_gc(int gc, const void* q, const void* k, const void* v,
              const unsigned char* valid, float* pm, float* pl, float* pacc,
              int b, int s, int h, int kv, int D, int lpr, int ks,
              int nsplit, int vec, float softcap, float scale,
              cudaStream_t st) {
  if (gc == 4)
    return launch_split<T, 4, VPL>(q, k, v, valid, pm, pl, pacc, b, s, h,
                                   kv, D, lpr, ks, nsplit, vec, softcap,
                                   scale, st);
  if (gc == 2)
    return launch_split<T, 2, VPL>(q, k, v, valid, pm, pl, pacc, b, s, h,
                                   kv, D, lpr, ks, nsplit, vec, softcap,
                                   scale, st);
  return launch_split<T, 1, VPL>(q, k, v, valid, pm, pl, pacc, b, s, h, kv,
                                 D, lpr, ks, nsplit, vec, softcap, scale,
                                 st);
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* valid, float* pm, float* pl, float* pacc,
           void* out, int b, int s, int h, int kv, int D, int gc, int lpr,
           int ks, int nsplit, float softcap, float scale, cudaStream_t st) {
  constexpr int VEC = vec_of<T>();
  const int g = h / kv;
  const int nch = (D + VEC - 1) / VEC;
  const int vpl = (nch + 31) / 32;
  // the host's plan must be the one this source computes
  if (D < 1 || D > MAX_HEAD_DIM || kv < 1 || h % kv != 0 ||
      !(gc == 1 || gc == 2 || gc == 4) || g % gc != 0 ||
      lpr != lanes_per_row(D, VEC) || ks < 1 ||
      ks % ((32 / lpr) * rows_of(gc, vpl)) != 0 ||
      nsplit != (s + ks - 1) / ks)
    return (int)cudaErrorInvalidValue;
  const unsigned long long align =
      (unsigned long long)k | (unsigned long long)v;
  const int vec = (D % VEC == 0) && (align % 16 == 0);
  int err;
  if (vpl == 2)
    err = launch_gc<T, 2>(gc, q, k, v, valid, pm, pl, pacc, b, s, h, kv, D,
                          lpr, ks, nsplit, vec, softcap, scale, st);
  else
    err = launch_gc<T, 1>(gc, q, k, v, valid, pm, pl, pacc, b, s, h, kv, D,
                          lpr, ks, nsplit, vec, softcap, scale, st);
  if (err != 0) return err;
  // nsplit <= the plan's 132 * 16 units, so the weights fit in 8.5 KB
  const size_t wbytes = (size_t)nsplit * sizeof(float);
  decode_merge_kernel<T><<<(unsigned)(b * h), CT, wbytes, st>>>(
      pm, pl, pacc, (T*)out, D, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- plain C entry points (loaded with ctypes) ---------------------------
// q [b, h, d], k/v [b, s, kv, d], out [b, h, d] contiguous, of one dtype
// (0 = float32, 1 = bfloat16); valid [b, s] bytes (0 / 1); scratch
// part_m / part_l [b * h * nsplit] and part_acc [... * d] float32,
// allocated by the caller.  gc, lpr, ks (keys a split, a multiple of the
// tile) and nsplit are the host's plan (decode_plan in
// kernels/decode_attention.py); a plan that differs from this source's
// rules is refused with cudaErrorInvalidValue.  s >= 1, b >= 1.
// Launches both kernels on the caller's stream; returns the cudaError_t
// (0 = success).

extern "C" int da_decode_attention(const void* q, const void* k,
                                   const void* v, const void* valid,
                                   void* part_m, void* part_l,
                                   void* part_acc, void* out, int dtype,
                                   int b, int s, int h, int kv, int d,
                                   int gc, int lpr, int ks, int nsplit,
                                   float softcap, float scale,
                                   void* stream) {
  if (b <= 0 || s <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* vm = (const unsigned char*)valid;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, vm, (float*)part_m,
                                 (float*)part_l, (float*)part_acc, out, b, s,
                                 h, kv, d, gc, lpr, ks, nsplit, softcap,
                                 scale, st);
  return launch<float>(q, k, v, vm, (float*)part_m, (float*)part_l,
                       (float*)part_acc, out, b, s, h, kv, d, gc, lpr, ks,
                       nsplit, softcap, scale, st);
}

extern "C" int da_max_head_dim() { return MAX_HEAD_DIM; }

// keys a lane-row tile covers for this dtype (0 = float32, 1 = bf16),
// head dim and head chunk: the unit the host's split length is a
// multiple of
extern "C" int da_tile_keys(int dtype, int d, int gc) {
  const int vec = dtype == 1 ? 8 : 4;
  const int lpr = lanes_per_row(d, vec);
  const int vpl = ((d + vec - 1) / vec + 31) / 32;
  return (32 / lpr) * rows_of(gc, vpl);
}

extern "C" const char* da_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
