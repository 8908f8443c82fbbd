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
// card's ~295 flops a byte.  So the lever is to read each K/V row once
// and keep enough bytes in flight from every SM.  Two kernels do that,
// the host's plan (kernels/decode_attention.py::decode_plan) choosing by
// shape, then a merge kernel.  One wrapper launch counts one.
//
// The split kernel (decode_split_kernel; float32, and bf16 at g < 6 or a
// d outside {64, 128, 256}: gemma2's g 2, deepseek's and whisper's g 1):
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
//    head, chunk of GC of its g query heads).  The plan picks the split
//    length, a multiple of the tile, so that the units fill every SM
//    once (132 SMs x 16 warps); a CTA's 8 warps are neighbouring kv heads
//    of one (batch, split), which read one contiguous span of the cache.
//    Each K/V row is loaded by g / GC warps.
//
// The group kernel (decode_group_kernel; bf16 at g 6-16 and d in {64,
// 128, 256}: recurrentgemma's g 16, d 256; starcoder2's g 12, mixtral's
// and internvl2's g 6, d 128).
// At g 16 a cache byte carries 16 flops and the float32 FMA pipe gives
// 20 a byte, so a CUDA-core kernel would sit near its operation ceiling;
// and at b x kv = 2 the split kernel cut 2048 keys into 256 splits of 8,
// loading each row 4 times and writing partials twice the cache's
// bytes.  So:
//  * One CTA of 4 warps takes a (batch, kv head, split) with all g query
//    heads: each K/V row is loaded once, by cp.async (16 bytes a lane)
//    into a 3-stage ring of 64-key tiles in swizzled shared memory.  The
//    copies never wait on the valid mask: each warp reads its own keys'
//    valid bytes a tile ahead, masks their logits and zeroes their V
//    rows in shared memory (only where a slot is invalid), so an invalid
//    slot's row meets only zero weights whatever the cache holds.
//  * Both products on the tensor cores, mma.sync m16n8k16 bf16 -> f32:
//    the g heads are one M of 16 rows (zeros past g), so S = Q K^T is
//    two n-tiles of 8 keys a warp (each warp 16 keys of a tile), and
//    O += P V takes P from the S registers, rounded to bf16, against V
//    read with ldmatrix.trans.  Each warp keeps its own float32 (m, l, O)
//    per head; the 4 warps merge in warp order at the end.
//  * The plan cuts far fewer, longer splits: about one CTA an SM, splits
//    a multiple of 64 keys, so the partials (g x (d + 2) floats a split)
//    stay near g / 64 of the split's K/V bytes (32 splits of 64
//    keys, 1.06 of 4.19 MB, at recurrentgemma's 2048-slot ring, b 2).
//    With one split the group kernel writes the output itself.
//
// Merge.  Each unit writes its partial (m, l, acc); the merge kernel,
// one CTA a (batch, query head, 64 output elements), walks the partials
// in split order, every thread forming the weights and denominator in
// the same order (no atomics: two runs give the same bits).  After the
// group kernel it is a programmatic dependent launch.
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
#include <stdint.h>

namespace {

constexpr int WPC = 8;          // warps per CTA of the split kernel
constexpr int MAX_HEAD_DIM = 256;
constexpr int MT = 64;          // threads (output elements) of a merge CTA
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

// One CTA per (batch, query head, MT output elements): the partials in
// split order.  The split weights exp(m_p - M) and the l_p are staged in
// shared memory (one load latency, not one a split); every thread then
// forms the denominator in split order, so all agree bit for bit, and
// each output element is a sum in split order whose loads are issued 8
// at a time, the last < 8 predicated, so a walk of n splits waits on
// about n / 8 load latencies (on the H100 this measured faster than a
// loop unrolled 16, whose remainder runs one load at a time, and than
// predicated batches of 16).  No atomics: two runs give the same bits.
template <typename T>
__global__ void __launch_bounds__(MT)
decode_merge_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out,
                    int D, int nsplit) {
  extern __shared__ float wsm[];                    // [nsplit] weights
  float* const lsm = wsm + nsplit;                  // [nsplit] l
  // after a programmatic dependent launch, wait here until the first
  // kernel has finished and its partials are visible (else a no-op)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long row = blockIdx.x;                 // bb * h + head
  const long long p0 = row * nsplit;
  const int dd = blockIdx.y * MT + threadIdx.x;
  for (int p = threadIdx.x; p < nsplit; p += MT) {
    wsm[p] = part_m[p0 + p];
    lsm[p] = part_l[p0 + p];
  }
  __syncthreads();
  float M = NEG_INF;
  for (int p = 0; p < nsplit; ++p) M = fmaxf(M, wsm[p]);
  __syncthreads();                                  // all have read m
  for (int p = threadIdx.x; p < nsplit; p += MT) {
    const float mp = wsm[p];
    wsm[p] = (mp == NEG_INF) ? 0.0f : expf(mp - M);
  }
  __syncthreads();
  if (dd >= D) return;
  float L = 0.0f, a = 0.0f;
  for (int p = 0; p < nsplit; ++p) L = fmaf(lsm[p], wsm[p], L);
  const float* src = part_acc + p0 * D + dd;
  int p = 0;
  for (; p + 8 <= nsplit; p += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = src[(long long)(p + u) * D];
#pragma unroll
    for (int u = 0; u < 8; ++u) a = fmaf(x[u], wsm[p + u], a);
  }
  if (p < nsplit) {                                 // the last < 8 splits
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = p + u < nsplit ? src[(long long)(p + u) * D] : 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (p + u < nsplit) a = fmaf(x[u], wsm[p + u], a);
  }
  out[row * D + dd] = from_f<T>(a / fmaxf(L, 1e-30f));
}

// dependent: a programmatic dependent launch, for the group kernel, which
// lets the merge CTAs be scheduled at its start; they wait for it in
// griddepcontrol.wait, so the launch latency between the two overlaps
// its run.  After the split kernel, whose CTAs fill the SMs, early merge
// CTAs measured slower on the H100 than a plain launch, which it keeps.
template <typename T>
int launch_merge(const float* pm, const float* pl, const float* pacc,
                 void* out, int b, int h, int D, int nsplit,
                 bool dependent, cudaStream_t st) {
  // nsplit <= the split plan's 132 * 16 warps, so the staged weights
  // and l take at most 17 KB
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * h), (unsigned)((D + MT - 1) / MT));
  cfg.blockDim = dim3(MT);
  cfg.dynamicSmemBytes = 2 * (size_t)nsplit * sizeof(float);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_merge_kernel<T>, pm, pl, pacc, (T*)out, D, nsplit);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
  return launch_merge<T>(pm, pl, pacc, out, b, h, D, nsplit, false, st);
}

// ---------------------------------------------------------------------------
// The group kernel: bfloat16, d in {64, 128, 256}, all g <= 16 query heads
// of a kv head in one CTA, both products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int GW = 4;            // warps of a group CTA
constexpr int GT = GW * 32;      // its threads
constexpr int GK = 64;           // keys a tile: 16 a warp
constexpr int GM = 16;           // query-head rows of the mma (g <= GM)
constexpr int G_STAGES = 3;      // depth of the K/V ring

// Dynamic shared memory of a group CTA at head dim D: Q (GM rows) and
// the ring of G_STAGES (K tile + V tile) of GK rows.  At d 256: 8,192 +
// 3 * 65,536 = 204,800 B of the 232,448 a block may use (a fourth stage
// would not fit).  The warps' partials reuse the ring once the walk is
// done.
__host__ __device__ constexpr int group_smem_bytes(int D) {
  return GM * D * 2 + G_STAGES * 2 * GK * D * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, zero-filled where !valid (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// four 8x8 bf16 matrices, one row address a lane (lanes 8i..8i+7: matrix
// i); .trans hands each lane a column pair instead of a row pair
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
// c += a . b: m16n8k16, bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One CTA = one (batch bb, kv head kh, split sp): the online softmax of
// all g query heads over the split's keys.  Warp w takes keys
// [16 w, 16 w + 16) of every 64-key tile with its own (m, l, O) for the
// 16 head rows; at the end the 4 warps merge in warp order into the
// split's partial (or, with one split, the output).  Rows are swizzled
// in shared memory (16-byte chunk c of row r at (c ^ (r % 8)) * 16 B) so
// every ldmatrix and cp.async is free of bank conflicts.
template <int D>
__global__ void __launch_bounds__(GT, 1)
decode_group_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc,
                    __nv_bfloat16* __restrict__ out, int s, int h, int kv,
                    int ks, int nsplit, float softcap, float scale) {
  static_assert(D == 64 || D == 128 || D == 256, "group kernel: d");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int CPR = D / 8;               // 16-byte chunks a row
  constexpr int ROW = D * 2;               // bytes a row
  constexpr int TILE = GK * ROW;           // bytes of a K or V tile
  constexpr int NO = D / 8;                // 8-column n-tiles of O
  constexpr int WS = D + 8;                // row stride of the warp partials
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const ring = smem + GM * ROW;
  const uint32_t qs = smem_u32(smem), rs0 = smem_u32(ring);

  const int g = h / kv;
  const int sp = blockIdx.x % nsplit, bk = blockIdx.x / nsplit;
  const int bb = bk / kv, kh = bk % kv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4, grow = lane / 4;     // fragment column pair, row
  const int mi = lane / 8, r8 = lane % 8;         // ldmatrix: matrix, row
  const long long k0 = (long long)sp * ks;
  const long long k1 = min(k0 + (long long)ks, (long long)s);
  const int ntiles = (int)((k1 - k0 + GK - 1) / GK);
  const long long kstride = (long long)kv * D;    // elements between keys
  const __nv_bfloat16* const kb = k + ((long long)bb * s * kv + kh) * D;
  const __nv_bfloat16* const vb = v + ((long long)bb * s * kv + kh) * D;
  const unsigned char* const vrow = valid + (long long)bb * s;

  // Q's g rows (zeros past g) by cp.async, in the first copy group with
  // tile 0, so their latencies overlap
  for (int i = tid; i < GM * CPR; i += GT) {
    const int r = i / CPR, c = i % CPR;
    cp_async16(qs + r * ROW + ((c ^ (r & 7)) * 16),
               q + ((long long)bb * h + kh * g + (r < g ? r : 0)) * D + c * 8,
               r < g);
  }

  // tile j of the split into stage j % G_STAGES: its K and V rows by
  // cp.async, rows past the split zero-filled (never read).  A thread
  // copies chunk cl of rows rl + u * RS, so its addresses step by a
  // constant; no copy waits on the valid mask.
  constexpr int RS = GT / CPR;             // rows a pass: 16, 8 or 4
  const int cl = tid % CPR, rl = tid / CPR;
  auto load_tile = [&](int j) {
    const int st = j % G_STAGES;
    const uint32_t kd = rs0 + st * 2 * TILE, vd = kd + TILE;
    const long long t0 = k0 + (long long)j * GK + rl;
    const long long off = t0 * kstride + cl * 8;
#pragma unroll
    for (int u = 0; u < GK / RS; ++u) {
      const int r = rl + u * RS;
      const bool in = t0 + u * RS < k1;
      const long long o = in ? off + (long long)u * RS * kstride : 0;
      const uint32_t dst = r * ROW + ((cl ^ (r & 7)) * 16);
      cp_async16(kd + dst, kb + o, in);
      cp_async16(vd + dst, vb + o, in);
    }
  };
  // the valid bytes of this lane's four keys of tile j (its S columns:
  // 2 quad, 2 quad + 1, 8 + 2 quad, 9 + 2 quad of the warp's 16), 0 past
  // the split; read a tile ahead of their use
  auto load_valid = [&](int j, unsigned char (&vb4)[4]) {
    const long long t0 = k0 + (long long)j * GK + warp * 16 + quad * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long key = t0 + (e >> 1) * 8 + (e & 1);
      vb4[e] = (j < ntiles && key < k1) ? vrow[key] : (unsigned char)0;
    }
  };
#pragma unroll
  for (int j = 0; j < G_STAGES - 1; ++j) {
    if (j < ntiles) load_tile(j);
    cp_async_commit();
  }
  unsigned char vcur[4], vnext[4];
  load_valid(0, vcur);

  // this lane's fragments: head rows grow and grow + 8, columns 2 quad
  // and 2 quad + 1 of each 8-wide n-tile
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j < ntiles; ++j) {
    load_valid(j + 1, vnext);
    // tile j has landed for every thread, and every warp is past tile
    // j - 1, whose stage takes tile j + G_STAGES - 1
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();
    if (j + G_STAGES - 1 < ntiles) load_tile(j + G_STAGES - 1);
    cp_async_commit();
    const int st = j % G_STAGES;
    const uint32_t kt = rs0 + st * 2 * TILE, vt = kt + TILE;

    // S = Q K^T for the warp's 16 keys: two n-tiles of 8 keys, the
    // k-steps alternating between two accumulators (shorter chains)
    float sa[2][4], sb[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[n][e] = sb[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk4[4];
      {
        const int r = (mi & 1) * 8 + r8, c = 2 * kk + (mi >> 1);
        ldsm_x4(a, qs + r * ROW + ((c ^ (r & 7)) * 16));
      }
      {
        const int r = warp * 16 + (mi >> 1) * 8 + r8, c = 2 * kk + (mi & 1);
        ldsm_x4(bk4, kt + r * ROW + ((c ^ (r & 7)) * 16));
      }
      if (kk & 1) {
        mma_bf16(sb[0], a, bk4[0], bk4[1]);
        mma_bf16(sb[1], a, bk4[2], bk4[3]);
      } else {
        mma_bf16(sa[0], a, bk4[0], bk4[1]);
        mma_bf16(sa[1], a, bk4[2], bk4[3]);
      }
    }

    // logits: scale, softcap, then the online softmax over valid slots
    float x[2][4], rmax[2] = {NEG_INF, NEG_INF};
    bool ok[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float xv = (sa[n][e] + sb[n][e]) * scale;
        if (softcap > 0.0f) xv = tanhf(xv / softcap) * softcap;
        ok[n][e] = vcur[n * 2 + (e & 1)] != 0;
        x[n][e] = xv;
        if (ok[n][e]) rmax[e >> 1] = fmaxf(rmax[e >> 1], xv);
      }
    float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
      const float m_new = fmaxf(m[r], rmax[r]);
      corr[r] = m[r] == NEG_INF ? 1.0f : expf(m[r] - m_new);
      m[r] = m_new;
    }
    float p[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[n][e] = ok[n][e] ? expf(x[n][e] - m[e >> 1]) : 0.0f;
        psum[e >> 1] += p[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], psum[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // the V rows of this warp's invalid slots (rare: a ring not yet
    // full) to zeros, as the TPU kernel zeroes them, so that whatever the
    // cache holds there meets only zero weights; lanes 0-3 hold all 16
    // keys' valid bytes
    unsigned bad = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned m4 = __ballot_sync(0xffffffffu, lane < 4 && !vcur[e]);
#pragma unroll
      for (int qd = 0; qd < 4; ++qd)
        if (m4 >> qd & 1u) bad |= 1u << ((e >> 1) * 8 + qd * 2 + (e & 1));
    }
    while (bad) {
      const int key = warp * 16 + __ffs(bad) - 1;
      bad &= bad - 1;
      for (int c = lane; c < CPR; c += 32)
        *reinterpret_cast<uint4*>(ring + st * 2 * TILE + TILE + key * ROW
                                  + c * 16) = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
    // O += P V: P (rounded to bf16, as the TPU kernel rounds the weights
    // to q's dtype) is the A fragment as it lies in the S registers
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                            pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]),
                            pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bv[4];
      const int r = warp * 16 + (mi & 1) * 8 + r8, c = 2 * dn + (mi >> 1);
      ldsm_x4_t(bv, vt + r * ROW + ((c ^ (r & 7)) * 16));
      mma_bf16(o[2 * dn], pa, bv[0], bv[1]);
      mma_bf16(o[2 * dn + 1], pa, bv[2], bv[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) vcur[e] = vnext[e];
  }

  // every warp is past its last tile and every copy has landed: the ring
  // holds the warps' partials [GW][GM][WS], then m, l, the merge weights
  // and each head's (M, L)
  cp_async_wait<0>();
  __syncthreads();
  float* const wo = reinterpret_cast<float*>(ring);
  float* const wm = wo + GW * GM * WS;
  float* const wl = wm + GW * GM;
  float* const ww = wl + GW * GM;
  float* const hm = ww + GW * GM;
  float* const hl = hm + GM;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* const mine = wo + warp * GM * WS;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(mine + grow * WS + n * 8 + quad * 2) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(mine + (grow + 8) * WS + n * 8 + quad * 2) =
        make_float2(o[n][2], o[n][3]);
  }
  if (quad == 0) {
    wm[warp * GM + grow] = m[0];
    wl[warp * GM + grow] = l[0];
    wm[warp * GM + grow + 8] = m[1];
    wl[warp * GM + grow + 8] = l[1];
  }
  __syncthreads();
  if (tid < GM) {
    float M = NEG_INF, L = 0.0f;
#pragma unroll
    for (int w = 0; w < GW; ++w) M = fmaxf(M, wm[w * GM + tid]);
#pragma unroll
    for (int w = 0; w < GW; ++w) {
      const float mw = wm[w * GM + tid];
      const float wt = (mw == NEG_INF) ? 0.0f : expf(mw - M);
      ww[w * GM + tid] = wt;
      L = fmaf(wl[w * GM + tid], wt, L);
    }
    hm[tid] = M;
    hl[tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < g * D; i += GT) {
    const int r = i / D, c = i % D;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < GW; ++w)
      a = fmaf(wo[(w * GM + r) * WS + c], ww[w * GM + r], a);
    const long long row = (long long)bb * h + kh * g + r;
    if (nsplit == 1) {
      out[row * D + c] = __float2bfloat16_rn(a / fmaxf(hl[r], 1e-30f));
    } else {
      const long long pr = row * nsplit + sp;
      part_acc[pr * D + c] = a;
      if (c == 0) {
        part_m[pr] = hm[r];
        part_l[pr] = hl[r];
      }
    }
  }
}

template <int D>
int launch_group(const void* q, const void* k, const void* v,
                 const unsigned char* valid, float* pm, float* pl,
                 float* pacc, void* out, int b, int s, int h, int kv,
                 int ks, int nsplit, float softcap, float scale,
                 cudaStream_t st) {
  const int bytes = group_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_group_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)b * kv * nsplit;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  decode_group_kernel<D><<<(unsigned)ctas, GT, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, valid, pm, pl, pacc, (__nv_bfloat16*)out, s,
      h, kv, ks, nsplit, softcap, scale);
  const int e = (int)cudaGetLastError();
  if (e != 0 || nsplit == 1) return e;
  return launch_merge<__nv_bfloat16>(pm, pl, pacc, out, b, h, D, nsplit,
                                     true, st);
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

// The group kernel: q [b, h, d], k/v [b, s, kv, d], out [b, h, d]
// contiguous bfloat16 at 16-byte aligned addresses, d in {64, 128, 256},
// g = h / kv <= 16; valid as above.  ks (keys a split, a multiple of
// da_group_tile_keys()) and nsplit are the host's plan; with nsplit > 1
// the partials (scratch as above) are merged by the merge kernel, with
// nsplit == 1 the group kernel writes out itself.  A plan or a tensor
// this source does not take is refused with cudaErrorInvalidValue.
extern "C" int da_decode_attention_group(const void* q, const void* k,
                                         const void* v, const void* valid,
                                         void* part_m, void* part_l,
                                         void* part_acc, void* out, int b,
                                         int s, int h, int kv, int d,
                                         int ks, int nsplit, float softcap,
                                         float scale, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  const unsigned long long align =
      (unsigned long long)q | (unsigned long long)k |
      (unsigned long long)v | (unsigned long long)out;
  if (!(d == 64 || d == 128 || d == 256) || kv < 1 || h % kv != 0 ||
      h / kv > GM || ks < GK || ks % GK != 0 ||
      nsplit != (s + ks - 1) / ks || align % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* vm = (const unsigned char*)valid;
  float *pm = (float*)part_m, *pl = (float*)part_l, *pa = (float*)part_acc;
  if (d == 256)
    return launch_group<256>(q, k, v, vm, pm, pl, pa, out, b, s, h, kv, ks,
                             nsplit, softcap, scale, st);
  if (d == 128)
    return launch_group<128>(q, k, v, vm, pm, pl, pa, out, b, s, h, kv, ks,
                             nsplit, softcap, scale, st);
  return launch_group<64>(q, k, v, vm, pm, pl, pa, out, b, s, h, kv, ks,
                          nsplit, softcap, scale, st);
}

// keys a tile of the group kernel: the unit its split length is a
// multiple of
extern "C" int da_group_tile_keys() { return GK; }

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
