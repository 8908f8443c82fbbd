// Sorted multi-channel segment sum for Hopper (sm_90a).
//
// Port of the Pallas TPU kernel segment_reduce
// (src/repro/kernels/fluid_reduce.py:67, body _reduce_kernel :44): every
// per-queue sum of the fluid step, C channels at once, each segment's
// rows added in row order.  The TPU kernel walks the rows in one
// sequential grid with the [S, C] accumulator resident in VMEM; here
// blocks run in parallel in no order, so each segment's sum is one chain
// of __fadd_rn from +0.0 in row order, owned by one lane, with no
// atomics and no reassociation: the order of every addition is the one
// the plain version (and the reference's sequential scatter) uses, so
// the result is bitwise equal.
//
// rows (optional) fuses the gather into sorted order: entry j of the
// walk reads data row rows[j]; without it the data is already sorted.
//
// Bound on this card: the larger of two terms.  Bytes: each data row
// read once, one int64 index and one offset per row, [S, C] floats
// written.  Chain: the longest segment's adds are dependent, one FADD
// latency each (4-5 clocks; chip_smoke measures it), whatever else runs
// beside them; at a hotspot (2055 rows) that is ~5 us, above the bytes.
// Where every segment is short (the DC walk) the random gather sets the
// time instead: a row of C floats costs one or two whole 32-byte
// sectors, so the walk moves about twice its bytes.
//
// Design (the staged walk).  A schedule built once per CSR on the host
// (kernels/fluid_reduce.py::reduce_schedule) lists work items, one CTA
// each, the long ones first in the grid so they start first:
//   * a long segment (more than LONG_ROWS rows): warps 1..7 gather
//     chunks of kLongChunk rows into a double-buffered shared-memory
//     slot laid out [C][rows] while lane c of warp 0 runs channel c's
//     chain over the previous chunk with 16-byte shared loads issued a
//     batch ahead, so each add waits only on the add before it;
//   * a group of consecutive short segments (at most kChunkRows rows and
//     kThreads segments): every thread loads indices, then data words
//     (one (row, channel) element at a time, so neighbouring lanes share
//     sectors), all in flight at once, into shared memory rows of C
//     floats (3 padded to 4); then one thread a segment, longest first,
//     runs its C chains from there with one vector load a row.
// Each item carries its walk range, so no block waits on the offsets
// before it can start its gather.
// C is a template argument (1, 2, 3: the fluid step's walks) and index
// arithmetic is 32-bit; the wrapper checks that the sizes fit.  Any
// other C, or sizes past 32 bits, take the row walk below (one thread a
// (segment, channel), two dependent global loads a row), also kept as
// the staged walk's yardstick.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// rows a short group stages, and segments it may hold (one thread each)
constexpr int kChunkRows = 2048;
constexpr int kGroupSegs = kThreads;
// a long segment's chunk: 7 gather warps x 32 lanes x 4 rows
constexpr int kGatherThreads = kThreads - 32;
constexpr int kLongRowsPerThread = 4;
constexpr int kLongChunk = kGatherThreads * kLongRowsPerThread;
// rows a chain lane has in flight: 4 float4 on the long path (a chunk
// is zero-padded to a multiple of it), 4 rows on the short path
constexpr int kLongUnroll = 16;
constexpr int kShortUnroll = 4;
static_assert(kLongChunk % kLongUnroll == 0, "chunk must pad to batches");

// ---- the chains -----------------------------------------------------------
// Each loads its next batch of rows before this batch's adds, so an add
// waits only on the add before it, never on a load.

// acc += p[0 .. n) in order, n a multiple of kLongUnroll, p 16-byte
// aligned (one channel of a long chunk).
__device__ __forceinline__ float chain_vec(const float* p, int n,
                                           float acc) {
  const float4* q = reinterpret_cast<const float4*>(p);
  constexpr int B = kLongUnroll / 4;
  const int nq = n / 4;
  float4 cur[B], nxt[B];
  if (nq == 0) return acc;
#pragma unroll
  for (int b = 0; b < B; ++b) cur[b] = q[b];
  for (int i = 0; i < nq; i += B) {
    if (i + B < nq) {
#pragma unroll
      for (int b = 0; b < B; ++b) nxt[b] = q[i + B + b];
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      acc = __fadd_rn(acc, cur[b].x);
      acc = __fadd_rn(acc, cur[b].y);
      acc = __fadd_rn(acc, cur[b].z);
      acc = __fadd_rn(acc, cur[b].w);
      cur[b] = nxt[b];
    }
  }
  return acc;
}

// ---- staging --------------------------------------------------------------

__device__ __forceinline__ int walk_row(const long long* __restrict__ rows,
                                        int j) {
  return rows != nullptr ? (int)rows[j] : j;
}

// Gather walk entries j0 .. j0 + m into slot [C][kLongChunk] (gather
// threads only), zeros up to the next multiple of kLongUnroll.
template <int C>
__device__ __forceinline__ void stage_long(const float* __restrict__ data,
                                           const long long* __restrict__ rows,
                                           int j0, int m, float* slot) {
  const int g = threadIdx.x - 32;
  const int mpad = (m + kLongUnroll - 1) / kLongUnroll * kLongUnroll;
  int idx[kLongRowsPerThread];
#pragma unroll
  for (int k = 0; k < kLongRowsPerThread; ++k) {
    const int i = g + k * kGatherThreads;
    idx[k] = i < m ? walk_row(rows, j0 + i) : -1;
  }
  float v[kLongRowsPerThread][C];
#pragma unroll
  for (int k = 0; k < kLongRowsPerThread; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c)
      v[k][c] = idx[k] >= 0 ? data[idx[k] * C + c] : 0.0f;
#pragma unroll
  for (int k = 0; k < kLongRowsPerThread; ++k) {
    const int i = g + k * kGatherThreads;
    if (i < mpad) {
#pragma unroll
      for (int c = 0; c < C; ++c) slot[c * kLongChunk + i] = v[k][c];
    }
  }
}

// ---- the two kinds of work item -------------------------------------------

template <int C>
__device__ __forceinline__ void long_segment(
    const float* __restrict__ data, const long long* __restrict__ rows,
    const int4 it, float* __restrict__ out, float* buf) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = it.x, j0 = it.z, n = it.w - it.z;
  const int nch = (n + kLongChunk - 1) / kLongChunk;
  if (warp > 0 && nch > 0) stage_long<C>(data, rows, j0, min(n, kLongChunk),
                                         buf);
  __syncthreads();
  float acc = 0.0f;
  for (int k = 0; k < nch; ++k) {
    if (warp > 0) {
      const int nxt = (k + 1) * kLongChunk;
      if (nxt < n)
        stage_long<C>(data, rows, j0 + nxt, min(n - nxt, kLongChunk),
                      buf + ((k + 1) & 1) * C * kLongChunk);
    } else if (lane < C) {
      const int m = min(n - k * kLongChunk, kLongChunk);
      acc = chain_vec(buf + (k & 1) * C * kLongChunk + lane * kLongChunk,
                      (m + kLongUnroll - 1) / kLongUnroll * kLongUnroll,
                      acc);
    }
    __syncthreads();
  }
  if (warp == 0 && lane < C) out[s * C + lane] = acc;
}

// Shared-memory row of a short group: C floats, 3 padded to 4 so that a
// chain lane reads a whole row with one vector load.
template <int C> struct Row;
template <> struct Row<1> {
  using V = float;
  static constexpr int kFloats = 1;
};
template <> struct Row<2> {
  using V = float2;
  static constexpr int kFloats = 2;
};
template <> struct Row<3> {
  using V = float4;
  static constexpr int kFloats = 4;
};

__device__ __forceinline__ float lane_of(float v, int) { return v; }
__device__ __forceinline__ float lane_of(const float2& v, int c) {
  return c == 0 ? v.x : v.y;
}
__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : v.z;
}

// acc[c] += row r's channel c for r in [0, n), in order, reading whole
// rows; the next kShortUnroll rows are loaded before this batch's adds.
template <int C>
__device__ __forceinline__ void chain_rows(const float* p, int n,
                                           float (&acc)[C]) {
  using V = typename Row<C>::V;
  const V* q = reinterpret_cast<const V*>(p);
  constexpr int U = kShortUnroll;
  V cur[U], nxt[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < n) cur[u] = q[u];
  for (int r = 0; r < n; r += U) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + U + u < n) nxt[u] = q[r + U + u];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u < n) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = __fadd_rn(acc[c], lane_of(cur[u], c));
      }
      cur[u] = nxt[u];
    }
  }
}

// Lane p of a short group runs segment s0 + lanes[s0 + p]: the builder
// orders each group's segments longest first, so a warp's lanes walk
// chains of similar length.  A thread's offsets are read before the
// staging so their latency hides behind it.
template <int C>
__device__ __forceinline__ void short_group(
    const float* __restrict__ data, const long long* __restrict__ rows,
    const long long* __restrict__ off, const unsigned char* __restrict__ lanes,
    const int4 it, float* __restrict__ out, float* buf) {
  constexpr int RF = Row<C>::kFloats;
  // one element (row, channel) a thread at a time, so a warp's loads of
  // neighbouring channels share sectors
  constexpr int kPerThread = kChunkRows * C / kThreads;
  const int tid = threadIdx.x;
  const int s0 = it.x, ns = it.y - it.x, r0 = it.z, nr = it.w - it.z;
  if (nr > kChunkRows || ns > kGroupSegs) __trap();  // bad schedule
  int s = -1, lo = 0, hi = 0;
  if (tid < ns) {
    s = s0 + lanes[s0 + tid];
    lo = (int)off[s] - r0;
    hi = (int)off[s + 1] - r0;
  }
  const int ne = nr * C;
  int at[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = tid + k * kThreads;
    const int row = e / C;
    at[k] = e < ne ? walk_row(rows, r0 + row) * C + (e - row * C) : -1;
  }
  float v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) v[k] = at[k] >= 0 ? data[at[k]] : 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = tid + k * kThreads;
    const int row = e / C;
    if (e < ne) buf[row * RF + (e - row * C)] = v[k];
  }
  __syncthreads();
  if (s >= 0) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    chain_rows<C>(buf + lo * RF, hi - lo, acc);
#pragma unroll
    for (int c = 0; c < C; ++c) out[s * C + c] = acc[c];
  }
}

// items[b] = (first segment, end segment, first walk entry, end walk
// entry); items[0 .. n_long) are single long segments, the rest short
// groups.
template <int C>
__global__ void __launch_bounds__(kThreads)
    staged_kernel(const float* __restrict__ data,
                  const long long* __restrict__ rows,
                  const long long* __restrict__ off,
                  const int4* __restrict__ items,
                  const unsigned char* __restrict__ lanes, int n_long,
                  float* __restrict__ out) {
  constexpr int kShort = kChunkRows * Row<C>::kFloats;
  constexpr int kLong = 2 * C * kLongChunk;
  __shared__ __align__(16) float buf[kShort > kLong ? kShort : kLong];
  const int4 it = items[blockIdx.x];
  if ((int)blockIdx.x < n_long)
    long_segment<C>(data, rows, it, out, buf);
  else
    short_group<C>(data, rows, off, lanes, it, out, buf);
}

// The card's latency of one dependent __fadd_rn, in clocks: one thread
// adds n values in a chain (the chain term of the staged walk's bound).
__global__ void fadd_chain_kernel(const float* __restrict__ x, int n,
                                  long long* __restrict__ clocks,
                                  float* __restrict__ sum) {
  const float a = x[0], b = x[1];
  float acc = a;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, b);
  const long long t1 = clock64();
  *sum = acc;
  *clocks = t1 - t0;
}

// ---- the row walk (generic C, 64-bit sizes) -------------------------------

__global__ void rowwalk_kernel(const float* __restrict__ data,
                               const long long* __restrict__ rows,
                               const long long* __restrict__ off,
                               long long n_seg, int C,
                               float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_seg * C) return;
  const long long s = i / C;
  const int c = (int)(i - s * C);
  const long long j0 = off[s], j1 = off[s + 1];
  float acc = 0.0f;
  if (rows != nullptr) {
#pragma unroll 8
    for (long long j = j0; j < j1; ++j)
      acc = __fadd_rn(acc, data[rows[j] * C + c]);
  } else {
#pragma unroll 8
    for (long long j = j0; j < j1; ++j)
      acc = __fadd_rn(acc, data[j * C + c]);
  }
  out[i] = acc;
}

}  // namespace

// ---- plain C entry points (loaded with ctypes) ----------------------------
// data [M, C] f32, rows [N] int64 (or null: M = N, already sorted),
// off [n_seg + 1] int64 ascending CSR offsets into the walk,
// out [n_seg, C] f32.  Each launches on the caller's stream and returns
// the cudaError_t of the launch (0 = success).

// The staged walk: items [n_items, 4] int32 and lanes [n_seg] uint8 from
// reduce_schedule, the first n_long items long segments; C in {1, 2, 3};
// M * C, N and n_seg * C below 2^31 (the wrapper checks both).
extern "C" int fr_segment_reduce(const float* data, const long long* rows,
                                 const long long* off, long long C,
                                 const int* items, const unsigned char* lanes,
                                 long long n_items, long long n_long,
                                 float* out, void* stream) {
  if (n_items <= 0) return 0;
  const int4* it = reinterpret_cast<const int4*>(items);
  const dim3 grid((unsigned int)n_items);
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      staged_kernel<1><<<grid, kThreads, 0, st>>>(data, rows, off, it, lanes,
                                                 (int)n_long, out);
      break;
    case 2:
      staged_kernel<2><<<grid, kThreads, 0, st>>>(data, rows, off, it, lanes,
                                                 (int)n_long, out);
      break;
    case 3:
      staged_kernel<3><<<grid, kThreads, 0, st>>>(data, rows, off, it, lanes,
                                                 (int)n_long, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Clocks of n dependent adds in one thread (x: two floats; clocks: one
// int64; sum: one float).
extern "C" int fr_fadd_clocks(const float* x, long long n, long long* clocks,
                              float* sum, void* stream) {
  if (n <= 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  fadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x, (int)n, clocks,
                                                       sum);
  return (int)cudaGetLastError();
}

// The row walk: any C, 64-bit sizes.
extern "C" int fr_segment_reduce_rowwalk(const float* data,
                                         const long long* rows,
                                         const long long* off,
                                         long long n_seg, long long C,
                                         float* out, void* stream) {
  const long long n = n_seg * C;
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  rowwalk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, rows, off, n_seg, (int)C, out);
  return (int)cudaGetLastError();
}

extern "C" const char* fr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
