// Sorted multi-channel segment sum for Hopper (sm_90a).
//
// Port of the Pallas TPU kernel segment_reduce
// (src/repro/kernels/fluid_reduce.py:67, body _reduce_kernel :44): every
// per-queue sum of the fluid step, C channels at once, each segment's
// rows added in row order.  The TPU kernel walks the rows in one
// sequential grid with the [S, C] accumulator resident in VMEM; here
// blocks run in parallel in no order, so the walk is turned inside out:
// one thread per (segment, channel) walks its segment's CSR range
// off[s] .. off[s+1] in row order, starting from +0.0, with no atomics.
// The order of every addition is the one the plain version (and the
// reference's sequential scatter) uses, so the result is bitwise equal.
//
// rows (optional) fuses the gather into sorted order: entry j of the
// walk reads data row rows[j]; without it the data is already sorted.
//
// Bound on this card: bytes.  The sum reads each data row once, one
// index and one offset per row (8 B each), and writes [S, C] floats; it
// does one add per row and channel.  What this design pays instead is
// latency: a segment's adds form one dependent chain, so the longest
// segment (74 rows at the DC cell, thousands under a hotspot) sets the
// time, not the bytes.  The row loop is unrolled so several rows' loads
// are in flight ahead of the chain of adds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void segment_reduce_kernel(const float* __restrict__ data,
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

// ---- plain C entry point (loaded with ctypes) ----------------------------
// data [M, C] f32, rows [N] int64 (or null: M = N, already sorted),
// off [n_seg + 1] int64 ascending CSR offsets into the walk,
// out [n_seg, C] f32.  Launches on the caller's stream and returns the
// cudaError_t of the launch (0 = success).

extern "C" int fr_segment_reduce(const float* data, const long long* rows,
                                 const long long* off, long long n_seg,
                                 long long C, float* out, void* stream) {
  const long long n = n_seg * C;
  if (n <= 0) return 0;
  const unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  segment_reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, rows, off, n_seg, (int)C, out);
  return (int)cudaGetLastError();
}

extern "C" const char* fr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
