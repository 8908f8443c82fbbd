// Per-flow congestion-control kernels for Hopper (sm_90a).
//
// Port of the four Pallas TPU kernels in repro/kernels/cc_step.py:
//   cc_gen_np_step  <- gen_np_step  (_gen_np_kernel, cc_step.py:118)
//   cc_rp_step      <- rp_step      (_rp_kernel,     cc_step.py:153)
//   cc_erp_step     <- erp_step     (_erp_kernel,    cc_step.py:225)
//   cc_swift_step   <- swift_step   (_swift_kernel,  cc_step.py:256)
//
// Every kernel is elementwise over the flattened [R * F] (run, flow)
// batch: one thread per flow, reading its run's float32 parameter row
// at par + (i / F) * par_stride (par_stride = 0 shares one row across
// the batch).  A Sweep therefore advances every run of a stage in ONE
// launch per step, whatever the parameter grid.
//
// Bound on this card: bytes.  Each flow reads and writes a handful of
// float32 state words and does ~20 flops, so the kernels sit far below
// the H100's ridge point; the least time is (bytes moved) / 3.35 TB/s:
//   gen_np 52 B/flow, rp 68 B/flow, erp 28 B/flow, swift 20 B/flow
// (inputs read once, outputs written once).  At the main-path batch
// (R = 36, F = 4096) that is 1-3 us, below the ~2-4 us a launch costs,
// so launch latency dominates.  The design keeps each launch to one
// pass over its state: neighbouring threads touch neighbouring words
// (coalesced 4-byte loads), every intermediate stays in registers, and
// the parameter row is one L1/L2-resident read per thread.
//
// Rounding: the parity contract holds these kernels BITWISE equal to
// their plain PyTorch versions (repro_torch/kernels/cc_step.py).  The
// per-flow arithmetic lives in cc_device.cuh, shared with the whole-step
// megakernel (fluid_step.cu), where every operation is an explicit
// round-to-nearest intrinsic.  Build without --use_fast_math.

#include <cuda_runtime.h>

#include "cc_device.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long flat_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// ---- fused generation + notification-timer tick ------------------------
// par row: (t_sec, dt)
__global__ void gen_np_kernel(const float* __restrict__ par,
                              long long par_stride, long long F,
                              long long n,
                              const float* __restrict__ nicq,
                              const float* __restrict__ offered,
                              const float* __restrict__ dropped,
                              const float* __restrict__ np_tmr,
                              const float* __restrict__ gen_rate,
                              const float* __restrict__ t_start,
                              const float* __restrict__ t_stop,
                              const float* __restrict__ volume,
                              const float* __restrict__ nic_buffer,
                              float* __restrict__ o_nicq,
                              float* __restrict__ o_off,
                              float* __restrict__ o_drop,
                              float* __restrict__ o_tmr) {
  long long i = flat_index();
  if (i >= n) return;
  const float* p = par + (i / F) * par_stride;
  const cc::GenNp o = cc::gen_np_flow(
      p[0], p[1], cc::GenNp{nicq[i], offered[i], dropped[i], np_tmr[i]},
      gen_rate[i], t_start[i], t_stop[i], volume[i], nic_buffer[i]);
  o_nicq[i] = o.nicq;
  o_off[i] = o.offered;
  o_drop[i] = o.dropped;
  o_tmr[i] = o.np_tmr;
}

// ---- DCQCN reaction point ----------------------------------------------
// par row: (g, rate_decrease, timer_T, byte_B, rai, rhai, fr_stages,
//           min_rate, line_rate, dt)
__global__ void rp_kernel(const float* __restrict__ par,
                          long long par_stride, long long F, long long n,
                          const float* __restrict__ rate_in,
                          const float* __restrict__ target_in,
                          const float* __restrict__ alpha_in,
                          const float* __restrict__ byte_cnt_in,
                          const float* __restrict__ tmr_in,
                          const float* __restrict__ alpha_tmr_in,
                          const float* __restrict__ bc_stage_in,
                          const float* __restrict__ t_stage_in,
                          const float* __restrict__ cnp_in,
                          float* __restrict__ o_rate,
                          float* __restrict__ o_target,
                          float* __restrict__ o_alpha,
                          float* __restrict__ o_byte_cnt,
                          float* __restrict__ o_tmr,
                          float* __restrict__ o_alpha_tmr,
                          float* __restrict__ o_bc_stage,
                          float* __restrict__ o_t_stage) {
  long long i = flat_index();
  if (i >= n) return;
  const float* p = par + (i / F) * par_stride;
  const cc::RP o = cc::rp_flow(
      p, cc::RP{rate_in[i], target_in[i], alpha_in[i], byte_cnt_in[i],
                tmr_in[i], alpha_tmr_in[i], bc_stage_in[i], t_stage_in[i]},
      cnp_in[i] > 0.0f);
  o_rate[i] = o.rate;
  o_target[i] = o.target;
  o_alpha[i] = o.alpha;
  o_byte_cnt[i] = o.byte_cnt;
  o_tmr[i] = o.tmr;
  o_alpha_tmr[i] = o.alpha_tmr;
  o_bc_stage[i] = o.bc_stage;
  o_t_stage[i] = o.t_stage;
}

// ---- the paper's ERP ----------------------------------------------------
// par row: (settle, hold, min_rate, line_rate, dt)
__global__ void erp_kernel(const float* __restrict__ par,
                           long long par_stride, long long F, long long n,
                           const float* __restrict__ rate_in,
                           const float* __restrict__ hold_in,
                           const float* __restrict__ cnp_in,
                           const float* __restrict__ tgt_rx,
                           const float* __restrict__ slope,
                           float* __restrict__ o_rate,
                           float* __restrict__ o_hold) {
  long long i = flat_index();
  if (i >= n) return;
  const float* p = par + (i / F) * par_stride;
  float rate = rate_in[i], hold = hold_in[i];
  cc::erp_flow(p, rate, hold, cnp_in[i] > 0.0f, tgt_rx[i], slope[i]);
  o_rate[i] = rate;
  o_hold[i] = hold;
}

// ---- delay-target reaction (Swift-like) ---------------------------------
// par row: (target, beta, ai, guard, min_rate, line_rate, dt)
//
// At the main-path batch the kernel moves 2.95 MB, so a launch's fixed
// cost, not the bytes, sets its time: chip_smoke times an empty kernel
// and a three-in two-out copy at this grid beside it.  One thread a flow
// (576 blocks at 36 x 4096 flows: one resident wave), 32-bit index
// arithmetic (one unsigned division for the run), the state loads issued
// before the parameter row is read.  On the H100, four flows a thread
// with 16-byte loads measured slower (fewer warps to hide swift_flow's
// dependent arithmetic behind the loads), as did two flows, other block
// sizes and a grid-stride loop.  The per-flow arithmetic is
// cc::swift_flow, shared with the megakernel.
__global__ void swift_kernel(const float* __restrict__ par, int par_stride,
                             unsigned int F, unsigned int n,
                             const float* __restrict__ rate_in,
                             const float* __restrict__ cool_in,
                             const float* __restrict__ qdelay,
                             float* __restrict__ o_rate,
                             float* __restrict__ o_cool) {
  const unsigned int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float rate = rate_in[i], cool = cool_in[i];
  const float qd = qdelay[i];
  const float* __restrict__ row = par + (size_t)(i / F) * par_stride;
  float p[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) p[k] = row[k];
  cc::swift_flow(p, rate, cool, qd);
  o_rate[i] = rate;
  o_cool[i] = cool;
}

// The yardsticks of one launch at swift's grid (chip_smoke's floor
// columns): a kernel that does nothing, and one that reads three [n]
// float32 arrays and writes two, one word each a thread.
__global__ void empty_kernel() {}

__global__ void copy5_kernel(const float* __restrict__ a,
                             const float* __restrict__ b,
                             const float* __restrict__ c,
                             float* __restrict__ x, float* __restrict__ y,
                             unsigned int n) {
  const unsigned int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  x[i] = a[i];
  y[i] = __fadd_rn(b[i], c[i]);
}

inline unsigned int n_blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// ---- plain C entry points (loaded with ctypes) ---------------------------
// Each launches on the caller's stream and returns the cudaError_t of the
// launch (0 = success).  n == 0 launches nothing.

extern "C" int cc_gen_np_step(const float* par, long long par_stride,
                              long long F, long long n, const float* nicq,
                              const float* offered, const float* dropped,
                              const float* np_tmr, const float* gen_rate,
                              const float* t_start, const float* t_stop,
                              const float* volume, const float* nic_buffer,
                              float* o_nicq, float* o_off, float* o_drop,
                              float* o_tmr, void* stream) {
  if (n <= 0) return 0;
  gen_np_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      par, par_stride, F, n, nicq, offered, dropped, np_tmr, gen_rate,
      t_start, t_stop, volume, nic_buffer, o_nicq, o_off, o_drop, o_tmr);
  return (int)cudaGetLastError();
}

extern "C" int cc_rp_step(const float* par, long long par_stride,
                          long long F, long long n, const float* rate,
                          const float* target, const float* alpha,
                          const float* byte_cnt, const float* tmr,
                          const float* alpha_tmr, const float* bc_stage,
                          const float* t_stage, const float* cnp,
                          float* o_rate, float* o_target, float* o_alpha,
                          float* o_byte_cnt, float* o_tmr,
                          float* o_alpha_tmr, float* o_bc_stage,
                          float* o_t_stage, void* stream) {
  if (n <= 0) return 0;
  rp_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      par, par_stride, F, n, rate, target, alpha, byte_cnt, tmr, alpha_tmr,
      bc_stage, t_stage, cnp, o_rate, o_target, o_alpha, o_byte_cnt, o_tmr,
      o_alpha_tmr, o_bc_stage, o_t_stage);
  return (int)cudaGetLastError();
}

extern "C" int cc_erp_step(const float* par, long long par_stride,
                           long long F, long long n, const float* rate,
                           const float* hold, const float* cnp,
                           const float* tgt_rx, const float* slope,
                           float* o_rate, float* o_hold, void* stream) {
  if (n <= 0) return 0;
  erp_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      par, par_stride, F, n, rate, hold, cnp, tgt_rx, slope, o_rate, o_hold);
  return (int)cudaGetLastError();
}

extern "C" int cc_swift_step(const float* par, long long par_stride,
                             long long F, long long n, const float* rate,
                             const float* cool, const float* qdelay,
                             float* o_rate, float* o_cool, void* stream) {
  if (n <= 0) return 0;
  if (n >= (1LL << 31) || par_stride >= (1LL << 24))
    return (int)cudaErrorInvalidValue;    // 32-bit indexing only
  swift_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      par, (int)par_stride, (unsigned int)F, (unsigned int)n, rate, cool,
      qdelay, o_rate, o_cool);
  return (int)cudaGetLastError();
}

// The empty kernel at swift's grid for n flows.
extern "C" int cc_swift_floor(long long n, void* stream) {
  if (n <= 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  empty_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// x = a, y = b + c over n float32 words at swift's grid.
extern "C" int cc_swift_copy(const float* a, const float* b, const float* c,
                             float* x, float* y, long long n, void* stream) {
  if (n <= 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  copy5_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      a, b, c, x, y, (unsigned int)n);
  return (int)cudaGetLastError();
}

extern "C" const char* cc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
