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
// their plain PyTorch versions (repro_torch/kernels/cc_step.py), which
// round after every operation.  So every multiply, add, subtract and
// divide is written with an explicit round-to-nearest intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn): the compiler never
// contracts those into an FMA.  Build without --use_fast_math.
// max/min follow torch.maximum/minimum: NaN in, NaN out, else fmaxf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float tmax(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float tmin(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float tclip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}

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
  const float t_sec = p[0];
  const float dt = p[1];
  const bool active = (t_sec >= t_start[i]) && (t_sec < t_stop[i]);
  const float off = offered[i];
  float gen = __fmul_rn(active ? gen_rate[i] : 0.0f, dt);
  gen = tmin(gen, tmax(__fsub_rn(volume[i], off), 0.0f));
  const float q = __fadd_rn(nicq[i], gen);
  const float over = tmax(__fsub_rn(q, nic_buffer[i]), 0.0f);
  o_nicq[i] = __fsub_rn(q, over);
  o_off[i] = __fsub_rn(__fadd_rn(off, gen), over);
  o_drop[i] = __fadd_rn(dropped[i], over);
  o_tmr[i] = __fadd_rn(np_tmr[i], dt);
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
  const float g = p[0], rate_decrease = p[1], timer_T = p[2];
  const float byte_B = p[3], rai = p[4], rhai = p[5], fr_stages = p[6];
  const float min_rate = p[7], line_rate = p[8], dt = p[9];

  const float rate = rate_in[i];
  float target = target_in[i];
  float alpha = alpha_in[i];
  float byte_cnt = byte_cnt_in[i];
  float tmr = tmr_in[i];
  float alpha_tmr = __fadd_rn(alpha_tmr_in[i], dt);
  float bc_stage = bc_stage_in[i];
  float t_stage = t_stage_in[i];
  const bool cnp = cnp_in[i] > 0.0f;

  const float one_minus_g = __fsub_rn(1.0f, g);
  const bool a_tick = alpha_tmr >= timer_T;
  if (a_tick) {
    alpha = __fmul_rn(one_minus_g, alpha);
    alpha_tmr = 0.0f;
  }
  float new_rate = rate;
  if (cnp) {
    target = rate;
    new_rate = __fmul_rn(rate, __fsub_rn(1.0f, __fmul_rn(alpha, rate_decrease)));
    alpha = __fadd_rn(__fmul_rn(one_minus_g, alpha), g);
    byte_cnt = 0.0f;
    tmr = 0.0f;
    alpha_tmr = 0.0f;
    bc_stage = 0.0f;
    t_stage = 0.0f;
  } else {
    byte_cnt = __fadd_rn(byte_cnt, __fmul_rn(rate, dt));
    tmr = __fadd_rn(tmr, dt);
  }
  float r = new_rate;

  const bool b_ev = byte_cnt >= byte_B;
  const bool t_ev = tmr >= timer_T;
  if (b_ev) byte_cnt = 0.0f;
  if (t_ev) tmr = 0.0f;
  bc_stage = __fadd_rn(bc_stage, b_ev ? 1.0f : 0.0f);
  t_stage = __fadd_rn(t_stage, t_ev ? 1.0f : 0.0f);
  const bool ev = b_ev || t_ev;
  const float imax = tmax(bc_stage, t_stage);
  const float imin = tmin(bc_stage, t_stage);
  const bool in_fr = imax <= fr_stages;
  const bool in_hyper = imin > fr_stages;
  if (ev && !in_fr && !in_hyper) target = __fadd_rn(target, rai);
  if (ev && in_hyper)
    target = __fadd_rn(target, __fmul_rn(rhai, __fsub_rn(imin, fr_stages)));
  if (ev) r = __fmul_rn(0.5f, __fadd_rn(r, target));

  o_rate[i] = tclip(r, min_rate, line_rate);
  o_target[i] = tclip(target, min_rate, line_rate);
  o_alpha[i] = alpha;
  o_byte_cnt[i] = byte_cnt;
  o_tmr[i] = tmr;
  o_alpha_tmr[i] = alpha_tmr;
  o_bc_stage[i] = bc_stage;
  o_t_stage[i] = t_stage;
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
  const float settle = p[0], hold_T = p[1], min_rate = p[2];
  const float line_rate = p[3], dt = p[4];
  const bool cnp = cnp_in[i] > 0.0f;
  float rate = rate_in[i];
  float hold;
  if (cnp) {
    rate = tmax(__fmul_rn(settle, tgt_rx[i]), min_rate);
    hold = hold_T;
  } else {
    hold = tmax(__fsub_rn(hold_in[i], dt), 0.0f);
    if (hold <= 0.0f) rate = __fadd_rn(rate, __fmul_rn(slope[i], dt));
  }
  o_rate[i] = tclip(rate, min_rate, line_rate);
  o_hold[i] = hold;
}

// ---- delay-target reaction (Swift-like) ---------------------------------
// par row: (target, beta, ai, guard, min_rate, line_rate, dt)
__global__ void swift_kernel(const float* __restrict__ par,
                             long long par_stride, long long F, long long n,
                             const float* __restrict__ rate_in,
                             const float* __restrict__ cool_in,
                             const float* __restrict__ qdelay,
                             float* __restrict__ o_rate,
                             float* __restrict__ o_cool) {
  long long i = flat_index();
  if (i >= n) return;
  const float* p = par + (i / F) * par_stride;
  const float target = p[0], beta = p[1], ai = p[2], guard = p[3];
  const float min_rate = p[4], line_rate = p[5], dt = p[6];
  float rate = rate_in[i];
  const float cool = tmax(__fsub_rn(cool_in[i], dt), 0.0f);
  const float qd = qdelay[i];
  const bool over = qd > target;
  const bool can = cool <= 0.0f;
  const float factor = __fsub_rn(
      1.0f, __fdiv_rn(__fmul_rn(beta, __fsub_rn(qd, target)),
                      tmax(qd, 1e-12f)));
  const float dec =
      tmax(__fmul_rn(rate, tmax(factor, __fsub_rn(1.0f, beta))), min_rate);
  if (over && can) {
    rate = dec;
  } else if (!over) {
    rate = __fadd_rn(rate, __fmul_rn(ai, dt));
  }
  o_cool[i] = (over && can) ? guard : cool;
  o_rate[i] = tclip(rate, min_rate, line_rate);
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
  swift_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      par, par_stride, F, n, rate, cool, qdelay, o_rate, o_cool);
  return (int)cudaGetLastError();
}

extern "C" const char* cc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
