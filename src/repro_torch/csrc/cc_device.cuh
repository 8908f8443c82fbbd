// Per-flow congestion-control arithmetic shared by the CUDA kernels.
//
// One definition of generation + NIC overflow + notification-timer tick,
// DCQCN RP, the paper's ERP and the Swift-style delay reaction, as
// __device__ functions on one flow's scalars.  The per-flow kernels of
// cc_step.cu and the whole-step megakernel of fluid_step.cu both call
// them, so the two tiers can never diverge.
//
// Rounding: every multiply, add, subtract and divide is an explicit
// round-to-nearest intrinsic (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn), so nothing is contracted into an FMA and each function is
// bitwise equal to its plain PyTorch version (kernels/cc_step.py), which
// rounds after every operation.  Build without --use_fast_math.
// max/min follow torch.maximum/minimum: NaN in, NaN out, else fmaxf.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cc {

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

// ---- fused generation + notification-timer tick ------------------------
struct GenNp {
  float nicq, offered, dropped, np_tmr;
};

__device__ __forceinline__ GenNp gen_np_flow(float t_sec, float dt,
                                             GenNp s, float gen_rate,
                                             float t_start, float t_stop,
                                             float volume,
                                             float nic_buffer) {
  const bool active = (t_sec >= t_start) && (t_sec < t_stop);
  float gen = __fmul_rn(active ? gen_rate : 0.0f, dt);
  gen = tmin(gen, tmax(__fsub_rn(volume, s.offered), 0.0f));
  const float q = __fadd_rn(s.nicq, gen);
  const float over = tmax(__fsub_rn(q, nic_buffer), 0.0f);
  GenNp o;
  o.nicq = __fsub_rn(q, over);
  o.offered = __fsub_rn(__fadd_rn(s.offered, gen), over);
  o.dropped = __fadd_rn(s.dropped, over);
  o.np_tmr = __fadd_rn(s.np_tmr, dt);
  return o;
}

// ---- DCQCN reaction point ----------------------------------------------
// p: (g, rate_decrease, timer_T, byte_B, rai, rhai, fr_stages, min_rate,
//     line_rate, dt); the stage counters travel as exact float integers
struct RP {
  float rate, target, alpha, byte_cnt, tmr, alpha_tmr, bc_stage, t_stage;
};

__device__ __forceinline__ RP rp_flow(const float* __restrict__ p, RP s,
                                      bool cnp) {
  const float g = p[0], rate_decrease = p[1], timer_T = p[2];
  const float byte_B = p[3], rai = p[4], rhai = p[5], fr_stages = p[6];
  const float min_rate = p[7], line_rate = p[8], dt = p[9];

  const float rate = s.rate;
  float target = s.target;
  float alpha = s.alpha;
  float byte_cnt = s.byte_cnt;
  float tmr = s.tmr;
  float alpha_tmr = __fadd_rn(s.alpha_tmr, dt);
  float bc_stage = s.bc_stage;
  float t_stage = s.t_stage;

  const float one_minus_g = __fsub_rn(1.0f, g);
  if (alpha_tmr >= timer_T) {
    alpha = __fmul_rn(one_minus_g, alpha);
    alpha_tmr = 0.0f;
  }
  float r = rate;
  if (cnp) {
    target = rate;
    r = __fmul_rn(rate, __fsub_rn(1.0f, __fmul_rn(alpha, rate_decrease)));
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

  RP o;
  o.rate = tclip(r, min_rate, line_rate);
  o.target = tclip(target, min_rate, line_rate);
  o.alpha = alpha;
  o.byte_cnt = byte_cnt;
  o.tmr = tmr;
  o.alpha_tmr = alpha_tmr;
  o.bc_stage = bc_stage;
  o.t_stage = t_stage;
  return o;
}

// ---- the paper's ERP ----------------------------------------------------
// p: (settle, hold, min_rate, line_rate, dt)
__device__ __forceinline__ void erp_flow(const float* __restrict__ p,
                                         float& rate, float& hold, bool cnp,
                                         float tgt_rx, float slope) {
  const float settle = p[0], hold_T = p[1], min_rate = p[2];
  const float line_rate = p[3], dt = p[4];
  if (cnp) {
    rate = tmax(__fmul_rn(settle, tgt_rx), min_rate);
    hold = hold_T;
  } else {
    hold = tmax(__fsub_rn(hold, dt), 0.0f);
    if (hold <= 0.0f) rate = __fadd_rn(rate, __fmul_rn(slope, dt));
  }
  rate = tclip(rate, min_rate, line_rate);
}

// ---- delay-target reaction (Swift-like) ---------------------------------
// p: (target, beta, ai, guard, min_rate, line_rate, dt)
__device__ __forceinline__ void swift_flow(const float* __restrict__ p,
                                           float& rate, float& cool,
                                           float qd) {
  const float target = p[0], beta = p[1], ai = p[2], guard = p[3];
  const float min_rate = p[4], line_rate = p[5], dt = p[6];
  const float c = tmax(__fsub_rn(cool, dt), 0.0f);
  const bool over = qd > target;
  const bool can = c <= 0.0f;
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
  cool = (over && can) ? guard : c;
  rate = tclip(rate, min_rate, line_rate);
}

}  // namespace cc
