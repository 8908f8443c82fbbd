// Whole-step fluid megakernel for Hopper (sm_90a).
//
// Port of the Pallas TPU kernels megastep and megastep_block
// (src/repro/kernels/fluid_step.py:232 and :243, _mega_call :165, with
// dense_reduce_tiled :82 inside): the whole fluid_step of
// repro_torch/core/fluid.py (path selection, generation, transfers, PFC
// with the switch pool, marking / notification / reaction dispatched by
// each run's stage codes) in ONE launch, and for megastep_block a whole
// trace window of n_substeps steps folded into one TraceSample row.
//
// Design.  The TPU kernel keeps the state in VMEM and runs the step as
// one sequential program.  Here the grid is R runs, one CTA per run;
// its threads stride over flows (per-flow and per-hop work), over
// (wire, VC) queues (the ordered link sums), over links and over
// switches, with __syncthreads() between the phases that need a whole
// run: the UGAL backlog pass, the transfer sums, the PFC sums, the
// per-switch pool, the marking surplus and the delay-line update.  State
// and scenario stay in global memory (a DC-scale batch is ~10 MB, held
// in the 50 MB L2); per-queue sums live in shared memory.  The kernel
// first copies its run's input state into the output buffers and then
// updates those in place: every cross-thread read of a value happens in
// an earlier phase than its write.
//
// Order of sums.  Each queue's sum walks the run's sorted incidence CSR
// (ScenarioDev.red_perm / red_off) in order from +0.0, one thread per
// queue, skipping entries of unselected candidate slots (exact +0.0
// terms in the plain step); the pool walks links in pool_perm order.
// These are the orders of the port's plain step, so the kernel is
// bitwise equal to the flow tier on the card.  Every float operation is
// an explicit round-to-nearest intrinsic (no FMA contraction), and max /
// min follow torch.maximum / minimum (NaN propagates).  The per-flow CC
// arithmetic is cc_device.cuh, shared with cc_step.cu.
//
// Bound on this card: latency, not bytes.  A step moves ~150 B per flow
// and hop; the time goes to the dependent chains: each queue's ordered
// sum (up to 74 rows at the DC cell) through L2, five times a step, and
// the phase barriers.  Only R CTAs run (36 of 132 SMs at the DC cell).

#include <cuda_runtime.h>
#include <math.h>

#include "cc_device.cuh"

namespace {

using cc::tclip;
using cc::tmax;
using cc::tmin;

constexpr int kThreads = 512;
constexpr int kMaxHops = 8;

// state leaves, in FluidState order with the cc dict expanded
enum Leaf {
  L_QH, L_NICQ, L_DELIVERED, L_OFFERED, L_DROPPED, L_EST, L_PAUSED,
  L_RATE, L_RP_TARGET, L_ALPHA, L_BYTE_CNT, L_TMR, L_ALPHA_TMR,
  L_BC_STAGE, L_T_STAGE, L_HOLD, L_NP_TMR, L_TRIG_BUF, L_TGT_BUF,
  L_PATH_IDX, L_SLOPE_ACC, L_SWIFT_COOL, L_T, N_LEAVES
};

// per-run float32 parameter row; the last three are the packed
// reaction rows of kernels/cc_step.py (rp 10, erp 5, swift 7 values)
enum FRow {
  FR_DT, FR_LINE_RATE, FR_XOFF, FR_XON, FR_POOL_XOFF, FR_PORT_BUFFER,
  FR_ECP_BETA, FR_CP_KMIN, FR_DRAIN_GAIN, FR_ECP_THRESH, FR_ECP_SLACK,
  FR_SLOPE_KMIN, FR_SLOPE_KMAX, FR_SLOPE_PMAX, FR_NP_WINDOW,
  FR_ENP_WINDOW, FR_FNCC_WINDOW, FR_FNCC_SCALE, FR_ERP_RAI,
  FR_ERP_JITTER, FR_WINDOW,
  FR_RP, FR_ERP = FR_RP + 10, FR_SWIFT = FR_ERP + 5,
  FR_COUNT = FR_SWIFT + 7
};

// per-run int32 row
enum IRow { IR_MARK_CODE, IR_NOTIF_CODE, IR_REACT_CODE, IR_ROUTE_CODE,
            IR_COUNT };

}  // namespace

// The launch operands, mirrored field by field by the ctypes Structure
// in kernels/fluid_step.py.
struct MegaArgs {
  long long R, F, H, K, L, V, S, D, NSW, n_substeps, block, nfp, nip;
  const float* fpar;
  const int* ipar;
  const float* gen_rate;
  const float* t_start;
  const float* t_stop;
  const float* volume;
  const float* cap_ext;
  const float* nic_buffer;
  const float* jitter;
  const long long* sink_ext;
  const long long* rtt;
  const long long* alt_routes;
  const long long* alt_hops;
  const long long* vc;
  const long long* red_perm;
  const long long* red_off;
  const long long* pool_perm;
  const long long* pool_off;
  const void* st_in[N_LEAVES];
  void* st_out[N_LEAVES];
  float* tr_inst_thr;
  float* tr_max_q;
  int* tr_n_paused;
  void* tr_marked;
  void* tr_cnp;
  int* tr_n_nonmin;
  float* tr_ctrl;
  float* tr_pause_time;
  float* tr_vc_stall;
  float* scratch;
};

namespace {

__device__ __forceinline__ long long leaf_words(const MegaArgs& a, int i) {
  switch (i) {
    case L_QH: case L_EST: return a.F * a.H;
    case L_PAUSED: return a.S;
    case L_TRIG_BUF: case L_TGT_BUF: return a.D * a.F;
    case L_T: return 1;
    default: return a.F;
  }
}

// Sum C channels of chan ([F*H][3] per run) per queue q < S, walking the
// queue's contributors in incidence order from +0.0; the scratch queue S
// is 0 (it only ever holds zeros).  qsum is [C][S + 1] in shared memory.
template <int C>
__device__ __forceinline__ void link_walk(const MegaArgs& a, long long r,
                                          const float* chan,
                                          const int* pidx, float* qsum) {
  const int S = (int)a.S, K = (int)a.K, H = (int)a.H;
  const long long N = a.F * a.K * a.H;
  const long long* perm = a.red_perm + r * N;
  const long long* off = a.red_off + r * (a.S + 2);
  for (int q = threadIdx.x; q < S; q += blockDim.x) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    const long long j1 = off[q + 1];
    for (long long j = off[q]; j < j1; ++j) {
      const int row = (int)perm[j];
      const int fk = row / H;
      const int h = row - fk * H;
      const int f = fk / K;
      if (K > 1 && fk - f * K != pidx[f]) continue;
      const float* d = chan + ((long long)f * H + h) * 3;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], d[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) qsum[c * (S + 1) + q] = acc[c];
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) qsum[c * (S + 1) + S] = 0.0f;
  }
}

// Fold per-queue [S + 1] sums to per-wire [L + 1] (V queues per wire,
// added in VC order; slot L is the scratch queue S).
__device__ __forceinline__ void to_wire(const MegaArgs& a, const float* x,
                                        float* w) {
  const int L = (int)a.L, V = (int)a.V, S = (int)a.S;
  for (int l = threadIdx.x; l <= L; l += blockDim.x) {
    if (l == L) {
      w[L] = x[S];
    } else if (V == 1) {
      w[l] = x[l];
    } else {
      float acc = x[l * V];
      for (int v = 1; v < V; ++v) acc = __fadd_rn(acc, x[l * V + v]);
      w[l] = acc;
    }
  }
}

// One flow's selected path: per-hop wire / queue ids and masks.
struct Hops {
  int n;                 // hop count of the selected candidate
  int widx[kMaxHops];    // wire id, L for PAD hops
  int qidx[kMaxHops];    // (wire, VC) queue id, S for PAD hops
  bool valid[kMaxHops];
};

__device__ __forceinline__ Hops path_of(const MegaArgs& a, long long r,
                                        int f, int k) {
  const int H = (int)a.H, L = (int)a.L, V = (int)a.V, S = (int)a.S;
  const long long base = (r * a.F + f) * a.K + k;
  const long long* routes = a.alt_routes + base * H;
  const long long* vc = a.vc + base * H;
  Hops p;
  p.n = (int)a.alt_hops[base];
  for (int h = 0; h < H; ++h) {
    const long long rt = routes[h];
    p.valid[h] = rt != -1;
    p.widx[h] = p.valid[h] ? (int)rt : L;
    p.qidx[h] = V == 1 ? p.widx[h]
                       : (p.valid[h] ? p.widx[h] * V + (int)vc[h] : S);
  }
  return p;
}

// UGAL cost of candidate k: hop count x backlog along it (B_prev = w)
__device__ __forceinline__ float path_cost(const MegaArgs& a, long long r,
                                           int f, long long k,
                                           const float* w) {
  const int H = (int)a.H;
  const long long base = (r * a.F + f) * a.K + k;
  const long long* routes = a.alt_routes + base * H;
  float q = 0.0f;
  for (int h = 0; h < H; ++h) {
    const long long rt = routes[h];
    const float x = rt != -1 ? w[rt] : 0.0f;
    q = h == 0 ? x : __fadd_rn(q, x);
  }
  return __fmul_rn((float)a.alt_hops[base], q);
}

__global__ void __launch_bounds__(kThreads, 1)
mega_kernel(const MegaArgs a) {
  extern __shared__ float smem[];
  const long long r = blockIdx.x;
  const int F = (int)a.F, H = (int)a.H, K = (int)a.K, L = (int)a.L;
  const int V = (int)a.V, S = (int)a.S, D = (int)a.D, NSW = (int)a.NSW;
  const int tid = threadIdx.x, nth = blockDim.x;
  const bool block = a.block != 0;

  float* qsum = smem;                 // [3][S + 1] raw per-queue sums
  float* Bq = qsum + 3 * (S + 1);     // [S + 1] queue backlog (B1)
  float* fifo = Bq + (S + 1);         // [S + 1] FIFO head-of-line factor
  float* wsw = fifo + (S + 1);        // [L + 1] B_prev, then sum_w per wire
  float* wact = wsw + (L + 1);        // [L + 1] active contributors
  float* wdem = wact + (L + 1);       // [L + 1] summed demand
  float* wsur = wdem + (L + 1);       // [L + 1] fair-share surplus
  float* whvy = wsur + (L + 1);       // [L + 1] heavy contributors
  float* wpool = whvy + (L + 1);      // [L + 1] pool input per link
  float* phot = wpool + (L + 1);      // [NSW] switch pool over xoff
  float* red = phot + NSW;            // [32] warp partial maxima
  int* cnt = (int*)(red + 32);        // [4 + V] per-step counters

  // ---- copy this run's state to the outputs, then work in place --------
  for (int i = 0; i < N_LEAVES; ++i) {
    const long long n = leaf_words(a, i);
    const unsigned* src = (const unsigned*)a.st_in[i] + r * n;
    unsigned* dst = (unsigned*)a.st_out[i] + r * n;
    for (long long j = tid; j < n; j += nth) dst[j] = src[j];
  }
  float* qh = (float*)a.st_out[L_QH] + r * F * H;
  float* nicq = (float*)a.st_out[L_NICQ] + r * F;
  float* delivered = (float*)a.st_out[L_DELIVERED] + r * F;
  float* offered = (float*)a.st_out[L_OFFERED] + r * F;
  float* dropped = (float*)a.st_out[L_DROPPED] + r * F;
  float* est = (float*)a.st_out[L_EST] + r * F * H;
  float* paused = (float*)a.st_out[L_PAUSED] + r * S;
  float* rate = (float*)a.st_out[L_RATE] + r * F;
  float* rp_target = (float*)a.st_out[L_RP_TARGET] + r * F;
  float* alpha = (float*)a.st_out[L_ALPHA] + r * F;
  float* byte_cnt = (float*)a.st_out[L_BYTE_CNT] + r * F;
  float* tmr = (float*)a.st_out[L_TMR] + r * F;
  float* alpha_tmr = (float*)a.st_out[L_ALPHA_TMR] + r * F;
  int* bc_stage = (int*)a.st_out[L_BC_STAGE] + r * F;
  int* t_stage = (int*)a.st_out[L_T_STAGE] + r * F;
  float* hold = (float*)a.st_out[L_HOLD] + r * F;
  float* np_tmr = (float*)a.st_out[L_NP_TMR] + r * F;
  float* trig = (float*)a.st_out[L_TRIG_BUF] + r * D * F;
  float* tgtb = (float*)a.st_out[L_TGT_BUF] + r * D * F;
  int* pidx = (int*)a.st_out[L_PATH_IDX] + r * F;
  float* slope_acc = (float*)a.st_out[L_SLOPE_ACC] + r * F;
  float* swift_cool = (float*)a.st_out[L_SWIFT_COOL] + r * F;
  int* tp = (int*)a.st_out[L_T] + r;

  const float* fp = a.fpar + r * a.nfp;
  const int* ip = a.ipar + r * a.nip;
  const float dt = fp[FR_DT], line_rate = fp[FR_LINE_RATE];
  const int mark_code = ip[IR_MARK_CODE], notif_code = ip[IR_NOTIF_CODE];
  const int react_code = ip[IR_REACT_CODE], route_code = ip[IR_ROUTE_CODE];
  const float* gen_rate = a.gen_rate + r * F;
  const float* t_start = a.t_start + r * F;
  const float* cap = a.cap_ext + r * (L + 1);
  const long long* sink = a.sink_ext + r * (L + 1);
  float* chan = a.scratch + r * (long long)F * H * 4;   // [F*H][3]
  float* Tb = chan + (long long)F * H * 3;               // [F*H]
  const long long rF = r * F;
  const float INF = INFINITY;

  if (tid == 0)
    for (int i = 0; i < 4 + V; ++i) cnt[i] = 0;
  if (block) {                      // window accumulators; d0 rides in inst_thr
    for (int f = tid; f < F; f += nth) {
      a.tr_inst_thr[rF + f] = delivered[f];
      ((int*)a.tr_marked)[rF + f] = 0;
      ((int*)a.tr_cnp)[rF + f] = 0;
      a.tr_ctrl[rF + f] = 0.0f;
    }
    if (tid == 0) {
      a.tr_max_q[r] = 0.0f;
      a.tr_n_paused[r] = 0;
      a.tr_n_nonmin[r] = 0;
      a.tr_pause_time[r] = 0.0f;
      for (int v = 0; v < V; ++v) a.tr_vc_stall[r * V + v] = 0.0f;
    }
  }
  __syncthreads();

  for (long long step = 0; step < a.n_substeps; ++step) {
    const int t = *tp;
    const float t_sec = __fmul_rn((float)t, dt);
    const int rslot = t % D;

    // ---- 0. path selection (min / valiant / ugal) -------------------------
    if (K > 1) {
      for (int f = tid; f < F; f += nth) {
        const Hops p = path_of(a, r, f, pidx[f]);
        for (int h = 0; h < H; ++h) {
          const bool hq = p.valid[h] && h < p.n - 1;
          chan[((long long)f * H + h) * 3] = hq ? qh[f * H + h] : 0.0f;
        }
      }
      __syncthreads();
      link_walk<1>(a, r, chan, pidx, qsum);
      __syncthreads();
      to_wire(a, qsum, wsw);
      __syncthreads();
      for (int f = tid; f < F; f += nth) {
        int newk = 0;
        if (route_code != 0) {
          const long long fb = (r * a.F + f) * a.K;
          int n_alt = 0;
          for (int k = 1; k < K; ++k) n_alt += a.alt_hops[fb + k] > 0;
          const long long samp =
              n_alt > 0 ? 1 + ((long long)f + t) % (long long)max(n_alt, 1)
                        : 0;
          const long long ugal =
              path_cost(a, r, f, samp, wsw) < path_cost(a, r, f, 0, wsw)
                  ? samp : 0;
          const float ts = t_start[f];
          const bool starting = (t_sec >= ts) && (__fsub_rn(t_sec, dt) < ts);
          const bool cnp_now = trig[(long long)rslot * F + f] > 0.0f;
          const bool epoch = starting || (route_code == 2 && cnp_now);
          const long long pick = route_code == 1 ? samp : ugal;
          newk = epoch ? (int)pick : pidx[f];
        }
        pidx[f] = newk;
      }
      __syncthreads();
    }

    // ---- 1. generation (+ notification-timer tick), 2a. transfer sums -----
    for (int f = tid; f < F; f += nth) {
      const Hops p = path_of(a, r, f, K > 1 ? pidx[f] : 0);
      const cc::GenNp g = cc::gen_np_flow(
          t_sec, dt, cc::GenNp{nicq[f], offered[f], dropped[f], np_tmr[f]},
          gen_rate[f], t_start[f], a.t_stop[rF + f], a.volume[rF + f],
          a.nic_buffer[rF + f]);
      nicq[f] = g.nicq;
      offered[f] = g.offered;
      dropped[f] = g.dropped;
      np_tmr[f] = g.np_tmr;         // post-tick timer until phase 5
      const float src_inj =
          tmin(g.nicq, __fmul_rn(tmin(rate[f], line_rate), dt));
      float wo[kMaxHops];
      for (int h = 0; h < H; ++h)
        wo[h] = __fsub_rn(1.0f, p.qidx[h] < S ? paused[p.qidx[h]] : 0.0f);
      for (int h = 0; h < H; ++h) {
        const float next_open = h + 1 < H ? wo[h + 1] : 1.0f;
        const bool holds = p.valid[h] && h < p.n - 1;
        const float q_here = holds ? qh[f * H + h] : 0.0f;
        const float src_q =
            p.valid[h] ? (h == 0 ? src_inj : qh[f * H + h - 1]) : 0.0f;
        float* d = chan + ((long long)f * H + h) * 3;
        d[0] = __fmul_rn(q_here, next_open);
        d[1] = q_here;
        d[2] = __fmul_rn(src_q, wo[h]);
      }
    }
    __syncthreads();
    link_walk<3>(a, r, chan, pidx, qsum);
    __syncthreads();
    for (int q = tid; q <= S; q += nth) {
      const float num = qsum[q], den = qsum[(S + 1) + q];
      fifo[q] = den > 0.0f ? __fdiv_rn(num, tmax(den, (float)1e-9)) : 1.0f;
    }
    to_wire(a, qsum + 2 * (S + 1), wsw);
    __syncthreads();

    // ---- 2b. transfers: shares, queues, delivery, crossing-rate EWMA ------
    for (int f = tid; f < F; f += nth) {
      const Hops p = path_of(a, r, f, K > 1 ? pidx[f] : 0);
      const float nq = nicq[f];
      const float src_inj = tmin(nq, __fmul_rn(tmin(rate[f], line_rate), dt));
      float qold[kMaxHops], T[kMaxHops];
      for (int h = 0; h < H; ++h) qold[h] = qh[f * H + h];
      for (int h = 0; h < H; ++h) {
        const float wo =
            __fsub_rn(1.0f, p.qidx[h] < S ? paused[p.qidx[h]] : 0.0f);
        const float src_q =
            p.valid[h] ? (h == 0 ? src_inj : qold[h - 1]) : 0.0f;
        const float weight = __fmul_rn(src_q, wo);
        const float budget =
            __fmul_rn(__fmul_rn(cap[p.widx[h]], dt), fifo[p.qidx[h]]);
        const float sww = wsw[p.widx[h]];
        const float share =
            sww > 0.0f ? __fdiv_rn(__fmul_rn(budget, weight),
                                   tmax(sww, (float)1e-9))
                       : 0.0f;
        T[h] = tmin(weight, share);
      }
      nicq[f] = __fsub_rn(nq, T[0]);
      float deliv = 0.0f;
      for (int h = 0; h < H; ++h) {
        const bool holds = p.valid[h] && h < p.n - 1;
        const bool is_last = p.valid[h] && h == p.n - 1;
        float qn = __fsub_rn(qold[h], h + 1 < H ? T[h + 1] : 0.0f);
        qn = tmax(__fadd_rn(qn, holds ? T[h] : 0.0f), 0.0f);
        qh[f * H + h] = qn;
        deliv = __fadd_rn(deliv, is_last ? T[h] : 0.0f);
      }
      delivered[f] = __fadd_rn(delivered[f], deliv);
      const float beta = fp[FR_ECP_BETA];
      const float omb = __fsub_rn(1.0f, beta);
      float e[kMaxHops];
      for (int h = 0; h < H; ++h) {
        e[h] = __fadd_rn(__fmul_rn(omb, est[f * H + h]),
                         __fmul_rn(beta, __fdiv_rn(T[h], dt)));
        est[f * H + h] = e[h];
      }
      for (int h = 0; h < H; ++h) {
        const bool holds = p.valid[h] && h < p.n - 1;
        const float dem = p.valid[h] ? (h == 0 ? e[0] : e[h - 1]) : 0.0f;
        const bool act = (dem > 1e6f) && p.valid[h];
        float* d = chan + ((long long)f * H + h) * 3;
        d[0] = holds ? qh[f * H + h] : 0.0f;
        d[1] = act ? 1.0f : 0.0f;
        d[2] = act ? dem : 0.0f;
        Tb[(long long)f * H + h] = T[h];
      }
      if (!block) a.tr_inst_thr[rF + f] = __fdiv_rn(deliv, dt);
    }
    __syncthreads();

    // ---- 3. PFC: per-queue hysteresis + shared switch pool ----------------
    link_walk<3>(a, r, chan, pidx, qsum);
    __syncthreads();
    {
      const float xoff_q = V == 1 ? fp[FR_XOFF]
          : __fmul_rn(fp[FR_XOFF], __fdiv_rn(1.0f, (float)V));
      const float xon_q = V == 1 ? fp[FR_XON]
          : __fmul_rn(fp[FR_XON], __fdiv_rn(1.0f, (float)V));
      for (int q = tid; q <= S; q += nth) {
        const float B = q < S ? qsum[q] : 0.0f;
        Bq[q] = B;
        if (q < S)
          paused[q] = B > xoff_q ? 1.0f : (B < xon_q ? 0.0f : paused[q]);
      }
    }
    to_wire(a, qsum + (S + 1), wact);
    to_wire(a, qsum + 2 * (S + 1), wdem);
    for (int l = tid; l < L; l += nth) {
      float bw = qsum[l * V];
      for (int v = 1; v < V; ++v) bw = __fadd_rn(bw, qsum[l * V + v]);
      wpool[l] = sink[l] >= 0 ? bw : 0.0f;
    }
    __syncthreads();
    {
      const long long* po = a.pool_off + r * (NSW + 1);
      const long long* pp = a.pool_perm + r * L;
      const float pool_xoff = fp[FR_POOL_XOFF];
      for (int sw = tid; sw < NSW; sw += nth) {
        float acc = 0.0f;
        for (long long j = po[sw]; j < po[sw + 1]; ++j)
          acc = __fadd_rn(acc, wpool[pp[j]]);
        phot[sw] = acc > pool_xoff ? 1.0f : 0.0f;
      }
    }
    __syncthreads();
    {
      float lmax = -INFINITY;
      int npz = 0;
      for (int q = tid; q < S; q += nth) {
        const long long sk = sink[q / V];
        const float pz = tmax(paused[q], sk >= 0 ? phot[sk] : 0.0f);
        paused[q] = pz;
        lmax = tmax(lmax, Bq[q]);
        if (pz > 0.5f) {
          ++npz;
          atomicAdd(&cnt[4 + q % V], 1);
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        lmax = tmax(lmax, __shfl_down_sync(0xffffffffu, lmax, o));
      if ((tid & 31) == 0) red[tid >> 5] = lmax;
      if (npz) atomicAdd(&cnt[0], npz);
    }

    // ---- 4a. fair-share surplus inputs ------------------------------------
    for (int f = tid; f < F; f += nth) {
      const Hops p = path_of(a, r, f, K > 1 ? pidx[f] : 0);
      for (int h = 0; h < H; ++h) {
        const float dem =
            p.valid[h] ? (h == 0 ? est[f * H] : est[f * H + h - 1]) : 0.0f;
        const bool act = (dem > 1e6f) && p.valid[h];
        const float share0 =
            __fdiv_rn(cap[p.widx[h]], tmax(wact[p.widx[h]], 1.0f));
        const bool under = dem < share0;
        float* d = chan + ((long long)f * H + h) * 3;
        d[0] = (act && under) ? __fsub_rn(share0, dem) : 0.0f;
        d[1] = (act && !under) ? 1.0f : 0.0f;
      }
    }
    __syncthreads();
    link_walk<2>(a, r, chan, pidx, qsum);
    __syncthreads();
    to_wire(a, qsum, wsur);
    to_wire(a, qsum + (S + 1), whvy);
    __syncthreads();

    // ---- 4b. marking, 5. notification + delay line, 6. reaction -----------
    int nonmin = 0;
    for (int f = tid; f < F; f += nth) {
      const Hops p = path_of(a, r, f, K > 1 ? pidx[f] : 0);
      float dem[kMaxHops], grant[kMaxHops], over[kMaxHops];
      for (int h = 0; h < H; ++h) {
        dem[h] = p.valid[h] ? (h == 0 ? est[f * H] : est[f * H + h - 1])
                            : 0.0f;
        const bool act = (dem[h] > 1e6f) && p.valid[h];
        const int w = p.widx[h];
        const float caps = cap[w];
        const float share0 = __fdiv_rn(caps, tmax(wact[w], 1.0f));
        const bool under = dem[h] < share0;
        const float g = under ? dem[h]
            : __fadd_rn(share0, __fdiv_rn(wsur[w], tmax(whvy[w], 1.0f)));
        grant[h] = act ? g : caps;
        over[h] = wdem[w] > caps ? 1.0f : 0.0f;
      }
      // marking (cc.MARKING: 0 cp, 1 ecp, 2 slope)
      const float thresh = mark_code == 1 ? fp[FR_ECP_THRESH]
                         : mark_code == 2 ? fp[FR_SLOPE_KMIN] : fp[FR_CP_KMIN];
      const float port_buffer = fp[FR_PORT_BUFFER];
      const float drain = fp[FR_DRAIN_GAIN];
      float mf[kMaxHops], sev[kMaxHops];
      float prob = 0.0f;
      for (int h = 0; h < H; ++h) {
        const bool holds = p.valid[h] && h < p.n - 1;
        float gn = h + 1 < H ? grant[h + 1] : INF;
        gn = holds ? gn : INF;
        const float dn = h + 1 < H ? dem[h + 1] : 0.0f;
        const float on = h + 1 < H ? over[h + 1] : 0.0f;
        const float b1w = Bq[p.qidx[h]];
        const bool present =
            qh[f * H + h] > 0.0f || Tb[(long long)f * H + h] > 0.0f;
        const float base =
            (b1w > thresh && present && holds) ? 1.0f : 0.0f;
        const float qexc =
            tclip(__fdiv_rn(__fsub_rn(b1w, thresh), port_buffer), 0.0f, 1.0f);
        const bool finite = isfinite(gn);
        sev[h] = finite ? __fmul_rn(finite ? gn : 0.0f,
                                    __fsub_rn(1.0f, __fmul_rn(drain, qexc)))
                        : INF;
        if (mark_code == 1) {
          const bool congesting =
              on > 0.0f && dn > __fmul_rn(fp[FR_ECP_SLACK], gn);
          mf[h] = __fmul_rn(base, congesting ? 1.0f : 0.0f);
        } else if (mark_code == 2) {
          const float kmin = fp[FR_SLOPE_KMIN], kmax = fp[FR_SLOPE_KMAX];
          const float ramp = tclip(
              __fdiv_rn(__fsub_rn(b1w, kmin),
                        tmax(__fsub_rn(kmax, kmin), 1.0f)), 0.0f, 1.0f);
          const float pf = __fmul_rn(
              b1w >= kmax ? 1.0f : __fmul_rn(fp[FR_SLOPE_PMAX], ramp), base);
          prob = h == 0 ? pf : tmax(prob, pf);
          mf[h] = base;
        } else {
          mf[h] = base;
        }
      }
      if (mark_code == 2) {
        float acc = __fadd_rn(slope_acc[f], prob);
        const bool fire = acc >= 1.0f;
        if (fire) acc = __fsub_rn(acc, 1.0f);
        slope_acc[f] = acc;
        for (int h = 0; h < H; ++h)
          mf[h] = __fmul_rn(mf[h], fire ? 1.0f : 0.0f);
      }
      bool marked = false;
      float tgt = INF, mlvl = mf[0], best = mf[0];
      int hm = 0;
      for (int h = 0; h < H; ++h) {
        const bool pos = mf[h] > 0.0f;
        marked = marked || pos;
        const float x = pos ? sev[h] : INF;
        tgt = h == 0 ? x : tmin(tgt, x);
        if (h > 0) {
          mlvl = tmax(mlvl, mf[h]);
          if (mf[h] > best) { best = mf[h]; hm = h; }
        }
      }
      tgt = isfinite(tgt) ? tgt : line_rate;
      mlvl = tmin(mlvl, 1.0f);

      // notification (cc.NOTIFICATION: 0 np, 1 enp, 2 fncc)
      const float window = notif_code == 1 ? fp[FR_ENP_WINDOW]
                         : notif_code == 2 ? fp[FR_FNCC_WINDOW]
                                           : fp[FR_NP_WINDOW];
      const float tmr_t = np_tmr[f];
      const float emit = (mlvl > 0.0f && tmr_t >= window) ? 1.0f : 0.0f;
      np_tmr[f] = emit > 0.0f ? 0.0f : tmr_t;
      const long long rtt = a.rtt[rF + f];
      long long delay = rtt;
      if (notif_code == 2) {
        const float frac = __fdiv_rn(__fadd_rn((float)hm, 1.0f),
                                     tmax((float)p.n, 1.0f));
        const float x = __fmul_rn(
            __fmul_rn(__fmul_rn((float)rtt, 0.5f), frac), fp[FR_FNCC_SCALE]);
        const int eff = max((int)rintf(x), 2);
        delay = min((long long)eff, rtt);
      }
      const long long wslot = ((long long)t + delay) % D;
      float* tw = trig + wslot * F + f;
      *tw = __fadd_rn(*tw, emit);
      if (emit > 0.0f) tgtb[wslot * F + f] = tgt;
      const float cnp =
          trig[(long long)rslot * F + f] > 0.0f ? 1.0f : 0.0f;
      const float tgt_rx = tgtb[(long long)rslot * F + f];
      trig[(long long)rslot * F + f] = 0.0f;

      // reaction (cc.REACTION: 0 pfc, 1 rp, 2 erp, 3 swift)
      if (react_code == 1) {
        const cc::RP o = cc::rp_flow(
            fp + FR_RP,
            cc::RP{rate[f], rp_target[f], alpha[f], byte_cnt[f], tmr[f],
                   alpha_tmr[f], (float)bc_stage[f], (float)t_stage[f]},
            cnp > 0.0f);
        rate[f] = o.rate;
        rp_target[f] = o.target;
        alpha[f] = o.alpha;
        byte_cnt[f] = o.byte_cnt;
        tmr[f] = o.tmr;
        alpha_tmr[f] = o.alpha_tmr;
        bc_stage[f] = (int)o.bc_stage;
        t_stage[f] = (int)o.t_stage;
      } else if (react_code == 2) {
        const float slope = __fmul_rn(
            fp[FR_ERP_RAI],
            __fadd_rn(1.0f, __fmul_rn(fp[FR_ERP_JITTER], a.jitter[rF + f])));
        float rt = rate[f], hd = hold[f];
        cc::erp_flow(fp + FR_ERP, rt, hd, cnp > 0.0f, tgt_rx, slope);
        rate[f] = rt;
        hold[f] = hd;
      } else if (react_code == 3) {
        float qd = 0.0f;
        for (int h = 0; h < H; ++h) {
          const bool holds = p.valid[h] && h < p.n - 1;
          const float x = holds ? qh[f * H + h] : 0.0f;
          qd = h == 0 ? x : __fadd_rn(qd, x);
        }
        float rt = rate[f], cool = swift_cool[f];
        cc::swift_flow(fp + FR_SWIFT, rt, cool, __fdiv_rn(qd, line_rate));
        rate[f] = rt;
        swift_cool[f] = cool;
      } else {
        rate[f] = tmin(gen_rate[f], line_rate);
      }

      if (pidx[f] > 0) ++nonmin;
      if (block) {
        ((int*)a.tr_marked)[rF + f] += marked ? 1 : 0;
        ((int*)a.tr_cnp)[rF + f] += cnp > 0.0f ? 1 : 0;
        a.tr_ctrl[rF + f] = __fadd_rn(a.tr_ctrl[rF + f], emit);
      } else {
        ((unsigned char*)a.tr_marked)[rF + f] = marked ? 1 : 0;
        ((unsigned char*)a.tr_cnp)[rF + f] = cnp > 0.0f ? 1 : 0;
        a.tr_ctrl[rF + f] = emit;
      }
    }
    if (nonmin) atomicAdd(&cnt[1], nonmin);
    __syncthreads();

    // ---- the step's per-run trace, folded into the window in block mode --
    if (tid == 0) {
      float mq = red[0];
      for (int w = 1; w < (nth + 31) / 32; ++w) mq = tmax(mq, red[w]);
      const int npz = cnt[0], nm = cnt[1];
      const float pt = __fmul_rn((float)npz, dt);
      if (block) {
        a.tr_max_q[r] = tmax(a.tr_max_q[r], mq);
        a.tr_n_paused[r] = max(a.tr_n_paused[r], npz);
        a.tr_n_nonmin[r] = max(a.tr_n_nonmin[r], nm);
        a.tr_pause_time[r] = __fadd_rn(a.tr_pause_time[r], pt);
        for (int v = 0; v < V; ++v)
          a.tr_vc_stall[r * V + v] = __fadd_rn(
              a.tr_vc_stall[r * V + v], __fmul_rn((float)cnt[4 + v], dt));
      } else {
        a.tr_max_q[r] = mq;
        a.tr_n_paused[r] = npz;
        a.tr_n_nonmin[r] = nm;
        a.tr_pause_time[r] = pt;
        for (int v = 0; v < V; ++v)
          a.tr_vc_stall[r * V + v] = __fmul_rn((float)cnt[4 + v], dt);
      }
      for (int i = 0; i < 4 + V; ++i) cnt[i] = 0;
      *tp = t + 1;
    }
    __syncthreads();
  }

  if (block) {
    const float window = fp[FR_WINDOW];
    for (int f = tid; f < F; f += nth)
      a.tr_inst_thr[rF + f] = __fdiv_rn(
          __fsub_rn(delivered[f], a.tr_inst_thr[rF + f]), window);
  }
}

}  // namespace

// ---- plain C entry points (loaded with ctypes) ----------------------------

extern "C" int fs_mega(const MegaArgs* args, long long smem_bytes,
                       void* stream) {
  if (args->R <= 0) return 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  mega_kernel<<<(unsigned int)args->R, kThreads, (size_t)smem_bytes,
                (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" long long fs_args_size() { return (long long)sizeof(MegaArgs); }

extern "C" long long fs_row_sizes(long long which) {
  return which == 0 ? (long long)FR_COUNT : (long long)IR_COUNT;
}

extern "C" const char* fs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
