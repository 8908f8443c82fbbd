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
// Bound on this card: latency, not bytes.  A step moves ~150 B per flow
// and hop; the time goes to chains of dependent loads (each queue's
// ordered sum over its incidence rows, five times a step), to the phase
// barriers and to how few SMs a run gets.  The design answers each:
//
//  * One thread-block cluster per run.  The host's plan
//    (kernels/fluid_step.py::mega_geometry) gives each run c CTAs,
//    c = min(8, max(1, 132 // R)), at most the CTAs its F flows fill
//    (ceil(F / kThreads)), lowered until R clusters are resident at once:
//    c = 3 at the DC cell's 36 runs, 1 at the paper cell's 5 flows.
//    CTA rank i of a cluster owns the i-th equal slice of the run's
//    flows, of its wires (with their V queues each) and of its switches.
//    Phase barriers are cluster barriers (barrier.cluster.arrive.release
//    / wait.acquire); a run of one CTA uses __syncthreads().
//  * Replicas in shared memory.  Every per-queue and per-wire value a
//    flow phase reads (FIFO factor, backlog, paused flag, the wire sums,
//    the capacities) has a replica in each CTA of the cluster.  The CTA
//    that owns a queue or wire computes it and pushes it into every
//    replica through distributed shared memory before the barrier, so
//    the flow phases read only their own shared memory.
//  * Ordered sums without gathers.  A flow phase stores each channel
//    value of its path's hops straight into the shared memory of the CTA
//    that owns the hop's queue, at the row's place in the queue's
//    incidence (CSR) order (a per-hop position table built on the
//    host).  Each queue is then still summed by one thread, in CSR row
//    order, from +0.0, now from its own shared memory.  Rows of
//    unselected candidate paths hold +0.0 (the owner clears its rows
//    before each phase when K > 1), which adds exactly like the plain
//    step's +0.0 terms, so every bit is kept.  Where those rows do not
//    fit, the flow phases write the channel rows to global memory and
//    the walk gathers them by the run's row ids, 8 rows' loads in
//    flight before it adds.
//  * Per-flow constants on chip.  Each hop's queue id and position of
//    every candidate path of a CTA's flows (int32) and the hop counts
//    are staged in shared memory for the whole window where they fit;
//    a flow's state is loaded into registers before any of it is
//    stored, so its loads go out together.
//  * The operands are a __grid_constant__ struct, read in place (no
//    per-thread copy of the argument block into local memory).
//
// State stays in global memory (a DC-scale batch is ~10 MB, held in the
// 50 MB L2).  The kernel first copies each CTA's slice of its run's
// input state into the output buffers and then updates those in place;
// a flow's state is read and written only by its own thread.
//
// Order of sums.  Each queue's sum walks the run's sorted incidence CSR
// (ScenarioDev.red_perm / red_off) in order from +0.0, one thread per
// queue; the pool walks links in pool_perm order.  These are the orders
// of the port's plain step, so the kernel is bitwise equal to the flow
// tier on the card.  Every float operation is an explicit
// round-to-nearest intrinsic (no FMA contraction), and max / min follow
// torch.maximum / minimum (NaN propagates); the run's largest backlog is
// folded in a fixed order (threads, warps, then cluster ranks).  The
// per-flow CC arithmetic is cc_device.cuh, shared with cc_step.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cc_device.cuh"

namespace cg = cooperative_groups;

namespace {

using cc::tclip;
using cc::tmax;
using cc::tmin;

constexpr int kThreads = 384;
constexpr int kMaxHops = 8;
constexpr int kMaxCluster = 8;
constexpr int kChunk = 8;           // rows a walk loads before it adds

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
  long long cluster, q_cap, flow_cap, rows_cap, pool_cap, push_rows,
      stage_paths;
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
  const int* path_q;
  const int* path_n;
  const int* path_pos;
  const int* red_rows;
  const long long* red_off;
  const int* pool_rows;
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

// 4-byte words of dynamic shared memory (the layout in mega_kernel):
// replicas Bq, fifo, psm [S + 1], wsw, wact, wdem, wsur, whvy, wpool,
// cap [L + 1], phot [NSW]; the CTA's own per-queue sums qsum [3][q_cap];
// 32 warp maxima, 4 + V counters, the cluster's partials
// [kMaxCluster][3 + V] and the pool rows of its switches; then the
// pushed channel values of its queues' rows [3][rows_cap] and the staged
// paths.
// kernels/fluid_step.py::smem_words mirrors it.
__host__ __device__ inline long long smem_words(const MegaArgs& a) {
  return 3 * (a.S + 1) + 7 * (a.L + 1) + a.NSW + 3 * a.q_cap + 32 +
         (4 + a.V) + kMaxCluster * (3 + a.V) + a.pool_cap +
         (a.push_rows ? 3 * a.rows_cap : 0) +
         (a.stage_paths
              ? a.flow_cap * a.K * (a.H + 1) +
                    (a.push_rows ? a.flow_cap * a.K * a.H : 0)
              : 0);
}

// Phase timers of the step loop, in the timed instance of the kernel's
// body only (mega_kernel_timed, launched while fs_phase_timers has them
// on; mega_kernel, the instance every other launch and every captured
// graph runs, holds no timer code).  A mark follows the loop's entry, the
// top of each step, every barrier inside it and the loop's exit; thread 0
// of block 0 (run 0, cluster rank 0) adds the clock64() cycles since the
// previous mark, and one, to the slot of each mark, and the loop's
// %globaltimer nanoseconds, entry to exit, to loop_ns.  Everything lives
// in global memory, written by the one thread.  kernels/fluid_step.py
// names the slots (PHASES).
constexpr int kPhaseMarks = 16;

struct PhaseAcc {
  unsigned long long cycles[kPhaseMarks];  // per mark: the intervals'
  unsigned long long n[kPhaseMarks];       // cycles, and their count
  unsigned long long last;                 // clock64() at the last mark
  unsigned long long c0, t0;               // clock64(), %globaltimer at entry
  unsigned long long loop_ns, loop_cycles, loops;
};

__device__ PhaseAcc g_phase;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool kTimed>
__device__ __forceinline__ void phase_enter() {
  if constexpr (kTimed) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    volatile PhaseAcc* p = &g_phase;
    const unsigned long long now = (unsigned long long)clock64();
    p->last = now;
    p->c0 = now;
    p->t0 = global_ns();
  }
}

template <bool kTimed>
__device__ __forceinline__ void phase_mark(int k) {
  if constexpr (kTimed) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    volatile PhaseAcc* p = &g_phase;
    const unsigned long long now = (unsigned long long)clock64();
    p->cycles[k] += now - p->last;
    p->n[k] += 1;
    p->last = now;
  }
}

template <bool kTimed>
__device__ __forceinline__ void phase_exit(int k) {
  if constexpr (kTimed) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    phase_mark<true>(k);
    volatile PhaseAcc* p = &g_phase;
    p->loop_cycles += p->last - p->c0;
    p->loop_ns += global_ns() - p->t0;
    p->loops += 1;
  }
}

// A barrier of the run: the cluster's, with release / acquire so that
// what a CTA pushed into another's shared memory is seen after it; for
// a run of one CTA the CTA's own, which needs no cluster-scope fence and
// measured faster (PERF.md).
__device__ __forceinline__ void run_sync(int c) {
  if (c == 1) {
    __syncthreads();
    return;
  }
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// x into slot i of the replica `local` of every CTA of the cluster
__device__ __forceinline__ void push(float* local, long long i, float x,
                                     int c) {
  cg::cluster_group cl = cg::this_cluster();
  for (int k = 0; k < c; ++k) *cl.map_shared_rank(local + i, k) = x;
}

// the start of rank i's equal slice of n items
__device__ __forceinline__ int slice(long long n, int i, int c) {
  return (int)(n * i / c);
}

// words of leaf i per run
__device__ __forceinline__ long long leaf_words(const MegaArgs& a, int i) {
  switch (i) {
    case L_QH: case L_EST: return a.F * a.H;
    case L_PAUSED: return a.S;
    case L_TRIG_BUF: case L_TGT_BUF: return a.D * a.F;
    case L_T: return 1;
    default: return a.F;
  }
}

// dst[j] = src[j] for j in [lo, hi) by the CTA's threads, kCopy loads in
// flight a thread before its stores
constexpr int kCopy = 8;
__device__ __forceinline__ void copy_words(unsigned* dst, const unsigned* src,
                                           long long lo, long long hi) {
  for (long long j = lo + threadIdx.x; j < hi;
       j += (long long)kCopy * blockDim.x) {
    unsigned v[kCopy];
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const long long x = j + (long long)u * blockDim.x;
      v[u] = x < hi ? src[x] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const long long x = j + (long long)u * blockDim.x;
      if (x < hi) dst[x] = v[u];
    }
  }
}

// Where a flow phase puts a channel value of one of its hops' rows: into
// the owner CTA's pushed rows (pos = owner rank << 24 | the row's index
// among the owner's rows; -1 for a PAD hop, whose scratch queue is never
// summed) or, without push, into the global channel rows [F*H][3].
struct RowSink {
  float* cbuf;          // this CTA's [3][rows_cap] (the same offset in all)
  int rows_cap;
  bool push;
  float* chan;
};

__device__ __forceinline__ void put(const RowSink& w, int pos, long long fh,
                                    int ch, float x) {
  if (w.push) {
    if (pos >= 0) {
      cg::cluster_group cl = cg::this_cluster();
      *cl.map_shared_rank(w.cbuf + ch * w.rows_cap + (pos & 0xffffff),
                          pos >> 24) = x;
    }
  } else {
    w.chan[fh * 3 + ch] = x;
  }
}

// One flow's selected path: per-hop queue ids (S for PAD), positions of
// its rows and the hop count, copied to registers (MH >= H hops).
template <int MH>
struct Path {
  int n;
  int q[MH];
  int pos[MH];
};

// Sum C channels per queue of [q0, q1) in incidence order from +0.0,
// one thread per queue; qsum is [C][q_cap], indexed by q - q0.  With
// pushed rows the values are this CTA's cbuf ([3][rows_cap], row j of
// the run at j - off[q0]); without, rows[j - off[q0]] (global memory)
// names entry j's (flow, candidate, hop) row and the walk gathers its
// channel values from global memory (skipping unselected candidates),
// kChunk rows' loads before it adds them in order.
template <int C>
__device__ __forceinline__ void walk(const MegaArgs& a, const RowSink& w,
                                     const float* chan, const int* pidx,
                                     const int* rows, const long long* off,
                                     int q0, int q1, float* qsum) {
  const int K = (int)a.K, H = (int)a.H, q_cap = (int)a.q_cap;
  const long long j0 = off[q0];
  for (int q = q0 + (int)threadIdx.x; q < q1; q += (int)blockDim.x) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    const long long j1 = off[q + 1];
    if (w.push) {
      const float* x = w.cbuf - j0;
#pragma unroll 4
      for (long long j = off[q]; j < j1; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = __fadd_rn(acc[c], x[c * w.rows_cap + j]);
    } else {
      for (long long j = off[q]; j < j1; j += kChunk) {
        const int n = (int)min((long long)kChunk, j1 - j);
        float val[kChunk][C];
        bool keep[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          keep[u] = false;
          if (u < n) {
            const int row = rows[j - j0 + u];
            int ci = row;
            if (K > 1) {
              const int fk = row / H;
              const int h = row - fk * H;
              const int f = fk / K;
              keep[u] = fk - f * K == __ldcg(pidx + f);
              ci = f * H + h;
            } else {
              keep[u] = true;
            }
#pragma unroll
            for (int c = 0; c < C; ++c)
              val[u][c] = __ldcg(chan + (long long)ci * 3 + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (keep[u]) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              acc[c] = __fadd_rn(acc[c], val[u][c]);
          }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) qsum[c * q_cap + (q - q0)] = acc[c];
  }
}

// +0.0 into channels [0, C) of this CTA's n pushed rows (K > 1: the
// rows of unselected candidates must read as the plain step's zeros)
template <int C>
__device__ __forceinline__ void clear_rows(const RowSink& w, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x)
#pragma unroll
    for (int c = 0; c < C; ++c) w.cbuf[c * w.rows_cap + j] = 0.0f;
}

// queue q's channel-c sum folded over the V queues of wire l, in VC
// order (qsum as in walk)
__device__ __forceinline__ float wire_sum(const float* qsum, int q_cap,
                                          int c, int l, int V, int q0) {
  const float* x = qsum + c * q_cap + (l * V - q0);
  float acc = x[0];
  for (int v = 1; v < V; ++v) acc = __fadd_rn(acc, x[v]);
  return acc;
}

__device__ __forceinline__ int wire_of(int q, int V, int S, int L) {
  return q < S ? (V == 1 ? q : q / V) : L;
}

// MH: the hop capacity of the per-flow register arrays (>= H; the
// launch picks the smallest of 4, 6 and kMaxHops that holds H); kTimed:
// the phase timers' instance
template <int MH, bool kTimed>
__device__ __forceinline__ void mega_body(const MegaArgs& a) {
  extern __shared__ float smem[];
  const int c = (int)a.cluster;
  const int rank = (int)cluster_rank();
  const long long r = blockIdx.x / c;
  const int F = (int)a.F, H = (int)a.H, K = (int)a.K, L = (int)a.L;
  const int V = (int)a.V, S = (int)a.S, D = (int)a.D, NSW = (int)a.NSW;
  const int tid = threadIdx.x, nth = blockDim.x;
  const bool block = a.block != 0, push_rows = a.push_rows != 0;
  const int q_cap = (int)a.q_cap;
  // this CTA's flows, wires (queues) and switches
  const int f0 = slice(F, rank, c), f1 = slice(F, rank + 1, c);
  const int l0 = slice(L, rank, c), l1 = slice(L, rank + 1, c);
  const int q0 = l0 * V, q1 = l1 * V;
  const int w0 = slice(NSW, rank, c), w1 = slice(NSW, rank + 1, c);

  float* Bq = smem;                   // [S + 1] queue backlog (B1)
  float* fifo = Bq + (S + 1);         // [S + 1] FIFO head-of-line factor
  float* psm = fifo + (S + 1);        // [S + 1] paused flags (slot S: 0)
  float* wsw = psm + (S + 1);         // [L + 1] B_prev, then sum_w per wire
  float* wact = wsw + (L + 1);        // [L + 1] active contributors
  float* wdem = wact + (L + 1);       // [L + 1] summed demand
  float* wsur = wdem + (L + 1);       // [L + 1] fair-share surplus
  float* whvy = wsur + (L + 1);       // [L + 1] heavy contributors
  float* wpool = whvy + (L + 1);      // [L + 1] pool input per link
  float* cap = wpool + (L + 1);       // [L + 1] the run's capacities
  float* phot = cap + (L + 1);        // [NSW] switch pool over xoff
  float* qsum = phot + NSW;           // [3][q_cap] own per-queue sums
  float* red = qsum + 3 * q_cap;      // [32] warp partial maxima
  int* cnt = (int*)(red + 32);        // [4 + V] per-step counters
  int* xred = cnt + 4 + V;            // [kMaxCluster][3 + V] rank partials
  int* spool = xred + kMaxCluster * (3 + V);        // [pool_cap]
  float* cbuf = (float*)(spool + a.pool_cap);        // rows of own queues
  int* spath = (int*)cbuf + (push_rows ? 3 * a.rows_cap : 0);
  int* shops = spath + (a.stage_paths ? a.flow_cap * K * H : 0);
  int* spos = shops + (a.stage_paths ? a.flow_cap * K : 0);

  const long long N = a.F * a.K * a.H;
  const long long* off = a.red_off + r * (a.S + 2);
  const long long* po = a.pool_off + r * (NSW + 1);
  const int* rows = a.red_rows + r * N + off[q0];     // without push
  const long long fk0 = (r * a.F + f0) * a.K;        // first own (f, k)
  const int* pth = a.stage_paths ? spath : a.path_q + fk0 * a.H;
  const int* phn = a.stage_paths ? shops : a.path_n + fk0;
  const int* pps = a.stage_paths ? spos : a.path_pos + fk0 * a.H;
  float* chan = a.scratch + r * (long long)F * H * 4;   // [F*H][3]
  float* Tb = chan + (long long)F * H * 3;               // [F*H]
  const RowSink sinkw{cbuf, (int)a.rows_cap, push_rows, chan};
  const int n_own_rows = (int)(off[q1] - off[q0]);
  // candidate k of own flow f, into registers
  auto path = [&](int f, int k) {
    const long long i = (long long)(f - f0) * K + k;
    Path<MH> p;
    p.n = phn[i];
#pragma unroll
    for (int h = 0; h < MH; ++h)
      if (h < H) {
        p.q[h] = pth[i * H + h];
        p.pos[h] = push_rows ? pps[i * H + h] : -1;
      }
    return p;
  };

  // ---- copy this CTA's slice of the run's state, stage, zero ----------
#pragma unroll
  for (int i = 0; i < N_LEAVES; ++i) {
    if (i == L_T) continue;
    const long long n = leaf_words(a, i);
    const unsigned* src = (const unsigned*)a.st_in[i] + r * n;
    unsigned* dst = (unsigned*)a.st_out[i] + r * n;
    if (i == L_PAUSED) {
      copy_words(dst, src, q0, q1);
    } else if (i == L_TRIG_BUF || i == L_TGT_BUF) {
      for (int d = 0; d < D; ++d)
        copy_words(dst + (long long)d * F, src + (long long)d * F, f0, f1);
    } else {
      const int per = (int)(n / a.F);                 // 1 or H
      copy_words(dst, src, (long long)f0 * per, (long long)f1 * per);
    }
  }
  {
    const float* pin = (const float*)a.st_in[L_PAUSED] + r * S;
    for (int q = tid; q <= S; q += nth) {
      psm[q] = q < S ? pin[q] : 0.0f;
      if (q == S) {
        Bq[S] = 0.0f;
        fifo[S] = 1.0f;
      }
    }
    const float* cap_in = a.cap_ext + r * (L + 1);
    for (int l = tid; l <= L; l += nth) cap[l] = cap_in[l];
    if (tid == 0) {
      wsw[L] = wact[L] = wdem[L] = wsur[L] = whvy[L] = wpool[L] = 0.0f;
      for (int i = 0; i < 4 + V; ++i) cnt[i] = 0;
    }
    const int* ps = a.pool_rows + r * L + po[w0];
    const int np = (int)(po[w1] - po[w0]);
    for (int j = tid; j < np; j += nth) spool[j] = ps[j];
    if (push_rows && K > 1) clear_rows<3>(sinkw, n_own_rows);
    if (a.stage_paths) {
      const int nk = (f1 - f0) * K;
      for (int j = tid; j < nk * H; j += nth) {
        spath[j] = a.path_q[fk0 * a.H + j];
        if (push_rows) spos[j] = a.path_pos[fk0 * a.H + j];
      }
      for (int j = tid; j < nk; j += nth) shops[j] = a.path_n[fk0 + j];
    }
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

  const float* fp = a.fpar + r * a.nfp;
  const int* ip = a.ipar + r * a.nip;
  const float dt = fp[FR_DT], line_rate = fp[FR_LINE_RATE];
  const int mark_code = ip[IR_MARK_CODE], notif_code = ip[IR_NOTIF_CODE];
  const int react_code = ip[IR_REACT_CODE], route_code = ip[IR_ROUTE_CODE];
  const float* gen_rate = a.gen_rate + r * F;
  const float* t_start = a.t_start + r * F;
  const long long* sink = a.sink_ext + r * (L + 1);
  const long long rF = r * F;
  const float INF = INFINITY;
  int t = *((const int*)a.st_in[L_T] + r);

  if (block) {                      // window accumulators; d0 rides in inst_thr
    const float* d_in = (const float*)a.st_in[L_DELIVERED] + r * F;
    for (int f = f0 + tid; f < f1; f += nth) {
      a.tr_inst_thr[rF + f] = d_in[f];
      ((int*)a.tr_marked)[rF + f] = 0;
      ((int*)a.tr_cnp)[rF + f] = 0;
      a.tr_ctrl[rF + f] = 0.0f;
    }
    if (rank == 0 && tid == 0) {
      a.tr_max_q[r] = 0.0f;
      a.tr_n_paused[r] = 0;
      a.tr_n_nonmin[r] = 0;
      a.tr_pause_time[r] = 0.0f;
      for (int v = 0; v < V; ++v) a.tr_vc_stall[r * V + v] = 0.0f;
    }
  }
  __syncthreads();
  run_sync(c);     // every CTA of the cluster is up, its copy is done

  phase_enter<kTimed>();
  for (long long step = 0; step < a.n_substeps; ++step) {
    phase_mark<kTimed>(0);
    const float t_sec = __fmul_rn((float)t, dt);
    const int rslot = t % D;

    // ---- 0. path selection (min / valiant / ugal) -------------------------
    if (K > 1) {
      for (int f = f0 + tid; f < f1; f += nth) {
        const Path<MH> p = path(f, pidx[f]);
        float qf[MH];
#pragma unroll
        for (int h = 0; h < MH; ++h)
          if (h < H) qf[h] = qh[f * H + h];
#pragma unroll
        for (int h = 0; h < MH; ++h)
          if (h < H) {
            const bool hq = p.q[h] < S && h < p.n - 1;
            put(sinkw, p.pos[h], (long long)f * H + h, 0,
                hq ? qf[h] : 0.0f);
          }
      }
      run_sync(c);
      phase_mark<kTimed>(1);
      walk<1>(a, sinkw, chan, pidx, rows, off, q0, q1, qsum);
      __syncthreads();
      phase_mark<kTimed>(2);
      if (push_rows) clear_rows<3>(sinkw, n_own_rows);
      for (int l = l0 + tid; l < l1; l += nth)
        push(wsw, l, wire_sum(qsum, q_cap, 0, l, V, q0), c);
      run_sync(c);
      phase_mark<kTimed>(3);
      for (int f = f0 + tid; f < f1; f += nth) {
        int newk = 0;
        const int cur = pidx[f];
        if (route_code != 0) {
          int n_alt = 0;
          for (int k = 1; k < K; ++k)
            n_alt += phn[(long long)(f - f0) * K + k] > 0;
          const long long samp =
              n_alt > 0 ? 1 + ((long long)f + t) % (long long)max(n_alt, 1)
                        : 0;
          float cost[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {        // candidates samp and 0
            const long long fk = (long long)(f - f0) * K + (i ? 0 : samp);
            float q = 0.0f;
#pragma unroll
            for (int h = 0; h < MH; ++h)
              if (h < H) {
                const int qi = pth[fk * H + h];
                const float x = qi < S ? wsw[wire_of(qi, V, S, L)] : 0.0f;
                q = h == 0 ? x : __fadd_rn(q, x);
              }
            cost[i] = __fmul_rn((float)phn[fk], q);
          }
          const long long ugal = cost[0] < cost[1] ? samp : 0;
          const float ts = t_start[f];
          const bool starting = (t_sec >= ts) && (__fsub_rn(t_sec, dt) < ts);
          const bool cnp_now = trig[(long long)rslot * F + f] > 0.0f;
          const bool epoch = starting || (route_code == 2 && cnp_now);
          const long long pick = route_code == 1 ? samp : ugal;
          newk = epoch ? (int)pick : cur;
        }
        pidx[f] = newk;
      }
    }

    // ---- 1. generation (+ notification-timer tick), 2a. transfer sums -----
    for (int f = f0 + tid; f < f1; f += nth) {
      const Path<MH> p = path(f, K > 1 ? pidx[f] : 0);
      float qf[MH];
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) qf[h] = qh[f * H + h];
      const float rt = rate[f];
      const cc::GenNp g = cc::gen_np_flow(
          t_sec, dt, cc::GenNp{nicq[f], offered[f], dropped[f], np_tmr[f]},
          gen_rate[f], t_start[f], a.t_stop[rF + f], a.volume[rF + f],
          a.nic_buffer[rF + f]);
      const float src_inj = tmin(g.nicq, __fmul_rn(tmin(rt, line_rate), dt));
      float wo[MH];
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) wo[h] = __fsub_rn(1.0f, psm[p.q[h]]);
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) {
          const bool valid = p.q[h] < S;
          const float next_open = h + 1 < H ? wo[h + 1] : 1.0f;
          const bool holds = valid && h < p.n - 1;
          const float q_here = holds ? qf[h] : 0.0f;
          const float src_q = valid ? (h == 0 ? src_inj : qf[h - 1]) : 0.0f;
          const long long fh = (long long)f * H + h;
          put(sinkw, p.pos[h], fh, 0, __fmul_rn(q_here, next_open));
          put(sinkw, p.pos[h], fh, 1, q_here);
          put(sinkw, p.pos[h], fh, 2, __fmul_rn(src_q, wo[h]));
        }
      nicq[f] = g.nicq;
      offered[f] = g.offered;
      dropped[f] = g.dropped;
      np_tmr[f] = g.np_tmr;         // post-tick timer until phase 5
    }
    run_sync(c);
    phase_mark<kTimed>(4);
    walk<3>(a, sinkw, chan, pidx, rows, off, q0, q1, qsum);
    __syncthreads();
    phase_mark<kTimed>(5);
    if (push_rows && K > 1) clear_rows<3>(sinkw, n_own_rows);
    for (int l = l0 + tid; l < l1; l += nth) {
      for (int v = 0; v < V; ++v) {
        const int q = l * V + v;
        const float num = qsum[q - q0], den = qsum[q_cap + q - q0];
        push(fifo, q,
             den > 0.0f ? __fdiv_rn(num, tmax(den, (float)1e-9)) : 1.0f, c);
      }
      push(wsw, l, wire_sum(qsum, q_cap, 2, l, V, q0), c);
    }
    run_sync(c);
    phase_mark<kTimed>(6);

    // ---- 2b. transfers: shares, queues, delivery, crossing-rate EWMA ------
    for (int f = f0 + tid; f < f1; f += nth) {
      const Path<MH> p = path(f, K > 1 ? pidx[f] : 0);
      const float nq = nicq[f], rt = rate[f], d_old = delivered[f];
      float qold[MH], e_old[MH], T[MH];
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) {
          qold[h] = qh[f * H + h];
          e_old[h] = est[f * H + h];
        }
      const float src_inj = tmin(nq, __fmul_rn(tmin(rt, line_rate), dt));
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) {
          const int qi = p.q[h];
          const bool valid = qi < S;
          const int wi = wire_of(qi, V, S, L);
          const float wo = __fsub_rn(1.0f, psm[qi]);
          const float src_q =
              valid ? (h == 0 ? src_inj : qold[h - 1]) : 0.0f;
          const float weight = __fmul_rn(src_q, wo);
          const float budget = __fmul_rn(__fmul_rn(cap[wi], dt), fifo[qi]);
          const float sww = wsw[wi];
          const float share =
              sww > 0.0f ? __fdiv_rn(__fmul_rn(budget, weight),
                                     tmax(sww, (float)1e-9))
                         : 0.0f;
          T[h] = tmin(weight, share);
        }
      float deliv = 0.0f, qn[MH];
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) {
          const bool valid = p.q[h] < S;
          const bool holds = valid && h < p.n - 1;
          const bool is_last = valid && h == p.n - 1;
          float x = __fsub_rn(qold[h], h + 1 < H ? T[h + 1] : 0.0f);
          qn[h] = tmax(__fadd_rn(x, holds ? T[h] : 0.0f), 0.0f);
          deliv = __fadd_rn(deliv, is_last ? T[h] : 0.0f);
        }
      const float beta = fp[FR_ECP_BETA];
      const float omb = __fsub_rn(1.0f, beta);
      float e[MH];
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H)
          e[h] = __fadd_rn(__fmul_rn(omb, e_old[h]),
                           __fmul_rn(beta, __fdiv_rn(T[h], dt)));
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) {
          const bool valid = p.q[h] < S;
          const bool holds = valid && h < p.n - 1;
          const float dem = valid ? (h == 0 ? e[0] : e[h - 1]) : 0.0f;
          const bool act = (dem > 1e6f) && valid;
          const long long fh = (long long)f * H + h;
          put(sinkw, p.pos[h], fh, 0, holds ? qn[h] : 0.0f);
          put(sinkw, p.pos[h], fh, 1, act ? 1.0f : 0.0f);
          put(sinkw, p.pos[h], fh, 2, act ? dem : 0.0f);
        }
      nicq[f] = __fsub_rn(nq, T[0]);
      delivered[f] = __fadd_rn(d_old, deliv);
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) {
          qh[f * H + h] = qn[h];
          est[f * H + h] = e[h];
          Tb[(long long)f * H + h] = T[h];
        }
      if (!block) a.tr_inst_thr[rF + f] = __fdiv_rn(deliv, dt);
    }
    run_sync(c);
    phase_mark<kTimed>(7);

    // ---- 3. PFC: per-queue hysteresis, wire sums, pool inputs -------------
    walk<3>(a, sinkw, chan, pidx, rows, off, q0, q1, qsum);
    __syncthreads();
    phase_mark<kTimed>(8);
    if (push_rows && K > 1) clear_rows<2>(sinkw, n_own_rows);
    {
      const float xoff_q = V == 1 ? fp[FR_XOFF]
          : __fmul_rn(fp[FR_XOFF], __fdiv_rn(1.0f, (float)V));
      const float xon_q = V == 1 ? fp[FR_XON]
          : __fmul_rn(fp[FR_XON], __fdiv_rn(1.0f, (float)V));
      for (int l = l0 + tid; l < l1; l += nth) {
        for (int v = 0; v < V; ++v) {
          const int q = l * V + v;
          const float B = qsum[q - q0];
          push(Bq, q, B, c);
          // the hysteresis result waits in this CTA's own replica until
          // the pool is folded in (nobody else reads it before then)
          psm[q] = B > xoff_q ? 1.0f : (B < xon_q ? 0.0f : psm[q]);
        }
        push(wact, l, wire_sum(qsum, q_cap, 1, l, V, q0), c);
        push(wdem, l, wire_sum(qsum, q_cap, 2, l, V, q0), c);
        push(wpool, l,
             sink[l] >= 0 ? wire_sum(qsum, q_cap, 0, l, V, q0) : 0.0f, c);
      }
    }
    run_sync(c);
    phase_mark<kTimed>(9);

    // ---- 3b. the switch pool; 4a. fair-share surplus inputs ---------------
    {
      const float pool_xoff = fp[FR_POOL_XOFF];
      const long long pb = po[w0];
      for (int sw = w0 + tid; sw < w1; sw += nth) {
        float acc = 0.0f;
        for (long long j = po[sw]; j < po[sw + 1]; ++j)
          acc = __fadd_rn(acc, wpool[spool[j - pb]]);
        push(phot, sw, acc > pool_xoff ? 1.0f : 0.0f, c);
      }
    }
    for (int f = f0 + tid; f < f1; f += nth) {
      const Path<MH> p = path(f, K > 1 ? pidx[f] : 0);
      float ef[MH];
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) ef[h] = est[f * H + h];
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) {
          const int qi = p.q[h];
          const bool valid = qi < S;
          const int wi = wire_of(qi, V, S, L);
          const float dem = valid ? (h == 0 ? ef[0] : ef[h - 1]) : 0.0f;
          const bool act = (dem > 1e6f) && valid;
          const float share0 = __fdiv_rn(cap[wi], tmax(wact[wi], 1.0f));
          const bool under = dem < share0;
          const long long fh = (long long)f * H + h;
          put(sinkw, p.pos[h], fh, 0,
              (act && under) ? __fsub_rn(share0, dem) : 0.0f);
          put(sinkw, p.pos[h], fh, 1, (act && !under) ? 1.0f : 0.0f);
        }
    }
    run_sync(c);
    phase_mark<kTimed>(10);

    // ---- 3c. paused = max(hysteresis, pool); 4a. surplus sums -------------
    walk<2>(a, sinkw, chan, pidx, rows, off, q0, q1, qsum);
    {
      float lmax = -INFINITY;
      int npz = 0;
      for (int q = q0 + tid; q < q1; q += nth) {
        const long long sk = sink[q / V];
        const float pz = tmax(psm[q], sk >= 0 ? phot[sk] : 0.0f);
        paused[q] = pz;
        push(psm, q, pz, c);
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
    __syncthreads();
    phase_mark<kTimed>(11);
    if (push_rows && K > 1) clear_rows<1>(sinkw, n_own_rows);
    for (int l = l0 + tid; l < l1; l += nth) {
      push(wsur, l, wire_sum(qsum, q_cap, 0, l, V, q0), c);
      push(whvy, l, wire_sum(qsum, q_cap, 1, l, V, q0), c);
    }
    run_sync(c);
    phase_mark<kTimed>(12);

    // ---- 4b. marking, 5. notification + delay line, 6. reaction -----------
    int nonmin = 0;
    for (int f = f0 + tid; f < f1; f += nth) {
      const int pk = K > 1 ? pidx[f] : 0;
      const Path<MH> p = path(f, pk);
      // everything this flow reads, before any of it is written
      float ef[MH], qf[MH], tf[MH];
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) {
          ef[h] = est[f * H + h];
          qf[h] = qh[f * H + h];
          tf[h] = Tb[(long long)f * H + h];
        }
      const float sacc = slope_acc[f], tmr_t = np_tmr[f];
      const long long rtt = a.rtt[rF + f];
      const float trig_r = trig[(long long)rslot * F + f];
      const float tgt_r = tgtb[(long long)rslot * F + f];
      float rt = rate[f];
      cc::RP rp{};
      float hd = 0.0f, jit = 0.0f, cool = 0.0f, gr = 0.0f;
      if (react_code == 1) {
        rp = cc::RP{rt, rp_target[f], alpha[f], byte_cnt[f], tmr[f],
                    alpha_tmr[f], (float)bc_stage[f], (float)t_stage[f]};
      } else if (react_code == 2) {
        hd = hold[f];
        jit = a.jitter[rF + f];
      } else if (react_code == 3) {
        cool = swift_cool[f];
      } else {
        gr = gen_rate[f];
      }
      int acc_mk = 0, acc_cn = 0;
      float acc_ctrl = 0.0f;
      if (block) {
        acc_mk = ((int*)a.tr_marked)[rF + f];
        acc_cn = ((int*)a.tr_cnp)[rF + f];
        acc_ctrl = a.tr_ctrl[rF + f];
      }

      // marking (cc.MARKING: 0 cp, 1 ecp, 2 slope), hop by hop: hop h
      // reads the next hop's demand, grant and overload, which are
      // computed one hop ahead, and folds its mark into the flow's at
      // once (slope's coin flip zeroes every mark afterwards)
      const float thresh = mark_code == 1 ? fp[FR_ECP_THRESH]
                         : mark_code == 2 ? fp[FR_SLOPE_KMIN] : fp[FR_CP_KMIN];
      const float port_buffer = fp[FR_PORT_BUFFER];
      const float drain = fp[FR_DRAIN_GAIN];
      float prob = 0.0f;
      bool marked = false;
      float tgt = INF, mlvl = 0.0f, best = 0.0f;
      int hm = 0;
#pragma unroll
      for (int h = 0; h < MH; ++h)
        if (h < H) {
          float dn = 0.0f, on = 0.0f, gn = INF;     // hop h + 1
          if (h + 1 < H) {
            const int qi = p.q[h + 1];
            const bool valid = qi < S;
            dn = valid ? ef[h] : 0.0f;
            const bool act = (dn > 1e6f) && valid;
            const int w = wire_of(qi, V, S, L);
            const float caps = cap[w];
            const float share0 = __fdiv_rn(caps, tmax(wact[w], 1.0f));
            const bool under = dn < share0;
            const float g = under ? dn
                : __fadd_rn(share0, __fdiv_rn(wsur[w], tmax(whvy[w], 1.0f)));
            gn = act ? g : caps;
            on = wdem[w] > caps ? 1.0f : 0.0f;
          }
          const bool valid = p.q[h] < S;
          const bool holds = valid && h < p.n - 1;
          gn = holds ? gn : INF;
          const float b1w = Bq[p.q[h]];
          const bool present = qf[h] > 0.0f || tf[h] > 0.0f;
          const float base =
              (b1w > thresh && present && holds) ? 1.0f : 0.0f;
          const float qexc = tclip(
              __fdiv_rn(__fsub_rn(b1w, thresh), port_buffer), 0.0f, 1.0f);
          const bool finite = isfinite(gn);
          const float sev = finite
              ? __fmul_rn(finite ? gn : 0.0f,
                          __fsub_rn(1.0f, __fmul_rn(drain, qexc)))
              : INF;
          float mf = base;
          if (mark_code == 1) {
            const bool congesting =
                on > 0.0f && dn > __fmul_rn(fp[FR_ECP_SLACK], gn);
            mf = __fmul_rn(base, congesting ? 1.0f : 0.0f);
          } else if (mark_code == 2) {
            const float kmin = fp[FR_SLOPE_KMIN], kmax = fp[FR_SLOPE_KMAX];
            const float ramp = tclip(
                __fdiv_rn(__fsub_rn(b1w, kmin),
                          tmax(__fsub_rn(kmax, kmin), 1.0f)), 0.0f, 1.0f);
            const float pf = __fmul_rn(
                b1w >= kmax ? 1.0f : __fmul_rn(fp[FR_SLOPE_PMAX], ramp),
                base);
            prob = h == 0 ? pf : tmax(prob, pf);
          }
          const bool pos = mf > 0.0f;
          marked = marked || pos;
          const float x = pos ? sev : INF;
          tgt = h == 0 ? x : tmin(tgt, x);
          if (h == 0) {
            mlvl = best = mf;
          } else {
            mlvl = tmax(mlvl, mf);
            if (mf > best) {
              best = mf;
              hm = h;
            }
          }
        }
      if (mark_code == 2) {
        float acc = __fadd_rn(sacc, prob);
        const bool fire = acc >= 1.0f;
        if (fire) acc = __fsub_rn(acc, 1.0f);
        slope_acc[f] = acc;
        if (!fire) {                 // every mark times 0: no mark at all
          marked = false;
          tgt = INF;
          mlvl = 0.0f;
          hm = 0;
        }
      }
      tgt = isfinite(tgt) ? tgt : line_rate;
      mlvl = tmin(mlvl, 1.0f);

      // notification (cc.NOTIFICATION: 0 np, 1 enp, 2 fncc)
      const float window = notif_code == 1 ? fp[FR_ENP_WINDOW]
                         : notif_code == 2 ? fp[FR_FNCC_WINDOW]
                                           : fp[FR_NP_WINDOW];
      const float emit = (mlvl > 0.0f && tmr_t >= window) ? 1.0f : 0.0f;
      np_tmr[f] = emit > 0.0f ? 0.0f : tmr_t;
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
      const float tw_new = __fadd_rn(*tw, emit);
      *tw = tw_new;
      if (emit > 0.0f) tgtb[wslot * F + f] = tgt;
      // the read slot after that write (the same slot when delay % D == 0)
      const bool same = wslot == rslot;
      const float cnp = (same ? tw_new : trig_r) > 0.0f ? 1.0f : 0.0f;
      const float tgt_rx = (same && emit > 0.0f) ? tgt : tgt_r;
      trig[(long long)rslot * F + f] = 0.0f;

      // reaction (cc.REACTION: 0 pfc, 1 rp, 2 erp, 3 swift)
      if (react_code == 1) {
        const cc::RP o = cc::rp_flow(fp + FR_RP, rp, cnp > 0.0f);
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
            fp[FR_ERP_RAI], __fadd_rn(1.0f, __fmul_rn(fp[FR_ERP_JITTER], jit)));
        cc::erp_flow(fp + FR_ERP, rt, hd, cnp > 0.0f, tgt_rx, slope);
        rate[f] = rt;
        hold[f] = hd;
      } else if (react_code == 3) {
        float qd = 0.0f;
#pragma unroll
        for (int h = 0; h < MH; ++h)
          if (h < H) {
            const bool holds = p.q[h] < S && h < p.n - 1;
            const float x = holds ? qf[h] : 0.0f;
            qd = h == 0 ? x : __fadd_rn(qd, x);
          }
        cc::swift_flow(fp + FR_SWIFT, rt, cool, __fdiv_rn(qd, line_rate));
        rate[f] = rt;
        swift_cool[f] = cool;
      } else {
        rate[f] = tmin(gr, line_rate);
      }

      if (pk > 0) ++nonmin;
      if (block) {
        ((int*)a.tr_marked)[rF + f] = acc_mk + (marked ? 1 : 0);
        ((int*)a.tr_cnp)[rF + f] = acc_cn + (cnp > 0.0f ? 1 : 0);
        a.tr_ctrl[rF + f] = __fadd_rn(acc_ctrl, emit);
      } else {
        ((unsigned char*)a.tr_marked)[rF + f] = marked ? 1 : 0;
        ((unsigned char*)a.tr_cnp)[rF + f] = cnp > 0.0f ? 1 : 0;
        a.tr_ctrl[rF + f] = emit;
      }
    }
    if (nonmin) atomicAdd(&cnt[1], nonmin);
    __syncthreads();
    phase_mark<kTimed>(13);

    // ---- this CTA's partials to rank 0, which folds the run's trace -------
    if (tid == 0) {
      float mq = red[0];
      for (int w = 1; w < (nth + 31) / 32; ++w) mq = tmax(mq, red[w]);
      int* slot = xred + rank * (3 + V);
      cg::cluster_group cl = cg::this_cluster();
      int* dst = cl.map_shared_rank(slot, 0);
      dst[0] = __float_as_int(mq);
      dst[1] = cnt[0];
      dst[2] = cnt[1];
      for (int v = 0; v < V; ++v) dst[3 + v] = cnt[4 + v];
      for (int i = 0; i < 4 + V; ++i) cnt[i] = 0;
    }
    run_sync(c);
    phase_mark<kTimed>(14);
    if (rank == 0 && tid == 0) {
      float mq = __int_as_float(xred[0]);
      int npz = xred[1], nm = xred[2];
      for (int k = 1; k < c; ++k) {
        const int* x = xred + k * (3 + V);
        mq = tmax(mq, __int_as_float(x[0]));
        npz += x[1];
        nm += x[2];
      }
      const float pt = __fmul_rn((float)npz, dt);
      if (block) {
        a.tr_max_q[r] = tmax(a.tr_max_q[r], mq);
        a.tr_n_paused[r] = max(a.tr_n_paused[r], npz);
        a.tr_n_nonmin[r] = max(a.tr_n_nonmin[r], nm);
        a.tr_pause_time[r] = __fadd_rn(a.tr_pause_time[r], pt);
      } else {
        a.tr_max_q[r] = mq;
        a.tr_n_paused[r] = npz;
        a.tr_n_nonmin[r] = nm;
        a.tr_pause_time[r] = pt;
      }
      for (int v = 0; v < V; ++v) {
        int nv = 0;
        for (int k = 0; k < c; ++k) nv += xred[k * (3 + V) + 3 + v];
        const float st = __fmul_rn((float)nv, dt);
        a.tr_vc_stall[r * V + v] =
            block ? __fadd_rn(a.tr_vc_stall[r * V + v], st) : st;
      }
    }
    ++t;
  }
  phase_exit<kTimed>(15);

  if (block) {
    const float window = fp[FR_WINDOW];
    for (int f = f0 + tid; f < f1; f += nth)
      a.tr_inst_thr[rF + f] = __fdiv_rn(
          __fsub_rn(delivered[f], a.tr_inst_thr[rF + f]), window);
  }
  if (rank == 0 && tid == 0) *((int*)a.st_out[L_T] + r) = t;
}

template <int MH>
__global__ void __launch_bounds__(kThreads, 1)
mega_kernel(const __grid_constant__ MegaArgs a) {
  mega_body<MH, false>(a);
}

template <int MH>
__global__ void __launch_bounds__(kThreads, 1)
mega_kernel_timed(const __grid_constant__ MegaArgs a) {
  mega_body<MH, true>(a);
}

// The device whose launches run mega_kernel_timed (-1: none).
int g_timed_device = -1;

cudaLaunchConfig_t launch_config(const MegaArgs& a, long long smem_bytes,
                                 cudaStream_t st, cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(a.R * a.cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = st;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned int)a.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// ---- plain C entry points (loaded with ctypes) ----------------------------

// One launch: R clusters of args->cluster CTAs.  smem_bytes must be the
// layout's size (smem_words * 4); returns the cudaError_t (0 = success).
extern "C" int fs_mega(const MegaArgs* args, long long smem_bytes,
                       void* stream) {
  if (args->R <= 0) return 0;
  if (args->cluster < 1 || args->cluster > kMaxCluster ||
      smem_bytes != smem_words(*args) * 4)
    return (int)cudaErrorInvalidValue;
  if (args->H > kMaxHops) return (int)cudaErrorInvalidValue;
  int dev = -1;
  const bool timed = g_timed_device >= 0 &&
                     cudaGetDevice(&dev) == cudaSuccess &&
                     dev == g_timed_device;
  void (*kern)(MegaArgs) =
      timed ? (args->H <= 4   ? mega_kernel_timed<4>
               : args->H <= 6 ? mega_kernel_timed<6>
                              : mega_kernel_timed<kMaxHops>)
            : (args->H <= 4   ? mega_kernel<4>
               : args->H <= 6 ? mega_kernel<6>
                              : mega_kernel<kMaxHops>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg =
      launch_config(*args, smem_bytes, (cudaStream_t)stream, at);
  err = cudaLaunchKernelEx(&cfg, kern, *args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `cluster` CTAs with smem_bytes each that the card holds at
// once (cudaOccupancyMaxActiveClusters, for the widest instance; all
// take one CTA an SM), or minus the cudaError_t.
extern "C" long long fs_max_clusters(long long cluster,
                                     long long smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      mega_kernel<kMaxHops>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return -(long long)err;
  MegaArgs a = {};
  a.R = 1;
  a.cluster = cluster;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg = launch_config(a, smem_bytes, 0, at);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, mega_kernel<kMaxHops>, &cfg);
  return err == cudaSuccess ? (long long)n : -(long long)err;
}

// The phase timers on the current device (on != 0: its launches from now
// run mega_kernel_timed) or off; reset != 0 zeroes the accumulators
// first, ordered on `stream`.  Turning them on loads the timed instances,
// so that a graph captured next may hold them.
extern "C" int fs_phase_timers(int on, int reset, void* stream) {
  int dev = -1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && reset) {
    void* acc = nullptr;
    err = cudaGetSymbolAddress(&acc, g_phase);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(acc, 0, sizeof(PhaseAcc), (cudaStream_t)stream);
  }
  if (err == cudaSuccess && on) {
    void (*const timed[])(MegaArgs) = {
        mega_kernel_timed<4>, mega_kernel_timed<6>,
        mega_kernel_timed<kMaxHops>};
    cudaFuncAttributes fa;
    for (int i = 0; i < 3 && err == cudaSuccess; ++i)
      err = cudaFuncGetAttributes(&fa, timed[i]);
  }
  if (err == cudaSuccess) g_timed_device = on ? dev : -1;
  return (int)err;
}

// The marks' cycles and counts (kPhaseMarks each) and the loop's
// nanoseconds, cycles and launches (3), once the work on `stream` is done.
extern "C" int fs_phase_read(unsigned long long* cycles,
                             unsigned long long* n,
                             unsigned long long* loop, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PhaseAcc acc;
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      &acc, g_phase, sizeof(PhaseAcc), 0, cudaMemcpyDeviceToHost, st);
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < kPhaseMarks; ++k) {
    cycles[k] = acc.cycles[k];
    n[k] = acc.n[k];
  }
  loop[0] = acc.loop_ns;
  loop[1] = acc.loop_cycles;
  loop[2] = acc.loops;
  return 0;
}

extern "C" long long fs_phase_marks() { return (long long)kPhaseMarks; }

extern "C" long long fs_args_size() { return (long long)sizeof(MegaArgs); }

extern "C" long long fs_row_sizes(long long which) {
  return which == 0 ? (long long)FR_COUNT : (long long)IR_COUNT;
}

extern "C" const char* fs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
