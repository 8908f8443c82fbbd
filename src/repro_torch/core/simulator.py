"""Scan driver + result analysis (port of ``repro.core.simulator``).

``decimating_scan`` advances a batched state one ``dt`` at a time in a
Python loop and folds the steps into trace windows on the device (one
``TraceSample`` per ``trace_every`` steps); only the decimated samples
come back to the host.  With ``use_kernels="mega"`` a whole window is
one ``megastep_block`` launch instead (``make_block_fn``).  Given a
window runner (``Sweep.run``'s cache entry) it replays one captured
window at a time instead.  ``run``
drives one (scenario, config) point as a batch of one; batched sweeps
live in ``experiments.py`` and share the same loop.  ``SimResult`` and its metrics are the reference's, verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..kernels import fluid_step as mega
from ..kernels.capture import card_lock
from . import cc, obs
from .fluid import (FluidState, Scenario, _step_body, check_routing_paths,
                    dense_reduce_rows, init_state, kernel_tier,
                    make_step_fn, reduce_plan, refuse_unported,
                    resolve_device, scenario_device, step_params)
from .params import CCConfig, CCScheme


class TraceSample(NamedTuple):
    """One decimated trace sample covering ``trace_every`` sim steps.

    ``delivered`` / ``rate`` are the window's last step; ``inst_thr`` is
    the window-mean delivery rate; ``max_q`` / ``n_paused`` /
    ``n_nonmin`` are window maxima; ``marked`` / ``cnp`` are window
    event counts; ``ctrl`` / ``pause_time`` / ``vc_stall`` are window
    sums (so run totals do not depend on the decimation).
    """

    delivered: Any
    rate: Any
    inst_thr: Any
    max_q: Any
    n_paused: Any
    marked: Any
    cnp: Any
    n_nonmin: Any
    ctrl: Any
    pause_time: Any
    vc_stall: Any


def _zero_accum(st: FluidState, n_vcs: int = 1):
    """Window accumulators shaped like the batched state ([R] / [R, F])."""
    z = lambda like, dt: torch.zeros_like(like, dtype=dt)   # noqa: E731
    return (z(st.t, torch.float32),            # max_q
            z(st.t, torch.int32),              # n_paused
            z(st.nicq, torch.int32),           # marked
            z(st.nicq, torch.int32),           # cnp
            z(st.t, torch.int32),              # n_nonmin
            z(st.nicq, torch.float32),         # ctrl
            z(st.t, torch.float32),            # pause_time
            torch.zeros(st.t.shape + (n_vcs,), dtype=torch.float32,
                        device=st.t.device))   # vc_stall


def _acc_update(acc, tr):
    """Fold one step's trace into the window accumulators."""
    mq, npz, mk, cn, nm, ct, pt, vs = acc
    return (torch.maximum(mq, tr.max_q),
            torch.maximum(npz, tr.n_paused),
            mk + tr.marked.to(torch.int32),
            cn + tr.cnp.to(torch.int32),
            torch.maximum(nm, tr.n_nonmin),
            ct + tr.ctrl,
            pt + tr.pause_time,
            vs + tr.vc_stall)


def _window_sample(st: FluidState, d0, acc, window: torch.Tensor
                   ) -> TraceSample:
    """One TraceSample from the window-end state + accumulators;
    ``window`` is the float32 window length in seconds."""
    mq, npz, mk, cn, nm, ct, pt, vs = acc
    return TraceSample(
        delivered=st.delivered, rate=st.rate,
        inst_thr=(st.delivered - d0) / window,
        max_q=mq, n_paused=npz, marked=mk, cnp=cn, n_nonmin=nm,
        ctrl=ct, pause_time=pt, vc_stall=vs)


def copy_leaves(dsts: list, srcs: list) -> None:
    """``d.copy_(s)`` for each pair, as one multi-tensor copy a dtype
    (``torch._foreach_copy_`` takes its fast path only when every
    tensor of a call has one dtype)."""
    groups: dict = {}
    for d, s in zip(dsts, srcs):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def flow_window(step, trace_every: int, dt: float, n_vcs: int, device):
    """``window(state) -> (state, TraceSample)``: ``trace_every`` calls
    of ``step`` folded into one sample on the device (the flow tiers'
    trace window)."""
    window = torch.tensor(trace_every * dt, dtype=torch.float32,
                          device=device)

    def run(st: FluidState):
        d0 = st.delivered
        acc = _zero_accum(st, n_vcs)
        for _ in range(trace_every):
            st, tr = step(st)
            acc = _acc_update(acc, tr)
        return st, _window_sample(st, d0, acc, window)

    return run


def decimating_scan(step, st: FluidState, n_samples: int,
                    trace_every: int, dt: float, n_vcs: int = 1, *,
                    block_fn=None, runner=None):
    """Run ``n_samples * trace_every`` steps, emitting one TraceSample
    per ``trace_every`` steps.  Returns ``(final state, TraceSample of
    [T, R, ...] tensors)``, all still on the state's device.

    ``block_fn(state) -> (state, TraceSample)`` replaces the per-step
    loop with one call per trace window (the megakernel's whole-window
    launch); ``step`` / ``trace_every`` / ``dt`` / ``n_vcs`` are unused
    then (the block closes over them).

    ``runner`` (a ``core.experiments.WindowExecutable``, the sweep's
    cached window) replaces both: ``runner.start(st)`` loads the initial
    state into its own tensors and each ``runner.advance()`` runs one
    window there (a CUDA-graph replay on the card) and returns its
    sample, which is copied into preallocated ``[T, R, ...]`` buffers.
    The final state is returned as a copy of the runner's.

    A run that keeps a trace (``core.obs``) records the runner's loop as
    a ``sweep.windows`` span, each window as a ``window`` span in it."""
    if runner is not None:
        rec = obs.current()
        with obs.span(rec, "sweep.windows"):
            runner.start(st)
            out = None
            for i in range(n_samples):
                sample = runner.advance() if rec is None \
                    else rec.window(runner, last=i == n_samples - 1)
                if out is None:
                    out = TraceSample(*[x.new_empty((n_samples,) + x.shape)
                                        for x in sample])
                copy_leaves([buf[i] for buf in out], list(sample))
                if rec is not None:
                    rec.exit()
            final = runner.state
            return FluidState(*[x.clone() for x in final[:-2]],
                              cc={k: v.clone() for k, v in final.cc.items()},
                              t=final.t.clone()), out
    window = block_fn or flow_window(step, trace_every, dt, n_vcs,
                                     st.nicq.device)
    samples = []
    for _ in range(n_samples):
        st, sample = window(st)
        samples.append(sample)
    return st, TraceSample(*[torch.stack(f) for f in zip(*samples)])


def block_fn_for(sd, par, plan, packed: dict, mplan, *, n_switches: int,
                 n_vcs: int, trace_every: int, dt: float,
                 reduce: str = "fused"):
    """``block(state) -> (state, TraceSample)``: one ``megastep_block``
    launch per trace window of a staged batch (on the CPU its plain
    version: the port's step and the host's window fold); ``packed`` is
    ``cc.pack_react_rows(par...)``, ``mplan`` the batch's ``mega_plan``
    with this window's length."""
    window = torch.tensor(trace_every * dt, dtype=torch.float32,
                          device=plan.dt.device)

    def body(s):
        return _step_body(s, sd, par, plan, n_switches=n_switches,
                          reduce=reduce, n_vcs=n_vcs, packed_react=packed)

    def block(st: FluidState):
        return mega.megastep_block(
            st, sd, par, plan, mplan, body=body, n_substeps=trace_every,
            acc_init=_zero_accum, acc_update=_acc_update,
            make_sample=lambda s, d0, acc: _window_sample(s, d0, acc,
                                                          window),
            n_vcs=n_vcs, n_switches=n_switches)

    return block


def make_block_fn(scn: Scenario, cfg: CCConfig, trace_every: int, *,
                  reduce: str = "fused", dense_rows: int | None = None,
                  device=None):
    """Megakernel analogue of ``make_step_fn``: ``block(state) ->
    (state, TraceSample)`` runs ``trace_every`` steps of one scenario
    (R = 1) as ONE ``megastep_block`` launch on the card."""
    refuse_unported(reduce=reduce, use_kernels="mega")
    check_routing_paths(cfg, scn)
    dev = resolve_device(device)
    n_vcs = int(getattr(cfg.link, "n_vcs", 1))
    sd = scenario_device(scn, n_vcs=n_vcs, device=dev)
    par = step_params(cfg, device=dev)
    if dense_rows is None:
        dense_rows = dense_reduce_rows(scn, n_vcs) if reduce == "fused" \
            else 0
    n_sw = int(scn.n_switches)
    plan = reduce_plan(sd, n_switches=n_sw, n_vcs=n_vcs,
                       dense_rows=dense_rows if reduce == "fused" else 0,
                       dt=float(cfg.sim.dt))
    dt = float(cfg.sim.dt)
    packed = cc.pack_react_rows(par.react, par.line_rate, plan.dt)
    mplan = mega.mega_plan(par, packed, plan.dt, sd=sd, plan=plan,
                           window=float(trace_every * dt))
    return block_fn_for(sd, par, plan, packed, mplan, n_switches=n_sw,
                        n_vcs=n_vcs, trace_every=trace_every, dt=dt,
                        reduce=reduce)


def _resolve_steps(cfg: CCConfig, n_steps: int | None,
                   trace_every: int | None) -> tuple[int, int]:
    if n_steps is None:
        n_steps = int(round(cfg.sim.t_end / cfg.sim.dt))
    k = cfg.sim.trace_every if trace_every is None else trace_every
    k = max(1, int(k))
    n_samples = -(-n_steps // k)          # ceil: round the run up to a
    return n_samples, k                   # whole number of samples


@dataclasses.dataclass
class SimResult:
    """Host-side view of a finished run.

    Trace arrays are decimated by ``trace_every`` (see TraceSample for
    the per-field semantics); ``times`` marks each sample's window end.
    """

    cfg: CCConfig
    scn: Scenario
    times: np.ndarray          # [T] seconds (window-end times)
    delivered: np.ndarray      # [T, F] cumulative bytes
    rate: np.ndarray           # [T, F] RP rate (B/s)
    inst_thr: np.ndarray       # [T, F] window-mean delivery rate (B/s)
    max_q: np.ndarray          # [T] window-max hottest queue (bytes)
    n_paused: np.ndarray       # [T] window-max paused wires
    marked: np.ndarray         # [T, F] marking events in window
    cnp: np.ndarray            # [T, F] CNPs received in window
    n_nonmin: np.ndarray       # [T] window-max flows on non-minimal paths
    final: Any                 # FluidState (host)
    ctrl: np.ndarray = None    # [T, F] notification emissions in window
    trace_every: int = 1
    # PFC-pathology instrumentation (None on traces that predate it):
    pause_time: np.ndarray = None  # [T] pause wire-seconds in window
    vc_stall: np.ndarray = None    # [T, V] per-VC pause wire-seconds

    def to_dict(self, *, traces: bool = True, decimate: int = 1) -> dict:
        """JSON-ready dict (numpy-free scalars, tagged arrays) in the
        reference's wire format.  ``traces=False`` drops the trace
        arrays; ``decimate=k`` thins them by a further factor k.  The
        full form round-trips through ``json.dumps``/``loads`` +
        :meth:`from_dict` bit-exactly (see ``core.serialize``)."""
        from .serialize import simresult_to_dict
        return simresult_to_dict(self, traces=traces, decimate=decimate)

    @classmethod
    def from_dict(cls, d: dict) -> "SimResult":
        from .serialize import simresult_from_dict
        return simresult_from_dict(d)

    # -- derived metrics ----------------------------------------------------
    def window_samples(self, seconds: float) -> int:
        """Trace samples spanning ``seconds`` (smoothing windows should
        be specified in time, not samples — sample spacing depends on
        ``trace_every``)."""
        dt_sample = self.trace_every * self.cfg.sim.dt
        return max(1, int(round(seconds / dt_sample)))

    def flow_throughput(self, window: int = 50) -> np.ndarray:
        """[T, F] delivery rate smoothed over `window` samples (B/s).

        Box filter over the sample axis via cumulative sums (equivalent
        to per-flow ``np.convolve(..., mode="same")`` but one vectorised
        pass over [T, F] instead of an O(F) python loop).
        """
        x = self.inst_thr.astype(np.float64)   # f32 cumsum would drift
        T = x.shape[0]
        w = max(1, min(window, T))
        c = np.concatenate([np.zeros((1,) + x.shape[1:]), np.cumsum(x, 0)])
        # same-mode box filter: sample t averages [t - w//2, t + (w-1)//2]
        lo = np.clip(np.arange(T) - w // 2, 0, T)
        hi = np.clip(np.arange(T) + (w - 1) // 2 + 1, 0, T)
        return (c[hi] - c[lo]) / w

    def aggregate_throughput(self, window: int = 50) -> np.ndarray:
        return self.flow_throughput(window).sum(axis=1)

    def completion_times(self, frac: float = 0.999) -> np.ndarray:
        """[F] time when `frac` of the flow's work was delivered.

        Volume-mode flows are measured against their declared volume
        (NaN if the run ended early); window-mode flows against the
        admitted bytes.  ``delivered`` is monotone per flow, so the
        first crossing is a vectorised argmax over the sample axis."""
        offered = np.asarray(self.final.offered)
        vol = np.asarray(self.scn.volume, dtype=np.float64)
        total = np.where(np.isfinite(vol), vol, offered)
        done = self.delivered >= frac * np.maximum(total, 1e-300)[None, :]
        first = done.argmax(axis=0)                   # 0 if never done too
        hit = done.any(axis=0) & (total > 0)
        return np.where(hit, self.times[first], np.nan)

    def completion_time(self, frac: float = 0.999) -> float:
        ct = self.completion_times(frac)
        return float(np.nanmax(ct)) if np.isfinite(ct).any() else float("nan")

    def mean_throughput_while_active(self) -> np.ndarray:
        """[F] mean delivery rate while the flow is live.

        Window mode: averaged over [t_start, t_stop).  Volume mode
        (t_stop = inf): volume / (completion - t_start).
        """
        t0 = np.asarray(self.scn.t_start, np.float64)
        t1 = np.asarray(self.scn.t_stop, np.float64)
        ct = self.completion_times()
        windowed = np.isfinite(t1)
        live = ((self.times[:, None] >= t0[None, :])
                & (self.times[:, None] < t1[None, :]))          # [T, F]
        n_live = live.sum(axis=0)
        mean_w = np.where(n_live > 0,
                          (self.inst_thr * live).sum(axis=0)
                          / np.maximum(n_live, 1), 0.0)
        span = ct - t0
        mean_v = np.where(np.isfinite(ct) & (span > 0),
                          self.delivered[-1] / np.maximum(span, 1e-300), 0.0)
        return np.where(windowed, mean_w, mean_v)

    def _real_flows(self) -> np.ndarray:
        """[F] bool — flows with actual offered work (padding rows in
        stacked sweeps carry zero rate and are excluded from
        fairness/tail statistics)."""
        return np.asarray(self.scn.gen_rate) > 0

    def jain_index(self) -> float:
        """Jain fairness over per-flow goodput while active, in [0, 1].

        1 = all real flows saw the same rate; 1/n = one flow took
        everything.  A first-class tuner objective (repro.tune).
        """
        thr = self.mean_throughput_while_active()[self._real_flows()]
        n = thr.size
        if n == 0:
            return float("nan")
        denom = n * float((thr ** 2).sum())
        return float(thr.sum()) ** 2 / denom if denom > 0 else 1.0

    def flow_slowdowns(self) -> np.ndarray:
        """[F_real] demand-normalised slowdown per real flow (>= ~1).

        Ideal rate = min(offered rate, line rate); slowdown = ideal /
        achieved mean rate while active — the fluid-model analogue of
        FCT slowdown (a flow throttled to half its unconstrained rate
        scores 2).
        """
        real = self._real_flows()
        thr = self.mean_throughput_while_active()[real]
        ideal = np.minimum(np.asarray(self.scn.gen_rate),
                           self.cfg.link.line_rate)[real]
        return ideal / np.maximum(thr, 1e-6 * self.cfg.link.line_rate)

    def p99_slowdown(self) -> float:
        """p99 of ``flow_slowdowns`` — the tail-latency tuner objective."""
        s = self.flow_slowdowns()
        return float(np.percentile(s, 99)) if s.size else float("nan")

    def victim_slowdown(self) -> float:
        """Mean slowdown over the scenario's designated victim flows.

        Victims (``Scenario.victim``) are flows that do not contribute
        to the congestion under test but share fabric with it — the
        HoL/pause-storm collateral the PFC-pathology scenarios measure.
        NaN when the scenario designates none (or none are real flows).
        """
        if self.scn.victim is None:
            return float("nan")
        vic = np.asarray(self.scn.victim, bool)[self._real_flows()]
        if not vic.any():
            return float("nan")
        return float(self.flow_slowdowns()[vic].mean())

    def pause_duration(self) -> float:
        """Total PFC pause wire-seconds over the run (sum over queues
        of pause level x dt).  NaN on traces predating the counter."""
        if self.pause_time is None:
            return float("nan")
        return float(np.asarray(self.pause_time).sum())

    def vc_stall_time(self) -> np.ndarray:
        """[V] pause wire-seconds per virtual channel ([1] when the
        config runs a single VC).  None on traces predating it."""
        if self.vc_stall is None:
            return None
        return np.asarray(self.vc_stall).sum(axis=0)

    def ctrl_per_mb(self) -> float:
        """Notification messages per delivered MB (control overhead).

        NaN when the trace predates the ``ctrl`` counter (old blobs).
        """
        if self.ctrl is None:
            return float("nan")
        mb = float(np.asarray(self.final.delivered).sum()) / 1e6
        return float(self.ctrl.sum()) / max(mb, 1e-9)

    def summary(self) -> dict:
        """Headline numbers for this run (one row of the Fig. 2/3
        table; ``SweepResult.summary`` is this, per point)."""
        thr = self.mean_throughput_while_active()
        return {
            "aggregate_gbps": float(thr.sum() / 1e9),
            "min_flow_gbps": float(thr.min() / 1e9),
            "completion_ms": float(self.completion_time() * 1e3),
            "peak_queue_kb": float(self.max_q.max() / 1e3),
            "delivered_mb": float(
                np.asarray(self.final.delivered).sum() / 1e6),
            "marks": int(self.marked.sum()),
            "cnps": int(self.cnp.sum()),
            "peak_nonmin_flows": int(self.n_nonmin.max()),
            "jain_index": self.jain_index(),
            "p99_slowdown": self.p99_slowdown(),
            "ctrl_per_mb": self.ctrl_per_mb(),
            "victim_slowdown": self.victim_slowdown(),
            "pause_s": self.pause_duration(),
            "vc_stall_s": None if self.vc_stall is None else
                [float(x) for x in self.vc_stall_time()],
        }


def run(scn: Scenario, cfg: CCConfig, n_steps: int | None = None,
        trace_every: int | None = None, *, reduce: str = "fused",
        use_kernels: "bool | str" = False, device=None) -> SimResult:
    """Simulate one point and pull (decimated) traces to host.

    ``device=None`` runs on the card (and raises when there is none);
    pass ``device="cpu"`` to run on the CPU.  ``trace_every`` defaults
    to ``cfg.sim.trace_every``; ``n_steps`` is rounded up to a whole
    number of trace windows.  ``reduce`` / ``use_kernels`` as in
    ``fluid.fluid_step``; ``use_kernels="mega"`` makes each trace window
    one ``megastep_block`` launch.
    """
    from ..convert import state_to_numpy
    dev = resolve_device(device)
    n_samples, k = _resolve_steps(cfg, n_steps, trace_every)
    n_vcs = int(getattr(cfg.link, "n_vcs", 1))
    with card_lock(dev):
        st0 = init_state(scn, cfg, device=dev)
        if kernel_tier(use_kernels) == "mega":
            block = make_block_fn(scn, cfg, k, reduce=reduce, device=dev)
            final, tr = decimating_scan(None, st0, n_samples, k,
                                        float(cfg.sim.dt), n_vcs,
                                        block_fn=block)
        else:
            step = make_step_fn(scn, cfg, reduce=reduce,
                                use_kernels=use_kernels, device=dev)
            final, tr = decimating_scan(step, st0, n_samples, k,
                                        float(cfg.sim.dt), n_vcs)
        tr = TraceSample(*[x[:, 0].cpu().numpy() for x in tr])
        fin = state_to_numpy(final)
    # (i+1)*k first (exact int), then *dt — so decimated times are the
    # same floats as the strided full-resolution times
    times = (np.arange(n_samples) + 1) * k * cfg.sim.dt
    return SimResult(
        cfg=cfg, scn=scn, times=times, delivered=tr.delivered,
        rate=tr.rate, inst_thr=tr.inst_thr, max_q=tr.max_q,
        n_paused=tr.n_paused, marked=tr.marked, cnp=tr.cnp,
        n_nonmin=tr.n_nonmin,
        final=FluidState(*[x[0] for x in fin[:-2]],
                         cc={kk: v[0] for kk, v in fin.cc.items()},
                         t=fin.t[0]),
        ctrl=tr.ctrl, trace_every=k, pause_time=tr.pause_time,
        vc_stall=tr.vc_stall)


def run_all_schemes(scn: Scenario, cfg: CCConfig,
                    n_steps: int | None = None, *,
                    device=None) -> dict[str, SimResult]:
    """The scheme ablation (PFC_ONLY, DCQCN, DCQCN_REV under ``cfg``'s
    other settings) as one 3-point ``Sweep``; ``device`` as in ``run``."""
    from .experiments import Sweep
    schemes = (CCScheme.PFC_ONLY, CCScheme.DCQCN, CCScheme.DCQCN_REV)
    sweep = Sweep([(s.name, cfg.replace(scheme=s), scn) for s in schemes])
    res = sweep.run(n_steps=n_steps, device=device)
    return {s.name: res[s.name] for s in schemes}
