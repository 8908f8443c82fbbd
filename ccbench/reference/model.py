"""Plain PyTorch reference of the fluid congestion-control model.

One batch of runs (a leading run axis R) of the single-path, single-VC
model the benchmark's cells run, advanced one ``dt`` at a time and
decimated into trace samples as the program's ``Sweep.run`` does:

  1. generation into the NIC queue (window or volume mode, NIC overflow);
  2. transfers: a proportional share of each wire's budget, gated by PFC
     pause and scaled by the strict-FIFO head-of-line factor;
  3. PFC xoff/xon hysteresis per wire and the shared pool per switch;
  4. marking (cp, ecp, slope), 5. notification through the delay line
     (np, enp, fncc), 6. reaction (pfc, rp, erp, swift).

Every per-wire sum adds its contributors in (flow, hop) order, the order
the model defines: ``index_add_`` on the CPU, and on a card one add a
contributor rank over a table of every wire's contributors (``index_add_``
is unordered there), each step replayed as a CUDA graph.  ``dtype`` runs
the whole model in another float type (the check's lower-precision
control).
Nothing here imports the program: the scenario comes from
``reference.scenario`` and the constants from the configuration file.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MARKING = ("cp", "ecp", "slope")
NOTIFICATION = ("np", "enp", "fncc")
REACTION = ("pfc", "rp", "erp", "swift")
EPS_RATE = 1e6                      # B/s: a hop's demand counts as active

#: trace fields, as ``SweepResult.traces`` names them
TRACE_FIELDS = ("delivered", "rate", "inst_thr", "max_q", "n_paused",
                "marked", "cnp", "n_nonmin", "ctrl", "pause_time",
                "vc_stall")


def stage_params(params: dict) -> dict:
    """Every stage constant of one configuration, by the name the stages
    read (python floats; ``rp_fr_stages`` an int)."""
    lk, dc, rv = params["link"], params["dcqcn"], params["rev"]
    fn, sw = params["fncc"], params["swift"]
    return {
        "line_rate": lk["line_rate"],
        "xoff": lk["port_buffer"] * lk["pfc_xoff_frac"],
        "xon": lk["port_buffer"] * lk["pfc_xon_frac"],
        "pool_xoff": lk["shared_buffer"] * lk["pfc_xoff_frac"],
        "port_buffer": lk["port_buffer"],
        "ecp_beta": rv["ecp_rate_ewma"],
        "alpha_init": dc["alpha_init"],
        "cp_kmin": dc["kmin"], "drain_gain": rv["erp_drain_gain"],
        "ecp_thresh": rv["detect_threshold"],
        "ecp_slack": rv["ecp_fairness_slack"],
        "slope_kmin": dc["kmin"], "slope_kmax": dc["kmax"],
        "slope_pmax": dc["pmax"],
        "np_window": dc["cnp_window"], "enp_window": rv["enp_coalesce"],
        "fncc_window": fn["coalesce"], "fncc_scale": fn["rtt_scale"],
        "rp_g": dc["g"], "rp_rdf": dc["rate_decrease_factor"],
        "rp_timer": dc["timer_T"], "rp_byte": dc["byte_counter_B"],
        "rp_rai": dc["rai"], "rp_rhai": dc["rhai"],
        "rp_fr_stages": float(dc["fr_stages"]),
        "rp_min_rate": dc["min_rate"],
        "erp_settle": rv["erp_settle"], "erp_rai": rv["erp_rai"],
        "erp_jitter": rv["erp_jitter"], "erp_hold": rv["erp_hold"],
        "erp_min_rate": rv["min_rate"],
        "swift_target": sw["target_delay"], "swift_beta": sw["beta"],
        "swift_ai": sw["ai"], "swift_guard": sw["guard"],
        "swift_min_rate": sw["min_rate"],
    }


def _gather(x, idx):
    """Per-run gather: ``x`` [R, N], ``idx`` [R, ...] -> [R, ...]."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(
        idx.shape)


def _hop_sum(x):
    """Left-to-right sum over the hop axis."""
    acc = x[:, :, 0]
    for h in range(1, x.shape[2]):
        acc = acc + x[:, :, h]
    return acc


class Batch:
    """R runs of one shape: scenario arrays stacked, constants per run.

    ``scns`` are ``reference.scenario.build`` dicts, ``stacks`` the
    (marking, notification, reaction) names and ``params`` the stage
    constants (``stage_params``) of each run."""

    def __init__(self, scns, stacks, params, *, dt: float,
                 dtype=torch.float32, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        fl = dtype
        self.R = len(scns)
        F, H = scns[0]["routes"].shape
        self.F, self.H = F, H
        self.L = scns[0]["capacity"].shape[0]
        self.n_sw = max(s["n_switches"] for s in scns)
        self.D = max(max(2, int(np.max(s["rtt_steps"])) + 1) for s in scns)

        def up(key, np_dtype, t_dtype):
            return torch.from_numpy(np.stack(
                [np.asarray(s[key], np_dtype) for s in scns])).to(
                    self.device, t_dtype)

        self.routes = up("routes", np.int64, torch.int64)
        self.hops = up("hops", np.int64, torch.int64)
        self.gen_rate = up("gen_rate", np.float32, fl)
        self.t_start = up("t_start", np.float32, fl)
        self.t_stop = up("t_stop", np.float32, fl)
        self.volume = up("volume", np.float32, fl)
        self.nic_buffer = up("nic_buffer", np.float32, fl)
        cap = np.stack([np.concatenate([s["capacity"], [np.inf]])
                        .astype(np.float32) for s in scns])
        self.cap_ext = torch.from_numpy(cap).to(self.device, fl)
        self.sink = up("sink_switch", np.int64, torch.int64)
        self.rtt = up("rtt_steps", np.int64, torch.int64)
        self.jitter = up("jitter", np.float32, fl)
        self.codes = [tuple(fam.index(name) for fam, name in
                            zip((MARKING, NOTIFICATION, REACTION), st))
                      for st in stacks]
        self.used = [sorted({c[i] for c in self.codes}) for i in range(3)]
        code = torch.tensor(self.codes, dtype=torch.int64, device=self.device)
        self.mark_code, self.notif_code, self.react_code = code.unbind(1)
        self.p = {k: torch.tensor([float(p[k]) for p in params],
                                  dtype=torch.float32).to(self.device, fl)
                  for k in params[0]}
        self.dt = torch.tensor(dt, dtype=torch.float32).to(self.device, fl)
        self.dt_s = dt
        self.walk = self.pool_walk = None
        if self.device.type == "cuda":
            self._build_walks()

    def _build_walks(self):
        """Each wire's contributors, and each switch's pool links, as a
        [rank, R, wire] table of rows into the flattened data (the last
        row a zero), in the order the sums add them."""
        R, F, H, L = self.R, self.F, self.H, self.L
        routes = self.routes.cpu().numpy().reshape(R, F * H)
        self.walk = self._table(routes, L, F * H)
        sink = self.sink.cpu().numpy()
        self.pool_walk = self._table(np.where(sink >= 0, sink, -1),
                                     self.n_sw, L)

    def _table(self, keys: np.ndarray, n_seg: int, n: int) -> torch.Tensor:
        """[rank, R, n_seg] rows ``r * n + e`` of the entries ``e`` whose
        key is the segment, in entry order; ``R * n`` where none is left."""
        R = keys.shape[0]
        seg = np.where(keys >= 0, keys, n_seg)
        flat = (np.arange(R)[:, None] * (n_seg + 1) + seg).reshape(-1)
        order = np.argsort(flat, kind="stable")
        sk = flat[order]
        starts = np.searchsorted(sk, sk, side="left")
        rank = np.arange(sk.size) - starts
        keep = (sk % (n_seg + 1)) < n_seg
        depth = int(rank[keep].max(initial=0)) + 1
        table = np.full((depth, R, n_seg), R * n, np.int64)
        r_of, s_of = sk[keep] // (n_seg + 1), sk[keep] % (n_seg + 1)
        table[rank[keep], r_of, s_of] = order[keep]
        return torch.from_numpy(table).to(self.device)

    @staticmethod
    def _walk_sum(data, walk):
        """``data`` [N, C] summed along ``walk`` [rank, ...] rank by rank
        from zero (row N of the extended data is a zero)."""
        ext = torch.cat([data, data.new_zeros((1,) + data.shape[1:])])
        dense = torch.index_select(ext, 0, walk.reshape(-1)).reshape(
            walk.shape + data.shape[1:])
        acc = torch.zeros_like(dense[0])
        for p in range(dense.shape[0]):
            acc = acc + dense[p]
        return acc

    # -- state ------------------------------------------------------------

    def init_state(self) -> dict:
        R, F, H, L, D = self.R, self.F, self.H, self.L, self.D
        z = lambda *s: torch.zeros(s, dtype=self.dtype,   # noqa: E731
                                   device=self.device)
        line = torch.minimum(self.gen_rate,
                             self.p["line_rate"][:, None])
        return dict(
            qh=z(R, F, H), nicq=z(R, F), delivered=z(R, F), offered=z(R, F),
            dropped=z(R, F), est=z(R, F, H), paused=z(R, L), rate=line,
            rp_target=line.clone(),
            alpha=self.p["alpha_init"][:, None].expand(R, F).clone(),
            byte_cnt=z(R, F), tmr=z(R, F), alpha_tmr=z(R, F),
            bc_stage=z(R, F), t_stage=z(R, F), hold=z(R, F),
            np_tmr=torch.ones((R, F), dtype=self.dtype, device=self.device),
            trig_buf=z(R, D, F), tgt_buf=z(R, D, F),
            slope_acc=z(R, F), swift_cool=z(R, F),
            t=torch.zeros((R,), dtype=torch.int64, device=self.device))

    # -- one dt ------------------------------------------------------------

    def _link_sums(self, channels, qidx):
        """Per-wire sums of [R, F, H] channels in (flow, hop) order:
        [R, L + 1] each, the last column (PAD hops) zero."""
        R, L = self.R, self.L
        data = torch.stack(channels, dim=-1).reshape(R * self.F * self.H, -1)
        if self.walk is not None:
            acc = self._walk_sum(data, self.walk)
            acc = torch.cat([acc, acc.new_zeros((R, 1, acc.shape[2]))], 1)
        else:
            index = (qidx + torch.arange(R, device=self.device)[:, None, None]
                     * (L + 1)).reshape(-1)
            acc = data.new_zeros((R * (L + 1), data.shape[1])).index_add_(
                0, index, data).reshape(R, L + 1, -1)
            acc[:, L] = 0.0
        return [acc[:, :, c] for c in range(acc.shape[2])]

    def step(self, st: dict):
        p, dt, R, F, H, L, D = (self.p, self.dt, self.R, self.F, self.H,
                                self.L, self.D)
        fl, dev = self.dtype, self.device
        col = lambda x: x[:, None]                     # noqa: E731
        col3 = lambda x: x[:, None, None]              # noqa: E731
        line = p["line_rate"]
        t_sec = st["t"].to(fl) * dt
        routes, hops = self.routes, self.hops
        ar_h = torch.arange(H, device=dev)[None, None, :]
        valid = routes != -1
        widx = torch.where(valid, routes, L)
        hm1 = hops[:, :, None] - 1
        is_last = valid & (ar_h == hm1)
        holds = valid & (ar_h < hm1)

        # 1. generation, and the notification timer's tick
        ts = col(t_sec)
        active = (ts >= self.t_start) & (ts < self.t_stop)
        gen = torch.where(active, self.gen_rate, 0.0) * dt
        gen = torch.minimum(gen, torch.clamp_min(self.volume - st["offered"],
                                                 0.0))
        nicq = st["nicq"] + gen
        over = torch.clamp_min(nicq - self.nic_buffer, 0.0)
        nicq, offered = nicq - over, st["offered"] + gen - over
        dropped, np_tmr_t = st["dropped"] + over, st["np_tmr"] + dt

        # 2. transfers
        src_inj = torch.minimum(nicq, torch.minimum(st["rate"], col(line))
                                * dt)
        src_q = torch.cat([src_inj[:, :, None], st["qh"][:, :, :-1]], 2)
        src_q = torch.where(valid, src_q, 0.0)
        pause_q = torch.cat([st["paused"], st["paused"].new_zeros((R, 1))], 1)
        wire_open = 1.0 - _gather(pause_q, widx)
        next_open = torch.cat([wire_open[:, :, 1:],
                               wire_open.new_ones((R, F, 1))], 2)
        q_here = torch.where(holds, st["qh"], 0.0)
        weight = src_q * wire_open
        caps = _gather(self.cap_ext, widx)
        num, den, sum_w = self._link_sums([q_here * next_open, q_here,
                                           weight], widx)
        fifo = torch.where(den > 0, num / torch.clamp_min(den, 1e-9), 1.0)
        budget = caps * dt * _gather(fifo, widx)
        sww = _gather(sum_w, widx)
        share = torch.where(sww > 0,
                            budget * weight / torch.clamp_min(sww, 1e-9), 0.0)
        T = torch.minimum(weight, share)
        nicq = nicq - T[:, :, 0]
        qh = st["qh"] - torch.nn.functional.pad(T[:, :, 1:], (0, 1))
        qh = torch.clamp_min(qh + torch.where(holds, T, 0.0), 0.0)
        deliv = torch.where(is_last, T, 0.0).sum(dim=2)
        delivered = st["delivered"] + deliv
        beta = col3(p["ecp_beta"])
        est = (1 - beta) * st["est"] + beta * (T / dt)
        dem = torch.where(valid, torch.cat([est[:, :, :1], est[:, :, :-1]],
                                           2), 0.0)
        act = (dem > EPS_RATE) & valid

        # 3. PFC: per-wire hysteresis, then the shared pool per switch
        B_ext, n_act, sum_dem = self._link_sums(
            [torch.where(holds, qh, 0.0), act.to(fl),
             torch.where(act, dem, 0.0)], widx)
        B = B_ext[:, :L]
        paused = torch.where(B > col(p["xoff"]), 1.0,
                             torch.where(B < col(p["xon"]), 0.0,
                                         st["paused"]))
        sink = self.sink
        pool_in = torch.where(sink >= 0, B, 0.0).reshape(-1)
        if self.pool_walk is not None:
            pool = self._walk_sum(pool_in, self.pool_walk)
        else:
            pidx = (torch.where(sink >= 0, sink, self.n_sw)
                    + torch.arange(R, device=dev)[:, None] * (self.n_sw + 1))
            pool = pool_in.new_zeros(R * (self.n_sw + 1)).index_add_(
                0, pidx.reshape(-1), pool_in).reshape(R, -1)[:, :self.n_sw]
        hot = (pool > col(p["pool_xoff"])).to(fl)
        pool_pause = torch.where(sink >= 0,
                                 _gather(hot, torch.clamp_min(sink, 0)), 0.0)
        paused = torch.maximum(paused, pool_pause)

        # 4. marking
        B1_w = _gather(torch.cat([B, B.new_zeros((R, 1))], 1), widx)
        present = (qh > 0) | (T > 0)
        share0 = caps / torch.clamp_min(_gather(n_act, widx), 1.0)
        under = dem < share0
        surplus, n_heavy = self._link_sums(
            [torch.where(act & under, share0 - dem, 0.0),
             (act & ~under).to(fl)], widx)
        grant = torch.where(
            under, dem, share0 + _gather(surplus, widx)
            / torch.clamp_min(_gather(n_heavy, widx), 1.0))
        grant = torch.where(act, grant, caps)
        oversub = (_gather(sum_dem, widx) > caps).to(fl)
        inf_col = torch.full((R, F, 1), math.inf, dtype=fl, device=dev)
        zero_col = qh.new_zeros((R, F, 1))
        grant_next = torch.where(holds, torch.cat([grant[:, :, 1:], inf_col],
                                                  2), math.inf)
        dem_next = torch.cat([dem[:, :, 1:], zero_col], 2)
        over_next = torch.cat([oversub[:, :, 1:], zero_col], 2)
        finite = torch.isfinite(grant_next)
        g_fin = torch.where(finite, grant_next, 0.0)

        def common(thresh):
            base = ((B1_w > thresh) & present & holds).to(fl)
            qexc = torch.clamp((B1_w - thresh) / col3(p["port_buffer"]),
                               0.0, 1.0)
            sev = torch.where(finite, g_fin * (1.0 - col3(p["drain_gain"])
                                               * qexc), math.inf)
            return base, sev

        slope_acc = st["slope_acc"]
        marks = {}
        for code in self.used[0]:
            if code == 0:                                    # cp
                marks[0] = common(col3(p["cp_kmin"]))
            elif code == 1:                                  # ecp
                base, sev = common(col3(p["ecp_thresh"]))
                cong = ((over_next > 0) & (dem_next > col3(p["ecp_slack"])
                                           * grant_next)).to(fl)
                marks[1] = (base * cong, sev)
            else:                                            # slope
                kmin, kmax = col3(p["slope_kmin"]), col3(p["slope_kmax"])
                base, sev = common(kmin)
                ramp = torch.clamp((B1_w - kmin)
                                   / torch.clamp_min(kmax - kmin, 1.0),
                                   0.0, 1.0)
                prob = torch.where(B1_w >= kmax, 1.0,
                                   col3(p["slope_pmax"]) * ramp) * base
                acc = st["slope_acc"] + torch.amax(prob, dim=2)
                fire = acc >= 1.0
                sel = self.mark_code == 2
                slope_acc = torch.where(col(sel), torch.where(
                    fire, acc - 1.0, acc), st["slope_acc"])
                marks[2] = (base * fire.to(fl)[:, :, None], sev)
        mark_fh = self._select(self.mark_code, {k: v[0]
                                                for k, v in marks.items()})
        sev = self._select(self.mark_code, {k: v[1]
                                            for k, v in marks.items()})
        mark_pos = mark_fh > 0.0
        marked = mark_pos.any(dim=2)
        tgt = torch.amin(torch.where(mark_pos, sev, math.inf), dim=2)
        tgt = torch.where(torch.isfinite(tgt), tgt, col(line))
        mark_lvl = torch.clamp_max(torch.amax(mark_fh, dim=2), 1.0)

        # 5. notification through the delay line
        t_col = col(st["t"])
        outs = {}
        for code in self.used[1]:
            window = col(p[("np_window", "enp_window",
                            "fncc_window")[code]])
            emit = ((mark_lvl > 0) & (np_tmr_t >= window)).to(fl)
            np_tmr = torch.where(emit > 0, 0.0, np_tmr_t)
            if code < 2:
                delay = self.rtt
            else:
                h_mark = torch.argmax(mark_fh, dim=2).to(fl)
                frac = (h_mark + 1.0) / torch.clamp_min(hops.to(fl), 1.0)
                eff = torch.round(self.rtt.to(fl) * 0.5 * frac
                                  * col(p["fncc_scale"]))
                delay = torch.minimum(torch.clamp_min(eff.to(torch.int32), 2),
                                      self.rtt)
            outs[code] = (emit, np_tmr, (t_col + delay) % D)
        emit, np_tmr, wslot = (self._select(self.notif_code, {
            k: v[i] for k, v in outs.items()}) for i in range(3))
        rslot = st["t"] % D
        d_iota = torch.arange(D, device=dev)[None, :, None]
        w_hot = d_iota == wslot[:, None, :]
        trig_buf = st["trig_buf"] + torch.where(w_hot, emit[:, None, :], 0.0)
        tgt_buf = torch.where(w_hot & (emit[:, None, :] > 0),
                              tgt[:, None, :], st["tgt_buf"])
        runs = torch.arange(R, device=dev)
        cnp = (trig_buf[runs, rslot] > 0).to(fl)
        tgt_rx = tgt_buf[runs, rslot]
        trig_buf = torch.where(d_iota == rslot[:, None, None], 0.0, trig_buf)

        # 6. reaction
        qdelay = _hop_sum(torch.where(holds, qh, 0.0)) / col(line)
        keys = ("rate", "rp_target", "alpha", "byte_cnt", "tmr", "alpha_tmr",
                "bc_stage", "t_stage", "hold")
        swift_cool = st["swift_cool"]
        reacts = {}
        for code in self.used[2]:
            out = {k: st[k] for k in keys}
            if code == 0:                                    # pfc
                out["rate"] = torch.minimum(self.gen_rate, col(line))
            elif code == 1:                                  # DCQCN RP
                out.update(self._rp(st, cnp))
            elif code == 2:                                  # the paper's ERP
                out.update(self._erp(st, cnp, tgt_rx))
            else:                                            # swift
                out["rate"], cool = self._swift(st, qdelay)
                swift_cool = torch.where(col(self.react_code == 3), cool,
                                         st["swift_cool"])
            reacts[code] = out
        react = {k: self._select(self.react_code, {c: o[k] for c, o in
                                                   reacts.items()})
                 for k in keys}

        new = dict(st, qh=qh, nicq=nicq, delivered=delivered,
                   offered=offered, dropped=dropped, est=est, paused=paused,
                   np_tmr=np_tmr, trig_buf=trig_buf, tgt_buf=tgt_buf,
                   slope_acc=slope_acc, swift_cool=swift_cool,
                   t=st["t"] + 1, **react)
        trace = dict(delivered=delivered, rate=react["rate"],
                     max_q=torch.amax(B, dim=1),
                     n_paused=(paused > 0.5).sum(dim=1),
                     marked=marked, cnp=cnp > 0, ctrl=emit,
                     pause_time=paused.sum(dim=1) * dt)
        return new, trace

    def _select(self, code, outs: dict):
        """Each run's output of the stage its code names."""
        keys = sorted(outs)
        sel = outs[keys[0]]
        for k in keys[1:]:
            hit = (code == k).reshape((-1,) + (1,) * (sel.dim() - 1))
            sel = torch.where(hit, outs[k], sel)
        return sel

    def _rp(self, st, cnp):
        p, dt = self.p, self.dt
        col = lambda k: p[k][:, None]                  # noqa: E731
        g, rdf, timer = col("rp_g"), col("rp_rdf"), col("rp_timer")
        fr = col("rp_fr_stages")
        c = cnp > 0
        rate, target, alpha = st["rate"], st["rp_target"], st["alpha"]
        alpha_tmr = st["alpha_tmr"] + dt
        tick = alpha_tmr >= timer
        alpha = torch.where(tick, (1 - g) * alpha, alpha)
        alpha_tmr = torch.where(tick, 0.0, alpha_tmr)
        target = torch.where(c, rate, target)
        new_rate = torch.where(c, rate * (1 - alpha * rdf), rate)
        alpha = torch.where(c, (1 - g) * alpha + g, alpha)
        byte_cnt = torch.where(c, 0.0, st["byte_cnt"] + rate * dt)
        tmr = torch.where(c, 0.0, st["tmr"] + dt)
        alpha_tmr = torch.where(c, 0.0, alpha_tmr)
        bc = torch.where(c, 0.0, st["bc_stage"])
        ts = torch.where(c, 0.0, st["t_stage"])
        rate = new_rate
        b_ev = byte_cnt >= col("rp_byte")
        t_ev = tmr >= timer
        byte_cnt = torch.where(b_ev, 0.0, byte_cnt)
        tmr = torch.where(t_ev, 0.0, tmr)
        bc = bc + b_ev.to(self.dtype)
        ts = ts + t_ev.to(self.dtype)
        ev = b_ev | t_ev
        imax, imin = torch.maximum(bc, ts), torch.minimum(bc, ts)
        in_fr, in_hyper = imax <= fr, imin > fr
        target = torch.where(ev & ~in_fr & ~in_hyper, target + col("rp_rai"),
                             target)
        target = torch.where(ev & in_hyper,
                             target + col("rp_rhai") * (imin - fr), target)
        rate = torch.where(ev, 0.5 * (rate + target), rate)
        lo, hi = col("rp_min_rate"), col("line_rate")
        return dict(rate=torch.minimum(torch.maximum(rate, lo), hi),
                    rp_target=torch.minimum(torch.maximum(target, lo), hi),
                    alpha=alpha, byte_cnt=byte_cnt, tmr=tmr,
                    alpha_tmr=alpha_tmr, bc_stage=bc, t_stage=ts)

    def _erp(self, st, cnp, tgt_rx):
        p, dt = self.p, self.dt
        col = lambda k: p[k][:, None]                  # noqa: E731
        slope = col("erp_rai") * (1.0 + col("erp_jitter") * self.jitter)
        c = cnp > 0
        lo, hi = col("erp_min_rate"), col("line_rate")
        rate = torch.where(c, torch.maximum(col("erp_settle") * tgt_rx, lo),
                           st["rate"])
        hold = torch.where(c, col("erp_hold"),
                           torch.clamp_min(st["hold"] - dt, 0.0))
        rate = torch.where(~c & (hold <= 0), rate + slope * dt, rate)
        return dict(rate=torch.minimum(torch.maximum(rate, lo), hi),
                    hold=hold)

    def _swift(self, st, qdelay):
        p, dt = self.p, self.dt
        col = lambda k: p[k][:, None]                  # noqa: E731
        target, beta = col("swift_target"), col("swift_beta")
        cool = torch.clamp_min(st["swift_cool"] - dt, 0.0)
        over = qdelay > target
        can = cool <= 0.0
        factor = 1.0 - beta * (qdelay - target) / torch.clamp_min(qdelay,
                                                                   1e-12)
        dec = torch.maximum(st["rate"] * torch.maximum(factor, 1.0 - beta),
                            col("swift_min_rate"))
        rate = torch.where(over & can, dec,
                           torch.where(over, st["rate"],
                                       st["rate"] + col("swift_ai") * dt))
        cool = torch.where(over & can, col("swift_guard"), cool)
        rate = torch.minimum(torch.maximum(rate, col("swift_min_rate")),
                             col("line_rate"))
        return rate, cool

    # -- a whole run, decimated ---------------------------------------------

    def run(self, n_steps: int, trace_every: int) -> dict:
        """Advance ``ceil(n_steps / trace_every)`` windows; returns host
        numpy traces ``[R, T, ...]`` by field and the final state."""
        n_samples = -(-n_steps // trace_every)
        R, F, dev = self.R, self.F, self.device
        st = self.init_state()
        window = torch.tensor(trace_every * self.dt_s,
                              dtype=torch.float32).to(dev, self.dtype)
        i64 = torch.int64
        acc = dict(max_q=st["nicq"].new_zeros((R,)),
                   n_paused=torch.zeros((R,), dtype=i64, device=dev),
                   marked=torch.zeros((R, F), dtype=i64, device=dev),
                   cnp=torch.zeros((R, F), dtype=i64, device=dev),
                   ctrl=st["nicq"].new_zeros((R, F)),
                   pause_time=st["nicq"].new_zeros((R,)))

        def advance():
            new, tr = self.step(st)
            for k, v in new.items():
                st[k].copy_(v)
            acc["max_q"].copy_(torch.maximum(acc["max_q"], tr["max_q"]))
            acc["n_paused"].copy_(torch.maximum(acc["n_paused"],
                                                tr["n_paused"]))
            for k in ("marked", "cnp"):
                acc[k].add_(tr[k].to(i64))
            acc["ctrl"].add_(tr["ctrl"])
            acc["pause_time"].add_(tr["pause_time"])

        graph = None
        with torch.no_grad():
            if dev.type == "cuda":
                graph = self._capture(advance, st, acc)
            out = {f: [] for f in TRACE_FIELDS}
            for _ in range(n_samples):
                d0 = st["delivered"].clone()
                for v in acc.values():
                    v.zero_()
                for _ in range(trace_every):
                    graph.replay() if graph is not None else advance()
                sample = dict(acc, delivered=st["delivered"], rate=st["rate"],
                              inst_thr=(st["delivered"] - d0) / window,
                              n_nonmin=torch.zeros((R,), dtype=i64),
                              vc_stall=acc["pause_time"][:, None])
                for f in TRACE_FIELDS:
                    out[f].append(np.array(sample[f].float().cpu()))
        traces = {f: np.stack(v, axis=1) for f, v in out.items()}
        final = {k: np.array(v.float().cpu()) for k, v in st.items()}
        return {"traces": traces, "final": final}

    def _capture(self, advance, st: dict, acc: dict):
        """One step as a CUDA graph over ``st`` and ``acc``: warmed up on
        copies (so the run starts from its initial state), then captured."""
        keep = {k: v.clone() for k, v in st.items()}
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                advance()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            advance()
        for k, v in keep.items():
            st[k].copy_(v)
        return graph
