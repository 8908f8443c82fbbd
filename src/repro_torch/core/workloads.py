"""Collective-workload generator: communication patterns of real apps.

The paper's verdicts hinge on congestion *dynamics*, which are set by
what applications actually do on the wire — collectives, incast storms,
hotspots, bursts — not just the §II 5-flow scene.  Each generator here
emits a ``Workload``: plain per-flow tuples (src, dst, start, stop,
volume, rate) that compile through ``ScenarioSpec.from_workload`` to
the padded/stackable ``Scenario`` tensors, so any (fabric x workload)
point drops straight into one-jit ``Sweep`` evaluation:

    from repro_torch.core import PAPER_CONFIG, CCScheme, Sweep
    from repro_torch.core.workloads import ring_allreduce, incast_storm
    from repro_torch.net import FabricSpec

    fab = FabricSpec.fat_tree(4, taper=2)
    Sweep.grid(
        configs={s.name: PAPER_CONFIG.replace(scheme=s) for s in CCScheme},
        scenarios={
            "ring": ring_allreduce(16, 8e6).spec(fabric=fab),
            "storm": incast_storm(24, 4, 64, volume=2e6).spec(fabric=fab),
        }).run()

Phases are modelled by staggered start times (the fluid model has no
inter-flow dependencies): phase p opens at ``t0 + p * phase_gap``,
with ``phase_gap`` defaulting to the slack-scaled serialisation time
of one phase's bytes at line rate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .experiments import ScenarioSpec

LINE_RATE = 12.5e9            # B/s default for phase-gap sizing only
INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Workload:
    """Per-flow traffic description as plain (hashable) tuples."""

    src: tuple[int, ...]
    dst: tuple[int, ...]
    t_start: tuple[float, ...]
    t_stop: tuple[float, ...]          # inf with finite volume = work mode
    volume: tuple[float, ...]          # bytes; inf = window-limited
    # B/s per flow; None = all at line rate.  Workloads are built before
    # the config's line rate is known, so two sentinels resolve at
    # ``build(cfg)`` time: an entry of inf means "line rate", and a
    # negative entry -f means "fraction f of line rate".
    rate: tuple[float, ...] | None = None
    label: str = "workload"
    # victim designation for the PFC-pathology metrics: flows that do
    # NOT cause the congestion under test but share fabric with it
    # (compiled to ``Scenario.victim``, aggregated by
    # ``SimResult.victim_slowdown``).  Empty = no designated victims.
    victim: tuple[bool, ...] = ()
    # per-flow virtual-channel pin (compiled to ``ScenarioSpec.flow_vc``;
    # clipped to the config's ``LinkParams.n_vcs``).  Empty = the
    # spec's ``vc_mode`` rule decides.
    vc: tuple[int, ...] = ()

    @property
    def n_flows(self) -> int:
        return len(self.src)

    def spec(self, fabric=None, **kw) -> ScenarioSpec:
        """Compile onto a fabric (see ScenarioSpec.from_workload)."""
        return ScenarioSpec.from_workload(self, fabric=fabric, **kw)

    def __post_init__(self):
        n = len(self.src)
        for f in ("dst", "t_start", "t_stop", "volume"):
            if len(getattr(self, f)) != n:
                raise ValueError(f"{f} has {len(getattr(self, f))} entries "
                                 f"for {n} flows")
        if self.rate is not None and len(self.rate) != n:
            raise ValueError("rate length mismatch")
        for f in ("victim", "vc"):
            if getattr(self, f) and len(getattr(self, f)) != n:
                raise ValueError(f"{f} length mismatch")


def concat(*workloads: Workload, label: str | None = None) -> Workload:
    """Mix workloads into one (e.g. a collective + background traffic)."""
    if not workloads:
        raise ValueError("nothing to concat")
    rates = [w.rate or (INF,) * w.n_flows for w in workloads]
    vics = [w.victim or (False,) * w.n_flows for w in workloads]
    vcs = [w.vc or (0,) * w.n_flows for w in workloads]
    any_vic = any(any(v) for v in vics)
    any_vc = any(any(v) for v in vcs)
    return Workload(
        src=sum((w.src for w in workloads), ()),
        dst=sum((w.dst for w in workloads), ()),
        t_start=sum((w.t_start for w in workloads), ()),
        t_stop=sum((w.t_stop for w in workloads), ()),
        volume=sum((w.volume for w in workloads), ()),
        rate=sum((tuple(r) for r in rates), ()),
        victim=sum((tuple(v) for v in vics), ()) if any_vic else (),
        vc=sum((tuple(v) for v in vcs), ()) if any_vc else (),
        label=label or "+".join(w.label for w in workloads))


def _mk(src, dst, t0, t1, vol, rate=None, label="workload",
        victim=None, vc=None) -> Workload:
    return Workload(
        src=tuple(int(s) for s in src), dst=tuple(int(d) for d in dst),
        t_start=tuple(float(t) for t in t0),
        t_stop=tuple(float(t) for t in t1),
        volume=tuple(float(v) for v in vol),
        rate=None if rate is None else tuple(float(r) for r in rate),
        victim=() if victim is None else tuple(bool(v) for v in victim),
        vc=() if vc is None else tuple(int(v) for v in vc),
        label=label)


def _gap(bytes_per_flow: float, line_rate: float, slack: float) -> float:
    return slack * bytes_per_flow / line_rate


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_to_all(n_nodes: int, volume: float, *, phases: int | None = None,
               phase_gap: float | None = None, t_start: float = 0.0,
               line_rate: float = LINE_RATE, slack: float = 2.0,
               nodes=None) -> Workload:
    """Phased all-to-all: shift k sends node i -> (i+k) % n.

    The n-1 shifts are spread over ``phases`` groups (default: one
    phase per shift, the classic ring-ordered exchange); each phase
    opens ``phase_gap`` after the previous.  ``volume`` is bytes per
    (src, dst) pair; ``nodes`` restricts the participant set.
    """
    nodes = list(range(n_nodes)) if nodes is None else list(nodes)
    n = len(nodes)
    if n < 2:
        raise ValueError("all_to_all needs >= 2 participants")
    phases = n - 1 if phases is None else int(phases)
    if not 1 <= phases <= n - 1:
        raise ValueError(f"phases must be in [1, {n - 1}]")
    shifts_per_phase = -(-(n - 1) // phases)
    if phase_gap is None:
        phase_gap = _gap(volume * shifts_per_phase, line_rate, slack)
    src, dst, t0 = [], [], []
    for k in range(1, n):
        p = (k - 1) % phases
        for i in range(n):
            src.append(nodes[i])
            dst.append(nodes[(i + k) % n])
            t0.append(t_start + p * phase_gap)
    return _mk(src, dst, t0, [INF] * len(src), [volume] * len(src),
               label=f"a2a{n}p{phases}")


def ring_allreduce(n_nodes: int, bytes_total: float, *,
                   phased: bool = False, phase_gap: float | None = None,
                   t_start: float = 0.0, line_rate: float = LINE_RATE,
                   slack: float = 2.0, nodes=None) -> Workload:
    """Ring allreduce: reduce-scatter + allgather over neighbour links.

    Unphased (default): each node's 2(n-1) chunk sends to its ring
    successor coalesce into one volume-mode flow of 2(n-1)/n * S bytes
    — the collective's true per-link traffic.  ``phased=True`` emits
    all 2(n-1) steps as separate staggered flows (n flows per step).
    """
    nodes = list(range(n_nodes)) if nodes is None else list(nodes)
    n = len(nodes)
    if n < 2:
        raise ValueError("ring needs >= 2 participants")
    chunk = bytes_total / n
    succ = [nodes[(i + 1) % n] for i in range(n)]
    if not phased:
        vol = 2 * (n - 1) * chunk
        return _mk(nodes, succ, [t_start] * n, [INF] * n, [vol] * n,
                   label=f"ring{n}")
    if phase_gap is None:
        phase_gap = _gap(chunk, line_rate, slack)
    src, dst, t0 = [], [], []
    for step in range(2 * (n - 1)):
        for i in range(n):
            src.append(nodes[i])
            dst.append(succ[i])
            t0.append(t_start + step * phase_gap)
    return _mk(src, dst, t0, [INF] * len(src), [chunk] * len(src),
               label=f"ring{n}phased")


def recursive_doubling_allreduce(n_nodes: int, bytes_total: float, *,
                                 phase_gap: float | None = None,
                                 t_start: float = 0.0,
                                 line_rate: float = LINE_RATE,
                                 slack: float = 2.0,
                                 nodes=None) -> Workload:
    """Recursive-doubling allreduce: log2(n) rounds of pairwise
    exchanges at distance 2^r, each carrying the full vector.

    The distance doubles every round, so successive rounds climb the
    fabric — late rounds are the bisection-stressing ones.
    """
    nodes = list(range(n_nodes)) if nodes is None else list(nodes)
    n = len(nodes)
    if n < 2 or n & (n - 1):
        raise ValueError(f"recursive doubling needs a power-of-two "
                         f"participant count, got {n}")
    if phase_gap is None:
        phase_gap = _gap(bytes_total, line_rate, slack)
    src, dst, t0 = [], [], []
    rounds = n.bit_length() - 1
    for r in range(rounds):
        for i in range(n):
            src.append(nodes[i])
            dst.append(nodes[i ^ (1 << r)])
            t0.append(t_start + r * phase_gap)
    return _mk(src, dst, t0, [INF] * len(src), [bytes_total] * len(src),
               label=f"rdbl{n}")


# ---------------------------------------------------------------------------
# storms, hotspots, bursts
# ---------------------------------------------------------------------------


def incast_storm(n_senders: int, n_receivers: int, n_nodes: int, *,
                 volume: float = INF, t_start: float = 1e-3,
                 t_stop: float = 3e-3, seed: int = 0) -> Workload:
    """n-to-m incast: ``n_senders`` sources fan into ``n_receivers``
    sinks round-robin (each sink absorbs ~n/m flows).  With a finite
    ``volume`` the storm is equal-work; otherwise window-mode."""
    if n_senders + n_receivers > n_nodes:
        raise ValueError(f"{n_senders}+{n_receivers} endpoints exceed "
                         f"{n_nodes} hosts")
    rng = np.random.RandomState(seed)
    picks = rng.permutation(n_nodes)[: n_senders + n_receivers]
    recv, send = picks[:n_receivers], picks[n_receivers:]
    dst = [int(recv[i % n_receivers]) for i in range(n_senders)]
    stop = INF if np.isfinite(volume) else t_stop
    return _mk(send, dst, [t_start] * n_senders, [stop] * n_senders,
               [volume] * n_senders,
               label=f"storm{n_senders}to{n_receivers}")


def group_shift(n_groups: int, hosts_per_group: int, *, shift: int = 1,
                volume: float = INF, t_start: float = 0.0,
                t_stop: float = 3e-3) -> Workload:
    """Adversarial group-shifted permutation: host j of group g sends
    to host j of group (g + shift) % n_groups.

    On a dragonfly (``hosts_per_group = a * p``) this is the classic
    worst case for minimal routing: every flow leaving group g wants
    the *single* global channel g -> g+shift, so that one link carries
    ``hosts_per_group`` line-rate flows while every other global
    channel idles.  Valiant/UGAL detours spread the same traffic over
    two hops through random intermediate groups — the scenario where
    non-minimal routing must win.  (The pattern is fabric-agnostic:
    hosts are numbered group-major, matching the dragonfly layout.)
    """
    if n_groups < 2 or shift % n_groups == 0:
        raise ValueError(f"need >= 2 groups and a non-identity shift, "
                         f"got {n_groups} groups, shift {shift}")
    n = n_groups * hosts_per_group
    src = list(range(n))
    dst = [((g + shift) % n_groups) * hosts_per_group + j
           for g in range(n_groups) for j in range(hosts_per_group)]
    stop = INF if np.isfinite(volume) else t_stop
    return _mk(src, dst, [t_start] * n, [stop] * n, [volume] * n,
               label=f"gshift{n_groups}x{hosts_per_group}s{shift}")


def hotspot(n_flows: int, n_nodes: int, *, hot_frac: float = 0.5,
            hot_node: int = 0, bg_rate_frac: float = 0.5,
            t_start: float = 0.5e-3, t_stop: float = 3e-3,
            seed: int = 0) -> Workload:
    """Hotspot mix: ``hot_frac`` of the flows converge on ``hot_node``
    at line rate; the rest are random-pair background at
    ``bg_rate_frac`` of line rate (the tenants a throttler must not
    collaterally damage).  Rates use the config-agnostic sentinels
    (inf = line rate, -f = fraction f of it), so the workload tracks
    whatever line rate the scenario builds against."""
    rng = np.random.RandomState(seed)
    n_hot = int(round(n_flows * hot_frac))
    src, dst, rate = [], [], []
    others = [v for v in range(n_nodes) if v != hot_node]
    for i in range(n_hot):
        src.append(others[int(rng.randint(len(others)))])
        dst.append(hot_node)
        rate.append(INF)
    for i in range(n_flows - n_hot):
        s = int(rng.randint(n_nodes))
        d = int(rng.randint(n_nodes - 1))
        d = d + 1 if d >= s else d
        src.append(s)
        dst.append(d)
        rate.append(-bg_rate_frac)
    n = len(src)
    return _mk(src, dst, [t_start] * n, [t_stop] * n, [INF] * n, rate,
               label=f"hot{n_flows}f{hot_frac:g}")


def bursty(n_flows: int, n_nodes: int, *, on: float = 0.3e-3,
           off: float = 0.7e-3, n_bursts: int = 3, t_start: float = 0.0,
           jitter: float = 0.5, seed: int = 0) -> Workload:
    """Bursty on/off arrivals: each of ``n_flows`` random pairs fires
    ``n_bursts`` line-rate bursts of ``on`` seconds separated by ``off``
    seconds, with per-flow phase jitter — every burst is its own
    window-mode flow entry sharing the pair's route."""
    rng = np.random.RandomState(seed)
    src, dst, t0, t1 = [], [], [], []
    period = on + off
    for f in range(n_flows):
        s = int(rng.randint(n_nodes))
        d = int(rng.randint(n_nodes - 1))
        d = d + 1 if d >= s else d
        phase = float(rng.rand()) * jitter * period
        for b in range(n_bursts):
            t0.append(t_start + phase + b * period)
            t1.append(t0[-1] + on)
            src.append(s)
            dst.append(d)
    n = len(src)
    return _mk(src, dst, t0, t1, [INF] * n,
               label=f"burst{n_flows}x{n_bursts}")


# ---------------------------------------------------------------------------
# PFC pathologies (victim-flagged scenarios for the injection-throttling
# comparisons: HOL blocking, pause cascades, credit loops)
# ---------------------------------------------------------------------------


def hol_victim_incast(n_senders: int, n_nodes: int, *,
                      leaf_arity: int = 4, hot: int | None = None,
                      victim_rate: float = -0.3,
                      victim_delay: float = 1e-3,
                      burst_delay: float = 1.5e-3,
                      t_start: float = 1e-3,
                      t_stop: float = 5e-3) -> Workload:
    """Head-of-line-blocking incast with one designated victim flow.

    Two-wave geometry, built so the three throttling philosophies land
    in their characteristic order on the victim:

      * wave A — ``n_senders - 1`` line-rate sources, one per leaf
        (skipping leaf 0 and the hot leaf), open at ``t_start`` and
        converge onto host ``hot``;
      * the victim — last slot of leaf 0, at a *modest*
        ``victim_rate`` — joins at ``t_start + victim_delay``, once a
        working throttler has the incast under control;
      * wave B — one more line-rate sender on leaf 0 — lands at
        ``t_start + burst_delay``, slamming the victim's own uplink
        wire through the marking threshold.

    The CLOS route tables hash a flow's uplink slot by ``dst %
    leaf_arity``, so the victim's sink (on a third, uninvolved leaf)
    is chosen congruent to ``hot``: the victim rides exactly the wire
    wave B saturates while its own NIC stays idle — the paper's F3 =
    N3 -> N12 against N16, generalised.  Under PFC-only the shared
    wire is simply xoff-paused, stalling the victim outright; DCQCN's
    occupancy marking (cp) cannot tell the victim from the burst and
    cuts both, then recovers it at the glacial additive-increase rate;
    the refined grant-aware marking (ecp) sees the victim below its
    fair share and spares it.  Hence the scenario's defining metric
    ordering ``victim_slowdown: REV < DCQCN < PFC_ONLY``.  The victim
    is flagged in ``Workload.victim`` so ``SimResult.victim_slowdown``
    reports it directly (hosts are numbered leaf-major, as on the CLOS
    fabrics)."""
    if n_senders < 2:
        raise ValueError("need >= 2 senders (wave A + the wave-B burst)")
    hot = n_nodes - 1 if hot is None else int(hot)
    A = leaf_arity
    hot_leaf, n_leaves = hot // A, n_nodes // A
    if n_leaves < 3 or hot_leaf == 0:
        raise ValueError("need >= 3 leaves with the hot host off leaf 0")
    v_src = A - 1                                  # last slot of leaf 0
    v_leaf = next(g for g in range(1, n_leaves) if g != hot_leaf)
    v_dst = v_leaf * A + hot % A                   # collides by dst-hash
    wave_a = [g * A + s for s in range(A - 1)
              for g in range(1, n_leaves)
              if g != hot_leaf and g * A + s != v_dst][:n_senders - 1]
    if len(wave_a) < n_senders - 1:
        raise ValueError(f"{n_nodes} hosts / arity {A} fit only "
                         f"{len(wave_a)} wave-A senders, need "
                         f"{n_senders - 1}")
    wave_b = [0]                                   # leaf-0 slot 0
    src = wave_a + wave_b + [v_src]
    dst = [hot] * n_senders + [v_dst]
    t0 = ([t_start] * len(wave_a) + [t_start + burst_delay]
          + [t_start + victim_delay])
    n = n_senders + 1
    return _mk(src, dst, t0, [t_stop] * n, [INF] * n,
               [INF] * n_senders + [victim_rate],
               victim=[False] * n_senders + [True],
               label=f"holvictim{n_senders}")


def pause_storm(n_stages: int, fan: int, n_nodes: int, *,
                leaf_arity: int = 4, stage_gap: float = 0.3e-3,
                victim_rate: float = INF, t_start: float = 1e-3,
                t_stop: float = 4e-3) -> Workload:
    """Pause-storm cascade: staggered incast waves widening the paused
    region stage by stage.

    Stage s (at ``t_start + s * stage_gap``) aims ``fan`` line-rate
    senders at the s-th host of the hot leaf, so each wave adds another
    saturated downlink behind the same last-hop switch: xoff trips
    wire by wire and the pause front climbs into the spine instead of
    staying put.  ``n_stages`` through-flows from the
    sender leaves to an *uninvolved* sink leaf are flagged victims —
    their sinks stay idle the whole run, but every wave widens the
    paused region their traffic must cross.  ``SimResult.pause_duration``
    on this workload measures the cascade directly."""
    n_leaves = (n_nodes + leaf_arity - 1) // leaf_arity
    if n_leaves < 3:
        raise ValueError("pause_storm needs >= 3 leaves (hot leaf, "
                         "sender leaves, victim-sink leaf)")
    hot_hosts = list(range((n_leaves - 1) * leaf_arity, n_nodes))
    sink_hosts = list(range((n_leaves - 2) * leaf_arity,
                            (n_leaves - 1) * leaf_arity))
    pool = list(range((n_leaves - 2) * leaf_arity))  # sender/victim srcs
    src, dst, t0, t1, rate, victim = [], [], [], [], [], []
    k = 0
    for s in range(n_stages):
        start = t_start + s * stage_gap
        for _ in range(fan):
            src.append(pool[k % len(pool)])
            dst.append(hot_hosts[s % len(hot_hosts)])
            t0.append(start)
            t1.append(t_stop)
            rate.append(INF)
            victim.append(False)
            k += 1
    for s in range(n_stages):                     # through-flow victims
        src.append(pool[(k + s) % len(pool)])
        dst.append(sink_hosts[s % len(sink_hosts)])
        t0.append(t_start * 0.5)                  # up before the storm
        t1.append(t_stop)
        rate.append(victim_rate)
        victim.append(True)
    n = len(src)
    return _mk(src, dst, t0, t1, [INF] * n, rate, victim=victim,
               label=f"pausestorm{n_stages}x{fan}")


def credit_loop(n_groups: int, hosts_per_group: int, *, shift: int = 1,
                probe_rate: float = -0.25, volume: float = INF,
                t_start: float = 0.0, t_stop: float = 3e-3) -> Workload:
    """Dragonfly credit-loop: cyclic backpressure around the global
    channels, with probe flows as victims.

    Hosts ``j < hosts_per_group - 1`` of group g send to the same slot
    of group ``g + shift``, saturating the cyclic chain of global
    channels g -> g+shift -> g+2*shift -> ... -> g.  Under PFC the xoff
    backpressure circulates that same cycle — the fluid-model analogue
    of a credit-loop deadlock: pauses feed themselves and throughput
    collapses even though every queue would drain if any one link were
    released.  The last host of each group sends a ``probe_rate`` probe
    ``shift + 1`` groups ahead (riding the paused global channels but
    sinking elsewhere) and is flagged victim.  Compiling the spec with
    ``vc_mode="hop"`` and ``n_vcs >= 2`` breaks the cycle: later hops
    escalate to a higher VC (dateline rule), so the pause loop cannot
    close — the per-VC story this scenario exists to exercise.
    Hosts are numbered group-major, matching the dragonfly layout."""
    if n_groups < 3:
        raise ValueError("credit loop needs >= 3 groups to form a cycle")
    if hosts_per_group < 2:
        raise ValueError("need >= 2 hosts/group (loop + probe slots)")
    if shift % n_groups == 0:
        raise ValueError("identity shift closes no cycle")
    src, dst, rate, victim, vol = [], [], [], [], []
    for g in range(n_groups):
        for j in range(hosts_per_group - 1):
            src.append(g * hosts_per_group + j)
            dst.append(((g + shift) % n_groups) * hosts_per_group + j)
            rate.append(INF)
            victim.append(False)
            vol.append(volume)
    j = hosts_per_group - 1
    for g in range(n_groups):
        src.append(g * hosts_per_group + j)
        dst.append(((g + shift + 1) % n_groups) * hosts_per_group + j)
        rate.append(probe_rate)
        victim.append(True)
        vol.append(INF)                           # probes stay window-mode
    n = len(src)
    stop = INF if np.isfinite(volume) else t_stop
    t1 = [stop] * (n - n_groups) + [t_stop] * n_groups
    return _mk(src, dst, [t_start] * n, t1, vol, rate, victim=victim,
               label=f"creditloop{n_groups}x{hosts_per_group}")
