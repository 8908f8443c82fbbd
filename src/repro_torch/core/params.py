"""Congestion-control parameters for the DCQCN / DCQCN-Rev closed loop.

All constants follow the paper (§II.A) and, where the paper defers, the
original DCQCN fluid model (Zhu et al., SIGCOMM'15, [6]):

* 100 Gbps serial full-duplex pipelined links, 25 ns propagation delay.
* Tomahawk-3-like switches: 64 MB shared buffer, >= 512 KB per port.
* MTU 1 KB;  Kmin = Kmax = V = 15 KB  (step marking).
* DCQCN RP constants from [6]: g = 1/256, timer T = 55 us, byte counter
  B = 10 MB, RAI = 40 Mbps, RHAI = 200 Mbps, rate-decrease factor 1/2,
  NP CNP window 50 us.

Everything is a frozen dataclass of plain floats so that configs hash and
jit caches key cleanly; arrays live in the simulator state, not here.
"""

from __future__ import annotations

import dataclasses
import enum


class CCScheme(enum.IntEnum):
    """Which closed loop is active (static python-level switch)."""

    PFC_ONLY = 0      # no end-to-end CC; only hop-by-hop PFC backpressure
    DCQCN = 1         # CP/NP/RP per [6]
    DCQCN_REV = 2     # ECP/ENP/ERP per the paper


@dataclasses.dataclass(frozen=True)
class LinkParams:
    """Physical link + switch buffer constants (paper §II.A)."""

    line_rate: float = 12.5e9          # B/s  (100 Gbps)
    propagation_delay: float = 25e-9   # s, per hop
    mtu: float = 1024.0                # B
    port_buffer: float = 512 * 1024.0  # B, per-port guaranteed share
    shared_buffer: float = 64 * 1024 * 1024.0  # B, switch total (Tomahawk 3)
    # PFC thresholds (fractions of the per-port buffer). XOFF below XON is a
    # config error; hysteresis keeps pause from chattering at the boundary.
    pfc_xoff_frac: float = 0.75
    pfc_xon_frac: float = 0.50
    # Virtual channels per wire.  Each wire's input buffer splits into
    # ``n_vcs`` independent queues with their own PFC pause state and
    # FIFO order (per-VC thresholds are the port thresholds / n_vcs);
    # capacity stays shared per wire.  VC assignment is scenario data
    # (``Scenario.vc``, default: Valiant detours ride VC 1 so they stop
    # HoL-blocking minimal traffic).  ``n_vcs = 1`` is bit-identical to
    # the single-queue model (golden-grid held).
    n_vcs: int = 1

    def __post_init__(self):
        if self.pfc_xoff_frac <= self.pfc_xon_frac:
            raise ValueError(
                f"PFC XOFF threshold must sit above XON for the pause "
                f"hysteresis to work: pfc_xoff_frac={self.pfc_xoff_frac} "
                f"<= pfc_xon_frac={self.pfc_xon_frac} would pause and "
                f"unpause in the same region (or never unpause)")
        if not (isinstance(self.n_vcs, int) and self.n_vcs >= 1):
            raise ValueError(
                f"n_vcs={self.n_vcs!r} must be a positive int: it is a "
                f"static shape parameter (per-VC queue/pause state is "
                f"[n_links * n_vcs])")


@dataclasses.dataclass(frozen=True)
class DCQCNParams:
    """CP/NP/RP constants per [6]; Kmin=Kmax=V per the paper's §II.A."""

    # --- CP (switch marking) ---
    kmin: float = 15 * 1024.0          # B
    kmax: float = 15 * 1024.0          # B
    pmax: float = 1.0                  # marking prob at kmax (step since kmin==kmax)
    # --- NP (destination NIC) ---
    cnp_window: float = 50e-6          # s, min gap between CNPs of one flow
    # --- RP (source NIC) ---
    g: float = 1.0 / 256.0             # alpha EWMA gain
    alpha_init: float = 1.0
    rate_decrease_factor: float = 0.5  # R <- R * (1 - alpha * f)
    timer_T: float = 55e-6             # s, rate-increase timer period
    byte_counter_B: float = 10e6       # B, rate-increase byte period
    rai: float = 5e6                   # B/s additive increase (40 Mbps)
    rhai: float = 25e6                 # B/s hyper increase   (200 Mbps)
    fr_stages: int = 5                 # fast-recovery stages before AI
    min_rate: float = 1e6              # B/s floor so flows never starve

    def __post_init__(self):
        if self.kmin > self.kmax:
            raise ValueError(
                f"kmin={self.kmin} > kmax={self.kmax}: the marking ramp "
                f"must be non-decreasing (kmin == kmax gives step "
                f"marking; kmin < kmax the slope ramp up to pmax)")
        # The tuner explores these boxes programmatically (bounded
        # reparameterisations in repro.tune); construction-time checks
        # keep a mis-specified box from silently simulating nonsense.
        if not 0.0 < self.pmax <= 1.0:
            raise ValueError(
                f"pmax={self.pmax} must lie in (0, 1]: it is the marking "
                f"probability at kmax (0 would never mark, >1 is not a "
                f"probability)")
        if not 0.0 < self.g <= 1.0:
            raise ValueError(
                f"g={self.g} must lie in (0, 1]: it is the alpha EWMA "
                f"gain of the RP state machine")
        for name in ("rai", "rhai", "timer_T", "byte_counter_B",
                     "min_rate", "cnp_window"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(
                    f"{name}={v} must be non-negative (rate-increase "
                    f"gains, periods and floors have no meaningful "
                    f"negative form)")
        if not 0.0 <= self.rate_decrease_factor <= 1.0:
            raise ValueError(
                f"rate_decrease_factor={self.rate_decrease_factor} must "
                f"lie in [0, 1]: R <- R * (1 - alpha * f) would raise "
                f"the rate on congestion otherwise")


@dataclasses.dataclass(frozen=True)
class RevParams:
    """ECP/ENP/ERP constants (the paper's contribution).

    ECP: a flow is marked only if its measured arrival rate at the congested
    egress exceeds ``ecp_fairness_slack`` x fair-share of the drain rate.
    ENP: CNPs are immediate (coalesced at ``enp_coalesce``) and carry
    (drain bandwidth, n_contributors) severity.
    ERP: on CNP the rate is set to the signalled fair share scaled by
    ``erp_settle``; recovery is additive with a deterministic per-flow
    jitter in [1-j, 1+j] to desynchronise flows.
    """

    detect_threshold: float = 15 * 1024.0  # B, same V as DCQCN for parity
    ecp_fairness_slack: float = 1.10       # >1: tolerate small overshoot
    ecp_rate_ewma: float = 0.2             # per-dt EWMA for arrival estimate
    enp_coalesce: float = 5e-6             # s, CNP coalescing interval
    erp_settle: float = 0.98               # target = settle * fair_share
    erp_rai: float = 5e12                  # B/s^2 additive recovery slope
    #   (full 12.5 GB/s ramp in ~2.5 ms — same timescale DCQCN's staged
    #    recovery needs, but desynchronised and starting from fair share)
    erp_jitter: float = 0.5                # +-50% per-flow slope jitter
    erp_hold: float = 50e-6                # s, hold at target before recovery
    erp_drain_gain: float = 0.5            # severity: scale target below
    #   fair share in proportion to queue excess over V, so standing
    #   queues drain and the rate converges to fair as occupancy -> V
    min_rate: float = 1e6                  # B/s floor


@dataclasses.dataclass(frozen=True)
class FNCCParams:
    """FNCC-style fast in-path notification constants.

    Instead of the destination NIC echoing a CNP after the full forward
    trip, the congested switch writes the severity payload directly into
    the *return* path: the feedback delay shrinks from one RTT to the
    upstream trip from the marking hop back to the source,
    ``rtt/2 * (h_mark+1)/hops`` (scaled by ``rtt_scale``).
    """

    coalesce: float = 5e-6             # s, per-flow notification coalescing
    rtt_scale: float = 1.0             # scale on the hop-proportional delay


@dataclasses.dataclass(frozen=True)
class SwiftParams:
    """Delay-target reaction constants (Swift-like, mark-free).

    The source throttles on its *queuing-delay estimate* (bytes queued
    along the path / line rate) instead of mark arrival: multiplicative
    decrease proportional to the excess over ``target_delay`` (at most
    once per ``guard`` seconds), additive recovery below target.
    """

    target_delay: float = 3e-6         # s of path queuing delay
    beta: float = 0.8                  # max multiplicative decrease
    ai: float = 1e12                   # B/s^2 additive recovery slope
    guard: float = 25e-6               # s between decreases (~RTT pacing)
    min_rate: float = 1e6              # B/s floor


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Integrator constants."""

    dt: float = 1e-6                   # s, fluid step
    t_end: float = 14e-3               # s, simulate past DCQCN's 12.5 ms tail
    trace_every: int = 10              # record a trace sample every N steps


#: Routing-mode selectors (traced into ``StepParams.route_code``):
#: ``min`` pins every flow to its minimal path; ``valiant`` pins a
#: sampled VLB detour at flow start; ``ugal`` compares queue-weighted
#: hop costs (UGAL-L) at flow start and on CNP epochs.  Modes beyond
#: ``min`` need a multi-path scenario (``ScenarioSpec(n_paths > 1)``)
#: to have any candidates to pick from.
ROUTING_MODES = ("min", "valiant", "ugal")


@dataclasses.dataclass(frozen=True)
class CCSpec:
    """Composable CC description: one pluggable component per stage.

    The closed loop decomposes into three independently improvable
    mechanisms — congestion detection (``marking``), notification
    (``notification``) and injection throttling (``reaction``) — each
    named by a registry entry in ``repro_torch.core.cc``.  Every name traces
    to an integer code in ``StepParams``, so any (marking x
    notification x reaction x param-grid) product still compiles to ONE
    ``Sweep`` launch.

    Built-in stages (see ``repro_torch.core.cc`` to add more):
      * marking:      ``cp`` (step occupancy), ``ecp`` (occupancy AND
                      rate over fair grant), ``slope`` (RED-style
                      kmin<kmax ramp up to ``pmax``, error-diffused)
      * notification: ``np`` (CNP window), ``enp`` (fast coalescing +
                      severity), ``fncc`` (in-path: congested hop
                      writes the return path, shrinking the delay)
      * reaction:     ``pfc`` (fixed-rate source), ``rp`` (DCQCN),
                      ``erp`` (the paper), ``swift`` (delay-target)

    The legacy ``CCConfig`` maps onto this via ``CCConfig.to_spec()``
    bit-exactly (golden-grid verified).
    """

    marking: str = "ecp"
    notification: str = "enp"
    reaction: str = "erp"
    # adaptive-routing mode (see ROUTING_MODES); a traced selector, so
    # routing joins the stage names as a one-launch sweep axis
    routing: str = "min"
    link: LinkParams = dataclasses.field(default_factory=LinkParams)
    dcqcn: DCQCNParams = dataclasses.field(default_factory=DCQCNParams)
    rev: RevParams = dataclasses.field(default_factory=RevParams)
    fncc: FNCCParams = dataclasses.field(default_factory=FNCCParams)
    swift: SwiftParams = dataclasses.field(default_factory=SwiftParams)
    sim: SimParams = dataclasses.field(default_factory=SimParams)

    def __post_init__(self):
        from . import cc                     # deferred: cc imports params
        for family, name in ((cc.MARKING, self.marking),
                             (cc.NOTIFICATION, self.notification),
                             (cc.REACTION, self.reaction)):
            if name not in family:
                raise ValueError(
                    f"unknown {family.family} stage {name!r}; registered: "
                    f"{family.names()} (register new stages via "
                    f"repro_torch.core.cc.{family.family.upper()}.register)")
        if self.routing not in ROUTING_MODES:
            raise ValueError(f"unknown routing mode {self.routing!r}; "
                             f"expected one of {ROUTING_MODES}")

    def replace(self, **kw) -> "CCSpec":
        return dataclasses.replace(self, **kw)

    @property
    def name(self) -> str:
        return f"{self.marking}+{self.notification}+{self.reaction}"

    def to_spec(self) -> "CCSpec":
        return self


@dataclasses.dataclass(frozen=True)
class CCConfig:
    """Legacy scheme-enum config — a thin shim over ``CCSpec``.

    ``scheme`` (+ the ``marking``/``reaction`` ablation overrides) maps
    onto stage-registry entries via ``to_spec()``; the mapping is
    bit-exact on the golden grid, so existing configs and sweeps keep
    their numerics.  New code should construct ``CCSpec`` directly —
    it exposes notification as its own axis and accepts any registered
    stage (the override fields here also accept new registry names,
    e.g. ``marking="slope"`` or ``reaction="swift"``).
    """

    scheme: CCScheme = CCScheme.DCQCN_REV
    link: LinkParams = dataclasses.field(default_factory=LinkParams)
    dcqcn: DCQCNParams = dataclasses.field(default_factory=DCQCNParams)
    rev: RevParams = dataclasses.field(default_factory=RevParams)
    fncc: FNCCParams = dataclasses.field(default_factory=FNCCParams)
    swift: SwiftParams = dataclasses.field(default_factory=SwiftParams)
    sim: SimParams = dataclasses.field(default_factory=SimParams)
    # ablation overrides (None -> derived from scheme): isolate the
    # paper's mechanisms — marking in {cp, ecp, ...}, reaction in
    # {rp, erp, ...} (any registered stage name)
    marking: str | None = None
    reaction: str | None = None
    # adaptive-routing mode (see ROUTING_MODES); a traced selector, so
    # routing joins scheme/Kmin/gain as a one-launch sweep axis
    routing: str = "min"

    def replace(self, **kw) -> "CCConfig":
        return dataclasses.replace(self, **kw)

    @property
    def marking_kind(self) -> str:
        if self.marking:
            return self.marking
        return "ecp" if self.scheme == CCScheme.DCQCN_REV else "cp"

    @property
    def reaction_kind(self) -> str:
        if self.reaction:
            return self.reaction
        return "erp" if self.scheme == CCScheme.DCQCN_REV else "rp"

    def to_spec(self) -> CCSpec:
        """The registry view of this config (bit-exact shim).

        PFC_ONLY pins the fixed-rate ``pfc`` reaction (reaction
        overrides are ignored, as before); notification follows the
        reaction like the legacy window selection did — ``np`` with RP,
        ``enp`` otherwise.
        """
        reaction = ("pfc" if self.scheme == CCScheme.PFC_ONLY
                    else self.reaction_kind)
        notification = "np" if self.reaction_kind == "rp" else "enp"
        return CCSpec(
            marking=self.marking_kind, notification=notification,
            reaction=reaction, routing=self.routing, link=self.link,
            dcqcn=self.dcqcn, rev=self.rev, fncc=self.fncc,
            swift=self.swift, sim=self.sim)


PAPER_CONFIG = CCConfig()
