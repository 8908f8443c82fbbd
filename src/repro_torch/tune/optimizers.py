"""CC parameter tuners: gradient (soft model), ES and BO (hard model)
(port of ``repro.tune.optimizers``).

The pieces:

  * :class:`TunableParam` / :class:`ParamBox` — a bounded, optionally
    log-scaled search box over CC constants.  Each knob names both its
    ``StepParams`` leaves (what a traced rollout reads, e.g.
    ``"mark.cp_kmin"``) and its config paths (what a human sets, e.g.
    ``"dcqcn.kmin"``); ``apply`` swaps tuned values into a ``StepParams``
    inside a differentiated rollout, ``to_spec`` writes the same values back into
    a frozen ``CCSpec`` and *asserts* the two routes agree through
    ``step_params`` — the box cannot silently tune a different constant
    than it reports.
  * :class:`TuneProblem` / :class:`Evaluator` — one (config, scenario,
    objective) instance.  ``value_and_grad`` differentiates the
    temperature-smoothed rollout (``repro_torch.tune.soft``) through the
    dt loop with autograd, eagerly: the forward launches the CC and
    ``segment_reduce`` kernels on the card and their autograd rules
    (``kernels.cc_step.PlainVJP``, ``kernels.fluid_reduce.
    SegmentSumVJP``) carry the gradient back through them; on the card
    it runs under ``torch.use_deterministic_algorithms``, so two calls
    at one theta are bitwise equal.  ``hard_values`` scores parameter
    batches on the exact hard model by riding ``Sweep.run`` — the
    population IS a sweep, so ES/BO evaluations ride the run axis and
    hit ``SWEEP_EXEC_CACHE`` (one captured window a population shape).
  * :class:`GradTuner` — Adam (inlined; no external optimiser dep) on
    an unconstrained reparameterisation of the box, ascending the
    gradient of the soft objective.
  * :class:`ESTuner` — antithetic evolution strategies on the hard
    model (no smoothing bias, works for the integer-ish knobs gradients
    cannot see).
  * :class:`BOTuner` — Bayesian optimisation: a fixed-hyperparameter
    RBF Gaussian process on the unit box with Thompson-sampling batch
    proposals.

All tuners checkpoint through ``repro_torch.ckpt`` (``ckpt_dir=...``): host
state is float64 numpy and per-iteration randomness is keyed
``default_rng([seed, it])``, so a killed-and-resumed run replays the
exact trajectory of an uninterrupted one (bit-exact, tested).
"""

from __future__ import annotations

import contextlib
import dataclasses
import operator
import os
from typing import Callable

import numpy as np
import torch

from ..core import cc
from ..core.experiments import ScenarioSpec, Sweep
from ..core.fluid import (FluidState, Scenario, _step_body,
                          check_routing_paths, init_state, reduce_plan,
                          resolve_device, scenario_device, step_params)
from ..core.params import CCConfig, CCSpec
from ..core.simulator import TraceSample, _resolve_steps, decimating_scan

from . import objectives

# ---------------------------------------------------------------------------
# the search box
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TunableParam:
    """One bounded knob, named on both sides of ``step_params``.

    ``leaves`` are dotted ``StepParams`` paths (``"mark.cp_kmin"``,
    ``"react.rp_g"``, or a top-level field like ``"xoff"``) — what
    ``ParamBox.apply`` overrides inside a differentiated rollout.
    ``spec_paths`` are the matching dotted config paths
    (``"dcqcn.kmin"``) written by ``to_spec``.  Several paths tune as
    one knob (DCQCN's step marking uses one V for kmin = kmax).
    ``log=True`` searches the decade range geometrically.
    """

    name: str
    leaves: tuple
    spec_paths: tuple
    lo: float
    hi: float
    log: bool = False

    def __post_init__(self):
        if not (0 < self.lo < self.hi) and self.log:
            raise ValueError(f"{self.name}: log scale needs 0 < lo < hi")
        if self.lo >= self.hi:
            raise ValueError(f"{self.name}: empty range [{self.lo}, "
                             f"{self.hi}]")


def _sigmoid(x, xp):
    return 1.0 / (1.0 + xp.exp(-x))


def _replace_many(cfg, updates: dict):
    """All dotted-path writes in one ``dataclasses.replace`` per parent.

    Sequential single-path writes would trip ``__post_init__``
    validation on transient states (e.g. raising kmin above the old
    kmax before kmax is written); batching means validators only ever
    see the final combination.
    """
    direct, nested = {}, {}
    for path, v in updates.items():
        head, _, rest = path.partition(".")
        if rest:
            nested.setdefault(head, {})[rest] = v
        else:
            direct[head] = v
    for head, sub in nested.items():
        direct[head] = _replace_many(getattr(cfg, head), sub)
    return dataclasses.replace(cfg, **direct)


def _get_leaf(par, path: str):
    head, _, rest = path.partition(".")
    v = getattr(par, head)
    return v[rest] if rest else v


def _set_leaf(par, path: str, value):
    """``par`` with one leaf replaced by ``value`` (a 0-d tensor, spread
    over the leaf's runs)."""
    head, _, rest = path.partition(".")
    if rest:
        fam = dict(getattr(par, head))
        if rest not in fam:
            raise KeyError(f"StepParams.{head} has no leaf {rest!r} "
                           f"(have {sorted(fam)})")
        fam[rest] = value.expand_as(fam[rest])
        return par._replace(**{head: fam})
    return par._replace(**{head: value.expand_as(getattr(par, head))})


@dataclasses.dataclass(frozen=True)
class ParamBox:
    """A tuple of :class:`TunableParam` — the tuner's search space.

    Optimisers work in unconstrained theta-space; ``values`` maps theta
    through a sigmoid onto each knob's (lin or log) range, so every
    theta is feasible and bounds never need projection.
    """

    params: tuple

    def __post_init__(self):
        names = [p.name for p in self.params]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate knob names in box: {names}")

    @property
    def d(self) -> int:
        return len(self.params)

    @property
    def names(self) -> tuple:
        return tuple(p.name for p in self.params)

    def signature(self) -> tuple:
        """Hashable identity for executable-cache keys."""
        return tuple((p.name, p.leaves, p.spec_paths, p.lo, p.hi, p.log)
                     for p in self.params)

    def values(self, theta, xp=torch):
        """[d] theta -> [d] physical values (torch in a differentiated
        rollout, np on host — same formulas, so host round-trips match
        the rollout)."""
        def const(vals, dtype):
            if xp is np:
                return np.asarray(vals, dtype)
            return torch.tensor(vals, dtype=dtype, device=theta.device)

        u = _sigmoid(theta, xp)
        lo = const([p.lo for p in self.params], theta.dtype)
        hi = const([p.hi for p in self.params], theta.dtype)
        is_log = const([p.log for p in self.params],
                       bool if xp is np else torch.bool)
        lin = lo + (hi - lo) * u
        geo = xp.exp(xp.log(lo) + (xp.log(hi) - xp.log(lo)) * u)
        return xp.where(is_log, geo, lin)

    def apply(self, par, theta):
        """StepParams with this box's leaves overridden from theta (a
        float32 tensor on the params' device; gradients flow)."""
        vals = self.values(theta.to(torch.float32))
        for tp, v in zip(self.params, vals):
            for leaf in tp.leaves:
                par = _set_leaf(par, leaf, v)     # raises on a bad path
        return par

    def encode(self, cfg: "CCConfig | CCSpec") -> np.ndarray:
        """theta [d] f64 whose values reproduce the config's current
        settings (clipped just inside the box)."""
        spec = cfg.to_spec()
        theta = np.zeros(self.d)
        for i, tp in enumerate(self.params):
            v = float(operator.attrgetter(tp.spec_paths[0])(spec))
            if tp.log:
                u = (np.log(max(v, tp.lo)) - np.log(tp.lo)) \
                    / (np.log(tp.hi) - np.log(tp.lo))
            else:
                u = (v - tp.lo) / (tp.hi - tp.lo)
            u = float(np.clip(u, 1e-4, 1 - 1e-4))
            theta[i] = np.log(u / (1 - u))
        return theta

    def to_spec(self, cfg: "CCConfig | CCSpec", theta) -> CCSpec:
        """The config with this theta's values written back.

        Consistency-checked: the spec is flattened through
        ``step_params`` and every tuned ``StepParams`` leaf must equal
        the value ``apply`` would have used — so what a tuner reports
        is provably what its rollouts ran.
        """
        spec = cfg.to_spec()
        vals = self.values(np.asarray(theta, np.float32), xp=np)
        updates = {path: float(v)
                   for tp, v in zip(self.params, vals)
                   for path in tp.spec_paths}
        spec = _replace_many(spec, updates)
        par = step_params(spec, device="cpu")
        for tp, v in zip(self.params, vals):
            for leaf in tp.leaves:
                got = float(_get_leaf(par, leaf)[0])
                if not np.isclose(got, float(v), rtol=1e-5, atol=0):
                    raise AssertionError(
                        f"box inconsistency: {tp.name}: spec path(s) "
                        f"{tp.spec_paths} produced StepParams leaf "
                        f"{leaf} = {got}, expected {float(v)}")
        return spec


def dcqcn_box() -> ParamBox:
    """The DCQCN knobs the paper's sensitivity analysis walks: the
    marking threshold V (kmin = kmax, step marking), the rate-decrease
    aggressiveness, the alpha gain g and the additive-increase slope."""
    return ParamBox((
        TunableParam("V", ("mark.cp_kmin",),
                     ("dcqcn.kmin", "dcqcn.kmax"), 2e3, 2.56e5, log=True),
        TunableParam("rdf", ("react.rp_rdf",),
                     ("dcqcn.rate_decrease_factor",), 0.05, 1.0),
        TunableParam("g", ("react.rp_g",), ("dcqcn.g",),
                     1.0 / 1024, 0.25, log=True),
        TunableParam("rai", ("react.rp_rai",), ("dcqcn.rai",),
                     1e6, 2e8, log=True),
    ))


def rev_box() -> ParamBox:
    """The paper-scheme (ECP/ENP/ERP) knobs: detection threshold,
    settle fraction, recovery slope and hold-down."""
    return ParamBox((
        TunableParam("thresh", ("mark.ecp_thresh",),
                     ("rev.detect_threshold",), 4e3, 1.28e5, log=True),
        TunableParam("settle", ("react.erp_settle",),
                     ("rev.erp_settle",), 0.5, 1.0),
        TunableParam("rai", ("react.erp_rai",),
                     ("rev.erp_rai",), 1e11, 5e13, log=True),
        TunableParam("hold", ("react.erp_hold",),
                     ("rev.erp_hold",), 5e-6, 5e-4, log=True),
    ))


def box_for(cfg: "CCConfig | CCSpec") -> ParamBox:
    """Default box for a config, keyed on its reaction stage."""
    reaction = cfg.to_spec().reaction
    boxes = {"rp": dcqcn_box, "erp": rev_box}
    if reaction not in boxes:
        raise ValueError(
            f"no default ParamBox for reaction {reaction!r}; pass an "
            f"explicit box= (have defaults for {sorted(boxes)})")
    return boxes[reaction]()


# ---------------------------------------------------------------------------
# the problem + its evaluators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TuneProblem:
    """One tuning instance: which config, on which workload, scored
    how, over which knobs."""

    cfg: "CCConfig | CCSpec"
    scenario: "Scenario | ScenarioSpec"
    objective: "str | dict | Callable" = "default"
    box: ParamBox = None
    n_steps: int = 2000
    trace_every: int = 50
    device: object = None      # None = the card, as every port entry point

    def __post_init__(self):
        if self.box is None:
            self.box = box_for(self.cfg)


class _TraceShim:
    """Host-side stand-in for the stacked TraceSample (objectives only
    read ``.ctrl``)."""

    def __init__(self, ctrl):
        self.ctrl = torch.as_tensor(np.asarray(ctrl, np.float32))


def _host_final(final) -> FluidState:
    """A hard result's numpy final state as CPU tensors (objectives are
    torch functions)."""
    return FluidState(**{
        f: ({k: torch.as_tensor(np.asarray(v)) for k, v in final.cc.items()}
            if f == "cc" else torch.as_tensor(np.asarray(getattr(final, f))))
        for f in FluidState._fields})


def _run0(final: FluidState, trace: TraceSample):
    """Run 0 of a batched rollout: the unbatched views objectives read."""
    return (FluidState(*[x[0] for x in final[:-2]],
                       cc={k: v[0] for k, v in final.cc.items()},
                       t=final.t[0]),
            TraceSample(*[x[:, 0] for x in trace]))


@contextlib.contextmanager
def deterministic(device: torch.device):
    """``torch.use_deterministic_algorithms(True)`` on the card, restored
    after: the backward of the rollout's gathers and indexing (the
    per-run ``torch.gather`` of per-wire values into flows, the delay
    line's reads) accumulates with ``scatter_add_`` / ``index_put_``,
    which are atomic and unordered on CUDA by default.  The mode's fill
    of new tensors is left off: every output the rollout allocates is
    written in full, and the fills were the card's busiest kernel.  A
    no-op on the CPU, where those ops are ordered."""
    if device.type != "cuda":
        yield
        return
    # cuBLAS's products are deterministic only with this workspace
    # setting, which torch checks under the mode; it has to be in place
    # before the process's first product to size the workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch.utils.deterministic as det
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        det.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(prev, warn_only=warn)


class Evaluator:
    """Evaluation paths for one :class:`TuneProblem`, staged once on the
    problem's device."""

    def __init__(self, problem: TuneProblem):
        self.problem = problem
        self.box = problem.box
        cfg = problem.cfg
        self.spec: CCSpec = cfg.to_spec()
        scn = problem.scenario
        if isinstance(scn, ScenarioSpec):
            scn = scn.build(cfg)
        check_routing_paths(cfg, scn)
        self.scn: Scenario = scn
        self.device = resolve_device(problem.device)
        self.n_vcs = int(getattr(cfg.link, "n_vcs", 1))
        self.sd = scenario_device(scn, self.n_vcs, device=self.device)
        self.st0 = init_state(scn, cfg, device=self.device)
        self.par0 = step_params(cfg, device=self.device)
        self.n_samples, self.k = _resolve_steps(
            cfg, problem.n_steps, problem.trace_every)
        self.dt = float(cfg.sim.dt)
        self.n_sw = int(scn.n_switches)
        # the reference's soft path: reduce="fused", dense_rows=0 (the
        # segment sum: the segment_reduce kernel on the card)
        self.plan = reduce_plan(self.sd, n_switches=self.n_sw,
                                n_vcs=self.n_vcs, dense_rows=0, dt=self.dt)
        self.horizon = self.n_samples * self.k * self.dt
        self.ctx = objectives.make_ctx(
            scn, cfg.link.line_rate, self.horizon, self.dt,
            device=self.device)
        self.ctx_host = objectives.make_ctx(
            scn, cfg.link.line_rate, self.horizon, self.dt)
        self.obj_fn, self.obj_sig = objectives.resolve(problem.objective)
        # the one stage of each family this config runs: the rollout
        # evaluates those alone (the others' selected values are unused)
        self.stages = tuple(frozenset({reg.code(name)}) for reg, name in (
            (cc.MARKING, self.spec.marking),
            (cc.NOTIFICATION, self.spec.notification),
            (cc.REACTION, self.spec.reaction)))

    # -- soft path: an eager rollout under autograd -------------------------

    def soft_objective(self, theta: torch.Tensor, temperature: float):
        """The soft objective at ``theta`` (a float32 tensor on the
        device) as a tensor, differentiable in theta.  The box's values,
        and the kernels' parameter rows packed from them, are built here
        from theta, inside the differentiated call."""
        par = self.box.apply(self.par0, theta)
        par = par._replace(temperature=torch.full_like(
            self.par0.temperature, float(np.float32(temperature))))
        packed = cc.pack_react_rows(par.react, par.line_rate, self.plan.dt)

        def step(s):
            return _step_body(s, self.sd, par, self.plan,
                              n_switches=self.n_sw, reduce="fused",
                              n_vcs=self.n_vcs, packed_react=packed,
                              tau=par.temperature, stages=self.stages)

        final, tr = decimating_scan(step, self.st0, self.n_samples, self.k,
                                    self.dt, self.n_vcs)
        return self.obj_fn(*_run0(final, tr), self.ctx)

    def value_and_grad(self, theta, temperature: float):
        """(soft objective, d(objective)/d(theta)) at one theta.

        ``temperature`` is the per-run soft temperature of the rollout
        (the step is the soft one whatever its value); 0.0 evaluates the
        exact hard model, differentiated through its hard branch."""
        with deterministic(self.device):
            th = torch.tensor(np.asarray(theta, np.float32),
                              device=self.device, requires_grad=True)
            val = self.soft_objective(th, temperature)
            (g,) = torch.autograd.grad(val, th)
        return float(val.detach()), g.double().cpu().numpy()

    # -- hard path: populations ride the Sweep engine -----------------------

    def hard_values(self, thetas) -> np.ndarray:
        """[P] exact hard-model objective for a theta batch.

        Each theta becomes a ``CCSpec`` (consistency-checked) and the
        batch runs as ONE ``Sweep`` launch — the population shares the
        sweep executable cache, so repeated generations of the same
        shape capture once.  Values come from the same objective
        function the soft path uses, applied to the hard traces.
        """
        thetas = np.atleast_2d(np.asarray(thetas, np.float64))
        points = [(f"t{i}", self.box.to_spec(self.spec, th), self.scn)
                  for i, th in enumerate(thetas)]
        res = Sweep(points).run(
            n_steps=self.problem.n_steps, trace_every=self.k,
            device=self.device)
        return np.asarray([self.hard_objective(res[i])
                           for i in range(len(thetas))])

    def hard_objective(self, sim_result) -> float:
        """The tuner objective evaluated on a finished hard run (on the
        host's CPU, in float32)."""
        val = self.obj_fn(_host_final(sim_result.final),
                          _TraceShim(sim_result.ctrl), self.ctx_host)
        return float(val)


# ---------------------------------------------------------------------------
# checkpoint plumbing (repro_torch.ckpt; host f64 state, bit-exact resume)
# ---------------------------------------------------------------------------


def _ckpt_save(ckpt_dir, it, state: dict):
    from ..ckpt import save_checkpoint
    save_checkpoint(ckpt_dir, it, state, extra={"it": it})


def _ckpt_load(ckpt_dir):
    """(state, it) from the latest committed checkpoint, or (None, 0)."""
    from ..ckpt import latest_step, load_checkpoint
    if ckpt_dir is None or latest_step(ckpt_dir) is None:
        return None, 0
    tree, extra = load_checkpoint(ckpt_dir)
    return tree, int(extra["it"])


@dataclasses.dataclass
class TuneTrace:
    """Everything a tuner evaluated: [n, d] thetas, [n] objective
    values (soft for :class:`GradTuner`, hard for ES/BO) and metadata.
    ``best`` is the argmax theta — candidates for the *decision* should
    still be re-scored on the hard model (``pareto.autotune`` does)."""

    theta: np.ndarray
    value: np.ndarray
    meta: dict

    @property
    def best(self) -> np.ndarray:
        return self.theta[int(np.argmax(self.value))]


# ---------------------------------------------------------------------------
# tuners
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GradTuner:
    """Adam ascent on the temperature-smoothed objective.

    The gradient flows through the full dt-scan (soft gates, see
    ``repro_torch.tune.soft``); Adam is inlined (bias-corrected, standard
    constants) so the tuner has no optimiser dependency.  ``anneal``
    decays the temperature geometrically to ``temperature_final`` over
    the run — late iterations score an almost-hard model.
    """

    iters: int = 40
    lr: float = 0.15
    temperature: float = 0.06
    temperature_final: float = None     # None = constant temperature
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    def _tau(self, it: int) -> float:
        if self.temperature_final is None or self.iters <= 1:
            return self.temperature
        frac = it / (self.iters - 1)
        return float(self.temperature
                     * (self.temperature_final / self.temperature) ** frac)

    def run(self, problem: TuneProblem, *, theta0=None, seed: int = 0,
            ckpt_dir: str = None, ckpt_every: int = 0) -> TuneTrace:
        ev = problem if isinstance(problem, Evaluator) else \
            Evaluator(problem)
        d = ev.box.d
        theta = np.asarray(theta0, np.float64) if theta0 is not None \
            else ev.box.encode(ev.spec)
        m, v = np.zeros(d), np.zeros(d)
        hist_t, hist_v = [], []
        state, start = _ckpt_load(ckpt_dir)
        if state is not None:
            theta, m, v = (np.asarray(state[k])
                           for k in ("theta", "m", "v"))
            hist_t = list(np.asarray(state["hist_t"]))
            hist_v = list(np.asarray(state["hist_v"]))
        for it in range(start, self.iters):
            val, g = ev.value_and_grad(theta, self._tau(it))
            hist_t.append(theta.copy())
            hist_v.append(val)
            m = self.beta1 * m + (1 - self.beta1) * g
            v = self.beta2 * v + (1 - self.beta2) * g * g
            mh = m / (1 - self.beta1 ** (it + 1))
            vh = v / (1 - self.beta2 ** (it + 1))
            theta = theta + self.lr * mh / (np.sqrt(vh) + self.eps)
            if ckpt_dir and ckpt_every and (it + 1) % ckpt_every == 0:
                _ckpt_save(ckpt_dir, it + 1, {
                    "theta": theta, "m": m, "v": v,
                    "hist_t": np.asarray(hist_t),
                    "hist_v": np.asarray(hist_v)})
        # score the final iterate so the trajectory includes it
        val, _ = ev.value_and_grad(theta, self._tau(self.iters - 1))
        hist_t.append(theta.copy())
        hist_v.append(val)
        return TuneTrace(np.asarray(hist_t), np.asarray(hist_v),
                         {"method": "grad", "iters": self.iters,
                          "temperature": self.temperature})


@dataclasses.dataclass
class ESTuner:
    """Antithetic evolution strategies on the exact hard model.

    Each generation draws ``pop/2`` Gaussian directions, scores the
    +/- pair batch as ONE sweep launch, and ascends the score-weighted
    direction average (normalised by the generation's value spread).
    Per-generation randomness is keyed ``default_rng([seed, it])`` so a
    checkpoint resume replays the identical trajectory.
    """

    iters: int = 20
    pop: int = 16
    sigma: float = 0.25
    lr: float = 0.3

    def run(self, problem: TuneProblem, *, theta0=None, seed: int = 0,
            ckpt_dir: str = None, ckpt_every: int = 0) -> TuneTrace:
        if self.pop % 2:
            raise ValueError("ESTuner.pop must be even (antithetic)")
        ev = problem if isinstance(problem, Evaluator) else \
            Evaluator(problem)
        d = ev.box.d
        half = self.pop // 2
        theta = np.asarray(theta0, np.float64) if theta0 is not None \
            else ev.box.encode(ev.spec)
        hist_t, hist_v = [], []
        state, start = _ckpt_load(ckpt_dir)
        if state is not None:
            theta = np.asarray(state["theta"])
            hist_t = list(np.asarray(state["hist_t"]))
            hist_v = list(np.asarray(state["hist_v"]))
        for it in range(start, self.iters):
            rng = np.random.default_rng([seed, it])
            eps = rng.standard_normal((half, d))
            cand = np.concatenate(
                [theta + self.sigma * eps, theta - self.sigma * eps])
            vals = ev.hard_values(cand)
            hist_t.extend(cand)
            hist_v.extend(vals)
            adv = vals[:half] - vals[half:]
            scale = max(float(vals.std()), 1e-9)
            g = (adv[:, None] * eps).sum(0) / (self.pop * self.sigma
                                               * scale)
            theta = theta + self.lr * g
            if ckpt_dir and ckpt_every and (it + 1) % ckpt_every == 0:
                _ckpt_save(ckpt_dir, it + 1, {
                    "theta": theta,
                    "hist_t": np.asarray(hist_t),
                    "hist_v": np.asarray(hist_v)})
        final_val = ev.hard_values(theta[None])[0]
        hist_t.append(theta.copy())
        hist_v.append(final_val)
        return TuneTrace(np.asarray(hist_t), np.asarray(hist_v),
                         {"method": "es", "iters": self.iters,
                          "pop": self.pop, "sigma": self.sigma})


def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / ls ** 2)


@dataclasses.dataclass
class BOTuner:
    """Thompson-sampling Bayesian optimisation on the unit box.

    A fixed-hyperparameter RBF GP (lengthscale on the [0, 1]^d encoded
    box, values standardised per fit) is cheap, dependency-free and
    deterministic; each iteration draws ``q`` joint posterior samples
    at ``cand`` uniform candidates and evaluates the batch of argmaxes
    as one sweep launch.  Exploration comes from posterior variance,
    not a tuned acquisition.
    """

    iters: int = 12
    init: int = 6
    q: int = 2
    cand: int = 256
    lengthscale: float = 0.35
    noise: float = 1e-4

    @staticmethod
    def _logit(u: np.ndarray) -> np.ndarray:
        u = np.clip(u, 1e-4, 1 - 1e-4)
        return np.log(u / (1 - u))

    def _propose(self, X, y, rng) -> np.ndarray:
        """[<=q, d] unit-box batch from joint Thompson samples."""
        C = rng.uniform(size=(self.cand, X.shape[1]))
        mu, sd = y.mean(), max(float(y.std()), 1e-9)
        ys = (y - mu) / sd
        K = _rbf(X, X, self.lengthscale) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, ys))
        Kc = _rbf(C, X, self.lengthscale)
        mean = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)
        cov = _rbf(C, C, self.lengthscale) - v.T @ v
        Lc = np.linalg.cholesky(cov + 1e-8 * np.eye(self.cand))
        z = rng.standard_normal((self.cand, self.q))
        picks = np.unique(np.argmax(mean[:, None] + Lc @ z, axis=0))
        return C[picks]

    def run(self, problem: TuneProblem, *, theta0=None, seed: int = 0,
            ckpt_dir: str = None, ckpt_every: int = 0) -> TuneTrace:
        ev = problem if isinstance(problem, Evaluator) else \
            Evaluator(problem)
        d = ev.box.d
        state, start = _ckpt_load(ckpt_dir)
        if state is not None:
            X = np.asarray(state["X"])
            y = np.asarray(state["y"])
        else:
            rng = np.random.default_rng([seed, 0])
            u0 = _sigmoid(np.asarray(
                theta0 if theta0 is not None else ev.box.encode(ev.spec),
                np.float64), np)
            X = np.concatenate(
                [u0[None], rng.uniform(size=(max(self.init - 1, 0), d))])
            y = ev.hard_values(self._logit(X))
        for it in range(start + 1, self.iters + 1):
            rng = np.random.default_rng([seed, it])
            U = self._propose(X, y, rng)
            vals = ev.hard_values(self._logit(U))
            X = np.concatenate([X, U])
            y = np.concatenate([y, vals])
            if ckpt_dir and ckpt_every and it % ckpt_every == 0:
                _ckpt_save(ckpt_dir, it, {"X": X, "y": y})
        return TuneTrace(self._logit(X), y,
                         {"method": "bo", "iters": self.iters,
                          "q": self.q, "cand": self.cand})


TUNERS = {"grad": GradTuner, "es": ESTuner, "bo": BOTuner}
