"""Wire-format (JSON) round-trips for configs, scenarios and results
(port of ``repro.core.serialize``).

The what-if query service returns simulation results over the wire, so
``SimResult`` / ``SweepResult`` need a stable, numpy-free dict form:

  * every scalar is a plain python ``int`` / ``float`` / ``bool`` /
    ``str`` — ``json.dumps`` works without custom encoders (python's
    ``json`` emits ``Infinity`` for the window-mode ``t_stop = inf``
    sentinels and parses it back; the round-trip is exact);
  * arrays are tagged dicts ``{"__ndarray__": dtype, "shape": [...],
    "data": [flat scalars]}`` — float32 values pass through python
    floats (float64) losslessly, so ``from_dict(to_dict(x))`` is
    *bit-exact*, not approximate;
  * configs carry a ``__class__`` tag (``CCConfig`` vs ``CCSpec``) and
    spell enums by name, so a round-tripped config reconstructs the
    identical frozen dataclass (hash-equal, jit-cache-equal).

Traces dominate the payload; ``simresult_to_dict(..., traces=False)``
drops them (final state + metadata only) and ``decimate=k`` thins them
by a further factor k for dashboard-weight responses — both are lossy
by construction and refuse to ``from_dict`` back into a full result.

The format is the reference's, field for field, so a blob either package
wrote loads in the other to the same arrays.  The port's results hold
numpy on the host already; a tensor handed to an encoder is copied to
the host first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fluid import FluidState, Scenario
from .params import (CCConfig, CCScheme, CCSpec, DCQCNParams, FNCCParams,
                     LinkParams, RevParams, SimParams, SwiftParams)

# ---------------------------------------------------------------------------
# arrays and scalars
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def encode_array(a: np.ndarray) -> dict:
    a = _host(a)
    return {"__ndarray__": a.dtype.name, "shape": list(a.shape),
            "data": a.ravel().tolist()}


def decode_array(d: dict) -> np.ndarray:
    return np.asarray(d["data"], dtype=d["__ndarray__"]).reshape(
        d["shape"])


def _enc(x):
    """Array -> tagged dict; numpy scalar -> python scalar; rest as-is."""
    if isinstance(x, (np.ndarray, torch.Tensor)) or hasattr(x, "__array__"):
        a = _host(x)
        return a.item() if a.ndim == 0 else encode_array(a)
    if isinstance(x, (np.generic,)):
        return x.item()
    return x


def _dec(x):
    if isinstance(x, dict) and "__ndarray__" in x:
        return decode_array(x)
    return x


# ---------------------------------------------------------------------------
# configs (CCConfig / CCSpec and their frozen param dataclasses)
# ---------------------------------------------------------------------------

_PARAM_FIELDS = {"link": LinkParams, "dcqcn": DCQCNParams,
                 "rev": RevParams, "fncc": FNCCParams,
                 "swift": SwiftParams, "sim": SimParams}


def config_to_dict(cfg: "CCConfig | CCSpec") -> dict:
    out = {"__class__": type(cfg).__name__}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in _PARAM_FIELDS:
            out[f.name] = dataclasses.asdict(v)
        elif isinstance(v, CCScheme):
            out[f.name] = v.name
        else:
            out[f.name] = v
    return out


def config_from_dict(d: dict) -> "CCConfig | CCSpec":
    cls = {"CCConfig": CCConfig, "CCSpec": CCSpec}[d["__class__"]]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _PARAM_FIELDS:
            v = _PARAM_FIELDS[f.name](**v)
        elif f.name == "scheme":
            v = CCScheme[v]
        kw[f.name] = v
    return cls(**kw)


# ---------------------------------------------------------------------------
# scenario + final state
# ---------------------------------------------------------------------------


def scenario_to_dict(scn: Scenario) -> dict:
    out = {"__class__": "Scenario"}
    for name, v in scn._asdict().items():
        out[name] = None if v is None else _enc(v)
    return out


def scenario_from_dict(d: dict) -> Scenario:
    kw = {}
    for name in Scenario._fields:
        v = d.get(name)
        kw[name] = None if v is None else _dec(v)
    kw["n_switches"] = int(kw["n_switches"])
    # host-side scalar buffers stay scalars (shape [] arrays decode to
    # python floats via _enc's .item() on the way out)
    return Scenario(**kw)


def state_to_dict(st: FluidState) -> dict:
    # always the tagged-array form (even for the 0-d ``t`` counter), so
    # dtypes survive the round trip exactly
    out = {"__class__": "FluidState"}
    for name, v in st._asdict().items():
        if name == "cc":
            out[name] = {k: encode_array(a) for k, a in v.items()}
        else:
            out[name] = encode_array(v)
    return out


def state_from_dict(d: dict) -> FluidState:
    kw = {}
    for name in FluidState._fields:
        v = d[name]
        if name == "cc":
            kw[name] = {k: _dec(a) for k, a in v.items()}
        else:
            kw[name] = np.asarray(_dec(v))
    return FluidState(**kw)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

_SIM_TRACE_FIELDS = ("delivered", "rate", "inst_thr", "max_q",
                     "n_paused", "marked", "cnp", "n_nonmin", "ctrl",
                     "pause_time", "vc_stall")

#: Trace fields added after the wire format shipped: absent from old
#: blobs, decoded as None (SimResult treats None as "predates the
#: counter") instead of failing the whole reconstruction.
_OPTIONAL_TRACE_FIELDS = ("pause_time", "vc_stall")


def simresult_to_dict(res, *, traces: bool = True,
                      decimate: int = 1) -> dict:
    """``SimResult`` -> JSON-ready dict (see module docstring).

    ``traces=False`` omits the trace arrays (and ``times``);
    ``decimate=k`` keeps every k-th sample.  Either makes the dict
    lossy: ``simresult_from_dict`` only accepts the full form.
    """
    out = {"__class__": "SimResult",
           "cfg": config_to_dict(res.cfg),
           "scn": scenario_to_dict(res.scn),
           "trace_every": int(res.trace_every),
           "traces": bool(traces) and decimate == 1,
           "final": state_to_dict(res.final)}
    if traces:
        k = max(1, int(decimate))
        out["times"] = encode_array(np.asarray(res.times)[k - 1::k])
        for f in _SIM_TRACE_FIELDS:
            v = getattr(res, f)
            if v is None:                 # result predates the counter
                continue
            out[f] = encode_array(np.asarray(v)[k - 1::k])
        if k > 1:
            out["trace_every"] = int(res.trace_every) * k
    return out


def simresult_from_dict(d: dict):
    from .simulator import SimResult
    if not d.get("traces"):
        raise ValueError(
            "cannot reconstruct a SimResult from a trace-less (or "
            "re-decimated) dict; serialise with traces=True, decimate=1")
    return SimResult(
        cfg=config_from_dict(d["cfg"]),
        scn=scenario_from_dict(d["scn"]),
        times=decode_array(d["times"]),
        final=state_from_dict(d["final"]),
        trace_every=int(d["trace_every"]),
        **{f: decode_array(d[f]) if f in d else None
           for f in _SIM_TRACE_FIELDS})


def sweepresult_to_dict(res, *, traces: bool = True) -> dict:
    """``SweepResult`` -> JSON-ready dict.

    Point order is the wire contract (names key the per-point views);
    the batched trace pytree serialises field-wise with its [R, T, ...]
    layout intact, so ``sweepresult_from_dict`` rebuilds a result whose
    per-point ``SimResult`` views are bit-identical to the original's.
    """
    from .experiments import SweepPoint  # noqa: F401  (doc pointer)
    out = {"__class__": "SweepResult",
           "trace_every": int(res.trace_every),
           "traces": bool(traces),
           "times": encode_array(np.asarray(res.times)),
           "points": [{"name": p.name, "cfg": config_to_dict(p.cfg),
                       "scenario": scenario_to_dict(p.scenario)}
                      for p in res.points],
           "final": state_to_dict(res.final)}
    if traces:
        out["trace_fields"] = {
            f: encode_array(np.asarray(getattr(res.traces, f)))
            for f in _SIM_TRACE_FIELDS
            if getattr(res.traces, f, None) is not None}
    return out


def sweepresult_from_dict(d: dict):
    from .experiments import SweepPoint, SweepResult
    from .simulator import TraceSample
    if not d.get("traces"):
        raise ValueError(
            "cannot reconstruct a SweepResult from a trace-less dict; "
            "serialise with traces=True")
    points = [SweepPoint(name=p["name"], cfg=config_from_dict(p["cfg"]),
                         scenario=scenario_from_dict(p["scenario"]))
              for p in d["points"]]
    tf = {f: decode_array(d["trace_fields"][f])
          if f in d["trace_fields"] else None
          for f in _SIM_TRACE_FIELDS}
    missing = [f for f, v in tf.items() if v is None
               and f not in _OPTIONAL_TRACE_FIELDS]
    if missing:
        raise KeyError(f"trace_fields missing {missing}")
    return SweepResult(points=points,
                       times=decode_array(d["times"]),
                       traces=TraceSample(**tf),
                       final=state_from_dict(d["final"]),
                       trace_every=int(d["trace_every"]))


# ---------------------------------------------------------------------------
# shard-level merge (the fleet coordinator's result assembly)
# ---------------------------------------------------------------------------


def merge_sweepresults(parts, points=None):
    """Concatenate shard-level ``SweepResult``s back into one grid result.

    ``parts`` are per-shard results over disjoint point subsets of one
    grid (all sharing the shape envelope, times and ``trace_every`` —
    the fleet planner pins those, so the arrays concatenate along the
    run axis without reshaping).  ``points`` optionally supplies the
    authoritative ``SweepPoint`` list: the merged run axis follows its
    order, and its (typically unpadded) scenarios replace the shards'
    padded copies so per-point views trim exactly like the one-launch
    reference.  Every name in ``points`` must be covered by exactly one
    shard; with ``points=None`` the merge keeps concatenation order.

    Purely a gather — every run's row is copied bit-for-bit from the
    shard that computed it, so a merge of bitwise-correct shards is
    bitwise the uninterrupted ``Sweep.run``.
    """
    from .experiments import SweepResult
    from .simulator import TraceSample

    parts = list(parts)
    if not parts:
        raise ValueError("merge_sweepresults: no shard results")
    base = parts[0]
    for p in parts[1:]:
        if int(p.trace_every) != int(base.trace_every) or \
                not np.array_equal(np.asarray(p.times),
                                   np.asarray(base.times)):
            raise ValueError(
                "shard results disagree on times/trace_every; they are "
                "not shards of one plan")
    where: dict[str, tuple] = {}
    for part in parts:
        for r, pt in enumerate(part.points):
            if pt.name in where:
                raise ValueError(f"point {pt.name!r} in two shards")
            where[pt.name] = (part, r)
    if points is None:
        order = [(pt.name, part, r) for part in parts
                 for r, pt in enumerate(part.points)]
        out_points = [part.points[r] for _, part, r in order]
    else:
        missing = [p.name for p in points if p.name not in where]
        if missing:
            raise ValueError(f"no shard produced points {missing}")
        order = [(p.name, *where[p.name]) for p in points]
        out_points = list(points)
    tf = {}
    for f in _SIM_TRACE_FIELDS:
        vals = [getattr(part.traces, f, None) for part in parts]
        if any(v is None for v in vals):
            if not all(v is None for v in vals):
                raise ValueError(f"trace field {f!r} present in some "
                                 f"shards but not others")
            tf[f] = None
            continue
        tf[f] = np.stack([np.asarray(getattr(part.traces, f))[r]
                          for _, part, r in order])
    final = FluidState(**{
        f: ({k: np.stack([np.asarray(part.final.cc[k])[r]
                          for _, part, r in order])
             for k in base.final.cc} if f == "cc" else
            np.stack([np.asarray(getattr(part.final, f))[r]
                      for _, part, r in order]))
        for f in FluidState._fields})
    return SweepResult(points=out_points,
                       times=np.asarray(base.times),
                       traces=TraceSample(**tf),
                       final=final,
                       trace_every=int(base.trace_every))
