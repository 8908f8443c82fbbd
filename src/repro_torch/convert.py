"""Carry state between the reference's arrays and the port's tensors.

The port never sees a JAX array: a caller turns the reference's
NamedTuples into numpy (``jax.tree.map(np.asarray, x)`` or
``jax.device_get``) and hands them here.  Every converter takes the
reference's field names and nesting (``StepParams.mark``/``notif``/
``react`` and ``FluidState.cc`` are dicts) and batched ``[R, ...]``
arrays, as the reference's ``Sweep`` stages them.  ``device=None`` is
the card, as everywhere in the port; pass ``device="cpu"`` for the CPU.

  * ``scenario_from_numpy``   -> ``repro_torch.core.fluid.Scenario``
  * ``scenario_dev_from_numpy`` -> ``ScenarioDev`` (integers as int64)
  * ``step_params_from_numpy`` -> ``StepParams``
  * ``state_from_numpy``      -> ``FluidState``
  * ``state_to_numpy``        -> ``FluidState`` of numpy arrays, with the
    reference's dtypes (float32, and int32 for the integer fields)
  * ``params_from_numpy``     -> the transformer's param tree (the
    reference's stacked ``groups/p{j}`` leaves unstacked into the port's
    flat ``layers`` list)
  * ``caches_from_numpy`` / ``caches_to_numpy`` -> the per-layer caches
    (``KVCache``, ``SSMState``, ``RGLRUState``) and back to the
    reference's nesting
"""

from __future__ import annotations

import numpy as np
import torch

from .core.fluid import (FluidState, Scenario, ScenarioDev, StepParams,
                         resolve_device)

_STATE_INT = ("bc_stage", "t_stage", "path_idx", "t")
_PARAM_INT = ("mark_code", "notif_code", "react_code", "route_code")


def _get(x, field):
    return x[field] if isinstance(x, dict) else getattr(x, field)


def _tensor(a, dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                        dtype=dtype)


def _num_dtype(a) -> torch.dtype:
    return torch.int32 if np.issubdtype(np.asarray(a).dtype, np.integer) \
        else torch.float32


def scenario_from_numpy(scn) -> Scenario:
    """The reference's host ``Scenario`` (numpy fields) as the port's."""
    return Scenario(**{f: _get(scn, f) for f in Scenario._fields})


def scenario_dev_from_numpy(sd, device=None) -> ScenarioDev:
    device = resolve_device(device)
    out = {}
    for f in ScenarioDev._fields:
        a = _get(sd, f)
        dt = torch.float32 if np.issubdtype(np.asarray(a).dtype,
                                            np.floating) else torch.int64
        out[f] = _tensor(a, dt, device)
    return ScenarioDev(**out)


def step_params_from_numpy(par, device=None) -> StepParams:
    device = resolve_device(device)
    out = {}
    for f in StepParams._fields:
        a = _get(par, f)
        if f in ("mark", "notif", "react"):
            out[f] = {k: _tensor(v, _num_dtype(v), device)
                      for k, v in a.items()}
        else:
            out[f] = _tensor(a, torch.int32 if f in _PARAM_INT
                             else torch.float32, device)
    return StepParams(**out)


def state_from_numpy(st, device=None) -> FluidState:
    device = resolve_device(device)
    out = {}
    for f in FluidState._fields:
        a = _get(st, f)
        if f == "cc":
            out[f] = {k: _tensor(v, torch.float32, device)
                      for k, v in a.items()}
        else:
            out[f] = _tensor(a, torch.int32 if f in _STATE_INT
                             else torch.float32, device)
    return FluidState(**out)


def _np(x: torch.Tensor, f: str) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a.astype(np.int32) if f in _STATE_INT else a


def state_to_numpy(st: FluidState) -> FluidState:
    """A port ``FluidState`` as numpy arrays (reference dtypes)."""
    return FluidState(**{
        f: ({k: _np(v, k) for k, v in st.cc.items()} if f == "cc"
            else _np(getattr(st, f), f))
        for f in FluidState._fields})


# ---------------------------------------------------------------------------
# transformer params and KV caches
# ---------------------------------------------------------------------------

def _leaf(a, device) -> torch.Tensor:
    """A numpy leaf (bfloat16 arrays as ml_dtypes give them too) as a
    tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def _flat_layers(cfg, head, groups, tail, take):
    """head + every group's pattern in turn + tail, the port's order;
    ``take(leaf_tree, i)`` cuts layer i out of a stacked group."""
    from .models.transformer import layer_plan
    _, pat, n_groups, _ = layer_plan(cfg)
    out = list(head)
    for i in range(n_groups):
        out += [take(groups[f"p{j}"], i) for j in range(len(pat))]
    return out + list(tail)


def params_from_numpy(cfg, tree, device=None) -> dict:
    """The reference's param tree (numpy leaves) as the port's: each
    ``groups/p{j}`` leaf is unstacked along its leading ``layers`` axis
    into the flat layer list."""
    from .models.transformer import check_ported
    check_ported(cfg)
    device = resolve_device(device)
    conv = lambda a: _leaf(a, device)  # noqa: E731
    layers = _flat_layers(
        cfg, tree.get("head_blocks", []), tree.get("groups", {}),
        tree.get("tail_blocks", []),
        lambda g, i: _tree(g, lambda a: np.asarray(a)[i]))
    return {"embed": _tree(tree["embed"], conv),
            "layers": [_tree(b, conv) for b in layers],
            "final_norm": _tree(tree["final_norm"], conv),
            "logits": _tree(tree.get("logits", {}), conv)}


def _cache_types(cfg) -> list:
    """Each layer's cache type, in the port's layer order."""
    from .models.attention import KVCache
    from .models.rglru import RGLRUState
    from .models.ssm import SSMState
    from .models.transformer import layer_kinds
    by_kind = {"ssm": SSMState, "rec": RGLRUState}
    return [by_kind.get(k, KVCache) for k in layer_kinds(cfg)]


def caches_from_numpy(cfg, tree, device=None) -> list:
    """The reference's caches (``{"head": [...], "groups": {"p{j}":
    stacked}, "tail": [...]}`` of ``KVCache`` / ``SSMState`` /
    ``RGLRUState`` with numpy leaves) as the port's per-layer list; a
    ``KVCache``'s ``pos`` becomes a [] int32 tensor."""
    device = resolve_device(device)

    def fields(c):
        names = c.keys() if isinstance(c, dict) else c._fields
        return {f: np.asarray(_get(c, f)) for f in names}

    layers = _flat_layers(
        cfg, [fields(c) for c in tree.get("head", [])],
        tree.get("groups", {}), [fields(c) for c in tree.get("tail", [])],
        lambda c, i: {f: a.reshape(-1)[i] if f == "pos" else a[i]
                      for f, a in fields(c).items()})
    out = []
    for cls, c in zip(_cache_types(cfg), layers):
        leaves = {f: _leaf(np.asarray(c[f], np.int32) if f == "pos"
                           else c[f], device) for f in cls._fields}
        out.append(cls(**leaves))
    return out


def caches_to_numpy(cfg, caches) -> dict:
    """The port's per-layer caches in the reference's nesting, numpy
    leaves (float32 state, ``pos`` int32); a stacked group stacks every
    leaf along a leading layers axis."""
    from .models.transformer import layer_plan
    head, pat, n_groups, tail = layer_plan(cfg)

    def one(c):
        return type(c)(**{
            f: (np.asarray(x.cpu().numpy(), np.int32) if f == "pos"
                else x.detach().float().cpu().numpy())
            for f, x in zip(c._fields, c)})

    flat = [one(c) for c in caches]
    out = {"head": flat[:len(head)]}
    body = flat[len(head):len(head) + n_groups * len(pat)]
    if n_groups:
        out["groups"] = {}
        for j in range(len(pat)):
            group = body[j::len(pat)]
            out["groups"][f"p{j}"] = type(group[0])(*(
                np.stack(leaves) for leaves in zip(*group)))
    out["tail"] = flat[len(head) + n_groups * len(pat):]
    return out
