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
  * ``params_from_numpy``     -> a model's param tree: the transformer's
    (the reference's stacked ``groups/p{j}`` leaves unstacked into the
    port's flat ``layers`` list), the VLM's (that trunk plus its
    ``projector``) or the encoder-decoder's (stacked ``enc`` / ``dec``
    unstacked into lists)
  * ``caches_from_numpy`` / ``caches_to_numpy`` -> the per-layer caches
    (``KVCache``, ``SSMState``, ``RGLRUState``) and back to the
    reference's nesting (the encoder-decoder's: one ``KVCache`` stacked
    over the decoder layers, ``pos`` [n_layers])
  * ``train_state_from_numpy`` -> ``repro_torch.train.TrainState``: the
    params, moments, master copy and EF residual each through
    ``params_from_numpy``, the step a [] int32, the PRNG key uint32[2]
    on the CPU
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


#: the top-level keys of the reference's param trees, by model
_TRUNK_KEYS = {"embed", "head_blocks", "groups", "tail_blocks",
               "final_norm", "logits"}
_ENCDEC_KEYS = {"enc_pos", "enc", "enc_norm", "embed", "dec_pos", "dec",
                "final_norm", "logits"}


def _unstack(tree, n: int, conv) -> list:
    """A tree of leaves stacked on a leading ``layers`` axis of ``n`` as
    ``n`` trees of converted leaves."""
    return [_tree(tree, lambda a: conv(np.asarray(a)[i])) for i in range(n)]


def params_from_numpy(cfg, tree, device=None) -> dict:
    """The reference's param tree (numpy leaves) as the port's.  A
    decoder-only trunk: each ``groups/p{j}`` leaf is unstacked along its
    leading ``layers`` axis into the flat layer list; a VLM adds its
    ``projector``; an encoder-decoder unstacks ``enc`` and ``dec`` into
    lists.  Raises ``KeyError`` on a top-level key the model does not
    have."""
    from .models.transformer import check_ported
    check_ported(cfg)
    device = resolve_device(device)
    conv = lambda a: _leaf(a, device)  # noqa: E731
    known = (_ENCDEC_KEYS if cfg.encdec is not None else
             _TRUNK_KEYS | ({"projector"} if cfg.vlm is not None else set()))
    unknown = sorted(set(tree) - known)
    if unknown:
        raise KeyError(f"params_from_numpy: {cfg.name} has no param "
                       f"{unknown}")
    if cfg.encdec is not None:
        out = {k: _tree(tree[k], conv) for k in tree
               if k not in ("enc", "dec")}
        out["enc"] = _unstack(tree["enc"], cfg.encdec.n_enc_layers, conv)
        out["dec"] = _unstack(tree["dec"], cfg.n_layers, conv)
        return out
    layers = _flat_layers(
        cfg, tree.get("head_blocks", []), tree.get("groups", {}),
        tree.get("tail_blocks", []),
        lambda g, i: _tree(g, lambda a: np.asarray(a)[i]))
    out = {"embed": _tree(tree["embed"], conv),
           "layers": [_tree(b, conv) for b in layers],
           "final_norm": _tree(tree["final_norm"], conv),
           "logits": _tree(tree.get("logits", {}), conv)}
    if "projector" in tree:
        out["projector"] = _tree(tree["projector"], conv)
    return out


def _cache_types(cfg) -> list:
    """Each layer's cache type, in the port's layer order."""
    from .models.attention import KVCache
    from .models.rglru import RGLRUState
    from .models.ssm import SSMState
    from .models.transformer import layer_kinds
    by_kind = {"ssm": SSMState, "rec": RGLRUState}
    return [by_kind.get(k, KVCache) for k in layer_kinds(cfg)]


def _fields(c) -> dict:
    names = c.keys() if isinstance(c, dict) else c._fields
    return {f: np.asarray(_get(c, f)) for f in names}


def _pos_leaf(a, device) -> torch.Tensor:
    return _leaf(np.asarray(a, np.int32), device)


def caches_from_numpy(cfg, tree, device=None) -> list:
    """The reference's caches (``{"head": [...], "groups": {"p{j}":
    stacked}, "tail": [...]}`` of ``KVCache`` / ``SSMState`` /
    ``RGLRUState`` with numpy leaves; an encoder-decoder's one
    ``KVCache`` stacked over the decoder layers) as the port's per-layer
    list; a ``KVCache``'s ``pos`` becomes a [] int32 tensor (each
    layer's own, from the stacked ``pos`` [n_layers])."""
    from .models.attention import KVCache
    device = resolve_device(device)
    if cfg.encdec is not None:
        c = _fields(tree)
        return [KVCache(k=_leaf(c["k"][i], device), v=_leaf(c["v"][i], device),
                        pos=_pos_leaf(c["pos"][i], device))
                for i in range(cfg.n_layers)]

    layers = _flat_layers(
        cfg, [_fields(c) for c in tree.get("head", [])],
        tree.get("groups", {}), [_fields(c) for c in tree.get("tail", [])],
        lambda c, i: {f: a.reshape(-1)[i] if f == "pos" else a[i]
                      for f, a in _fields(c).items()})
    out = []
    for cls, c in zip(_cache_types(cfg), layers):
        leaves = {f: _pos_leaf(c[f], device) if f == "pos"
                  else _leaf(c[f], device) for f in cls._fields}
        out.append(cls(**leaves))
    return out


def caches_to_numpy(cfg, caches):
    """The port's per-layer caches in the reference's nesting, numpy
    leaves (float32 state, ``pos`` int32); a stacked group (and an
    encoder-decoder's decoder) stacks every leaf along a leading layers
    axis."""
    from .models.transformer import layer_plan

    def one(c):
        return type(c)(**{
            f: (np.asarray(x.cpu().numpy(), np.int32) if f == "pos"
                else x.detach().float().cpu().numpy())
            for f, x in zip(c._fields, c)})

    flat = [one(c) for c in caches]
    if cfg.encdec is not None:
        return type(flat[0])(*(np.stack(leaves) for leaves in zip(*flat)))
    head, pat, n_groups, tail = layer_plan(cfg)
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


def train_state_from_numpy(cfg, state, device=None):
    """The reference's ``TrainState`` (numpy leaves; its ``opt`` an
    ``OptState``, ``ef`` an ``EFState`` or None) as the port's."""
    from .optim import EFState, OptState
    from .train import TrainState
    device = resolve_device(device)
    opt, ef = _get(state, "opt"), _get(state, "ef")

    def tree(t):
        return None if t is None else params_from_numpy(cfg, t, device)

    return TrainState(
        params=tree(_get(state, "params")),
        opt=OptState(step=_leaf(np.asarray(_get(opt, "step"), np.int32),
                                device),
                     mu=tree(_get(opt, "mu")), nu=tree(_get(opt, "nu")),
                     master=tree(_get(opt, "master"))),
        ef=None if ef is None else EFState(
            residual=tree(_get(ef, "residual"))),
        rng=torch.from_numpy(np.asarray(_get(state, "rng"), np.uint32)
                             .copy()))
