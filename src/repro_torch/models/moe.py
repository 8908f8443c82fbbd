"""Mixture-of-Experts block: top-k routing with capacity-based dispatch
(port of ``repro.models.moe``).

Tokens route within their own sequence (group = batch row) into
``capacity_of(cfg, t)`` slots an expert, by token position: the first
tokens to claim an expert keep its slots, later ones are dropped.  Two
dispatch paths with the same drops, as in the reference:

  * one-hot (``moe_impl="onehot"``, deepseek-moe): capacity slots from an
    exclusive cumsum, ``[b, t, experts, capacity]`` dispatch and combine
    tensors accumulated over the k choices, and einsums;
  * sort (``moe_impl="sort"``, mixtral): the (token, choice) pairs
    sorted stably by expert, a pair's slot its rank in its expert's run;
    tokens gathered into ``[b, e, c, d]`` and the outputs gathered back.
    Where the reference scatter-adds each pair's output into its token
    (``.at[stok].add``), the port gathers each token's k outputs and sums
    them in ascending expert order, the order of the reference's
    updates: no atomics, so a serve is bitwise repeatable on the card.

Routing is ``jax.lax.top_k``'s: the k largest router probabilities, a
tie to the lower expert index (a stable descending sort gives that).
``cfg.moe_tokens`` and the ``shard`` calls (the reference's, the
identity outside a mesh: ``repro_torch.dist.sharding.shard``) place
tokens and expert slots on a mesh.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.sharding import (ambient_mesh, grad_as_output, logical_sharding,
                             on_shards, pin, rowwise, shard)
from .config import ModelConfig
from .layers import ParamDef, apply_mlp, dot, mlp_defs


def moe_defs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    defs = {
        "router": ParamDef((d, m.n_experts), ("embed", None), "scaled"),
        "wi": ParamDef((m.n_experts, d, m.d_ff_expert),
                       ("experts", "fsdp", "mlp"), "scaled"),
        "wg": ParamDef((m.n_experts, d, m.d_ff_expert),
                       ("experts", "fsdp", "mlp"), "scaled"),
        "wo": ParamDef((m.n_experts, m.d_ff_expert, d),
                       ("experts", "mlp", "fsdp"), "scaled"),
    }
    if m.n_shared:
        defs["shared"] = mlp_defs(d, m.d_ff_shared, "swiglu")
    return defs


def capacity_of(cfg: ModelConfig, t: int) -> int:
    m = cfg.moe
    return max(1, int(m.capacity_factor * t * m.top_k / m.n_experts))


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: (values, indices) of the k
    largest, largest first, equal values in ascending index order."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def route(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """(router probabilities [b, t, e] float32, normalised gate weights
    [b, t, k] float32, expert indices [b, t, k] int64)."""
    # a port pin: the routing is row by row, its layout (and its
    # gradient's) the batch's alone
    gate_logits = pin(dot(x, p["router"].to(x.dtype)).float(),
                      "batch", "seq", None)
    probs = torch.softmax(gate_logits, dim=-1)
    gate_w, gate_idx = top_k(probs, cfg.moe.top_k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, gate_w, gate_idx


def apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x: [b, t, d] -> (y, aux_loss)."""
    m = cfg.moe
    e = m.n_experts
    c = capacity_of(cfg, x.shape[1])
    gathered = cfg.moe_tokens == "gathered"
    if gathered:
        # moe.py:59 shard(x, "batch", None, "act_embed"): the sequence
        # gathered once at entry
        x = shard(x, "batch", None, "act_embed")
    probs, gate_w, gate_idx = route(p, cfg, x)
    sort = cfg.moe_impl == "sort"
    dispatch = _dispatch_sort if sort else _dispatch_onehot
    y = dispatch(p, cfg, x, gate_w, gate_idx, c)
    if m.n_shared:
        y = y + apply_mlp(p["shared"], x, "swiglu")
    if gathered and not sort:
        # moe.py:109 shard(y, "batch", "seq", "act_embed"): scattered
        # back to sequence shards (the one-hot path only, as there)
        y = shard(y, "batch", "seq", "act_embed")
    # Switch-style load-balancing aux loss
    me = probs.mean((0, 1))                                  # [e]
    ce = F.one_hot(gate_idx[..., 0], e).float().mean((0, 1))
    aux = m.router_aux_weight * e * torch.sum(me * ce)
    return y, aux


def onehot_slots(gate_idx: torch.Tensor, e: int, c: int):
    """Each (token, choice)'s slot in its expert's capacity buffer (the
    count of earlier claims on that expert, in token then choice order)
    and whether it is kept (slot < c): [b, t, k] each."""
    b, t, k = gate_idx.shape
    oh = F.one_hot(gate_idx, e)                              # [b,t,k,e]
    flat = oh.reshape(b, t * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, t, k, e)
    pos = (pos * oh).sum(-1)
    return pos, pos < c


def _onehot_tensors(gate_w, gate_idx, e: int, c: int, dtype):
    """The one-hot dispatch and combine tensors [b, t, e, c], row by
    row."""
    b, t, k = gate_idx.shape
    pos, keep = onehot_slots(gate_idx, e, c)
    keep = keep.to(dtype)
    experts = torch.arange(e, device=gate_idx.device)
    slots = torch.arange(c, device=gate_idx.device)
    # accumulate dispatch/combine over the small k axis to bound temps;
    # every (e, c) slot receives at most one nonzero term, so the sums in
    # the activation dtype are exact
    disp = torch.zeros((b, t, e, c), dtype=dtype, device=gate_idx.device)
    comb = torch.zeros((b, t, e, c), dtype=dtype, device=gate_idx.device)
    for kk in range(k):
        sel = ((gate_idx[:, :, kk, None] == experts).to(dtype)[..., None]
               * (pos[:, :, kk, None] == slots).to(dtype)[:, :, None, :]
               * keep[:, :, kk, None, None])
        disp = disp + sel
        comb = comb + sel * gate_w[:, :, kk, None, None].to(dtype)
    return disp, comb


def _combine_onehot(comb, ye):
    return torch.einsum("btec,becd->btd", comb, ye)


def _dispatch_onehot(p, cfg, x, gate_w, gate_idx, c: int):
    e = cfg.moe.n_experts
    # row by row under a mesh: the one-hot builds and the int64 cumsum
    # have no DTensor rule, and the dispatch contracts a row's tokens
    disp, comb = rowwise(
        lambda w, i: _onehot_tensors(w, i, e, c, x.dtype),
        (gate_w, gate_idx), n_out=2)
    xe = rowwise(lambda dd, xx: torch.einsum("btec,btd->becd", dd, xx),
                 (disp, x))                                  # dispatch
    # moe.py:101 shard(xe, "batch", "experts", None, "act_embed")
    xe = shard(xe, "batch", "experts", None, "act_embed")
    ye = _expert_ffn(p, cfg, xe)
    mesh = ambient_mesh()
    if mesh is None:
        return _combine_onehot(comb, ye)                     # combine
    # the combine on each rank's rows and experts: a partial sum over the
    # experts' mesh axis, reduced where the next op needs it
    from torch.distributed.tensor import Partial, Shard
    pc = logical_sharding(("batch", None, "experts", None),
                          tuple(comb.shape), mesh).placements
    pe = logical_sharding(("batch", "experts", None, None),
                          tuple(ye.shape), mesh).placements
    out = [Partial() if p == Shard(2) else p for p in pc]
    return on_shards(_combine_onehot, (comb, ye), (pc, pe), out)


def _expert_mm(eq: str, a, w, a_dims, w_dims, out_dims):
    """``torch.einsum(eq, a, w)``, under a mesh on each rank's rows and
    experts (``on_shards``: DTensor's einsum views a shard's local
    tensor by the global strides, which a sharded layout breaks): the
    weight gathered over its fsdp axis, an expert's hidden dim split
    where the experts are not; a hidden dim split on both sides of a
    contraction leaves a partial sum."""
    mesh = ambient_mesh()
    if mesh is None:
        return torch.einsum(eq, a, w)
    from torch.distributed.tensor import Partial, Shard
    pa = logical_sharding(a_dims, tuple(a.shape), mesh).placements
    pw = logical_sharding(w_dims, tuple(w.shape), mesh).placements
    ins, o = eq.split("->")
    la, lw = ins.split(",")
    out_shape = tuple(a.shape[la.index(c)] if c in la else
                      w.shape[lw.index(c)] for c in o)
    po = list(logical_sharding(out_dims, out_shape, mesh).placements)
    for i, (x, y) in enumerate(zip(pa, pw)):
        if (isinstance(x, Shard) and isinstance(y, Shard)
                and la[x.dim] == lw[y.dim] and la[x.dim] not in o):
            po[i] = Partial()
    return grad_as_output(on_shards(
        lambda u, v: torch.einsum(eq, u, v), (a, w), (pa, pw), po))


def _expert_ffn(p: dict, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: xe [b, e, c, d] -> [b, e, c, d]."""
    rows, hid = ("batch", "experts", None, None), ("batch", "experts", None,
                                                   "mlp")
    hi = _expert_mm("becd,edf->becf", xe, p["wi"].to(xe.dtype), rows,
                    ("experts", None, "mlp"), hid)
    hg = _expert_mm("becd,edf->becf", xe, p["wg"].to(xe.dtype), rows,
                    ("experts", None, "mlp"), hid)
    # moe.py:122 shard(silu(hg) * hi, "batch", "experts", None, "mlp")
    he = shard(F.silu(hg) * hi, "batch", "experts", None, "mlp")
    ye = _expert_mm("becf,efd->becd", he, p["wo"].to(xe.dtype), hid,
                    ("experts", "mlp", None), rows)
    # moe.py:125 shard(ye, "batch", "experts", None, "act_embed")
    return shard(ye, "batch", "experts", None, "act_embed")


def sort_slots(gate_idx: torch.Tensor, e: int, c: int):
    """The sort dispatch's plan: the (token, choice) pairs of each row
    sorted stably by expert -> (pair order [b, t*k], slot [b, t*k]: the
    flat ``expert * c + rank`` of a kept pair, ``e * c`` of a dropped
    one, keep [b, t*k])."""
    b, t, k = gate_idx.shape
    tk = t * k
    se, order = torch.sort(gate_idx.reshape(b, tk), dim=-1, stable=True)
    starts = torch.searchsorted(
        se, torch.arange(e, device=se.device).expand(b, e).contiguous(),
        right=False)
    rank = torch.arange(tk, device=se.device) - starts.gather(1, se)
    keep = rank < c
    slot = torch.where(keep, se * c + rank, torch.full_like(se, e * c))
    return order, slot, keep


def _sort_gather(x, gate_w, gate_idx, e: int, c: int):
    """The sort dispatch's gather into expert slots, row by row: (xe [b,
    e * c, d], slot, keep, the pairs' gate weights, the pair order)."""
    b, t, d = x.shape
    k = gate_idx.shape[-1]
    tk = t * k
    order, slot, keep = sort_slots(gate_idx, e, c)
    stok = order // k                                # token of each pair
    sw = gate_w.reshape(b, tk).gather(1, order)
    rows = torch.arange(b, device=x.device)[:, None]
    xs = torch.where(keep[..., None], x[rows, stok], 0.0)
    xe = torch.zeros((b, e * c + 1, d), dtype=x.dtype, device=x.device)
    # the kept slots are distinct; dropped pairs all write zeros to the
    # trash slot e * c
    xe[rows, slot] = xs
    return xe[:, :e * c], slot, keep, sw, order


def _sort_combine(flat, slot, keep, sw, order, t: int):
    """Each token's k expert outputs gathered back and summed, row by
    row: flat [b, e * c, d] -> [b, t, d]."""
    b, ec, d = flat.shape
    tk = order.shape[1]
    k = tk // t
    rows = torch.arange(b, device=flat.device)[:, None]
    vals = torch.where(keep[..., None],
                       flat[rows, torch.clamp(slot, max=ec - 1)], 0.0)
    vals = vals * sw[..., None].to(flat.dtype)               # [b, tk, d]
    # each token's k pairs, in the order they sit in the sorted list
    # (ascending expert): their positions there, sorted
    at = torch.empty_like(order)
    at.scatter_(1, order, torch.arange(tk, device=flat.device).expand(b, tk))
    at = torch.sort(at.reshape(b, t, k), dim=-1).values
    y = torch.zeros((b, t, d), dtype=flat.dtype, device=flat.device)
    for j in range(k):
        y = y + vals[rows, at[:, :, j]]
    return y


def _dispatch_sort(p, cfg, x, gate_w, gate_idx, c: int):
    """Gather into expert slots and back; no [b, t, e, c] tensors.  Under
    a mesh the sort, the searches and the gathers and scatters run on
    each rank's rows (no DTensor rule for ``searchsorted`` or for index
    writes)."""
    b, t, d = x.shape
    e = cfg.moe.n_experts
    xe, slot, keep, sw, order = rowwise(
        lambda xx, w, i: _sort_gather(xx, w, i, e, c), (x, gate_w, gate_idx),
        n_out=5)
    # moe.py:159 shard(xe, "batch", "experts", None, "act_embed")
    xe = shard(xe.reshape(b, e, c, d), "batch", "experts", None, "act_embed")
    ye = _expert_ffn(p, cfg, xe)
    return rowwise(lambda f, s_, k_, w, o: _sort_combine(f, s_, k_, w, o, t),
                   (ye.reshape(b, e * c, d), slot, keep, sw, order))


__all__ = ["apply_moe", "capacity_of", "moe_defs", "onehot_slots", "route",
           "sort_slots", "top_k"]
