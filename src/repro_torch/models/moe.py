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
``cfg.moe_tokens`` and the reference's ``shard`` constraints place
tokens on a mesh; the models run whole on one rank, so they are left
out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import ParamDef, apply_mlp, mlp_defs


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
    gate_logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(gate_logits, dim=-1)
    gate_w, gate_idx = top_k(probs, cfg.moe.top_k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    return probs, gate_w, gate_idx


def apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x: [b, t, d] -> (y, aux_loss)."""
    m = cfg.moe
    e = m.n_experts
    c = capacity_of(cfg, x.shape[1])
    probs, gate_w, gate_idx = route(p, cfg, x)
    dispatch = _dispatch_sort if cfg.moe_impl == "sort" else _dispatch_onehot
    y = dispatch(p, cfg, x, gate_w, gate_idx, c)
    if m.n_shared:
        y = y + apply_mlp(p["shared"], x, "swiglu")
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


def _dispatch_onehot(p, cfg, x, gate_w, gate_idx, c: int):
    b, t, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    pos, keep = onehot_slots(gate_idx, e, c)
    keep = keep.to(x.dtype)
    experts = torch.arange(e, device=x.device)
    slots = torch.arange(c, device=x.device)
    # accumulate dispatch/combine over the small k axis to bound temps;
    # every (e, c) slot receives at most one nonzero term, so the sums in
    # the activation dtype are exact
    disp = torch.zeros((b, t, e, c), dtype=x.dtype, device=x.device)
    comb = torch.zeros((b, t, e, c), dtype=x.dtype, device=x.device)
    for kk in range(k):
        sel = ((gate_idx[:, :, kk, None] == experts).to(x.dtype)[..., None]
               * (pos[:, :, kk, None] == slots).to(x.dtype)[:, :, None, :]
               * keep[:, :, kk, None, None])
        disp = disp + sel
        comb = comb + sel * gate_w[:, :, kk, None, None].to(x.dtype)
    xe = torch.einsum("btec,btd->becd", disp, x)             # dispatch
    ye = _expert_ffn(p, cfg, xe)
    return torch.einsum("btec,becd->btd", comb, ye)          # combine


def _expert_ffn(p: dict, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: xe [b, e, c, d] -> [b, e, c, d]."""
    hi = torch.einsum("becd,edf->becf", xe, p["wi"].to(xe.dtype))
    hg = torch.einsum("becd,edf->becf", xe, p["wg"].to(xe.dtype))
    return torch.einsum("becf,efd->becd", F.silu(hg) * hi,
                        p["wo"].to(xe.dtype))


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


def _dispatch_sort(p, cfg, x, gate_w, gate_idx, c: int):
    """Gather into expert slots and back; no [b, t, e, c] tensors."""
    b, t, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
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
    ye = _expert_ffn(p, cfg, xe[:, :e * c].reshape(b, e, c, d))
    flat = ye.reshape(b, e * c, d)
    vals = torch.where(keep[..., None],
                       flat[rows, torch.clamp(slot, max=e * c - 1)], 0.0)
    vals = vals * sw[..., None].to(x.dtype)                  # [b, tk, d]
    # each token's k pairs, in the order they sit in the sorted list
    # (ascending expert): their positions there, sorted
    at = torch.empty_like(order)
    at.scatter_(1, order, torch.arange(tk, device=x.device).expand(b, tk))
    at = torch.sort(at.reshape(b, t, k), dim=-1).values
    y = torch.zeros((b, t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + vals[rows, at[:, :, j]]
    return y


__all__ = ["apply_moe", "capacity_of", "moe_defs", "onehot_slots", "route",
           "sort_slots", "top_k"]
