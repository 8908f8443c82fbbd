"""Primitive layers + the ParamDef descriptor system (port of
``repro.models.layers``).

Params are described by trees (dicts and lists) of
``ParamDef(shape, dims, init)``, where ``dims`` are *logical* sharding
axes (see ``repro_torch.dist.sharding``).  The same tree materialises
three ways:

  * ``init_params``      — real tensors on a device (seeded)
  * ``abstract_params``  — meta-device tensors (shape and dtype, no
    storage: the reference's ShapeDtypeStructs)
  * ``param_specs``      — logical-dims tree (for ``logical_sharding``)

Numerics follow the reference where the frameworks' defaults differ:
norms compute in float32 and cast back; GELU is the tanh approximation
(``jax.nn.gelu``'s default); ``rope`` casts cos/sin to x's dtype before
the multiply; the embedding scale is ``sqrt(d)`` cast to x's dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.fluid import resolve_device
from ..dist.sharding import grad_as_output, shard


class ParamDef(NamedTuple):
    shape: tuple
    dims: tuple                   # logical axis per dim (str | None)
    init: str = "normal"          # normal | zeros | ones | scaled
    scale: float = 0.02


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def def_leaves(tree) -> list:
    """The ``ParamDef`` leaves of a def tree, in the order
    ``init_params`` draws them (dict keys sorted, lists in order)."""
    if is_def(tree):
        return [tree]
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in def_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [d for x in tree for d in def_leaves(x)]
    raise TypeError(f"not a ParamDef tree: {type(tree)}")


def _init_one(d: ParamDef, gen: torch.Generator, dtype,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "normal":
        s = d.scale
    elif d.init == "scaled":  # fan-in scaled
        s = 1.0 / math.sqrt(d.shape[0] if len(d.shape) > 1
                            else max(d.shape[0], 1))
    else:
        raise ValueError(d.init)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(s).to(dtype)


def init_params(defs, seed: int, dtype=torch.float32, device=None):
    """Materialise a def tree: random leaves from one ``torch.Generator``
    seeded with ``seed`` on the target device, drawn leaf by leaf in
    ``def_leaves`` order.  The numbers are not the reference's (JAX's
    generator differs); tests carry the reference's weights across with
    ``convert.params_from_numpy`` instead.  ``device=None`` is the card
    (raises without one)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(tree):
        if is_def(tree):
            return _init_one(tree, gen, dtype, device)
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return [build(x) for x in tree]

    return build(defs)


def _map_defs(fn, defs):
    """The def tree with each ``ParamDef`` d replaced by ``fn(d)``."""
    if is_def(defs):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: _map_defs(fn, v) for k, v in defs.items()}
    return [_map_defs(fn, x) for x in defs]


def abstract_params(defs, dtype=torch.bfloat16):
    """The def tree as meta-device tensors of ``dtype``."""
    return _map_defs(
        lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def param_specs(defs):
    """The def tree with each ``ParamDef`` replaced by its logical dims."""
    return _map_defs(lambda d: tuple(d.dims), defs)


def param_shapes(defs):
    """The def tree with each ``ParamDef`` replaced by its shape tuple."""
    return _map_defs(lambda d: tuple(d.shape), defs)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; on a sharded path its gradient is laid out as the
    product was (``grad_as_output``)."""
    return grad_as_output(x @ w)


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

def rmsnorm_defs(dim: int) -> dict:
    return {"scale": ParamDef((dim,), (None,), "ones")}


def layernorm_defs(dim: int) -> dict:
    return {"scale": ParamDef((dim,), (None,), "ones"),
            "bias": ParamDef((dim,), (None,), "zeros")}


def norm_defs(kind: str, dim: int) -> dict:
    return rmsnorm_defs(dim) if kind == "rms" else layernorm_defs(dim)


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        nrm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (nrm * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    nrm = (xf - mu) * torch.rsqrt(var + eps)
    return (nrm * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embed_defs(vocab: int, d_model: int) -> dict:
    return {"table": ParamDef((vocab, d_model), ("vocab", "embed"),
                              "normal", 0.01)}


def embed_lookup(p: dict, ids: torch.Tensor, scale: bool,
                 d: int) -> torch.Tensor:
    # F.embedding, not table[ids]: its backward sums a row's gradients in
    # a fixed order on the CPU, where index_put_'s accumulation is
    # threaded and unordered (a resumed run must repeat the bits)
    x = F.embedding(ids, p["table"])
    if scale:
        # a device fill, not a host copy: capturable in a CUDA graph
        x = x * torch.full((), math.sqrt(d), dtype=x.dtype, device=x.device)
    # layers.py:111 shard(x, "batch", "seq", "act_embed")
    return shard(x, "batch", "seq", "act_embed")


def logits_defs(vocab: int, d_model: int, tied: bool) -> dict:
    if tied:
        return {}
    return {"out": ParamDef((d_model, vocab), ("embed", "vocab"), "scaled")}


def apply_logits(p: dict, embed_p: dict, x: torch.Tensor, tied: bool,
                 softcap: float) -> torch.Tensor:
    w = embed_p["table"].T if tied else p["out"]
    logits = dot(x, w.to(x.dtype))
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits.float()


def masked_ce(logits: torch.Tensor, labels: torch.Tensor):
    """(summed negative log-likelihood of ``labels`` under ``logits``, the
    count of positions) over the positions where ``labels >= 0`` (the
    reference's ``transformer._ce``)."""
    mask = labels >= 0
    lab = torch.clamp_min(labels, 0).long()
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def masked_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits`` over
    the positions where ``labels >= 0``."""
    tot, cnt = masked_ce(logits, labels)
    return tot / torch.clamp_min(cnt, 1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, kind: str) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "wi": ParamDef((d_model, d_ff), ("fsdp", "mlp"), "scaled"),
            "wg": ParamDef((d_model, d_ff), ("fsdp", "mlp"), "scaled"),
            "wo": ParamDef((d_ff, d_model), ("mlp", "fsdp"), "scaled"),
        }
    return {  # plain gelu MLP (starcoder2, whisper)
        "wi": ParamDef((d_model, d_ff), ("fsdp", "mlp"), "scaled"),
        "bi": ParamDef((d_ff,), ("mlp",), "zeros"),
        "wo": ParamDef((d_ff, d_model), ("mlp", "fsdp"), "scaled"),
        "bo": ParamDef((d_model,), (None,), "zeros"),
    }


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        h = dot(x, p["wi"].to(x.dtype))
        g = dot(x, p["wg"].to(x.dtype))
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        # layers.py:153 shard(h * act, "batch", "seq", "mlp")
        h = shard(h * act, "batch", "seq", "mlp")
        return dot(h, p["wo"].to(x.dtype))
    h = F.gelu(dot(x, p["wi"].to(x.dtype)) + p["bi"].to(x.dtype),
               approximate="tanh")
    # layers.py:157 shard(h, "batch", "seq", "mlp")
    h = shard(h, "batch", "seq", "mlp")
    return dot(h, p["wo"].to(x.dtype)) + p["bo"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [b, t, heads, head_dim]; positions: [b, t] integer."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq               # [b,t,half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x
