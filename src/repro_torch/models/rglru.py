"""RG-LRU recurrent block (RecurrentGemma; port of
``repro.models.rglru``).

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_r x_t)                    (recurrence gate)
    i_t = sigmoid(W_i x_t)                    (input gate)
    a_t = a^(c * r_t),  a = sigmoid(Lambda)   (per-channel decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped with a temporal conv1d and linear in/out projections.  Prefill
runs ``scan.associative_scan`` over the sequence; decode carries
``RGLRUState(conv [b, cw-1, w], h [b, w])``, one step a token.  ``h``
stays float32 whatever the activation dtype.  The functions return a
new state, as the reference's do; ``transformer`` writes it into the
caller's state tensors.  GELU is the tanh form (``jax.nn.gelu``'s
default).  The reference's ``shard`` constraints (the identity outside a
mesh, ``repro_torch.dist.sharding.shard``) are left out: the models run
whole on one rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..dist.sharding import elementwise, pin, shard, zeros
from .config import ModelConfig
from .layers import ParamDef, dot
from .scan import associative_scan, causal_conv

C_SCALE = 8.0   # the Griffin `c` constant


class RGLRUState(NamedTuple):
    conv: torch.Tensor    # [b, conv_width-1, width]
    h: torch.Tensor       # [b, width] float32


def rglru_defs(cfg: ModelConfig) -> dict:
    w = cfg.lru_width
    d = cfg.d_model
    cw = cfg.rglru.conv_width
    return {
        "in_x": ParamDef((d, w), ("fsdp", "mlp"), "scaled"),
        "in_gate": ParamDef((d, w), ("fsdp", "mlp"), "scaled"),
        "conv_w": ParamDef((cw, w), ("conv", "mlp"), "scaled"),
        "conv_b": ParamDef((w,), ("mlp",), "zeros"),
        "w_r": ParamDef((w, w), ("mlp", None), "scaled"),
        "w_i": ParamDef((w, w), ("mlp", None), "scaled"),
        "lam": ParamDef((w,), ("mlp",), "ones"),
        "out": ParamDef((w, d), ("mlp", "fsdp"), "scaled"),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, dtype,
                     device) -> RGLRUState:
    w, cw = cfg.lru_width, cfg.rglru.conv_width
    return RGLRUState(
        conv=zeros((batch, cw - 1, w), rglru_state_spec(cfg).conv, dtype,
                   device),
        h=zeros((batch, w), rglru_state_spec(cfg).h, torch.float32, device))


def rglru_state_spec(cfg: ModelConfig) -> RGLRUState:
    return RGLRUState(conv=("cache_batch", None, "mlp"),
                      h=("cache_batch", "mlp"))


def apply_rglru(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: RGLRUState | None = None):
    """x: [b, t, d] -> (y, new_state)."""
    b, t, _ = x.shape
    gate = F.gelu(dot(x, p["in_gate"].to(x.dtype)), approximate="tanh")
    xi = dot(x, p["in_x"].to(x.dtype))
    # rglru.py:70 shard(xi, "batch", "seq", "mlp")
    xi = shard(xi, "batch", "seq", "mlp")
    xc, new_conv = causal_conv(xi, None if state is None else state.conv,
                               p["conv_w"], p["conv_b"])
    # port pins: the conv output and the gate in xi's layout
    xc = pin(xc, "batch", "seq", "mlp")
    gate = pin(gate, "batch", "seq", "mlp")

    r = torch.sigmoid(dot(xc, p["w_r"].to(xc.dtype)).float())
    i = torch.sigmoid(dot(xc, p["w_i"].to(xc.dtype)).float())
    # log a (no DTensor rule for log_sigmoid: shard by shard)
    log_a0 = elementwise(F.logsigmoid, p["lam"].float())
    a = torch.exp(C_SCALE * r * log_a0)                      # a^(c r)
    gated = i * xc.float()
    u = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated

    h0 = (state.h if state is not None
          else torch.zeros((b, xc.shape[-1]), device=x.device))
    if t == 1:
        h = a[:, 0] * h0 + u[:, 0]
        hs = h[:, None]
    else:
        u[:, 0] += a[:, 0] * h0                  # fold the carried state
        _, hs = associative_scan(a, u)
        h = hs[:, -1]

    y = hs.to(x.dtype) * gate
    out = dot(y, p["out"].to(x.dtype))
    return out, RGLRUState(conv=new_conv.to(x.dtype), h=h)


__all__ = ["C_SCALE", "RGLRUState", "apply_rglru", "init_rglru_state",
           "rglru_defs", "rglru_state_spec"]
