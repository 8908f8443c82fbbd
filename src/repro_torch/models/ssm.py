"""Mamba-1 selective SSM block (falcon-mamba-7b; port of
``repro.models.ssm``).

Prefill runs ``scan.associative_scan`` over the sequence, in chunks of
``cfg.ssm_chunk`` carrying the state where the chunk divides a longer
sequence (the reference's ``lax.scan`` over chunks, a Python loop
here); decode is one recurrence step on the carried
``SSMState(conv [b, d_conv-1, d_inner], ssm [b, d_inner, d_state])``.
The scan pairs are in ``cfg.ssm_scan_dtype``; the carried state stays
float32.  The functions return a new state, as the reference's do;
``transformer`` writes it into the caller's state tensors.
``jax.nn.softplus`` is ``logaddexp(x, 0)``, kept as such
(``F.softplus`` returns x itself above its threshold of 20).
``cfg.ssm_shard`` picks the ``shard`` calls' channel axis, as in the
reference (the identity outside a mesh,
``repro_torch.dist.sharding.shard``); the chunked scan stacks its chunks
on a leading axis, as the reference's ``lax.scan`` input, and loops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..dist.sharding import grad_as_output, pin, shard, zeros
from .config import ModelConfig
from .layers import ParamDef, dot
from .scan import associative_scan, causal_conv


class SSMState(NamedTuple):
    conv: torch.Tensor    # [b, d_conv-1, d_inner]
    ssm: torch.Tensor     # [b, d_inner, d_state] float32


def ssm_defs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d, di, dr, ds = cfg.d_model, cfg.d_inner, cfg.dt_rank, s.d_state
    return {
        "in_proj": ParamDef((d, 2 * di), ("fsdp", "mlp"), "scaled"),
        "conv_w": ParamDef((s.d_conv, di), ("conv", "mlp"), "scaled"),
        "conv_b": ParamDef((di,), ("mlp",), "zeros"),
        "x_proj": ParamDef((di, dr + 2 * ds), ("mlp", None), "scaled"),
        "dt_proj_w": ParamDef((dr, di), (None, "mlp"), "scaled"),
        "dt_proj_b": ParamDef((di,), ("mlp",), "ones"),
        # A stored as log so A = -exp(log_a) < 0 (stability)
        "log_a": ParamDef((di, ds), ("mlp", "state"), "zeros"),
        "d_skip": ParamDef((di,), ("mlp",), "ones"),
        "out_proj": ParamDef((di, d), ("mlp", "fsdp"), "scaled"),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> SSMState:
    s = cfg.ssm
    return SSMState(
        conv=zeros((batch, s.d_conv - 1, cfg.d_inner),
                   ssm_state_spec(cfg).conv, dtype, device),
        ssm=zeros((batch, cfg.d_inner, s.d_state), ssm_state_spec(cfg).ssm,
                  torch.float32, device))


def ssm_state_spec(cfg: ModelConfig) -> SSMState:
    return SSMState(conv=("cache_batch", None, "mlp"),
                    ssm=("cache_batch", "mlp", "state"))


def _ssm_params(p: dict, cfg: ModelConfig, xc: torch.Tensor):
    """Input-dependent (dt, B, C) from the conv output xc [..., di]."""
    s = cfg.ssm
    dr = cfg.dt_rank
    proj = dot(xc, p["x_proj"].to(xc.dtype))
    dt_low, Bm, Cm = (proj[..., :dr], proj[..., dr:dr + s.d_state],
                      proj[..., dr + s.d_state:])
    dt = dot(dt_low, p["dt_proj_w"].to(xc.dtype))
    dt = dt.float() + p["dt_proj_b"].float()
    dt = torch.logaddexp(dt, dt.new_zeros(()))               # softplus
    return dt, Bm.float(), Cm.float()


def _read_out(hs: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """einsum('btis,bts->bti', hs, Cm) in float32."""
    return grad_as_output(torch.einsum("btis,bts->bti", hs.float(), Cm))


def _fold_state(u: torch.Tensor, da: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    """``u[:, 0] += da[:, 0] * h`` in u's dtype: the carried state folded
    into the scan's first step (the reference's ``u.at[:, 0].add``)."""
    u[:, 0] += (da[:, 0].float() * h).to(u.dtype)
    return u


def apply_ssm(p: dict, cfg: ModelConfig, x: torch.Tensor,
              state: SSMState | None = None):
    """x: [b, t, d].  Returns (y, new_state)."""
    s = cfg.ssm
    b, t, _ = x.shape
    di = cfg.d_inner

    xz = dot(x, p["in_proj"].to(x.dtype))
    xi, z = xz[..., :di], xz[..., di:]
    if cfg.ssm_shard == "channel":
        # ssm.py:84 shard(xi, "batch", None, "mlp"): the recurrence is
        # elementwise in d_inner, so channel shards scan without talking
        xi = shard(xi, "batch", None, "mlp")
    else:
        # ssm.py:86 shard(xi, "batch", "seq", "mlp")
        xi = shard(xi, "batch", "seq", "mlp")
    xc, new_conv = causal_conv(xi, None if state is None else state.conv,
                               p["conv_w"], p["conv_b"])
    xc = F.silu(xc)

    dt, Bm, Cm = _ssm_params(p, cfg, xc)             # [b,t,di],[b,t,ds]x2
    # port pins: B and C whole on each rank's rows (the read-out's
    # product flattens batch and time)
    Bm, Cm = pin(Bm, "batch", "seq", None), pin(Cm, "batch", "seq", None)
    A = -torch.exp(p["log_a"].float())               # [di, ds]
    da = torch.exp(dt[..., None] * A)                # [b,t,di,ds] decay
    u = dt[..., None] * Bm[:, :, None, :] * xc.float()[..., None]
    scan_dt = getattr(torch, cfg.ssm_scan_dtype)
    da, u = da.to(scan_dt), u.to(scan_dt)

    h0 = (state.ssm if state is not None
          else torch.zeros((b, di, s.d_state), device=x.device))
    ck = cfg.ssm_chunk
    if t == 1:                                       # one decode step
        h = da[:, 0].float() * h0 + u[:, 0].float()
        y = _read_out(h[:, None], Cm)
    elif ck and t > ck and t % ck == 0:
        # the chunked scan: the state carried from chunk to chunk, the
        # [.., d_inner, d_state] temporaries bounded by the chunk
        nc = t // ck
        mlp_ax = "mlp" if cfg.ssm_shard == "channel" else None
        # ssm.py:131-132 shard(da_c / u_c, None, "batch", None, mlp_ax,
        # None): the chunks stacked on a leading axis (views of da, u)
        da_c = shard(da.reshape(b, nc, ck, di, -1).transpose(0, 1),
                     None, "batch", None, mlp_ax, None)
        u_c = shard(u.reshape(b, nc, ck, di, -1).transpose(0, 1),
                    None, "batch", None, mlp_ax, None)
        h, ys = h0, []
        for i in range(nc):
            # ssm.py:137-138 shard(da_i / u_i, "batch", None, mlp_ax, None)
            da_i = shard(da_c[i], "batch", None, mlp_ax, None)
            u_i = shard(u_c[i], "batch", None, mlp_ax, None)
            u_i = _fold_state(u_i, da_i, h)
            _, hs_i = associative_scan(da_i, u_i)
            # ssm.py:145 shard(y_i, "batch", None, mlp_ax)
            ys.append(shard(_read_out(hs_i, Cm[:, i * ck:(i + 1) * ck]),
                            "batch", None, mlp_ax))
            h = hs_i[:, -1].float()
        y = torch.cat(ys, dim=1)
    else:
        u = _fold_state(u, da, h0)                   # carried state
        _, hs = associative_scan(da, u)
        h = hs[:, -1].float()
        y = _read_out(hs, Cm)                        # C read-out
    y = y + xc.float() * p["d_skip"].float()
    # a port pin: the gated output in xi's channel layout before the
    # product (DTensor's own choice may split the time axis there)
    y = pin(y.to(x.dtype) * F.silu(z), "batch", "seq", "mlp")
    out = dot(y, p["out_proj"].to(x.dtype))
    return out, SSMState(conv=new_conv.to(x.dtype), ssm=h)


__all__ = ["SSMState", "apply_ssm", "init_ssm_state", "ssm_defs",
           "ssm_state_spec"]
