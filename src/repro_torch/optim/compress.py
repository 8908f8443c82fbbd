"""Int8 gradient compression with error feedback (port of
``repro.optim.compress``).

Gradients are quantised to int8 with a per-tensor scale and the
quantisation residual is carried into the next step (error feedback
keeps convergence).  ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ._tree import leaves, tree_map, unflatten


class EFState(NamedTuple):
    residual: Any                 # same tree as grads, fp32


def ef_init(grads_like) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


#: 1/127 in float32.  The reference runs jitted, and XLA turns its division
#: by the constant 127 into a multiply by this reciprocal: multiplying
#: by it keeps the scales, and so the codes and residuals, the reference's
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, 1e-12) * _INV_127


def _quantise(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def compress_int8(x: torch.Tensor):
    """-> (int8 values, f32 scale). Symmetric per-tensor quantisation."""
    x32 = x.to(torch.float32)
    scale = _scale(torch.max(torch.abs(x32)))
    return _quantise(x32, scale), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_update(grads, ef: EFState, groups=None):
    """Quantise (grads + residual); return (dequantised grads, new EF).

    The dequantised value is what enters the cross-pod reduction; the
    residual keeps what quantisation lost (rounded once, as XLA's fused
    multiply-add leaves it).  ``groups`` (lists of leaf
    indices, in leaf order) share one scale: the leaves the reference
    holds as one stacked tensor (``repro_torch.train.step.scale_groups``)
    quantise as that tensor does.  By default each leaf has its own.
    """
    flat_g, flat_r = leaves(grads), leaves(ef.residual)
    if groups is None:
        groups = [[i] for i in range(len(flat_g))]
    deq, res = [None] * len(flat_g), [None] * len(flat_g)
    for idx in groups:
        tot = {i: flat_g[i].to(torch.float32) + flat_r[i] for i in idx}
        amax = torch.max(torch.stack([torch.max(torch.abs(t))
                                      for t in tot.values()]))
        scale = _scale(amax)
        for i, t in tot.items():
            q = _quantise(t, scale)
            deq[i] = decompress_int8(q, scale).to(flat_g[i].dtype)
            # tot - q * scale rounded once, as the reference's fused
            # multiply-add: the product is exact in float64, and so is
            # the difference (tot lies within scale / 2 of the product)
            res[i] = (t.to(torch.float64) - q.to(torch.float64)
                      * scale.to(torch.float64)).to(torch.float32)
    return (unflatten(grads, deq),
            EFState(residual=unflatten(grads, res)))
