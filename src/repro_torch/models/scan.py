"""The associative scan of a linear recurrence and the depthwise causal
conv1d, shared by the RG-LRU and SSM blocks (the reference calls
``jax.lax.associative_scan`` with the same pair operator, and writes
the same conv, in ``models/rglru.py`` and ``models/ssm.py``).

``associative_scan(a, u)`` returns every ``h_t = a_t * h_{t-1} + u_t``
along axis 1 from ``h_{-1} = 0`` (the caller folds a carried state into
``u[:, 0]``), together with the running products of ``a``.  It is the
log-depth odd/even recursion that ``jax.lax.associative_scan`` runs:
combine adjacent pairs, scan the half-length sequence, then fix up the
even positions, with the pair operator ``(a1, u1) o (a2, u2) = (a1 * a2,
a2 * u1 + u2)``.  Plain torch ops, O(t) work, log2(t) levels; the
multiply and add of each combine round separately (no fused multiply-
add), so on the CPU it follows the reference's rounding step for step
wherever XLA does the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.sharding import ambient_mesh, on_shards, placements_of


def _combine(lhs, rhs):
    a1, u1 = lhs
    a2, u2 = rhs
    return a1 * a2, a2 * u1 + u2


def associative_scan(a: torch.Tensor, u: torch.Tensor):
    """Inclusive scan of the pairs ``(a, u)`` along axis 1: returns
    ``(prod_{s<=t} a_s, h_t)`` for every t, in the inputs' dtype.  Under
    a mesh it runs on each rank's shards (the recursion's strided slices
    and interleaving writes have no DTensor rule), axis 1 whole on each
    rank: the recurrence is elementwise in every other axis."""
    if ambient_mesh() is not None:
        pl = placements_of(a, free=(1,))
        return on_shards(_scan, (a, u), (pl, pl), (pl, pl))
    return _scan(a, u)


def _scan(a: torch.Tensor, u: torch.Tensor):
    n = a.shape[1]
    if n < 2:
        return a, u
    odd = _scan(*_combine((a[:, 0:-1:2], u[:, 0:-1:2]),
                                     (a[:, 1::2], u[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], u[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], u[:, 2::2]))
    out = []
    for x, e, o in zip((a, u), even, odd):
        # position 0 is the first element; then even and odd interleave
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        y[:, :1] = x[:, :1]
        y[:, 2::2] = e
        y[:, 1::2] = o
        out.append(y)
    return out[0], out[1]


def causal_conv(xi: torch.Tensor, hist: torch.Tensor | None,
                w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv1d of ``xi`` [b, t, c] with taps ``w`` [cw,
    c] after the carried history ``hist`` [b, cw-1, c] (zeros if None):
    (conv output + bias, the new history)."""
    cw, t = w.shape[0], xi.shape[1]
    if hist is not None:
        xpad = torch.cat([hist.to(xi.dtype), xi], dim=1)
    else:
        xpad = F.pad(xi, (0, 0, cw - 1, 0))
    w = w.to(xi.dtype)
    xc = sum(xpad[:, i:i + t, :] * w[i] for i in range(cw))
    return xc + b.to(xc.dtype), xpad[:, xpad.shape[1] - (cw - 1):, :]


__all__ = ["associative_scan", "causal_conv"]
