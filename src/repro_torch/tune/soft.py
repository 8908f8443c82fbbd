"""Temperature-smoothed relaxations of the fluid model's hard gates
(port of ``repro.tune.soft``).

The closed loop in ``core.fluid`` / ``core.cc`` is full of hard
nonlinearities — PFC xoff/xon hysteresis, kmin/kmax marking thresholds,
CNP suppression windows, rate clamps.  Each one is a ``torch.where`` on
a boolean, so autograd through the dt loop sees zero gradient with
respect to every CC constant that only acts through a threshold
crossing.  These primitives smooth them:

  * every softened site is written ``select(tau, soft_expr, hard_expr)``
    where ``hard_expr`` is the hard code verbatim, so a run at
    ``tau == 0`` takes the hard value bitwise;
  * ``tau`` is ``StepParams.temperature``, one value per run (``[R]``):
    the caller broadcasts it against the site's operands
    (``tau[:, None]`` against ``[R, F]``, ``tau[:, None, None]`` against
    ``[R, F, H]``), as it does every per-run constant;
  * as ``tau -> 0`` the soft expressions converge pointwise to the hard
    ones (sigmoid gates sharpen to step functions, softplus clamps to
    min/max).

Gradient hygiene: ``torch.where`` is a select, so the untaken branch's
gradient is zero, and the hard branch never pollutes the gradient at
``tau > 0``.  Blends (``gate*a + (1-gate)*b``) are only used where both
operands are finite; sites with ``inf`` sentinels select instead of
blending, because ``0 * inf = nan``.

Pure torch on purpose: ``core.fluid`` and ``core.cc`` import this module
at the top level, so it imports nothing of ``repro_torch.core``.
"""

from __future__ import annotations

import torch

#: Additive floor on sigmoid/softplus widths (guards ``scale == 0``
#: sites; the tau = 0 case is handled by :func:`safe_tau`).
TINY = 1e-30


def safe_tau(tau):
    """``tau`` where positive, 1.0 at ``tau == 0``.

    At temperature zero ``select`` discards the soft branch, but
    autograd still differentiates it: a width of ``0 * scale`` would put
    ``x / width`` at +-inf and the backward pass would turn the
    (correctly zero) gradient into ``0 * inf = nan``.  Evaluating the
    dead branch at tau = 1 keeps every intermediate and every
    vector-Jacobian product finite without changing any tau > 0 value.
    """
    return torch.where(tau > 0.0, tau, 1.0)


def unit_gate(x, tau, scale):
    """Soft step: ``sigmoid(x / (tau * scale))`` -> ``1[x > 0]`` as tau->0.

    ``scale`` sets the natural units of ``x`` (port-buffer bytes, line
    rate, a CNP window) so one dimensionless ``tau`` smooths every site
    comparably: the transition band is ``O(tau * scale)`` wide.
    """
    return torch.sigmoid(x / (safe_tau(tau) * scale + TINY))


def select(tau, soft_expr, hard_expr):
    """The soft expression at ``tau > 0``, the hard one (bitwise) at 0."""
    return torch.where(tau > 0.0, soft_expr, hard_expr)


def pick(tau, gate, cond, a, b):
    """Gated choice: hard ``where(cond, a, b)``, soft ``gate*a+(1-gate)*b``.

    ``gate`` is the soft relaxation of the boolean ``cond`` (hard mode
    carries it as an exact 0/1 float).  Operands must be finite — this
    is a blend, not a select.
    """
    return select(tau, gate * a + (1.0 - gate) * b, torch.where(cond, a, b))


def softplus(x, width):
    """``width * log(1 + exp(x / width))`` -> ``max(x, 0)`` as width->0
    (``logaddexp(x, 0)``, the reference's softplus, with no threshold)."""
    z = x / (width + TINY)
    return width * torch.logaddexp(z, torch.zeros_like(z))


def clip(x, lo, hi, tau, scale):
    """Two-sided soft clamp -> ``minimum(maximum(x, lo), hi)`` bitwise at
    tau = 0.

    Soft form: a softplus hinge at each edge, transition band
    ``O(tau * scale)`` wide.  Monotone in ``x`` and differentiable in
    ``x``, ``lo`` and ``hi``.
    """
    w = safe_tau(tau) * scale + TINY
    soft_lo = lo + softplus(x - lo, w)
    soft_both = hi - softplus(hi - soft_lo, w)
    return select(tau, soft_both, torch.minimum(torch.maximum(x, lo), hi))
