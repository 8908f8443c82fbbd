"""AdamW from scratch (port of ``repro.optim.adamw``).

Moments are float32 and mirror the params; the float32 master copy is
optional (bf16 training keeps masters, and the update is taken on them;
fp32 training may reuse the params).  The update is functional, as the
reference's: it returns new tensors and writes none of its inputs, so a
caller may keep the old state.  Leaves may share storage (the master of
a float32 param is the param itself).

Arithmetic follows the reference's dtype promotion, where torch's
differs: a bf16 gradient times the float32 clip scale is multiplied in
float32 and cast back (JAX promotes; torch would keep bf16), and
``max_norm / norm`` is one true division (torch's scalar-over-tensor is
a reciprocal and a multiply).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ._tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    use_master: bool = True       # fp32 master weights for bf16 params


class OptState(NamedTuple):
    step: torch.Tensor            # [] int32
    mu: Any                       # first moment  (fp32)
    nu: Any                       # second moment (fp32)
    master: Any                   # fp32 master params or None


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params, cfg: AdamWConfig) -> OptState:
    first = leaves(params)
    device = first[0].device if first else None
    master = (tree_map(lambda p: p.to(torch.float32), params)
              if cfg.use_master else None)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(_zeros32, params),
                    nu=tree_map(_zeros32, params), master=master)


def is_dims(x) -> bool:
    """A logical-dims leaf of a spec tree: a tuple of axis names / None."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def copy_dims(tree):
    """A copy of a logical-dims tree (dicts, lists, NamedTuples)."""
    if is_dims(tree):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: copy_dims(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*[copy_dims(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(copy_dims(v) for v in tree)
    return tree


def opt_state_specs(param_spec_tree, cfg: AdamWConfig) -> OptState:
    """Logical-dims tree for the optimizer state (mirrors params)."""
    copy = copy_dims(param_spec_tree)
    return OptState(step=(), mu=copy, nu=copy_dims(param_spec_tree),
                    master=copy if cfg.use_master else None)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(
        torch.full((), max_norm, dtype=torch.float32, device=norm.device)
        / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def adamw_update(grads, opt: OptState, params, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None):
    """Returns (new_params, new_opt, metrics)."""
    step = opt.step + 1
    lr_t = cfg.lr if lr is None else lr
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(g, m, v, p, pm):
        g32 = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mhat = m / bc1
        vhat = v / bc2
        base = pm if pm is not None else p.to(torch.float32)
        new = base - lr_t * (mhat / (torch.sqrt(vhat) + cfg.eps)
                             + cfg.weight_decay * base)
        return new.to(p.dtype), m, v, new

    flat_p = leaves(params)
    flat_pm = (leaves(opt.master) if opt.master is not None
               else [None] * len(flat_p))
    outs = [upd(g, m, v, p, pm) for g, m, v, p, pm in
            zip(leaves(grads), leaves(opt.mu), leaves(opt.nu), flat_p,
                flat_pm)]
    new_opt = OptState(
        step=step, mu=unflatten(params, [o[1] for o in outs]),
        nu=unflatten(params, [o[2] for o in outs]),
        master=(unflatten(params, [o[3] for o in outs])
                if opt.master is not None else None))
    lr_out = (lr_t.to(torch.float32) if isinstance(lr_t, torch.Tensor)
              else torch.tensor(lr_t, dtype=torch.float32,
                                device=step.device))
    return unflatten(params, [o[0] for o in outs]), new_opt, {
        "grad_norm": gnorm, "lr": lr_out}
