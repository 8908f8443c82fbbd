"""train_step builder: loss -> grads -> (optional EF-int8) -> AdamW (port
of ``repro.train.step``).

One function covers all ten architectures: the model family dispatch
(decoder / enc-dec / vlm) picks the loss; everything below it is shared.
Microbatch gradient accumulation happens inside the step (into float32
zeros, as the reference's scan), so the global batch is a config knob
independent of memory.  The step is functional, as the reference's: it
returns a new ``TrainState`` and leaves the one it was given as it was.
Gradients come from ``torch.autograd.grad`` on detached leaves of the
params; a batch (numpy, as the data pipeline gives it) moves to the
params' device.  The step reads nothing back to the host: its metrics
are [] tensors on the device.

``TrainState.rng`` is the reference's ``jax.random.PRNGKey(seed)``: a
uint32[2] tensor on the CPU, split once a step by threefry-2x32 as
``jax.random.split`` splits it (``split_key``), and never consumed, as
in the reference: a converted state and a checkpoint hold the
reference's key after any number of steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..models import encdec, transformer, vlm
from ..models.config import ModelConfig
from ..optim import (AdamWConfig, EFState, OptState, adamw_init,
                     adamw_update, ef_compress_update, ef_init,
                     cosine_schedule, opt_state_specs)
from ..optim.adamw import copy_dims
from ..optim._tree import leaves, paths, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    ef: Optional[EFState]         # error-feedback residual (compression on)
    rng: torch.Tensor             # uint32[2] on the CPU


@dataclasses.dataclass(frozen=True)
class StepConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compress_grads: bool = False
    warmup_steps: int = 100
    total_steps: int = 10000


# ---------------------------------------------------------------------------
# the reference's PRNG key: threefry-2x32 (jax._src.prng)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1: int, k2: int, x1: int, x2: int) -> tuple[int, int]:
    """The Threefry-2x32 hash of the counter pair (x1, x2) under the key
    (k1, k2): 20 rounds, a key injection every 4."""
    def rotl(v, d):
        return ((v << d) | (v >> (32 - d))) & _M32

    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as JAX gives it without 64-bit mode
    (its default): uint32 [0, seed mod 2**32]."""
    return torch.tensor(np.array([0, int(seed) & _M32], np.uint32))


def split_key(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` under threefry-2x32 with
    ``jax_threefry_partitionable`` on (JAX's default since 0.5): key i is
    the hash of the counter pair (i >> 32, i & 0xFFFFFFFF).  Host
    arithmetic: returns uint32 [num, 2] on the CPU."""
    k1, k2 = (int(v) for v in key.cpu().numpy().astype(np.uint32))
    out = [threefry2x32(k1, k2, i >> 32, i & _M32) for i in range(num)]
    return torch.tensor(np.asarray(out, np.uint32).reshape(num, 2))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def model_loss(cfg: ModelConfig):
    if cfg.encdec is not None:
        return lambda p, batch: encdec.loss_fn(
            p, cfg, batch["frames"], batch["tokens"], batch["labels"])
    if cfg.vlm is not None:
        return lambda p, batch: vlm.loss_fn(
            p, cfg, batch["patches"], batch["tokens"], batch["labels"])
    return lambda p, batch: transformer.loss_fn(
        p, cfg, batch["tokens"], batch["labels"])


def init_train_state(cfg: ModelConfig, params, sc: StepConfig,
                     seed: int = 0) -> TrainState:
    return TrainState(
        params=params,
        opt=adamw_init(params, sc.opt),
        ef=ef_init(params) if sc.compress_grads else None,
        rng=prng_key(seed))


def train_state_specs(cfg: ModelConfig, param_spec_tree,
                      sc: StepConfig) -> TrainState:
    """Logical-dims tree of a ``TrainState`` (the key's dims are the
    reference's; the port keeps the key on the host)."""
    return TrainState(
        params=copy_dims(param_spec_tree),
        opt=opt_state_specs(param_spec_tree, sc.opt),
        ef=EFState(residual=copy_dims(param_spec_tree))
        if sc.compress_grads else None,
        rng=(None,))


def scale_groups(cfg: ModelConfig, params) -> list[list[int]]:
    """The leaves (indices in ``leaves(params)`` order) that the reference
    holds as one tensor stacked on a ``layers`` axis: the same leaf of a
    scanned group's layers at one place of ``cfg.block_pattern``, and of
    every encoder (``enc``) or decoder (``dec``) layer of an
    encoder-decoder.  Int8 compression quantises each such set with one
    scale, as the reference quantises its stacked leaf."""
    head, pat, n_groups, _ = transformer.layer_plan(cfg)
    lo, hi = len(head), len(head) + n_groups * len(pat)
    groups: dict[tuple, list[int]] = {}
    for n, path in enumerate(paths(params)):
        key = path
        if path[0] == "layers" and lo <= path[1] < hi:
            key = ("layers", "group", (path[1] - lo) % len(pat)) + path[2:]
        elif path[0] in ("enc", "dec"):
            key = (path[0],) + path[2:]
        groups.setdefault(key, []).append(n)
    return list(groups.values())


def _on(batch: dict, device: torch.device) -> dict:
    """A batch's arrays as tensors on ``device`` (tensors already there
    are kept)."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, sc: StepConfig):
    loss_fn = model_loss(cfg)
    groups: list = []      # the int8 scales' leaf groups, built once

    def grads_of(params, b):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            total, (ce, _) = loss_fn(unflatten(params, flat), b)
            g = torch.autograd.grad(total, flat)
        return list(g), total.detach(), ce.detach()

    def train_step(state: TrainState, batch):
        flat_p = leaves(state.params)
        batch = _on(batch, flat_p[0].device)
        mb = sc.microbatches

        if mb == 1:
            grads, loss, ce = grads_of(state.params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in flat_p]
            loss = torch.zeros((), device=flat_p[0].device)
            ce = torch.zeros((), device=flat_p[0].device)
            for i in range(mb):
                part = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                        for k, v in batch.items()}
                g, l, c = grads_of(state.params, part)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                loss, ce = loss + l, ce + c
                del g
            grads = [g / mb for g in grads]
            loss, ce = loss / mb, ce / mb
        grads = unflatten(state.params, grads)

        ef = state.ef
        if sc.compress_grads:
            if not groups:
                groups.extend(scale_groups(cfg, state.params))
            grads, ef = ef_compress_update(grads, ef, groups)

        lr = cosine_schedule(state.opt.step + 1, peak_lr=sc.opt.lr,
                             warmup_steps=sc.warmup_steps,
                             total_steps=sc.total_steps)
        params, opt, metrics = adamw_update(grads, state.opt, state.params,
                                            sc.opt, lr)
        rng = split_key(state.rng)[0]
        new_state = TrainState(params=params, opt=opt, ef=ef, rng=rng)
        metrics = dict(metrics, loss=loss, ce=ce)
        return new_state, metrics

    return train_step
