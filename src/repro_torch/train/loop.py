"""Fault-tolerant host training loop (port of ``repro.train.loop``).

  * checkpoint/restart: async atomic saves every N steps
    (``repro_torch.ckpt``, the reference's on-disk layout); on start the
    loop resumes from the latest committed checkpoint including the data
    step (bit-exact),
  * preemption: SIGTERM-style `stop_flag` triggers a final save,
  * straggler detection: per-step wall-time EWMA after 2 warm-up steps;
    steps slower than ``straggler_factor``x the EWMA are counted,
  * elastic restart: restore onto a different mesh via
    ``state_shardings`` (a ``TrainState`` of
    ``repro_torch.dist.sharding.NamedSharding``): the leaves come back as
    DTensors on them, and the steps run under DTensor's implicit
    replication, so the batch (a plain tensor) meets them as replicated.

``float(metrics["loss"])`` is the loop's one host read a step, as in the
reference.  Without ``state_shardings`` a restored state goes to the
device of the state the caller passed.  Either way its key stays a
plain uint32[2] tensor on the CPU (host arithmetic, ``split_key``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from ..ckpt import CheckpointManager, latest_step, load_checkpoint
from ..data import DataConfig, make_batches
from ..optim._tree import leaves
from ..optim.adamw import OptState
from ..optim.compress import EFState
from .step import TrainState

NT_REGISTRY = {"TrainState": TrainState, "OptState": OptState,
               "EFState": EFState}


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    keep_ckpts: int = 3
    straggler_factor: float = 3.0


def restore_state(directory: str, device=None, *,
                  shardings: Optional[TrainState] = None
                  ) -> tuple[TrainState, dict]:
    """The newest loadable checkpoint in ``directory`` as a
    ``TrainState`` on ``device``, or as DTensors on ``shardings`` (its
    key a CPU tensor either way), and its extra."""
    if shardings is not None:
        return load_checkpoint(directory,
                               shardings=shardings._replace(rng=None),
                               nt_registry=NT_REGISTRY)
    state, extra = load_checkpoint(directory, device=device,
                                   nt_registry=NT_REGISTRY)
    return state._replace(rng=state.rng.cpu()), extra


def train_loop(step_fn: Callable, state: TrainState, data_cfg: DataConfig,
               loop_cfg: TrainLoopConfig, *,
               state_shardings: Any = None,
               stop_flag: Optional[Callable[[], bool]] = None,
               on_metrics: Optional[Callable] = None) -> dict:
    """Run training; returns summary metrics."""
    start_step = 0
    if loop_cfg.ckpt_dir and latest_step(loop_cfg.ckpt_dir) is not None:
        state, extra = restore_state(loop_cfg.ckpt_dir,
                                     leaves(state.params)[0].device,
                                     shardings=state_shardings)
        start_step = int(extra["data_step"])
    spmd = contextlib.nullcontext
    if state_shardings is not None:
        from torch.distributed.tensor.experimental import \
            implicit_replication as spmd

    mgr = (CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep_ckpts)
           if loop_cfg.ckpt_dir else None)

    losses, step_times = [], []
    ewma = None
    stragglers = 0
    it = make_batches(data_cfg, start_step)
    final_step = start_step

    for step, batch in it:
        if step >= loop_cfg.total_steps:
            break
        t0 = time.perf_counter()
        with spmd():
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        step_times.append(dt)
        losses.append(loss)
        final_step = step + 1

        # straggler detection (EWMA of steady-state step time)
        if step - start_step >= 2:      # skip warm-up steps
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > loop_cfg.straggler_factor * ewma:
                stragglers += 1

        if on_metrics and step % loop_cfg.log_every == 0:
            on_metrics(step, dict(metrics, step_time=dt))

        if mgr and (step + 1) % loop_cfg.ckpt_every == 0:
            mgr.save_async(step + 1, state, extra={"data_step": step + 1})

        if stop_flag and stop_flag():
            if mgr:
                mgr.save_async(step + 1, state,
                               extra={"data_step": step + 1})
            break

    if mgr:
        mgr.wait()
    return {
        "final_step": final_step,
        "losses": np.asarray(losses),
        "mean_step_time": float(np.mean(step_times)) if step_times else 0.0,
        "stragglers": stragglers,
        "state": state,
    }
