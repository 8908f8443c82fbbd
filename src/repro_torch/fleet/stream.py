"""Streamed device→host traces of a sweep (port of ``repro.fleet.stream``).

``Sweep.run`` keeps the whole decimated trace on the device until the
last window — at pod scale that is the memory ceiling, and a preempted
run loses everything.  ``stream_sweep`` runs the SAME staged batch
through the same cached window runner (``experiments._sweep_executable``:
on the card one CUDA-graph replay a trace window), and copies each
window's sample out before the next window overwrites it: into a ring of
``buffer_windows`` host buffers (pinned on the card, the copy queued
behind the window with a CUDA event a slot).  A spiller thread waits on
a slot's event and writes the sample into per-field ``.npy`` spill files
while the card advances the next windows.  The ring is the double
buffer: at most ``buffer_windows`` windows are in flight, so the device
holds one window's sample and host memory stays O(window) until the
spill is read back.

The reference pins its scan's outer depth to 1 to get a one-window
program; the port's runner already runs one window an ``advance()``.

Reassembly transposes the spill ([T, R, ...]) into the [R, T, ...]
layout of ``SweepResult`` exactly like ``Sweep.run`` does — the result
is **bitwise identical** to the in-memory run, every trace field and
the final state (``tests/test_torch_fleet.py``).
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading

import numpy as np
import torch

from ..core.experiments import (Sweep, SweepResult, _sweep_executable,
                                _tree_map)
from ..core.fluid import FluidState, resolve_device
from ..core.simulator import TraceSample
from ..kernels.capture import card_lock


class _Spill:
    """Per-field [T, ...] spill files under one directory."""

    def __init__(self, directory: str, n_samples: int):
        self.directory = directory
        self.n_samples = n_samples
        self._mm: dict[str, np.memmap] = {}
        os.makedirs(directory, exist_ok=True)

    def write(self, t: int, window: dict) -> None:
        for f, v in window.items():
            mm = self._mm.get(f)
            if mm is None:
                mm = np.lib.format.open_memmap(
                    os.path.join(self.directory, f"{f}.npy"), mode="w+",
                    dtype=v.dtype, shape=(self.n_samples,) + v.shape)
                self._mm[f] = mm
            mm[t] = v

    def arrays(self, copy: bool) -> dict[str, np.ndarray]:
        for mm in self._mm.values():
            mm.flush()
        as_array = np.array if copy else np.asarray
        return {f: as_array(mm) for f, mm in self._mm.items()}


def _stream(runner, n_samples: int, spill: _Spill, depth: int,
            cuda: bool) -> None:
    """Advance ``runner`` ``n_samples`` windows, spilling each sample
    through a ring of ``depth`` host buffers; raises what the spiller
    raised."""
    ring: list = [None] * depth
    events = [torch.cuda.Event() if cuda else None for _ in range(depth)]
    free = threading.Semaphore(depth)
    todo: "queue.Queue" = queue.Queue()
    err: list[BaseException] = []

    def spiller():
        while True:
            item = todo.get()
            if item is None:
                return
            t, slot = item
            try:
                if cuda:
                    events[slot].synchronize()
                spill.write(t, {f: b.numpy() for f, b in
                                zip(TraceSample._fields, ring[slot])})
            except BaseException as e:      # surfaced after the loop
                err.append(e)
                return
            free.release()

    th = threading.Thread(target=spiller, name="trace-spiller",
                          daemon=True)
    th.start()
    try:
        for t in range(n_samples):
            sample = runner.advance()
            # the slot of window t - depth is free once it was spilled;
            # a dead spiller must never leave the producer waiting
            while not free.acquire(timeout=0.1):
                if err:
                    break
            if err:
                break
            slot = t % depth
            if ring[slot] is None:
                ring[slot] = [torch.empty(x.shape, dtype=x.dtype,
                                          pin_memory=cuda) for x in sample]
            for b, x in zip(ring[slot], sample):
                b.copy_(x, non_blocking=cuda)
            if cuda:
                events[slot].record()
            todo.put((t, slot))
    finally:
        todo.put(None)
        th.join()
    if err:
        raise err[0]


def stream_sweep(sweep: Sweep, n_steps: int | None = None,
                 trace_every: int | None = None, *,
                 spill_dir: str | None = None,
                 buffer_windows: int = 2,
                 reduce: str = "fused", use_kernels: "bool | str" = False,
                 pad_runs_to: int | None = None,
                 min_delay_slots: int | None = None,
                 dense_rows: int | None = None,
                 temperature: float = 0.0,
                 min_switches: int | None = None,
                 device=None) -> SweepResult:
    """``Sweep.run`` with per-window device→host trace streaming.

    Accepts ``Sweep.run``'s knobs (minus ``mesh``: the fleet scheduler
    is the axis across workers), ``device`` as there (None: the card).
    ``spill_dir`` keeps the raw window spill on disk (the fleet journal
    points there; the result's traces are then views of those files);
    ``None`` spills to a temp dir deleted after reassembly.
    ``buffer_windows`` bounds the windows in flight (the double buffer);
    the producer waits when the spiller falls behind, so streaming can
    throttle but never drop or reorder a window.  The run holds its
    cached window, and on the card the card's lock, until the spiller
    has written the last window.
    """
    if buffer_windows < 1:
        raise ValueError(f"buffer_windows must be >= 1: {buffer_windows}")
    from ..convert import state_to_numpy
    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="sweep_spill_") if spill_dir is None \
        else spill_dir
    try:
        with card_lock(dev):
            static, inp, n_samples = sweep._prepare(
                n_steps, trace_every, mesh=None, reduce=reduce,
                use_kernels=use_kernels, pad_runs_to=pad_runs_to,
                min_delay_slots=min_delay_slots, dense_rows=dense_rows,
                temperature=temperature, min_switches=min_switches,
                device=dev)
            spill = _Spill(tmp, n_samples)
            with _sweep_executable(static, inp) as runner:
                runner.start(inp.state)
                _stream(runner, n_samples, spill, buffer_windows,
                        dev.type == "cuda")
                # a copy: on the CPU numpy shares a tensor's memory, and
                # the entry's state is the next run's
                fin = state_to_numpy(_tree_map(torch.clone, runner.state))
        arrays = spill.arrays(copy=spill_dir is None)
    finally:
        if spill_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)

    R = len(sweep.points)
    traces = TraceSample(**{f: np.moveaxis(arrays[f], 0, 1)[:R]
                            for f in TraceSample._fields})
    final = FluidState(*[x[:R] for x in fin[:-2]],
                       cc={k: v[:R] for k, v in fin.cc.items()},
                       t=fin.t[:R])
    k = static.trace_every
    times = (np.arange(n_samples) + 1) * k * sweep.points[0].cfg.sim.dt
    return SweepResult(points=sweep.points, times=times, traces=traces,
                       final=final, trace_every=k)
