"""Sorted multi-channel segment sum: the CUDA C++ kernel for Hopper and
its plain PyTorch version (port of ``repro.kernels.fluid_reduce``).

``segment_reduce(data, seg, num_segments)`` sums the rows of ``data``
([N, C] float32) into ``num_segments`` segments by their ascending ids
``seg`` ([N]); each segment's rows are added in row order from +0.0, the
order of the reference's sequential scatter, so every engine of the
fluid step that uses it is bitwise equal to the others.  The fluid step
passes the segment CSR offsets it built once (``offsets``) and the
gather into sorted order (``rows``), so no sort or gather runs per call.

Dispatch is by device, never by flag: CPU tensors run the plain version
below (a gather into a [rows, segments, C] table added row by row, the
port's ordered walk; never ``index_add_``, which is unordered on CUDA);
CUDA tensors launch ``csrc/fluid_reduce.cu`` (built at first use) or
raise.  Each launch adds one to ``LAUNCHES["segment_reduce"]``.

On the card the kernel walks a ``ReduceSchedule`` (``reduce_schedule``):
every segment longer than ``LONG_ROWS`` rows gets a CTA of its own, the
rest are packed into groups of consecutive segments that one CTA stages
in shared memory.  The schedule depends on the offsets alone, so the
fluid step builds it once per batch (``ReducePlan.seg_sched``) and every
walk over that CSR shares it; a call without one builds it on the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

#: kernel launches since the last ``reset_launch_counts``
LAUNCHES = {"segment_reduce": 0}

#: a segment of more rows than this is a long one: a CTA of its own
LONG_ROWS = 256
#: rows a short group stages in shared memory (``kChunkRows`` in the
#: source) and segments it may hold, one thread each (``kGroupSegs``)
CHUNK_ROWS = 2048
GROUP_SEGS = 256
#: channel counts the staged kernel is built for; others take the row walk
STAGED_CHANNELS = (1, 2, 3)

_P, _I = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "fr_segment_reduce": ([_P, _P, _P, _I, _P, _P, _I, _I, _P, _P],
                          ctypes.c_int),
    "fr_segment_reduce_rowwalk": ([_P, _P, _P, _I, _I, _P, _P],
                                  ctypes.c_int),
    # clocks of n dependent adds in one thread (x, n, clocks, sum, stream)
    "fr_fadd_clocks": ([_P, _I, _P, _P, _P], ctypes.c_int),
    "fr_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


class ReduceSchedule(NamedTuple):
    """The kernel's work items over one CSR, one CTA each.

    ``items[b] = (first, end, walk_first, walk_end)``: segments
    ``first .. end`` over walk entries ``offsets[first] ..
    offsets[end]``.  ``items[:n_long]`` are the long segments (``end =
    first + 1``), in segment order, so they start first; the rest are
    groups of consecutive short segments, each at most ``CHUNK_ROWS``
    rows and ``GROUP_SEGS`` segments.  Every segment is in exactly one
    item.  ``lanes[first + p]`` is the segment (from ``first``) that lane
    p of a group sums: the group's segments longest first."""

    items: torch.Tensor      # [n_items, 4] int32
    lanes: torch.Tensor      # [S] uint8
    n_long: int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from .build import load
    return load("fluid_reduce", _SIGNATURES)


def csr_offsets(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[num_segments + 1] int64 offsets of ascending ids ``seg``."""
    return torch.searchsorted(
        seg.to(torch.int64),
        torch.arange(num_segments + 1, dtype=torch.int64,
                     device=seg.device))


def reduce_schedule(offsets: torch.Tensor | np.ndarray,
                    device=None) -> ReduceSchedule:
    """The ``ReduceSchedule`` of CSR ``offsets`` ([S + 1], ascending),
    built on the host (a card tensor is copied back: one sync), on
    ``device`` (default: the offsets' device)."""
    if isinstance(offsets, torch.Tensor):
        device = offsets.device if device is None else device
        offsets = offsets.cpu().numpy()
    off = np.asarray(offsets, np.int64)
    lens = np.diff(off)
    if lens.size and lens.min() < 0:
        raise ValueError("reduce_schedule: offsets must be ascending")
    long_ids = np.flatnonzero(lens > LONG_ROWS)
    spans = [(s, s + 1) for s in long_ids.tolist()]
    first, rows = -1, 0
    for s, n in enumerate(lens.tolist()):
        if n > LONG_ROWS:
            if first >= 0:
                spans.append((first, s))
            first = -1
            continue
        if first >= 0 and (rows + n > CHUNK_ROWS
                           or s - first == GROUP_SEGS):
            spans.append((first, s))
            first = -1
        if first < 0:
            first, rows = s, 0
        rows += n
    if first >= 0:
        spans.append((first, lens.size))
    spans = np.asarray(spans, np.int64).reshape(-1, 2)
    items = np.concatenate([spans, off[spans]], axis=1).astype(np.int32)
    # each group's segments longest first (ties in segment order)
    lanes = np.zeros(lens.size, np.uint8)
    groups = spans[len(long_ids):]
    if groups.size:
        gid = np.repeat(np.arange(len(groups)), groups[:, 1] - groups[:, 0])
        segs = np.concatenate([np.arange(a, b) for a, b in groups])
        order = segs[np.lexsort((segs, -lens[segs], gid))]
        lanes[segs] = order - np.repeat(groups[:, 0],
                                        groups[:, 1] - groups[:, 0])
    items_t, lanes_t = torch.from_numpy(items), torch.from_numpy(lanes)
    if device is not None:
        items_t, lanes_t = items_t.to(device), lanes_t.to(device)
    return ReduceSchedule(items_t, lanes_t, len(long_ids))


def segment_reduce_plain(data: torch.Tensor, offsets: torch.Tensor,
                         rows: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: ``[S, C]`` sums of the CSR walk over ``data``.

    Position p of segment s reads walk entry ``offsets[s] + p`` (row
    ``rows[...]`` of ``data``) or, past the segment's end, an all-zero
    row; the positions are added one by one from +0.0, so each segment
    sums its rows in order (a trailing +0.0 changes no sum that starts
    from +0.0)."""
    S, C = offsets.shape[0] - 1, data.shape[1]
    if S <= 0:
        return data.new_zeros((max(S, 0), C))
    srt = data if rows is None else data[rows]
    lens = offsets[1:] - offsets[:-1]
    P = int(lens.max())
    ext = torch.cat([srt, srt.new_zeros((1, C))])
    pos = torch.arange(P, dtype=torch.int64, device=data.device)[:, None]
    src = torch.where(pos < lens[None], offsets[None, :-1] + pos,
                      srt.shape[0])                       # [P, S]
    dense = ext[src]                                      # [P, S, C]
    acc = data.new_zeros((S, C))
    for p in range(P):
        acc = acc + dense[p]
    return acc


def _check(data, offsets, rows):
    if data.dim() != 2 or data.dtype != torch.float32:
        raise ValueError(f"segment_reduce: data must be [N, C] float32, got "
                         f"{tuple(data.shape)} {data.dtype}")
    for name, x in (("offsets", offsets), ("rows", rows)):
        if x is None:
            continue
        if x.dim() != 1 or x.dtype != torch.int64:
            raise ValueError(f"segment_reduce: {name} must be 1-d int64")
        if x.device != data.device:
            raise ValueError(f"segment_reduce: {name} on {x.device}, data "
                             f"on {data.device}")
    n_walk = data.shape[0] if rows is None else rows.shape[0]
    return n_walk


def _fits_staged(data, offsets, rows) -> bool:
    """The staged kernel takes C in STAGED_CHANNELS and 32-bit indices."""
    S, C = offsets.shape[0] - 1, data.shape[1]
    n_walk = data.shape[0] if rows is None else rows.shape[0]
    return (C in STAGED_CHANNELS
            and max(data.numel(), n_walk, S * C) < 2 ** 31)


def _prepare(data, offsets, rows):
    dev = data.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"segment_reduce: tensors on {dev} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    out = torch.empty((offsets.shape[0] - 1, data.shape[1]),
                      dtype=torch.float32, device=dev)
    return (data.contiguous(), offsets.contiguous(),
            None if rows is None else rows.contiguous(), out,
            torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(lib, err):
    if err != 0:
        raise RuntimeError(f"segment_reduce: kernel launch failed: "
                           f"{lib.fr_error_string(err).decode()} ({err})")


def _launch(data, offsets, rows, schedule: ReduceSchedule) -> torch.Tensor:
    data, offsets, rows, out, stream = _prepare(data, offsets, rows)
    items, lanes = schedule.items, schedule.lanes
    if (items.dtype != torch.int32 or items.dim() != 2
            or items.shape[1] != 4 or lanes.dtype != torch.uint8
            or lanes.shape != (out.shape[0],)
            or items.device != data.device or lanes.device != data.device):
        raise ValueError(f"segment_reduce: the schedule must be [n, 4] "
                         f"int32 items and [{out.shape[0]}] uint8 lanes on "
                         f"{data.device}")
    lib = _lib()
    _raise_on(lib, lib.fr_segment_reduce(
        data.data_ptr(), None if rows is None else rows.data_ptr(),
        offsets.data_ptr(), data.shape[1], items.contiguous().data_ptr(),
        lanes.contiguous().data_ptr(), items.shape[0], schedule.n_long,
        out.data_ptr(), stream))
    LAUNCHES["segment_reduce"] += 1
    return out


def segment_reduce_rowwalk(data: torch.Tensor, offsets: torch.Tensor,
                           rows: torch.Tensor | None = None) -> torch.Tensor:
    """The row walk on the card (one thread a segment and channel, two
    dependent global loads a row): the staged kernel's fallback for
    other channel counts and 64-bit sizes, and its yardstick."""
    n_walk = _check(data, offsets, rows)
    if data.device.type != "cuda":
        raise ValueError("segment_reduce_rowwalk: CUDA tensors only")
    if n_walk == 0 or offsets.shape[0] <= 1 or data.shape[1] == 0:
        return torch.zeros((max(offsets.shape[0] - 1, 0), data.shape[1]),
                           dtype=torch.float32, device=data.device)
    data, offsets, rows, out, stream = _prepare(data, offsets, rows)
    lib = _lib()
    _raise_on(lib, lib.fr_segment_reduce_rowwalk(
        data.data_ptr(), None if rows is None else rows.data_ptr(),
        offsets.data_ptr(), out.shape[0], out.shape[1], out.data_ptr(),
        stream))
    LAUNCHES["segment_reduce"] += 1
    return out


def segment_reduce(data: torch.Tensor, seg: torch.Tensor | None,
                   num_segments: int, *, rows: torch.Tensor | None = None,
                   offsets: torch.Tensor | None = None,
                   schedule: ReduceSchedule | None = None) -> torch.Tensor:
    """Multi-channel sorted segment sum: [N, C] + [N] ids -> [S, C].

    ``seg`` must be ascending; equal-id rows are added in row order.
    ``offsets`` ([S + 1] int64 CSR offsets of ``seg``) may replace
    ``seg`` (pass ``seg=None``); ``rows`` ([N] int64) gathers the walk
    from an unsorted ``data`` (entry j reads ``data[rows[j]]``).
    ``schedule`` (``reduce_schedule(offsets)``) is the card's work list;
    without one a card call builds it (a host sync).  The CPU ignores it.
    """
    if offsets is None:
        if seg is None:
            raise ValueError("segment_reduce: pass seg or offsets")
        offsets = csr_offsets(seg, num_segments)
    if offsets.shape[0] != num_segments + 1:
        raise ValueError(f"segment_reduce: offsets has {offsets.shape[0]} "
                         f"entries for {num_segments} segments")
    n_walk = _check(data, offsets, rows)
    if data.device.type == "cpu":
        return segment_reduce_plain(data, offsets, rows)
    if data.device.type != "cuda":
        raise ValueError(f"segment_reduce: no kernel or plain version for "
                         f"device {data.device}")
    if n_walk == 0 or num_segments == 0 or data.shape[1] == 0:
        # nothing to walk: exact zeros, nothing launched or counted
        return torch.zeros((num_segments, data.shape[1]),
                           dtype=torch.float32, device=data.device)
    if not _fits_staged(data, offsets, rows):
        return segment_reduce_rowwalk(data, offsets, rows)
    if schedule is None:
        schedule = reduce_schedule(offsets)
    return _launch(data, offsets, rows, schedule)
