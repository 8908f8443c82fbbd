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
"""

from __future__ import annotations

import ctypes

import torch

#: kernel launches since the last ``reset_launch_counts``
LAUNCHES = {"segment_reduce": 0}

_P, _I = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "fr_segment_reduce": ([_P, _P, _P, _I, _I, _P, _P], ctypes.c_int),
    "fr_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


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


def _launch(data, offsets, rows) -> torch.Tensor:
    dev = data.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"segment_reduce: tensors on {dev} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    S, C = offsets.shape[0] - 1, data.shape[1]
    data = data.contiguous()
    offsets = offsets.contiguous()
    rows = None if rows is None else rows.contiguous()
    out = torch.empty((S, C), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fr_segment_reduce(
        data.data_ptr(), None if rows is None else rows.data_ptr(),
        offsets.data_ptr(), S, C, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_reduce: kernel launch failed: "
                           f"{lib.fr_error_string(err).decode()} ({err})")
    LAUNCHES["segment_reduce"] += 1
    return out


def segment_reduce(data: torch.Tensor, seg: torch.Tensor | None,
                   num_segments: int, *, rows: torch.Tensor | None = None,
                   offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-channel sorted segment sum: [N, C] + [N] ids -> [S, C].

    ``seg`` must be ascending; equal-id rows are added in row order.
    ``offsets`` ([S + 1] int64 CSR offsets of ``seg``) may replace
    ``seg`` (pass ``seg=None``); ``rows`` ([N] int64) gathers the walk
    from an unsorted ``data`` (entry j reads ``data[rows[j]]``).
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
    return _launch(data, offsets, rows)
