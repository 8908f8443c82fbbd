"""Single-token GQA decode attention: the CUDA C++ kernel for Hopper and
its plain PyTorch version (port of ``repro.kernels.decode_attention``).

``decode_attention(q, k, v, valid, softcap=, scale=)`` takes one query
token per sequence q ``[b, h, d]``, a KV cache k, v ``[b, s, kv, d]``
and the valid-slot mask ``[b, s]`` (ring buffers have arbitrary valid
patterns) and returns ``[b, h, d]`` in q's dtype.

Dispatch is by device, never by flag: CPU tensors run the plain version
(``ref.decode_attention_ref``); CUDA tensors launch
``csrc/decode_attention.cu`` (a split pass over the keys and a merge
pass, one wrapper launch; built at first use) or raise.  Each launch adds
one to ``LAUNCHES["decode_attention"]``.  Kernel and plain version agree
to 3e-5 in float32 and 2e-2 in bfloat16 (the reference's bounds).  Like
``flash_attention``, the kernel has no backward: a CUDA call under
autograd with q, k or v requiring grad raises (``refuse_autograd``).

``decode_plan`` is the launch's geometry, computed on the host: how a
K/V row is cut into 16-byte chunks over a warp's lanes, the tile of keys
a warp loads at once, and the split of the keys that fills the card
(see the note at the top of the source).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .flash_attention import (_DTYPES, MAX_HEAD_DIM, _cuda_stream, check_qkv,
                              refuse_autograd, refuse_dtensor)
from .ref import decode_attention_ref

#: kernel launches since the last ``reset_launch_counts``
LAUNCHES = {"decode_attention": 0}

_P, _Int = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "da_decode_attention": ([_P] * 8 + [_Int] * 10
                            + [ctypes.c_float, ctypes.c_float, _P], _Int),
    "da_max_head_dim": ([], _Int),
    "da_tile_keys": ([_Int, _Int, _Int], _Int),
    "da_error_string": ([_Int], ctypes.c_char_p),
}

#: warps a CTA of the split kernel (``WPC`` in the source) and the CTAs
#: of it an SM holds at once (``__launch_bounds__(256, 2)``)
WARPS_PER_CTA = 8
CTAS_PER_SM = 2
#: SMs of an H100 SXM: the plan's default (the wrapper asks the card)
N_SM = 132
#: bytes a lane loads at once
CHUNK_BYTES = 16


class DecodePlan(NamedTuple):
    """One launch's geometry (``decode_plan``)."""

    gc: int              # query heads a warp takes (1, 2 or 4; divides g)
    lpr: int             # lanes a K/V row takes (a power of two <= 32)
    vpl: int             # 16-byte chunks a lane holds of a row (1 or 2)
    rows: int            # rows of K (and of V) a lane loads a tile
    tile: int            # keys a warp loads at once: rows * 32 / lpr
    keys_per_split: int  # a multiple of tile
    nsplit: int          # splits of the s keys
    units: int           # warps with work: b * nsplit * kv * (g / gc)
    ctas: int            # CTAs of the split kernel
    smem_bytes: int      # shared memory a CTA: none, all in registers
    part_rows: int       # partial (m, l, acc[d]) rows: b * h * nsplit


def decode_plan(b: int, s: int, h: int, kv: int, d: int,
                dtype: torch.dtype, n_sm: int = N_SM) -> DecodePlan:
    """The split kernel's geometry at these shapes (the rules of
    ``csrc/decode_attention.cu``, which refuses any other plan).

    A row of d elements is cut into 16-byte chunks; ``lpr`` lanes (the
    chunk count rounded up to a power of two, at most 32) take one row,
    each ``vpl`` chunks of it, so a warp covers ``32 / lpr`` keys a
    load and ``tile`` keys with the ``rows`` loads a lane issues before
    it uses any.  A warp is one unit of (batch, split, kv head, chunk of
    ``gc`` query heads).  The split length is the key count that gives
    at most ``n_sm * CTAS_PER_SM * WARPS_PER_CTA`` units (every SM's
    resident warps once), rounded up to a multiple of the tile: the
    units fill one wave (or, where b * kv * g / gc is more, take one
    split each)."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {d} outside 1.."
                         f"{MAX_HEAD_DIM} (MAX_HEAD_DIM)")
    if kv < 1 or h % kv:
        raise ValueError(f"decode_attention: {h} query heads are not a "
                         f"multiple of {kv} kv heads")
    g = h // kv
    gc = 4 if g % 4 == 0 else 2 if g % 2 == 0 else 1
    vec = CHUNK_BYTES // torch.empty((), dtype=dtype).element_size()
    nch = -(-d // vec)
    lpr = 1
    while lpr < nch and lpr < 32:
        lpr *= 2
    vpl = -(-nch // 32)
    rows = (4 if gc >= 2 else 8) // vpl
    tile = rows * 32 // lpr
    per_split = b * kv * (g // gc)
    want = n_sm * CTAS_PER_SM * WARPS_PER_CTA
    nsplit = max(1, want // max(per_split, 1))
    ks = -(-max(-(-s // nsplit), 1) // tile) * tile
    nsplit = max(1, -(-s // ks))
    units = per_split * nsplit
    return DecodePlan(gc=gc, lpr=lpr, vpl=vpl, rows=rows, tile=tile,
                      keys_per_split=ks, nsplit=nsplit, units=units,
                      ctas=-(-units // WARPS_PER_CTA), smem_bytes=0,
                      part_rows=b * h * nsplit)


_N_SM: dict[int, int] = {}


def _n_sm(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _N_SM[idx]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from .build import load
    lib = load("decode_attention", _SIGNATURES)
    if lib.da_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("decode_attention: the library's head_dim limit "
                           f"{lib.da_max_head_dim()} != {MAX_HEAD_DIM}")
    return lib


def decode_attention_plain(q, k, v, valid, *, softcap: float = 0.0,
                           scale: float | None = None) -> torch.Tensor:
    """Plain version: the untiled definition
    (``ref.decode_attention_ref``)."""
    return decode_attention_ref(q, k, v, valid, softcap=softcap,
                                scale=scale)


def decode_attention(q, k, v, valid, *, softcap: float = 0.0,
                     scale: float | None = None) -> torch.Tensor:
    """q: [b, h, d]; k, v: [b, s, kv, d]; valid: [b, s] -> [b, h, d]."""
    refuse_dtensor("decode_attention", q, k, v, valid)
    if q.dim() != 3:
        raise ValueError(f"decode_attention: q must be [b, h, d], got "
                         f"{tuple(q.shape)}")
    check_qkv("decode_attention", q, k, v)
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if tuple(valid.shape) != (b, s) or valid.dtype != torch.bool:
        raise ValueError(f"decode_attention: valid must be [{b}, {s}] bool, "
                         f"got {tuple(valid.shape)} {valid.dtype}")
    if valid.device != q.device:
        raise ValueError(f"decode_attention: valid on {valid.device}, q on "
                         f"{q.device}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, valid, softcap=softcap,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel or plain version for "
                         f"device {q.device}")
    refuse_autograd("decode_attention", q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = _cuda_stream("decode_attention", q.device)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        # nothing to attend to: the TPU kernel's acc / max(l, 1e-30) = 0
        return out.zero_()
    lib = _lib()
    plan = decode_plan(b, s, h, kv, d, q.dtype, n_sm=_n_sm(q.device))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    valid = valid.contiguous()
    part_m = torch.empty(plan.part_rows, dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty(plan.part_rows, dtype=torch.float32,
                         device=q.device)
    part_acc = torch.empty(plan.part_rows * d, dtype=torch.float32,
                           device=q.device)
    err = lib.da_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], b, s, h, kv, d, plan.gc, plan.lpr,
        plan.keys_per_split, plan.nsplit, float(softcap), float(scale),
        stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed: "
                           f"{lib.da_error_string(err).decode()} ({err})")
    LAUNCHES["decode_attention"] += 1
    return out
