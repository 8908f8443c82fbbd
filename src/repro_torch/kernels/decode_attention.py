"""Single-token GQA decode attention: the CUDA C++ kernel for Hopper and
its plain PyTorch version (port of ``repro.kernels.decode_attention``).

``decode_attention(q, k, v, valid, softcap=, scale=)`` takes one query
token per sequence q ``[b, h, d]``, a KV cache k, v ``[b, s, kv, d]``
and the valid-slot mask ``[b, s]`` (ring buffers have arbitrary valid
patterns) and returns ``[b, h, d]`` in q's dtype.

Dispatch is by device, never by flag: CPU tensors run the plain version
(``ref.decode_attention_ref``); CUDA tensors launch
``csrc/decode_attention.cu`` (built at first use) or raise: a pass over
the keys by the kernel ``decode_plan`` names for the shape, the split
kernel or, for bf16 at g 6-16 and d in ``GROUP_HEAD_DIMS``, the group
kernel, then a merge pass (one wrapper launch).  Each launch adds one to
``LAUNCHES["decode_attention"]`` and one to ``PLANS[plan.kernel]``.  Kernel and plain version agree
to 3e-5 in float32 and 2e-2 in bfloat16 (the reference's bounds).  Like
``flash_attention``, the kernel has no backward: a CUDA call under
autograd with q, k or v requiring grad raises (``refuse_autograd``).

``decode_plan`` is the launch's geometry, computed on the host: the
kernel, how a K/V row is cut into 16-byte chunks over a warp's lanes (the
split kernel), the tile of keys loaded at once, and the split of the keys
that fills the card (see the note at the top of the source).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .flash_attention import (_DTYPES, MAX_HEAD_DIM, _aligned, _cuda_stream,
                              check_qkv, refuse_autograd, refuse_dtensor)
from .ref import decode_attention_ref

#: kernel launches since the last ``reset_launch_counts``
LAUNCHES = {"decode_attention": 0}
#: the same launches by the plan's kernel (``DecodePlan.kernel``)
PLANS = {"split": 0, "group": 0}

_P, _Int = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "da_decode_attention": ([_P] * 8 + [_Int] * 10
                            + [ctypes.c_float, ctypes.c_float, _P], _Int),
    "da_decode_attention_group": ([_P] * 8 + [_Int] * 7
                                  + [ctypes.c_float, ctypes.c_float, _P],
                                  _Int),
    "da_group_tile_keys": ([], _Int),
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
#: the group kernel (``decode_group_kernel``): keys a tile (16 a warp of
#: 4), query heads a CTA at most (one mma M), stages of its K/V ring, the
#: head dims it takes (bf16 only), and the smallest GQA group the plan
#: gives it.  chip_smoke times the other kernel's plan beside every served
#: decode shape (PERF.md): the group kernel is the faster at g 6
#: (mixtral's and internvl2's 48/8) and g 16, the split kernel at gemma2's
#: g 2, whose few long splits walk 34 tiles a group CTA
GROUP_TILE = 64
GROUP_MAX_HEADS = 16
GROUP_STAGES = 3
GROUP_HEAD_DIMS = (64, 128, 256)
GROUP_MIN_G = 6


class DecodePlan(NamedTuple):
    """One launch's geometry (``decode_plan``).  The group kernel has no
    lanes-a-row cut: its ``lpr``, ``vpl`` and ``rows`` are 0."""

    gc: int              # query heads a unit takes (split: 1, 2 or 4,
                         # dividing g; group: all g)
    lpr: int             # lanes a K/V row takes (a power of two <= 32)
    vpl: int             # 16-byte chunks a lane holds of a row (1 or 2)
    rows: int            # rows of K (and of V) a lane loads a tile
    tile: int            # keys loaded at once: rows * 32 / lpr a warp
                         # (split), GROUP_TILE a CTA (group)
    keys_per_split: int  # a multiple of tile
    nsplit: int          # splits of the s keys
    units: int           # split: warps with work, b * nsplit * kv *
                         # (g / gc); group: CTAs, b * kv * nsplit
    ctas: int            # CTAs of the first kernel
    smem_bytes: int      # shared memory a CTA (split: none)
    part_rows: int       # partial (m, l, acc[d]) rows: b * h * nsplit
                         # (group with one split: 0, no merge)
    kernel: str          # "split" or "group"


def group_smem_bytes(d: int) -> int:
    """The group kernel's dynamic shared memory at head dim d (the
    source's ``group_smem_bytes``): Q and the K/V ring."""
    return GROUP_MAX_HEADS * d * 2 + GROUP_STAGES * 2 * GROUP_TILE * d * 2


def group_takes(g: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the group kernel can run this shape at all."""
    return (dtype == torch.bfloat16 and d in GROUP_HEAD_DIMS
            and 1 <= g <= GROUP_MAX_HEADS)


def decode_plan(b: int, s: int, h: int, kv: int, d: int,
                dtype: torch.dtype, n_sm: int = N_SM,
                kernel: str | None = None) -> DecodePlan:
    """The launch's geometry at these shapes (the rules of
    ``csrc/decode_attention.cu``, which refuses any other plan).

    ``kernel`` None picks by shape: the group kernel where it can run and
    g >= GROUP_MIN_G, else the split kernel.  Naming one forces it (the
    group kernel raises ValueError where it cannot run); chip_smoke
    times the other plan beside the chosen one that way.

    Group kernel: one CTA a (batch, kv head, split), all g heads; about
    one CTA an SM (``n_sm // (b * kv)`` splits), each split a multiple of
    GROUP_TILE keys, so a split's partials (g x (d + 2) floats) stay near
    g / 64 of its K/V bytes (a quarter at g 16).

    Split kernel:
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
    if kernel is None:
        kernel = ("group" if group_takes(g, d, dtype) and g >= GROUP_MIN_G
                  else "split")
    if kernel == "group":
        if not group_takes(g, d, dtype):
            raise ValueError(f"decode_attention: the group kernel takes "
                             f"bfloat16 at g <= {GROUP_MAX_HEADS} and d in "
                             f"{GROUP_HEAD_DIMS}, not {dtype} g {g} d {d}")
        units = b * kv
        nsplit = max(1, n_sm // max(units, 1))
        ks = -(-max(-(-s // nsplit), 1) // GROUP_TILE) * GROUP_TILE
        nsplit = max(1, -(-s // ks))
        return DecodePlan(gc=g, lpr=0, vpl=0, rows=0, tile=GROUP_TILE,
                          keys_per_split=ks, nsplit=nsplit,
                          units=units * nsplit, ctas=units * nsplit,
                          smem_bytes=group_smem_bytes(d),
                          part_rows=b * h * nsplit if nsplit > 1 else 0,
                          kernel="group")
    if kernel != "split":
        raise ValueError(f"decode_attention: no kernel {kernel!r}")
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
                      part_rows=b * h * nsplit, kernel="split")


_N_SM: dict[int, int] = {}


def _n_sm(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _N_SM[idx]


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, PLANS):
        for k in counts:
            counts[k] = 0


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
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    return _launch(decode_plan(b, s, h, kv, d, q.dtype, n_sm=_n_sm(q.device)),
                   q, k, v, valid, softcap=softcap, scale=scale)


def _launch(plan: DecodePlan, q, k, v, valid, *, softcap: float,
            scale: float | None) -> torch.Tensor:
    """One launch of ``plan`` on checked CUDA tensors.  ``decode_attention``
    passes the plan ``decode_plan`` picks; chip_smoke also passes the
    other kernel's plan at a shape, to time the two beside each other."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = _cuda_stream("decode_attention", q.device)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        # nothing to attend to: the TPU kernel's acc / max(l, 1e-30) = 0
        return out.zero_()
    lib = _lib()
    valid = valid.contiguous()
    if plan.kernel == "group":      # 16-byte rows by cp.async
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    part_m = torch.empty(plan.part_rows, dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty(plan.part_rows, dtype=torch.float32,
                         device=q.device)
    part_acc = torch.empty(plan.part_rows * d, dtype=torch.float32,
                           device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            out.data_ptr())
    if plan.kernel == "group":
        err = lib.da_decode_attention_group(
            *ptrs, b, s, h, kv, d, plan.keys_per_split, plan.nsplit,
            float(softcap), float(scale), stream)
    else:
        err = lib.da_decode_attention(
            *ptrs, _DTYPES[q.dtype], b, s, h, kv, d, plan.gc, plan.lpr,
            plan.keys_per_split, plan.nsplit, float(softcap), float(scale),
            stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: {plan.kernel} kernel launch "
                           f"failed: {lib.da_error_string(err).decode()} "
                           f"({err})")
    LAUNCHES["decode_attention"] += 1
    PLANS[plan.kernel] += 1
    return out
