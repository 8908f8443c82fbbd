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
to 3e-5 in float32 and 2e-2 in bfloat16 (the reference's bounds).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .flash_attention import _DTYPES, MAX_HEAD_DIM, _cuda_stream, check_qkv
from .ref import decode_attention_ref

#: kernel launches since the last ``reset_launch_counts``
LAUNCHES = {"decode_attention": 0}

_P, _Int = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "da_decode_attention": ([_P] * 8 + [_Int] * 6
                            + [ctypes.c_float, ctypes.c_float, _P], _Int),
    "da_parts": ([_Int], _Int),
    "da_max_head_dim": ([], _Int),
    "da_smem_bytes": ([_Int, _Int], ctypes.c_longlong),
    "da_error_string": ([_Int], ctypes.c_char_p),
}

#: dynamic shared memory a CTA may take on Hopper (227 KB)
SMEM_CAP = 232448


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
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = _cuda_stream("decode_attention", q.device)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        # nothing to attend to: the TPU kernel's acc / max(l, 1e-30) = 0
        return out.zero_()
    lib = _lib()
    g = h // kv
    smem = lib.da_smem_bytes(g, d)
    if smem > SMEM_CAP:
        raise ValueError(f"decode_attention: g={g}, head_dim={d} needs "
                         f"{smem} B of shared memory > SMEM_CAP {SMEM_CAP}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    valid = valid.contiguous()
    n = b * kv * lib.da_parts(s) * g
    part_m = torch.empty(n, dtype=torch.float32, device=q.device)
    part_l = torch.empty(n, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(n * d, dtype=torch.float32, device=q.device)
    err = lib.da_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], b, s, h, kv, d, float(softcap),
        float(scale), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed: "
                           f"{lib.da_error_string(err).decode()} ({err})")
    LAUNCHES["decode_attention"] += 1
    return out
