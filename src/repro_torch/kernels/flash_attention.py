"""Blockwise fused attention (forward): the CUDA C++ kernel for Hopper and
its plain PyTorch version (port of ``repro.kernels.flash_attention``).

``flash_attention(q, k, v, causal=, window=, softcap=, scale=)`` takes
q ``[b, t, h, d]`` and k, v ``[b, s, kv, d]`` (GQA: h = kv * g) in
float32 or bfloat16 and returns ``[b, t, h, d]`` in q's dtype; m, l and
the accumulator are float32.  Causal and sliding-window masks compare
positions (the window keeps ``kpos > qpos - window``), the softcap is
``tanh(x / cap) * cap`` after the scale and before the mask.

Dispatch is by device, never by flag: CPU tensors run the plain version
(``ref.attention_ref``); CUDA tensors launch a kernel of
``csrc/flash_attention.cu`` (built at first use) or raise.  Which kernel
is decided by ``_route(dtype, d)`` alone: bfloat16 at d in
``TC_HEAD_DIMS`` takes the tensor-core kernel (``wgmma`` fed by a TMA
ring), everything else the CUDA-core kernel.  There is no fallback
between the two: a tensor-core call that cannot build, is refused or
fails to launch raises.  Each launch adds one to
``LAUNCHES["flash_attention"]`` and one to ``ROUTES[route]``.  The
kernels sum in another order than the plain version's einsum and
softmax, so they agree to a tolerance, not to the bit: 3e-5 in float32,
2e-2 in bfloat16 (the reference's own bounds, ``tests/test_kernels.py``).

The kernels have no backward, as the reference's Pallas kernels have
none: on a CUDA tensor, a call under autograd with q, k or v requiring
grad raises (``refuse_autograd``) instead of returning an output that
drops the gradient.  The CPU branch (the plain version) differentiates,
as the reference's ``ref`` backend does.  Training runs attention with
``cfg.use_pallas=False``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .ref import attention_ref

#: kernel launches since the last ``reset_launch_counts``
LAUNCHES = {"flash_attention": 0}
#: the same launches by route (``_route``)
ROUTES = {"tensor_core": 0, "cuda_core": 0}

#: the largest head_dim the kernels take: the CUDA-core kernel's widest
#: bucket holds 64 rows of Q, three 32-key K/V slots and P in float32 in
#: shared memory at this width
MAX_HEAD_DIM = 256
#: head_dims of the tensor-core kernels (bfloat16 only): one, two or four
#: 64-column swizzled panels a row.  At 256 a consumer thread's float32
#: O takes 128 registers, so that width runs 64-key K/V tiles (S in 32
#: registers) where 64 and 128 run 128-key tiles (``bk_of`` in the
#: source); 128 launches its own kernel, a persistent grid that runs the
#: softmax beside the products (``flash_tc128_kernel``)
TC_HEAD_DIMS = (64, 128, 256)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _Int = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fa_flash_attention": ([_P, _P, _P, _P] + [_Int] * 9
                           + [ctypes.c_float, ctypes.c_float, _P], _Int),
    "fa_flash_attention_tc": ([_P, _P, _P, _P] + [_Int] * 8
                              + [ctypes.c_float, ctypes.c_float, _P], _Int),
    "fa_max_head_dim": ([], _Int),
    "fa_smem_bytes": ([_Int], ctypes.c_longlong),
    "fa_error_string": ([_Int], ctypes.c_char_p),
}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def _route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call takes: "tensor_core" for bfloat16 at d in
    ``TC_HEAD_DIMS`` (gemma2's 128, recurrentgemma's 256), else
    "cuda_core" (float32 at any d stays off TF32 tensor cores, which
    would break its 3e-5 bound; bf16 at the smoke configs' narrow d)."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (TMA and the
    kernels' 16-byte loads need it); a fresh allocation always is."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _lib():
    from .build import load
    lib = load("flash_attention", _SIGNATURES)
    if lib.fa_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("flash_attention: the library's head_dim limit "
                           f"{lib.fa_max_head_dim()} != {MAX_HEAD_DIM}")
    return lib


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None, softcap: float = 0.0,
                          scale: float | None = None) -> torch.Tensor:
    """Plain version: the untiled definition (``ref.attention_ref``)."""
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


def check_qkv(name: str, q, k, v) -> None:
    """Shapes, dtypes and devices the attention kernels take."""
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: k, v must be [b, s, kv, d] of one shape, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    b, d, kv = q.shape[0], q.shape[-1], k.shape[2]
    h = q.shape[-2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head_dim")
    if kv < 1 or h % kv:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{kv} kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} is outside 1..{MAX_HEAD_DIM}"
                         f" (MAX_HEAD_DIM), the widths the kernel takes")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for x in (k, v):
        if x.device != q.device:
            raise ValueError(f"{name}: tensors on {x.device} and {q.device}")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where a kernel would drop a gradient: autograd is on and an
    input requires grad.  The CUDA kernels write their output through
    raw pointers, so it would have no ``grad_fn``."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and the reference "
            f"cannot differentiate its Pallas kernels either; run attention "
            f"with use_pallas=False to train (the plain path "
            f"differentiates), or call it under torch.no_grad()")


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise on a DTensor: the kernels read ``data_ptr()`` of a local
    tensor, and on a sharded path (a model under ``set_mesh``) attention
    takes the plain route, as the reference's dry run sets
    ``use_pallas=False``.  Neither the kernel nor its plain version runs
    in its place."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(x, DTensor) for x in tensors):
        raise TypeError(
            f"{name}: given a DTensor; a sharded model runs attention on "
            f"the plain route (cfg.use_pallas=False: the model's _mha / "
            f"_blockwise_attn), never through the kernels")


def _cuda_stream(name: str, dev: torch.device) -> int:
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(dev).cuda_stream


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """q: [b, t, h, d]; k, v: [b, s, kv, d] -> [b, t, h, d] in q's dtype."""
    refuse_dtensor("flash_attention", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [b, t, h, d], got "
                         f"{tuple(q.shape)}")
    check_qkv("flash_attention", q, k, v)
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel or plain version for "
                         f"device {q.device}")
    refuse_autograd("flash_attention", q, k, v)
    return _launch(_route(q.dtype, q.shape[-1]), q, k, v, causal=causal,
                   window=window, softcap=softcap, scale=scale)


def _launch(route: str, q, k, v, *, causal: bool, window: int | None,
            softcap: float, scale: float | None) -> torch.Tensor:
    """One launch of ``route``'s kernel on checked CUDA tensors.
    ``flash_attention`` passes ``_route``'s choice; the CUDA-core kernel
    also takes bf16 at a tensor-core width when named here, which is how
    chip_smoke times the two routes at one shape.  The tensor-core kernel
    refuses a d outside ``TC_HEAD_DIMS`` (it raises)."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = _cuda_stream("flash_attention", q.device)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:            # nothing to launch, nothing counted
        return out
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (b, t, s, h, kv, d, int(causal),
             -1 if window is None else int(window), float(softcap),
             float(scale), stream)
    if route == "tensor_core":
        err = lib.fa_flash_attention_tc(*args, *shape)
    else:
        err = lib.fa_flash_attention(*args, _DTYPES[q.dtype], *shape)
    if err != 0:
        raise RuntimeError(f"flash_attention: {route} kernel launch failed: "
                           f"{lib.fa_error_string(err).decode()} ({err})")
    LAUNCHES["flash_attention"] += 1
    ROUTES[route] += 1
    return out

