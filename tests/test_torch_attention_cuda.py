"""The attention designs for the served shapes on a card: flash
attention's tensor-core route at bf16, head_dim 256 (recurrentgemma-9b)
and head_dim 128 (the persistent, pipelined kernel: deepseek-moe-16b,
internvl2-26b, mixtral-8x22b, gemma2-27b), and decode attention's group
kernel (g 6-16), each against its plain version run in float32 on the
same values at the reference's bfloat16 bound, 2e-2.  Every test here
needs a CUDA device and skips without one; the file imports no JAX (the
CPU models of the kernels are in ``tests/test_torch_attention_group.py``
and ``tests/test_torch_flash_tc_walk.py``).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

DA = importlib.import_module("repro_torch.kernels.decode_attention")
FA = importlib.import_module("repro_torch.kernels.flash_attention")
TOL = dict(atol=2e-2, rtol=2e-2)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda", torch.cuda.current_device())


def _bf16(dev, seed, *shapes, sd=(0.3, 0.3, 1.0)):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*sh).astype(np.float32) * s).to(
        dev, torch.bfloat16) for sh, s in zip(shapes, sd)]


def _close(got, want):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL)


#: (b, t, h, kv, d, causal, window, cap): recurrentgemma's heads under
#: its window, causal and not, softcaps 0 and 50, a ragged t, t shorter
#: than one 64-key tile, and a window that skips whole tiles
TC256_CASES = [
    (2, 2048, 16, 1, 256, True, 2048, 0.0),
    (1, 300, 16, 1, 256, True, None, 50.0),
    (1, 333, 8, 2, 256, False, None, 0.0),
    (2, 40, 16, 1, 256, True, None, 0.0),
    (1, 520, 16, 1, 256, True, 100, 50.0),
    (1, 97, 4, 4, 256, True, 48, 2.0),
]


@pytest.mark.cuda
def test_tensor_core_route_at_d256_on_cuda():
    """bf16 at d 256 takes the tensor-core kernel (every launch counted
    there), within 2e-2 of the plain version, two launches bitwise
    equal; the CUDA-core kernel at the same inputs agrees too."""
    dev = _cuda()
    FA.reset_launch_counts()
    for i, (b, t, h, kv, d, causal, window, cap) in enumerate(TC256_CASES):
        sd = 2.0 if cap else 1.5
        q, k, v = _bf16(dev, i, (b, t, h, d), (b, t, kv, d), (b, t, kv, d),
                        sd=(sd, sd, 1.0))
        kw = dict(causal=causal, window=window, softcap=cap)
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                        **kw)
        torch.cuda.synchronize()
        _close(got, want)
        assert torch.equal(got, FA.flash_attention(q, k, v, **kw))
    n = 2 * len(TC256_CASES)
    assert FA.ROUTES == {"tensor_core": n, "cuda_core": 0}
    q, k, v = _bf16(dev, 9, (1, 200, 16, 256), (1, 200, 1, 256),
                    (1, 200, 1, 256))
    cc = FA._launch("cuda_core", q, k, v, causal=True, window=64,
                    softcap=0.0, scale=None)
    _close(cc, FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                        window=64))
    assert FA.ROUTES == {"tensor_core": n, "cuda_core": 1}


#: (b, t, h, kv, window, cap): the d 128 kernel at deepseek-moe-16b's
#: heads (16/16) and internvl2-26b's (48/8) at t 2048, causal, and a
#: ragged t 200 under a window of 64 with softcap 50 at both groupings
TC128_CASES = [
    (2, 2048, 16, 16, None, 0.0),
    (2, 2048, 48, 8, None, 0.0),
    (1, 200, 16, 16, 64, 50.0),
    (1, 200, 48, 8, 64, 50.0),
]


@pytest.mark.cuda
def test_tensor_core_route_at_d128_on_cuda():
    """bf16 at d 128 takes the tensor-core kernel (every launch counted
    there, none on the CUDA-core route), within 2e-2 of the plain
    version, two launches bitwise equal; q blocks that see no key (t > s
    under a window) come out as zeros."""
    dev = _cuda()
    FA.reset_launch_counts()
    for i, (b, t, h, kv, window, cap) in enumerate(TC128_CASES):
        sd = 2.0 if cap else 1.5
        q, k, v = _bf16(dev, 40 + i, (b, t, h, 128), (b, t, kv, 128),
                        (b, t, kv, 128), sd=(sd, sd, 1.0))
        kw = dict(causal=True, window=window, softcap=cap)
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                        **kw)
        torch.cuda.synchronize()
        _close(got, want)
        assert torch.equal(got, FA.flash_attention(q, k, v, **kw))
    q, k, v = _bf16(dev, 49, (1, 256, 32, 128), (1, 64, 16, 128),
                    (1, 64, 16, 128))
    got = FA.flash_attention(q, k, v, window=32, softcap=50.0)
    want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                    window=32, softcap=50.0)
    seen = 64 + 32 - 1
    _close(got[:, :seen], want[:, :seen])
    assert not got[:, seen:].any()
    n = 2 * len(TC128_CASES) + 1
    assert FA.ROUTES == {"tensor_core": n, "cuda_core": 0}


#: (b, s, h, kv, d, cap): g 16 at d 256 (recurrentgemma's ring), g 8 at
#: d 64 / 128 / 256 over 2 kv heads, g 12 (starcoder2's), g 6 (mixtral's
#: and internvl2's 48/8), a cache no multiple of the 64-key tile, a
#: cache shorter than one tile
GROUP_CASES = [
    (2, 2048, 16, 1, 256, 0.0),
    (2, 2048, 16, 1, 256, 50.0),
    (3, 323, 16, 2, 64, 0.0),
    (2, 323, 16, 2, 128, 5.0),
    (2, 515, 16, 2, 256, 0.0),
    (2, 700, 12, 1, 128, 0.0),
    (2, 2176, 48, 8, 128, 0.0),
    (2, 40, 16, 1, 256, 0.0),
]


@pytest.mark.cuda
def test_group_decode_on_cuda():
    """The group kernel against its plain version under ring masks: a
    whole split with no valid slot (its partial merges with weight 0),
    batch row 1 with none at all (the kernel's 0); two runs bitwise
    equal; one plan of a single split (no merge); every launch counted
    on the group plan."""
    dev = _cuda()
    DA.reset_launch_counts()
    n = 0
    for i, (b, s, h, kv, d, cap) in enumerate(GROUP_CASES):
        sd = 2.0 if cap else 1.5
        q, k, v = _bf16(dev, 20 + i, (b, h, d), (b, s, kv, d), (b, s, kv, d),
                        sd=(sd, sd, 1.0))
        plan = DA.decode_plan(b, s, h, kv, d, torch.bfloat16,
                              n_sm=DA._n_sm(dev))
        assert plan.kernel == "group"
        valid = np.random.RandomState(i).rand(b, s) > 0.3
        if plan.nsplit > 2:
            valid[:, plan.keys_per_split:2 * plan.keys_per_split] = False
        valid[1] = False
        vm = torch.from_numpy(valid).to(dev)
        got = DA.decode_attention(q, k, v, vm, softcap=cap)
        want = DA.decode_attention_plain(q.float(), k.float(), v.float(),
                                         vm, softcap=cap)
        torch.cuda.synchronize()
        _close(got[:1], want[:1])
        _close(got[2:], want[2:])
        assert not got[1].any()
        assert torch.equal(got, DA.decode_attention(q, k, v, vm,
                                                    softcap=cap))
        # the split kernel on the same inputs agrees within the bound
        split = DA._launch(DA.decode_plan(b, s, h, kv, d, torch.bfloat16,
                                          kernel="split"),
                           q, k, v, vm, softcap=cap, scale=None)
        _close(split, got)
        n += 2
        # one split: the group kernel writes the output itself
        one = DA.decode_plan(b, s, h, kv, d, torch.bfloat16, n_sm=1)
        if one.nsplit == 1:
            _close(DA._launch(one, q, k, v, vm, softcap=cap, scale=None),
                   got)
            n += 1
    assert DA.PLANS["group"] == n and DA.LAUNCHES["decode_attention"] == \
        n + len(GROUP_CASES)
    assert DA._lib().da_group_tile_keys() == DA.GROUP_TILE
