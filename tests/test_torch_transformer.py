"""The port's transformer against the reference's, on the CPU.

The gemma2 and starcoder2 smoke configs in float32, with the reference's
weights carried across by ``convert.params_from_numpy``: prefill logits
and KV caches, then 8 ``decode_step``s that run past gemma2's window of
16 (every local layer's ring wraps), through the plain attention path
and through ``use_pallas`` (the kernels' plain versions on the CPU).

Bound: every logit and cache element within 1e-4 of the reference,
relative to the largest magnitude of the tensor (``_close``).  The two
frameworks sum the matrix products in other orders (float32 rounding,
~1e-6 relative a product); 1e-4 leaves room for that across the layers
and 8 steps, and is far below any change of a layer's arithmetic.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from repro.configs import get_config as get_config_R        # noqa: E402
from repro.configs import get_smoke_config as smoke_R       # noqa: E402
from repro.models import transformer as T_R                 # noqa: E402
from repro.models.layers import init_params as init_R       # noqa: E402
from repro_torch import convert                             # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import transformer as T_P           # noqa: E402
from repro_torch.models.layers import init_params           # noqa: E402

ARCHS = ["gemma2-27b", "starcoder2-3b"]
PROMPT, MAX_LEN, STEPS = 24, 40, 8
REL = 1e-4


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, (what, err, scale)


def _cache_leaves(tree):
    out = []
    for c in (list(tree["head"])
              + [tree["groups"][k] for k in sorted(tree.get("groups", {}))]
              + list(tree["tail"])):
        out += [np.asarray(c.k), np.asarray(c.v), np.asarray(c.pos)]
    return out


def _models(arch, use_pallas):
    cfg_r = dataclasses.replace(smoke_R(arch), use_pallas=use_pallas)
    cfg_p = dataclasses.replace(get_smoke_config(arch), use_pallas=use_pallas)
    params_r = init_R(T_R.param_defs(cfg_r), 0, jnp.float32)
    params_p = convert.params_from_numpy(
        cfg_p, jax.tree.map(np.asarray, params_r), device="cpu")
    return cfg_r, params_r, cfg_p, params_p


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, use_pallas):
    cfg_r, params_r, cfg_p, params_p = _models(arch, use_pallas)
    toks = np.random.RandomState(1).randint(
        2, cfg_r.vocab, (2, PROMPT)).astype(np.int32)
    prefill_r = jax.jit(T_R.prefill, static_argnums=(1, 3))
    step_r = jax.jit(T_R.decode_step, static_argnums=1)

    lr, cr = prefill_r(params_r, cfg_r, jnp.asarray(toks), MAX_LEN)
    lp, cp = T_P.prefill(params_p, cfg_p, torch.from_numpy(toks), MAX_LEN)
    _close(lp.numpy(), lr, "prefill logits")
    for i, (a, b) in enumerate(zip(_cache_leaves(
            convert.caches_to_numpy(cfg_p, cp)), _cache_leaves(
            jax.tree.map(np.asarray, cr)))):
        _close(a, b, f"prefill cache leaf {i}")

    cur = np.asarray(lr)[:, -1].argmax(-1).astype(np.int32)
    for pos in range(PROMPT, PROMPT + STEPS):
        lr, cr = step_r(params_r, cfg_r, jnp.asarray(cur[:, None]), cr,
                        jnp.asarray(pos, jnp.int32))
        lp, cp = T_P.decode_step(params_p, cfg_p,
                                 torch.from_numpy(cur[:, None]), cp,
                                 torch.tensor(pos, dtype=torch.int32))
        _close(lp.numpy(), lr, f"decode logits at {pos}")
        cur = np.asarray(lr)[:, 0].argmax(-1).astype(np.int32)
    for i, (a, b) in enumerate(zip(_cache_leaves(
            convert.caches_to_numpy(cfg_p, cp)), _cache_leaves(
            jax.tree.map(np.asarray, cr)))):
        _close(a, b, f"decoded cache leaf {i}")
    # the caches round-trip through the reference's nesting
    back = convert.caches_from_numpy(
        cfg_p, convert.caches_to_numpy(cfg_p, cp), device="cpu")
    assert all(torch.equal(a.k, b.k) and torch.equal(a.pos, b.pos)
               for a, b in zip(back, cp))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg_r, params_r, cfg_p, params_p = _models(arch, False)
    toks = np.random.RandomState(2).randint(
        2, cfg_r.vocab, (2, 20)).astype(np.int32)
    want, _ = T_R.forward(params_r, cfg_r, jnp.asarray(toks))
    got = T_P.forward(params_p, cfg_p, torch.from_numpy(toks))
    _close(got.numpy(), want, "forward logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_blockwise_attention_matches_reference(arch):
    """``attn_impl="blockwise"`` (the online-softmax loop over kv blocks
    of 16, past the window) against the reference's scan."""
    cfg_r, params_r, cfg_p, params_p = _models(arch, False)
    cfg_r = dataclasses.replace(cfg_r, attn_impl="blockwise",
                                attn_block_k=16)
    cfg_p = dataclasses.replace(cfg_p, attn_impl="blockwise",
                                attn_block_k=16)
    toks = np.random.RandomState(4).randint(
        2, cfg_r.vocab, (2, 40)).astype(np.int32)
    want, _ = T_R.forward(params_r, cfg_r, jnp.asarray(toks))
    got = T_P.forward(params_p, cfg_p, torch.from_numpy(toks))
    _close(got.numpy(), want, "blockwise forward logits")


@pytest.mark.parametrize("arch", ["gemma2-27b", "starcoder2-3b",
                                  "phi3-medium-14b", "qwen2.5-32b"])
def test_param_count_and_tree_match_reference(arch):
    """Full-size dense configs count the reference's parameters (gemma2:
    27,227,128,320), and a smoke tree from ``init_params`` has the
    layout ``params_from_numpy`` makes of the reference's."""
    assert get_config(arch).param_count() == get_config_R(arch).param_count()
    cfg_p = get_smoke_config(arch)
    zeros = jax.tree.map(lambda d: np.zeros(d.shape, np.float32),
                         T_R.param_defs(smoke_R(arch)),
                         is_leaf=lambda x: hasattr(x, "dims"))
    carried = convert.params_from_numpy(cfg_p, zeros, device="cpu")
    own = init_params(T_P.param_defs(cfg_p), 0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)  # noqa
    assert shapes(own) == shapes(carried)
    assert len(own["layers"]) == cfg_p.n_layers
    assert T_P.n_params(own) == cfg_p.param_count()


def _moe_attn_only():
    """deepseek without its dense head layer: every layer ``moe_attn``."""
    cfg = get_smoke_config("deepseek-moe-16b")
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, first_k_dense=0))


@pytest.mark.parametrize("make,what", [
    (lambda: get_smoke_config("mixtral-8x22b"), "moe_local"),
    (_moe_attn_only, "moe_attn"),
    (lambda: get_smoke_config("deepseek-moe-16b"), "dense_attn"),
    (lambda: get_smoke_config("falcon-mamba-7b"), "ssm"),
    (lambda: get_smoke_config("recurrentgemma-9b"), "rec"),
    (lambda: get_smoke_config("whisper-base"), "encoder-decoder"),
    (lambda: get_smoke_config("internvl2-26b"), "VLM")],
    ids=["moe_local", "moe_attn", "dense_attn", "ssm", "rec", "encdec",
         "vlm"])
def test_unported_kinds_raise(make, what):
    cfg = make()
    for fn in (lambda: T_P.param_defs(cfg),
               lambda: T_P.init_caches(cfg, 1, 8, torch.float32, "cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            fn()
    with pytest.raises(NotImplementedError, match=what):
        T_P.check_ported(cfg)


def test_params_from_numpy_keeps_bfloat16():
    """The reference's bfloat16 leaves (ml_dtypes in numpy) carry across
    as torch.bfloat16 with the same bits."""
    arch = "gemma2-27b"
    rng = np.random.RandomState(5)
    tree = jax.tree.map(
        lambda d: rng.randn(*d.shape).astype(jnp.bfloat16),
        T_R.param_defs(smoke_R(arch)), is_leaf=lambda x: hasattr(x, "dims"))
    got = convert.params_from_numpy(get_smoke_config(arch), tree,
                                    device="cpu")
    want = tree["groups"]["p1"]["attn"]["wq"][0]       # layer 1, global
    wq = got["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_with_tensor_pos_past_the_ring_wrap(use_pallas):
    """``KVCache.pos`` is a [] int32 tensor, as in the reference: from the
    reference's prefill caches carried by ``convert.caches_from_numpy``,
    12 decode steps from position 10 run past gemma2's window of 16 (each
    local layer's ring wraps during decode), the reference fed a
    ``jnp.int32`` pos and the port a tensor, the same tokens both sides."""
    cfg_r, params_r, cfg_p, params_p = _models("gemma2-27b", use_pallas)
    assert cfg_p.window == 16
    prompt, steps = 10, 12
    toks = np.random.RandomState(6).randint(
        2, cfg_r.vocab, (2, prompt)).astype(np.int32)
    step_r = jax.jit(T_R.decode_step, static_argnums=1)
    lr, cr = jax.jit(T_R.prefill, static_argnums=(1, 3))(
        params_r, cfg_r, jnp.asarray(toks), MAX_LEN)
    cp = convert.caches_from_numpy(cfg_p, jax.tree.map(np.asarray, cr),
                                   device="cpu")
    assert all(c.pos.dtype == torch.int32 and c.pos.dim() == 0
               and int(c.pos) == prompt for c in cp)
    cur = np.asarray(lr)[:, -1].argmax(-1).astype(np.int32)
    for pos in range(prompt, prompt + steps):
        lr, cr = step_r(params_r, cfg_r, jnp.asarray(cur[:, None]), cr,
                        jnp.int32(pos))
        lp, cp = T_P.decode_step(params_p, cfg_p,
                                 torch.from_numpy(cur[:, None]), cp,
                                 torch.tensor(pos, dtype=torch.int32))
        _close(lp.numpy(), lr, f"decode logits at {pos}")
        cur = np.asarray(lr)[:, 0].argmax(-1).astype(np.int32)
    assert all(int(c.pos) == prompt + steps for c in cp)
    for i, (a, b) in enumerate(zip(_cache_leaves(
            convert.caches_to_numpy(cfg_p, cp)), _cache_leaves(
            jax.tree.map(np.asarray, cr)))):
        _close(a, b, f"decoded cache leaf {i}")
