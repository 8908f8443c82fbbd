"""The port's transformer against the reference's, on the CPU.

The gemma2 and starcoder2 smoke configs in float32, with the reference's
weights carried across by ``convert.params_from_numpy``: prefill logits
and KV caches, then 8 ``decode_step``s that run past gemma2's window of
16 (every local layer's ring wraps), through the plain attention path
and through ``use_pallas`` (the kernels' plain versions on the CPU);
``tests/test_torch_families.py`` runs the same prefill and decode
checks on the RG-LRU, SSM and MoE families.  Their ``forward`` (logits
and MoE aux loss), param trees, param counts and bfloat16 leaves, and
the serving path's refusal of the encoder-decoder and VLM configs, are
held here.

Bound: every logit and cache element within 1e-4 of the reference,
relative to the largest magnitude of the tensor
(``_torch_families.near``).  The two frameworks sum the matrix products
in other orders (float32 rounding, ~1e-6 relative a product); 1e-4
leaves room for that across the layers and 8 steps, and is far below
any change of a layer's arithmetic.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from _torch_families import (FAMILIES, MAX_LEN, cache_leaves,  # noqa: E402
                             forward_match, models, near,
                             prefill_and_decode_match)
from repro.configs import ARCHS as ALL_ARCHS                # noqa: E402
from repro.configs import get_config as get_config_R        # noqa: E402
from repro.configs import get_smoke_config as smoke_R       # noqa: E402
from repro.models import transformer as T_R                 # noqa: E402
from repro_torch import convert                             # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import transformer as T_P           # noqa: E402
from repro_torch.models.layers import init_params           # noqa: E402

ARCHS = ["gemma2-27b", "starcoder2-3b"]
PATHS = [(a, p) for a in ARCHS for p in (False, True)]


@pytest.mark.parametrize("arch,use_pallas", PATHS)
def test_prefill_and_decode_match_reference(arch, use_pallas):
    prefill_and_decode_match(arch, use_pallas)


@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_forward_matches_reference(arch):
    forward_match(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_blockwise_attention_matches_reference(arch):
    """``attn_impl="blockwise"`` (the online-softmax loop over kv blocks
    of 16, past the window) against the reference's scan."""
    cfg_r, params_r, cfg_p, params_p = models(arch, False)
    cfg_r = dataclasses.replace(cfg_r, attn_impl="blockwise",
                                attn_block_k=16)
    cfg_p = dataclasses.replace(cfg_p, attn_impl="blockwise",
                                attn_block_k=16)
    toks = np.random.RandomState(4).randint(
        2, cfg_r.vocab, (2, 40)).astype(np.int32)
    want, _ = T_R.forward(params_r, cfg_r, jnp.asarray(toks))
    got, _ = T_P.forward(params_p, cfg_p, torch.from_numpy(toks))
    near(got.numpy(), want, "blockwise forward logits")


@pytest.mark.parametrize("arch", ["gemma2-27b", "starcoder2-3b",
                                  "phi3-medium-14b", "qwen2.5-32b"]
                         + FAMILIES)
def test_param_count_and_tree_match_reference(arch):
    """Full-size decoder-only configs count the reference's parameters
    (gemma2: 27,227,128,320), and a smoke tree from ``init_params`` has
    the layout ``params_from_numpy`` makes of the reference's."""
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


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_count_matches_reference_for_every_config(arch):
    """``ModelConfig.param_count`` (the trunk's defs) is the reference's
    for all ten configs: whisper-base 72,022,016 and internvl2-26b
    19,861,260,288 among them."""
    assert get_config(arch).param_count() == get_config_R(arch).param_count()


@pytest.mark.parametrize("arch", ["gemma2-27b", "whisper-base",
                                  "internvl2-26b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_reference(arch, shape):
    """``configs.common.input_specs``: meta-device tensors of the
    reference's ``ShapeDtypeStruct`` shapes and dtypes."""
    from repro.configs import input_specs as specs_R
    from repro_torch.configs import input_specs
    want = specs_R(get_config_R(arch), shape)
    got = input_specs(get_config(arch), shape)
    assert set(got) == set(want)
    for k, spec in got.items():
        assert spec.device.type == "meta", k
        assert tuple(spec.shape) == tuple(want[k].shape), k
        assert str(spec.dtype)[6:] == str(want[k].dtype), k


@pytest.mark.parametrize("arch,what", [
    ("whisper-base", "repro_torch.models.encdec"),
    ("internvl2-26b", "repro_torch.models.vlm")], ids=["encdec", "vlm"])
def test_unported_kinds_raise(arch, what):
    """The decoder-only serving path refuses the encoder-decoder and the
    VLM, naming the model module that runs each (the reference's
    launcher refuses both too); their trunk defs build, as the
    reference's do (``param_count`` counts them)."""
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_smoke_config(arch)
    defs = T_P.param_defs(cfg)
    assert len(defs["layers"]) == cfg.n_layers
    params = init_params(defs, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        ServingEngine(cfg, params, ServeConfig(), device="cpu")
    with pytest.raises(SystemExit, match=what):
        launcher.main(["--arch", arch, "--smoke", "--device", "cpu"])
    T_P.check_ported(cfg)


@pytest.mark.parametrize("arch,group,path,layer", [
    ("gemma2-27b", ("p1", 0), ("attn", "wq"), 1),        # layer 1, global
    ("deepseek-moe-16b", ("p0", 1), ("moe", "wi"), 2),   # [e, d, f] experts
    ("falcon-mamba-7b", ("p0", 2), ("ssm", "log_a"), 2),
    ("recurrentgemma-9b", ("p1", 0), ("rglru", "lam"), 1)])
def test_params_from_numpy_keeps_bfloat16(arch, group, path, layer):
    """The reference's bfloat16 leaves (ml_dtypes in numpy) carry across
    as torch.bfloat16 with the same bits, each stacked group leaf
    unstacked into its layer."""
    rng = np.random.RandomState(5)
    tree = jax.tree.map(
        lambda d: rng.randn(*d.shape).astype(jnp.bfloat16),
        T_R.param_defs(smoke_R(arch)), is_leaf=lambda x: hasattr(x, "dims"))
    got = convert.params_from_numpy(get_smoke_config(arch), tree,
                                    device="cpu")
    want = tree["groups"][group[0]][path[0]][path[1]][group[1]]
    leaf = got["layers"][layer][path[0]][path[1]]
    assert leaf.dtype == torch.bfloat16 and leaf.shape == want.shape
    np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_with_tensor_pos_past_the_ring_wrap(use_pallas):
    """``KVCache.pos`` is a [] int32 tensor, as in the reference: from the
    reference's prefill caches carried by ``convert.caches_from_numpy``,
    12 decode steps from position 10 run past gemma2's window of 16 (each
    local layer's ring wraps during decode), the reference fed a
    ``jnp.int32`` pos and the port a tensor, the same tokens both sides."""
    cfg_r, params_r, cfg_p, params_p = models("gemma2-27b", use_pallas)
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
        near(lp.numpy(), lr, f"decode logits at {pos}")
        cur = np.asarray(lr)[:, 0].argmax(-1).astype(np.int32)
    assert all(int(c.pos) == prompt + steps for c in cp)
    for i, (a, b) in enumerate(zip(cache_leaves(
            convert.caches_to_numpy(cfg_p, cp)), cache_leaves(
            jax.tree.map(np.asarray, cr)))):
        near(a, b, f"decoded cache leaf {i}")
