"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
reference's, on the CPU.

whisper-base's smoke config (2 + 2 layers, d 64, 4 heads, 16 frames) in
float32, with the reference's weights (biases and norm parameters moved
off their zeros and ones) carried across by
``convert.params_from_numpy``; the stub frames take their shape from
``configs.common.input_specs``.  ``encode``; ``prefill`` (last logits,
every layer's K/V and ``pos``, ``enc_out``); 8 greedy ``decode_step``s;
``forward``; ``loss_fn`` — through the plain attention path and through
``use_pallas`` (the kernels' plain versions on the CPU).  The reference
runs its layers unrolled (``scan_layers=False``), as the port does.

Bound: 1e-4 of each tensor's largest magnitude (``_torch_families.near``,
the gemma2 float32 bound).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from _torch_families import near, perturbed, shape_count    # noqa: E402
from repro.configs import get_smoke_config as smoke_R       # noqa: E402
from repro.models import encdec as E_R                      # noqa: E402
from repro_torch import convert                             # noqa: E402
from repro_torch.configs import get_smoke_config, input_specs  # noqa: E402
from repro_torch.models import encdec as E_P                # noqa: E402
from repro_torch.models.layers import init_params           # noqa: E402

ARCH = "whisper-base"
B, PROMPT, MAX_LEN, STEPS = 2, 4, 24, 8


def models(use_pallas: bool):
    over = dict(use_pallas=use_pallas, scan_layers=False)
    cfg_r = dataclasses.replace(smoke_R(ARCH), **over)
    cfg_p = dataclasses.replace(get_smoke_config(ARCH), **over)
    params_np = perturbed(E_R.param_defs(cfg_r), 0)
    params_p = convert.params_from_numpy(cfg_p, params_np, device="cpu")
    return cfg_r, params_np, cfg_p, params_p


def frames_and_tokens(cfg, seed: int, t: int = PROMPT):
    spec = input_specs(cfg, "prefill_32k")["frames"]
    assert spec.device.type == "meta" and spec.dtype == torch.bfloat16
    rng = np.random.RandomState(seed)
    frames = rng.randn(B, *spec.shape[1:]).astype(np.float32)
    toks = rng.randint(2, cfg.vocab, (B, t)).astype(np.int32)
    return frames, toks


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(use_pallas):
    cfg_r, params_r, cfg_p, params_p = models(use_pallas)
    frames, toks = frames_and_tokens(cfg_r, 1)
    want = jax.jit(E_R.encode, static_argnums=1)(params_r, cfg_r,
                                                 jnp.asarray(frames))
    got = E_P.encode(params_p, cfg_p, torch.from_numpy(frames))
    near(got.numpy(), want, "encode")

    lr, cr, er = jax.jit(E_R.prefill, static_argnums=(1, 4))(
        params_r, cfg_r, jnp.asarray(frames), jnp.asarray(toks), MAX_LEN)
    lp, cp, ep = E_P.prefill(params_p, cfg_p, torch.from_numpy(frames),
                             torch.from_numpy(toks), MAX_LEN)
    near(lp.numpy(), lr, "prefill logits")
    near(ep.numpy(), er, "enc_out")
    assert len(cp) == cfg_p.n_layers

    def caches_near(cp, cr, what):
        got = convert.caches_to_numpy(cfg_p, cp)
        for f in ("k", "v"):
            for i in range(cfg_p.n_layers):
                near(getattr(got, f)[i], np.asarray(getattr(cr, f))[i],
                     f"{what} layer {i} {f}")
        want_pos = np.asarray(cr.pos)
        assert want_pos.shape == (cfg_p.n_layers,)
        assert [int(c.pos) for c in cp] == want_pos.tolist(), what
        np.testing.assert_array_equal(got.pos, want_pos)

    caches_near(cp, cr, "prefill")
    cur = np.asarray(lr)[:, -1].argmax(-1).astype(np.int32)
    step_r = jax.jit(E_R.decode_step, static_argnums=1)
    for pos in range(PROMPT, PROMPT + STEPS):
        lr, cr = step_r(params_r, cfg_r, jnp.asarray(cur[:, None]), er, cr,
                        jnp.int32(pos))
        lp, cp = E_P.decode_step(params_p, cfg_p,
                                 torch.from_numpy(cur[:, None]), ep, cp,
                                 torch.tensor(pos, dtype=torch.int32))
        near(lp.numpy(), lr, f"decode logits at {pos}")
        assert np.array_equal(lp.numpy()[:, 0].argmax(-1),
                              np.asarray(lr)[:, 0].argmax(-1)), pos
        cur = np.asarray(lr)[:, 0].argmax(-1).astype(np.int32)
    caches_near(cp, cr, "decoded")


def test_caches_carry_each_layers_pos():
    """The reference's stacked decoder caches carry one ``pos`` a layer:
    each port layer gets its own (not layer 0's), and back."""
    cfg_r, _, cfg_p, _ = models(False)
    n = cfg_p.n_layers
    c = jax.tree.map(np.asarray, E_R.init_dec_caches(cfg_r, B, 8,
                                                     jnp.float32))
    rng = np.random.RandomState(3)
    tree = c._replace(k=rng.randn(*c.k.shape).astype(np.float32),
                      v=rng.randn(*c.v.shape).astype(np.float32),
                      pos=np.arange(5, 5 + n, dtype=np.int32))
    got = convert.caches_from_numpy(cfg_p, tree, device="cpu")
    assert [int(x.pos) for x in got] == list(range(5, 5 + n))
    assert all(x.pos.dim() == 0 and x.pos.dtype == torch.int32 for x in got)
    for i in range(n):
        np.testing.assert_array_equal(got[i].k.numpy(), tree.k[i])
        np.testing.assert_array_equal(got[i].v.numpy(), tree.v[i])
    back = convert.caches_to_numpy(cfg_p, got)
    for a, b in zip(back, tree):
        np.testing.assert_array_equal(a, b)
    own = E_P.init_dec_caches(cfg_p, B, 8, torch.float32, "cpu")
    assert len(own) == n and len({id(x.pos) for x in own}) == n
    assert [tuple(x.k.shape) for x in own] == [c.k.shape[1:]] * n


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_loss_match_reference(use_pallas):
    cfg_r, params_r, cfg_p, params_p = models(use_pallas)
    frames, toks = frames_and_tokens(cfg_r, 2, t=12)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    want, want_aux = jax.jit(E_R.forward, static_argnums=1)(
        params_r, cfg_r, jnp.asarray(frames), jnp.asarray(toks))
    got, aux = E_P.forward(params_p, cfg_p, torch.from_numpy(frames),
                           torch.from_numpy(toks))
    near(got.numpy(), want, "forward logits")
    assert float(aux) == float(want_aux) == 0.0
    (lr, (nr, _)) = jax.jit(E_R.loss_fn, static_argnums=1)(
        params_r, cfg_r, jnp.asarray(frames), jnp.asarray(toks),
        jnp.asarray(labels))
    lp, (np_, _) = E_P.loss_fn(params_p, cfg_p, torch.from_numpy(frames),
                               torch.from_numpy(toks),
                               torch.from_numpy(labels))
    near(lp.numpy(), lr, "loss")
    near(np_.numpy(), nr, "nll")


def test_param_tree_and_count_match_reference():
    """The smoke tree from ``init_params`` has the layout (and element
    count) of the reference's carried across; at full size the defs
    count the reference's 100,106,240 elements and ``param_count`` its
    trunk's 72,022,016."""
    from repro.configs import get_config as get_config_R
    from repro_torch.configs import get_config
    from repro_torch.models import param_shapes, transformer
    cfg_r, params_r, cfg_p, carried = models(False)
    own = init_params(E_P.param_defs(cfg_p), 0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)  # noqa
    assert shapes(own) == shapes(carried)
    assert transformer.n_params(own) == sum(
        a.size for a in jax.tree.leaves(params_r))
    full = get_config(ARCH)
    shapes = param_shapes(E_P.param_defs(full))
    n = shape_count(shapes)
    ref = sum(int(np.prod(s)) for s in jax.tree.leaves(
        jax.tree.map(lambda d: d.shape, E_R.param_defs(get_config_R(ARCH)),
                     is_leaf=lambda x: hasattr(x, "dims")),
        is_leaf=lambda x: isinstance(x, tuple)))
    assert n == ref == 100_106_240
    assert len(shapes["enc"]) == len(shapes["dec"]) == 6
    assert full.param_count() == get_config_R(ARCH).param_count() \
        == 72_022_016


def test_max_len_past_the_position_table_raises():
    """``dec_pos`` has 4096 rows: a prefill that could decode past them
    raises on the host (the reference would read NaN rows)."""
    _, _, cfg_p, params_p = models(False)
    frames, toks = frames_and_tokens(cfg_p, 4)
    args = (params_p, cfg_p, torch.from_numpy(frames),
            torch.from_numpy(toks))
    with pytest.raises(ValueError, match="4096"):
        E_P.prefill(*args, 4097)
    E_P.prefill(*args, 4096)


def test_params_from_numpy_refuses_an_unknown_key():
    cfg_r, params_r, cfg_p, _ = models(False)
    bad = dict(params_r, layers=params_r["dec"])
    with pytest.raises(KeyError, match="layers"):
        convert.params_from_numpy(cfg_p, bad, device="cpu")
