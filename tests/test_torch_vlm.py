"""The port's VLM (``repro_torch.models.vlm``) against the reference's,
on the CPU.

internvl2-26b's smoke config (3 layers, d 64, 4/2 heads, 8 patches of
width 48) in float32, with the reference's weights (biases and norm
parameters moved off their zeros and ones) carried across by
``convert.params_from_numpy``; the stub patches take their shape from
``configs.common.input_specs``.  ``project_patches``, ``fuse_inputs``,
``forward`` ([b, p + t, vocab]), ``prefill`` and 8 greedy
``transformer.decode_step``s from position p + t, ``loss_fn`` with the
patch positions' labels at -1 — through the plain attention path and
through ``use_pallas`` (the kernels' plain versions on the CPU).  The
reference runs its layers unrolled (``scan_layers=False``), as the port
does.

Bound: 1e-4 of each tensor's largest magnitude (``_torch_families.near``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from _torch_families import (cache_leaves, near, perturbed,  # noqa: E402
                             shape_count)
from repro.configs import get_smoke_config as smoke_R       # noqa: E402
from repro.models import transformer as T_R                 # noqa: E402
from repro.models import vlm as V_R                         # noqa: E402
from repro_torch import convert                             # noqa: E402
from repro_torch.configs import get_smoke_config, input_specs  # noqa: E402
from repro_torch.models import transformer as T_P           # noqa: E402
from repro_torch.models import vlm as V_P                   # noqa: E402
from repro_torch.models.layers import init_params           # noqa: E402

ARCH = "internvl2-26b"
B, TEXT, MAX_LEN, STEPS = 2, 6, 32, 8


def models(use_pallas: bool):
    over = dict(use_pallas=use_pallas, scan_layers=False)
    cfg_r = dataclasses.replace(smoke_R(ARCH), **over)
    cfg_p = dataclasses.replace(get_smoke_config(ARCH), **over)
    params_np = perturbed(V_R.param_defs(cfg_r), 0)
    params_p = convert.params_from_numpy(cfg_p, params_np, device="cpu")
    return cfg_r, params_np, cfg_p, params_p


def patches_and_tokens(cfg, seed: int, t: int = TEXT):
    spec = input_specs(cfg, "prefill_32k")
    assert spec["patches"].device.type == "meta"
    assert spec["tokens"].shape[1] == 32768 - cfg.vlm.n_patches
    rng = np.random.RandomState(seed)
    patches = rng.randn(B, *spec["patches"].shape[1:]).astype(np.float32)
    toks = rng.randint(2, cfg.vocab, (B, t)).astype(np.int32)
    return patches, toks


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(use_pallas):
    cfg_r, params_r, cfg_p, params_p = models(use_pallas)
    patches, toks = patches_and_tokens(cfg_r, 1)
    want = V_R.project_patches(params_r, cfg_r, jnp.asarray(patches))
    got = V_P.project_patches(params_p, cfg_p, torch.from_numpy(patches))
    near(got.numpy(), want, "project_patches")
    want = V_R.fuse_inputs(params_r, cfg_r, jnp.asarray(patches),
                           jnp.asarray(toks))
    got = V_P.fuse_inputs(params_p, cfg_p, torch.from_numpy(patches),
                          torch.from_numpy(toks))
    assert got.shape == (B, cfg_p.vlm.n_patches + TEXT, cfg_p.d_model)
    near(got.numpy(), want, "fuse_inputs")

    lr, cr = jax.jit(V_R.prefill, static_argnums=(1, 4))(
        params_r, cfg_r, jnp.asarray(patches), jnp.asarray(toks), MAX_LEN)
    lp, cp = V_P.prefill(params_p, cfg_p, torch.from_numpy(patches),
                         torch.from_numpy(toks), MAX_LEN)
    near(lp.numpy(), lr, "prefill logits")

    def caches_near(cp, cr, what):
        for i, (a, b) in enumerate(zip(
                cache_leaves(convert.caches_to_numpy(cfg_p, cp)),
                cache_leaves(jax.tree.map(np.asarray, cr)))):
            near(a, b, f"{what} cache leaf {i}")

    caches_near(cp, cr, "prefill")
    p0 = cfg_p.vlm.n_patches + TEXT
    assert [int(c.pos) for c in cp] == [p0] * cfg_p.n_layers
    cur = np.asarray(lr)[:, -1].argmax(-1).astype(np.int32)
    step_r = jax.jit(T_R.decode_step, static_argnums=1)
    for pos in range(p0, p0 + STEPS):
        lr, cr = step_r(params_r, cfg_r, jnp.asarray(cur[:, None]), cr,
                        jnp.int32(pos))
        lp, cp = T_P.decode_step(params_p, cfg_p,
                                 torch.from_numpy(cur[:, None]), cp,
                                 torch.tensor(pos, dtype=torch.int32))
        near(lp.numpy(), lr, f"decode logits at {pos}")
        assert np.array_equal(lp.numpy()[:, 0].argmax(-1),
                              np.asarray(lr)[:, 0].argmax(-1)), pos
        cur = np.asarray(lr)[:, 0].argmax(-1).astype(np.int32)
    caches_near(cp, cr, "decoded")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_loss_match_reference(use_pallas):
    cfg_r, params_r, cfg_p, params_p = models(use_pallas)
    patches, toks = patches_and_tokens(cfg_r, 2, t=10)
    p = cfg_p.vlm.n_patches
    labels = np.full((B, p + 10), -1, np.int32)
    labels[:, p:-1] = toks[:, 1:]
    want, want_aux = jax.jit(V_R.forward, static_argnums=1)(
        params_r, cfg_r, jnp.asarray(patches), jnp.asarray(toks))
    got, aux = V_P.forward(params_p, cfg_p, torch.from_numpy(patches),
                           torch.from_numpy(toks))
    assert got.shape == (B, p + 10, cfg_p.vocab)
    near(got.numpy(), want, "forward logits")
    assert float(aux) == float(want_aux) == 0.0
    lr, (nr, _) = jax.jit(V_R.loss_fn, static_argnums=1)(
        params_r, cfg_r, jnp.asarray(patches), jnp.asarray(toks),
        jnp.asarray(labels))
    lp, (np_, _) = V_P.loss_fn(params_p, cfg_p, torch.from_numpy(patches),
                               torch.from_numpy(toks),
                               torch.from_numpy(labels))
    near(lp.numpy(), lr, "loss")
    near(np_.numpy(), nr, "nll")


def test_param_tree_and_count_match_reference():
    """The smoke tree from ``init_params`` has the layout (and element
    count) of the reference's carried across; at full size the defs
    count 19,918,688,512 elements (the trunk's 19,861,260,288, which
    ``param_count`` gives as the reference's does, plus the projector)
    without materialising anything."""
    from repro.configs import get_config as get_config_R
    from repro_torch.configs import get_config
    from repro_torch.models import param_shapes
    _, params_r, cfg_p, carried = models(False)
    own = init_params(V_P.param_defs(cfg_p), 0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)  # noqa
    assert shapes(own) == shapes(carried)
    assert T_P.n_params(own) == sum(a.size for a in jax.tree.leaves(params_r))
    full = get_config(ARCH)
    shapes = param_shapes(V_P.param_defs(full))
    assert shape_count(shapes) == 19_918_688_512
    assert shapes["projector"]["w1"] == (3200, 6144)
    assert full.param_count() == get_config_R(ARCH).param_count() \
        == 19_861_260_288


def test_params_from_numpy_refuses_an_unknown_key():
    """An unknown top-level key raises (it used to be dropped): the
    trunk's tree with the VLM's ``projector`` under a decoder-only
    config, and a VLM tree with an extra key."""
    _, params_r, cfg_p, _ = models(False)
    with pytest.raises(KeyError, match="vision"):
        convert.params_from_numpy(cfg_p, dict(params_r, vision={}),
                                  device="cpu")
    trunk = dataclasses.replace(cfg_p, vlm=None)
    with pytest.raises(KeyError, match="projector"):
        convert.params_from_numpy(trunk, params_r, device="cpu")
