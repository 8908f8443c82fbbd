"""Helpers shared by the port's model-family tests
(``tests/test_torch_{rglru,ssm,moe,encdec,vlm}.py``): seeded numpy
weights for a ``ParamDef`` tree, the closeness bound, and the engine
comparison."""

import dataclasses

import numpy as np


def np_params(defs, seed: int, scale: float = 1.0) -> dict:
    """Random float32 leaves for a reference ``ParamDef`` dict (as the
    block modules' ``*_defs`` give): matrices at 1/sqrt of their fan-in,
    vectors at ``scale`` around 0, every leaf nonzero."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in sorted(defs):
        if isinstance(defs[name], dict):
            out[name] = np_params(defs[name], seed + 1, scale)
            continue
        shape = defs[name].shape
        fan = shape[-2] if len(shape) > 1 else 1
        out[name] = (rng.randn(*shape) * scale / np.sqrt(fan)).astype(
            np.float32)
    return out


def perturbed(defs, seed: int):
    """The reference's float32 params from ``seed``, with the leaves it
    initialises to zeros or ones (biases, norm scales and offsets) moved
    by N(0, 0.05), so that they count.  (Moving every matrix too grows
    the residual stream to ~290 and puts the reference's own jit and
    eager logits 4.5e-4 of their largest apart, past the bound.)"""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import init_params as init_R
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray, init_R(defs, seed, jnp.float32))
    return jax.tree.map(
        lambda d, a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)
        if d.init in ("zeros", "ones") else a, defs, tree,
        is_leaf=lambda x: hasattr(x, "dims"))


def shape_count(shapes) -> int:
    """Elements of a ``param_shapes`` tree (shape tuples at the leaves)."""
    if isinstance(shapes, tuple):
        return int(np.prod(shapes))
    vals = shapes.values() if isinstance(shapes, dict) else shapes
    return sum(shape_count(v) for v in vals)


def to_torch(tree):
    import torch
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def close(got, want, rel: float, what: str) -> float:
    """max |got - want| <= rel * max(1, max |want|); returns the error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * scale, (what, err, scale)
    return err


def engine_matches_reference(arch: str, **over) -> dict:
    """The arch's smoke config (float32, the reference's weights carried
    across) through both engines: 6 ragged prompts on 3 slots with EOS
    live (refills mid-flight, a second joint prefill); the port's greedy
    tokens and scheduler stats must equal the reference's.  Returns the
    port engine's stats."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as smoke_R
    from repro.models import transformer as T_R
    from repro.models.layers import init_params as init_R
    from repro.serve import ServeConfig as ServeConfig_R
    from repro.serve import ServingEngine as Engine_R
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg_r = dataclasses.replace(smoke_R(arch), **over)
    cfg_p = dataclasses.replace(get_smoke_config(arch), **over)
    params_r = init_R(T_R.param_defs(cfg_r), 0, jnp.float32)
    params_p = convert.params_from_numpy(
        cfg_p, jax.tree.map(np.asarray, params_r), device="cpu")
    rng = np.random.RandomState(3)
    prompts = [[int(x) for x in rng.randint(2, cfg_r.vocab, 6 + 3 * i)]
               for i in range(6)]
    # EOS = request 0's 3rd greedy token, so slots free mid-flight
    probe = ServingEngine(cfg_p, params_p, ServeConfig(
        batch_slots=3, max_len=64, eos_token=-1), device="cpu")
    eos = probe.generate(prompts, max_new_tokens=3)[0][2]
    sv = dict(batch_slots=3, max_len=64, eos_token=eos)
    want_eng = Engine_R(cfg_r, params_r, ServeConfig_R(**sv))
    want = want_eng.generate(prompts, max_new_tokens=8)
    eng = ServingEngine(cfg_p, params_p, ServeConfig(**sv), device="cpu")
    got = eng.generate(prompts, max_new_tokens=8)
    assert got == want
    assert eng.stats == want_eng.stats
    assert eng.stats["refills"] >= 1, eng.stats
    return eng.stats


# ---------------------------------------------------------------------------
# the trunk against the reference's (tests/test_torch_{transformer,
# families}.py)
# ---------------------------------------------------------------------------

#: the families of ROADMAP Queue 1 item 1a (RG-LRU, SSM, the two MoE)
FAMILIES = ["recurrentgemma-9b", "falcon-mamba-7b", "deepseek-moe-16b",
            "mixtral-8x22b"]
PROMPT, MAX_LEN, STEPS = 24, 40, 8
#: every logit and cache element within 1e-4 of the reference, relative
#: to the tensor's largest magnitude (the gemma2 float32 bound)
REL = 1e-4
#: archs held against the reference's unrolled layers (``scan_layers``
#: off: the same function, every layer its own params): recurrentgemma's
#: RG-LRU gate, at the smoke config's activations (conv output ~80),
#: turns ulp-level differences of the conv and gate products into
#: 4.4e-4 of the logits between the reference's own scanned and
#: unrolled compilations (XLA contracts them differently inside a
#: ``lax.scan`` body).  The port is within 3e-7 of the unrolled one.
UNROLLED = ("recurrentgemma-9b",)


def near(got, want, what):
    close(got, want, REL, what)


def cache_leaves(tree):
    """Every cache tensor of the reference's nesting, in order."""
    out = []
    for c in (list(tree["head"])
              + [tree["groups"][k] for k in sorted(tree.get("groups", {}))]
              + list(tree["tail"])):
        out += [np.asarray(x) for x in c]
    return out


def models(arch, use_pallas):
    """(reference config, its float32 params from seed 0, the port's
    config, those params carried across) for the smoke config."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as smoke_R
    from repro.models import transformer as T_R
    from repro.models.layers import init_params as init_R
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    over = dict(use_pallas=use_pallas)
    if arch in UNROLLED:
        over["scan_layers"] = False
    cfg_r = dataclasses.replace(smoke_R(arch), **over)
    cfg_p = dataclasses.replace(get_smoke_config(arch), **over)
    params_r = init_R(T_R.param_defs(cfg_r), 0, jnp.float32)
    params_p = convert.params_from_numpy(
        cfg_p, jax.tree.map(np.asarray, params_r), device="cpu")
    return cfg_r, params_r, cfg_p, params_p


def prefill_and_decode_match(arch, use_pallas):
    """Prefill logits and caches, then ``STEPS`` greedy decode steps
    (logits each step, caches at the end), within ``REL``; the caches
    round-trip through the reference's nesting."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import transformer as T_R
    from repro_torch import convert
    from repro_torch.models import transformer as T_P
    cfg_r, params_r, cfg_p, params_p = models(arch, use_pallas)
    toks = np.random.RandomState(1).randint(
        2, cfg_r.vocab, (2, PROMPT)).astype(np.int32)
    prefill_r = jax.jit(T_R.prefill, static_argnums=(1, 3))
    step_r = jax.jit(T_R.decode_step, static_argnums=1)

    def caches_near(cp, cr, what):
        for i, (a, b) in enumerate(zip(
                cache_leaves(convert.caches_to_numpy(cfg_p, cp)),
                cache_leaves(jax.tree.map(np.asarray, cr)))):
            near(a, b, f"{what} cache leaf {i}")

    lr, cr = prefill_r(params_r, cfg_r, jnp.asarray(toks), MAX_LEN)
    lp, cp = T_P.prefill(params_p, cfg_p, torch.from_numpy(toks), MAX_LEN)
    near(lp.numpy(), lr, "prefill logits")
    caches_near(cp, cr, "prefill")
    cur = np.asarray(lr)[:, -1].argmax(-1).astype(np.int32)
    for pos in range(PROMPT, PROMPT + STEPS):
        lr, cr = step_r(params_r, cfg_r, jnp.asarray(cur[:, None]), cr,
                        jnp.asarray(pos, jnp.int32))
        lp, cp = T_P.decode_step(params_p, cfg_p,
                                 torch.from_numpy(cur[:, None]), cp,
                                 torch.tensor(pos, dtype=torch.int32))
        near(lp.numpy(), lr, f"decode logits at {pos}")
        assert np.array_equal(lp.numpy()[:, 0].argmax(-1),
                              np.asarray(lr)[:, 0].argmax(-1)), pos
        cur = np.asarray(lr)[:, 0].argmax(-1).astype(np.int32)
    caches_near(cp, cr, "decoded")
    back = convert.caches_from_numpy(
        cfg_p, convert.caches_to_numpy(cfg_p, cp), device="cpu")
    assert all(type(a) is type(b) and torch.equal(x, y)
               for a, b in zip(back, cp) for x, y in zip(a, b))


def forward_match(arch):
    """``forward``'s logits and MoE aux loss (0 without MoE layers)."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import transformer as T_R
    from repro_torch.models import transformer as T_P
    cfg_r, params_r, cfg_p, params_p = models(arch, False)
    toks = np.random.RandomState(2).randint(
        2, cfg_r.vocab, (2, 20)).astype(np.int32)
    want, want_aux = jax.jit(T_R.forward, static_argnums=1)(
        params_r, cfg_r, jnp.asarray(toks))
    got, aux = T_P.forward(params_p, cfg_p, torch.from_numpy(toks))
    near(got.numpy(), want, "forward logits")
    near(aux.numpy(), want_aux, "aux loss")
    assert (float(aux) > 0) == (cfg_p.moe is not None)


# ---------------------------------------------------------------------------
# loss and gradients against the reference's (tests/test_torch_train*.py)
# ---------------------------------------------------------------------------

#: whisper-base's smoke gradients are ill-conditioned (embedding and
#: position gradients ~77 beside first-layer query gradients ~0.2): the
#: reference's own float32 gradient is 2.0e-3 of a leaf's scale from the
#: float64 one (the port's, on the same weights), the port's float32
#: 5.5e-4.  Every other smoke config is within 2.3e-4 of the reference.
GRAD_REL = {"whisper-base": 3e-3}


def grads_close(got, want, what, rel: float = 5e-4):
    """Each gradient leaf within ``rel`` of the larger of its own largest
    magnitude and 1e-3 of the tree's largest (a leaf whose gradient is
    zero in exact arithmetic, such as a key bias under softmax, is
    rounding noise on both sides)."""
    top = max(float(w.abs().max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(float(w.abs().max()), 1e-3 * top)
        err = float((g - w).abs().max())
        assert err <= rel * scale, (what, i, err, scale)


def loss_and_grads_match(arch: str):
    """The arch's smoke config (float32, the reference's params from seed
    0 with the zero/one leaves perturbed, carried across) through
    ``train.step.model_loss`` on both sides: a batch of 2 x 12 tokens
    with -1 labels (and stub frames or patches, the patch positions'
    labels -1); the total loss, the nll and the MoE aux within 1e-5
    relative, every gradient leaf within ``grads_close`` (at
    ``GRAD_REL`` where it says so).  recurrentgemma
    runs the reference's unrolled layers (``UNROLLED``)."""
    import jax
    import torch
    from repro.configs import get_smoke_config as smoke_R
    from repro.models import encdec as E_R
    from repro.models import transformer as T_R
    from repro.models import vlm as V_R
    from repro.train.step import model_loss as model_loss_R
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim._tree import leaves, unflatten
    from repro_torch.train.step import model_loss
    over = dict(scan_layers=False) if arch in UNROLLED else {}
    cfg_r = dataclasses.replace(smoke_R(arch), **over)
    cfg_p = dataclasses.replace(get_smoke_config(arch), **over)
    mod = E_R if cfg_r.encdec else V_R if cfg_r.vlm else T_R
    params = perturbed(mod.param_defs(cfg_r), 0)
    rng = np.random.RandomState(1)
    b, t = 2, 12
    toks = rng.randint(2, cfg_r.vocab, (b, t)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    labels[0, 3] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg_r.encdec is not None:
        batch["frames"] = rng.randn(b, cfg_r.encdec.enc_seq,
                                    cfg_r.d_model).astype(np.float32)
    if cfg_r.vlm is not None:
        p = cfg_r.vlm.n_patches
        batch["patches"] = rng.randn(b, p, cfg_r.vlm.vit_dim).astype(
            np.float32)
        batch["labels"] = np.concatenate(
            [np.full((b, p), -1, np.int32), labels], 1)
    loss_r = model_loss_R(cfg_r)
    (tot_r, (nll_r, aux_r)), g = jax.jit(jax.value_and_grad(
        lambda q: loss_r(q, batch), has_aux=True))(params)
    params_p = convert.params_from_numpy(cfg_p, params, device="cpu")
    flat = [x.requires_grad_() for x in leaves(params_p)]
    tot_p, (nll_p, aux_p) = model_loss(cfg_p)(
        unflatten(params_p, flat),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tot_p, flat)
    for what, got, want in (("loss", tot_p, tot_r), ("nll", nll_p, nll_r),
                            ("aux", aux_p, aux_r)):
        assert abs(float(got.detach()) - float(want)) <= \
            1e-5 * max(abs(float(want)), 1e-3), (arch, what)
    want = leaves(convert.params_from_numpy(
        cfg_p, jax.tree.map(np.asarray, g), device="cpu"))
    assert len(want) == len(grads)
    grads_close(grads, want, arch, GRAD_REL.get(arch, 5e-4))
    return float(aux_r)
