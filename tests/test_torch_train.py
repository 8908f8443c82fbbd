"""The port's training path (``repro_torch.models.transformer.loss_fn``,
``repro_torch.train.step``) against the reference's, on the CPU.

A 2-layer model (d 64, 4/2 heads, vocab 256) in float32, the reference's
params carried across by ``convert``; the weights are drawn at unit
scale (embedding N(0, 1), matrices at 1/sqrt(fan-in)) so that the
gradients are well posed (the default 0.01 embedding under an RMS norm
makes the first layer's gradients cancel to ~1e-4 of their size).  The
reference runs jitted, as its callers run it.

Bounds, stated once: losses within 1e-5 relative; each gradient leaf
within 5e-4 of the larger of its own largest magnitude and 1e-3 of the
tree's (a leaf whose gradient is zero in exact arithmetic, such as a key
bias under softmax, is rounding noise on both sides).  A train step from
the same state: loss and ce within 1e-5, grad norm within 1e-4, lr within
1e-6 relative, the step and the key bitwise; the new params within 1e-5
of the reference's except at most 0.1% of them, where AdamW's normalised
first steps turn a gradient within rounding of 0 into opposite signs, and
none further than 2 lr; the EF residual likewise.  Three chained steps:
losses within 1e-4 relative.  The remat modes are bitwise equal.
"""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_families import grads_close                     # noqa: E402
from repro.data import DataConfig as DataConfig_R           # noqa: E402
from repro.data import SyntheticLM as SyntheticLM_R         # noqa: E402
from repro.models import ModelConfig as ModelConfig_R       # noqa: E402
from repro.models import transformer as T_R                 # noqa: E402
from repro.models.layers import init_params as init_R       # noqa: E402
from repro.optim import AdamWConfig as AdamWConfig_R        # noqa: E402
from repro.train import step as S_R                         # noqa: E402
from repro_torch import convert                             # noqa: E402
from repro_torch.configs import get_smoke_config            # noqa: E402
from repro_torch.kernels.flash_attention import (           # noqa: E402
    flash_attention, refuse_autograd)
from repro_torch.kernels.decode_attention import decode_attention  # noqa
from repro_torch.models import ModelConfig                  # noqa: E402
from repro_torch.models import transformer as T_P           # noqa: E402
from repro_torch.models.layers import init_params           # noqa: E402
from repro_torch.optim import AdamWConfig                   # noqa: E402
from repro_torch.optim._tree import leaves, unflatten       # noqa: E402
from repro_torch.train import step as S_P                   # noqa: E402

KW = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, d_ff=128, vocab=256)
B, T = 3, 20
LR = 3e-3


def unit_params(cfg_r, seed: int = 1) -> dict:
    """The reference's param tree with every leaf redrawn at unit scale
    (norm scales around 1)."""
    defs = T_R.param_defs(cfg_r)
    tree = jax.tree.map(np.asarray, init_R(defs, 0, jnp.float32))
    rng = np.random.RandomState(seed)

    def draw(d, a):
        if d.dims and d.dims[0] == "vocab":
            s = 1.0
        elif a.ndim - (1 if d.dims[:1] == ("layers",) else 0) > 1:
            s = 1.0 / np.sqrt(a.shape[-2] if d.dims[:1] != ("layers",)
                              else a.shape[1])
        else:
            s = 0.1
        return (rng.randn(*a.shape) * s
                + (1.0 if d.init == "ones" else 0.0)).astype(np.float32)
    return jax.tree.map(draw, defs, tree, is_leaf=lambda x: hasattr(x, "dims"))


def models(**over):
    cfg_r = dataclasses.replace(ModelConfig_R(**KW), **over)
    cfg_p = dataclasses.replace(ModelConfig(**KW), **over)
    params = unit_params(cfg_r)
    return cfg_r, params, cfg_p, convert.params_from_numpy(cfg_p, params,
                                                           device="cpu")


def tokens_and_labels(seed: int = 2, t: int = T):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, KW["vocab"], (B, t)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    labels[1, 2:5] = -1
    return toks, labels


def port_value_and_grad(cfg, params, toks, labels):
    flat = [p.detach().clone().requires_grad_() for p in leaves(params)]
    total, (loss, aux) = T_P.loss_fn(unflatten(params, flat), cfg,
                                     torch.from_numpy(toks),
                                     torch.from_numpy(labels))
    grads = torch.autograd.grad(total, flat)
    return total.detach(), loss.detach(), aux.detach(), grads


@pytest.mark.parametrize("loss_chunk", [0, 8, 32])
def test_loss_and_gradients_match_reference(loss_chunk):
    """Plain (0) and chunked loss heads: 8 of 20 positions gives two
    chunks and a ragged tail of 4; 32 one chunk of the whole sequence;
    some labels are -1."""
    cfg_r, params_r, cfg_p, params_p = models(loss_chunk=loss_chunk)
    toks, labels = tokens_and_labels()
    (tr, (lr_, ar)), g = jax.jit(jax.value_and_grad(
        lambda p: T_R.loss_fn(p, cfg_r, toks, labels), has_aux=True))(
        params_r)
    tp, lp, ap, gp = port_value_and_grad(cfg_p, params_p, toks, labels)
    assert abs(float(tp) - float(tr)) <= 1e-5 * abs(float(tr))
    assert abs(float(lp) - float(lr_)) <= 1e-5 * abs(float(lr_))
    assert float(ap) == float(ar) == 0.0
    want = leaves(convert.params_from_numpy(
        cfg_p, jax.tree.map(np.asarray, g), device="cpu"))
    grads_close(gp, want, f"loss_chunk={loss_chunk}")
    # the chunked head is the plain one's function
    if loss_chunk:
        t0, _, _, g0 = port_value_and_grad(
            dataclasses.replace(cfg_p, loss_chunk=0), params_p, toks, labels)
        assert abs(float(tp) - float(t0)) <= 1e-5 * abs(float(t0))
        grads_close(gp, g0, "chunked vs plain")


def _saved_shapes(cfg, params, toks, labels) -> list:
    shapes = []

    def pack(x):
        shapes.append(tuple(x.shape))
        return x
    flat = [p.detach().clone().requires_grad_() for p in leaves(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        total, _ = T_P.loss_fn(unflatten(params, flat), cfg,
                               torch.from_numpy(toks),
                               torch.from_numpy(labels))
    torch.autograd.grad(total, flat)
    return shapes


def test_chunked_head_keeps_no_logits_for_the_backward():
    """Under autograd the chunked head recomputes each chunk's logits in
    the backward: no [b, *, vocab] tensor is saved; the plain head saves
    the whole [b, t, vocab] logits."""
    _, _, cfg_p, params_p = models()
    toks, labels = tokens_and_labels()
    v = KW["vocab"]
    plain = _saved_shapes(cfg_p, params_p, toks, labels)
    assert any(s[:1] == (B,) and s[-1] == v for s in plain)
    chunked = _saved_shapes(dataclasses.replace(cfg_p, loss_chunk=8),
                            params_p, toks, labels)
    assert not any(s[:1] == (B,) and s[-1] == v for s in chunked), chunked


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", [None, "mixtral-8x22b", "falcon-mamba-7b"])
def test_remat_modes_bitwise_equal(arch):
    """remat none / full / dots give the same loss and gradients, bit for
    bit; "full" recomputes every product in the backward, "dots" none of
    the unbatched ones (``mm``) but the attention's batched ones."""
    if arch is None:
        cfg = ModelConfig(**KW)
        params = convert.params_from_numpy(cfg, unit_params(
            ModelConfig_R(**KW)), device="cpu")
    else:
        cfg = get_smoke_config(arch)
        params = init_params(T_P.param_defs(cfg), 0, device="cpu")
    toks, labels = tokens_and_labels()
    toks %= cfg.vocab
    labels = np.where(labels >= 0, labels % cfg.vocab, -1).astype(np.int32)
    out, mm = {}, {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        flat = [p.detach().clone().requires_grad_() for p in leaves(params)]
        total, _ = T_P.loss_fn(unflatten(params, flat), c,
                               torch.from_numpy(toks),
                               torch.from_numpy(labels))
        with _Count() as n:
            grads = torch.autograd.grad(total, flat)
        out[remat] = (total.detach(), grads)
        mm[remat] = (n.ops[torch.ops.aten.mm.default],
                     n.ops[torch.ops.aten.bmm.default])
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b), remat
    assert mm["full"][0] > mm["none"][0], mm
    assert mm["dots"][0] == mm["none"][0], mm
    if arch is None:                 # attention's einsums are batched
        assert mm["dots"][1] > mm["none"][1], mm


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 3, -1])
def test_key_split_bitwise(seed):
    key_r = jax.random.PRNGKey(seed)
    key_p = S_P.prng_key(seed)
    assert key_p.dtype == torch.uint32 and key_p.device.type == "cpu"
    for _ in range(5):
        np.testing.assert_array_equal(key_p.numpy(), np.asarray(key_r))
        np.testing.assert_array_equal(
            S_P.split_key(key_p, 3).numpy(),
            np.asarray(jax.random.split(key_r, 3)))
        key_r, _ = jax.random.split(key_r)
        key_p = S_P.split_key(key_p)[0]
    np.testing.assert_array_equal(key_p.numpy(), np.asarray(key_r))


def _leaves_np(cfg_p, tree):
    return [x.numpy() for x in leaves(convert.params_from_numpy(
        cfg_p, jax.tree.map(np.asarray, tree), device="cpu"))]


def _near_but_few(got, want, lr: float, what: str):
    got = np.concatenate([np.ravel(g) for g in got])
    want = np.concatenate([np.ravel(w) for w in want])
    far = np.abs(got - want) > 1e-5
    assert far.mean() <= 1e-3, (what, int(far.sum()), got.size)
    assert np.abs(got - want).max() <= 2 * lr, what


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (1, True), (2, True)])
def test_train_steps_match_reference(microbatches, compress):
    cfg_r, params, cfg_p, _ = models()
    kw = dict(microbatches=microbatches, compress_grads=compress,
              warmup_steps=2, total_steps=10)
    sc_r = S_R.StepConfig(opt=AdamWConfig_R(lr=LR), **kw)
    sc_p = S_P.StepConfig(opt=AdamWConfig(lr=LR), **kw)
    state_r = S_R.init_train_state(cfg_r, jax.tree.map(jnp.asarray, params),
                                   sc_r, seed=5)
    chained = convert.train_state_from_numpy(
        cfg_p, jax.tree.map(np.asarray, state_r), device="cpu")
    assert chained.rng.dtype == torch.uint32
    assert chained.opt.step.dtype == torch.int32
    step_r = jax.jit(S_R.make_train_step(cfg_r, sc_r))
    step_p = S_P.make_train_step(cfg_p, sc_p)
    data = SyntheticLM_R(DataConfig_R(vocab=KW["vocab"], seq_len=16,
                                      global_batch=4, kind="markov"))
    for i in range(3):
        batch = data.batch_at(i)
        carried = convert.train_state_from_numpy(
            cfg_p, jax.tree.map(np.asarray, state_r), device="cpu")
        state_r, m_r = step_r(state_r, batch)
        got, m_p = step_p(carried, batch)
        chained, m_c = step_p(chained, batch)
        for k, rel in (("loss", 1e-5), ("ce", 1e-5), ("grad_norm", 1e-4),
                       ("lr", 1e-6)):
            assert m_p[k].dim() == 0
            assert abs(float(m_p[k]) - float(m_r[k])) <= \
                rel * abs(float(m_r[k])), (i, k)
        assert abs(float(m_c["loss"]) - float(m_r["loss"])) <= \
            1e-4 * float(m_r["loss"]), i
        assert int(got.opt.step) == int(state_r.opt.step) == i + 1
        np.testing.assert_array_equal(got.rng.numpy(),
                                      np.asarray(state_r.rng))
        np.testing.assert_array_equal(chained.rng.numpy(),
                                      np.asarray(state_r.rng))
        _near_but_few([x.detach().numpy() for x in leaves(got.params)],
                      _leaves_np(cfg_p, state_r.params), LR, f"params {i}")
        _near_but_few([x.numpy() for x in leaves(got.opt.master)],
                      _leaves_np(cfg_p, state_r.opt.master), LR,
                      f"master {i}")
        assert (got.ef is None) == (not compress)
        if compress:
            _near_but_few([x.numpy() for x in leaves(got.ef.residual)],
                          _leaves_np(cfg_p, state_r.ef.residual), LR,
                          f"residual {i}")


def test_train_step_keeps_its_input_state():
    """Functional, as the reference's: the state passed in is unchanged."""
    _, _, cfg_p, params_p = models()
    sc = S_P.StepConfig(opt=AdamWConfig(lr=LR), compress_grads=True,
                        warmup_steps=1, total_steps=4)
    state = S_P.init_train_state(cfg_p, params_p, sc)
    before = [x.clone() for x in leaves(state)]
    toks, labels = tokens_and_labels()
    new, _ = S_P.make_train_step(cfg_p, sc)(
        state, {"tokens": toks, "labels": labels})
    for a, b in zip(leaves(state), before):
        assert torch.equal(a, b)
    assert not torch.equal(leaves(new.params)[0], leaves(state.params)[0])


def test_attention_kernels_refuse_autograd():
    """The CUDA kernels write through raw pointers and have no backward:
    ``refuse_autograd`` raises where a call would drop a gradient, and
    stays quiet without autograd or without an input that needs it.  On
    the CPU the wrappers run their plain versions, which differentiate
    (the reference's ``ref`` backend does too)."""
    q = torch.randn(1, 5, 4, 8, requires_grad=True)
    k = torch.randn(1, 5, 2, 8)
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        refuse_autograd("flash_attention", q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_autograd("decode_attention", k, k, q)
    with torch.no_grad():
        refuse_autograd("flash_attention", q, k, k)
    refuse_autograd("flash_attention", q.detach(), k, k)
    out = flash_attention(q, k, k, causal=True)
    (g,) = torch.autograd.grad(out.sum(), q)
    assert g.abs().sum() > 0
    qd = torch.randn(1, 4, 8, requires_grad=True)
    valid = torch.ones(1, 5, dtype=torch.bool)
    (g,) = torch.autograd.grad(decode_attention(qd, k, k, valid).sum(), qd)
    assert torch.isfinite(g).all()
