"""The port's optimizer (``repro_torch.optim``) against the reference's,
on the CPU, from the same seeded numpy inputs.

The reference's functions run jitted, as its train step does.  Bounds:
the schedule within 1e-6 relative (XLA reassociates its constant
products and divisions, and its cosine is another); the global norm
within 2e-6 (another summation order); the clip bitwise (its inputs are
chosen so that the norm is exact in any summation order); AdamW's
float32 moments and master within 1e-6 of each leaf's largest magnitude
(XLA contracts ``a*b + c`` into one FMA where torch rounds twice; the
moments cancel) and its bf16 params within one bf16 ulp; the int8 codes
equal except where the scaled value lies within 1e-6 of a .5 tie; the
dequantised grads and the EF residuals bitwise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
import ml_dtypes                                            # noqa: E402

from repro import optim as O_R                              # noqa: E402
from repro_torch import optim as O_P                        # noqa: E402
from repro_torch.train.step import scale_groups             # noqa: E402

BF16 = ml_dtypes.bfloat16


def _t(a):
    """A numpy array (bfloat16 as ml_dtypes gives it too) as a tensor."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _tree(seed, dtype=np.float32, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(33, 17) * scale).astype(dtype),
            "layers": [{"b": (rng.randn(7) * scale).astype(dtype)},
                       {"b": (rng.randn(7) * scale).astype(dtype)}],
            "z": (rng.randn(5, 3, 2) * scale).astype(dtype)}


def _flat(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (7, 7)])
def test_cosine_schedule(warmup, total):
    kw = dict(peak_lr=3e-3, warmup_steps=warmup, total_steps=total)
    sched_r = jax.jit(lambda s: O_R.cosine_schedule(s, **kw))
    for step in list(range(0, total + 5)) + [10_000]:
        want = np.float32(sched_r(jnp.int32(step)))
        got = O_P.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                  **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want)), \
            (step, float(got), want)
    end = O_P.cosine_schedule(torch.tensor(total + 3), **kw)
    assert float(end) == pytest.approx(3e-4, rel=1e-6)   # min_ratio 0.1


def test_clip_bf16_multiplies_in_float32():
    """bf16 grads at a clip scale below 1: the reference multiplies in
    float32 (bf16 x a float32 [] array promotes) and casts back; in
    torch a bf16 tensor times a [] float32 tensor stays bf16.  Integer
    grads make the norm exact in any summation order, so the two must be
    bitwise equal."""
    rng = np.random.RandomState(0)
    grads = {k: rng.randint(-8, 9, shape).astype(np.float32).astype(BF16)
             for k, shape in (("a", (64, 33)), ("b", (17,)), ("c", (5, 9)))}
    out_r, norm_r = jax.jit(O_R.clip_by_global_norm, static_argnums=1)(
        grads, 3.0)
    out_p, norm_p = O_P.clip_by_global_norm(
        {k: _t(v) for k, v in grads.items()}, 3.0)
    assert float(norm_p) == float(norm_r) and float(norm_r) > 3.0
    for k in grads:
        assert out_p[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(out_p[k]).view(np.uint16),
                                      np.asarray(out_r[k]).view(np.uint16),
                                      err_msg=k)
    # the trap: a product in bf16 rounds the scale to bf16 first
    scale = (torch.tensor(3.0) / norm_p).to(torch.bfloat16)
    assert not torch.equal(_t(grads["a"]) * scale, out_p["a"])
    # a norm under the clip leaves the grads as they are
    same, _ = O_P.clip_by_global_norm({k: _t(v) for k, v in grads.items()},
                                      1e6)
    for k in grads:
        assert torch.equal(same[k], _t(grads[k]))


def test_global_norm():
    tree = _tree(3)
    want = float(O_R.global_norm(tree))
    got = O_P.global_norm(jax.tree.map(_t, tree))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 2e-6 * want


@pytest.mark.parametrize("dtype,use_master", [("bfloat16", True),
                                              ("float32", False),
                                              ("float32", True)])
def test_adamw_update_matches_reference(dtype, use_master):
    np_dtype = BF16 if dtype == "bfloat16" else np.float32
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0,
                  use_master=use_master)
    params = _tree(1, np_dtype)
    opt_r = O_R.adamw_init(params, O_R.AdamWConfig(**cfg_kw))
    opt_p = O_P.adamw_init(jax.tree.map(_t, params),
                           O_P.AdamWConfig(**cfg_kw))
    assert (opt_p.master is None) == (not use_master)
    upd_r = jax.jit(O_R.adamw_update, static_argnums=3)
    p_r, p_p = params, jax.tree.map(_t, params)
    for step in range(3):
        # nonzero integer grads: away from 0, where Adam's normalised
        # step is well posed, and with a norm exact in any order
        rng = np.random.RandomState(10 + step)
        g = jax.tree.map(lambda a: (rng.randint(1, 9, a.shape)
                                    * rng.choice([-1, 1], a.shape)
                                    ).astype(np.float32).astype(np_dtype),
                         params)
        lr = jnp.float32(1e-2 * (step + 1) / 3)
        p_r, opt_r, m_r = upd_r(g, opt_r, p_r, O_R.AdamWConfig(**cfg_kw), lr)
        p_p, opt_p, m_p = O_P.adamw_update(
            jax.tree.map(_t, g), opt_p, p_p, O_P.AdamWConfig(**cfg_kw),
            torch.tensor(float(lr)))
        assert int(opt_p.step) == int(opt_r.step) == step + 1
        assert opt_p.step.dtype == torch.int32
        assert float(m_p["grad_norm"]) == float(m_r["grad_norm"])
        assert float(m_p["lr"]) == float(m_r["lr"])
        for name, got, want in (("mu", opt_p.mu, opt_r.mu),
                                ("nu", opt_p.nu, opt_r.nu)) + (
                ((("master", opt_p.master, opt_r.master),)
                 if use_master else ())):
            for a, b in zip(_flat(jax.tree.map(_np, got)), _flat(want)):
                assert a.dtype == np.float32
                b = np.asarray(b)
                assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), \
                    (step, name)
        for a, b in zip(_flat(jax.tree.map(_np, p_p)), _flat(p_r)):
            assert a.dtype == np_dtype
            a32, b32 = a.astype(np.float32), np.asarray(b, np.float32)
            if dtype == "bfloat16":      # one bf16 ulp
                assert np.all(np.abs(a32 - b32)
                              <= np.spacing(np.abs(b32)) * 2 ** 16), step
            else:
                assert np.abs(a32 - b32).max() <= 1e-6 * np.abs(b32).max()
    # the input state is not written: the update is functional
    assert int(O_P.adamw_init(p_p, O_P.AdamWConfig()).step) == 0


def _near_tie(x, scale) -> np.ndarray:
    v = np.abs(np.asarray(x, np.float64) / np.float64(scale))
    return np.abs(v - np.floor(v) - 0.5) < 1e-6 * np.maximum(v, 1.0)


def test_int8_codes_and_roundtrip():
    rng = np.random.RandomState(4)
    x = (rng.randn(300, 40) * rng.rand(300, 1) ** 3).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 127.0]          # ties, round half to even
    x[1, :] = 0.0
    for arr in (x, x.astype(BF16), np.zeros((3, 3), np.float32)):
        q_r, s_r = jax.jit(O_R.compress_int8)(arr)
        q_p, s_p = O_P.compress_int8(_t(arr))
        assert q_p.dtype == torch.int8 and s_p.dtype == torch.float32
        assert float(s_p) == float(s_r)
        diff = q_p.numpy() != np.asarray(q_r)
        assert not np.any(diff & ~_near_tie(np.asarray(arr, np.float32),
                                            float(s_r)))
        assert diff.mean() <= 1e-3
        back = O_P.decompress_int8(q_p, s_p).numpy()
        want = np.asarray(O_R.decompress_int8(q_r, s_r))
        np.testing.assert_array_equal(back[~diff], want[~diff])
    q, s = O_P.compress_int8(torch.tensor([[1.5, 2.5, -127.0]]) * 1.0)
    assert q.tolist() == [[2, 2, -127]] and float(s) == 1.0


def test_ef_residuals_match_reference_over_steps():
    grads = [_tree(20 + i) for i in range(4)]
    ef_r = O_R.ef_init(grads[0])
    ef_p = O_P.ef_init(jax.tree.map(_t, grads[0]))
    upd_r = jax.jit(O_R.ef_compress_update)
    for g in grads:
        d_r, ef_r = upd_r(g, ef_r)
        d_p, ef_p = O_P.ef_compress_update(jax.tree.map(_t, g), ef_p)
        for a, b in zip(_flat(jax.tree.map(_np, d_p)), _flat(d_r)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_flat(jax.tree.map(_np, ef_p.residual)),
                        _flat(ef_r.residual)):
            np.testing.assert_array_equal(a, b)


def test_ef_groups_quantise_as_the_stacked_leaf():
    """The reference stacks a scanned group's layers into one leaf and
    quantises it with one scale; the port's unstacked layers share that
    scale through ``groups``."""
    from repro_torch.models import ModelConfig
    rng = np.random.RandomState(5)
    stacked = (rng.randn(3, 16, 8) * np.array([1.0, 4.0, 0.25])[:, None,
                                                                  None]
               ).astype(np.float32)
    d_r, ef_r = jax.jit(O_R.ef_compress_update)(
        {"w": stacked}, O_R.ef_init({"w": stacked}))
    layers = {"layers": [{"w": _t(stacked[i])} for i in range(3)]}
    cfg = ModelConfig(name="t", n_layers=3, d_model=16, n_heads=2,
                      n_kv_heads=1, head_dim=8, d_ff=32, vocab=32)
    groups = scale_groups(cfg, layers)
    assert groups == [[0, 1, 2]]
    d_p, ef_p = O_P.ef_compress_update(layers, O_P.ef_init(layers), groups)
    for i in range(3):
        np.testing.assert_array_equal(d_p["layers"][i]["w"].numpy(),
                                      np.asarray(d_r["w"])[i])
        np.testing.assert_array_equal(ef_p.residual["layers"][i]["w"].numpy(),
                                      np.asarray(ef_r.residual["w"])[i])
    # each layer alone would take its own scale: a different result
    alone, _ = O_P.ef_compress_update(layers, O_P.ef_init(layers))
    assert not torch.equal(alone["layers"][2]["w"], d_p["layers"][2]["w"])
