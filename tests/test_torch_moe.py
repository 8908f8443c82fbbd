"""The port's MoE block against the reference's, on the CPU
(``repro_torch.models.moe`` vs ``repro.models.moe``).

Both dispatch paths (one-hot: deepseek-moe's; sort: mixtral's) at a
loose capacity (no drops) and a tight one (drops), with and without
shared experts.  Discrete routing is held exactly: the experts chosen
(``jax.lax.top_k``'s, ties to the lower index), and which (token,
choice) pairs keep a capacity slot, against the reference's one-hot
cumsum (moe.py:79-83) computed with jax; the sort path's drops equal the
one-hot path's.  The outputs and the aux loss are held within 1e-5 of
the reference's (``_torch_families.close``: relative to max(1, max
|reference|); float32 products summed in another order).  The
deepseek-moe and mixtral smoke configs through the engine (refills, EOS
live) give the reference's greedy tokens.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

from _torch_families import (close, engine_matches_reference,  # noqa: E402
                             np_params, to_torch)
from repro.configs import get_smoke_config as smoke_R       # noqa: E402
from repro.models import moe as R                           # noqa: E402
from repro_torch.configs import get_smoke_config            # noqa: E402
from repro_torch.models import moe as P                     # noqa: E402

apply_R = jax.jit(R.apply_moe, static_argnums=1)


def _setup(arch, impl, capacity_factor, n_shared=None):
    def cut(cfg):
        moe = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
        if n_shared is not None:
            moe = dataclasses.replace(moe, n_shared=n_shared)
        return dataclasses.replace(cfg, moe=moe, moe_impl=impl)
    cfg_r, cfg_p = cut(smoke_R(arch)), cut(get_smoke_config(arch))
    return cfg_r, cfg_p, np_params(R.moe_defs(cfg_r), 0)


def _reference_routing(p, cfg, x):
    """The reference's routing, its own expressions (moe.py:66-83) in
    jax: expert indices [b, t, k] and the kept mask of each choice."""
    m = cfg.moe
    b, t, _ = x.shape
    e, k = m.n_experts, m.top_k
    probs = jax.nn.softmax(jnp.einsum("btd,de->bte", x, p["router"]), -1)
    _, gate_idx = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32)
    flat = oh.reshape(b, t * k, e)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(b, t, k, e)
           * oh).sum(-1)
    return np.asarray(gate_idx), np.asarray(pos < R.capacity_of(cfg, t))


CASES = [("deepseek-moe-16b", "onehot", 8.0, None),
         ("deepseek-moe-16b", "onehot", 0.5, None),
         ("deepseek-moe-16b", "onehot", 0.5, 0),
         ("mixtral-8x22b", "sort", 8.0, None),
         ("mixtral-8x22b", "sort", 0.5, None),
         ("mixtral-8x22b", "onehot", 0.5, None),
         ("deepseek-moe-16b", "sort", 0.5, None)]


@pytest.mark.parametrize("arch,impl,cf,n_shared", CASES,
                         ids=[f"{a.split('-')[0]}-{i}-cf{c}-sh{s}"
                              for a, i, c, s in CASES])
def test_apply_moe_matches_reference(arch, impl, cf, n_shared):
    cfg_r, cfg_p, p = _setup(arch, impl, cf, n_shared)
    x = np.random.RandomState(1).randn(2, 24, cfg_r.d_model).astype(
        np.float32)
    pj, pt, xt = jax.tree.map(jnp.asarray, p), to_torch(p), \
        torch.from_numpy(x)
    want_idx, want_keep = _reference_routing(pj, cfg_r, jnp.asarray(x))
    _, _, gate_idx = P.route(pt, cfg_p, xt)
    np.testing.assert_array_equal(gate_idx.numpy(), want_idx)
    c = P.capacity_of(cfg_p, 24)
    _, keep = P.onehot_slots(gate_idx, cfg_p.moe.n_experts, c)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    # the sort path keeps the same (token, choice) pairs
    order, _, skeep = P.sort_slots(gate_idx, cfg_p.moe.n_experts, c)
    unsorted = torch.empty_like(skeep).scatter_(1, order, skeep)
    np.testing.assert_array_equal(unsorted.reshape(keep.shape).numpy(),
                                  want_keep)
    assert want_keep.all() == (cf == 8.0), "capacity case not exercised"
    y_r, aux_r = apply_R(pj, cfg_r, jnp.asarray(x))
    y_p, aux_p = P.apply_moe(pt, cfg_p, xt)
    close(y_p.numpy(), y_r, 1e-5, "y")
    close(aux_p.numpy(), aux_r, 1e-5, "aux")


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25],
                        [0.1, 0.3, 0.3, 0.3],
                        [0.4, 0.1, 0.4, 0.1],
                        [0.1, 0.2, 0.3, 0.4]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = P.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_sort_combine_repeats_bitwise():
    """The sort path gathers each token's outputs and sums them in a
    fixed order: two calls give the same bits."""
    cfg_r, cfg_p, p = _setup("mixtral-8x22b", "sort", 0.5)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        3, 17, cfg_p.d_model).astype(np.float32))
    a, _ = P.apply_moe(to_torch(p), cfg_p, x)
    b, _ = P.apply_moe(to_torch(p), cfg_p, x)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b"])
def test_engine_matches_reference(arch):
    engine_matches_reference(arch)
