"""The port's RG-LRU block and associative scan against the reference's,
on the CPU (``repro_torch.models.{rglru,scan}`` vs ``repro.models.rglru``
and ``jax.lax.associative_scan``).

Inputs and weights are seeded numpy, the same arrays on both sides.
Bounds (``_torch_families.close``: max |diff| <= rel * max(1, max
|reference|)):
  * the scan: 1e-6 in float32 (the same odd/even recursion as XLA's, so
    only a contracted multiply-add could move a bit), 1e-2 in bfloat16
    (a bfloat16 ulp is 2^-8 relative);
  * the block: 1e-5 on its output and state, per call, with the state
    carried from a prefill into a second prefill and into decode steps
    (float32 products summed in another order, ~1e-6 relative each).
The recurrentgemma smoke config through prefill, decode and the
engine's refill is held in ``test_torch_transformer.py`` and here
(``test_engine_matches_reference``: greedy tokens equal).
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
from repro.models import rglru as R                         # noqa: E402
from repro_torch.configs import get_smoke_config            # noqa: E402
from repro_torch.models import rglru as P                   # noqa: E402
from repro_torch.models.scan import associative_scan        # noqa: E402

ARCH = "recurrentgemma-9b"
apply_R = jax.jit(R.apply_rglru, static_argnums=1)


def _combine(lhs, rhs):
    a1, u1 = lhs
    a2, u2 = rhs
    return a1 * a2, a2 * u1 + u2


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-6),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("n", [1, 2, 3, 8, 37, 512])
def test_scan_matches_reference(n, dtype, rel):
    rng = np.random.RandomState(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    u = rng.randn(2, n, 3, 4).astype(np.float32)
    want = jax.jit(lambda a, u: jax.lax.associative_scan(
        _combine, (a, u), axis=1))(jnp.asarray(a, dtype),
                                   jnp.asarray(u, dtype))
    got = associative_scan(torch.from_numpy(a).to(getattr(torch, dtype)),
                           torch.from_numpy(u).to(getattr(torch, dtype)))
    for g, w, what in zip(got, want, ("prod a", "h")):
        assert g.dtype == getattr(torch, dtype)
        close(g.float().numpy(), np.asarray(w, np.float32), rel, what)


def _setup(conv_width=4):
    cfg_r = smoke_R(ARCH)
    cfg_r = dataclasses.replace(cfg_r, rglru=dataclasses.replace(
        cfg_r.rglru, conv_width=conv_width))
    cfg_p = dataclasses.replace(get_smoke_config(ARCH), rglru=cfg_r.rglru)
    p = np_params(R.rglru_defs(cfg_r), 0)
    return cfg_r, cfg_p, p


def _state(s):
    return [np.asarray(x) for x in s]


@pytest.mark.parametrize("conv_width", [4, 1])
def test_apply_rglru_matches_reference(conv_width):
    """A 24-token prefill from no state, a 7-token prefill from its
    state, then 4 single-token steps: output and (conv, h) each call."""
    cfg_r, cfg_p, p = _setup(conv_width)
    pj, pt = jax.tree.map(jnp.asarray, p), to_torch(p)
    rng = np.random.RandomState(1)
    st_r = st_p = None
    for t in (24, 7, 1, 1, 1, 1):
        x = rng.randn(2, t, cfg_r.d_model).astype(np.float32)
        y_r, st_r = apply_R(pj, cfg_r, jnp.asarray(x), st_r)
        y_p, st_p = P.apply_rglru(pt, cfg_p, torch.from_numpy(x), st_p)
        close(y_p.numpy(), y_r, 1e-5, f"y at t={t}")
        assert st_p.h.dtype == torch.float32
        assert st_p.conv.shape == (2, conv_width - 1, cfg_p.lru_width)
        for a, b, f in zip(_state(st_p), _state(st_r), st_p._fields):
            close(a, b, 1e-5, f"{f} at t={t}")


def test_apply_rglru_bfloat16_keeps_h_float32():
    """Activations in bfloat16: the conv history in bfloat16, ``h`` in
    float32, as the reference's (rglru.py:50-53); outputs within 2e-2
    (bfloat16 products, ulp 2^-8)."""
    cfg_r, cfg_p, p = _setup()
    pj, pt = jax.tree.map(jnp.asarray, p), to_torch(p)
    x = np.random.RandomState(2).randn(2, 9, cfg_r.d_model).astype(
        np.float32)
    y_r, st_r = apply_R(pj, cfg_r, jnp.asarray(x, jnp.bfloat16))
    y_p, st_p = P.apply_rglru(pt, cfg_p,
                              torch.from_numpy(x).to(torch.bfloat16))
    assert y_p.dtype == st_p.conv.dtype == torch.bfloat16
    assert st_p.h.dtype == torch.float32
    close(y_p.float().numpy(), np.asarray(y_r, np.float32), 2e-2, "y")
    close(st_p.h.numpy(), np.asarray(st_r.h), 2e-2, "h")


def test_init_state_matches_reference():
    cfg_r, cfg_p, _ = _setup()
    want = R.init_rglru_state(cfg_r, 3, jnp.bfloat16)
    got = P.init_rglru_state(cfg_p, 3, torch.bfloat16, "cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype)[6:] == str(w.dtype)


def test_engine_matches_reference():
    """Continuous batching with refills: a refilled slot's recurrent
    state is scattered like its KV rows (the reference's scanned
    layers)."""
    engine_matches_reference(ARCH)
