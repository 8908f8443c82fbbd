"""The port's Mamba-1 SSM block against the reference's, on the CPU
(``repro_torch.models.ssm`` vs ``repro.models.ssm``).

Every branch of ``apply_ssm`` (ssm.py:117-154): the single decode step
(t = 1), the chunked scan (``ssm_chunk`` dividing a longer t: t = 2 and
3 chunks, the state carried from chunk to chunk), and the whole-sequence
scan (t not a multiple of the chunk, or no longer than one), each from
no state and from a carried state; the scan pairs in float32 and in
bfloat16 (``ssm_scan_dtype``).  Inputs and weights are seeded numpy, the
same arrays on both sides.  Bounds (``_torch_families.close``: max
|diff| <= rel * max(1, max |reference|)): 1e-5 in float32 (products and
the C read-out summed in another order, ~1e-6 relative each); 2e-2 with
bfloat16 scan pairs (ulp 2^-8, rounded at every combine).
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
from repro.models import ssm as R                           # noqa: E402
from repro_torch.configs import get_smoke_config            # noqa: E402
from repro_torch.models import ssm as P                     # noqa: E402

ARCH = "falcon-mamba-7b"
CHUNK = 8
apply_R = jax.jit(R.apply_ssm, static_argnums=1)


def _setup(**over):
    over = {"ssm_chunk": CHUNK, **over}
    cfg_r = dataclasses.replace(smoke_R(ARCH), **over)
    cfg_p = dataclasses.replace(get_smoke_config(ARCH), **over)
    return cfg_r, cfg_p, np_params(R.ssm_defs(cfg_r), 0)


def _held(p, cfg_r, cfg_p, x, st_r, st_p, rel, what):
    y_r, st_r = apply_R(jax.tree.map(jnp.asarray, p), cfg_r,
                        jnp.asarray(x), st_r)
    y_p, st_p = P.apply_ssm(to_torch(p), cfg_p, torch.from_numpy(x), st_p)
    close(y_p.numpy(), y_r, rel, f"y {what}")
    assert st_p.ssm.dtype == torch.float32
    for a, b, f in zip(st_p, st_r, st_p._fields):
        close(a.numpy(), np.asarray(b), rel, f"{f} {what}")
    return st_r, st_p


@pytest.mark.parametrize("scan_dtype,rel", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
@pytest.mark.parametrize("t", [1, 2 * CHUNK, 3 * CHUNK, 13, CHUNK],
                         ids=["decode", "chunked2", "chunked3", "whole13",
                              "whole_one_chunk"])
def test_apply_ssm_matches_reference(t, scan_dtype, rel):
    """A call at ``t`` from no state, then from the state of a 5-token
    prefill, then one decode step from that."""
    cfg_r, cfg_p, p = _setup(ssm_scan_dtype=scan_dtype)
    rng = np.random.RandomState(t)
    x = rng.randn(2, t, cfg_r.d_model).astype(np.float32)
    _held(p, cfg_r, cfg_p, x, None, None, rel, f"t={t} from zero")
    pre = rng.randn(2, 5, cfg_r.d_model).astype(np.float32)
    st_r, st_p = _held(p, cfg_r, cfg_p, pre, None, None, rel, "prefill 5")
    st_r, st_p = _held(p, cfg_r, cfg_p, x, st_r, st_p, rel,
                       f"t={t} carried")
    step = rng.randn(2, 1, cfg_r.d_model).astype(np.float32)
    _held(p, cfg_r, cfg_p, step, st_r, st_p, rel, "decode after")


def test_softplus_is_the_references_above_20():
    """``jax.nn.softplus`` is logaddexp(x, 0); ``F.softplus`` returns x
    above its threshold of 20.  dt biases of 18-30 straddle it."""
    cfg_r, cfg_p, p = _setup()
    p["dt_proj_b"] = np.linspace(18.0, 30.0, cfg_r.d_inner,
                                 dtype=np.float32)
    xc = np.random.RandomState(4).randn(2, 3, cfg_r.d_inner).astype(
        np.float32)
    want = R._ssm_params(jax.tree.map(jnp.asarray, p), cfg_r,
                         jnp.asarray(xc))
    got = P._ssm_params(to_torch(p), cfg_p, torch.from_numpy(xc))
    for g, w, what in zip(got, want, ("dt", "B", "C")):
        assert g.dtype == torch.float32
        close(g.numpy(), w, 1e-6, what)


def test_init_state_matches_reference():
    cfg_r, cfg_p, _ = _setup()
    want = R.init_ssm_state(cfg_r, 3, jnp.bfloat16)
    got = P.init_ssm_state(cfg_p, 3, torch.bfloat16, "cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype)[6:] == str(w.dtype)


@pytest.mark.parametrize("chunk", [0, 4], ids=["whole", "chunked"])
def test_engine_matches_reference(chunk):
    """Continuous batching with refills on the falcon-mamba smoke
    config: each SSM layer's (conv, ssm) state carried by the engine,
    scattered on a refill; with a chunk of 4 the joint prefills whose
    width is a multiple of 4 take the chunked scan."""
    engine_matches_reference(ARCH, ssm_chunk=chunk)
