"""The port's ``pipeline_apply`` (``repro_torch.dist.pipeline``) against
the reference's on the same numpy inputs, on the CPU: the reference's
own one-stage case (``tests/test_substrates.py``) and three stages of
``tanh(x @ W + b)``, within 1e-6 of the largest output in float32; and
the reference's two refusals."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
from repro.dist.pipeline import pipeline_apply as ref_apply  # noqa: E402

from repro_torch.dist.pipeline import pipeline_apply        # noqa: E402

POD = types.SimpleNamespace(mesh_dim_names=("pod",))


def _ref_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _inputs(S, M, B, D, seed):
    g = np.random.default_rng(seed)
    w = (g.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    b = (0.1 * g.standard_normal((S, D))).astype(np.float32)
    xs = g.standard_normal((M, B, D)).astype(np.float32)
    return {"w": w, "b": b}, xs


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


def test_one_stage_matches_reference_case():
    """The reference's case: S = 1, ``x @ p + 1`` over 3 microbatches."""
    w = np.asarray([[2.0]], np.float32)
    xs = np.arange(6.0, dtype=np.float32).reshape(3, 2, 1)
    want = ref_apply(lambda p, x: x @ p + 1.0, jnp.stack([w]),
                     jnp.asarray(xs), jax.make_mesh((1,), ("pod",)),
                     n_stages=1, axis="pod")
    got = pipeline_apply(lambda p, x: x @ p + 1.0,
                         torch.from_numpy(w)[None], torch.from_numpy(xs),
                         POD, n_stages=1, axis="pod")
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([x @ w + 1.0 for x in xs]))


@pytest.mark.parametrize("S, M", [(1, 4), (3, 5)])
def test_stages_match_reference(S, M):
    params, xs = _inputs(S, M, 8, 32, seed=S)
    want = ref_apply(_ref_stage, {k: jnp.asarray(v) for k, v in
                                  params.items()}, jnp.asarray(xs),
                     jax.make_mesh((1,), ("pod",)), n_stages=S)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got = pipeline_apply(_stage, tp, torch.from_numpy(xs), POD, n_stages=S)
    _close(got.numpy(), want)
    # the stages applied back to back, microbatch by microbatch
    seq = []
    for x in torch.from_numpy(xs):
        for s in range(S):
            x = _stage({k: v[s] for k, v in tp.items()}, x)
        seq.append(x)
    assert torch.equal(got, torch.stack(seq))


def test_refuses_params_of_another_stage_count():
    params, xs = _inputs(2, 3, 4, 8, seed=0)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="n_stages"):
        pipeline_apply(_stage, tp, torch.from_numpy(xs), POD, n_stages=3)


def test_refuses_a_mesh_without_the_axis_and_passes_one_without_names():
    params, xs = _inputs(1, 2, 4, 8, seed=1)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x = torch.from_numpy(xs)
    with pytest.raises(ValueError, match="no axis 'pod'"):
        pipeline_apply(_stage, tp, x,
                       types.SimpleNamespace(mesh_dim_names=("data",)),
                       n_stages=1)
    out = pipeline_apply(_stage, tp, x, object(), n_stages=1)
    assert torch.equal(out, pipeline_apply(_stage, tp, x, POD, n_stages=1))
