"""The port's ERP pacer (``repro_torch.dist.pacer``) against the
reference's (``repro.dist.pacer``), on the CPU.

  * ``chunk_bytes_of``: the same chunks as the reference on the same
    arrays — numpy trees, and the port's own trees of tensors (a dict, a
    list, a module's ``state_dict``) against their numpy copies;
  * ``erp_chunk_schedule`` for DCQCN and DCQCN_REV (the scheme that runs
    the ``erp_step`` kernel on the card) within the golden tolerance
    (rtol 2e-3) of the reference's schedule.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

from repro.dist import pacer as RP                           # noqa: E402
from repro_torch.dist import chunk_bytes_of, erp_chunk_schedule  # noqa: E402


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:        # no numpy bf16: same bytes
            tree = tree.view(torch.int16)
        return tree.detach().numpy()
    return tree


def _trees():
    rng = np.random.RandomState(0)
    yield {"a": rng.randn(3, 5).astype(np.float32),
           "b": [np.zeros(7, np.int32), np.ones((2, 2), np.float64)],
           "c": None}
    yield [np.zeros((1024, 1024), np.float32)] * 25     # the example's
    yield {"x": torch.zeros(13, dtype=torch.bfloat16),
           "y": (torch.ones(4, 4), torch.arange(9))}
    lin = torch.nn.Sequential(torch.nn.Linear(7, 5), torch.nn.ReLU(),
                              torch.nn.Linear(5, 3, dtype=torch.float64))
    yield lin.state_dict()


@pytest.mark.parametrize("n_chunks", [1, 3, 8, 64])
def test_chunk_bytes_equal_the_reference(n_chunks):
    for tree in _trees():
        mine = chunk_bytes_of(tree, n_chunks)
        want = RP.chunk_bytes_of(_np_tree(tree), n_chunks)
        assert mine == want
        assert len(mine) == n_chunks and max(mine) - min(mine) <= 1
    with pytest.raises(ValueError, match="positive"):
        chunk_bytes_of({}, 0)


#: 4 chunks of a 3.5 MiB tree: a 3000-step schedule (the shortest the
#: pacer's horizon allows), DCQCN's staged recovery visible in it
CHUNKS = chunk_bytes_of({"w": np.zeros((896, 1024), np.float32)}, 4)


@pytest.mark.parametrize("scheme", ["DCQCN", "DCQCN_REV"])
def test_schedule_within_golden_tolerance(scheme):
    got = erp_chunk_schedule(CHUNKS, scheme_name=scheme, device="cpu")
    want = RP.erp_chunk_schedule(CHUNKS, scheme_name=scheme)
    assert set(got) == set(want)
    assert got["scheme"] == scheme and got["bytes"] == want["bytes"]
    for k in ("completion_ms", "victim_gbps"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(got["chunks"], want["chunks"], rtol=2e-3)
    assert np.isfinite(got["completion_ms"]) and got["victim_gbps"] > 0
