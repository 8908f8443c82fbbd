"""The port's checkpoints (``repro_torch.ckpt``): the reference's
kill-point cases (``tests/test_ckpt.py``) on the port, and checkpoints
read across the two packages bit for bit.

The commit protocol is temp dir + fsync + atomic rename + a fsync'd
``.done`` marker, so every kill point leaves no trace, an ignorable
``.tmp`` orphan, or a fully committed checkpoint; a committed but
unreadable newest step is skipped on load.
"""

import json
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ckpt as CR                                 # noqa: E402
from repro_torch.ckpt import (CheckpointManager,             # noqa: E402
                              committed_steps, latest_step,
                              load_checkpoint, save_checkpoint)

TREE = {"a": torch.arange(6.0), "b": {"c": torch.ones((2, 3))}}


class Pair(NamedTuple):
    x: np.ndarray
    y: np.ndarray


def _corrupt(path: str, data: bytes = b"torn") -> None:
    with open(path, "wb") as f:
        f.write(data)


def _tree(seed: int) -> dict:
    """A mixed tree (float64 / float32 / int32 leaves, a NamedTuple, a
    tuple) made from a seed."""
    g = np.random.default_rng(seed)
    return {"theta": g.standard_normal(4),
            "hist": g.standard_normal((3, 4)).astype(np.float32),
            "pair": Pair(np.arange(5, dtype=np.int32),
                         g.standard_normal(2)),
            "seq": (np.float64(g.standard_normal()), np.zeros((0, 2)))}


def _assert_tree_equal(a, b):
    if isinstance(a, (dict, tuple)):
        assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_committed_steps_ignores_unmarked_dirs(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, TREE)
    save_checkpoint(d, 2, TREE)
    os.remove(os.path.join(d, "step_000000002.done"))
    assert committed_steps(d) == [1]
    assert latest_step(d) == 1


@pytest.mark.parametrize("torn", ["arrays.npz", "manifest.json"])
def test_load_skips_torn_newest_checkpoint(tmp_path, torn):
    d = str(tmp_path)
    save_checkpoint(d, 1, TREE, extra={"v": 1})
    save_checkpoint(d, 2, TREE, extra={"v": 2})
    _corrupt(os.path.join(d, "step_000000002", torn),
             b'{"truncated' if torn.endswith(".json") else b"torn")
    got, extra = load_checkpoint(d)
    assert extra["v"] == 1
    np.testing.assert_array_equal(got["a"], np.arange(6.0))


def test_explicit_uncommitted_step_is_an_error(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, TREE)
    os.remove(os.path.join(d, "step_000000003.done"))
    with pytest.raises(FileNotFoundError, match="torn write"):
        load_checkpoint(d, step=3)


def test_all_torn_reports_every_reason(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, TREE)
    _corrupt(os.path.join(d, "step_000000001", "arrays.npz"))
    with pytest.raises(FileNotFoundError, match="step 1"):
        load_checkpoint(d)


def test_save_overwrites_stale_tmp_orphan(tmp_path):
    d = str(tmp_path)
    tmp = os.path.join(d, "step_000000005.tmp")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "garbage"), "w") as f:
        f.write("partial")
    save_checkpoint(d, 5, TREE, extra={"ok": True})
    got, extra = load_checkpoint(d, step=5)
    assert extra["ok"] is True
    np.testing.assert_array_equal(got["b"]["c"], np.ones((2, 3)))


def test_manifest_extra_survives_and_device_restore(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, TREE, extra={"digest": "abc"})
    with open(os.path.join(d, "step_000000001", "manifest.json")) as f:
        assert json.load(f)["extra"]["digest"] == "abc"
    got, _ = load_checkpoint(d, device="cpu")
    assert isinstance(got["a"], torch.Tensor)
    assert torch.equal(got["a"], TREE["a"])


def test_manager_save_async_commits_atomically(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    for s in (1, 2, 3):
        mgr.save_async(s, {"x": torch.full((4,), float(s))},
                       extra={"s": s})
    mgr.wait()
    assert committed_steps(d) == [2, 3]
    got, extra = load_checkpoint(d)
    assert extra["s"] == 3
    assert float(got["x"][0]) == 3.0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A checkpoint either package wrote loads in the other to the same
    arrays, dtypes and nesting (NamedTuples through ``nt_registry``)."""
    d = str(tmp_path)
    trees = {s: _tree(s) for s in (1, 2)}
    save, load = ((CR.save_checkpoint, load_checkpoint)
                  if writer == "reference"
                  else (save_checkpoint, CR.load_checkpoint))
    for s, tree in trees.items():
        save(d, s, tree, extra={"it": s})
    assert committed_steps(d) == CR.committed_steps(d) == [1, 2]
    got, extra = load(d, nt_registry={"Pair": Pair})
    assert extra == {"it": 2}
    _assert_tree_equal(trees[2], got)
    got, _ = load(d, step=1, nt_registry={"Pair": Pair})
    _assert_tree_equal(trees[1], got)
    # and the other package's torn-step skipping applies to it too
    _corrupt(os.path.join(d, "step_000000002", "arrays.npz"))
    got, extra = load(d, nt_registry={"Pair": Pair})
    assert extra == {"it": 1}
