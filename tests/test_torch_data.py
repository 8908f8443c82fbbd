"""The port's data pipeline (``repro_torch.data``) against the
reference's, on the CPU: every batch bitwise equal, for each kind, for
several hosts and for a resume at any step."""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import DataConfig as DataConfig_R               # noqa: E402
from repro.data import SyntheticLM as SyntheticLM_R             # noqa: E402
from repro.data import make_batches as make_batches_R           # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM, make_batches  # noqa: E402


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b) == ["labels", "tokens"]
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["zipf", "markov", "uniform"])
@pytest.mark.parametrize("n_hosts", [1, 4])
def test_batches_bitwise_reference(kind, n_hosts):
    kw = dict(vocab=97, seq_len=24, global_batch=8, seed=11, kind=kind,
              n_hosts=n_hosts)
    for host in range(n_hosts):
        got = SyntheticLM(DataConfig(**kw, host_id=host))
        want = SyntheticLM_R(DataConfig_R(**kw, host_id=host))
        assert got.cfg.host_batch == 8 // n_hosts
        for step in (0, 1, 7, 2**32 + 3):
            _equal(got.batch_at(step), want.batch_at(step))
        _equal(next(iter(got)), want.batch_at(0))


@pytest.mark.parametrize("start", [0, 5, 123])
def test_resume_at_any_step(start):
    kw = dict(vocab=512, seq_len=16, global_batch=4, kind="markov")
    got = list(itertools.islice(make_batches(DataConfig(**kw), start), 3))
    want = list(itertools.islice(make_batches_R(DataConfig_R(**kw), start),
                                 3))
    assert [s for s, _ in got] == [s for s, _ in want] == \
        [start, start + 1, start + 2]
    for (_, a), (_, b) in zip(got, want):
        _equal(a, b)
    # a resumed stream is the uninterrupted one from that step on
    full = dict(itertools.islice(make_batches(DataConfig(**kw)), start + 3))
    for s, b in got:
        _equal(full[s], b)


def test_hosts_draw_different_shards():
    kw = dict(vocab=1000, seq_len=8, global_batch=4, n_hosts=2)
    a = SyntheticLM(DataConfig(**kw, host_id=0)).batch_at(3)["tokens"]
    b = SyntheticLM(DataConfig(**kw, host_id=1)).batch_at(3)["tokens"]
    assert a.shape == b.shape == (2, 8)
    assert not np.array_equal(a, b)
