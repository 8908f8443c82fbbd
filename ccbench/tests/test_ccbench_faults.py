"""A run with the timed path broken underneath has to come out not
correct: the harness's look for a card skipped (the CPU), the rest of a
run driven as the benchmark drives it, one fault planted in the program's
step at a time.  (The exchange between chips does not exist in a
one-chip cell.)"""

import pytest
import torch

from conftest import SMALL

CELL = "dfly1056_stages36.permutation"


def _state_unchanged(step):
    def broken(st, *a, **k):
        _, trace = step(st, *a, **k)
        return st, trace
    return broken


def _half_the_batch(step):
    """Only the first half of the runs advances; the rest keep their
    state."""
    def broken(st, *a, **k):
        new, trace = step(st, *a, **k)
        R = st.nicq.shape[0]

        def keep(n, o):
            if not isinstance(n, torch.Tensor) or n.dim() == 0:
                return n
            head = (torch.arange(R) < R // 2).reshape(
                (R,) + (1,) * (n.dim() - 1))
            return torch.where(head, n, o)
        return type(new)(*[
            {kk: keep(v, st.cc[kk]) for kk, v in n.items()}
            if isinstance(n, dict) else keep(n, o)
            for n, o in zip(new, st)]), trace
    return broken


def _answer_altered(step):
    """Run 0's first flow is credited twice what it delivers."""
    def broken(st, *a, **k):
        new, trace = step(st, *a, **k)
        d = new.delivered.clone()
        d[0, 0] += d[0, 0] - st.delivered[0, 0]
        return new._replace(delivered=d), trace
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered])
def test_a_broken_step_is_not_correct(run_mod, monkeypatch, fault):
    from repro_torch.core import SWEEP_EXEC_CACHE, experiments
    monkeypatch.setattr(experiments, "_step_body",
                        fault(experiments._step_body))
    SWEEP_EXEC_CACHE.clear()
    try:
        out = run_mod.run_cell(CELL, 2 ** 31 + 21, 0.2, False, device="cpu",
                               overrides=SMALL)
    finally:
        SWEEP_EXEC_CACHE.clear()
    assert out["correct"] is False, out["checks"]


def test_the_sound_step_is_correct(run_mod):
    out = run_mod.run_cell(CELL, 2 ** 31 + 21, 0.2, False, device="cpu",
                           overrides=SMALL)
    assert out["correct"] is True, out["checks"]
