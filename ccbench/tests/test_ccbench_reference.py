"""The plain reference: bitwise the port's CPU path at a small size, its
card path's ordered table bitwise its CPU sums, the same work whatever the
seed, and its bfloat16 control failing the limits."""

import numpy as np
import pytest
import torch

from conftest import SMALL

PAPER_SMALL = {"config": {"horizon_steps": 1300}}


def _program_and_reference(name, seed, overrides, runs=None):
    from ccbench.harness import cell as cell_mod
    from ccbench.harness import check, program
    cell = cell_mod.load(name, seed, overrides)
    grid = program.Grid(cell)
    res = grid.sweep(cell.scale(0)).run(**grid.run_kw("cpu"))
    runs = list(range(cell.runs)) if runs is None else runs
    ref = check.reference_result(cell, runs, cell.scale(0))
    ends = {roll: grid.link_ends(roll) for roll in cell.fabrics}
    return cell, check.program_view(res, runs, ends, cell), \
        check.reference_view(ref, runs, cell)


@pytest.mark.parametrize("name,overrides", [
    ("dfly1056_stages36.permutation", SMALL),
    ("clos64_paper.incast_mega", PAPER_SMALL)])
def test_reference_is_the_ports_cpu_path_bitwise(name, overrides):
    from ccbench.harness import check
    _, got, want = _program_and_reference(name, 2 ** 31 + 1, overrides)
    assert check.compare(got, want) == {"route_mismatch": 0,
                                        "trace_gap": 0.0, "summary_gap": 0.0}
    assert want["summaries"][0]["delivered_mb"] > 0


def test_the_cards_ordered_table_is_the_cpu_sum_bitwise(monkeypatch):
    from ccbench.harness import cell as cell_mod
    from ccbench.harness import check
    from ccbench.reference import model
    cell = cell_mod.load("dfly1056_stages36.permutation", 5, SMALL)
    runs = [0, 13, 26, 35]
    plain = check.reference_result(cell, runs, 1.0)
    init = model.Batch.__init__

    def with_walks(self, *a, **k):
        init(self, *a, **k)
        self._build_walks()
    monkeypatch.setattr(model.Batch, "__init__", with_walks)
    walked = check.reference_result(cell, runs, 1.0)
    for f in model.TRACE_FIELDS:
        assert np.array_equal(plain["traces"][f], walked["traces"][f]), f


def test_the_reference_agrees_with_itself_across_seeds():
    """Two seeds rename the hosts behind each router; the reference then
    delivers the same bytes a run, to rounding."""
    from ccbench.harness import cell as cell_mod
    from ccbench.harness import check
    out = []
    for seed in (3, 2 ** 31 + 9):
        cell = cell_mod.load("dfly1056_stages36.permutation", seed, SMALL)
        out.append(check.reference_result(cell, [1, 14, 22, 35], 1.0))
    a, b = (o["traces"]["delivered"][:, -1].sum(axis=1) for o in out)
    assert np.allclose(a, b, rtol=1e-5, atol=0)
    assert (a > 0).all()


@pytest.mark.parametrize("name,overrides", [
    ("dfly1056_stages36.permutation", SMALL),
    ("clos64_paper.incast_mega", PAPER_SMALL)])
def test_the_bfloat16_control_fails(name, overrides):
    """The reference in bfloat16 put in the program's place: the check
    has to call it wrong (the control of ``control.py``, at a size a test
    run holds)."""
    import importlib.util
    import os
    from conftest import ROOT
    from ccbench.harness import check
    spec = importlib.util.spec_from_file_location(
        "ccbench_control", os.path.join(ROOT, "ccbench", "control.py"))
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    got = control.control_readings(name, 11, device="cpu",
                                   overrides=overrides)
    assert not check.verdict(got), got
