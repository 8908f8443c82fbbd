"""The roofline counts against hand counts at a small shape, and the
readers built on them."""

import importlib.util
import os

import pytest

from conftest import ROOT


def _load(*parts):
    path = os.path.join(ROOT, "ccbench", *parts)
    spec = importlib.util.spec_from_file_location(
        "t_" + "_".join(parts).replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,ops,words", [
    ("gen_np_step", 9, 13), ("rp_step", 24, 17), ("erp_step", 9, 7),
    ("swift_step", 13, 5)])
def test_cc_kernel_counts(name, ops, words):
    from ccbench.roofline import cc_kernels as roof
    R, F = 2, 3
    assert roof.ops_bytes(name, R, F) == (ops * 6, 4 * words * 6)
    want = max(4 * words * 6 / 3.35e12, ops * 6 / 67e12)
    assert roof.bound_s(name, R, F) == pytest.approx(want, rel=1e-12)


def test_megastep_block_counts():
    from ccbench.roofline import megastep_block as roof
    shapes = {"R": 2, "F": 3, "K": 1, "H": 4, "state_bytes": 1000,
              "scenario_bytes": 500, "entries": 17}
    ops, nbytes = roof.ops_bytes(shapes, 10)
    assert ops == 10 * (48 * 2 * 3 * 4 + 8 * 17)
    assert nbytes == 2 * 1000 + 500 + (4 * 6 * 3 + 4 * 6 + 16 * 2)
    assert roof.bound_s(shapes, 10) == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12))


def test_cc_roofline_reader():
    from ccbench.roofline import cc_kernels as roof
    read = _load("metrics", "cc_kernels_roofline.py").read
    rec = {"shapes": {"R": 36, "F": 4096},
           "launches": {k: 10 for k in roof.KERNELS},
           "kernel_s": {"void gen_np_kernel<>": 4e-5, "void rp_kernel": 3e-5,
                        "void erp_kernel": 2e-5, "swift_kernel(...)": 2e-5,
                        "elementwise": 1.0}}
    bound = sum(10 * roof.bound_s(k, 36, 4096) for k in roof.KERNELS)
    assert read(rec) == pytest.approx(100 * bound / 1.1e-4)
    rec["kernel_s"] = {"elementwise": 1.0}
    assert read(rec) is None


def test_mega_roofline_reader_reads_nothing_on_the_flow_tier():
    read = _load("metrics", "megastep_block_roofline.py").read
    assert read({"tier": "flow", "window_ms": [1.0]}) is None
    shapes = {"R": 1, "F": 1, "K": 1, "H": 1, "state_bytes": 0,
              "scenario_bytes": 0, "entries": 0}
    rec = {"tier": "mega", "window_ms": [2.0, 4.0], "shapes": shapes,
           "trace_every": 10}
    from ccbench.roofline import megastep_block as roof
    assert read(rec) == pytest.approx(100 * roof.bound_s(shapes, 10) / 3e-3)
