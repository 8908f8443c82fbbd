"""A tiny run of ``run.py`` on the CPU gives the contract's last line, and
on a machine without a card the command refuses and prints nothing."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL

CELL = "dfly1056_stages36.permutation"


def _line(run_mod, trace: bool) -> dict:
    _, e2e, per_layer = run_mod.benchmark_entry(CELL)
    out = run_mod.run_cell(CELL, 2 ** 31 + 3, 0.5, trace, device="cpu",
                           overrides=SMALL, e2e=e2e, per_layer=per_layer)
    return json.loads(run_mod.result_line(out))


def test_dry_run_prints_the_contract_line(run_mod):
    line = _line(run_mod, trace=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"run_steps_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_traced_dry_run_reads_the_layers(run_mod):
    line = _line(run_mod, trace=True)
    assert line["correct"] is True
    assert {"scenario_build_s", "prepare_ms",
            "exec_cache_misses"} <= set(line["metrics"])
    assert line["metrics"]["exec_cache_misses"]["value"] == 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "window_s" in line["device"] and "busy_s" in line["device"]


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is not reachable")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "ccbench", "run.py"),
         "--workload", CELL, "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_host_tail_reader_is_the_end_to_end_p90(run_mod):
    import statistics
    lat = [400.0, 410.5, 395.2, 620.0, 405.1, 399.9, 402.3, 401.0, 398.7,
           430.2, 415.4]
    read = run_mod.reader("sweep_p90_ms.host")
    assert read({"sweep_ms": lat}) == statistics.quantiles(
        lat, n=10, method="inclusive")[8]
    assert read({"sweep_ms": lat[:1]}) is None
