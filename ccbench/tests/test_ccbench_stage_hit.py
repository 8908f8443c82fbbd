"""The stage cache's reader: the traced dry run on the CPU follows
``Sweep.prepare`` of its batch, so its sweep finds its structure in the
program's stage cache and ``sweep_stage_hit_mb`` is on the result line;
a record without the counter, or no record, reads None."""

import json

from conftest import SMALL

CELL = "dfly1056_stages36.permutation"


def test_traced_dry_run_reads_the_stage_hit(run_mod):
    _, e2e, per_layer = run_mod.benchmark_entry(CELL)
    out = run_mod.run_cell(CELL, 2 ** 31 + 7, 0.5, True, device="cpu",
                           overrides=SMALL, e2e=e2e, per_layer=per_layer)
    line = json.loads(run_mod.result_line(out))
    assert line["correct"] is True
    hit = line["metrics"]["sweep_stage_hit_mb"]
    assert hit["value"] > 0 and hit["unit"] == "MB"


def test_stage_hit_reader(run_mod, monkeypatch):
    from repro_torch.core import obs
    read = run_mod.reader("sweep_stage_hit_mb")
    rec = obs.Record(runs=12, device="cpu", profiled=False)
    rec.counters = {"h2d_bytes": 0, "put_hit_bytes": 0,
                    "digest_bytes": 6_730_000, "d2h_bytes": 0,
                    "stage_hit_bytes": 74_530_000}
    monkeypatch.setattr(obs, "last", lambda: rec)
    assert read({}) == 74.53
    # a program that keeps no such counter
    del rec.counters["stage_hit_bytes"]
    assert read({}) is None
    monkeypatch.setattr(obs, "last", lambda: None)
    assert read({}) is None
