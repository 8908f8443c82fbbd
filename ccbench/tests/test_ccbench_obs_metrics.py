"""The traced dry run on the CPU reads the program's own record of the
traced sweep: its span and put-cache metrics are on the result line, and
the readers of what only a card gives (bytes to and from a card, the
megakernel's timers) leave theirs out."""

import json

from conftest import SMALL

CELL = "dfly1056_stages36.permutation"
SPANS = ("sweep_stage_ms", "sweep_plan_ms", "sweep_lookup_ms",
         "window_host_us")
#: the put cache's counters, kept on any device
CACHE = ("sweep_digest_mb", "sweep_put_hit_mb")


def test_traced_dry_run_reads_the_programs_record(run_mod):
    _, e2e, per_layer = run_mod.benchmark_entry(CELL)
    out = run_mod.run_cell(CELL, 2 ** 31 + 5, 0.5, True, device="cpu",
                           overrides=SMALL, e2e=e2e, per_layer=per_layer)
    line = json.loads(run_mod.result_line(out))
    assert line["correct"] is True
    metrics = line["metrics"]
    for name in SPANS:
        assert metrics[name]["value"] > 0, name
        assert metrics[name]["unit"] in ("ms", "us"), name
    for name in CACHE:
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "MB"
    assert "sweep_h2d_mb" not in metrics and "sweep_d2h_mb" not in metrics
    assert {m["name"] for m in per_layer} >= set(SPANS)
