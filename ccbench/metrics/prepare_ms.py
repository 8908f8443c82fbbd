"""Host milliseconds of ``Sweep.prepare`` at the cell's shapes (stacking,
padding, the reduce plan and, on the mega tier, the megakernel's plan),
synchronised before and after: the staging every sweep of the window pays
before its first window runs."""


def read(rec):
    return rec["prepare_ms"]
