"""MB of the traced sweep's staged batch structure (its scenario tensors,
reduce plan and megakernel tables) that the program's stage cache already
held, so that none of it was staged again (the program's
``stage_hit_bytes``), on any device.  None where the program keeps no
such counter."""

from ccbench.harness import record


def read(rec):
    last = record.last()
    if last is None or "stage_hit_bytes" not in last.counters:
        return None
    return last.counters["stage_hit_bytes"] / 1e6
