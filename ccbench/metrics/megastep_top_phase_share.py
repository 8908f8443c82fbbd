"""Per cent of the megakernel's step-loop cycles (its phase timers, run
0's first CTA) spent in the costliest interval between two marks of the
loop: how far one phase dominates a step."""

from ccbench.harness import record


def read(rec):
    r = record.mega(record.last())
    cycles = [p["cycles"] for p in (r.mega_phases or [])] if r else []
    if not sum(cycles):
        return None
    return 100.0 * max(cycles) / sum(cycles)
