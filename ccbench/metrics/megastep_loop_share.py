"""Per cent of the traced sweep's timed window (its last, replayed with
the megakernel's timed instance between the program's CUDA event pair)
that the kernel's step loop fills: 100 x its ``%globaltimer``
nanoseconds, loop entry to exit in run 0's first CTA, over the window's
event time.  The rest is launch, the state's copy-in before the loop,
the sample's fold after it, and the graph's copies."""

from ccbench.harness import record


def read(rec):
    r = record.mega(record.last())
    if r is None:
        return None
    return 100.0 * r.mega_loop_ns * 1e-6 / sum(r.window_ms)
