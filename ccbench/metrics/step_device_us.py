"""Microseconds the device is busy a simulated step in the traced sweep:
the union of the profiler's kernel intervals, or the CUDA-event spans of
the replayed windows where the profiler misses the megakernel."""


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    return rec["busy_s"] * 1e6 / rec["steps"]
