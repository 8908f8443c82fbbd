"""Misses of the program's ``SWEEP_EXEC_CACHE`` from the start of the
measured window through the traced sweep: each is a window captured
anew, which the window should never need."""


def read(rec):
    return rec["cache"]["misses"]
