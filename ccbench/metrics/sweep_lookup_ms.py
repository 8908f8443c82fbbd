"""Host milliseconds of the traced sweep's ``sweep.lookup`` span: the
batch's structural signature, the executable cache's lookup and the copy
of the batch into the cached window's own tensors (with a capture on a
miss, which the window should never need)."""

from ccbench.harness import record


def read(rec):
    return record.span_ms("sweep.lookup")
