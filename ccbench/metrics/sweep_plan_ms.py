"""Host milliseconds of the traced sweep's ``sweep.plan`` span: the
reduce plan, the packed reaction rows and, on the mega tier, the
megakernel's plan, which depend on the batch's structure alone."""

from ccbench.harness import record


def read(rec):
    return record.span_ms("sweep.plan")
