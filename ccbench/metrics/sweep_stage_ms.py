"""Host milliseconds of the traced sweep's ``sweep.stage`` span: the
program's ``Sweep._prepare`` up to the plans (stacking and padding the
runs, their upload, the initial state, the parameters, the dense rows)."""

from ccbench.harness import record


def read(rec):
    return record.span_ms("sweep.stage")
