"""Mean host microseconds of the traced sweep's ``window`` spans: one
window's ``advance()`` (a graph replay on the card) and the copy of its
sample, as the host issues them."""

from ccbench.harness import record


def read(rec):
    r = record.last()
    spans = [] if r is None else r.named("window")
    if not spans:
        return None
    return sum(s.ns for s in spans) / len(spans) * 1e-3
