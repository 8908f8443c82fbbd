"""MB of the traced sweep's batch that the program's put cache already
held, so that nothing was copied for them (the program's
``put_hit_bytes``), on any device."""

from ccbench.harness import record


def read(rec):
    return record.mb("put_hit_bytes")
