"""MB the traced sweep copied from the host to the card (the program's
``h2d_bytes``: the batch's upload, its initial state and parameters, and
its plans; a put-cache hit uploads nothing)."""

from ccbench.harness import record


def read(rec):
    return record.card_mb("h2d_bytes")
