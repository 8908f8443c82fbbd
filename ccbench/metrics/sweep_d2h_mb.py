"""MB the traced sweep copied from the card to the host (the program's
``d2h_bytes``: the traces and the final state of ``collect``, and what
the plans read back)."""

from ccbench.harness import record


def read(rec):
    return record.card_mb("d2h_bytes")
