"""MB the traced sweep hashed to look up its batch in the program's
content caches (the program's ``digest_bytes``: the put cache's fields
and the route stacks of the incidence cache), on any device."""

from ccbench.harness import record


def read(rec):
    return record.mb("digest_bytes")
