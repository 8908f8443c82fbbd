"""Per cent of the traced sweep's wall time in which no kernel ran on the
device: 100 x (1 - busy / wall)."""


def read(rec):
    if rec["wall_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["wall_s"])
