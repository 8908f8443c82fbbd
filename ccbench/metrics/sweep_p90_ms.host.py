"""90th percentile of the window's sweep wall times, call to
``SweepResult`` on the host, in ms: the tail of a cell whose sweeps wait
on the host's staging, kept beside its rate instead of as an end-to-end
metric, because it swings with the host from run to run."""

import statistics


def read(rec):
    lat = rec.get("sweep_ms") or []
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
