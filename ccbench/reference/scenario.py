"""One run's scenario arrays for the reference, from the cell's data.

A scene (from ``harness.traffic``) lists each flow's source and destination
host, its generator window, volume and rate (a fraction of the line rate),
and the NIC buffer.  The fabric routes every pair minimally; the CNP delay
of a flow is its round trip over its hops, quantised to ``dt`` steps.
"""

from __future__ import annotations

import numpy as np


def flow_jitter(n: int) -> np.ndarray:
    """Deterministic per-flow jitter in [-1, 1] (a Weyl sequence), which
    desynchronises the ERP recovery slopes."""
    x = (np.arange(n, dtype=np.uint64) * np.uint64(2654435761)) \
        % np.uint64(2 ** 32)
    return (x.astype(np.float64) / 2 ** 31 - 1.0).astype(np.float32)


def build(fab, scene: dict, link: dict, dt: float) -> dict:
    src, dst = scene["src"], scene["dst"]
    F = len(src)
    routes = fab.routes(src, dst)
    hops = (routes != -1).sum(axis=1).astype(np.int32)
    per_hop = link["propagation_delay"] + link["mtu"] / link["line_rate"]
    rtt = 2 * hops * per_hop + 1e-6
    rtt_steps = np.maximum(2, np.round(rtt / dt)).astype(np.int32)
    line = link["line_rate"]
    rates = (-np.asarray(scene["rate_frac"], np.float32)).astype(np.float64)
    rates = np.where(np.isfinite(rates), rates, line)
    rates = np.where(rates < 0, -rates * line, rates).astype(np.float32)
    return dict(
        routes=routes, hops=hops, gen_rate=rates,
        t_start=np.asarray(scene["t_start"], np.float32),
        t_stop=np.asarray(scene["t_stop"], np.float32),
        volume=np.asarray(scene["volume"], np.float32),
        capacity=np.full((fab.n_links,), line, np.float64).astype(
            np.float32),
        sink_switch=fab.sink_switch(), n_switches=fab.n_switches,
        rtt_steps=rtt_steps,
        nic_buffer=np.broadcast_to(np.asarray(scene["nic_buffer"],
                                              np.float32), (F,)).copy(),
        victim=np.asarray(scene["victim"], bool),
        jitter=flow_jitter(F))
