"""The one traffic generator: a mix file's parameters and a seed -> scenes.

A scene is one flow set on the fabric: per flow its source and destination
host, generator window (``t_start``, ``t_stop``, seconds), volume (bytes;
inf = window-limited) and rate as a fraction of the line rate, plus the NIC
buffer and the flows marked as victims.  Patterns:

* ``permutation``: ``n_flows`` sources drawn with replacement, each sending
  to its image under one random permutation of the hosts (the program's
  ``ScenarioSpec.permutation``), from the mix's ``base_seed``.
* ``hotspot``: ``hot_frac`` of the flows into ``hot_node`` at line rate,
  the rest random pairs at ``bg_rate_frac`` (``workloads.hotspot``).
* ``scenes``: explicit flow lists, fixed by the mix (the paper's incast).

``relabel: "within_router"`` renames the hosts behind each first-hop
switch by a permutation drawn from the run's seed.  Every link then
carries as many flows, over as many hops, as before: the seed changes
which hosts talk, never how much work the sweep is.
"""

from __future__ import annotations

import numpy as np

INF = float("inf")


def _permutation(n_hosts: int, n_flows: int, seed: int):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n_hosts)
    srcs = rng.choice(n_hosts, size=n_flows, replace=n_flows > n_hosts)
    src, dst = [], []
    for s in srcs:
        d = int(perm[s % n_hosts])
        if d == s:
            d = (d + 1) % n_hosts
        src.append(int(s))
        dst.append(d)
    return src, dst


def _hotspot(n_hosts: int, n_flows: int, hot_frac: float, hot_node: int,
             bg_rate_frac: float, seed: int):
    rng = np.random.RandomState(seed)
    n_hot = int(round(n_flows * hot_frac))
    others = [v for v in range(n_hosts) if v != hot_node]
    src, dst, rate = [], [], []
    for _ in range(n_hot):
        src.append(others[int(rng.randint(len(others)))])
        dst.append(hot_node)
        rate.append(1.0)
    for _ in range(n_flows - n_hot):
        s = int(rng.randint(n_hosts))
        d = int(rng.randint(n_hosts - 1))
        src.append(s)
        dst.append(d + 1 if d >= s else d)
        rate.append(bg_rate_frac)
    return src, dst, rate


def _within_router(fab, rng) -> np.ndarray:
    """A host renaming that keeps every host behind its first-hop switch."""
    first = fab.link_dst[:fab.n_hosts]          # host n's uplink is link n
    out = np.arange(fab.n_hosts)
    for sw in np.unique(first):
        hosts = np.flatnonzero(first == sw)
        out[hosts] = rng.permutation(hosts)
    return out


def scenes(mix: dict, fab, seed: int) -> list[dict]:
    """The mix's scenes for one run seed (``fab``: a reference fabric)."""
    pat = mix["pattern"]
    n = fab.n_hosts
    if pat == "scenes":
        out = []
        for sc in mix["scenes"]:
            F = len(sc["pairs"])
            per = lambda key, default: [sc.get(key, default)] * F  # noqa
            out.append(dict(
                name=sc["name"], src=[p[0] for p in sc["pairs"]],
                dst=[p[1] for p in sc["pairs"]],
                t_start=per("t_start", 0.0), t_stop=per("t_stop", INF),
                volume=per("volume", INF), rate_frac=per("rate_frac", 1.0),
                nic_buffer=sc["nic_buffer"],
                victim=sc.get("victim", [False] * F)))
        return out
    if pat == "permutation":
        src, dst = _permutation(n, mix["n_flows"], mix["base_seed"])
        rate = [mix.get("rate_frac", 1.0)] * len(src)
    elif pat == "hotspot":
        src, dst, rate = _hotspot(n, mix["n_flows"], mix["hot_frac"],
                                  mix["hot_node"], mix["bg_rate_frac"],
                                  mix["base_seed"])
    else:
        raise ValueError(f"unknown traffic pattern {pat!r}")
    if mix.get("relabel") == "within_router":
        name = _within_router(fab, np.random.default_rng([seed, 1]))
        src, dst = [int(name[s]) for s in src], [int(name[d]) for d in dst]
    F = len(src)
    return [dict(name=mix.get("label", pat), src=src, dst=dst,
                 t_start=[mix["t_start"]] * F, t_stop=[mix["t_stop"]] * F,
                 volume=[mix.get("volume", INF)] * F, rate_frac=rate,
                 nic_buffer=mix["nic_buffer"], victim=[False] * F)]
