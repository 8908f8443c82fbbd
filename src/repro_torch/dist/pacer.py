"""ERP-paced collective scheduling on the modelled fabric (port of
``repro.dist.pacer``).

Training traffic is the framework's own congestion workload: a cross-pod
gradient reduction is an incast of chunked flows into each pod's DCN
ports.  ``erp_chunk_schedule`` runs that incast (plus a victim tenant)
through the CC fluid model and returns the chunk completion schedule a
NIC rate-limiter would be programmed with — the paper's mechanism applied
to the collectives the serving/training stack emits.

Built on ``repro_torch.core.experiments``: every scheme evaluation is one
point of a Sweep, so repeated calls with the same chunk count share one
cached window (the scheme and chunk sizes are data); on the card the
``DCQCN_REV`` scheme launches the ``erp_step`` kernel, ``DCQCN`` the
``rp_step`` kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.experiments import ScenarioSpec, Sweep
from ..core.params import CCConfig, CCScheme


def _leaves(tree, out: list) -> list:
    """The array leaves of a dict / list / tuple / NamedTuple tree (a
    ``state_dict`` is a dict); None is an empty subtree."""
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.prod(x.shape, dtype=np.int64)) * x.dtype.itemsize


def chunk_bytes_of(tree, n_chunks: int) -> list[int]:
    """Partition a tree's total byte size into ``n_chunks`` quanta.

    ``tree`` is a dict (a ``state_dict`` too), list or tuple of tensors
    or numpy arrays.  The quanta are the injection units a NIC pacer
    schedules; they cover the tree exactly (sum == total bytes) and
    differ by at most one byte.
    """
    if n_chunks <= 0:
        raise ValueError("n_chunks must be positive")
    total = sum(_nbytes(x) for x in _leaves(tree, []))
    base, rem = divmod(total, n_chunks)
    return [base + (1 if i < rem else 0) for i in range(n_chunks)]


def _schedule_scenario(chunks, n_pods: int, cfg: CCConfig):
    """One flow per (pod-pair, chunk) into the reducing pod's port, plus
    the victim tenant of the paper's scene."""
    n_senders = max(2, 4 * max(1, n_pods - 1))
    dst = 16
    senders = [n for n in range(64) if n != dst][:n_senders]
    pairs = [(senders[i % n_senders], dst) for i in range(len(chunks))]
    pairs.append((3, 12))                       # victim tenant
    vols = list(chunks) + [float("inf")]
    spec = ScenarioSpec.flows(pairs, t_start=0.0, t_stop=float("inf"),
                              label="reduce")
    scn = spec.build(cfg)
    # per-flow volumes: chunks are unequal in general
    volume = np.asarray(vols, np.float32)
    t_stop = np.where(np.isfinite(volume), np.inf, 2e-3).astype(np.float32)
    return scn._replace(volume=volume,
                        t_stop=t_stop,
                        nic_buffer=float(2 * max(max(chunks), 1)))


def erp_chunk_schedule(chunks, n_pods: int = 2,
                       scheme_name: str = "DCQCN_REV",
                       cfg: CCConfig | None = None, *,
                       device=None) -> dict:
    """Schedule a chunked cross-pod reduction under one CC scheme.

    Returns the collective's completion time, the per-chunk completion
    schedule (what the pacer programs), and the victim tenant's
    bandwidth while the reduction is in flight.  ``device`` as in
    ``Sweep.run``: None runs on the card, ``"cpu"`` on the CPU.
    """
    if cfg is None:
        cfg = CCConfig(scheme=CCScheme[scheme_name])
    else:
        cfg = cfg.replace(scheme=CCScheme[scheme_name])
    chunks = [max(int(c), 1) for c in chunks]
    scn = _schedule_scenario(chunks, n_pods, cfg)
    # Horizon: all concurrent chunk flows share the reducing port, so the
    # fair drain is line_rate / n_concurrent; x3 slack covers DCQCN's slow
    # staged recovery (the scheme under test may be far off fair).
    n_concurrent = min(len(chunks), max(2, 4 * max(1, n_pods - 1)))
    horizon = 3.0 * max(chunks) * n_concurrent / cfg.link.line_rate + 2e-3
    n_steps = int(math.ceil(horizon / cfg.sim.dt / 1000.0)) * 1000
    res = Sweep([("reduce", cfg, scn)]).run(n_steps=n_steps,
                                            device=device)["reduce"]
    ct = res.completion_times()
    chunk_ct = ct[: len(chunks)]
    victim = res.mean_throughput_while_active()[-1]
    done = float(np.nanmax(chunk_ct)) if np.isfinite(chunk_ct).any() \
        else float("nan")
    return {
        "scheme": scheme_name,
        "completion_ms": done * 1e3,
        "chunks": [float(c) * 1e3 for c in np.nan_to_num(chunk_ct)],
        "victim_gbps": float(victim) / 1e9,
        "bytes": int(sum(chunks)),
    }
