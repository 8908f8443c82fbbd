"""Deterministic synthetic LM data pipeline (port of
``repro.data.pipeline``, which is numpy under a JAX import: the port
keeps its own copy, unchanged, so every batch is bitwise the
reference's).

Production shape: host-sharded, stateful (exact-resume via the checkpoint
manifest), backpressure-free.  The generator is a counter-based PRNG
(Philox keyed on (seed, step, shard)) so any host can materialise its
shard of any step independently — the property that makes elastic
restart and straggler skip-ahead trivial: state == an integer.

Also provides a Zipf-mixture "naturalish" token distribution so loss
curves have realistic structure.  Batches are numpy int32 arrays; the
train step moves them to its state's device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "zipf"            # zipf | markov | uniform
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Stateless-per-step generator; state is just the step counter."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed Zipf ranks + a deterministic bigram shift for structure
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self._zipf_p = (1.0 / ranks ** 1.2)
        self._zipf_p /= self._zipf_p.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        key = ((cfg.seed & 0xFFFFFFFF) << 96) | ((step & 0xFFFFFFFF) << 64) \
            | ((cfg.host_id & 0xFFFFFFFF) << 32) | 0xC0FFEE
        rng = np.random.Generator(np.random.Philox(key=key))
        b, t = cfg.host_batch, cfg.seq_len
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab, size=(b, t + 1))
        elif cfg.kind == "markov":
            # learnable structure: x_{i+1} = (a*x_i + noise) mod vocab
            toks = np.zeros((b, t + 1), np.int64)
            toks[:, 0] = rng.integers(0, cfg.vocab, size=b)
            noise = rng.integers(0, 7, size=(b, t))
            for i in range(t):
                toks[:, i + 1] = (toks[:, i] * 31 + 17 + noise[:, i]) \
                    % cfg.vocab
        else:  # zipf
            toks = rng.choice(cfg.vocab, size=(b, t + 1), p=self._zipf_p)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batches(cfg: DataConfig, start_step: int = 0):
    """Iterator of (step, batch) resuming exactly at `start_step`."""
    ds = SyntheticLM(cfg)
    step = start_step
    while True:
        yield step, ds.batch_at(step)
        step += 1
