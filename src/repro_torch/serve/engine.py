"""Batched serving: continuous-batching engine over prefill/decode steps
(port of ``repro.serve.engine``).

``make_serve_step`` / ``make_prefill`` are the reference's step
builders.  ``ServingEngine`` is the host-side request manager: slot-based
continuous batching (a finished sequence's slot is refilled by the next
queued request without stopping the batch), greedy or temperature
sampling.  The model runs on the engine's device (the card unless
``device="cpu"``); sampling stays on the host in numpy with the
reference's ``RandomState(0)``, so greedy tokens can equal the
reference's.

Where the reference jits its step once, the engine captures its decode
step once as a CUDA graph (on the card): the caches are the engine's own
per-layer ``KVCache`` tensors (batch on axis 0), allocated by its first
joint prefill and rewritten in place by every later one, so the graph
always reads the same storage; its inputs are the token tensor and the
device position ``pos``.  Prefill is not captured.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.fluid import resolve_device
from ..kernels.capture import CapturedGraph, warm_up
from ..models import transformer
from ..models.attention import KVCache
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8
    max_len: int = 2048
    temperature: float = 0.0      # 0 = greedy
    eos_token: int = 1


def make_serve_step(cfg: ModelConfig):
    """(params, token [b,1], caches, pos []) -> (logits, caches)."""
    def serve_step(params, token, caches, pos):
        return transformer.decode_step(params, cfg, token, caches, pos)
    return serve_step


def make_prefill(cfg: ModelConfig, max_len: int):
    """(params, tokens [b,t], caches=None) -> (logits, caches); given
    caches are rewritten in place (``transformer.prefill``)."""
    def prefill(params, tokens, caches=None):
        return transformer.prefill(params, cfg, tokens, max_len,
                                   caches=caches)
    return prefill


class ServingEngine:
    """Host-side continuous batching over a fixed slot grid.

    All slots share one decode position counter (padded prefixes);
    per-slot alive masks handle ragged completion.  When a slot's
    sequence ends (EOS or budget) the next queued request is *refilled*
    into that slot mid-flight — its prompt is prefilled left-padded to
    the batch's current position and the fresh KV rows are scattered
    into the live caches — so the batch never stalls on its slowest
    member.  Rows are independent under the causal position mask, so a
    refilled slot's output is identical to serving it alone with the
    same left padding.

    ``params`` must lie on ``device`` (``None`` = the card; raises
    without one unless ``device="cpu"``).  On the card the first decode
    step runs eagerly on a side stream (the capture's warm-up) and is
    then captured; every later step, in this and later ``generate``
    calls, is one replay (``captures`` counts captures: one an engine).
    A failed capture raises.  The host's ``pos`` makes the scheduling
    decisions; the device ``pos`` is what the step reads.
    """

    def __init__(self, cfg: ModelConfig, params, sv: ServeConfig,
                 device=None):
        self.device = resolve_device(device)
        transformer.check_ported(cfg)
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"ServingEngine: params on {table.device}, "
                             f"engine on {self.device}")
        self.cfg, self.params, self.sv = cfg, params, sv
        self.rng = np.random.RandomState(0)
        self.stats = {"prefills": 0, "refills": 0, "decode_steps": 0}
        self._serve_step = make_serve_step(cfg)
        self._prefill_fn = make_prefill(cfg, sv.max_len)
        # the decode step's inputs: the engine's caches (every layer's
        # ``pos`` is ``_pos``), the token and the position
        self._caches = None
        self._pos = torch.zeros((), dtype=torch.int32, device=self.device)
        self._token = torch.zeros((sv.batch_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self._graph = None
        self.captures = 0

    # -- model calls --------------------------------------------------------
    @torch.no_grad()
    def _prefill(self, grid: np.ndarray, into=None):
        """Prefill ``grid``; ``into`` = the engine's caches (a joint
        prefill rewrites them), None = a fresh set (a refill's)."""
        tokens = torch.from_numpy(grid).to(self.device)
        return self._prefill_fn(self.params, tokens, into)

    def _joint_prefill(self, grid: np.ndarray):
        """Restart the grid: prefill into the engine's caches (the first
        one allocates them) and set the device position."""
        logits, fresh = self._prefill(grid, self._caches)
        if self._caches is None:
            self._caches = [KVCache(k=c.k, v=c.v, pos=self._pos)
                            for c in fresh]
        self._pos.copy_(fresh[0].pos)
        return logits

    def _decode(self):
        logits, new = self._serve_step(self.params, self._token,
                                       self._caches, self._pos)
        self._pos.copy_(new[0].pos)
        return logits

    @torch.no_grad()
    def _step(self, cur: np.ndarray):
        """One decode step of every slot from tokens ``cur`` [B]; the
        logits (on the card: the graph's output, rewritten next step)."""
        self._token.copy_(torch.from_numpy(
            np.ascontiguousarray(cur[:, None], np.int32)))
        if self.device.type != "cuda":
            return self._decode()
        if self._graph is None:
            logits = warm_up(self._decode)        # this step, for real
            self._graph = CapturedGraph(self._decode)
            self.captures += 1
            return logits
        self._graph.replay()
        return self._graph.out

    # -- scheduling ---------------------------------------------------------
    def generate(self, prompts: list[list[int]],
                 max_new_tokens: int = 32) -> list[list[int]]:
        """Serve a queue of prompts through the slot grid.

        Continuous batching: a finished slot is refilled from the queue
        head while the rest of the batch keeps decoding (strict FIFO; a
        head prompt longer than the current position waits for the next
        joint prefill).  Unlike the wave scheduler, a refilled request's
        first (prefill-sampled) token is also EOS-checked.
        """
        sv = self.sv
        queue = list(enumerate(prompts))
        outputs: dict[int, list[int]] = {i: [] for i in range(len(prompts))}
        B = sv.batch_slots
        self.stats = {"prefills": 0, "refills": 0, "decode_steps": 0}
        slot_id = np.full((B,), -1, np.int64)    # request id, -1 = free
        remaining = np.zeros((B,), np.int64)     # decode budget per slot
        cur = np.zeros((B,), np.int32)           # token for position `pos`
        pos = 0

        while queue or (slot_id >= 0).any():
            if not (slot_id >= 0).any():
                # joint prefill: restart the grid with the next B requests
                wave, queue = queue[:B], queue[B:]
                plen = max(len(t) for _, t in wave)
                grid = np.zeros((B, plen), np.int32)
                for i, (_, t) in enumerate(wave):
                    grid[i, plen - len(t):] = t           # left-pad
                logits = self._joint_prefill(grid)
                last = self._sample(logits[:, -1].cpu().numpy())
                pos, cur = plen, last
                self.stats["prefills"] += 1
                for i, (rid, _) in enumerate(wave):
                    slot_id[i] = rid
                    remaining[i] = max_new_tokens - 1
                    outputs[rid].append(int(last[i]))
                    if last[i] == sv.eos_token or remaining[i] <= 0:
                        slot_id[i] = -1
                continue

            # refill free slots from the queue head (prompts that fit
            # in the current position; longer ones wait for a restart)
            free = [i for i in range(B) if slot_id[i] < 0]
            fill = []
            while queue and free and len(queue[0][1]) <= pos:
                fill.append((free.pop(0), queue.pop(0)))
            if fill:
                grid = np.zeros((B, pos), np.int32)
                for slot, (_, t) in fill:
                    grid[slot, pos - len(t):] = t
                logits, fresh = self._prefill(grid)
                last = self._sample(logits[:, -1].cpu().numpy())
                self._scatter_rows(self._caches, fresh,
                                   [s for s, _ in fill])
                del fresh
                self.stats["refills"] += len(fill)
                for slot, (rid, _) in fill:
                    slot_id[slot] = rid
                    remaining[slot] = max_new_tokens - 1
                    cur[slot] = last[slot]
                    outputs[rid].append(int(last[slot]))
                    if last[slot] == sv.eos_token or remaining[slot] <= 0:
                        slot_id[slot] = -1
                if not (slot_id >= 0).any():
                    continue

            if pos >= sv.max_len - 1:            # out of cache room:
                slot_id[:] = -1                  # retire the whole grid
                continue
            logits = self._step(cur)
            nxt = self._sample(logits[:, 0].cpu().numpy())
            pos += 1
            self.stats["decode_steps"] += 1
            for i in range(B):
                if slot_id[i] >= 0:
                    outputs[slot_id[i]].append(int(nxt[i]))
                    remaining[i] -= 1
                    if nxt[i] == sv.eos_token or remaining[i] <= 0:
                        slot_id[i] = -1
            cur = nxt
        return [outputs[i] for i in range(len(prompts))]

    def _scatter_rows(self, live, fresh, slots: list[int]) -> None:
        """Copy ``slots``' rows of every layer's cache from ``fresh`` into
        ``live`` (in place; batch is axis 0 of every cache tensor).  The
        position counter stays live's."""
        rows = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        for lc, fc in zip(live, fresh):
            lc.k[rows] = fc.k[rows]
            lc.v[rows] = fc.v[rows]

    def _generate_waves(self, prompts: list[list[int]],
                        max_new_tokens: int = 32) -> list[list[int]]:
        """Wave scheduler (the pre-refill baseline, kept as the
        regression oracle): each wave of B prompts runs to completion
        before the next starts; a finished slot idles till wave end."""
        sv = self.sv
        queue = list(enumerate(prompts))
        outputs: dict[int, list[int]] = {i: [] for i in range(len(prompts))}
        B = sv.batch_slots

        while queue:
            wave, queue = queue[:B], queue[B:]
            ids = [w[0] for w in wave]
            toks = [w[1] for w in wave]
            plen = max(len(t) for t in toks)
            grid = np.zeros((B, plen), np.int32)
            for i, t in enumerate(toks):
                grid[i, plen - len(t):] = t       # left-pad
            logits = self._joint_prefill(grid)
            last = self._sample(logits[:, -1].cpu().numpy())
            alive = np.zeros((B,), bool)
            alive[:len(wave)] = True
            for i in range(len(wave)):
                outputs[ids[i]].append(int(last[i]))

            pos = plen
            cur = last
            for _ in range(max_new_tokens - 1):
                if not alive.any() or pos >= sv.max_len - 1:
                    break
                logits = self._step(cur)
                nxt = self._sample(logits[:, 0].cpu().numpy())
                for i in range(len(wave)):
                    if alive[i]:
                        outputs[ids[i]].append(int(nxt[i]))
                        if nxt[i] == sv.eos_token:
                            alive[i] = False
                cur = nxt
                pos += 1
        return [outputs[i] for i in range(len(prompts))]

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        if self.sv.temperature <= 0:
            return logits.argmax(-1).astype(np.int32)
        z = logits / self.sv.temperature
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        return np.asarray([self.rng.choice(p.shape[-1], p=p[i])
                           for i in range(p.shape[0])], np.int32)
