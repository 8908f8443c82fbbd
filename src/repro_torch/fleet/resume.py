"""Preemptible checkpoint/resume for fleet runs (port of
``repro.fleet.resume``, on ``repro_torch.ckpt``, which writes the
reference's on-disk layout).

The coordinator journals every completed shard through ``repro_torch.ckpt``'s
atomic checkpoint layout (one committed step per shard, step id =
shard index, the shard's content digest + spill path in the manifest
extra), so a killed fleet resumes with ZERO recompute of finished
shards: on restart the runner loads each committed shard's result
bit-for-bit from the journal and only schedules the remainder.  The
journal is also the multi-process coordination substrate of the
``torch.distributed`` backend — shard ownership is an O_EXCL claim file,
failure counts are append-only markers, and completion is the ckpt
``.done`` commit, all of which survive any worker dying mid-write
(that is exactly the torn-checkpoint hardening in
``repro_torch.ckpt.checkpoint``).

Layout::

    <dir>/plan.json                  — plan digest + shard digests
    <dir>/shards/step_<i>/…(.done)   — shard i's result (repro_torch.ckpt)
    <dir>/claims/<digest>            — live ownership (O_EXCL create)
    <dir>/failures/<digest>.<n>      — one marker per failed attempt
    <dir>/spill/<digest>/            — raw streaming window spill
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..ckpt import committed_steps, load_checkpoint, save_checkpoint
from ..core.experiments import SweepResult
from ..core.fluid import FluidState
from ..core.serialize import _SIM_TRACE_FIELDS
from ..core.simulator import TraceSample

from .plan import FleetPlan, ShardSpec


class FleetJournal:
    """Durable record of one plan's progress, addressed by content."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        self.shards_dir = os.path.join(self.directory, "shards")
        self.claims_dir = os.path.join(self.directory, "claims")
        self.failures_dir = os.path.join(self.directory, "failures")
        for d in (self.directory, self.shards_dir, self.claims_dir,
                  self.failures_dir):
            os.makedirs(d, exist_ok=True)
        self._plan_digest: str | None = None

    # -- plan binding -------------------------------------------------------

    def bind(self, plan: FleetPlan) -> None:
        """Pin the journal to one plan; a digest mismatch means the
        journal belongs to different work and must not be reused."""
        path = os.path.join(self.directory, "plan.json")
        doc = {"digest": plan.digest,
               "shards": [s.digest for s in plan.shards]}
        if os.path.exists(path):
            with open(path) as f:
                have = json.load(f)
            if have["digest"] != plan.digest:
                raise ValueError(
                    f"journal {self.directory} is bound to plan "
                    f"{have['digest'][:16]}…, not {plan.digest[:16]}… — "
                    f"refusing to mix results of different plans")
        else:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)
        self._plan_digest = plan.digest

    # -- completion ---------------------------------------------------------

    def completed(self) -> dict[str, int]:
        """{shard digest: journal step} over committed shard results."""
        out = {}
        for s in committed_steps(self.shards_dir):
            mf = os.path.join(self.shards_dir, f"step_{s:09d}",
                              "manifest.json")
            try:
                with open(mf) as f:
                    extra = json.load(f).get("extra", {})
            except (OSError, ValueError):
                continue                   # torn manifest: not complete
            d = extra.get("digest")
            if d:
                out[d] = s
        return out

    def is_complete(self, digest: str) -> bool:
        return digest in self.completed()

    def spill_dir(self, digest: str) -> str:
        return os.path.join(self.directory, "spill", digest[:32])

    def save_shard(self, shard: ShardSpec, res: SweepResult,
                   spill: str | None = None) -> str:
        """Commit one shard's result (atomic; step id = shard index)."""
        tree = {
            "times": np.asarray(res.times),
            "traces": {f: np.asarray(getattr(res.traces, f))
                       for f in _SIM_TRACE_FIELDS
                       if getattr(res.traces, f, None) is not None},
            "final": res.final,
        }
        extra = {"digest": shard.digest, "names": list(shard.names),
                 "trace_every": int(res.trace_every),
                 "spill": spill, "plan": self._plan_digest}
        return save_checkpoint(self.shards_dir, shard.index, tree, extra)

    def load_shard(self, plan: FleetPlan, shard: ShardSpec) -> SweepResult:
        """Rebuild one shard's SweepResult bit-for-bit from the journal."""
        tree, extra = load_checkpoint(
            self.shards_dir, step=shard.index,
            nt_registry={"FluidState": FluidState})
        if extra.get("digest") != shard.digest:
            raise ValueError(
                f"journal step {shard.index} holds digest "
                f"{str(extra.get('digest'))[:16]}…, expected "
                f"{shard.digest[:16]}… — stale journal for this plan")
        traces = TraceSample(**{f: tree["traces"].get(f)
                                for f in TraceSample._fields})
        return SweepResult(points=plan.shard_sweep(shard).points,
                           times=np.asarray(tree["times"]),
                           traces=traces, final=tree["final"],
                           trace_every=int(extra["trace_every"]))

    # -- multi-process coordination (claims + failure counts) ---------------

    def claim(self, digest: str, owner: str) -> bool:
        """Take exclusive ownership of a shard; False if already owned."""
        path = os.path.join(self.claims_dir, digest)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            json.dump({"owner": owner, "time": time.time()}, f)
        return True

    def release(self, digest: str) -> None:
        try:
            os.remove(os.path.join(self.claims_dir, digest))
        except OSError:
            pass

    def claim_age(self, digest: str) -> float | None:
        """Seconds since the claim was (re)written; None if unclaimed."""
        try:
            return time.time() - os.path.getmtime(
                os.path.join(self.claims_dir, digest))
        except OSError:
            return None

    def steal_claim(self, digest: str, owner: str) -> bool:
        """Replace a stale claim (atomic overwrite).  In the worst race
        two stealers both run the shard — harmless: results are content
        addressed and the ckpt commit is atomic, so the bytes agree."""
        path = os.path.join(self.claims_dir, digest)
        tmp = f"{path}.steal.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"owner": owner, "time": time.time(),
                       "stolen": True}, f)
        os.replace(tmp, path)
        return True

    def record_failure(self, digest: str, error: str) -> int:
        """Append a failure marker; returns the new failure count."""
        n = self.failures(digest) + 1
        path = os.path.join(self.failures_dir, f"{digest}.{n}")
        with open(path, "w") as f:
            f.write(error[:2000])
        return n

    def failures(self, digest: str) -> int:
        n = 0
        while os.path.exists(
                os.path.join(self.failures_dir, f"{digest}.{n + 1}")):
            n += 1
        return n
