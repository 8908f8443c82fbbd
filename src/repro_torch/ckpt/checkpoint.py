"""Fault-tolerant checkpointing (port of ``repro.ckpt.checkpoint``).

Layout:  <dir>/step_000123/
            manifest.json       — step, data step, config hash, tree spec
            arrays.npz          — flat {path: array} (host 0's view)
         <dir>/step_000123.done — commit marker (atomic rename)

Properties required at 1000-node scale and tested in tests/test_ckpt.py:
  * **atomic**: partially-written checkpoints are never visible (write to
    tmp dir, fsync, rename; .done marker commits),
  * **async**: `CheckpointManager.save_async` runs serialisation off the
    step loop (straggler-free saves),
  * **portable**: arrays are saved densely as numpy (a tensor leaf is
    copied to the host first; a DTensor leaf is gathered whole), in the
    reference's exact layout, so a checkpoint either package wrote loads
    in the other; a load restores numpy arrays, tensors on a stated
    ``device``, or DTensors on stated shardings (elastic restore),
  * **exact resume**: the data-pipeline step and RNG state live in the
    manifest, so training resumes bit-identically.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Optional

import numpy as np
import torch


def _host(v) -> np.ndarray:
    """A leaf as a numpy array (tensors leave the device first; a
    DTensor is gathered whole, a collective every rank of its mesh
    calls)."""
    if isinstance(v, torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(v, DTensor):
            v = v.full_tensor()
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _map_leaves(fn, tree):
    """``fn`` over every leaf of a dict / NamedTuple / list / tuple tree
    (None stays None), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_leaves(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:          # namedtuple: field-name paths,
            out.update(_flatten(getattr(tree, f), f"{prefix}{f}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        pass
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _tree_template(tree):
    """JSON-able structure descriptor used to rebuild on load."""
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _tree_template(v) for k, v in tree.items()}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"__kind__": "namedtuple", "cls": type(tree).__name__,
                "items": {f: _tree_template(getattr(tree, f))
                          for f in tree._fields}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_tree_template(v) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    return {"__kind__": "leaf"}


def _rebuild(template, flat, prefix="", nt_registry=None):
    k = template["__kind__"]
    if k == "none":
        return None
    if k == "leaf":
        return flat[prefix.rstrip("/")]
    if k == "dict":
        return {key: _rebuild(v, flat, f"{prefix}{key}/", nt_registry)
                for key, v in template["items"].items()}
    if k == "namedtuple":
        vals = {key: _rebuild(v, flat, f"{prefix}{key}/", nt_registry)
                for key, v in template["items"].items()}
        cls = (nt_registry or {}).get(template["cls"])
        return cls(**vals) if cls else vals
    seq = [_rebuild(v, flat, f"{prefix}{i}/", nt_registry)
           for i, v in enumerate(template["items"])]
    return seq if k == "list" else tuple(seq)


def _distribute(tree, shardings, where: str = "tree"):
    """Each numpy leaf of ``tree`` as a DTensor on the ``NamedSharding``
    (``repro_torch.dist.sharding``) at its place in ``shardings``, a tree
    of the same structure (TypeError where it is not); a None sharding
    leaves its leaf a CPU tensor."""
    from ..dist.sharding import NamedSharding
    if isinstance(shardings, NamedSharding):
        from torch.distributed.tensor import distribute_tensor
        # every rank reads the same file: its local data is the value,
        # so nothing is broadcast or scattered (src_data_rank=None)
        return distribute_tensor(torch.from_numpy(np.asarray(tree)),
                                 shardings.mesh, shardings.placements,
                                 src_data_rank=None)
    if tree is None:
        return None
    if isinstance(tree, dict):
        get = (shardings.get if isinstance(shardings, dict)
               else lambda k: getattr(shardings, k, None))
        return {k: _distribute(v, get(k), f"{where}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if shardings is None:
            shardings = [None] * len(tree)
        if len(shardings) != len(tree):
            raise TypeError(f"shardings at {where} hold {len(shardings)} "
                             f"entries for {len(tree)}")
        out = [_distribute(v, s, f"{where}/{i}")
               for i, (v, s) in enumerate(zip(tree, shardings))]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    if shardings is None:
        return torch.from_numpy(np.asarray(tree))
    raise TypeError(f"shardings at {where}: {type(shardings).__name__} "
                     f"is not a NamedSharding")


def _fsync_dir(path: str) -> None:
    """Durably record a directory's entries (renames included)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                    # platform without dir-open: best
        return                         # effort, the data fsyncs stand
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomic synchronous save. Returns the committed path.

    Preemption-safe: everything is written and fsynced inside a
    ``.tmp`` dir, renamed into place, and only then committed by the
    ``.done`` marker (itself written via temp + atomic rename, so a
    marker can never exist half-written).  A kill at ANY point leaves
    either no visible checkpoint for this step or a fully committed
    one — ``load_checkpoint`` / ``latest_step`` ignore everything else.
    """
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    arrays = {k: _host(v) for k, v in flat.items()}
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    manifest = {"step": step, "template": _tree_template(tree),
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    done_tmp = final + ".done.tmp"
    with open(done_tmp, "w") as f:   # commit marker: temp + rename so
        f.write("ok")                # it is atomic like everything else
        f.flush()
        os.fsync(f.fileno())
    os.rename(done_tmp, final + ".done")
    _fsync_dir(directory)
    return final


def latest_step(directory: str) -> Optional[int]:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def committed_steps(directory: str) -> list[int]:
    """All committed (``.done``-marked) steps, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith((".tmp", ".done")):
            if os.path.exists(os.path.join(directory, name) + ".done"):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _load_step(directory: str, step: int, device, nt_registry,
               shardings=None):
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = _rebuild(manifest["template"], flat, nt_registry=nt_registry)
    if device is not None:
        tree = _map_leaves(lambda v: torch.from_numpy(v).to(device), tree)
    elif shardings is not None:
        tree = _distribute(tree, shardings)
    return tree, manifest["extra"]


def load_checkpoint(directory: str, step: Optional[int] = None,
                    device: Any = None, nt_registry=None, *,
                    shardings: Any = None):
    """Load (tree, extra): leaves are numpy arrays, tensors on ``device``
    when one is given, or, with ``shardings`` (a matching tree of
    ``repro_torch.dist.sharding.NamedSharding``), DTensors
    ``distribute_tensor``-ed onto them (elastic restore: the reference
    ``device_put``s each leaf onto its sharding).  A None sharding leaves
    its leaf a CPU tensor.  ``device`` and ``shardings`` exclude each
    other.

    With ``step=None``, walks the committed steps newest-first and
    skips torn/partial checkpoints (unreadable manifest or arrays —
    e.g. a ``.done`` marker surviving a corrupted write) instead of
    crashing, so a fleet resuming after preemption always lands on the
    newest checkpoint that actually loads.  An explicit ``step`` must
    be committed (``.done`` marker present) and intact.
    """
    if device is not None and shardings is not None:
        raise ValueError("load_checkpoint: pass device= or shardings=, "
                         "not both")
    if step is not None:
        path = os.path.join(directory, f"step_{step:09d}")
        if not os.path.exists(path + ".done"):
            raise FileNotFoundError(
                f"checkpoint step {step} in {directory} is missing or "
                f"uncommitted (no .done marker — torn write?)")
        return _load_step(directory, step, device, nt_registry, shardings)
    errors = []
    for s in reversed(committed_steps(directory)):
        try:
            return _load_step(directory, s, device, nt_registry, shardings)
        except (OSError, ValueError, KeyError, EOFError,
                json.JSONDecodeError, zipfile.BadZipFile) as e:
            errors.append(f"step {s}: {e!r}")   # torn/corrupt: try older
    detail = f" (skipped torn: {'; '.join(errors)})" if errors else ""
    raise FileNotFoundError(
        f"no loadable committed checkpoint in {directory}{detail}")


class CheckpointManager:
    """Async saver with bounded retention + straggler-free commits."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any, extra=None) -> None:
        self.wait()
        # materialise on host *before* returning control to the step loop
        host_tree = _map_leaves(_host, tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith((".tmp", ".done"))
            and os.path.exists(os.path.join(self.directory, n) + ".done"))
        for s in steps[:-self.keep] if self.keep else []:
            p = os.path.join(self.directory, f"step_{s:09d}")
            shutil.rmtree(p, ignore_errors=True)
            try:
                os.remove(p + ".done")
            except OSError:
                pass
