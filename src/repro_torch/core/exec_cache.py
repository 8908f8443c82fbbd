"""Instrumented LRU cache for captured executables (port of
``repro.core.exec_cache``).

The reference keeps one AOT-compiled XLA executable per structural
signature so that a repeated launch never compiles again.  In the port
the counterpart of a compiled executable is a captured
``torch.cuda.CUDAGraph``: the sweep engine (``core/experiments.py``)
keeps one graph of a trace window per signature, with the static tensors
it reads.  The cache itself is the reference's:

  * bounded LRU keyed by the caller's structural signature (the static
    configuration plus every input leaf's path, shape, dtype and device,
    so a hit means "this entry can run these tensors as they are");
  * hit / miss / eviction counters plus cumulative build seconds,
    snapshotable as :class:`CacheStats` (deltas subtract);
  * configurable capacity (``resize``), safe under concurrent readers
    (one lock; builders run under it so a key is built once).

One addition: an entry that has a ``release()`` method gets it called
when the cache evicts or clears it, so a captured graph gives back its
private memory pool instead of waiting for the garbage collector.  The
call comes after the cache's lock is let go (freeing a graph takes the
card's lock, which a run holds around its own lookups), and an entry
that is still in use defers its release to its holder
(``experiments.WindowExecutable``).

The module imports nothing but the standard library: the cache stores
whatever the builder returns.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Hashable


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Monotone counter snapshot; subtract two snapshots for a window."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    build_s: float = 0.0          # cumulative seconds spent in builders

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        """Hits per lookup (1.0 for the empty window: nothing missed)."""
        n = self.lookups
        return self.hits / n if n else 1.0

    def __sub__(self, other: "CacheStats") -> "CacheStats":
        return CacheStats(hits=self.hits - other.hits,
                          misses=self.misses - other.misses,
                          evictions=self.evictions - other.evictions,
                          build_s=self.build_s - other.build_s)

    def to_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hit_rate, 4),
                "build_s": round(self.build_s, 3)}


def _leaves(path: str, x, out: list) -> None:
    """(path, shape, dtype, device) of each tensor leaf of ``x`` (a
    NamedTuple, tuple, list or dict tree); (path, value) of each other
    leaf (None, numbers, strings), in a fixed order."""
    if hasattr(x, "shape") and hasattr(x, "dtype") and hasattr(x, "device"):
        out.append((path, tuple(x.shape), str(x.dtype), str(x.device)))
    elif isinstance(x, dict):
        for k in sorted(x):
            _leaves(f"{path}[{k!r}]", x[k], out)
    elif hasattr(x, "_fields"):
        for f in x._fields:
            _leaves(f"{path}.{f}", getattr(x, f), out)
    elif isinstance(x, (tuple, list)):
        for i, y in enumerate(x):
            _leaves(f"{path}[{i}]", y, out)
    else:
        out.append((path, x))


def structural_signature(static: tuple, args) -> tuple:
    """The full structural cache key for a captured program.

    ``static`` is the caller's static configuration tuple; ``args`` is
    the input tree (NamedTuples, tuples, lists and dicts of tensors) the
    entry will run.  The key appends each leaf as ``(field path, shape,
    dtype, device)`` — non-tensor leaves (None, the Python ints of a
    plan) as ``(field path, value)`` — so two inputs with equal
    signatures can be copied into one entry's static tensors as they
    are.  The field paths stand for the reference's treedef.
    """
    out: list = []
    _leaves("", args, out)
    return static + (tuple(out),)


def _release_all(entries) -> None:
    for entry in entries:
        release = getattr(entry, "release", None)
        if callable(release):
            release()


class ExecutableCache:
    """Bounded, instrumented LRU: key -> built executable.

    ``get_or_build(key, builder)`` returns the cached value for ``key``
    or runs ``builder()`` (counting its wall time as build time) and
    inserts the result, evicting least-recently-used entries past
    ``capacity``.  Keys must be hashable; use a full structural
    signature — anything that changes the captured program (static
    arguments, input shapes/dtypes/devices) belongs in the key.  An
    evicted or cleared entry's ``release()`` is called, if it has one.
    """

    def __init__(self, capacity: int = 32, name: str = "exec"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self._capacity = int(capacity)
        self._entries: "collections.OrderedDict[Hashable, Any]" = \
            collections.OrderedDict()
        self._lock = threading.RLock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._build_s = 0.0

    # -- core ---------------------------------------------------------------

    def get_or_build(self, key: Hashable,
                     builder: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._entries:
                self._hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
            # build under the lock: concurrent callers of one key must
            # not capture twice (the capture is the expensive part)
            self._misses += 1
            t0 = time.perf_counter()
            value = builder()
            self._build_s += time.perf_counter() - t0
            self._entries[key] = value
            gone = self._evict_past(self._capacity)
        _release_all(gone)
        return value

    def _evict_past(self, capacity: int) -> list:
        """Drop LRU entries past ``capacity`` (under the lock); returns
        them for ``_release_all`` once the lock is let go."""
        gone = []
        while len(self._entries) > capacity:
            gone.append(self._entries.popitem(last=False)[1])
            self._evictions += 1
        return gone

    # -- introspection ------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._capacity

    def resize(self, capacity: int) -> None:
        """Change capacity; shrinking evicts LRU entries immediately."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._lock:
            self._capacity = int(capacity)
            gone = self._evict_past(self._capacity)
        _release_all(gone)

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(hits=self._hits, misses=self._misses,
                              evictions=self._evictions,
                              build_s=self._build_s)

    def reset_stats(self) -> None:
        """Zero the counters (entries stay — hit rates restart clean)."""
        with self._lock:
            self._hits = self._misses = self._evictions = 0
            self._build_s = 0.0

    def clear(self) -> None:
        """Drop (and release) every entry; not counted as evictions;
        stats persist."""
        with self._lock:
            gone = list(self._entries.values())
            self._entries.clear()
        _release_all(gone)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self):
        with self._lock:
            return list(self._entries.keys())

    def values(self):
        with self._lock:
            return list(self._entries.values())

    def __repr__(self) -> str:
        s = self.stats()
        return (f"ExecutableCache({self.name!r}, {len(self)}/"
                f"{self._capacity} entries, hits={s.hits} "
                f"misses={s.misses} evictions={s.evictions})")
