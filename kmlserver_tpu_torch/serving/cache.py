"""Epoch-keyed recommendation cache with singleflight miss collapsing —
counterpart of ``kmlserver_tpu/serving/cache.py``, whole.

Rule lookup is deterministic per published bundle: the same seed set
against the same rule generation always yields the same answer (the
static-fallback path included — its sampling seed is a stable digest of
the seed tracks). Real playlist-seed traffic is Zipf-skewed, so a bounded
LRU in front of the batcher turns the hot head of the request
distribution into dictionary lookups.

Correctness comes from the key, not from invalidation machinery: entries
are keyed by ``(bundle_epoch, seed-set generation, canonicalized seed
set)``, and the engine bumps ``bundle_epoch`` on every successful hot
swap AFTER publishing the new bundle (see the ordering contract in
``engine.load``). A post-swap lookup therefore constructs a key no stale
entry can match — the whole cache is invalidated wholesale, for free,
without touching it. Stale old-epoch entries age out of the LRU
naturally.

**Selective invalidation** extends the same key-freshness argument to
updates that touch a handful of vocab rows without bumping the epoch: the
cache keeps a per-seed-name GENERATION counter, and a key's generation
component is the sum over its seeds. ``invalidate_seeds(touched)`` bumps
the touched names' generations after the patched bundle is live, so a
later lookup whose seeds intersect the touched set constructs a key that
no stale entry (and no in-flight leader's eventual store) can match, while
untouched keys keep their entries. Unreachable entries are also deleted
eagerly (one walk under the lock) so dead keys do not squat the LRU.

Canonicalization: answers are order-independent for seed sets within the
kernel's seed cap (the score merge is a max over seeds; the fallback
digest sorts internally), so the key sorts the seeds — requests that
permute the same seeds share one entry. Duplicates are KEPT (the fallback
digest distinguishes ``["a", "a"]`` from ``["a"]``), and oversized seed
lists keep their original order (truncation to the cap is positional, so
order changes the answer there).

Singleflight: concurrent identical misses collapse onto ONE in-flight
future — the first requester dispatches to the batcher, later identical
requests attach to the same future instead of duplicating device work.
Works for both transports because both speak futures (``concurrent
.futures.Future`` from the threaded batcher, ``asyncio.Future`` from the
loop-native one); the cache never blocks on a future itself.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable


class RecommendCache:
    """Bounded LRU of ``key → (songs, source)`` plus the in-flight
    singleflight table. Thread-safe; counters are Prometheus-monotonic
    (rendered by serving/metrics.py)."""

    def __init__(self, max_entries: int = 8192):
        self.max_entries = max(1, max_entries)
        self._lru: "OrderedDict[tuple, tuple[list[str], str]]" = OrderedDict()
        self._inflight: dict[tuple, object] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.singleflight_joins = 0
        # per-seed-name generation counters: bumping one name makes every
        # key containing it unconstructable. Only names ever invalidated
        # have entries.
        self._name_gen: dict[str, int] = {}
        self.selective_invalidations = 0
        self.invalidated_keys = 0

    # ---------- keys ----------

    @staticmethod
    def key(epoch: int, seeds: list[str], seed_cap: int) -> tuple:
        """Generation-less key: ``(epoch, 0, canonical seed tuple)``.
        Sorted (order-free answers) with duplicates kept; seed lists past
        the kernel cap keep request order because truncation there is
        positional. Cache-owning callers use :meth:`make_key`, which adds
        the live seed-set generation component."""
        core = tuple(sorted(seeds)) if len(seeds) <= seed_cap else tuple(seeds)
        return (epoch, 0, core)

    def make_key(self, epoch: int, seeds: list[str], seed_cap: int) -> tuple:
        """→ ``(epoch, seed-set generation, canonical seed tuple)``. The
        generation sum is monotone non-decreasing per seed set and
        strictly increases when any member name is invalidated, so a
        stale entry's key can never be reconstructed. Lock-free reads: a
        lookup racing a bump reads the old generation, which is exactly
        equivalent to having looked up before the bump."""
        core = tuple(sorted(seeds)) if len(seeds) <= seed_cap else tuple(seeds)
        gens = self._name_gen
        if not gens:
            return (epoch, 0, core)
        get = gens.get
        gen = 0
        for s in core:
            gen += get(s, 0)
        return (epoch, gen, core)

    def invalidate_seeds(self, touched: set[str]) -> int:
        """Selectively invalidate every key whose seed set intersects
        ``touched``: bump the touched names' generations (making stale
        keys unconstructable) and eagerly delete the now-unreachable LRU
        entries. Call AFTER the new bundle reference is live, mirroring
        the epoch ordering contract. → entries deleted."""
        if not touched:
            return 0
        with self._lock:
            for name in touched:
                self._name_gen[name] = self._name_gen.get(name, 0) + 1
            doomed = [
                k for k in self._lru
                if any(s in touched for s in k[-1])
            ]
            for k in doomed:
                del self._lru[k]
            self.selective_invalidations += 1
            self.invalidated_keys += len(doomed)
        return len(doomed)

    # ---------- LRU ----------

    def get(self, key: tuple) -> tuple[list[str], str] | None:
        with self._lock:
            value = self._lru.get(key)
            if value is None:
                self.misses += 1
                return None
            self._lru.move_to_end(key)
            self.hits += 1
            return value

    def contains(self, key: tuple) -> bool:
        """Presence peek WITHOUT hit/miss accounting or LRU recency."""
        with self._lock:
            return key in self._lru

    def put(self, key: tuple, value: tuple[list[str], str]) -> None:
        # a "degraded:<reason>" source is an answered-but-partial result:
        # storing it would pin the partial answer for the key's whole
        # cache lifetime. Degraded answers are served, never remembered.
        if value[1].startswith("degraded:"):
            return
        with self._lock:
            self._lru[key] = value
            self._lru.move_to_end(key)
            while len(self._lru) > self.max_entries:
                self._lru.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def hit_ratio(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    # ---------- singleflight ----------

    def join_or_lead(
        self, key: tuple, submit: Callable[[], Any]
    ) -> tuple[Any, bool]:
        """→ ``(future, joined)``. Atomically joins the in-flight future
        for ``key``, or installs ``submit()``'s future as the new leader.
        ``submit`` may raise (e.g. the batcher's Overloaded shed) — then
        nothing is installed and followers are unaffected. The leader must
        arrange :meth:`finish` to run when its future completes."""
        with self._lock:
            future = self._inflight.get(key)
            if future is not None:
                self.singleflight_joins += 1
                return future, True
            # submit() under the lock keeps lead-election atomic; the
            # batcher's admission path never calls back into the cache,
            # so the lock order is acyclic
            future = submit()
            self._inflight[key] = future
            return future, False

    def finish(self, key: tuple, future: Any) -> None:
        """Leader's done-callback: retire the in-flight entry and store
        the answer on success (failures — sheds included — cache nothing)."""
        with self._lock:
            self._inflight.pop(key, None)
        try:
            if future.cancelled() or future.exception() is not None:
                return
            result = future.result()
        except Exception:
            return
        self.put(key, result)
