"""Fleet cache affinity and routing by rendezvous hashing — counterpart of
``kmlserver_tpu/freshness/ring.py``.

The answer cache is per process, so N replicas each recompute the same hot
seed sets. :class:`RendezvousRing` names the replica that would own a key
(``argmax`` over peers of ``H(peer, key)``): removing a peer re-maps only
the keys it owned, which is what a rolling deployment needs.

``KMLS_CACHE_AFFINITY=1`` arms the measurement: the app counts the requests
this replica (``KMLS_CACHE_AFFINITY_SELF``, default the hostname) owns
among ``KMLS_CACHE_AFFINITY_PEERS`` as ``kmls_cache_affinity_local_total``
and ``_remote_total`` — what an affinity router would keep local, before
one is deployed. :func:`simulate_fleet` and :func:`fleet_multiplier` replay
a key stream against N bounded caches under affinity and round-robin
routing: the fleet-wide hit-ratio multiplier.

:class:`FleetRouter` is the live client/ingress router over the same ring:
each key goes to its rendezvous owner; ``eject_threshold`` consecutive
failures eject a peer (its keys spill to their next-highest weight, the
bounded remap), a half-open probe every ``probe_interval_s`` re-admits it,
and with every peer out it fails open to the owner. A slow-but-alive peer
(every answer a 200, just late) is ejected by the same machinery once its
latency EWMA passes ``slow_ratio`` × the healthy peers' median, and only a
fast probe sample re-admits it. The serving side (``KMLS_FLEET_SELF`` /
``KMLS_FLEET_PEERS``, ``serving/app.py``) answers mis-routed requests
locally, stamps ``X-KMLS-Cache-Owner`` and counts
``kmls_cache_misrouted_total``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque


def _weight(peer: str, key: str) -> int:
    digest = hashlib.blake2b(f"{peer}\x1f{key}".encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "big")


class RendezvousRing:
    """Highest-random-weight owner selection over a stable peer set."""

    def __init__(self, peers: list[str]):
        cleaned = [p.strip() for p in peers if p and p.strip()]
        if not cleaned:
            raise ValueError("rendezvous ring needs at least one peer")
        # sorted: a tie on the 64-bit weight resolves the same everywhere
        self.peers = sorted(set(cleaned))

    def owner(self, key: str) -> str:
        return max(self.peers, key=lambda p: (_weight(p, key), p))

    def owner_index(self, key: str) -> int:
        return self.peers.index(self.owner(key))

    def owns(self, key: str, peer: str) -> bool:
        return self.owner(key) == peer

    def ranked(self, key: str) -> list[str]:
        """Every peer by descending weight for ``key``: ``ranked(key)[0]``
        is the owner, and without it ``ranked(key)[1]`` is the owner a ring
        built without that peer elects."""
        return sorted(self.peers, key=lambda p: (_weight(p, key), p), reverse=True)


def seeds_key(seeds: list[str]) -> str:
    """The ring key of a seed set — the answer cache's canonical form
    (sorted, duplicates kept), so a request's owner is its entry's owner."""
    return "\x1f".join(sorted(seeds))


# EWMA smoothing of a peer's latency (~the last 10 samples)
_EWMA_ALPHA = 0.2
# samples a peer must have before its EWMA joins the slow ladder (or the
# healthy median it is judged against)
_MIN_LATENCY_SAMPLES = 8
# the bounded window behind the hedge-delay quantile
_LATENCY_WINDOW = 64


class _PeerHealth:
    __slots__ = (
        "consecutive_failures", "ejected", "next_probe_at", "failed_shard",
        "ewma_s", "samples", "recent", "slow",
    )

    def __init__(self) -> None:
        self.consecutive_failures = 0
        self.ejected = False
        self.next_probe_at = 0.0
        # the gang rank a 503 + X-KMLS-Mesh-Unavailable blamed (None for a
        # plain transport/5xx failure); observability only
        self.failed_shard = None
        # latency health: EWMA seconds, sample count, the recent window of
        # the hedge delay, and whether the ejection was for slowness
        self.ewma_s = 0.0
        self.samples = 0
        self.recent: deque = deque(maxlen=_LATENCY_WINDOW)
        self.slow = False


class FleetRouter:
    """Health-aware rendezvous routing over the live peer set.

    :meth:`route` returns the highest-weight non-ejected peer of a key.
    ``eject_threshold`` consecutive :meth:`mark_failure` calls eject a
    peer; once per ``probe_interval_s`` :meth:`route` hands an ejected
    peer one request (half-open), and :meth:`mark_success` re-admits it.
    With ``slow_ratio > 0``, :meth:`mark_latency` ejects a peer whose EWMA
    exceeds ``slow_ratio`` × the healthy median (counted in ``ejections``
    and ``slow_ejections``); a slow-ejected peer comes back only through a
    probe whose own sample is under the bar. Thread-safe; ``clock`` is
    injectable."""

    def __init__(
        self,
        peers: list[str],
        *,
        eject_threshold: int = 3,
        probe_interval_s: float = 1.0,
        slow_ratio: float = 0.0,
        clock=time.monotonic,
    ):
        self.ring = RendezvousRing(peers)
        self.eject_threshold = max(1, eject_threshold)
        self.probe_interval_s = probe_interval_s
        # 0 disables the slow ladder (latency is still tracked: the hedge
        # delay wants samples either way)
        self.slow_ratio = max(0.0, slow_ratio)
        self._clock = clock
        self._health = {p: _PeerHealth() for p in self.ring.peers}
        self._lock = threading.Lock()
        self.ejections = 0
        self.readmissions = 0
        self.probes = 0
        self.spills = 0
        self.slow_ejections = 0

    @property
    def peers(self) -> list[str]:
        return self.ring.peers

    def route(self, key: str) -> str:
        now = self._clock()
        ranked = self.ring.ranked(key)
        with self._lock:
            for i, peer in enumerate(ranked):
                health = self._health[peer]
                if not health.ejected:
                    if i > 0:
                        self.spills += 1
                    return peer
                if now >= health.next_probe_at:
                    # half-open: one request per interval auditions it
                    health.next_probe_at = now + self.probe_interval_s
                    self.probes += 1
                    return peer
            # every peer ejected: fail open to the owner
            return ranked[0]

    def mark_failure(self, peer: str, shard: int | None = None) -> None:
        """One failure against ``peer``; ``shard`` is the gang rank a
        gang peer's 503 named (the breaker itself is shard-blind)."""
        with self._lock:
            health = self._health.get(peer)
            if health is None:
                return
            health.consecutive_failures += 1
            if shard is not None:
                health.failed_shard = int(shard)
            if health.ejected:
                # a failed probe: the next audition a full interval out
                health.next_probe_at = self._clock() + self.probe_interval_s
            elif health.consecutive_failures >= self.eject_threshold:
                health.ejected = True
                health.next_probe_at = self._clock() + self.probe_interval_s
                self.ejections += 1

    def mark_success(self, peer: str) -> None:
        with self._lock:
            health = self._health.get(peer)
            if health is None:
                return
            health.consecutive_failures = 0
            health.failed_shard = None
            # a slow peer still succeeds: only a fast sample re-admits it
            if health.ejected and not health.slow:
                health.ejected = False
                self.readmissions += 1

    def _healthy_median_locked(self, exclude: str) -> float | None:
        """Median EWMA of the healthy, sampled peers other than
        ``exclude`` (the peer under judgment). Caller holds the lock."""
        ewmas = sorted(
            h.ewma_s
            for p, h in self._health.items()
            if p != exclude and not h.ejected and h.samples >= _MIN_LATENCY_SAMPLES
        )
        if not ewmas:
            return None
        mid = len(ewmas) // 2
        if len(ewmas) % 2:
            return ewmas[mid]
        return 0.5 * (ewmas[mid - 1] + ewmas[mid])

    def mark_latency(self, peer: str, seconds: float) -> None:
        """One observed round trip of ``peer``: always tracked (EWMA and
        the recent window); with ``slow_ratio > 0`` also the slow ladder —
        eject past the bar (after ``_MIN_LATENCY_SAMPLES`` samples, with a
        median of other sampled healthy peers), and while slow-ejected
        re-admit on a probe sample back under it (the EWMA restarts from
        that sample) or push the next probe out."""
        with self._lock:
            health = self._health.get(peer)
            if health is None:
                return
            s = max(0.0, float(seconds))
            health.recent.append(s)
            health.samples += 1
            if health.samples == 1:
                health.ewma_s = s
            else:
                health.ewma_s += _EWMA_ALPHA * (s - health.ewma_s)
            if self.slow_ratio <= 0.0:
                return
            if health.slow and health.ejected:
                median = self._healthy_median_locked(exclude=peer)
                if median is not None and s <= self.slow_ratio * median:
                    health.slow = False
                    health.ejected = False
                    health.ewma_s = s
                    self.readmissions += 1
                else:
                    health.next_probe_at = self._clock() + self.probe_interval_s
                return
            if health.ejected or health.samples < _MIN_LATENCY_SAMPLES:
                return
            median = self._healthy_median_locked(exclude=peer)
            if median is not None and health.ewma_s > self.slow_ratio * median:
                health.slow = True
                health.ejected = True
                health.next_probe_at = self._clock() + self.probe_interval_s
                self.ejections += 1
                self.slow_ejections += 1

    def hedge_delay_s(self, peer: str, floor_s: float = 0.0) -> float:
        """The hedge trigger of ``peer``: ~p95 of its recent window,
        floored at ``floor_s``; the floor alone until the window holds
        ``_MIN_LATENCY_SAMPLES`` samples."""
        with self._lock:
            health = self._health.get(peer)
            if health is None or len(health.recent) < _MIN_LATENCY_SAMPLES:
                return floor_s
            ordered = sorted(health.recent)
            q = ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]
            return max(floor_s, q)

    def peer_latency_s(self, peer: str) -> float:
        """The EWMA latency of ``peer`` (0.0 unsampled)."""
        with self._lock:
            health = self._health.get(peer)
            return health.ewma_s if health is not None else 0.0

    def ejected_peers(self) -> list[str]:
        with self._lock:
            return [p for p, h in self._health.items() if h.ejected]

    def slow_peers(self) -> list[str]:
        """Peers ejected for slowness."""
        with self._lock:
            return [p for p, h in self._health.items() if h.slow]

    def failed_shards(self) -> dict[str, int]:
        """peer → the gang rank its latest failure blamed (cleared on
        success): a lost member told apart from a dead pod."""
        with self._lock:
            return {
                p: h.failed_shard for p, h in self._health.items() if h.failed_shard is not None
            }


class _BoundedSet:
    """An LRU set standing in for one replica's answer cache."""

    def __init__(self, capacity: int):
        self.capacity = max(1, capacity)
        self._od: OrderedDict[str, None] = OrderedDict()

    def hit_or_insert(self, key: str) -> bool:
        if key in self._od:
            self._od.move_to_end(key)
            return True
        self._od[key] = None
        if len(self._od) > self.capacity:
            self._od.popitem(last=False)
        return False


def simulate_fleet(
    keys: list[str], n_replicas: int, capacity: int, policy: str = "affinity"
) -> float:
    """The fleet's hit ratio for a key stream under ``policy``:
    ``affinity`` (the rendezvous owner), ``roundrobin`` or ``random`` (a
    hash of the position, so runs repeat). Each replica is an LRU of
    ``capacity`` keys; the ratio is hits over requests across all."""
    if policy not in ("affinity", "roundrobin", "random"):
        raise ValueError(f"unknown routing policy {policy!r}")
    peers = [f"replica-{i}" for i in range(max(1, n_replicas))]
    ring = RendezvousRing(peers) if policy == "affinity" else None
    caches = [_BoundedSet(capacity) for _ in peers]
    hits = 0
    for i, key in enumerate(keys):
        if ring is not None:
            idx = ring.owner_index(key)
        elif policy == "roundrobin":
            idx = i % len(peers)
        else:
            idx = _weight("route", f"{i}") % len(peers)
        if caches[idx].hit_or_insert(key):
            hits += 1
    return hits / len(keys) if keys else 0.0


def fleet_multiplier(
    keys: list[str], n_replicas: int = 3, capacity: int = 512
) -> dict[str, float]:
    """Affinity against round-robin hit ratio over the same stream and
    topology, and their ratio: the fleet-wide hit-ratio multiplier."""
    affinity = simulate_fleet(keys, n_replicas, capacity, "affinity")
    baseline = simulate_fleet(keys, n_replicas, capacity, "roundrobin")
    return {
        "affinity_hit_ratio": affinity,
        "baseline_hit_ratio": baseline,
        "multiplier": (affinity / baseline) if baseline > 0 else float("inf"),
    }
