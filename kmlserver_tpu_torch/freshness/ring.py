"""Fleet cache affinity by rendezvous hashing — counterpart of
``kmlserver_tpu/freshness/ring.py:55-112`` and ``:372-435``.

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

The live router (``FleetRouter``) and the owner-aware serving it drives are
not part of this package.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict


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
