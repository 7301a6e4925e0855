"""Continuous freshness — counterpart of ``kmlserver_tpu/freshness/``:

- :mod:`.delta` — the mining job's ``delta`` route (fingerprint the CSV
  against the last publication's base state, parse only the appended rows,
  recount the affected rows, publish a ``delta-<seq>.bundle`` through the
  lease) and the one base ∘ delta application that mining, compaction and
  serving share;
- :mod:`.ring` — rendezvous-hash cache affinity over the replica fleet and
  the simulated fleet that prices it.
"""

from .delta import DeltaIneligible, apply_delta_to_tensors  # noqa: F401
from .ring import RendezvousRing, seeds_key  # noqa: F401
