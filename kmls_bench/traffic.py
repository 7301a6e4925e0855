"""The one generator of the serving mixes. A mix is a data file
(``traffic/<mix>.json``); this module turns it and a seed into requests.

Keys of a serving mix:

- ``kind``: ``open`` (arrivals on a schedule) or ``closed`` (clients that
  each wait for their answer);
- ``seeds_per_request`` and ``weights``: the request sizes and their
  shares; ``unknown_fraction``: the share of requests that name one track
  the catalog lacks; ``popularity_zipf_s``: seed tracks are drawn distinct
  by a Zipf law of this exponent over the catalog's popularity ranks;
- open: ``rate_per_s``, ``connections``, ``pipeline``; closed: ``clients``
  and ``pool_per_s`` (payloads drawn per second of window);
- ``warm_requests``: requests sent before the window, drawn apart;
  ``trace_seconds``: the traced part of a traced run's window (its end);
  ``check_sample``: the answers the check compares.

Every seed gets the same set of request sizes, and an open mix the same
number of arrivals in the window, in another order: the sizes are the
weights' exact shares, shuffled, and the arrival times are that many
uniform times sorted (a Poisson process given its count).
"""

from __future__ import annotations

import math

import numpy as np

from .cells import subseed


def request_sizes(n: int, mix: dict, rng: np.random.Generator) -> np.ndarray:
    """``n`` request sizes in the mix's exact shares, shuffled; 0 marks an
    unknown-seed request."""
    n_unknown = int(round(n * float(mix["unknown_fraction"])))
    sizes = np.asarray(mix["seeds_per_request"], dtype=np.int64)
    w = np.asarray(mix["weights"], dtype=np.float64)
    counts = np.floor((n - n_unknown) * w / w.sum()).astype(np.int64)
    counts[: (n - n_unknown) - int(counts.sum())] += 1
    out = np.concatenate([np.repeat(sizes, counts), np.zeros(n_unknown, dtype=np.int64)])
    rng.shuffle(out)
    return out


class SeedDrawer:
    """Distinct seed tracks by a Zipf law over the catalog's ranks."""

    def __init__(self, names: list[str], zipf_s: float, rng: np.random.Generator):
        w = 1.0 / np.arange(1, len(names) + 1, dtype=np.float64) ** zipf_s
        self.cdf = np.cumsum(w / w.sum())
        self.names = names
        self.rng = rng

    def draw(self, k: int) -> list[str]:
        picked: list[int] = []
        seen: set[int] = set()
        while len(picked) < k:
            cand = np.searchsorted(self.cdf, self.rng.random(2 * k + 8), side="right")
            for c in np.minimum(cand, len(self.names) - 1).tolist():
                if c not in seen:
                    seen.add(c)
                    picked.append(c)
                    if len(picked) == k:
                        break
        return [self.names[c] for c in picked]


def payloads(n: int, mix: dict, names: list[str], rng: np.random.Generator, tag: str) -> list[list[str]]:
    """``n`` request payloads of the mix over the catalog ``names``."""
    drawer = SeedDrawer(names, float(mix["popularity_zipf_s"]), rng)
    out = []
    for i, k in enumerate(request_sizes(n, mix, rng).tolist()):
        out.append(drawer.draw(k) if k > 0 else [f"__unknown_{tag}_{i}__"])
    return out


def open_schedule(mix: dict, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """The arrival times of an open mix's window, seconds from its start."""
    n = int(round(float(mix["rate_per_s"]) * seconds))
    return np.sort(rng.uniform(0.0, seconds, n))


def window_requests(mix: dict, names: list[str], seed: int, seconds: float):
    """A run's requests, all drawn here from the run's ``--seed`` →
    ``(warm, arrivals, load)``: the ``warm_requests`` payloads sent before
    the window, an open mix's arrival times (None for a closed mix), and
    the window's payloads (a closed mix's pool, ``pool_per_s`` a second)."""
    rng = np.random.default_rng(subseed(seed, "traffic"))
    warm = payloads(int(mix["warm_requests"]), mix, names, rng, "warm")
    if mix["kind"] == "open":
        arrivals = open_schedule(mix, seconds, rng)
        n = len(arrivals)
    else:
        arrivals, n = None, int(math.ceil(float(mix["pool_per_s"]) * seconds))
    return warm, arrivals, payloads(n, mix, names, rng, "w")
