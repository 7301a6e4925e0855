"""QPS replay harness — counterpart of ``kmlserver_tpu/serving/replay.py``
for the load BASELINE config 5 sends: ``/api/recommend/`` requests at a
fixed rate with open-loop (Poisson-paced) arrivals — closed-loop clients
understate tail latency because a slow server throttles its own load —
reporting achieved QPS and latency percentiles.

    python -m kmlserver_tpu_torch.serving.replay --url http://127.0.0.1:8000 \\
        --qps 1000 --requests 8000 [--zipf-s 1.1] [--trace-log client.jsonl]
        [--shape constant|burst|ramp|sine|flashcrowd] [--client async|pooled]
    python -m kmlserver_tpu_torch.serving.replay \\
        --fleet replica-0=http://127.0.0.1:8000,replica-1=http://127.0.0.1:8001 \\
        [--fleet-policy ring|roundrobin]
    python -m kmlserver_tpu_torch.serving.replay --qps 1000 --requests 2000 \\
        [--batch-max-size 32] [--batch-window-ms 2]

With neither ``--url`` nor ``--fleet`` the target is in process: an app
(``serving/app.RecommendApp``: answer cache → micro-batcher → engine) over
the artifacts under ``BASE_DIR``, on ``KMLS_TORCH_DEVICE`` (default
``cuda``; the engine serves through the native host lookup on ``cpu``),
and the report adds the cache hit ratio and each replica's dispatches.

Seed sets are sampled from the served vocabulary (read from the artifacts
under ``BASE_DIR``, when it points at the server's PVC): mostly known
tracks and a slice of unknown ones, so both the rules path and the static
fallback run. ``--zipf-s`` repeats a payload pool with Zipf-skewed
frequencies — the head-heavy mix real playlist-seed traffic has, which
the answer cache feeds on. The draws are the reference's for the same
arguments. ``--trace-log`` writes a :class:`ClientTraceLog` — the echoed
``X-KMLS-Trace`` ids with the client's send and receive clocks — for
``python -m kmlserver_tpu_torch.observability.tracejoin``.

Traffic shapes: :func:`shaped_arrivals` makes the arrival schedule of a
non-homogeneous Poisson process (``constant``, the legacy schedule bit for
bit; ``burst``; ``ramp``; ``sine``), which :func:`replay` and
:func:`replay_pooled` take as ``arrivals=``; :func:`flash_crowd_payloads`
collapses a mid-run window of the mix onto a few hot seed sets, and
``events=[(index, fn)]`` runs a hook when dispatch reaches an index (a
mid-run publication or kill).

:func:`replay_fleet_http` drives an N-replica fleet from one event loop
with client-side rendezvous routing (``freshness/ring.FleetRouter``) or
round robin, re-dispatching the unanswered requests of a dead peer, with
optional hedged dispatch (``HEDGES_ISSUED`` counts every hedge copy, so
``hedge=False`` is provably free) and ``X-KMLS-Deadline-Budget``. All
draws are the reference's for the same arguments.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import hashlib
import json
import math
import os
import queue as queue_mod
import random
import socket
import threading
import time
import urllib.parse

import numpy as np

# every hedge copy replay_fleet_http issues, and nothing else: 0 after any
# replay with hedge=False
HEDGES_ISSUED = 0


@dataclasses.dataclass
class ReplayReport:
    target_qps: float
    # offered = arrival rate actually generated (includes drops + errors);
    # achieved = COMPLETED requests only
    offered_qps: float
    achieved_qps: float
    duration_s: float
    n_requests: int
    n_errors: int
    p50_ms: float
    p95_ms: float
    p99_ms: float
    by_source: dict[str, int]
    # the server's queue-vs-device split, filled from /metrics by callers
    # that scrape it
    queue_wait_p50_ms: float | None = None
    queue_wait_p99_ms: float | None = None
    device_p50_ms: float | None = None
    device_p99_ms: float | None = None
    e2e_p999_ms: float | None = None
    # cache split, present when the target reports cache outcomes (the
    # HTTP server's X-KMLS-Cache header, or a send() returning
    # (source, cached))
    cache_hit_ratio: float | None = None
    cached_p50_ms: float | None = None
    cached_p99_ms: float | None = None
    uncached_p50_ms: float | None = None
    uncached_p99_ms: float | None = None
    # p99 of the requests that ARRIVED in the schedule's first 40 % and its
    # last 40 % (replays that keep arrival-indexed latencies)
    onset_p99_ms: float | None = None
    steady_p99_ms: float | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class ClientTraceLog:
    """The client half of the trace join: one record per request whose
    response echoed an ``X-KMLS-Trace`` id, with the send/receive wall
    clocks the server's retained spans (``GET /debug/traces``) cannot
    know. Bounded and thread-safe; ``observability/tracejoin.py`` merges
    the two halves into one per-request timeline."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = max(1, capacity)
        self._entries: list[dict] = []
        self._lock = threading.Lock()
        self.dropped = 0

    def record(
        self, trace_id: str, send_unix: float, recv_unix: float, status: int = 200,
    ) -> None:
        if not trace_id:
            return
        entry = {
            "trace_id": trace_id,
            "client_send_unix": round(send_unix, 6),
            "client_recv_unix": round(recv_unix, 6),
            "client_rtt_ms": round((recv_unix - send_unix) * 1e3, 4),
            "status": int(status),
        }
        with self._lock:
            if len(self._entries) >= self.capacity:
                self.dropped += 1
                return
            self._entries.append(entry)

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._entries)

    def write_jsonl(self, path: str) -> int:
        """Dump the log → records written (a client-side scratch file,
        not a volume artifact)."""
        entries = self.entries()
        # kmls-verify: allow[atomic-write] — loadgen-side scratch JSONL on
        # the client host, not a PVC artifact; no reader races it
        with open(path, "w", encoding="utf-8") as fh:
            for e in entries:
                fh.write(json.dumps(e) + "\n")
        return len(entries)


def _unpack_send_result(result) -> tuple[str, bool | None]:
    """send() returns a bare source tag, or (source, cached)."""
    if isinstance(result, tuple):
        return result[0], bool(result[1])
    return result, None


def attach_attribution(report: ReplayReport, metrics) -> ReplayReport:
    """Fold a :class:`~.metrics.ServingMetrics` queue/device split into
    the report (milliseconds)."""
    qw50, qw99 = metrics.queue_wait.percentiles(0.50, 0.99)
    dv50, dv99 = metrics.device.percentiles(0.50, 0.99)
    (e2e999,) = metrics.e2e.percentiles(0.999)
    report.queue_wait_p50_ms = qw50 * 1e3
    report.queue_wait_p99_ms = qw99 * 1e3
    report.device_p50_ms = dv50 * 1e3
    report.device_p99_ms = dv99 * 1e3
    report.e2e_p999_ms = e2e999 * 1e3
    return report


def onset_steady_p99(
    points: list[tuple[float, float]],
    span_s: float,
    *,
    onset_frac: float = 0.4,
    steady_frac: float = 0.6,
) -> tuple[float | None, float | None]:
    """Split ``(relative_arrival_s, latency_ms)`` points by ARRIVAL into
    the first ``onset_frac`` of ``span_s`` and the part after
    ``steady_frac`` → each window's p99 (None when empty). A request that
    arrived at the cliff and finished late stays the cliff's."""
    if not points or span_s <= 0:
        return None, None
    onset = sorted(d for t, d in points if t <= onset_frac * span_s)
    steady = sorted(d for t, d in points if t >= steady_frac * span_s)
    return (
        _percentile(onset, 0.99) if onset else None,
        _percentile(steady, 0.99) if steady else None,
    )


def _percentile(sorted_ms: list[float], q: float) -> float:
    if not sorted_ms:
        return float("nan")
    idx = min(int(q * len(sorted_ms)), len(sorted_ms) - 1)
    return sorted_ms[idx]


def _cache_split_fields(lat_cached: list[float], lat_uncached: list[float], n_ok: int) -> dict:
    """→ the ReplayReport cache-split kwargs (empty when the target never
    reported a cache outcome)."""
    if not lat_cached and not lat_uncached:
        return {}
    cached_sorted = sorted(lat_cached)
    uncached_sorted = sorted(lat_uncached)
    out = {"cache_hit_ratio": len(cached_sorted) / n_ok if n_ok else 0.0}
    if cached_sorted:
        out["cached_p50_ms"] = _percentile(cached_sorted, 0.50)
        out["cached_p99_ms"] = _percentile(cached_sorted, 0.99)
    if uncached_sorted:
        out["uncached_p50_ms"] = _percentile(uncached_sorted, 0.50)
        out["uncached_p99_ms"] = _percentile(uncached_sorted, 0.99)
    return out


def _report(qps: float, duration: float, n_requests: int, lat_ms: list[float],
            n_errors: int, by_source: dict, split: dict, **extra) -> ReplayReport:
    lat_sorted = sorted(lat_ms)
    n_ok = len(lat_sorted)
    return ReplayReport(
        target_qps=qps,
        offered_qps=(n_ok + n_errors) / duration if duration > 0 else 0.0,
        achieved_qps=n_ok / duration if duration > 0 else 0.0,
        duration_s=duration,
        n_requests=n_requests,
        n_errors=n_errors,
        p50_ms=_percentile(lat_sorted, 0.50),
        p95_ms=_percentile(lat_sorted, 0.95),
        p99_ms=_percentile(lat_sorted, 0.99),
        by_source=by_source,
        **split,
        **extra,
    )


def sample_seed_sets(
    vocab: list[str],
    n: int,
    *,
    seeds_per_request: int = 3,
    unknown_fraction: float = 0.1,
    rng_seed: int = 0,
    zipf_s: float = 0.0,
    zipf_pool: int = 512,
) -> list[list[str]]:
    """n request payloads: mostly known tracks, a slice of unknown ones.
    ``zipf_s > 0`` draws a pool of ``zipf_pool`` distinct payloads exactly
    as before and picks pool entry k with probability ∝ 1/k^s."""
    rng = random.Random(rng_seed)

    def _draw(i: int) -> list[str]:
        if vocab and rng.random() >= unknown_fraction:
            k = min(seeds_per_request, len(vocab))
            return rng.sample(vocab, k)
        return [f"__replay_unknown_{i}__"]

    if zipf_s <= 0.0:
        return [_draw(i) for i in range(n)]
    pool = [_draw(i) for i in range(max(1, min(zipf_pool, max(n, 1))))]
    ranks = np.arange(1, len(pool) + 1, dtype=np.float64)
    p = ranks ** -zipf_s
    p /= p.sum()
    picks = np.random.default_rng(rng_seed).choice(len(pool), size=n, p=p)
    return [pool[int(i)] for i in picks]


def _poisson_arrivals(n: int, qps: float) -> np.ndarray:
    """The reference's constant-rate schedule (seconds from start)."""
    return shaped_arrivals(n, qps)


REPLAY_SHAPES = ("constant", "burst", "ramp", "sine")


def shaped_arrivals(
    n: int,
    qps: float,
    shape: str = "constant",
    *,
    rng_seed: int = 12345,
    burst_factor: float = 10.0,
    burst_fraction: float = 0.15,
    n_bursts: int = 4,
    ramp_start_factor: float = 0.1,
    ramp_stop_factor: float = 2.0,
    sine_amplitude: float = 0.75,
    sine_cycles: float = 2.0,
) -> np.ndarray:
    """Arrival times (seconds from start) of ``n`` requests whose rate
    follows ``shape``: ``constant`` (``qps``, the replays' legacy schedule
    bit for bit), ``burst`` (``n_bursts`` trains of ``burst_fraction`` of
    each period at ``burst_factor`` × ``qps``), ``ramp`` (linear from
    ``ramp_start_factor`` to ``ramp_stop_factor`` × ``qps``) or ``sine``
    (``sine_cycles`` cycles of ``qps·(1 ± sine_amplitude)``). Unit-rate
    exponential gaps are divided by the rate at the current arrival, so
    every shape emits exactly ``n`` requests; an unknown shape raises."""
    if shape not in REPLAY_SHAPES:
        raise ValueError(
            f"unknown replay shape {shape!r}; expected one of {'/'.join(REPLAY_SHAPES)}"
        )
    rng = np.random.default_rng(rng_seed)
    if shape == "constant":
        # the scale goes into exponential(): numpy's scale·standard_exp can
        # differ from gaps/qps in the last bit
        return np.cumsum(rng.exponential(1.0 / qps, size=n))
    unit_gaps = rng.exponential(1.0, size=n)
    # the run length at the shape's mean rate: the rate functions are
    # phased against it
    if shape == "burst":
        mean = qps * (1.0 + burst_fraction * (burst_factor - 1.0))
    elif shape == "ramp":
        mean = qps * (ramp_start_factor + ramp_stop_factor) / 2.0
    else:  # sine
        mean = qps
    nominal_s = n / mean

    def rate(t: float) -> float:
        # past the nominal window (a slow target stretches real time) the
        # shape holds its final value
        phase = min(t / nominal_s, 1.0) if nominal_s > 0 else 1.0
        if shape == "burst":
            if phase >= 1.0:
                return qps  # each period ends at the base rate
            period = 1.0 / max(n_bursts, 1)
            in_burst = (phase % period) < burst_fraction * period
            return qps * burst_factor if in_burst else qps
        if shape == "ramp":
            return qps * (ramp_start_factor + (ramp_stop_factor - ramp_start_factor) * phase)
        # sine, floored at 5 % of the base so the process always advances
        return max(
            qps * (1.0 + sine_amplitude * math.sin(2.0 * math.pi * sine_cycles * phase)),
            0.05 * qps,
        )

    out = np.empty(n, dtype=np.float64)
    t = 0.0
    for i in range(n):
        t += unit_gaps[i] / rate(t)
        out[i] = t
    return out


def flash_crowd_payloads(
    payloads: list[list[str]],
    *,
    window: tuple[float, float] = (0.4, 0.7),
    hot_pool: int = 4,
) -> list[list[str]]:
    """The flash-crowd mix: inside ``window`` (fractions of the stream)
    every request is one of ``hot_pool`` distinct seed sets taken from the
    window's own head (cold at onset); outside it the mix is unchanged."""
    n = len(payloads)
    lo, hi = int(window[0] * n), int(window[1] * n)
    if hi <= lo:
        return list(payloads)
    seen: dict[tuple, None] = {}
    for p in payloads[lo:hi]:
        seen.setdefault(tuple(p), None)
        if len(seen) >= hot_pool:
            break
    pool = [list(p) for p in seen]
    return [
        list(pool[i % len(pool)]) if lo <= i < hi else list(payloads[i])
        for i in range(n)
    ]


def _fire_events(events, i: int, fired: set) -> None:
    """Run each not-yet-fired event whose index is <= i (on the pacing
    thread; an event that raises is the harness's fault and propagates)."""
    if not events:
        return
    for j, (at_index, fn) in enumerate(events):
        if j not in fired and i >= at_index:
            fired.add(j)
            fn()


def replay(
    send,  # callable(list[str]) -> source tag or (source, cached)
    payloads: list[list[str]],
    *,
    qps: float,
    max_concurrency: int = 256,
    arrivals: np.ndarray | None = None,
    events: list | None = None,
) -> ReplayReport:
    """Open-loop replay, one thread per request: request i is dispatched
    at its arrival time whatever earlier requests did (beyond
    ``max_concurrency`` in flight an arrival counts as an error).
    ``arrivals`` replaces the constant-rate schedule; ``events`` is
    ``[(index, fn)]``."""
    arrival = arrivals if arrivals is not None else _poisson_arrivals(len(payloads), qps)
    lat_ms: list[float] = []
    lat_cached: list[float] = []
    lat_uncached: list[float] = []
    by_source: dict[str, int] = {}
    errors = 0
    lock = threading.Lock()
    inflight = threading.Semaphore(max_concurrency)
    threads: list[threading.Thread] = []

    def worker(seeds: list[str]) -> None:
        nonlocal errors
        t0 = time.perf_counter()
        try:
            source, cached = _unpack_send_result(send(seeds))
            dt_ms = (time.perf_counter() - t0) * 1e3
            with lock:
                lat_ms.append(dt_ms)
                if cached is not None:
                    (lat_cached if cached else lat_uncached).append(dt_ms)
                by_source[source] = by_source.get(source, 0) + 1
        except Exception:
            with lock:
                errors += 1
        finally:
            inflight.release()

    fired: set = set()
    start = time.perf_counter()
    for i, seeds in enumerate(payloads):
        wait = arrival[i] - (time.perf_counter() - start)
        if wait > 0:
            time.sleep(wait)
        _fire_events(events, i, fired)
        if not inflight.acquire(blocking=False):
            with lock:
                errors += 1
            continue
        t = threading.Thread(target=worker, args=(seeds,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=60.0)
    duration = time.perf_counter() - start
    # a straggler past its join deadline lands before this snapshot or not
    # at all
    with lock:
        return _report(qps, duration, len(payloads), list(lat_ms), errors, dict(by_source),
                       _cache_split_fields(lat_cached, lat_uncached, len(lat_ms)))


def replay_pooled(
    make_send,  # () -> callable(list[str]) -> source tag or (source, cached)
    payloads: list[list[str]],
    *,
    qps: float,
    n_workers: int = 64,
    max_queue: int = 512,
    arrivals: np.ndarray | None = None,
    events: list | None = None,
) -> ReplayReport:
    """Open-loop replay with a fixed worker pool and one persistent sender
    per worker. Arrivals are Poisson-paced into a bounded queue and latency
    runs from the scheduled ARRIVAL to completion — queue wait included —
    so an overloaded target shows as latency and drops, never as reduced
    offered load. ``arrivals`` overrides the constant-rate schedule;
    ``events`` as in :func:`replay`. The report carries the onset/steady
    p99 split."""
    arrival = arrivals if arrivals is not None else _poisson_arrivals(len(payloads), qps)
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max_queue)
    lat_ms: list[float] = []
    # (arrival s from start, latency ms) per completion: the onset/steady
    # split's input
    lat_points: list[tuple[float, float]] = []
    lat_cached: list[float] = []
    lat_uncached: list[float] = []
    by_source: dict[str, int] = {}
    errors = 0
    lock = threading.Lock()

    def worker() -> None:
        nonlocal errors
        send = make_send()
        while True:
            item = q.get()
            if item is None:
                return
            # sweep a burst behind the blocking get: one wakeup per item
            # is the loadgen's ceiling at high rates
            burst = [item]
            while len(burst) < 64:
                try:
                    extra = q.get_nowait()
                except queue_mod.Empty:
                    break
                if extra is None:
                    q.put_nowait(None)  # keep the sentinel for the pool
                    break
                burst.append(extra)
            for arrival_abs, seeds in burst:
                try:
                    source, cached = _unpack_send_result(send(seeds))
                    dt_ms = (time.perf_counter() - arrival_abs) * 1e3
                    with lock:
                        lat_ms.append(dt_ms)
                        # start is bound before anything is enqueued
                        lat_points.append((arrival_abs - start, dt_ms))
                        if cached is not None:
                            (lat_cached if cached else lat_uncached).append(dt_ms)
                        by_source[source] = by_source.get(source, 0) + 1
                except Exception:
                    with lock:
                        errors += 1

    workers = [threading.Thread(target=worker, daemon=True) for _ in range(n_workers)]
    for w in workers:
        w.start()
    fired: set = set()
    start = time.perf_counter()
    for i, seeds in enumerate(payloads):
        wait = arrival[i] - (time.perf_counter() - start)
        if wait > 0:
            time.sleep(wait)
        _fire_events(events, i, fired)
        try:
            q.put_nowait((start + arrival[i], seeds))
        except queue_mod.Full:
            with lock:
                errors += 1  # target (or pool) saturated: an honest drop
    for _ in workers:
        q.put(None)
    for w in workers:
        w.join(timeout=120.0)
    duration = time.perf_counter() - start
    with lock:
        onset_p99, steady_p99 = onset_steady_p99(
            list(lat_points), float(arrival[-1]) if len(arrival) else 0.0
        )
        return _report(qps, duration, len(payloads), list(lat_ms), errors, dict(by_source),
                       _cache_split_fields(lat_cached, lat_uncached, len(lat_ms)),
                       onset_p99_ms=onset_p99, steady_p99_ms=steady_p99)


def _parse_http_head(head: bytes) -> tuple[int, int, bytes]:
    """The pipelined client's response-head parse → ``(status,
    content_length, lowercased head)``."""
    head_lower = head.lower()
    clen = 0
    for line in head_lower.split(b"\r\n"):
        if line.startswith(b"content-length"):
            clen = int(line.split(b":", 1)[1])
    return int(head.split(b" ", 2)[1]), clen, head_lower


async def _open_http_conn(host: str, port: int):
    """Persistent loadgen connection with TCP_NODELAY."""
    reader, writer = await asyncio.open_connection(host, port)
    sock = writer.get_extra_info("socket")
    if sock is not None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return reader, writer


def replay_async_http(
    url: str,
    payloads: list[list[str]],
    *,
    qps: float,
    n_conns: int = 32,
    pipeline: int = 16,
    max_queue: int = 4096,
    responses: list | None = None,
    trace_log: ClientTraceLog | None = None,
) -> ReplayReport:
    """Open-loop HTTP replay on ONE event loop with request pipelining:
    arrivals are Poisson-paced into a queue, each of ``n_conns``
    persistent connections writes bursts of up to ``pipeline`` queued
    requests as one send and reads the responses back to back, and latency
    runs from the SCHEDULED arrival to response completion, so an
    overloaded server (or client) shows as latency/drops, never as reduced
    offered load. Every non-200 answer counts as an error. ``responses``,
    when given, receives ``(request index, status, lowercased head, body)``
    per answer; ``trace_log`` records each echoed ``X-KMLS-Trace`` id with
    the request's scheduled arrival and completion as wall clocks."""
    u = urllib.parse.urlsplit(url)
    host, port = u.hostname or "127.0.0.1", u.port or 80
    # pre-encode every request: the loadgen's job is pacing, not cooking
    reqs: list[bytes] = []
    for seeds in payloads:
        body = json.dumps({"songs": seeds}).encode()
        reqs.append(
            b"POST /api/recommend/ HTTP/1.1\r\nHost: replay\r\n"
            b"Content-Type: application/json\r\nContent-Length: "
            + str(len(body)).encode() + b"\r\n\r\n" + body
        )
    arrival = _poisson_arrivals(len(payloads), qps)
    lat_ms: list[float] = []
    lat_cached: list[float] = []
    lat_uncached: list[float] = []
    by_source: dict[str, int] = {}
    errors = 0
    # perf_counter → unix offset, taken once: trace-log records carry wall
    # clocks so tracejoin can line them up with the spans' start_unix
    wall_off = time.time() - time.perf_counter()

    async def _run() -> None:
        nonlocal errors
        queue: asyncio.Queue = asyncio.Queue(maxsize=max_queue)

        async def worker() -> None:
            nonlocal errors
            reader, writer = await _open_http_conn(host, port)
            dead = False  # reconnect failed: drain the queue as errors
            while True:
                item = await queue.get()
                if item is None:
                    if writer is not None:
                        writer.close()
                    return
                burst = [item]
                while len(burst) < pipeline:
                    try:
                        extra = queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if extra is None:
                        queue.put_nowait(None)  # keep the sentinel
                        break
                    burst.append(extra)
                if dead:
                    errors += len(burst)
                    continue
                done = 0  # responses already accounted (ok OR non-200)
                try:
                    writer.write(b"".join(reqs[i] for _, i in burst))
                    for t_arr, i in burst:
                        head = await reader.readuntil(b"\r\n\r\n")
                        status, clen, head_lower = _parse_http_head(head)
                        body = await reader.readexactly(clen)
                        done += 1
                        t_done = time.perf_counter()
                        if responses is not None:
                            responses.append((i, status, head_lower, body))
                        if trace_log is not None:
                            for line in head_lower.split(b"\r\n"):
                                if line.startswith(b"x-kmls-trace:"):
                                    trace_log.record(
                                        line.split(b":", 1)[1].strip().decode("ascii", "replace"),
                                        wall_off + t_arr, wall_off + t_done, status,
                                    )
                                    break
                        if status != 200:
                            errors += 1
                            continue
                        dt_ms = (t_done - t_arr) * 1e3
                        lat_ms.append(dt_ms)
                        if b"x-kmls-cache: hit" in head_lower:
                            lat_cached.append(dt_ms)
                        else:
                            lat_uncached.append(dt_ms)
                        source = "empty" if b'"songs": []' in body else "nonempty"
                        by_source[source] = by_source.get(source, 0) + 1
                except Exception:
                    # only the UNanswered tail of the burst is new errors
                    errors += len(burst) - done
                    try:
                        writer.close()
                    except Exception:
                        pass
                    try:
                        reader, writer = await _open_http_conn(host, port)
                    except OSError:
                        dead = True
                        writer = None

        workers = [asyncio.create_task(worker()) for _ in range(n_conns)]
        t0 = time.perf_counter()
        for i in range(len(payloads)):
            wait = arrival[i] - (time.perf_counter() - t0)
            if wait > 0:
                await asyncio.sleep(wait)
            try:
                queue.put_nowait((t0 + arrival[i], i))
            except asyncio.QueueFull:
                errors += 1  # saturated: an honest drop
        for _ in workers:
            await queue.put(None)
        await asyncio.gather(*workers)

    start = time.perf_counter()
    asyncio.run(_run())
    duration = time.perf_counter() - start
    return _report(qps, duration, len(payloads), lat_ms, errors, by_source,
                   _cache_split_fields(lat_cached, lat_uncached, len(lat_ms)))


def replay_fleet_http(
    peer_urls: dict[str, str],
    payloads: list[list[str]],
    *,
    qps: float,
    policy: str = "ring",
    n_conns: int = 4,
    pipeline: int = 16,
    max_queue: int = 8192,
    eject_threshold: int = 3,
    probe_interval_s: float = 1.0,
    redispatch_max: int = 4,
    window_end: int | None = None,
    events: list | None = None,
    hedge: bool = False,
    hedge_delay_ms: float = 30.0,
    hedge_max_frac: float = 0.05,
    slow_ratio: float = 0.0,
    deadline_ms: float = 0.0,
    responses: list | None = None,
) -> tuple[ReplayReport, dict]:
    """Open-loop HTTP replay against an N-replica fleet on ONE event loop,
    ``n_conns`` persistent pipelined connections per peer — the load
    generator of the fleet cache tier, a stand-in for a consistent-hash
    ingress.

    ``policy``: ``ring`` routes each request to the rendezvous owner of
    its seed-set key through a :class:`~..freshness.ring.FleetRouter` (the
    ring ``simulate_fleet`` scores and the servers stamp owners with); a
    peer failing ``eject_threshold`` consecutive sends is ejected, its
    keys spill to their next weight, and a half-open probe every
    ``probe_interval_s`` re-admits it. ``roundrobin`` is the
    independent-caches baseline. A send that dies re-dispatches its
    UNanswered requests (at most ``redispatch_max`` times each) before
    counting an error, so a replica killed mid-replay reads as remap and
    survivor latency, never as drops; a 503 with
    ``X-KMLS-Mesh-Unavailable`` (a gang missing a member) is a peer
    failure that blames the named shard and spills the same way. Latency
    runs from the scheduled arrival, retries included.

    ``window_end`` splits the cache-outcome accounting at that request
    index; ``events`` is ``[(index, fn)]``. ``slow_ratio > 0`` arms the
    router's slow ladder on every first-attempt answer. ``hedge=True``:
    after the primary peer's adaptive delay (~p95, floored at
    ``hedge_delay_ms``) an unanswered request goes ONCE to the next
    healthy ranked peer; the first answer wins, the loser is discarded
    and digest-compared (``hedge_mismatch``); hedges spend a token bucket
    that earns ``hedge_max_frac`` per primary dispatch. ``deadline_ms > 0``
    stamps the remaining budget on each request as
    ``X-KMLS-Deadline-Budget`` at write time. ``responses``, when given,
    receives ``(request index, peer, status, lowercased head, body)`` per
    answer that won. → ``(ReplayReport, fleet)``, ``fleet`` holding hit
    ratios, per-peer answer counts and the router's and the hedges'
    counters."""
    from ..freshness.ring import FleetRouter, seeds_key

    if policy not in ("ring", "roundrobin"):
        raise ValueError(f"unknown fleet routing policy {policy!r}")
    peers = sorted(peer_urls)
    router = FleetRouter(
        peers, eject_threshold=eject_threshold, probe_interval_s=probe_interval_s,
        slow_ratio=slow_ratio,
    )
    addr: dict[str, tuple[str, int]] = {}
    for peer, url in peer_urls.items():
        u = urllib.parse.urlsplit(url)
        addr[peer] = (u.hostname or "127.0.0.1", u.port or 80)
    keys = [seeds_key(p) for p in payloads]
    # heads carrying a budget or a hedge mark are built at write time; the
    # pre-encoded fast path is used whenever both are off
    dynamic_head = hedge or deadline_ms > 0
    bodies = [json.dumps({"songs": seeds}).encode() for seeds in payloads]
    reqs = [
        b"POST /api/recommend/ HTTP/1.1\r\nHost: replay\r\n"
        b"Content-Type: application/json\r\nContent-Length: "
        + str(len(body)).encode() + b"\r\n\r\n" + body
        for body in bodies
    ]
    arrival = _poisson_arrivals(len(payloads), qps)
    lat_ms: list[float] = []
    lat_cached: list[float] = []
    lat_uncached: list[float] = []
    stats = {
        "http_5xx": 0, "owner_stamped": 0, "rerouted": 0, "errors": 0,
        "win_total": 0, "win_hits": 0, "mesh_unavailable": 0,
        "hedges_issued": 0, "hedge_wins": 0, "hedge_losses": 0,
        "hedges_suppressed": 0, "hedge_mismatch": 0, "deadline_expired": 0,
    }
    answered_by = {p: 0 for p in peers}
    # one winner per request when hedging races two copies
    answered = bytearray(len(payloads))
    digests: dict[int, bytes] = {}
    hedged: set[int] = set()
    # earns hedge_max_frac per primary dispatch, spends 1.0 per hedge,
    # starts full at a small burst cap
    hedge_cap = max(1.0, 16.0 * hedge_max_frac)
    hedge_tokens = [hedge_cap]

    def _bdigest(payload: bytes) -> bytes:
        return hashlib.blake2b(payload, digest_size=8).digest()

    def _wire(item) -> bytes:
        t_arr, idx, _attempts, is_hedge = item
        if not dynamic_head:
            return reqs[idx]
        extra = b""
        if deadline_ms > 0:
            remaining = deadline_ms - (time.perf_counter() - t_arr) * 1e3
            extra += b"X-KMLS-Deadline-Budget: " + str(max(0, int(remaining))).encode() + b"\r\n"
        if is_hedge:
            extra += b"X-KMLS-Hedge: 1\r\n"
        body = bodies[idx]
        return (
            b"POST /api/recommend/ HTTP/1.1\r\nHost: replay\r\n"
            b"Content-Type: application/json\r\n" + extra
            + b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body
        )

    async def _run() -> None:
        queues = {p: asyncio.Queue(maxsize=max_queue) for p in peers}
        outstanding = [0]
        drained = asyncio.Event()
        drained.set()

        def _enter() -> None:
            outstanding[0] += 1
            drained.clear()

        def _leave() -> None:
            outstanding[0] -= 1
            if outstanding[0] <= 0:
                drained.set()

        def _redispatch(item, failed_peer: str) -> None:
            """A failed request back out, or an error once its budget is
            spent. The round-robin baseline retries on the next peer in
            cyclic order: routing its retries to owners would warm the
            owners' caches like the routed leg."""
            t_arr, idx, attempts, is_hedge = item
            if hedge and answered[idx]:
                _leave()  # the other copy already won
                return
            if attempts >= redispatch_max:
                stats["errors"] += 1
                _leave()
                return
            if policy == "ring":
                target = router.route(keys[idx])
            else:
                step = 1 + (attempts % max(len(peers) - 1, 1))
                target = peers[(peers.index(failed_peer) + step) % len(peers)]
            stats["rerouted"] += 1
            try:
                queues[target].put_nowait((t_arr, idx, attempts + 1, is_hedge))
            except asyncio.QueueFull:
                stats["errors"] += 1
                _leave()

        def _account(peer: str, item, status: int, head_lower: bytes, payload: bytes) -> bool:
            """Account one response → True for a gang's 503 refusal (the
            caller then must not mark the burst a success)."""
            t_arr, idx, attempts, is_hedge = item
            if hedge and answered[idx]:
                # the losing copy: discarded, but still an observation
                if status == 200:
                    want = digests.get(idx)
                    if want is not None and _bdigest(payload) != want:
                        stats["hedge_mismatch"] += 1
                    if not is_hedge and attempts == 0:
                        router.mark_latency(peer, time.perf_counter() - t_arr)
                elif status >= 500 and b"x-kmls-mesh-unavailable:" not in head_lower:
                    stats["http_5xx"] += 1
                _leave()
                return False
            if status == 503 and b"x-kmls-mesh-unavailable:" in head_lower:
                shard = None
                for line in head_lower.split(b"\r\n"):
                    if line.startswith(b"x-kmls-mesh-unavailable:"):
                        val = line.split(b":", 1)[1].strip()
                        if val.isdigit():
                            shard = int(val)
                stats["mesh_unavailable"] += 1
                router.mark_failure(peer, shard=shard)
                _redispatch(item, peer)
                return True
            if status >= 500:
                stats["http_5xx"] += 1
                stats["errors"] += 1
                _leave()
                return False
            if status != 200:
                stats["errors"] += 1
                _leave()
                return False
            dt_s = time.perf_counter() - t_arr
            dt_ms = dt_s * 1e3
            lat_ms.append(dt_ms)
            hit = b"x-kmls-cache: hit" in head_lower
            (lat_cached if hit else lat_uncached).append(dt_ms)
            if b"x-kmls-cache-owner:" in head_lower:
                stats["owner_stamped"] += 1
            if b"x-kmls-degraded: deadline-expired" in head_lower:
                stats["deadline_expired"] += 1
            if window_end is not None and idx < window_end:
                stats["win_total"] += 1
                stats["win_hits"] += int(hit)
            answered_by[peer] += 1
            if responses is not None:
                responses.append((idx, peer, status, head_lower, payload))
            # first-attempt primaries are clean observations of their peer
            if not is_hedge and attempts == 0:
                router.mark_latency(peer, dt_s)
            if hedge:
                answered[idx] = 1
                if idx in hedged:
                    digests[idx] = _bdigest(payload)
                    stats["hedge_wins" if is_hedge else "hedge_losses"] += 1
            _leave()
            return False

        async def worker(peer: str) -> None:
            queue = queues[peer]
            reader = writer = None
            while True:
                item = await queue.get()
                if item is None:
                    if writer is not None:
                        writer.close()
                    return
                burst = [item]
                while len(burst) < pipeline:
                    try:
                        extra = queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if extra is None:
                        queue.put_nowait(None)
                        break
                    burst.append(extra)
                if writer is None:
                    try:
                        reader, writer = await _open_http_conn(*addr[peer])
                    except OSError:
                        # unreachable: one failure per burst, the work spills
                        router.mark_failure(peer)
                        for it in burst:
                            _redispatch(it, peer)
                        continue
                done = 0
                burst_mesh_degraded = False
                try:
                    writer.write(b"".join(_wire(it) for it in burst))
                    for it in burst:
                        head = await reader.readuntil(b"\r\n\r\n")
                        status, clen, head_lower = _parse_http_head(head)
                        payload = await reader.readexactly(clen)
                        done += 1
                        burst_mesh_degraded |= _account(peer, it, status, head_lower, payload)
                    if not burst_mesh_degraded:
                        # a gang still missing a shard is re-admitted only
                        # by a burst it actually serves
                        router.mark_success(peer)
                except Exception:
                    # the answered prefix is accounted; the tail spills
                    router.mark_failure(peer)
                    for it in burst[done:]:
                        _redispatch(it, peer)
                    try:
                        writer.close()
                    except Exception:
                        pass
                    reader = writer = None

        async def _hedge_after(idx: int, t_arr: float, primary: str) -> None:
            """One hedge audition of request ``idx``."""
            global HEDGES_ISSUED
            delay = router.hedge_delay_s(primary, hedge_delay_ms / 1e3)
            wait = (t_arr + delay) - time.perf_counter()
            if wait > 0:
                await asyncio.sleep(wait)
            if answered[idx]:
                return
            if hedge_tokens[0] < 1.0:
                stats["hedges_suppressed"] += 1  # no token: plain waiting
                return
            # never hedge onto an ejected (or slow-ejected) peer
            unhealthy = set(router.ejected_peers())
            if policy == "ring":
                target = next(
                    (p for p in router.ring.ranked(keys[idx])
                     if p != primary and p not in unhealthy),
                    None,
                )
            else:
                start = peers.index(primary)
                target = next(
                    (peers[(start + off) % len(peers)] for off in range(1, len(peers))
                     if peers[(start + off) % len(peers)] not in unhealthy),
                    None,
                )
            if target is None or target == primary:
                stats["hedges_suppressed"] += 1
                return
            hedge_tokens[0] -= 1.0
            HEDGES_ISSUED += 1
            stats["hedges_issued"] += 1
            hedged.add(idx)
            _enter()
            try:
                queues[target].put_nowait((t_arr, idx, 0, True))
            except asyncio.QueueFull:
                hedged.discard(idx)
                stats["hedges_suppressed"] += 1
                _leave()

        workers = [asyncio.create_task(worker(p)) for p in peers for _ in range(n_conns)]
        hedge_tasks: list = []
        fired: set = set()
        t0 = time.perf_counter()
        for i in range(len(payloads)):
            wait = arrival[i] - (time.perf_counter() - t0)
            if wait > 0:
                await asyncio.sleep(wait)
            _fire_events(events, i, fired)
            target = router.route(keys[i]) if policy == "ring" else peers[i % len(peers)]
            _enter()
            try:
                queues[target].put_nowait((t0 + arrival[i], i, 0, False))
            except asyncio.QueueFull:
                stats["errors"] += 1
                _leave()
                continue
            if hedge:
                hedge_tokens[0] = min(hedge_tokens[0] + hedge_max_frac, hedge_cap)
                hedge_tasks.append(
                    asyncio.create_task(_hedge_after(i, t0 + arrival[i], target))
                )
        # re-dispatches re-enter a queue: the sentinels go out only once
        # every request is answered, errored or given up
        try:
            await asyncio.wait_for(drained.wait(), timeout=120.0)
        except asyncio.TimeoutError:
            # wedged past every retry: count the stuck tail, tear down
            stats["errors"] += max(outstanding[0], 0)
            for task in workers + hedge_tasks:
                task.cancel()
            await asyncio.gather(*workers, *hedge_tasks, return_exceptions=True)
            return
        for task in hedge_tasks:
            task.cancel()
        if hedge_tasks:
            await asyncio.gather(*hedge_tasks, return_exceptions=True)
        for p in peers:
            for _ in range(n_conns):
                queues[p].put_nowait(None)
        await asyncio.gather(*workers)

    start = time.perf_counter()
    asyncio.run(_run())
    duration = time.perf_counter() - start
    n_ok = len(lat_ms)
    report = _report(qps, duration, len(payloads), lat_ms, stats["errors"], {"fleet": n_ok},
                     _cache_split_fields(lat_cached, lat_uncached, n_ok))
    fleet = {
        "policy": policy,
        "peers": peers,
        "answered_by": dict(answered_by),
        "hit_ratio": (len(lat_cached) / n_ok) if n_ok else 0.0,
        "window_hit_ratio": (
            stats["win_hits"] / stats["win_total"] if stats["win_total"] else None
        ),
        "window_requests": stats["win_total"],
        "http_5xx": stats["http_5xx"],
        "rerouted": stats["rerouted"],
        "ejections": router.ejections,
        "readmissions": router.readmissions,
        "spills": router.spills,
        "owner_stamped": stats["owner_stamped"],
        "mesh_unavailable": stats["mesh_unavailable"],
        "failed_shards": router.failed_shards(),
        "slow_ejections": router.slow_ejections,
        "hedges_issued": stats["hedges_issued"],
        "hedge_wins": stats["hedge_wins"],
        "hedge_losses": stats["hedge_losses"],
        "hedges_suppressed": stats["hedges_suppressed"],
        "hedge_mismatch": stats["hedge_mismatch"],
        "deadline_expired": stats["deadline_expired"],
    }
    return report, fleet


def pooled_http_sender_factory(url: str, trace_log: ClientTraceLog | None = None):
    """→ ``make_send`` for :func:`replay_pooled`: each worker holds its own
    keep-alive HTTP/1.1 connection (reconnecting after an error); a non-200
    answer raises, so it counts as an error. ``trace_log`` records echoed
    ``X-KMLS-Trace`` ids."""
    import http.client

    u = urllib.parse.urlsplit(url)
    host, port = u.hostname or "127.0.0.1", u.port or 80

    def make_send():
        conn = http.client.HTTPConnection(host, port, timeout=30)

        def send(seeds: list[str]) -> str:
            body = json.dumps({"songs": seeds})
            t_send = time.time()
            try:
                conn.request("POST", "/api/recommend/", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = json.load(resp)
                if trace_log is not None:
                    tid = resp.getheader("X-KMLS-Trace")
                    if tid:
                        trace_log.record(tid, t_send, time.time(), resp.status)
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}")
            except Exception:
                conn.close()  # the next request reconnects
                raise
            return "nonempty" if data.get("songs") else "empty"

        return send

    return make_send


def _local_vocab() -> list[str]:
    """The served vocabulary, read from the artifacts under ``BASE_DIR``
    (the npz twin, else the pickle) without loading an engine. Empty when
    absent — then every request is an unknown seed and only the static
    fallback runs."""
    from ..config import ServingConfig
    from ..io import artifacts

    cfg = ServingConfig.from_env()
    rec_path = os.path.join(cfg.pickles_dir, cfg.recommendations_file)
    npz_path = artifacts.tensor_artifact_path(rec_path)
    try:
        if os.path.exists(npz_path):
            return [str(v) for v in artifacts.load_rule_tensors(npz_path)["vocab"]]
        rules = artifacts.load_pickle(rec_path)
    except (OSError, ValueError, KeyError):
        return []
    return sorted(set(rules) | {o for row in rules.values() for o in row})


def _replay_in_process(args, arrivals: np.ndarray, reshape) -> int:
    """The in-process target: the app core over ``BASE_DIR`` — the cache →
    batcher → engine path the HTTP front ends serve, without a socket."""
    from ..config import ServingConfig, torch_device_from_env
    from .app import RecommendApp

    cfg = dataclasses.replace(
        ServingConfig.from_env(),
        batch_max_size=args.batch_max_size, batch_window_ms=args.batch_window_ms,
    )
    app = RecommendApp(cfg, device=torch_device_from_env())
    try:
        if not app.engine.load():
            print("artifacts not found; run the mining job first")
            return 1

        def send(seeds: list[str]) -> tuple[str, bool]:
            _, source, cached = app.recommend_direct(seeds)
            return source, cached

        payloads = reshape(sample_seed_sets(
            app.engine.bundle.vocab, args.requests, zipf_s=args.zipf_s
        ))
        report = replay(send, payloads, qps=args.qps, arrivals=arrivals)
        attach_attribution(report, app.metrics)
        if app.cache is not None:
            report.cache_hit_ratio = app.cache.hit_ratio()
        out = json.loads(report.to_json())
        out["per_device_dispatch"] = list(app.engine.dispatch_counts)
        print(json.dumps(out))
        return 0
    finally:
        app.close()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--url", default=None,
                        help="the server, e.g. http://127.0.0.1:8000; default: in process")
    parser.add_argument("--batch-max-size", type=int, default=32,
                        help="in-process target: the batcher's batch size")
    parser.add_argument("--batch-window-ms", type=float, default=2.0,
                        help="in-process target: the batcher's window")
    parser.add_argument("--qps", type=float, default=1000.0)
    parser.add_argument("--requests", type=int, default=2000)
    parser.add_argument("--workers", type=int, default=64)
    parser.add_argument(
        "--client", choices=("async", "pooled"), default="async",
        help="HTTP loadgen: single-loop pipelined (default) or thread pool",
    )
    parser.add_argument(
        "--zipf-s", type=float, default=0.0,
        help="Zipf exponent for a skewed query mix over a pool of distinct "
             "payloads (0 = off, all distinct; 1.1 models real playlist-seed "
             "traffic and feeds the answer cache)",
    )
    parser.add_argument(
        "--shape", choices=REPLAY_SHAPES + ("flashcrowd",),
        default=os.environ.get("KMLS_REPLAY_SHAPE") or "constant",
        help="traffic shape: constant (Poisson), burst (--burst-factor trains), "
             "ramp, sine, or flashcrowd (constant rate, a mid-run collapse onto "
             "a few hot seed sets); default from KMLS_REPLAY_SHAPE",
    )
    parser.add_argument("--burst-factor", type=float, default=10.0,
                        help="burst-shape rate multiplier over --qps")
    parser.add_argument(
        "--fleet", default=None, metavar="PEER=URL,...",
        help="replay against an N-replica fleet with client-side consistent-hash "
             "routing: comma-separated peer=url pairs whose peer names match each "
             "server's KMLS_FLEET_SELF. Overrides --url.",
    )
    parser.add_argument(
        "--fleet-policy", choices=("ring", "roundrobin"), default="ring",
        help="fleet routing: ring (rendezvous owner) or roundrobin (independent caches)",
    )
    parser.add_argument(
        "--trace-log", default=None, metavar="PATH",
        help="write echoed X-KMLS-Trace ids + client send/recv wall clocks as "
             "JSONL (requires the server's KMLS_TRACE_SAMPLE > 0); join with the "
             "server's /debug/traces via python -m "
             "kmlserver_tpu_torch.observability.tracejoin",
    )
    args = parser.parse_args()
    if args.shape == "flashcrowd":
        arrivals = shaped_arrivals(args.requests, args.qps)
        reshape = flash_crowd_payloads
    else:
        arrivals = shaped_arrivals(args.requests, args.qps, args.shape,
                                   burst_factor=args.burst_factor)
        reshape = list
    vocab = _local_vocab()
    if args.fleet:
        peer_urls = dict(pair.split("=", 1) for pair in args.fleet.split(",") if "=" in pair)
        if not peer_urls:
            print("--fleet needs at least one peer=url pair")
            return 1
        if args.shape != "constant" or args.trace_log:
            # never pace a constant stream under a shaped or traced label
            print("--fleet supports constant arrivals only (no --shape/--trace-log "
                  "yet); drop the unsupported flag")
            return 1
        payloads = sample_seed_sets(vocab, args.requests, zipf_s=args.zipf_s)
        report, fleet = replay_fleet_http(peer_urls, payloads, qps=args.qps,
                                          policy=args.fleet_policy)
        out = json.loads(report.to_json())
        out["fleet"] = fleet
        print(json.dumps(out))
        return 0
    if not args.url:
        return _replay_in_process(args, arrivals, reshape)
    if not vocab:
        print("NOTE: no local artifacts found (BASE_DIR); all seeds are "
              "unknown — this measures the static-fallback path only")
    payloads = reshape(sample_seed_sets(vocab, args.requests, zipf_s=args.zipf_s))
    trace_log = ClientTraceLog() if args.trace_log else None
    if args.client == "async" and args.shape in ("constant", "flashcrowd"):
        # the pipelined client paces the constant schedule itself; shaped
        # rates need replay_pooled's arrivals=
        report = replay_async_http(args.url, payloads, qps=args.qps,
                                   n_conns=min(args.workers, 128),
                                   trace_log=trace_log)
    else:
        report = replay_pooled(pooled_http_sender_factory(args.url, trace_log), payloads,
                               qps=args.qps, n_workers=args.workers, arrivals=arrivals)
    if trace_log is not None:
        n_traced = trace_log.write_jsonl(args.trace_log)
        print(f"trace log: {n_traced} client records -> {args.trace_log}")
    print(report.to_json())
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
