"""QPS replay harness — counterpart of ``kmlserver_tpu/serving/replay.py``
for the load BASELINE config 5 sends: ``/api/recommend/`` requests at a
fixed rate with open-loop (Poisson-paced) arrivals — closed-loop clients
understate tail latency because a slow server throttles its own load —
reporting achieved QPS and latency percentiles.

    python -m kmlserver_tpu_torch.serving.replay --url http://127.0.0.1:8000 \\
        --qps 1000 --requests 8000 [--zipf-s 1.1] [--trace-log client.jsonl]

Seed sets are sampled from the served vocabulary (read from the artifacts
under ``BASE_DIR``, when it points at the server's PVC): mostly known
tracks and a slice of unknown ones, so both the rules path and the static
fallback run. ``--zipf-s`` repeats a payload pool with Zipf-skewed
frequencies — the head-heavy mix real playlist-seed traffic has, which
the answer cache feeds on. The draws are the reference's for the same
arguments. ``--trace-log`` writes a :class:`ClientTraceLog` — the echoed
``X-KMLS-Trace`` ids with the client's send and receive clocks — for
``python -m kmlserver_tpu_torch.observability.tracejoin``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import queue as queue_mod
import random
import socket
import threading
import time
import urllib.parse

import numpy as np


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
        with open(path, "w", encoding="utf-8") as fh:
            for e in entries:
                fh.write(json.dumps(e) + "\n")
        return len(entries)


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
            n_errors: int, by_source: dict, split: dict) -> ReplayReport:
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
    return np.cumsum(np.random.default_rng(12345).exponential(1.0 / qps, size=n))


def replay_pooled(
    make_send,  # () -> callable(list[str]) -> source tag or (source, cached)
    payloads: list[list[str]],
    *,
    qps: float,
    n_workers: int = 64,
    max_queue: int = 512,
    arrivals: np.ndarray | None = None,
) -> ReplayReport:
    """Open-loop replay with a fixed worker pool and one persistent sender
    per worker. Arrivals are Poisson-paced into a bounded queue and latency
    runs from the scheduled ARRIVAL to completion — queue wait included —
    so an overloaded target shows as latency and drops, never as reduced
    offered load. ``arrivals`` overrides the constant-rate schedule."""
    arrival = arrivals if arrivals is not None else _poisson_arrivals(len(payloads), qps)
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max_queue)
    lat_ms: list[float] = []
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
                    result = send(seeds)
                    source, cached = result if isinstance(result, tuple) else (result, None)
                    dt_ms = (time.perf_counter() - arrival_abs) * 1e3
                    with lock:
                        lat_ms.append(dt_ms)
                        if cached is not None:
                            (lat_cached if cached else lat_uncached).append(dt_ms)
                        by_source[source] = by_source.get(source, 0) + 1
                except Exception:
                    with lock:
                        errors += 1

    workers = [threading.Thread(target=worker, daemon=True) for _ in range(n_workers)]
    for w in workers:
        w.start()
    start = time.perf_counter()
    for i, seeds in enumerate(payloads):
        wait = arrival[i] - (time.perf_counter() - start)
        if wait > 0:
            time.sleep(wait)
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
        return _report(qps, duration, len(payloads), lat_ms, errors, dict(by_source),
                       _cache_split_fields(lat_cached, lat_uncached, len(lat_ms)))


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--url", required=True, help="the server, e.g. http://127.0.0.1:8000")
    parser.add_argument("--qps", type=float, default=1000.0)
    parser.add_argument("--requests", type=int, default=2000)
    parser.add_argument(
        "--zipf-s", type=float, default=0.0,
        help="Zipf exponent for a skewed query mix over a pool of distinct "
             "payloads (0 = off, all distinct; 1.1 models real playlist-seed "
             "traffic and feeds the answer cache)",
    )
    parser.add_argument(
        "--trace-log", default=None, metavar="PATH",
        help="write echoed X-KMLS-Trace ids + client send/recv wall clocks as "
             "JSONL (requires the server's KMLS_TRACE_SAMPLE > 0); join with the "
             "server's /debug/traces via python -m "
             "kmlserver_tpu_torch.observability.tracejoin",
    )
    args = parser.parse_args()
    vocab = _local_vocab()
    if not vocab:
        print("NOTE: no local artifacts found (BASE_DIR); all seeds are "
              "unknown — this measures the static-fallback path only")
    payloads = sample_seed_sets(vocab, args.requests, zipf_s=args.zipf_s)
    trace_log = ClientTraceLog() if args.trace_log else None
    report = replay_async_http(args.url, payloads, qps=args.qps, trace_log=trace_log)
    if trace_log is not None:
        n_traced = trace_log.write_jsonl(args.trace_log)
        print(f"trace log: {n_traced} client records -> {args.trace_log}")
    print(report.to_json())
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
