"""HTTP load for the serving cells, on one asyncio loop in the benchmark's
process.

- :func:`open_loop`: the open-loop schedule of the port's config-5 replay
  (``serving/replay.py::replay_async_http``): requests are queued at their
  scheduled arrival times, persistent connections each write up to
  ``pipeline`` queued requests as one send and read the answers back to
  back, and a request's latency runs from its SCHEDULED arrival to its
  answer, so a stall shows as latency of the requests behind it and never
  as less offered load.
- :func:`closed_loop`: ``clients`` connections, each sending its next
  request when its last answer has arrived.

Every answer is kept as ``(index, status, lowercased head, body)`` for the
check, with its latency; a request never answered is a failure.
"""

from __future__ import annotations

import asyncio
import json
import socket
import time

LATE_LIMIT_S = 60.0  # how long past the window an answer is awaited


def encode(payload: list[str]) -> bytes:
    body = json.dumps({"songs": payload}).encode()
    return (b"POST /api/recommend/ HTTP/1.1\r\nHost: bench\r\n"
            b"Content-Type: application/json\r\nContent-Length: "
            + str(len(body)).encode() + b"\r\n\r\n" + body)


async def _connect(port: int):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    sock = writer.get_extra_info("socket")
    if sock is not None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return reader, writer


async def _read_answer(reader) -> tuple[int, bytes, bytes]:
    head = await reader.readuntil(b"\r\n\r\n")
    lower = head.lower()
    clen = 0
    for line in lower.split(b"\r\n"):
        if line.startswith(b"content-length"):
            clen = int(line.split(b":", 1)[1])
    body = await reader.readexactly(clen)
    return int(head.split(b" ", 2)[1]), lower, body


class Record:
    """Per request: its due time, its answer and when it arrived."""

    def __init__(self, n: int):
        self.due = [0.0] * n
        self.done = [None] * n
        self.status = [None] * n
        self.head = [None] * n
        self.body = [None] * n

    def keep(self, i: int, status: int, head: bytes, body: bytes) -> None:
        self.done[i] = time.perf_counter()
        self.status[i], self.head[i], self.body[i] = status, head, body


def _schedule(timers) -> None:
    loop = asyncio.get_running_loop()
    for delay, fn in timers or ():
        loop.call_later(delay, fn)


def open_loop(port: int, payloads: list[list[str]], arrivals, *, connections: int,
              pipeline: int, on_start=None, timers=()) -> tuple[Record, float]:
    """Offer ``payloads`` at ``arrivals`` (seconds from the start) →
    ``(record, start perf_counter)``. ``on_start()`` runs just before the
    start; each ``(delay, fn)`` of ``timers`` runs ``delay`` s after it."""
    reqs = [encode(p) for p in payloads]
    rec = Record(len(reqs))

    async def run() -> float:
        queue: asyncio.Queue = asyncio.Queue()
        conns = [await _connect(port) for _ in range(connections)]

        async def worker(reader, writer) -> None:
            while True:
                item = await queue.get()
                if item is None:
                    writer.close()
                    return
                burst = [item]
                while len(burst) < pipeline and not queue.empty():
                    nxt = queue.get_nowait()
                    if nxt is None:
                        queue.put_nowait(None)
                        break
                    burst.append(nxt)
                try:
                    writer.write(b"".join(reqs[i] for i in burst))
                    for i in burst:
                        rec.keep(i, *await _read_answer(reader))
                except (OSError, asyncio.IncompleteReadError, ValueError):
                    # the unanswered rest of the burst stays failed; reconnect
                    writer.close()
                    reader, writer = await _connect(port)

        workers = [asyncio.create_task(worker(r, w)) for r, w in conns]
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        _schedule(timers)
        for i, at in enumerate(arrivals):
            rec.due[i] = t0 + float(at)
            wait = rec.due[i] - time.perf_counter()
            if wait > 0:
                await asyncio.sleep(wait)
            queue.put_nowait(i)
        for _ in workers:
            queue.put_nowait(None)
        await asyncio.wait(workers, timeout=LATE_LIMIT_S)
        for w in workers:
            w.cancel()
        return t0

    t0 = asyncio.run(run())
    return rec, t0


def closed_loop(port: int, payloads: list[list[str]], *, clients: int, seconds: float,
                on_start=None, timers=()) -> tuple[Record, float, int]:
    """``clients`` closed-loop clients over ``payloads`` in order for
    ``seconds``, or until the payloads run out → ``(record, start
    perf_counter, requests sent)``."""
    reqs = [encode(p) for p in payloads]
    rec = Record(len(reqs))
    sent = 0

    async def run() -> float:
        nonlocal sent
        conns = [await _connect(port) for _ in range(clients)]
        end = 0.0

        async def client(reader, writer) -> None:
            nonlocal sent
            while time.perf_counter() < end and sent < len(reqs):
                i = sent
                sent += 1
                rec.due[i] = time.perf_counter()
                try:
                    writer.write(reqs[i])
                    rec.keep(i, *await _read_answer(reader))
                except (OSError, asyncio.IncompleteReadError, ValueError):
                    writer.close()
                    reader, writer = await _connect(port)
            writer.close()

        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        end = t0 + seconds
        _schedule(timers)
        tasks = [asyncio.create_task(client(r, w)) for r, w in conns]
        await asyncio.wait(tasks, timeout=seconds + LATE_LIMIT_S)
        for t in tasks:
            t.cancel()
        return t0

    t0 = asyncio.run(run())
    return rec, t0, sent
