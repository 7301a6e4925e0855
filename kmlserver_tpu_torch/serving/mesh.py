"""The serve gang's transport — counterpart of ``kmlserver_tpu/serving/mesh.py``.

A gang of ``KMLS_SERVE_GANG_SIZE`` server processes (``kubernetes/
serve-gang.yaml``: an indexed StatefulSet, ordinal → rank) each holds only
its own vocab slab — rows ``[rank·slab, (rank+1)·slab)`` of the padded rule
tensors — and presents one logical replica. Every member runs a
:class:`MeshWorkerServer` that serves its slab's ``(B, k_best)`` top-k
partial (``ops/serve.shard_partial_topk``, on the member's card) to its
peers, and a :class:`MeshCoordinator` that sends a request's seed batch to
every peer, stacks the partials in rank order and lets the engine merge
them on its card (``ops/serve.merge_partial_topk``) — the two halves of the
in-process sharded lookup, so the gang answers as the replicated layout
does, bit for bit.

The wire format is the reference's, byte for byte: a ``!I`` header length,
a compact JSON header, then the raw C-order bytes of the arrays (int32 seeds
in; int32 ids then float32 confidences out) — no pickle. A frame written by
either package decodes in the other.

Failure model (the standalone branch of the reference): a dead member makes
the coordinator raise :class:`MeshShardUnavailable` naming its rank; the app
answers the popularity fallback with ``X-KMLS-Degraded:
mesh-shard-missing:<rank>`` and ``/readyz`` names
``serve_mesh_shard_missing:<rank>``. A missing rank is re-probed (the cheap
``ready`` op) at most once per interval by whatever asks first — a request
or ``/readyz`` — so a respawned member rejoins with no background thread.
A model token rides every partial: a peer serving another generation reads
as a missing shard, never as a silent merge across generations.

The reference's real-collectives gang (one JAX world over the gang) is
:class:`CollectiveGang`: one torch.distributed world, the partials
all-gathered in rounds that every member joins. The engine takes it where
the members cannot share a card (``parallel/distributed.py::
choose_gang_transport``), and the socket transport elsewhere; both answer
alike. Under the collective transport a dead, hung or leaving member ends
its peers with the resumable exit code 76 within a bound, and the
StatefulSet re-forms the gang.

Threads: ``kmls-mesh-worker`` (accept), ``kmls-mesh-conn`` (one per peer
connection), ``kmls-mesh-fetch`` (the coordinator's pool) and
``kmls-mesh-round`` (the collective gang's rounds, with its watchdog's
``kmls-rank-heartbeat`` and ``kmls-rank-monitor``); each is stopped and
joined by its owner's ``stop()`` / ``close()``.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import logging
import socket
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger("kmlserver_tpu_torch.mesh")

_LEN = struct.Struct("!I")
_MAX_FRAME = 1 << 28  # 256 MiB: no sane seed batch or partial is larger


class MeshShardUnavailable(RuntimeError):
    """A gang member's slab partial could not be obtained — the mesh is
    missing a shard, so a full-catalog answer is impossible. Carries the
    rank so /readyz and the 503 signal can name it."""

    def __init__(self, rank: int, reason: str):
        super().__init__(f"serve mesh shard {rank} unavailable: {reason}")
        self.rank = rank
        self.reason = reason


@dataclass(frozen=True)
class GangConfig:
    """One gang member's identity + addressing.

    ``coordinator`` is rank 0's partial-fetch address (``host:port``).
    Peer addressing derives from it: a hostname carrying the ``-0``
    ordinal (the headless-Service pod DNS recipe —
    ``serve-gang-0.serve-mesh:8477``) maps rank r to the ``-r`` name on
    the SAME port; a bare host (the CPU simulation's ``127.0.0.1``)
    maps rank r to port ``base_port + r`` on the same host."""

    coordinator: str
    size: int
    rank: int

    def peer_address(self, rank: int) -> tuple[str, int]:
        host, _, port_s = self.coordinator.rpartition(":")
        if not host or not port_s.isdigit():
            raise ValueError(
                f"serve gang coordinator must be host:port, got "
                f"{self.coordinator!r}"
            )
        port = int(port_s)
        if "-0." in host:
            return host.replace("-0.", f"-{rank}.", 1), port
        if host.endswith("-0"):
            return f"{host[:-2]}-{rank}", port
        return host, port + rank

    @property
    def my_address(self) -> tuple[str, int]:
        return self.peer_address(self.rank)


def gang_from_config(cfg) -> GangConfig | None:
    """→ this process's :class:`GangConfig`, or None when no gang is
    armed. Same fail-fast contract as the mining bootstrap: a rank
    outside the declared size is a boot-time config error, never a
    hang (parallel/distributed.py:distributed_env)."""
    size = int(getattr(cfg, "serve_gang_size", 1) or 1)
    coordinator = getattr(cfg, "serve_gang_coordinator", "") or ""
    if size <= 1 or not coordinator:
        return None
    rank = int(getattr(cfg, "serve_gang_rank", 0) or 0)
    if rank >= size:
        raise ValueError(
            f"serve gang rank {rank} >= gang size {size}: set "
            "KMLS_SERVE_GANG_SIZE to the StatefulSet's replica count"
        )
    return GangConfig(coordinator=coordinator, size=size, rank=rank)


# ---------------------------------------------------------------------------
# wire protocol: !I header length + JSON header + raw payload bytes.
# Arrays travel as C-order bytes with shape/dtype in the header — no
# pickle anywhere (an artifact server must never eval peer bytes).
# ---------------------------------------------------------------------------


def _send_frame(sock: socket.socket, header: dict, payload: bytes = b""):
    head = json.dumps(header, separators=(",", ":")).encode()
    sock.sendall(_LEN.pack(len(head)) + head + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> tuple[dict, bytes]:
    (head_len,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if head_len > _MAX_FRAME:
        raise ConnectionError(f"oversized header ({head_len} bytes)")
    header = json.loads(_recv_exact(sock, head_len))
    n = int(header.get("payload_bytes", 0))
    if not 0 <= n <= _MAX_FRAME:
        raise ConnectionError(f"oversized payload ({n} bytes)")
    return header, _recv_exact(sock, n) if n else b""


class MeshWorkerServer:
    """Every gang member's partial-protocol endpoint: serves this slab's
    (B, k_best) top-k partials to whichever member coordinates a
    request (the design is symmetric — any member can front the gang;
    under the k8s recipe the ring lists the gang Service, so traffic
    lands on whichever pod DNS round-robins to).

    ``serve_partial(seeds) -> (ids, confs, token)`` and
    ``status() -> dict`` come from the engine; this class owns only the
    sockets. Threads are daemonic and connections persistent (one
    framed request/response at a time per connection — the coordinator
    serializes per-peer calls)."""

    def __init__(self, serve_partial, status, host: str = "", port: int = 0):
        self._serve_partial = serve_partial
        self._status = status
        # short bind-retry: a re-forming gang member reuses its rank's
        # port, and the dead incarnation's sockets may still be mid-FIN
        # (SO_REUSEADDR — create_server sets it — already covers the
        # TIME_WAIT case; the retry covers the close race)
        deadline = time.monotonic() + 5.0
        while True:
            try:
                self._sock = socket.create_server((host or "0.0.0.0", port))
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.1)
        self.port = self._sock.getsockname()[1]
        # partial frames shed because their deadline budget was already
        # spent when they arrived (wasted-work, not slow-compute)
        self.expired_on_arrival = 0
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, name="kmls-mesh-worker", daemon=True
        )
        # the open peer connections and their threads, closed and joined
        # by stop()
        self._conns: dict[socket.socket, threading.Thread] = {}
        self._conns_lock = threading.Lock()

    def start(self) -> "MeshWorkerServer":
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Close the listening socket and every peer connection (the peers
        read the close as this shard going missing, as they would a killed
        process), then join the threads."""
        self._stopped.set()
        with self._conns_lock:
            socks = [self._sock, *self._conns]
            threads = [self._thread, *self._conns.values()]
        for sock in socks:
            try:
                # shutdown BEFORE close: close alone only drops the fd — a
                # thread blocked in accept or recv keeps the kernel socket
                # (and the port) alive; shutdown aborts the call
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        for thread in threads:
            if thread.is_alive() and thread is not threading.current_thread():
                thread.join(max(deadline - time.monotonic(), 0.0))

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listening socket closed
            thread = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="kmls-mesh-conn", daemon=True,
            )
            with self._conns_lock:
                if self._stopped.is_set():
                    conn.close()
                    return
                self._conns[conn] = thread
            thread.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            self._serve_frames(conn)
        finally:
            with self._conns_lock:
                self._conns.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass

    def _serve_frames(self, conn: socket.socket) -> None:
        with conn:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stopped.is_set():
                try:
                    header, payload = _recv_frame(conn)
                except (ConnectionError, OSError, ValueError):
                    return
                if self._stopped.is_set():
                    # stop() landed while blocked in recv: drop the
                    # request unanswered — the peer reads the close as
                    # this shard going missing (the test/chaos stand-in
                    # for a SIGKILLed pod, where every socket dies)
                    return
                try:
                    self._handle(conn, header, payload)
                except (BrokenPipeError, ConnectionError, OSError):
                    return

    def _handle(self, conn, header: dict, payload: bytes) -> None:
        op = header.get("op")
        if op == "ready":
            _send_frame(conn, {"ok": True, **self._status()})
            return
        if op != "partial":
            _send_frame(conn, {"ok": False, "error": f"unknown op {op!r}"})
            return
        budget = header.get("budget_ms")
        if budget is not None and float(budget) <= 0.0:
            # deadline propagation: the request's remaining
            # budget died in transit — shed instead of computing a
            # partial nobody will wait for. The counter distinguishes
            # wasted-work (expired on ARRIVAL) from slow-compute.
            self.expired_on_arrival += 1
            _send_frame(conn, {"ok": False, "error": "deadline-expired"})
            return
        try:
            b, length = (int(x) for x in header["shape"])
            seeds = np.frombuffer(payload, dtype=np.int32).reshape(b, length)
            ids, confs, token = self._serve_partial(seeds)
        except Exception as exc:  # surfaced to the coordinator, not eaten
            logger.warning("mesh partial failed: %s", exc)
            _send_frame(conn, {"ok": False, "error": str(exc)})
            return
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        confs = np.ascontiguousarray(confs, dtype=np.float32)
        body = ids.tobytes() + confs.tobytes()
        _send_frame(conn, {
            "ok": True, "token": token, "shape": list(ids.shape),
            "payload_bytes": len(body),
        }, body)


class MeshPeerClient:
    """One persistent connection to one gang member's worker endpoint.
    Any transport fault — refused connect, timeout, mid-frame close, a
    peer-side error, a model-token mismatch — closes the socket and
    raises :class:`MeshShardUnavailable` for that rank."""

    def __init__(
        self, rank: int, address: tuple[str, int],
        connect_timeout_s: float = 2.0, request_timeout_s: float = 30.0,
    ):
        self.rank = rank
        self.address = address
        self.connect_timeout_s = connect_timeout_s
        self.request_timeout_s = request_timeout_s
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def abort(self) -> None:
        """Shut the connection down without waiting for a request in
        flight (which then fails as a missing shard)."""
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _request(self, header: dict, payload: bytes) -> tuple[dict, bytes]:
        with self._lock:
            try:
                if self._sock is None:
                    self._sock = socket.create_connection(
                        self.address, timeout=self.connect_timeout_s
                    )
                    self._sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                self._sock.settimeout(self.request_timeout_s)
                _send_frame(self._sock, header, payload)
                resp, body = _recv_frame(self._sock)
            except (OSError, ConnectionError, ValueError) as exc:
                self._close_locked()
                raise MeshShardUnavailable(
                    self.rank, f"{type(exc).__name__}: {exc}"
                ) from exc
        if not resp.get("ok"):
            raise MeshShardUnavailable(
                self.rank, str(resp.get("error", "peer error"))
            )
        return resp, body

    def partial(
        self, seeds: np.ndarray, token: str,
        budget_ms: float | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """→ this peer slab's (B, k_best) partial for ``seeds``. The
        model token travels both ways: a peer serving a DIFFERENT
        publication (mid-rollout generation skew) must read as a
        missing shard — merging partials across epochs would be silent
        corruption, a degraded answer is a clean one.
        ``budget_ms`` rides the frame header (deadline propagation): a
        worker receiving an already-expired budget sheds the partial
        instead of computing it."""
        seeds = np.ascontiguousarray(seeds, dtype=np.int32)
        header = {
            "op": "partial", "token": token,
            "shape": list(seeds.shape), "payload_bytes": seeds.nbytes,
        }
        if budget_ms is not None:
            header["budget_ms"] = round(float(budget_ms), 3)
        resp, body = self._request(header, seeds.tobytes())
        if resp.get("token") != token:
            raise MeshShardUnavailable(
                self.rank,
                f"model token mismatch (peer {resp.get('token')!r})",
            )
        b, k = (int(x) for x in resp["shape"])
        n = b * k * 4
        if len(body) != 2 * n:
            raise MeshShardUnavailable(
                self.rank, f"short partial payload ({len(body)} bytes)"
            )
        ids = np.frombuffer(body[:n], dtype=np.int32).reshape(b, k)
        confs = np.frombuffer(body[n:], dtype=np.float32).reshape(b, k)
        return ids, confs

    def ready(self) -> dict:
        resp, _ = self._request({"op": "ready"}, b"")
        return resp


class MeshCoordinator:
    """The request-side fan-out/merge state for one gang member:
    persistent peer clients, a small fetch pool, and the missing-shard
    health record that /readyz, the gauge, and the request short-circuit
    read.

    Recovery needs no background thread: a missing rank is re-probed
    (cheap ``ready`` op) at most every ``probe_min_interval_s``, from
    whatever touches the state first — a request arriving while the
    gang is degraded, or a periodic /readyz — so a re-formed gang is found
    within one probe interval."""

    def __init__(
        self, gang: GangConfig, *,
        connect_timeout_s: float = 2.0, request_timeout_s: float = 30.0,
        probe_min_interval_s: float = 1.0, clock=time.monotonic,
        hedge: bool = False, hedge_delay_ms: float = 30.0,
        hedge_max_frac: float = 0.05, peer_slow_ratio: float = 0.0,
    ):
        self.gang = gang
        self.request_timeout_s = request_timeout_s
        self.clients = {
            r: MeshPeerClient(
                r, gang.peer_address(r),
                connect_timeout_s=connect_timeout_s,
                request_timeout_s=request_timeout_s,
            )
            for r in range(gang.size) if r != gang.rank
        }
        self._missing: dict[int, str] = {}
        self._lock = threading.Lock()
        self._clock = clock
        self._probe_min_interval_s = probe_min_interval_s
        self._next_probe_at = 0.0
        # the straggler bound: per-rank latency tracking feeds
        # an adaptive straggler bound — when ``hedge`` is on, a rank
        # that hasn't answered within ~its own p95 (floored at
        # hedge_delay_ms) is DROPPED from the merge under the
        # deadline-degrade contract (no slab replica exists to re-issue
        # to in the simulation transport), budget-capped by a token
        # bucket so degrade amplification is structurally bounded.
        # hedge=False allocates no decisions: the counters stay 0.
        self.hedge = bool(hedge)
        self.hedge_delay_ms = hedge_delay_ms
        self.hedge_max_frac = hedge_max_frac
        self._hedge_cap = max(1.0, 16.0 * hedge_max_frac)
        self._hedge_tokens = self._hedge_cap
        self._rank_recent: dict[int, deque] = {
            r: deque(maxlen=64) for r in self.clients
        }
        self.hedge_wins = 0        # straggler dropped, merged without it
        self.hedge_losses = 0      # straggler finished in the grace check
        self.hedge_cancelled = 0   # budget exhausted → plain full wait
        # slow-outlier ladder (the reference fleet router's, mesh-side): a
        # rank whose EWMA latency exceeds peer_slow_ratio × the healthy
        # median is marked SLOW — its straggler bound collapses to the
        # floor (hedge immediately, don't re-learn its p95 every
        # request) until its EWMA, fed by the grace-landing and
        # full-wait samples that double as probes, recovers under the
        # same ratio. 0.0 (the default) disables the ladder entirely.
        self.peer_slow_ratio = max(0.0, peer_slow_ratio)
        self._rank_ewma: dict[int, float] = {}
        self._rank_slow: set[int] = set()
        self.slow_ejections = 0
        self.slow_readmissions = 0
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, gang.size - 1),
            thread_name_prefix="kmls-mesh-fetch",
        )

    def close(self) -> None:
        """Abort the peer connections (a fetch blocked in recv returns at
        once), then join the fetch pool."""
        for client in self.clients.values():
            client.abort()
        self._pool.shutdown(wait=True, cancel_futures=True)
        for client in self.clients.values():
            client.close()

    # -- health record ----------------------------------------------------

    def _note_missing(self, rank: int, reason: str) -> None:
        with self._lock:
            fresh = rank not in self._missing
            self._missing[rank] = reason
        if fresh:
            logger.warning("serve mesh shard %d missing: %s", rank, reason)

    def _note_serving(self, rank: int) -> None:
        with self._lock:
            back = self._missing.pop(rank, None) is not None
        if back:
            logger.info("serve mesh shard %d re-formed", rank)

    def missing_shards(self, probe: bool = False) -> list[int]:
        """Currently-missing ranks (sorted). ``probe=True`` re-auditions
        them first (rate-limited), so a re-formed gang recovers from
        the readyz/request path without waiting for traffic to fail."""
        with self._lock:
            missing = sorted(self._missing)
        if not (probe and missing):
            return missing
        now = self._clock()
        with self._lock:
            if now < self._next_probe_at:
                return missing
            self._next_probe_at = now + self._probe_min_interval_s
        for rank in missing:
            try:
                self.clients[rank].ready()
            except MeshShardUnavailable as exc:
                self._note_missing(rank, exc.reason)
            else:
                self._note_serving(rank)
        with self._lock:
            return sorted(self._missing)

    # -- the request fan-out ----------------------------------------------

    def _rank_straggler_bound_s(self, rank: int) -> float:
        """Per-rank adaptive straggler bound: ~p95 of its recent fetch
        latencies, floored at ``hedge_delay_ms`` (a cold coordinator
        must not drop ranks on noise)."""
        floor = self.hedge_delay_ms / 1e3
        with self._lock:
            if rank in self._rank_slow:
                # a slow-marked rank hedges at the floor: its own p95 IS
                # the stall being routed around
                return floor
            recent = self._rank_recent.get(rank)
            if not recent or len(recent) < 8:
                return floor
            ordered = sorted(recent)
            q = ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]
        return max(floor, q)

    def _mark_rank_latency(self, rank: int, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        with self._lock:
            recent = self._rank_recent.get(rank)
            if recent is None:
                return
            recent.append(seconds)
            prev = self._rank_ewma.get(rank)
            ewma = seconds if prev is None else 0.2 * seconds + 0.8 * prev
            self._rank_ewma[rank] = ewma
            if self.peer_slow_ratio <= 0.0 or len(recent) < 8:
                return
            peers = [
                e for r, e in self._rank_ewma.items()
                if r != rank and len(self._rank_recent[r]) >= 8
                and r not in self._rank_slow
            ]
            if not peers:
                return
            peers.sort()
            median = peers[len(peers) // 2]
            bound = self.peer_slow_ratio * median
            if rank not in self._rank_slow and ewma > bound:
                self._rank_slow.add(rank)
                self.slow_ejections += 1
            elif rank in self._rank_slow and ewma <= bound:
                self._rank_slow.discard(rank)
                self.slow_readmissions += 1

    def slow_ranks(self) -> list[int]:
        """Ranks the slow-outlier ladder currently marks slow (sorted;
        empty with KMLS_PEER_SLOW_RATIO=0)."""
        with self._lock:
            return sorted(self._rank_slow)

    def fetch_partials(
        self, seeds: np.ndarray, token: str,
        budget_ms: float | None = None,
    ):
        """Submit every peer's partial fetch NOW (concurrent with the
        local slab's device dispatch); the returned ``finish()`` blocks
        and yields ``{rank: (ids, confs)}`` or raises
        :class:`MeshShardUnavailable` for the first dead rank. The
        seeds array is serialized up front — the engine's staging
        buffer may be reused by the next batch before the pool thread
        runs.

        ``budget_ms`` (deadline propagation) rides each partial frame so
        a backed-up worker sheds expired work instead of computing it; a
        shed rank lands in ``finish.dropped`` whether or not hedging is
        armed — the merge degrades, the shard is never blamed missing.

        With ``hedge`` armed, a rank that hasn't answered within its
        adaptive straggler bound is dropped from the merge (one token
        from the hedge budget): ``finish.dropped`` lists the dropped
        ranks — the engine merges without them and marks the answers
        degraded — and ``finish.hedge_outcome`` carries
        ``won``/``lost``/``cancelled`` for the trace span. A dropped
        rank is NOT blamed as missing: it is alive, just late."""
        payload = np.ascontiguousarray(seeds, dtype=np.int32).copy()
        if self.hedge:
            # the bucket EARNS hedge_max_frac per dispatch (the replay
            # client's accounting, coordinator-side): straggler drops
            # are bounded at ~hedge_max_frac of traffic, not a one-time
            # allowance that exhausts for the process lifetime
            with self._lock:
                self._hedge_tokens = min(
                    self._hedge_tokens + self.hedge_max_frac,
                    self._hedge_cap,
                )
        t_submit = time.monotonic()
        futures = {
            rank: self._pool.submit(
                client.partial, payload, token, budget_ms
            )
            for rank, client in self.clients.items()
        }

        def finish() -> dict[int, tuple[np.ndarray, np.ndarray]]:
            out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
            failed: MeshShardUnavailable | None = None
            for rank, future in sorted(futures.items()):
                timeout = self.request_timeout_s + 5.0
                if self.hedge:
                    bound = self._rank_straggler_bound_s(rank)
                    remaining = (t_submit + bound) - time.monotonic()
                    try:
                        out[rank] = future.result(
                            timeout=max(0.0, remaining)
                        )
                        self._mark_rank_latency(
                            rank, time.monotonic() - t_submit
                        )
                        self._note_serving(rank)
                        continue

                    except FutureTimeoutError:
                        with self._lock:
                            has_token = self._hedge_tokens >= 1.0
                            if has_token:
                                self._hedge_tokens -= 1.0
                        if has_token:
                            # the "re-issue" equivalent when no slab
                            # replica exists: one short grace (the cost
                            # a hedge copy would have paid), then merge
                            # WITHOUT the straggler — it is alive, just
                            # late, so degrade, don't blame
                            grace = min(
                                0.25 * max(bound, 1e-3), 0.025
                            )
                            try:
                                out[rank] = future.result(timeout=grace)
                            except FutureTimeoutError:
                                finish.dropped.append(rank)
                                self.hedge_wins += 1
                                finish.hedge_outcome = "won"
                                continue
                            except MeshShardUnavailable as exc:
                                if exc.reason == "deadline-expired":
                                    finish.dropped.append(rank)
                                    continue
                                self._note_missing(rank, exc.reason)
                                failed = failed or exc
                                continue
                            # the straggler slipped in under the grace:
                            # its answer is used, the token refunded
                            with self._lock:
                                self._hedge_tokens = min(
                                    self._hedge_tokens + 1.0,
                                    self._hedge_cap,
                                )
                            self.hedge_losses += 1
                            finish.hedge_outcome = "lost"
                            self._mark_rank_latency(
                                rank, time.monotonic() - t_submit
                            )
                            self._note_serving(rank)
                            continue
                        # budget exhausted: plain waiting, the
                        # pre-hedge behavior exactly
                        self.hedge_cancelled += 1
                        finish.hedge_outcome = "cancelled"
                    except MeshShardUnavailable as exc:
                        if exc.reason == "deadline-expired":
                            # the worker shed expired work — that is
                            # deadline propagation doing its job, not a
                            # sick shard
                            finish.dropped.append(rank)
                            continue
                        self._note_missing(rank, exc.reason)
                        failed = failed or exc
                        continue
                    except Exception as exc:
                        wrapped = MeshShardUnavailable(
                            rank, f"{type(exc).__name__}: {exc}"
                        )
                        self._note_missing(rank, wrapped.reason)
                        failed = failed or wrapped
                        continue
                try:
                    out[rank] = future.result(timeout=timeout)
                    if self.hedge:
                        # the cancelled fall-through: the straggler was
                        # waited out plain-style (budget exhausted)
                        self._mark_rank_latency(
                            rank, time.monotonic() - t_submit
                        )
                    self._note_serving(rank)
                except MeshShardUnavailable as exc:
                    if exc.reason == "deadline-expired":
                        # the worker shed expired work — deadline
                        # propagation doing its job whether or not
                        # hedging is armed: degrade, don't blame a
                        # live shard (and don't fail the batch)
                        finish.dropped.append(rank)
                        continue
                    self._note_missing(rank, exc.reason)
                    failed = failed or exc
                except Exception as exc:  # pool/timeout faults
                    wrapped = MeshShardUnavailable(
                        rank, f"{type(exc).__name__}: {exc}"
                    )
                    self._note_missing(rank, wrapped.reason)
                    failed = failed or wrapped
            if failed is not None:
                raise failed
            return out

        finish.dropped = []
        finish.hedge_outcome = None
        return finish


# ---------------------------------------------------------------------------
# the collective transport: one torch.distributed world over the gang
# ---------------------------------------------------------------------------

# an idle gang parks after a round with rows nowhere, each round thread
# blocked on the park's key in the world's store; a parked member's
# kmls-mesh-wake thread sets the key at once when a batch reaches it, and
# looks this often for a publication the others must hear of
PARK_RECHECK_S = 0.1
# a parked round thread's wait on the store, renewed when it runs out
PARK_WAIT_S = 600.0
# per-stage round times kept for stats() (the newest)
ROUND_STATS_KEPT = 1 << 16


def token_digest(token: str) -> int:
    """A model token as a round header's fixed-width field: the first 8
    bytes of its blake2b as a signed int64, never 0 (0 = no slab)."""
    digest = int.from_bytes(
        hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest(), "big", signed=True
    )
    return digest or 1


class _Batch:
    """One batch handed to the round thread, and what its round gave."""

    __slots__ = ("seeds", "digest", "done", "parts", "error")

    def __init__(self, seeds: np.ndarray, digest: int):
        self.seeds = seeds
        self.digest = digest
        self.done = threading.Event()
        self.parts: dict[int, tuple[np.ndarray, np.ndarray]] | None = None
        self.error: MeshShardUnavailable | None = None


class CollectiveGang:
    """The gang's collective transport — the reference's real-collectives
    branch (``kmlserver_tpu/serving/engine.py:894-905`` over X9's
    ``shard_map`` program, ``kmlserver_tpu/ops/serve.py:126-249``) run in
    rounds that every member joins, on the torch.distributed world of
    ``parallel/distributed.py::maybe_initialize_serve_gang``.

    The engine calls it as it calls :class:`MeshCoordinator`:
    ``fetch_partials(seeds, token) -> finish()``, ``missing_shards()`` and
    ``close()``. A ``kmls-mesh-round`` thread runs the rounds:

    1. every member's header is all-gathered (its batch's rows and bucket
       length, 0 rows when it has none; its slab's token digest; whether
       it is leaving) — a round with no rows anywhere ends here, and the
       gang parks: each round thread blocks on the park's key in the world's
       store until a member with a batch (or leaving, or a new publication)
       sets it from its ``kmls-mesh-wake`` thread, so an idle gang runs no
       collective and spins no core;
    2. the batches' seeds are all-gathered (padded to the round's largest);
    3. each member computes its slab's partial (``slab.partial``, X9's
       ``shard_partial_topk`` on its card) for every other member's batch
       at that batch's own bucket, padded to the round's largest batch;
    4. the ``(S, B, k_best)`` ids and confidences (one int32 tensor) are
       all-gathered in rank order over the runtime's collective group, and
       each member takes the rows of its own batch; the engine merges them
       with its own partial on its card (``merge_partial_topk``).

    A member whose slab's token digest differs from a batch's is a
    missing shard for that batch: ``finish()`` raises
    :class:`MeshShardUnavailable` naming it, as the socket transport does
    for a peer on another generation. A leaving member (``close()``) says
    so in its last header, and its peers end at once. A dead or hung peer
    is caught by a :class:`~..parallel.distributed.RankWatchdog` (peer
    heartbeats on the PVC, each round's collectives guarded, both bounded
    by ``heartbeat_timeout_s``), which ends this member with the resumable
    exit code 76, as does a collective that raises; no ``finish()`` waits
    past ``2 · heartbeat_timeout_s + 5`` seconds.

    ``slab()`` → None before the first mesh publication, else an object
    with ``token`` and ``partial(seeds) -> (ids, confs)`` (device tensors
    of ``(rows, k_best)``)."""

    def __init__(
        self, gang: GangConfig, *, slab, k_best: int, device, heartbeat_dir: str,
        heartbeat_timeout_s: float, on_abort=None,
    ):
        from ..parallel.distributed import RankWatchdog

        self.gang = gang
        self._slab = slab
        self.k_best = int(k_best)
        self.device = device
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.finish_bound_s = 2 * self.heartbeat_timeout_s + 5.0
        self.watchdog = RankWatchdog(
            heartbeat_dir, gang.rank, gang.size,
            heartbeat_interval_s=min(5.0, self.heartbeat_timeout_s / 5),
            timeout_s=self.heartbeat_timeout_s,
            collective_timeout_s=self.heartbeat_timeout_s, on_abort=on_abort,
        )
        self._queue: deque[_Batch] = deque()
        self._missing: list[int] = []
        self._formed = False
        self._closed = False
        self._park_key: str | None = None
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._leaving = threading.Event()
        self._stopped = threading.Event()
        # counted by the round thread alone
        self.rounds = 0
        self.empty_rounds = 0
        self.parks = 0
        self._sent_digest = 0
        self.bytes_received = 0
        self.stage_ms = {
            name: deque(maxlen=ROUND_STATS_KEPT)
            for name in ("header", "seeds", "partials", "gather")
        }
        self._thread = threading.Thread(target=self._run, name="kmls-mesh-round", daemon=True)
        self._waker = threading.Thread(target=self._wake_loop, name="kmls-mesh-wake", daemon=True)
        self._store = self._wake_store = None

    def start(self) -> "CollectiveGang":
        from torch.distributed import distributed_c10d

        # the world's store: the round thread parks on it, the waker (on a
        # client of its own: a waiting client serves nothing else) sets keys
        self._store = distributed_c10d._get_default_store()
        self._wake_store = self._store.clone()
        self.watchdog.start()
        self._thread.start()
        self._waker.start()
        return self

    def close(self) -> None:
        """Leave the gang: the next round's header says so (its peers end
        at once), the round thread ends after it, and the world is left.
        A batch not served by then raises out of its ``finish()``."""
        if self._thread.is_alive():
            self._leaving.set()
            self._wake.set()
            self._thread.join(self.finish_bound_s)
        left = not self._thread.is_alive()
        self._stopped.set()
        self._wake.set()
        if self._waker.is_alive():
            self._waker.join(self.finish_bound_s)
        self.watchdog.stop()
        self._fail_queued("the collective gang is closed")
        if left:
            from ..parallel import distributed

            distributed.shutdown()

    # -- the engine's side ------------------------------------------------

    def missing_shards(self, probe: bool = False) -> list[int]:
        """Ranks whose slab serves another generation than this member's,
        as the last round's headers said (no probe: every round refreshes
        it)."""
        with self._lock:
            return list(self._missing)

    @property
    def formed(self) -> bool:
        """The last round's headers all carried this member's published
        slab's digest: the gang serves one generation."""
        with self._lock:
            return self._formed

    def fetch_partials(self, seeds: np.ndarray, token: str, budget_ms: float | None = None):
        """Hand a copy of the batch's seeds to the round thread (never
        blocks) → ``finish()``, which waits for the batch's round and
        yields ``{rank: (ids, confs)}`` for every other member, or raises
        :class:`MeshShardUnavailable`. ``budget_ms`` is not used: a round
        serves every batch it carries."""
        batch = _Batch(np.array(seeds, dtype=np.int32, copy=True), token_digest(token))
        with self._lock:
            closed = self._closed
            if not closed:
                self._queue.append(batch)
        if closed:
            self._settle(batch, error=MeshShardUnavailable(
                self._blame(), "the collective gang is closed"))
        self._wake.set()
        bound = self.finish_bound_s

        def finish() -> dict[int, tuple[np.ndarray, np.ndarray]]:
            if not batch.done.wait(bound):
                raise MeshShardUnavailable(
                    self._blame(), f"no gang round answered within {bound:.0f} s")
            if batch.error is not None:
                raise batch.error
            return batch.parts

        finish.dropped = []
        finish.hedge_outcome = None
        return finish

    def stats(self) -> dict:
        """Rounds, empty rounds, bytes this member's gathers received (in
        all, and a round with rows on average), and each stage's p50 / p99
        ms over the kept rounds that did work."""
        work = self.rounds - self.empty_rounds
        header_bytes = 32 * self.gang.size  # four int64 fields a member
        out = {"rounds": self.rounds, "empty_rounds": self.empty_rounds, "parks": self.parks,
               "bytes_received": self.bytes_received,
               "bytes_per_work_round": (
                   (self.bytes_received - header_bytes * self.empty_rounds) / work if work else 0.0)}
        for name, kept in self.stage_ms.items():
            values = np.asarray(kept.copy(), dtype=np.float64)  # one C call: no torn read
            out[f"{name}_ms"] = (
                {"p50": float(np.percentile(values, 50)), "p99": float(np.percentile(values, 99)),
                 "n": int(values.size)} if values.size else None
            )
        return out

    # -- the round thread -------------------------------------------------

    @staticmethod
    def _settle(batch: _Batch, parts=None, error=None) -> None:
        batch.parts, batch.error = parts, error
        batch.done.set()

    def _blame(self) -> int:
        """The rank a batch names when the gang itself failed or closed
        (the member ends at once, so no shard is known missing): the first
        peer."""
        return 1 if self.gang.rank == 0 else 0

    def _fail_queued(self, reason: str) -> None:
        with self._lock:
            self._closed = True
            queued = list(self._queue)
            self._queue.clear()
        for batch in queued:
            self._settle(batch, error=MeshShardUnavailable(self._blame(), reason))

    def _take(self) -> _Batch | None:
        with self._lock:
            return self._queue.popleft() if self._queue else None

    def _digest(self) -> int:
        slab = self._slab()
        return token_digest(slab.token) if slab is not None else 0

    def _has_work(self) -> bool:
        """A batch queued, leaving, or a slab published since the last
        header (its peers must learn the new digest)."""
        with self._lock:
            queued = bool(self._queue)
        return queued or self._leaving.is_set() or self._digest() != self._sent_digest

    def _park(self) -> str:
        """Block, with no collective, until some member sets this park's
        key; this member's waker sets it once a batch reaches it, it is
        leaving or it has published a slab. Every member parks after the
        same rounds, so the keys agree. → the key."""
        from torch.distributed import DistStoreError

        key = f"kmls-serve-gang/wake/{self.parks}"
        self.parks += 1
        with self._lock:
            self._park_key = key
        try:
            if self._has_work():  # before the key was visible to the waker
                self._store.set(key, b"1")
                return key
            while True:
                t0 = time.monotonic()
                try:
                    self._store.wait([key], datetime.timedelta(seconds=PARK_WAIT_S))
                    return key
                except DistStoreError:
                    if time.monotonic() - t0 < 0.9 * PARK_WAIT_S:
                        raise  # the store failed, not the wait
        finally:
            with self._lock:
                self._park_key = None

    def _wake_loop(self) -> None:
        """Set the parked round's key when this member has work."""
        while not self._stopped.is_set():
            self._wake.wait(PARK_RECHECK_S)
            self._wake.clear()
            with self._lock:
                key = self._park_key
            if key is not None and self._has_work():
                try:
                    self._wake_store.set(key, b"1")
                except Exception:  # the round thread sees the store fail too
                    logger.exception("serve gang wake failed")
                    return

    def _run(self) -> None:
        batch = None
        park = False
        try:
            while True:
                woke = self._park() if park else None
                leaving = self._leaving.is_set()
                batch = self._take()
                heads, worked = self._round(batch, leaving)
                batch = None
                if woke is not None and self.gang.rank == 0:
                    self._store.delete_key(woke)  # every member is past it
                leavers = [r for r in range(self.gang.size)
                           if heads[r, 3] and r != self.gang.rank]
                if leaving:
                    return
                if leavers:
                    self._fail_queued(f"serve gang rank {leavers[0]} left")
                    self.watchdog.abort(
                        f"serve gang rank {leavers[0]} left the gang (closed); the gang "
                        "re-forms when every member restarts")
                    return
                park = not worked
        except Exception as exc:
            reason = f"serve gang round failed: {type(exc).__name__}: {exc}"
            if batch is not None:
                self._settle(batch, error=MeshShardUnavailable(self._blame(), reason))
            self._fail_queued(reason)
            self.watchdog.abort(reason)
        finally:
            self._stopped.set()
            self._wake.set()

    def _round(self, batch: _Batch | None, leaving: bool) -> tuple[np.ndarray, bool]:
        """One round (every member runs the same collectives, decided by
        the gathered headers) → (the headers, whether any member had rows)."""
        import torch

        from ..parallel import collectives, distributed
        from ..parallel.mesh import Axis

        size, me = self.gang.size, self.gang.rank
        slab = self._slab()
        digest = self._sent_digest = token_digest(slab.token) if slab is not None else 0
        rows, length = batch.seeds.shape if batch is not None else (0, 0)
        world = Axis(tuple(range(size)))  # the gloo world group: host tensors
        with self.watchdog.guard("serve gang round"):
            t0 = time.perf_counter()
            # batch rows, bucket length, the slab's token digest, leaving
            header = torch.tensor([[rows, length, digest, int(leaving)]], dtype=torch.int64)
            heads = collectives.all_gather_cat(header, world).numpy()  # (S, 4)
            t1 = time.perf_counter()
            with self._lock:
                self._missing = [r for r in range(size)
                                 if r != me and digest and heads[r, 2] != digest]
                self._formed = bool(digest) and not self._missing
            self.rounds += 1
            self.bytes_received += heads.nbytes
            if not heads[:, 0].any():
                self.empty_rounds += 1
                return heads, False
            b_max, l_max = int(heads[:, 0].max()), int(heads[:, 1].max())
            padded = torch.full((1, b_max, l_max), -1, dtype=torch.int32)
            if batch is not None:
                padded[0, :rows, :length] = torch.from_numpy(batch.seeds)
            seeds = collectives.all_gather_cat(padded, world).numpy()  # (S, B, L)
            t2 = time.perf_counter()
            # this slab's partial for every other member's batch, ids and
            # confidences in one int32 tensor (the confidences' bits)
            out = torch.zeros((2, size, b_max, self.k_best), dtype=torch.int32, device=self.device)
            out[0] = -1
            if slab is not None:
                for m in range(size):
                    m_rows, m_len = int(heads[m, 0]), int(heads[m, 1])
                    if m == me or not m_rows:
                        continue
                    ids, confs = slab.partial(seeds[m, :m_rows, :m_len])
                    out[0, m, :m_rows] = ids
                    out[1, m, :m_rows] = confs.view(torch.int32)
            axis = Axis(tuple(range(size)), group=distributed.collective_group())
            if collectives.staged(out, axis):
                out = out.cpu()  # gloo gathers host tensors: stage it once
            elif out.is_cuda:
                torch.cuda.current_stream(out.device).synchronize()
            t3 = time.perf_counter()
            every = collectives.all_gather_cat(out.unsqueeze(0), axis)  # (S, 2, S, B, k)
            mine = every[:, :, me, :rows].contiguous().cpu()
            t4 = time.perf_counter()
        self.bytes_received += seeds.nbytes + every.numel() * 4
        for name, ms in (("header", t1 - t0), ("seeds", t2 - t1), ("partials", t3 - t2),
                         ("gather", t4 - t3)):
            self.stage_ms[name].append(1e3 * ms)
        if batch is not None:
            other = [p for p in range(size) if p != me and heads[p, 2] != batch.digest]
            if other:
                self._settle(batch, error=MeshShardUnavailable(
                    other[0], f"model token mismatch (rank {other[0]} serves another "
                              "generation)"))
            else:
                ids = mine[:, 0].numpy()
                confs = mine[:, 1].view(torch.float32).numpy()
                self._settle(batch, parts={p: (ids[p], confs[p])
                                           for p in range(size) if p != me})
        return heads, True
