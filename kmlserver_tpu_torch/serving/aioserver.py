"""Asyncio HTTP/1.1 transport for :class:`~.app.RecommendApp` — counterpart
of ``kmlserver_tpu/serving/aioserver.py``, the default serving front end
(``KMLS_HTTP_IMPL=threaded`` selects the stdlib server instead).

A single-threaded event loop holds its throughput flat as connections
grow, where thread-per-connection collapses into a GIL convoy. The
recommendation path never blocks the loop: ``app.submit_recommend`` first
consults the answer cache (a hit answers inline), then the loop-native
micro-batcher's ``submit()`` (→ an asyncio Future resolved on the loop
once the batch's finish() ran in the batcher's executor). Every other
route is sub-millisecond and runs inline.

Connections are pipelined: every complete request in the buffer is
dispatched at once, responses are staged by sequence number, and each
contiguous ready prefix leaves as ONE ``transport.write``. Reading pauses
while a connection has too many requests outstanding.

The loop-lag monitor's drift tick (``observability/runtime.py``) is armed
on the serving loop, so a stall of the loop shows as ``kmls_loop_lag_ms``
and escalates the admission ladder; the drain stops it. An armed
``fleet.peer`` fault (``KMLS_FAULT_FLEET_PEER_DELAY_MS``) is consumed here
with :func:`faults.take` and delays its request on a loop timer; the app is
then told not to fire the site again.

SIGTERM drain: the listener closes at once (racing connects are refused),
every later response carries ``Connection: close``, in-flight requests
settle for at most ``KMLS_DRAIN_SETTLE_S``, and then the connections still
open — idle keep-alive ones included — are closed, so the server's
``wait_closed()`` (which waits for every connection on Python ≥ 3.12.1)
returns instead of hanging.

Under a running profiler (``utils/profiling.span``) each request's framing
is a ``kmls:http.parse`` span (the body's JSON is the app's, under the
same name) and each recommend answer's encoding and write a
``kmls:http.respond`` span; no span crosses a loop iteration.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import socket
from concurrent.futures import ThreadPoolExecutor

from .. import faults
from ..config import drain_settle_s_from_env
from ..utils.profiling import span
from .app import RecommendApp, batcher_kwargs

logger = logging.getLogger("kmlserver_tpu_torch.serving")

_REASONS = {
    200: "OK", 307: "Temporary Redirect", 400: "Bad Request",
    403: "Forbidden", 404: "Not Found", 422: "Unprocessable Entity",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable",
}
_MAX_HEAD = 32 * 1024
_MAX_BODY = 10 * 1024 * 1024
_RECOMMEND_PATHS = ("/api/recommend/", "/api/recommend")
_ERROR_500 = (500, {"Content-Type": "application/json"}, b'{"detail": "Internal Server Error"}')

# bound on requests parsed-but-unanswered per connection
_MAX_PIPELINE = 128


class _ServerState:
    """Shared across connections: drain flag, in-flight accounting and the
    open connections (the loop is single-threaded, so plain ints are safe)."""

    def __init__(self, app: RecommendApp):
        self.app = app
        self.draining = False
        self.inflight = 0
        self.idle = asyncio.Event()
        self.idle.set()
        self.conns: set[_Conn] = set()
        self._engine_pool: ThreadPoolExecutor | None = None

    @property
    def engine_pool(self) -> ThreadPoolExecutor:
        """Small thread pool for the BATCHERLESS recommend path
        (KMLS_BATCH_WINDOW_MS=0): the engine call waits on the device and
        must not run on the loop. Lazy: the batched default never needs it."""
        if self._engine_pool is None:
            self._engine_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="kmls-aio-engine")
        return self._engine_pool

    def enter(self) -> None:
        self.inflight += 1
        self.idle.clear()

    def leave(self) -> None:
        self.inflight -= 1
        if self.inflight <= 0:
            self.idle.set()


class _Conn(asyncio.Protocol):
    """One pipelined HTTP/1.1 connection."""

    def __init__(self, state: _ServerState):
        self.state = state
        self.buf = b""
        self.transport: asyncio.Transport | None = None
        self.peer_host: str | None = None
        self.closed = False
        self._next_seq = 0    # next request sequence number to assign
        self._next_write = 0  # next sequence number to write out
        self._staged: dict[int, tuple[tuple, bool]] = {}
        self._reading_paused = False

    # ---------- transport events ----------

    def connection_made(self, transport) -> None:
        self.transport = transport
        self.loop = asyncio.get_running_loop()
        self.state.conns.add(self)
        sock = transport.get_extra_info("socket")
        if sock is not None:
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        peer = transport.get_extra_info("peername")
        self.peer_host = peer[0] if peer else None

    def connection_lost(self, exc) -> None:
        self.closed = True
        self.state.conns.discard(self)

    def data_received(self, data: bytes) -> None:
        self.buf += data
        self._process_buffer()
        self._update_read_flow()

    def _update_read_flow(self) -> None:
        """Backpressure the SOCKET, not just the parser."""
        if self.closed or self.transport is None:
            return
        backlogged = (
            self._next_seq - self._next_write >= _MAX_PIPELINE
            or len(self.buf) > _MAX_HEAD + _MAX_BODY
        )
        if backlogged != self._reading_paused:
            try:
                if backlogged:
                    self.transport.pause_reading()
                else:
                    self.transport.resume_reading()
                self._reading_paused = backlogged
            except RuntimeError:
                pass

    # ---------- request framing ----------

    def _process_buffer(self) -> None:
        while self.buf and not self.closed and self._next_seq - self._next_write < _MAX_PIPELINE:
            with span("http.parse"):
                request = self._next_request()
            if request is None:
                return
            self._dispatch(*request)

    def _next_request(self) -> tuple | None:
        """Frame the next complete request out of the buffer → the
        arguments of :meth:`_dispatch`, or None when it is incomplete or
        was answered 400."""
        end = self.buf.find(b"\r\n\r\n")
        if end < 0:
            if len(self.buf) > _MAX_HEAD:
                self._bad_request("headers too large")
            return None
        head = self.buf[:end]
        try:
            request_line, _, header_block = head.partition(b"\r\n")
            method, path, _ = request_line.decode("latin1").split(" ", 2)
        except ValueError:
            self._bad_request("malformed request line")
            return None
        content_length = 0
        close_after = False
        trace_header: str | None = None
        budget_header: str | None = None
        for line in header_block.split(b"\r\n"):
            key, _, value = line.partition(b":")
            lowered = key.strip().lower()
            if lowered == b"content-length":
                try:
                    content_length = int(value.strip())
                except ValueError:
                    self._bad_request("bad Content-Length")
                    return None
            elif lowered == b"connection":
                close_after = value.strip().lower() == b"close"
            elif lowered == b"x-kmls-trace":
                # span-trace propagation: the raw value; the recorder
                # validates it (charset, length) or replaces it
                trace_header = value.strip().decode("latin1")
            elif lowered == b"x-kmls-deadline-budget":
                # remaining budget (ms) forwarded by an upstream hop;
                # the app ignores malformed values
                budget_header = value.strip().decode("latin1")
        if content_length > _MAX_BODY:
            self._bad_request("body too large")
            return None
        total = end + 4 + content_length
        if len(self.buf) < total:
            return None  # body still arriving
        body = self.buf[end + 4: total] or None
        self.buf = self.buf[total:]
        return method, path, body, close_after, trace_header, budget_header

    def _bad_request(self, detail: str) -> None:
        seq = self._next_seq
        self._next_seq += 1
        self.buf = b""
        self._stage(
            seq,
            (400, {"Content-Type": "application/json"},
             b'{"detail": "' + detail.encode() + b'"}'),
            close_after=True,
        )

    # ---------- dispatch ----------

    def _dispatch(
        self, method: str, path: str, body: bytes | None, close_after: bool,
        trace_header: str | None, budget_header: str | None,
    ) -> None:
        state = self.state
        app = state.app
        state.enter()
        seq = self._next_seq
        self._next_seq += 1
        if method == "POST" and path.split("?", 1)[0] in _RECOMMEND_PATHS:
            # the fleet.peer chaos site, loop-native: an armed stall delays
            # THIS request on a loop timer while pipelined neighbours and
            # other connections flow on — a slow-but-alive replica, where a
            # blocking sleep would stall the whole loop
            try:
                delay = faults.take("fleet.peer", replica=app._fleet_index)
            except Exception:
                logger.exception("unhandled error for %s %s", method, path)
                app.metrics.record_error()
                self._stage(seq, _ERROR_500, close_after)
                state.leave()
                return
            if delay > 0:
                self.loop.call_later(delay, self._recommend, seq, path, body, close_after,
                                     trace_header, budget_header)
                return
            self._recommend(seq, path, body, close_after, trace_header, budget_header)
            return
        try:
            response = app.handle(method, path, body, client_host=self.peer_host)
        except Exception:
            logger.exception("unhandled error for %s %s", method, path)
            app.metrics.record_error()
            response = _ERROR_500
        self._stage(seq, response, close_after)
        state.leave()

    def _recommend(
        self, seq: int, path: str, body: bytes | None, close_after: bool,
        trace_header: str | None, budget_header: str | None,
    ) -> None:
        state = self.state
        app = state.app
        if self.closed:  # the connection dropped during a fault stall
            state.leave()
            return
        try:
            if app.batcher is None:
                # batching disabled: the engine call stays off the loop (the
                # fleet.peer site was consumed in _dispatch)
                task = state.engine_pool.submit(
                    app.handle, "POST", path, body, self.peer_host, trace_header,
                    budget_header, False,
                )
                task.add_done_callback(
                    lambda f: self.loop.call_soon_threadsafe(
                        self._finish_handled, seq, f, close_after
                    )
                )
                return
            response, future, t0, trace = app.submit_recommend(body, trace_header, budget_header)
            if response is None:
                if isinstance(future, asyncio.Future):
                    # loop-native batcher: resolved ON the loop
                    future.add_done_callback(
                        lambda f: self._finish_recommend(seq, f, t0, close_after, trace)
                    )
                else:
                    # threaded batcher: its completion thread fires the
                    # callback → hop back onto the loop
                    future.add_done_callback(
                        lambda f: self.loop.call_soon_threadsafe(
                            self._finish_recommend, seq, f, t0, close_after, trace
                        )
                    )
                return
        except Exception:
            logger.exception("unhandled error for POST %s", path)
            app.metrics.record_error()
            response = _ERROR_500
        with span("http.respond"):
            self._stage(seq, response, close_after)
        state.leave()

    def _finish_recommend(
        self, seq: int, future, t0: float, close_after: bool, trace=None,
    ) -> None:
        if not self.closed:
            with span("http.respond"):
                self._stage(seq, self.state.app.finish_recommend(future, t0, trace=trace),
                            close_after)
        self._after_answer()

    def _finish_handled(self, seq: int, task, close_after: bool) -> None:
        """Completion for the batcherless off-loop ``app.handle`` call."""
        if not self.closed:
            try:
                # kmls-verify: allow[loopblock] — this callback only runs
                # via call_soon_threadsafe AFTER the engine-pool task
                # completed, so result() returns immediately
                response = task.result()
            except Exception:
                logger.exception("engine-pool request failed")
                self.state.app.metrics.record_error()
                response = _ERROR_500
            self._stage(seq, response, close_after)
        self._after_answer()

    def _after_answer(self) -> None:
        self.state.leave()
        if not self.closed:
            self._process_buffer()  # pipeline slots freed — keep parsing
            self._update_read_flow()

    # ---------- response writing ----------

    def _stage(self, seq: int, response, close_after: bool) -> None:
        """Stage response ``seq``; flush the contiguous ready prefix as a
        single write (responses leave in request order)."""
        if self.closed or self.transport is None:
            return
        self._staged[seq] = (response, close_after)
        if seq != self._next_write:
            return
        chunks: list[bytes] = []
        closing = False
        while self._next_write in self._staged:
            response, close_after = self._staged.pop(self._next_write)
            self._next_write += 1
            closing = close_after or self.state.draining
            chunks.append(self._encode(response, closing))
            if closing:
                break
        self.transport.write(b"".join(chunks))
        if closing:
            self.close()

    def close(self) -> None:
        if not self.closed and self.transport is not None:
            self.transport.close()
        self.closed = True

    @staticmethod
    def _encode(response, closing: bool) -> bytes:
        status, headers, payload = response
        parts = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
                 f"Content-Length: {len(payload)}\r\n"]
        for key, value in headers.items():
            parts.append(f"{key}: {value}\r\n")
        if closing:
            # during a drain keep-alive clients must reconnect elsewhere
            parts.append("Connection: close\r\n")
        parts.append("\r\n")
        return "".join(parts).encode("latin1") + payload


async def run_async(app: RecommendApp, port: int, ready=None) -> int:
    """Bind + serve until SIGTERM/SIGINT (or ``drain()``), then drain; →
    exit code. ``ready(port, drain)`` is called once the socket is bound,
    with a thread-safe ``drain()`` that starts the same sequence as
    SIGTERM (tests drive the drain in process with it)."""
    loop = asyncio.get_running_loop()
    if app.batcher is None and app.cfg.batch_window_ms > 0:
        # the loop-native batcher, built where the loop exists
        from .batcher import AsyncMicroBatcher

        app.batcher = AsyncMicroBatcher(
            app.engine, **batcher_kwargs(app.cfg), metrics=app.metrics, lag_monitor=app.loop_lag,
            forecaster=app.forecaster,
        )
    if app.loop_lag is not None:
        # the drift tick: a late tick IS the time something blocked the loop
        app.loop_lag.start_on_loop(loop)
    state = _ServerState(app)
    server = await loop.create_server(lambda: _Conn(state), "0.0.0.0", port, backlog=256)
    bound_port = server.sockets[0].getsockname()[1]
    logger.info("serving on 0.0.0.0:%d (version %s, async, device %s)", bound_port,
                app.cfg.version, app.engine.device)
    stop = asyncio.Event()

    def _drain() -> None:
        logger.info("SIGTERM: draining in-flight requests, then exiting")
        state.draining = True
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, _drain)
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # not the main thread (in-process use)
    if ready is not None:
        ready(bound_port, lambda: loop.call_soon_threadsafe(_drain))

    try:
        await stop.wait()
        # the listener closes NOW: racing connects get an instant refusal
        server.close()
        settle_s = drain_settle_s_from_env()
        # floor before the zero-exit: a keep-alive client that raced the
        # signal may still be writing its request
        await asyncio.sleep(min(0.5, settle_s))
        try:
            await asyncio.wait_for(state.idle.wait(), timeout=settle_s)
        except asyncio.TimeoutError:
            logger.warning(
                "drain settle expired after %.1fs with %d requests still in "
                "flight (raise KMLS_DRAIN_SETTLE_S to match "
                "terminationGracePeriodSeconds)", settle_s, state.inflight,
            )
        # connections still open (idle keep-alive ones) would hold
        # wait_closed() forever: close them
        for conn in list(state.conns):
            conn.close()
        await server.wait_closed()
    finally:
        if app.loop_lag is not None:
            app.loop_lag.stop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.remove_signal_handler(sig)
            except (NotImplementedError, RuntimeError, ValueError):
                pass
        if state._engine_pool is not None:
            state._engine_pool.shutdown(wait=False)
        close = getattr(app.batcher, "close", None)
        if callable(close):
            close()
    return 0
