"""Entrypoint for the online API — counterpart of
``kmlserver_tpu/serving/server.py``.

Run as ``python -m kmlserver_tpu_torch.serving.server``. Configured by the
reference's environment variables (``BASE_DIR``, ``K_BEST_TRACKS``,
``POLLING_WAIT_IN_MINUTES``, ``KMLS_PORT`` — 0 picks a free port — and the
``KMLS_BATCH_*`` / ``KMLS_SHED_*`` / ``KMLS_CACHE_*`` knobs);
``KMLS_TORCH_DEVICE`` picks the device (default ``cuda``).

Transports: the asyncio front end with the loop-native
``AsyncMicroBatcher`` by default; ``KMLS_HTTP_IMPL=threaded`` selects the
stdlib ``ThreadingHTTPServer`` with the threaded ``MicroBatcher``. Either
transport drives the app's loop-lag monitor (a drift tick on the loop, a
drift thread beside the threaded server) and forwards ``X-KMLS-Trace``.
``KMLS_GIL_SWITCH_S`` sets the interpreter's thread switch interval. Logs
``serving on <host>:<port>`` once bound.

SIGTERM drains on both transports: responses from then on carry
``Connection: close``, the listener closes first, and in-flight requests
settle for at most ``KMLS_DRAIN_SETTLE_S`` before the process exits 0.
"""

from __future__ import annotations

import logging
import signal
import sys
import threading
import time

from ..config import (
    ServingConfig,
    drain_settle_s_from_env,
    gil_switch_s_from_env,
    http_impl_from_env,
    torch_device_from_env,
)
from .app import RecommendApp, serve

log = logging.getLogger("kmlserver_tpu_torch.serving")


def serve_threaded(app: RecommendApp, port: int | None = None, ready=None) -> int:
    """The threaded transport: serve until drained, then settle; → exit
    code. ``ready(port, drain)`` is called once bound, with a thread-safe
    ``drain()`` that starts the same sequence as SIGTERM.

    Drain: (1) handlers answer with ``Connection: close`` from now on; (2)
    ``shutdown()`` stops the accept loop (off the serving thread, or it
    deadlocks); (3) ``server_close()`` closes the LISTENING socket at once;
    (4) a bounded settle polls the in-flight counter and ends as soon as it
    is zero (handler threads are daemonic and idle keep-alive connections
    can block forever, so they are not joined)."""
    server = serve(app, port)
    host, bound = server.server_address[:2]
    if app.loop_lag is not None:
        # the sleep-drift thread: host-scheduling stalls (CPU starvation, a
        # GIL convoy) show as kmls_loop_lag_ms, as loop stalls do on the
        # async transport; app.close() below stops it
        app.loop_lag.start_thread()
    log.info("serving on %s:%d (version %s, threaded, device %s)", host, bound,
             app.cfg.version, app.engine.device)

    def drain() -> None:
        log.info("SIGTERM: draining in-flight requests, then exiting")
        server.draining.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    if ready is not None:
        ready(bound, drain)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()  # listening socket closed BEFORE the settle
    if server.draining.is_set():
        settle_s = drain_settle_s_from_env()
        t_settle = time.monotonic()
        deadline = t_settle + settle_s
        # floor: a connection accepted just before shutdown may not have
        # reached the counter increment yet
        floor = t_settle + min(0.5, settle_s)
        while time.monotonic() < deadline:
            with server.active_lock:
                if server.active_requests == 0 and time.monotonic() >= floor:
                    break
            time.sleep(0.05)
        else:
            log.warning(
                "drain settle expired after %.1fs with %d requests still in "
                "flight (raise KMLS_DRAIN_SETTLE_S to match "
                "terminationGracePeriodSeconds)", settle_s, server.active_requests,
            )
    app.close()
    return 0


def main() -> int:
    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stdout,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    cfg = ServingConfig.from_env()
    switch_s = gil_switch_s_from_env()
    if switch_s is not None:
        sys.setswitchinterval(switch_s)
    use_async = http_impl_from_env() == "async"
    # defer_batcher under async: the transport installs its loop-native
    # AsyncMicroBatcher on the loop
    app = RecommendApp(cfg, device=torch_device_from_env(), defer_batcher=use_async)
    app.engine.start_polling()
    if use_async:
        import asyncio

        from .aioserver import run_async

        return asyncio.run(run_async(app, cfg.port))

    def ready(_port: int, drain) -> None:
        signal.signal(signal.SIGTERM, lambda signum, frame: drain())

    return serve_threaded(app, ready=ready)


if __name__ == "__main__":
    sys.exit(main())
