"""The REST surface — counterpart of ``kmlserver_tpu/serving/app.py``, the
reference's FastAPI routes rebuilt on the stdlib:

- ``POST /api/recommend/`` (reference: rest_api/app/main.py:176-187): body
  ``{"songs": [...]}`` → ``{"songs": [...], "model_date": <token>,
  "version": <VERSION>}``; an empty song list → 400; a malformed body →
  422 (FastAPI's validation status); a shed → 429 with ``Retry-After``; a
  deadline, overload or replica-loss degradation → 200 from the popularity
  fallback with ``X-KMLS-Degraded``; a cache hit carries ``X-KMLS-Cache``.
- ``POST /metrics/reset``: windows the latency percentiles (loopback only).
- ``GET /`` (reference: :190-203): HTML test client with a seed sample.
- ``GET /test`` (reference: :150-153): 307 redirect to the docs.
- ``GET /docs`` + ``GET /openapi.json``: the docs with the reference's
  three canned request examples (:158-174).
- ``GET /healthz`` / ``GET /readyz`` (ready / degraded / 503, with the
  artifacts' ages); ``GET /metrics``: Prometheus text; ``GET /static/``.
- ``GET /debug/traces`` (retained request traces), ``GET /debug/slo``
  (burn-rate detail) and ``GET /debug/profile?seconds=N`` (a
  ``torch.profiler`` capture into ``KMLS_PROFILE_DIR``; 409 while it is
  unset), all loopback only.

With ``KMLS_DELTA_ENABLED`` the engine applies delta bundles in place and
calls back :meth:`RecommendApp._on_delta_applied`, which invalidates the
cached answers of the touched seeds only. With ``KMLS_CACHE_AFFINITY=1``
the app counts the requests its replica would own on a rendezvous ring of
``KMLS_CACHE_AFFINITY_PEERS`` (``freshness/ring.py``).

With ``KMLS_TRACE_SAMPLE`` > 0 every request carries a trace
(``observability/trace.py``): its id comes from ``X-KMLS-Trace`` (or is
generated) and is echoed on the response, and the cache, batcher queue,
device and compose spans are recorded; tail-based retention decides what
``/debug/traces`` keeps. With tracing off (the default) no request builds
anything.

``handle()`` maps a request to ``(status, headers, body)`` independently of
the transport; ``submit_recommend`` / ``finish_recommend`` are its
non-blocking halves for the asyncio transport.
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..config import ServingConfig
from ..io.iohealth import MONITOR
from ..observability import LoopLagMonitor, SloTracker, SpanRecorder
from ..utils import profiling
from .batcher import DeadlineExceeded, NoHealthyReplicas, Overloaded, OverloadDegraded
from .cache import RecommendCache
from .engine import RecommendEngine
from .metrics import ServingMetrics

logger = logging.getLogger("kmlserver_tpu_torch.serving")

_TEMPLATE_PATH = os.path.join(os.path.dirname(__file__), "templates", "client.html")

# The reference documents three canned request examples in its OpenAPI
# metadata (rest_api/app/main.py:158-174): typical seeds, uncommon seeds,
# and seeds absent from the rules (exercising the static fallback).
CANNED_EXAMPLES = {
    "normal": {
        "summary": "Typical seed songs",
        "value": {"songs": ["Yesterday", "Bohemian Rhapsody"]},
    },
    "uncommon": {
        "summary": "Uncommon seed songs (sparse rules)",
        "value": {"songs": ["Some Deep Cut B-Side"]},
    },
    "absent": {
        "summary": "Songs absent from the rules (static fallback)",
        "value": {"songs": ["Definitely Not A Real Song 123"]},
    },
}

Response = tuple[int, dict[str, str], bytes]


def is_loopback_host(client_host: str | None) -> bool:
    """The loopback guard of ``/metrics/reset`` and ``/debug/*``. ``None``
    is a direct in-process call — inherently local. A dual-stack server
    reports IPv4 loopback in IPv6-mapped form (``::ffff:127.0.0.1``)."""
    if client_host is None:
        return True
    host = client_host.removeprefix("::ffff:")
    return host in ("127.0.0.1", "::1")


def _json_response(status: int, obj) -> Response:
    return status, {"Content-Type": "application/json"}, json.dumps(obj).encode("utf-8")


def _html_response(status: int, html: str) -> Response:
    return status, {"Content-Type": "text/html; charset=utf-8"}, html.encode("utf-8")


def _esc(s: str) -> str:
    return (
        str(s).replace("&", "&amp;").replace("<", "&lt;")
        .replace(">", "&gt;").replace('"', "&quot;").replace("'", "&#39;")
    )


class RecommendApp:
    """Transport-independent app core."""

    def __init__(
        self,
        cfg: ServingConfig,
        engine: RecommendEngine | None = None,
        device: str | torch.device = "cuda",
        *,
        defer_batcher: bool = False,
    ):
        self.cfg = cfg
        self.engine = engine if engine is not None else RecommendEngine(cfg, device)
        self.metrics = ServingMetrics()
        # requests whose forwarded X-KMLS-Deadline-Budget arrived spent
        self.deadline_expired_total = 0
        # span tracing: disabled by default (KMLS_TRACE_SAMPLE=0 → the
        # recorder is not enabled, and every call site checks that first)
        self.recorder = SpanRecorder(
            sample=cfg.trace_sample, capacity=cfg.trace_buffer, slow_n=cfg.trace_slow_n,
        )
        # the event-loop stall collector: built here (the admission ladder
        # and /metrics read it), DRIVEN by the transports — the async one
        # arms the loop tick, the threaded one the thread — and stopped by
        # close(), so an in-process app spawns nothing by itself
        self.loop_lag = (
            LoopLagMonitor(half_life_s=cfg.loop_lag_half_life_s)
            if cfg.loop_lag_half_life_s > 0 else None
        )
        # SLO burn rates, computed from the metrics only when /metrics or
        # /debug/slo reads them
        self.slo = SloTracker(
            self.metrics,
            p99_target_ms=cfg.slo_p99_ms,
            error_budget=cfg.slo_error_budget,
            degrade_budget=cfg.slo_degrade_budget,
            fast_window_s=cfg.slo_fast_window_s,
            slow_window_s=cfg.slo_slow_window_s,
        )
        # one /debug/profile capture at a time (one profiler per process);
        # with KMLS_PROFILE_DIR set the profiler's slow first start is paid
        # here, before the server answers, not inside the first capture
        self._profile_thread: threading.Thread | None = None
        self._profile_lock = threading.Lock()
        profiling.prime()
        # epoch-keyed answer cache in front of the batcher: a bundle hot
        # swap invalidates it wholesale (the engine's epoch is the key
        # prefix)
        self.cache = (
            RecommendCache(cfg.cache_max_entries)
            if cfg.cache_enabled and cfg.cache_max_entries > 0
            else None
        )
        # a delta applied in place keeps the epoch: only the keys whose
        # seeds it touched may be stale. The engine calls back after the
        # patched replicas are live (getattr: engine doubles stay usable)
        listeners = getattr(self.engine, "delta_listeners", None)
        if listeners is not None:
            listeners.append(self._on_delta_applied)
        # rendezvous-ring affinity accounting (counters only, no routing)
        self.ring = None
        self._ring_self = ""
        self.affinity_local_total = 0
        self.affinity_remote_total = 0
        if cfg.cache_affinity:
            import socket

            from ..freshness.ring import RendezvousRing

            me = cfg.cache_affinity_self or socket.gethostname()
            peers = [p.strip() for p in cfg.cache_affinity_peers.split(",") if p.strip()]
            if me not in peers:
                peers.append(me)
            self.ring = RendezvousRing(peers)
            self._ring_self = me
        # defer_batcher: the asyncio transport installs its loop-native
        # AsyncMicroBatcher instead of the threaded pipeline
        self.batcher = None
        if cfg.batch_window_ms > 0 and not defer_batcher:
            from .batcher import MicroBatcher

            self.batcher = MicroBatcher(
                self.engine, **batcher_kwargs(cfg), metrics=self.metrics,
                lag_monitor=self.loop_lag,
            )
        # the client page and static root honor APP_PATH_FROM_ROOT like the
        # reference (rest_api/app/main.py:44-48, :138): templates/static
        # there take precedence over the package's copies
        pkg_dir = os.path.dirname(__file__)
        root = cfg.app_path_from_root or ""
        template_path = _TEMPLATE_PATH
        self.static_dir = os.path.abspath(os.path.join(pkg_dir, "static"))
        if root:
            custom_template = os.path.join(root, "templates", "client.html")
            if os.path.isfile(custom_template):
                template_path = custom_template
            custom_static = os.path.join(root, "static")
            if os.path.isdir(custom_static):
                self.static_dir = os.path.abspath(custom_static)
        with open(template_path, encoding="utf-8") as fh:
            self._template = fh.read()

    # ---------- routing ----------

    def handle(
        self, method: str, path: str, body: bytes | None,
        client_host: str | None = None, trace_header: str | None = None,
        budget_header: str | None = None,
    ) -> Response:
        path, _, query = path.partition("?")
        if method == "POST" and path in ("/api/recommend/", "/api/recommend"):
            return self._post_recommend(body, trace_header, budget_header)
        if method == "POST" and path == "/metrics/reset":
            # windows the latency percentiles to one replay run
            if not is_loopback_host(client_host):
                return _json_response(403, {"detail": "localhost only"})
            discarded = self.metrics.reset_latency()
            return _json_response(200, {"status": "reset", "discarded": discarded})
        if method == "GET":
            if path == "/":
                return self._get_client()
            if path == "/test":
                return 307, {"Location": "/docs#post-api-recommend"}, b""
            if path == "/docs":
                return self._get_docs()
            if path == "/openapi.json":
                return _json_response(200, self._openapi())
            if path == "/healthz":
                return _json_response(200, {"status": "alive"})
            if path == "/readyz":
                return self._get_readyz()
            if path in ("/debug/traces", "/debug/slo", "/debug/profile"):
                # loopback only: retained traces carry request payloads, and
                # fleet scraping belongs to /metrics
                if not is_loopback_host(client_host):
                    return _json_response(403, {"detail": "localhost only"})
                if path == "/debug/traces":
                    return _json_response(200, self.recorder.debug_payload())
                if path == "/debug/slo":
                    return _json_response(200, self.slo.debug_payload())
                return self._debug_profile(query)
            if path == "/metrics":
                text = self.metrics.render(
                    self.engine.reload_counter, self.engine.finished_loading,
                    cache=self.cache,
                    dispatch_counts=getattr(self.engine, "dispatch_counts", None),
                    robustness=self._robustness_state(),
                    artifact_ages=self._artifact_ages(),
                    io=MONITOR.snapshot(),
                    cost=getattr(self.engine, "cost_model", None),
                    slo=self.slo,
                )
                return 200, {"Content-Type": "text/plain; version=0.0.4"}, text.encode()
            if path.startswith("/static/"):
                return self._get_static(path[len("/static/"):])
        return _json_response(404, {"detail": "Not Found"})

    def close(self) -> None:
        """Stop the loop-lag driver and the threaded batcher's threads (the
        asyncio transport closes the batcher it installed itself)."""
        if self.loop_lag is not None:
            self.loop_lag.stop()
        close = getattr(self.batcher, "close", None)
        if callable(close):
            close()

    def _get_readyz(self) -> Response:
        """Degraded = ready-but-flagged (200): the pod keeps answering, so
        a bad moment on one replica never readiness-fails the fleet."""
        if not self.engine.finished_loading:
            return _json_response(503, {"status": "awaiting first artifacts"})
        ages = {name: round(age, 3) for name, age in self._artifact_ages().items()}
        reasons = self.degraded_reasons()
        if reasons:
            return _json_response(
                200, {"status": "degraded", "reasons": reasons, "artifact_age_seconds": ages}
            )
        return _json_response(200, {"status": "ready", "artifact_age_seconds": ages})

    def _robustness_state(self) -> dict:
        """Batcher recovery-state snapshot for /metrics (names ending in
        _total render as counters, the rest as gauges)."""
        ejected_fn = getattr(self.batcher, "ejected_replicas", None)
        util_fn = getattr(self.batcher, "utilization", None)
        return {
            "artifact_quarantines_total": getattr(self.engine, "artifact_quarantines", 0),
            "reload_failures_total": getattr(self.engine, "reload_failures", 0),
            "reload_consecutive_failures": getattr(
                self.engine, "consecutive_reload_failures", 0
            ),
            # hybrid serving: is the embedding merge live, how many
            # embedding loads degraded to rules only, the effective weight
            "embedding_active": int(getattr(self.engine, "embedding_active", False)),
            "embedding_load_failures_total": getattr(self.engine, "embedding_load_failures", 0),
            "hybrid_blend_weight": round(
                getattr(self.engine, "blend_weight", self.cfg.hybrid_blend_weight), 4
            ),
            "replicas_ejected": len(ejected_fn()) if callable(ejected_fn) else 0,
            # the autoscaling signal; 0.0 without a batcher so the series
            # always exists
            "utilization": round(util_fn() if callable(util_fn) else 0.0, 4),
            "admission_degrade_total": getattr(self.batcher, "degrade_total", 0),
            # the decayed stall estimate the ladder also folds in; 0.0 with
            # the collector off, so the series always exists
            "loop_lag_ms": (
                round(self.loop_lag.lag_s() * 1e3, 3) if self.loop_lag is not None else 0.0
            ),
            "deadline_expired_total": self.deadline_expired_total,
            # began is the zero-cost proof counter: 0 while tracing is off
            "traces_began_total": self.recorder.began,
            "traces_retained_total": self.recorder.retained_total,
            "trace_buffer_entries": self.recorder.retained() if self.recorder.enabled else 0,
            # continuous freshness: bundles applied in place vs rejected,
            # the chain position serving, the serving generation's chain
            # length, and the age of the newest applied generation
            "delta_applied_total": getattr(self.engine, "delta_applied_total", 0),
            "delta_rejected_total": getattr(self.engine, "delta_rejected_total", 0),
            "delta_seq": getattr(self.engine, "delta_seq", 0),
            "delta_chain_length": getattr(self.engine, "delta_chain_length", 0),
            "freshness_lag_seconds": round(
                getattr(self.engine, "freshness_lag_s", lambda: 0.0)(), 3
            ),
            # the requests a rendezvous router would keep on this replica
            # (0/0 with KMLS_CACHE_AFFINITY off)
            "cache_affinity_local_total": self.affinity_local_total,
            "cache_affinity_remote_total": self.affinity_remote_total,
        }

    def _artifact_ages(self) -> dict:
        ages_fn = getattr(self.engine, "artifact_ages", None)
        return ages_fn() if callable(ages_fn) else {}

    def _debug_profile(self, query: str) -> Response:
        """``GET /debug/profile?seconds=N``: a ``torch.profiler`` capture of
        the live server for N seconds (clamped to [0.05, 120]) through
        ``utils/profiling.trace_session``, on a background thread — the
        async transport handles this route ON the loop. Refused (409) while
        ``KMLS_PROFILE_DIR`` is unset, so production serving is never
        profiled by accident; one capture at a time."""
        target = profiling.profile_dir()
        if target is None:
            return _json_response(
                409,
                {"detail": "profiling disabled: set KMLS_PROFILE_DIR "
                           "to enable /debug/profile captures"},
            )
        try:
            params = dict(pair.split("=", 1) for pair in query.split("&") if "=" in pair)
            seconds = float(params.get("seconds", "5"))
        except ValueError:
            seconds = float("nan")
        if not math.isfinite(seconds):
            # nan/inf slide through the clamp below and would kill the
            # capture thread after the 202
            return _json_response(422, {"detail": "seconds must be a finite number"})
        seconds = min(max(seconds, 0.05), 120.0)
        label = f"serve-capture-{int(time.time())}"
        with self._profile_lock:
            thread = self._profile_thread
            if thread is not None and thread.is_alive():
                return _json_response(409, {"detail": "a profile capture is already running"})
            self._profile_thread = profiling.start_capture(label, seconds)
        return _json_response(
            202,
            {"status": "capturing", "seconds": seconds, "label": label,
             "dir": os.path.join(target, label)},
        )

    _STATIC_TYPES = {
        ".css": "text/css; charset=utf-8",
        ".js": "text/javascript; charset=utf-8",
        ".html": "text/html; charset=utf-8",
        ".json": "application/json",
        ".svg": "image/svg+xml",
        ".png": "image/png",
        ".ico": "image/x-icon",
    }

    def _get_static(self, rel: str) -> Response:
        """Static assets under the resolved static root, confined to it
        after symlink resolution (no ``..`` or symlink escapes)."""
        full = os.path.realpath(os.path.join(self.static_dir, rel))
        root = os.path.realpath(self.static_dir)
        if not full.startswith(root + os.sep):
            return _json_response(404, {"detail": "Not Found"})
        try:
            with open(full, "rb") as fh:
                data = fh.read()
        except OSError:
            return _json_response(404, {"detail": "Not Found"})
        ctype = self._STATIC_TYPES.get(
            os.path.splitext(full)[1].lower(), "application/octet-stream"
        )
        return 200, {"Content-Type": ctype}, data

    # ---------- endpoints ----------

    @staticmethod
    def _validate_recommend(body: bytes | None) -> tuple[Response | None, list[str] | None]:
        """→ (error response, None) or (None, songs)."""
        try:
            payload = json.loads(body or b"")
        except json.JSONDecodeError:
            return _json_response(
                422, {"detail": [{"msg": "request body is not valid JSON"}]}
            ), None
        songs = payload.get("songs") if isinstance(payload, dict) else None
        if not isinstance(songs, list) or not all(isinstance(s, str) for s in songs):
            return _json_response(
                422,
                {"detail": [{"loc": ["body", "songs"],
                             "msg": "field 'songs' must be a list of strings"}]},
            ), None
        if not songs:
            # reference: empty request → 400 (rest_api/app/main.py:178-179)
            return _json_response(400, {"detail": "Request with no songs"}), None
        return None, songs

    # ---------- span tracing ----------

    def _trace_begin(self, header: str | None):
        """→ a TraceContext for this request, or None: with tracing off
        the one ``enabled`` check is the whole per-request cost."""
        rec = self.recorder
        return rec.begin(header) if rec.enabled else None

    def _trace_finish(self, trace, status: str, headers: dict) -> None:
        """Close the trace (retention decides whether it is kept) and echo
        ``X-KMLS-Trace`` so a client can join its timing to the spans."""
        if trace is None:
            return
        self.recorder.finish(trace, status, time.perf_counter() - trace.t0)
        headers["X-KMLS-Trace"] = trace.trace_id

    # ---------- degradation (the fault-tolerance contract) ----------

    def _deadline_for(self, t0: float) -> float | None:
        """Per-request perf_counter deadline from KMLS_REQUEST_DEADLINE_MS,
        propagated cache → batcher → device. None = deadlines off."""
        budget_ms = self.cfg.request_deadline_ms
        return t0 + budget_ms / 1e3 if budget_ms > 0 else None

    def _effective_deadline(
        self, t0: float, budget_header: str | None
    ) -> tuple[float | None, float | None, bool]:
        """The TIGHTER of the local budget and the remaining milliseconds
        an upstream hop forwarded on ``X-KMLS-Deadline-Budget`` →
        ``(deadline, forwarded_budget_ms, expired)``; ``expired`` means the
        budget arrived spent. A malformed header is ignored."""
        deadline = self._deadline_for(t0)
        if not budget_header:
            return deadline, None, False
        try:
            budget_ms = float(budget_header)
        except (TypeError, ValueError):
            return deadline, None, False
        if not math.isfinite(budget_ms):
            return deadline, None, False
        if budget_ms <= 0.0:
            return deadline, budget_ms, True
        remote = t0 + budget_ms / 1e3
        if deadline is None or remote < deadline:
            deadline = remote
        return deadline, budget_ms, False

    @staticmethod
    def _degrade_reason(exc: Exception) -> str | None:
        """Exceptions answered from the fallback instead of an error
        status: deadline exhaustion, total replica loss, and the admission
        ladder's degrade band."""
        if isinstance(exc, DeadlineExceeded):
            return "deadline"
        if isinstance(exc, NoHealthyReplicas):
            return "replica-loss"
        if isinstance(exc, OverloadDegraded):
            return "overload"
        return None

    def _degraded_response(
        self, t0: float, songs: list[str], reason: str, trace=None,
    ) -> Response:
        """200 with the latency-budgeted popularity fallback and
        ``X-KMLS-Degraded: <reason>``: a slow device or a dead replica set
        costs answer QUALITY, never a 5xx. The fallback runs under the
        tighter of the request deadline and KMLS_FALLBACK_BUDGET_MS."""
        budget = time.perf_counter() + self.cfg.fallback_budget_ms / 1e3
        deadline = self._deadline_for(t0)
        deadline = budget if deadline is None else min(deadline, budget)
        recs = self.engine.static_recommendation(songs, deadline=deadline)
        self.metrics.record_degraded(reason)
        self.metrics.record("fallback", time.perf_counter() - t0)
        status, headers, payload = _json_response(
            200,
            {"songs": recs, "model_date": self.engine.cache_value, "version": self.cfg.version},
        )
        headers["X-KMLS-Degraded"] = reason
        if trace is not None:
            # the ladder's decision rides an attribute: "overload" is the
            # admission controller's degrade rung
            trace.annotate("reason", reason)
            if reason == "overload":
                trace.annotate("admission", "degrade")
            self._trace_finish(trace, "degraded", headers)
        return status, headers, payload

    def degraded_reasons(self) -> list[str]:
        """Why /readyz says "degraded" (empty = fully healthy), in the
        reference's order: reloads failing while the last-good bundle keeps
        serving, replicas ejected by the batcher's circuit breaker, and the
        artifact volume convicted as slow (degraded, not unready: serving
        runs from memory)."""
        reasons: list[str] = []
        consec = getattr(self.engine, "consecutive_reload_failures", 0)
        if consec > 0:
            reasons.append(f"reload failing x{consec} (serving last-good bundle)")
        if getattr(self.engine, "embedding_degraded", False):
            # a published embeddings.npz failed its checks: answered from
            # the rules, but flagged so the operator sees the dark family
            reasons.append("embedding artifact unusable (serving rules-only)")
        ejected_fn = getattr(self.batcher, "ejected_replicas", None)
        ejected = ejected_fn() if callable(ejected_fn) else []
        if ejected:
            reasons.append(f"replicas ejected: {ejected}")
        if MONITOR.storage_slow():
            reasons.append("storage-slow")
        return reasons

    def _recommend_error_response(self, exc: Exception, trace=None) -> Response:
        if isinstance(exc, Overloaded):
            # visible backpressure: tell the client when to come back
            status, headers, payload = _json_response(
                429,
                {"detail": "overloaded: projected queue wait "
                           f"{exc.projected_wait_ms:.0f}ms exceeds budget"},
            )
            # RFC 9110 delay-seconds is a non-negative INTEGER; ceil keeps
            # the sub-second jitter spread across whole seconds
            headers["Retry-After"] = str(math.ceil(max(exc.retry_after_s, 0.0)))
            if trace is not None:
                trace.annotate("admission", "shed")
                trace.annotate("retry_after_s", round(exc.retry_after_s, 3))
                self._trace_finish(trace, "shed", headers)
            return status, headers, payload
        logger.error("recommendation failed", exc_info=exc)
        self.metrics.record_error()
        status, headers, payload = _json_response(500, {"detail": "Internal Server Error"})
        if trace is not None:
            trace.annotate("error", type(exc).__name__)
            self._trace_finish(trace, "error", headers)
        return status, headers, payload

    def _recommend_result_response(
        self, t0: float, recs: list[str], source: str, cached: bool = False, trace=None,
    ) -> Response:
        # compose span: the answer is available (the caller comes straight
        # from the resolved future) → the response bytes are built
        t_compose = time.perf_counter() if trace is not None else 0.0
        self.metrics.record(source, time.perf_counter() - t0)
        status, headers, payload = _json_response(
            200,
            {"songs": recs, "model_date": self.engine.cache_value, "version": self.cfg.version},
        )
        if cached:
            # lets load harnesses split cached vs computed latency
            headers["X-KMLS-Cache"] = "hit"
        # a "degraded:<reason>" source is an answered-but-partial result
        degraded = source.startswith("degraded:")
        if degraded:
            reason = source.partition(":")[2] or source
            headers["X-KMLS-Degraded"] = reason
            self.metrics.record_degraded(reason)
        if trace is not None:
            trace.span("compose", t_compose, time.perf_counter(), {"source": source})
            if cached:
                trace.annotate("cached", True)
            if degraded:
                trace.annotate("reason", source.partition(":")[2] or source)
            self._trace_finish(trace, "ok", headers)
        return status, headers, payload

    def _on_delta_applied(self, touched: set, wholesale: bool) -> None:
        """Engine callback after a delta swapped in: invalidate the cached
        answers of the touched seeds (a wholesale apply bumped the epoch,
        which already invalidated every key)."""
        if self.cache is None or wholesale:
            return
        dropped = self.cache.invalidate_seeds(set(touched))
        logger.info(
            "delta applied: %d touched names, %d cache entries invalidated "
            "selectively", len(touched), dropped,
        )

    # ---------- the cache front half, shared by both transports ----------

    def _cache_key(self, songs: list[str]) -> tuple:
        if self.cache is not None:
            return self.cache.make_key(self.engine.bundle_epoch, songs, self.cfg.max_seed_tracks)
        return RecommendCache.key(self.engine.bundle_epoch, songs, self.cfg.max_seed_tracks)

    def _cache_lookup_or_lead(
        self, songs: list[str], deadline: float | None = None, trace=None,
    ):
        """→ ``("hit", (songs, source))`` | ``("flight", future)`` |
        ``("off", None)``. A miss joins the in-flight singleflight future
        for this key or leads a new batcher submission (the leader's
        done-callback stores the answer); raises what ``batcher.submit``
        raises. "off": cache disabled, or no batcher. With the ring armed
        it first counts whether this replica owns the request's key."""
        if self.ring is not None:
            from ..freshness.ring import seeds_key

            if self.ring.owner(seeds_key(songs)) == self._ring_self:
                self.affinity_local_total += 1
            else:
                self.affinity_remote_total += 1
        if self.cache is None or self.batcher is None:
            return "off", None
        key = self._cache_key(songs)
        if trace is not None:
            t_cache = time.perf_counter()
            hit = self.cache.get(key)
            trace.span("cache", t_cache, time.perf_counter(), {"hit": hit is not None})
        else:
            hit = self.cache.get(key)
        if hit is not None:
            return "hit", hit
        future, joined = self.cache.join_or_lead(
            key, lambda: self.batcher.submit(songs, deadline=deadline, trace=trace)
        )
        if joined and trace is not None:
            # a joiner shares the leader's batch slot: no queue/device spans
            trace.annotate("singleflight", "joined")
        if not joined:
            cache = self.cache
            future.add_done_callback(lambda f: cache.finish(key, f))
        # the seeds travel WITH the future so the async transport can build
        # a per-request degraded fallback when it resolves to an exception
        # (identical seed sets share one future, so the attribute agrees)
        future._kmls_seeds = songs
        return "flight", future

    def recommend_direct(
        self, songs: list[str], trace=None, deadline: float | None = None,
    ) -> tuple[list[str], str, bool]:
        """Blocking cached recommend → ``(songs, source, cache_hit)``; raises
        (Overloaded, DeadlineExceeded, NoHealthyReplicas included) like the
        underlying batcher/engine. ``deadline`` None computes the local one."""
        if deadline is None:
            deadline = self._deadline_for(time.perf_counter())
        state, payload = self._cache_lookup_or_lead(songs, deadline, trace)
        if state == "hit":
            return payload[0], payload[1], True
        if state == "flight":
            timeout = 30.0
            if deadline is not None:
                timeout = max(deadline - time.perf_counter(), 0.0)
            try:
                recs, source = payload.result(timeout=timeout)
            except FuturesTimeout:
                if deadline is not None:
                    raise DeadlineExceeded(
                        "request exceeded its deadline budget in flight"
                    ) from None
                raise
            return recs, source, False
        if self.batcher is not None:
            recs, source = self.batcher.recommend(songs, deadline=deadline, trace=trace)
        else:
            recs, source = self.engine.recommend(songs)
        if self.cache is not None:
            self.cache.put(self._cache_key(songs), (recs, source))
        return recs, source, False

    def _post_recommend(
        self, body: bytes | None, trace_header: str | None = None,
        budget_header: str | None = None,
    ) -> Response:
        t0 = time.perf_counter()
        err, songs = self._validate_recommend(body)
        if err is not None:
            return err
        # the trace begins after validation: a malformed body builds none
        trace = self._trace_begin(trace_header)
        deadline, budget_ms, expired = self._effective_deadline(t0, budget_header)
        if budget_ms is not None and trace is not None:
            trace.annotate("deadline_budget_ms", round(budget_ms, 3))
        if expired:
            # the budget arrived spent: answer the fallback, compute nothing
            self.deadline_expired_total += 1
            return self._degraded_response(t0, songs, "deadline-expired", trace=trace)
        try:
            recs, source, cached = self.recommend_direct(songs, trace=trace, deadline=deadline)
        except Exception as exc:
            reason = self._degrade_reason(exc)
            if reason is not None:
                return self._degraded_response(t0, songs, reason, trace=trace)
            return self._recommend_error_response(exc, trace=trace)
        return self._recommend_result_response(t0, recs, source, cached=cached, trace=trace)

    # ---------- async-transport entry points ----------

    def submit_recommend(
        self, body: bytes | None, trace_header: str | None = None,
        budget_header: str | None = None,
    ):
        """Non-blocking twin of :meth:`_post_recommend` for the asyncio
        transport: → ``(response, None, t0, None)`` when the answer is
        immediate (validation error, cache hit, shed, degraded, or the
        unbatched path), else ``(None, future, t0, trace)`` — resolve the
        future and build the reply with :meth:`finish_recommend`. The
        trace rides the tuple, not the future: identical seed sets share
        one future, and each connection's trace is its own."""
        t0 = time.perf_counter()
        err, songs = self._validate_recommend(body)
        if err is not None:
            return err, None, t0, None
        if self.batcher is None:
            return self._post_recommend(body, trace_header, budget_header), None, t0, None
        trace = self._trace_begin(trace_header)
        deadline, budget_ms, expired = self._effective_deadline(t0, budget_header)
        if budget_ms is not None and trace is not None:
            trace.annotate("deadline_budget_ms", round(budget_ms, 3))
        if expired:
            self.deadline_expired_total += 1
            return self._degraded_response(t0, songs, "deadline-expired", trace=trace), None, t0, None
        try:
            state, payload = self._cache_lookup_or_lead(songs, deadline, trace)
            if state == "off":
                payload = self.batcher.submit(songs, deadline=deadline, trace=trace)
                payload._kmls_seeds = songs
        except Exception as exc:  # Overloaded / OverloadDegraded / NoHealthyReplicas
            reason = self._degrade_reason(exc)
            if reason is not None:
                return self._degraded_response(t0, songs, reason, trace=trace), None, t0, None
            return self._recommend_error_response(exc, trace=trace), None, t0, None
        if state == "hit":
            response = self._recommend_result_response(
                t0, payload[0], payload[1], cached=True, trace=trace,
            )
            return response, None, t0, None
        return None, payload, t0, trace

    def finish_recommend(self, future, t0: float, trace=None) -> Response:
        """Build the response for a DONE :meth:`submit_recommend` future; a
        future resolved to a degradable exception answers the fallback for
        the seeds that rode in on it."""
        try:
            recs, source = future.result()
        except Exception as exc:
            reason = self._degrade_reason(exc)
            if reason is not None:
                songs = getattr(future, "_kmls_seeds", None) or []
                return self._degraded_response(t0, songs, reason, trace=trace)
            return self._recommend_error_response(exc, trace=trace)
        return self._recommend_result_response(t0, recs, source, trace=trace)

    # ---------- pages ----------

    def _get_client(self) -> Response:
        """Render the HTML test client with a sampled seed + static sample
        (reference: rest_api/app/main.py:190-203 — which sleeps 2 s when
        data isn't loaded yet; here the page renders with a notice)."""
        # finished_loading BEFORE best_tracks: load() publishes the tracks
        # first, so a True snapshot guarantees the read below sees them
        finished = self.engine.finished_loading
        best = self.engine.best_tracks
        page = self._template.replace("{{version}}", self.cfg.version).replace(
            "{{model_date}}", str(self.engine.cache_value)
        )
        if not best:
            if finished:
                notice = (
                    "<p><em>Model loaded, but the popularity ranking kept "
                    "no tracks (vocabulary × TOP_TRACKS_SAVE_PERCENTILE "
                    "truncates to zero) — use <a href='/docs'>/docs</a> to "
                    "POST seed songs directly.</em></p>"
                )
            else:
                notice = "<p><em>Model artifacts not loaded yet — retry shortly.</em></p>"
            page = (
                page.replace("{{track_checkboxes}}", notice)
                .replace("{{sample_seed}}", "—")
                .replace("{{sample_recommendations}}", "")
            )
            return _html_response(200, page)
        names = [b["track_name"] for b in best]
        sample_pool = random.sample(names, min(12, len(names)))
        seed = random.choice(names)
        sample = self.engine.static_recommendation([seed])
        checkboxes = "\n".join(
            f'<label><input type="checkbox" value="{_esc(n)}"> {_esc(n)}</label>'
            for n in sample_pool
        )
        sample_html = "\n".join(f"<li>{_esc(s)}</li>" for s in sample)
        page = (
            page.replace("{{track_checkboxes}}", checkboxes)
            .replace("{{sample_seed}}", _esc(seed))
            .replace("{{sample_recommendations}}", sample_html)
        )
        return _html_response(200, page)

    def _get_docs(self) -> Response:
        """The docs page: the three canned request examples (reference
        parity: rest_api/app/main.py:158-174) each load into an editable
        request body that can be sent to the live endpoint."""
        examples = "\n".join(
            f"<h3>{_esc(ex['summary'])}</h3>"
            f"<pre>POST /api/recommend/\n{json.dumps(ex['value'], indent=2)}</pre>"
            f"<button class='load' data-body='{_esc(json.dumps(ex['value']))}'>"
            f"Try it</button>"
            for ex in CANNED_EXAMPLES.values()
        )
        first = json.dumps(next(iter(CANNED_EXAMPLES.values()))["value"], indent=2)
        html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>API docs — Playlist Recommender</title>
<style>body{{font-family:system-ui;max-width:760px;margin:2rem auto;padding:0 1rem}}
pre{{background:#8881;padding:.8rem;border-radius:6px;overflow-x:auto}}
textarea{{width:100%;font-family:monospace;min-height:7rem}}
button{{margin:.3rem .3rem .3rem 0;padding:.35rem .9rem;cursor:pointer}}
#resp{{white-space:pre-wrap}}</style></head>
<body><h1>Playlist Recommender API {_esc(self.cfg.version)}</h1>
<p>Machine-readable spec: <a href="/openapi.json">/openapi.json</a></p>
<h2 id="post-api-recommend">POST /api/recommend/</h2>
<p>Request: <code>{{"songs": ["...", ...]}}</code> — at least one song
(empty → 400). Response: <code>{{"songs": [...], "model_date": "...",
"version": "..."}}</code>. Seeds found in the mined rules yield rule-based
recommendations; fully unknown seed sets fall back to a deterministic
popular-tracks sample.</p>
{examples}
<h2>Try it against this server</h2>
<textarea id="body" spellcheck="false">{_esc(first)}</textarea><br>
<button id="send">Send POST /api/recommend/</button>
<pre id="resp">(response appears here)</pre>
<script>
document.querySelectorAll('button.load').forEach(function (b) {{
  b.addEventListener('click', function () {{
    document.getElementById('body').value =
      JSON.stringify(JSON.parse(b.dataset.body), null, 2);
    document.getElementById('body').scrollIntoView({{behavior: 'smooth'}});
  }});
}});
document.getElementById('send').addEventListener('click', async function () {{
  var out = document.getElementById('resp');
  out.textContent = '...';
  try {{
    var r = await fetch('/api/recommend/', {{
      method: 'POST',
      headers: {{'Content-Type': 'application/json'}},
      body: document.getElementById('body').value,
    }});
    var text = await r.text();
    try {{ text = JSON.stringify(JSON.parse(text), null, 2); }} catch (e) {{}}
    out.textContent = 'HTTP ' + r.status + '\\n' + text;
  }} catch (e) {{
    out.textContent = 'request failed: ' + e;
  }}
}});
</script>
<h2>Other endpoints</h2>
<ul>
<li><code>GET /</code> — HTML test client</li>
<li><code>GET /test</code> — redirect here</li>
<li><code>GET /healthz</code>, <code>GET /readyz</code> — probes</li>
<li><code>GET /metrics</code> — Prometheus text metrics</li>
<li><code>GET /debug/traces</code>, <code>GET /debug/slo</code>,
<code>GET /debug/profile?seconds=N</code> — loopback-only debug views
(retained traces, SLO burn rates, on-demand profiler capture)</li>
</ul></body></html>"""
        return _html_response(200, html)

    def _openapi(self) -> dict:
        return {
            "openapi": "3.1.0",
            "info": {"title": "Playlist Recommender (TPU rebuild)", "version": self.cfg.version},
            "paths": {
                "/api/recommend/": {
                    "post": {
                        "summary": "Recommend songs from seed songs",
                        "requestBody": {
                            "required": True,
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "type": "object",
                                        "required": ["songs"],
                                        "properties": {
                                            "songs": {
                                                "type": "array",
                                                "items": {"type": "string"},
                                                "minItems": 1,
                                            }
                                        },
                                    },
                                    "examples": CANNED_EXAMPLES,
                                }
                            },
                        },
                        "responses": {
                            "200": {
                                "description": "Recommendations",
                                "content": {
                                    "application/json": {
                                        "schema": {
                                            "type": "object",
                                            "properties": {
                                                "songs": {"type": "array", "items": {"type": "string"}},
                                                "model_date": {"type": "string"},
                                                "version": {"type": "string"},
                                            },
                                        }
                                    }
                                },
                            },
                            "400": {"description": "Empty song list"},
                            "422": {"description": "Malformed body"},
                        },
                    }
                }
            },
        }


def batcher_kwargs(cfg: ServingConfig) -> dict:
    """The micro-batcher knobs of ``cfg``, shared by both transports."""
    return dict(
        max_size=cfg.batch_max_size,
        window_ms=cfg.batch_window_ms,
        max_inflight=cfg.batch_max_inflight,
        adaptive=cfg.batch_adaptive_window,
        window_min_ms=cfg.batch_window_min_ms,
        shed_queue_budget_ms=cfg.shed_queue_budget_ms,
        shed_retry_after_s=cfg.shed_retry_after_s,
        shed_soft_ratio=cfg.shed_soft_ratio,
        shed_hard_ratio=cfg.shed_hard_ratio,
        shed_retry_jitter=cfg.shed_retry_jitter,
        eject_threshold=cfg.replica_eject_threshold,
        probe_interval_s=cfg.replica_probe_interval_s,
        redispatch_max=cfg.redispatch_max_retries,
    )


# ---------- stdlib HTTP adapter ----------


def make_handler(app: RecommendApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # headers and body go out as separate sends on an unbuffered
        # socket; with Nagle on, the body waits for the peer's delayed ACK
        disable_nagle_algorithm = True

        def _dispatch(self, method: str) -> None:
            # in-flight accounting for the SIGTERM drain: idle keep-alive
            # connections sit BETWEEN requests and are not counted
            with self.server.active_lock:
                self.server.active_requests += 1
            try:
                body = None
                if method == "POST":
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                try:
                    status, headers, payload = app.handle(
                        method, self.path, body,
                        client_host=self.client_address[0],
                        trace_header=self.headers.get("X-KMLS-Trace"),
                        budget_header=self.headers.get("X-KMLS-Deadline-Budget"),
                    )
                except Exception:
                    logger.exception("unhandled error for %s %s", method, self.path)
                    app.metrics.record_error()
                    status, headers, payload = 500, {"Content-Type": "application/json"}, (
                        b'{"detail": "Internal Server Error"}'
                    )
                self.send_response(status)
                for key, value in headers.items():
                    self.send_header(key, value)
                self.send_header("Content-Length", str(len(payload)))
                # during a drain, tell keep-alive clients to reconnect
                # elsewhere: endpoint removal only diverts NEW connections
                if self.server.draining.is_set():
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(payload)
            finally:
                with self.server.active_lock:
                    self.server.active_requests -= 1

        def do_GET(self) -> None:  # noqa: N802 (stdlib API)
            self._dispatch("GET")

        def do_POST(self) -> None:  # noqa: N802
            self._dispatch("POST")

        def log_message(self, fmt: str, *args) -> None:
            logger.debug("%s - %s", self.address_string(), fmt % args)

    return Handler


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the stdlib default listen backlog of 5 refuses bursts
    request_queue_size = 256

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # in-flight request count and the drain flag, read by the handlers
        # and the SIGTERM drain (serving/server.py)
        self.active_requests = 0
        self.active_lock = threading.Lock()
        self.draining = threading.Event()


def serve(app: RecommendApp, port: int | None = None) -> ThreadingHTTPServer:
    """Bind + return the server (caller runs ``serve_forever``); port 0
    picks a free port."""
    return _Server(("0.0.0.0", port if port is not None else app.cfg.port), make_handler(app))
