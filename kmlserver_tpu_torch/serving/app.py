"""The REST surface — counterpart of ``kmlserver_tpu/serving/app.py`` for
this slice, on the stdlib ``ThreadingHTTPServer``:

- ``POST /api/recommend/`` (reference: rest_api/app/main.py:176-187): body
  ``{"songs": [...]}`` → ``{"songs": [...], "model_date": <token>,
  "version": <VERSION>}``; an empty song list → 400; a malformed body →
  422 (FastAPI's validation status);
- ``GET /readyz``: 200 once the first artifacts have loaded, else 503;
- ``GET /healthz``: liveness.

``handle()`` maps a request to ``(status, headers, body)`` independently of
the transport, so the app is testable in-process.
"""

from __future__ import annotations

import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..config import ServingConfig
from .engine import RecommendEngine

logger = logging.getLogger("kmlserver_tpu_torch.serving")

Response = tuple[int, dict[str, str], bytes]


def _json_response(status: int, obj) -> Response:
    return status, {"Content-Type": "application/json"}, json.dumps(obj).encode("utf-8")


class RecommendApp:
    def __init__(
        self,
        cfg: ServingConfig,
        engine: RecommendEngine | None = None,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.engine = engine if engine is not None else RecommendEngine(cfg, device)

    def handle(self, method: str, path: str, body: bytes | None) -> Response:
        path = path.partition("?")[0]
        if method == "POST" and path in ("/api/recommend/", "/api/recommend"):
            return self._post_recommend(body)
        if method == "GET" and path == "/healthz":
            return _json_response(200, {"status": "alive"})
        if method == "GET" and path == "/readyz":
            if self.engine.finished_loading:
                return _json_response(200, {"status": "ready"})
            return _json_response(503, {"status": "awaiting first artifacts"})
        return _json_response(404, {"detail": "Not Found"})

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

    def _post_recommend(self, body: bytes | None) -> Response:
        err, songs = self._validate_recommend(body)
        if err is not None:
            return err
        recs, _source = self.engine.recommend(songs)
        return _json_response(
            200,
            {
                "songs": recs,
                "model_date": self.engine.cache_value,
                "version": self.cfg.version,
            },
        )


def make_handler(app: RecommendApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def _dispatch(self, method: str) -> None:
            body = None
            if method == "POST":
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
            try:
                status, headers, payload = app.handle(method, self.path, body)
            except Exception:
                logger.exception("unhandled error for %s %s", method, self.path)
                status, headers, payload = 500, {"Content-Type": "application/json"}, (
                    b'{"detail": "Internal Server Error"}'
                )
            self.send_response(status)
            for key, value in headers.items():
                self.send_header(key, value)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

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


def serve(app: RecommendApp, port: int | None = None) -> ThreadingHTTPServer:
    """Bind + return the server (caller runs ``serve_forever``); port 0
    picks a free port."""
    return _Server(
        ("0.0.0.0", port if port is not None else app.cfg.port), make_handler(app)
    )
