"""Entrypoint for the online API.

Run as ``python -m kmlserver_tpu_torch.serving.server``. Configured by the
reference's environment variables (``BASE_DIR``, ``K_BEST_TRACKS``,
``POLLING_WAIT_IN_MINUTES``, ``KMLS_PORT`` — 0 picks a free port — ...);
``KMLS_TORCH_DEVICE`` picks the device (default ``cuda``). Logs
``serving on <host>:<port>`` once bound; SIGTERM stops the accept loop and
exits.
"""

from __future__ import annotations

import logging
import signal
import sys
import threading

from ..config import ServingConfig, torch_device_from_env
from .app import RecommendApp, serve


def main() -> int:
    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stdout,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("kmlserver_tpu_torch.serving")
    cfg = ServingConfig.from_env()
    app = RecommendApp(cfg, device=torch_device_from_env())
    app.engine.start_polling()
    server = serve(app)
    host, port = server.server_address[:2]
    log.info("serving on %s:%d (version %s, device %s)", host, port, cfg.version,
             app.engine.device)

    def _stop(signum, frame):
        log.info("SIGTERM: stopping")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
