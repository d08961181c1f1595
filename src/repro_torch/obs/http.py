"""Live serving dashboard: a stdlib HTTP endpoint over ``Observability``.

``serve(obs, port=...)`` starts a daemon ``ThreadingHTTPServer`` that
renders a *fresh* snapshot per request:

* ``GET /metrics``  — Prometheus text exposition (``obs.export``), the
  scrape target: counters (ingested docs, tier writes, resident doc-
  steps, realized spend) are monotone across scrapes of a live engine.
* ``GET /snapshot`` — the full nested snapshot as JSON (the dashboard /
  debugging view).

Snapshots drain the engines' device counters on the request thread —
the same sync ``Observability.snapshot`` always was; the ingest loop
keeps running (host-side state swaps are atomic enough under the GIL
for monitoring reads, which is all an exposition endpoint needs).
No third-party dependencies: the serving stack must not grow a web
framework for two read-only routes.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import export


class ObsServer:
    """Handle for a running endpoint: ``.port`` (resolved when asked for
    port 0), ``.url``, and ``.stop()``."""

    def __init__(self, httpd: ThreadingHTTPServer, thread: threading.Thread):
        self._httpd = httpd
        self._thread = thread
        self._stopped = False
        self.port = int(httpd.server_address[1])
        self.url = f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        """Drain and close the endpoint. Idempotent — shutdown paths
        (signal handler + normal exit) may both call it."""
        if self._stopped:
            return
        self._stopped = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def serve(obs, port: int = 0, host: str = "127.0.0.1",
          prefix: str = "repro_obs") -> ObsServer:
    """Start serving ``obs`` on ``host:port`` (port 0 = ephemeral);
    returns the ``ObsServer`` handle immediately."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server's casing)
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    body = obs.prometheus(prefix=prefix).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/snapshot":
                    body = json.dumps(
                        obs.snapshot(), sort_keys=True,
                        default=export._json_default).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404, "try /metrics or /snapshot")
                    return
            except Exception as exc:  # surface, don't kill the server
                self.send_error(500, type(exc).__name__)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet: scrapes are not events
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="obs-http", daemon=True)
    thread.start()
    return ObsServer(httpd, thread)
