"""Opt-in local Prometheus scrape endpoint.

``clawker loop --metrics-port N`` (or settings ``telemetry.metrics_port``)
serves the process registry's text exposition on ``127.0.0.1:N/metrics``
for the duration of the run.  Loopback-only on purpose: the scrape
surface carries worker ids and agent names; anything fleet-wide rides
the OTLP lanes to the collector instead (telemetry/otlp.py), exactly
like the reference stack's OTel Collector -> Prometheus path.

The port's copy of ``clawker_tpu/telemetry/httpserv.py``, whole.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import logsetup
from .registry import REGISTRY, MetricsRegistry

log = logsetup.get("telemetry.http")


class MetricsServer:
    """Daemon-threaded scrape server over one registry.

    ``port=0`` binds an ephemeral port (tests); read :attr:`port` after
    :meth:`start`.  Serving never blocks a recording thread: the handler
    takes registry stripes one at a time, same as any snapshot.
    """

    def __init__(self, port: int, *, registry: MetricsRegistry | None = None,
                 host: str = "127.0.0.1"):
        self.registry = registry if registry is not None else REGISTRY
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsServer":
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 -- http.server contract
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = registry.exposition().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:    # scrapes are not news
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="telemetry-metrics",
                                        daemon=True)
        self._thread.start()
        log.info("metrics endpoint on http://%s:%d/metrics",
                 self.host, self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
