"""In-process HTTP observability endpoint (stdlib ``http.server``).

Port of ``lightgbm_tpu/obs/http_server.py`` (host code, copied). Serving
starts it (``maybe_start``): ``server.PredictServer`` and
``fleet.FleetServer`` call it with their parameters and register their
status sections. Off by default; ``obs_port=<port>`` starts one
daemon-threaded server bound to 127.0.0.1 serving three read-only paths:

    /metrics   live Prometheus scrape of ``obs.METRICS`` (collectors run
               first, so derived gauges — event drops, model age — are fresh)
    /healthz   liveness probe ("ok")
    /statusz   JSON snapshot assembled from registered status sections
               (PredictServer registers "serving"; OnlineTrainer "online")

Everything here is host-side and pull-based: a scrape never touches device
state, so leaving the endpoint up costs nothing between requests.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from .. import log
from .events import _json_default

_status_lock = threading.Lock()
_SECTIONS: Dict[str, Callable[[], Any]] = {}


def add_status_section(name: str, fn: Callable[[], Any]) -> None:
    """Register a ``/statusz`` section (latest registration wins)."""
    with _status_lock:
        _SECTIONS[name] = fn


def remove_status_section(name: str) -> None:
    with _status_lock:
        _SECTIONS.pop(name, None)


def status() -> Dict[str, Any]:
    """Assemble the /statusz document from the registered sections."""
    from . import EVENTS, enabled
    with _status_lock:
        sections = list(_SECTIONS.items())
    out: Dict[str, Any] = {"telemetry": {"enabled": enabled(),
                                         "events_buffered": len(EVENTS),
                                         "events_dropped": EVENTS.dropped}}
    for name, fn in sections:
        try:
            out[name] = fn()
        except Exception as e:  # a broken provider must not 500 the probe
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "lgbmtpu-obs/1"

    def do_GET(self) -> None:
        from . import METRICS, run_collectors
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            run_collectors()
            body = METRICS.to_prometheus().encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/healthz":
            body = b"ok\n"
            ctype = "text/plain; charset=utf-8"
        elif path == "/statusz":
            doc = json.dumps(status(), sort_keys=True, default=_json_default)
            body = (doc + "\n").encode("utf-8")
            ctype = "application/json"
        else:
            self.send_error(404, "unknown path (try /metrics /healthz /statusz)")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format: str, *args: Any) -> None:
        log.debug(f"obs-http {self.client_address[0]} {format % args}")


class ObsServer:
    """Daemon-threaded HTTP server; ``port=0`` binds an ephemeral port."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1") -> None:
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="lgbm-obs-http", daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ObsServer":
        from . import emit
        self._thread.start()
        emit("obs_server", phase="start", port=self.port)
        return self

    def close(self) -> None:
        from . import emit
        port = self.port
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        emit("obs_server", phase="stop", port=port)


# process-wide singleton for the obs_port= knob (direct ObsServer
# construction stays available for embedders/tests wanting ephemeral ports)
_server_lock = threading.Lock()
_SERVER: Optional[ObsServer] = None


def maybe_start(conf) -> Optional[ObsServer]:
    """Start the process-wide ObsServer when ``conf.obs_port > 0``.
    Idempotent: returns the server only to the call that started it (that
    owner passes it back to :func:`stop`); later calls return None."""
    global _SERVER
    port = int(getattr(conf, "obs_port", 0) or 0)
    if port <= 0:
        return None
    with _server_lock:
        if _SERVER is not None:
            return None
        try:
            srv = ObsServer(port=port)
        except OSError as e:
            log.warning(f"could not bind obs_port={port} "
                        f"({type(e).__name__}: {e}); ObsServer disabled")
            return None
        _SERVER = srv
    return srv.start()


def stop(srv: Optional[ObsServer]) -> None:
    """Shut down a server returned by :func:`maybe_start` (None is a no-op)."""
    global _SERVER
    if srv is None:
        return
    with _server_lock:
        if _SERVER is srv:
            _SERVER = None
    srv.close()
