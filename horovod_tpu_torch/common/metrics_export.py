"""Metrics export: Prometheus text exposition, JSON dumps, live endpoints
(counterpart of ``horovod_tpu/common/metrics_export.py``; the port's own
copy, rendering the same text and JSON).

Three consumers of the ``telemetry`` registry:

* ``hvd.metrics()``: the in-process snapshot dict (``common/basics.py``).
* ``HOROVOD_METRICS_FILE=<path>``: a daemon thread dumps a JSON snapshot
  every ``HOROVOD_METRICS_FILE_INTERVAL`` seconds (atomic tmp+rename).
  ``{rank}`` in the path expands to the rank, so multi-process runs don't
  clobber one file.
* ``HOROVOD_METRICS_PORT=<port>``: rank 0 serves Prometheus text at
  ``/metrics``, a JSON snapshot (with the fleet view) at
  ``/metrics.json``, and registered views (the engine's live ``/status``)
  from a daemon thread, bound to loopback unless HOROVOD_METRICS_ADDR
  says otherwise.

Everything here is default-off: with neither variable set, no thread is
started and no socket is opened (the registry itself costs a few int adds
per engine cycle).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ..utils import atomic_file
from ..utils.logging import get_logger
from . import env as env_cfg
from . import telemetry

logger = get_logger()


# ---------------------------------------------------------------------------
# Renderers

def _prom_name(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def _escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (exposition spec §text
    format details) — a multi-line help string would otherwise corrupt
    every line after it for strict parsers."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value: str) -> str:
    """Label values escape backslash, double-quote and newline. A
    version label like `0.4.37+cuda"test` must round-trip, not break
    the series line."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels, extra: str = "") -> str:
    parts = []
    if labels:
        parts.extend(f'{k}="{_escape_label_value(labels[k])}"'
                     for k in sorted(labels))
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v) -> str:
    if isinstance(v, float):
        if v != v:  # NaN
            return "NaN"
        if v == float("inf"):
            return "+Inf"
        return repr(v)
    return str(v)


def to_prometheus(registry: Optional[telemetry.MetricsRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4.
    Histogram buckets are emitted cumulatively with `le` labels plus the
    `+Inf` bucket, `_sum` and `_count`, per the exposition spec."""
    registry = registry or telemetry.default_registry()
    lines = []
    seen_headers = set()
    # Sort by name so all series of one family render contiguously:
    # lazily-created labeled series (op latency) otherwise interleave
    # with other families, which strict exposition parsers reject.
    for m in sorted(registry.metrics(), key=lambda m: m.name):
        name = _prom_name(m.name)
        if name not in seen_headers:
            seen_headers.add(name)
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
        if isinstance(m, telemetry.Histogram):
            snap = m.snapshot()
            cum = 0
            for bound, c in zip(snap["bounds"], snap["counts"]):
                cum += c
                le = 'le="' + _fmt(bound) + '"'
                lines.append(f"{name}_bucket{_prom_labels(m.labels, le)} {cum}")
            cum += snap["counts"][-1]
            le_inf = 'le="+Inf"'
            lines.append(f"{name}_bucket{_prom_labels(m.labels, le_inf)} {cum}")
            lines.append(f"{name}_sum{_prom_labels(m.labels)} {_fmt(snap['sum'])}")
            lines.append(f"{name}_count{_prom_labels(m.labels)} {snap['count']}")
        else:
            lines.append(f"{name}{_prom_labels(m.labels)} {_fmt(m.snapshot())}")
    return "\n".join(lines) + "\n"


def _unescape_help(s: str) -> str:
    """Inverse of `_escape_help`, single left-to-right pass — chained
    str.replace would corrupt a literal backslash followed by 'n'
    (escaped `\\\\n` must decode to backslash+n, not backslash+LF)."""
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_label_block(s: str) -> dict:
    """Inverse of `_prom_labels`: parse `{k="v",...}` honoring the
    value escapes (backslash, quote, newline)."""
    out = {}
    i = 1  # past '{'
    end = len(s) - 1  # before '}'
    while i < end:
        eq = s.index("=", i)
        name = s[i:eq].strip().lstrip(",").strip()
        if s[eq + 1] != '"':
            raise ValueError(f"unquoted label value in {s!r}")
        k = eq + 2
        val = []
        while True:
            c = s[k]
            if c == "\\":
                nxt = s[k + 1]
                val.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
                k += 2
            elif c == '"':
                k += 1
                break
            else:
                val.append(c)
                k += 1
        out[name] = "".join(val)
        i = k
    return out


def parse_prometheus(text: str):
    """Parse text exposition 0.0.4 back into
    ``(samples, types, helps)``: samples keyed the same way as
    `MetricsRegistry.snapshot()` (``name{k="v",...}`` with sorted
    labels), types/helps keyed by family name. The conformance
    round-trip test — and anything in-repo that scrapes a live
    `/metrics` — consumes this instead of regexing the text."""
    samples: dict = {}
    types: dict = {}
    helps: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if line.startswith("# HELP "):
            _, _, name, rest = line.split(None, 3)
            helps[name] = _unescape_help(rest)
            continue
        if line.startswith("#"):
            continue
        brace = line.find("{")
        if brace >= 0:
            close = line.rindex("}")
            name = line[:brace]
            labels = _parse_label_block(line[brace:close + 1])
            value = line[close + 1:].strip()
        else:
            name, value = line.split(None, 1)
            labels = {}
        v = float(value)
        key = name
        if labels:
            inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
            key = f"{name}{{{inner}}}"
        samples[key] = v
    return samples, types, helps


def to_json(registry: Optional[telemetry.MetricsRegistry] = None,
            fleet: Optional[telemetry.FleetView] = None,
            extra: Optional[dict] = None) -> str:
    registry = registry or telemetry.default_registry()
    doc = {"time": time.time(), "metrics": registry.snapshot()}
    if fleet is not None:
        doc["fleet"] = fleet.snapshot()
    if extra:
        doc.update(extra)
    return json.dumps(doc, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# Periodic JSON file dump

class MetricsFileWriter:
    """Daemon thread dumping a JSON snapshot every `interval` seconds.
    Writes are atomic (tmp + rename) so a scraper never reads a torn
    file; a final dump runs at stop() so shutdown state is captured."""

    def __init__(self, path: str, registry: Optional[telemetry.MetricsRegistry] = None,
                 fleet: Optional[telemetry.FleetView] = None,
                 interval: float = 30.0, rank: int = 0):
        self.path = path.replace("{rank}", str(rank))
        self.registry = registry or telemetry.default_registry()
        self.fleet = fleet
        self.interval = max(interval, 0.05)
        self.rank = rank
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-metrics-file", daemon=True
        )

    def start(self) -> "MetricsFileWriter":
        self._thread.start()
        return self

    def _dump(self):
        try:
            atomic_file.atomic_write_text(
                self.path,
                to_json(self.registry, self.fleet,
                        extra={"rank": self.rank}))
        except OSError as e:  # an unwritable path must not kill the job
            logger.warning("metrics file dump to %s failed: %s", self.path, e)

    def _loop(self):
        while not self._stop.wait(self.interval):
            self._dump()
        self._dump()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# Live HTTP endpoint (rank 0)

class _Handler(BaseHTTPRequestHandler):
    server_version = "hvd-metrics"

    def _send(self, code: int, body: str, ctype: str):
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 (http.server API)
        srv: "MetricsHTTPServer" = self.server.owner  # type: ignore[attr-defined]
        try:
            if self.path.startswith("/metrics.json"):
                self._send(200, to_json(srv.registry, srv.fleet),
                           "application/json")
            elif self.path.startswith("/metrics"):
                self._send(200, to_prometheus(srv.registry),
                           "text/plain; version=0.0.4; charset=utf-8")
            else:
                # Registered views (add_view): /<name> serves whatever
                # the provider returns: dicts render as JSON, strings
                # pass through verbatim (pre-rendered documents).
                name = self.path.lstrip("/").split("?")[0].split("/")[0]
                fn = srv.get_view(name)
                if fn is None:
                    views = ", ".join("/" + v for v in srv.view_names())
                    self._send(404, f"not found: try /metrics, "
                               f"/metrics.json{', ' + views if views else ''}"
                               "\n", "text/plain")
                else:
                    body = fn()
                    if isinstance(body, str):
                        self._send(200, body, "application/json")
                    else:
                        self._send(200, json.dumps(body, indent=1,
                                                   sort_keys=True),
                                   "application/json")
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper hung up mid-response; nothing left to answer
        except Exception as e:  # a broken provider must not kill the server
            try:
                self._send(500, f"error: {e}\n", "text/plain")
            except OSError:  # pragma: no cover - peer gone during the 500
                pass

    def log_message(self, fmt, *args):
        logger.debug("metrics http: " + fmt, *args)


class MetricsHTTPServer:
    """Daemon-thread HTTP server for /metrics and /metrics.json plus
    pluggable views: each `add_view(name, fn)` registration serves the
    provider's result at `/<name>` (dicts as JSON, strings verbatim).
    The engine registers "status"; planes that come and go register and
    remove their own views instead of threading constructor kwargs
    through this module.
    `port=0` binds an ephemeral port (tests); read it back via `.port`."""

    def __init__(self, port: int,
                 registry: Optional[telemetry.MetricsRegistry] = None,
                 fleet: Optional[telemetry.FleetView] = None,
                 status_fn: Optional[Callable[[], dict]] = None,
                 addr: str = "127.0.0.1"):
        self.registry = registry or telemetry.default_registry()
        self.fleet = fleet
        self._views: dict = {}
        self._views_lock = threading.Lock()
        if status_fn is not None:
            self.add_view("status", status_fn)
        self._httpd = ThreadingHTTPServer((addr, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-metrics-http",
            daemon=True,
        )

    # -- pluggable views -------------------------------------------------
    def add_view(self, name: str, fn: Callable[[], object]
                 ) -> "MetricsHTTPServer":
        """Serve `fn()` at `/<name>`. Reserved names (the metrics
        renderers) are rejected; re-registering a name replaces the
        previous provider (latest owner wins, like Gauge.set_function)."""
        if not name or not all(c.isalnum() or c in "_-" for c in name):
            raise ValueError(f"invalid view name {name!r}")
        # "metrics.json" needs no reservation: dots already fail the
        # charset check above.
        if name == "metrics":
            raise ValueError(f"view name {name!r} is reserved")
        with self._views_lock:
            self._views[name] = fn
        return self

    def remove_view(self, name: str, fn: Optional[Callable] = None):
        """Detach a view — the teardown contract for owners going away.
        Pass the provider you registered to detach only if you are still
        the current owner (a replacement may have taken the name over);
        None detaches unconditionally."""
        with self._views_lock:
            if fn is None or self._views.get(name) == fn:
                self._views.pop(name, None)

    def get_view(self, name: str) -> Optional[Callable[[], object]]:
        with self._views_lock:
            return self._views.get(name)

    def view_names(self) -> list:
        with self._views_lock:
            return sorted(self._views)

    def start(self) -> "MetricsHTTPServer":
        self._thread.start()
        logger.info("metrics endpoint serving on :%d (/metrics, /status)",
                    self.port)
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# Env-driven lifecycle (the engine's start in process mode, ``init`` in
# mesh mode; see common/basics.py).

def start_exporters_from_env(
    registry: Optional[telemetry.MetricsRegistry] = None,
    fleet: Optional[telemetry.FleetView] = None,
    status_fn: Optional[Callable[[], dict]] = None,
    rank: int = 0,
):
    """Start the exporters the environment asks for. Returns a list of
    started exporter objects (each has .stop()). The HTTP endpoint only
    starts on rank 0 — it serves the fleet view; the JSON file dump runs
    on rank 0 too unless the path contains `{rank}` (then every rank
    writes its own file)."""
    started = []
    path = env_cfg.get_str(env_cfg.METRICS_FILE)
    if path and (rank == 0 or "{rank}" in path):
        # Interval <= 0 disables, matching HOROVOD_METRICS_SYNC_SECONDS
        # (not "dump as fast as possible").
        interval = env_cfg.get_float(env_cfg.METRICS_FILE_INTERVAL, 30.0)
        if interval > 0:
            started.append(MetricsFileWriter(
                path, registry, fleet, interval=interval, rank=rank
            ).start())
    port = env_cfg.get_int(env_cfg.METRICS_PORT, -1)
    if port >= 0 and rank == 0:
        # Loopback by default: the endpoint is unauthenticated, so
        # network exposure (remote Prometheus scrapers) is the explicit
        # opt-in, matching the rendezvous server's HMAC-everything
        # posture.
        addr = env_cfg.get_str(env_cfg.METRICS_ADDR, "127.0.0.1")
        try:
            started.append(MetricsHTTPServer(
                port, registry, fleet, status_fn=status_fn, addr=addr,
            ).start())
        except OSError as e:
            logger.warning("metrics endpoint on port %d failed to start: %s",
                           port, e)
    return started
