"""Copy of ``uigc_tpu/telemetry/exporter.py`` (pure Python), held against
it by ``tests/test_torch_telemetry.py``.

Exporters: Prometheus text exposition, localhost HTTP, JSONL events.

Three ways out of the process:

- :func:`prometheus_text` renders a :class:`MetricsRegistry` in the
  Prometheus text exposition format (``# HELP``/``# TYPE`` headers,
  ``name{labels} value`` samples, cumulative ``_bucket{le=...}``
  histogram series).
- :class:`MetricsHTTPServer` serves that text on ``127.0.0.1`` at
  ``/metrics`` (plus a JSON snapshot at ``/metrics.json``) from a
  daemon thread — the minimal scrape handle, deliberately loopback-only.
- :class:`JsonlEventSink` persists every committed recorder event as
  one JSON line; :func:`replay_jsonl` streams a written file back as
  ``(name, fields)`` pairs, the exact shape
  :meth:`uigc_tpu.analysis.race.RaceDetector.feed` ingests, so a
  production event log replays into the race detector (and the
  sanitizer's violation record, :func:`replay_violations`) offline.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterator, List, Optional, TextIO, Tuple

from .metrics import MetricsRegistry

# ------------------------------------------------------------------- #
# Prometheus text exposition
# ------------------------------------------------------------------- #


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _render_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{name}="{_escape_label_value(value)}"' for name, value in labels
    )
    return "{" + inner + "}"


def _render_value(value: float) -> str:
    """Exposition-format value: integers bare, floats via repr, and the
    non-finite spellings the format defines — a user callback gauge
    returning inf/NaN must not kill the whole scrape."""
    value = float(value)
    if not math.isfinite(value):
        if math.isnan(value):
            return "NaN"
        return "+Inf" if value > 0 else "-Inf"
    return str(int(value)) if value == int(value) else repr(value)


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render every metric in the registry as Prometheus exposition
    text (version 0.0.4)."""
    lines: List[str] = []
    seen_header = set()
    for metric, suffix, labels, value in registry.collect():
        if metric.name not in seen_header:
            seen_header.add(metric.name)
            if metric.help_text:
                lines.append(f"# HELP {metric.name} {metric.help_text}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
        lines.append(
            f"{metric.name}{suffix}{_render_labels(labels)} {_render_value(value)}"
        )
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------------- #
# Localhost HTTP handle
# ------------------------------------------------------------------- #


class MetricsHTTPServer:
    """Serve ``/metrics`` (Prometheus text), ``/metrics.json`` and
    ``/healthz`` on a loopback port from a daemon thread; with a
    liveness inspector attached (``uigc.telemetry.inspect``), also
    ``/snapshot`` (``?merged=1`` for the cluster-wide graph) and
    ``/inspect?actor=<path-or-key>`` (a why-live retaining path); with
    the time plane attached (``uigc.telemetry.timeseries``), also
    ``/timeseries`` (``?name=``/``?window=``/``?resolution=`` select a
    series and range, ``?merged=1`` pulls and merges the cluster's
    stores over the ``tsq``/``tsr`` frames) and ``/alerts`` (the
    anomaly/SLO engine's firing set and rule catalog); with the device
    observatory attached (``uigc.telemetry.device``), also ``/device``
    (the memory-ledger/compile-cache/transfer document
    ``tools/device_report.py`` renders).
    ``port=0`` binds an ephemeral port; read the bound one from
    :attr:`port`."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", inspector: Any = None,
                 node: str = "", store: Any = None, alerts: Any = None,
                 observatory: Any = None):
        self.registry = registry
        self.inspector = inspector
        self.node = node
        self.store = store
        self.alerts = alerts
        self.observatory = observatory
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                parsed = urllib.parse.urlsplit(self.path)
                route = parsed.path
                query = urllib.parse.parse_qs(parsed.query)
                if route.startswith("/metrics.json"):
                    body = json.dumps(outer.registry.snapshot(), default=repr)
                    ctype = "application/json"
                elif route.startswith("/metrics"):
                    body = prometheus_text(outer.registry)
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif route.startswith("/healthz"):
                    body = json.dumps(
                        {"status": "ok", "node": outer.node, "t": time.time()}
                    )
                    ctype = "application/json"
                elif route.startswith("/timeseries") and outer.store is not None:
                    try:
                        body = json.dumps(
                            outer._timeseries_doc(query), default=repr
                        )
                    except Exception as exc:
                        self._send_json_error(500, repr(exc))
                        return
                    ctype = "application/json"
                elif route.startswith("/device") and outer.observatory is not None:
                    try:
                        body = json.dumps(
                            outer.observatory.to_doc(), default=repr
                        )
                    except Exception as exc:
                        self._send_json_error(500, repr(exc))
                        return
                    ctype = "application/json"
                elif route.startswith("/alerts") and outer.alerts is not None:
                    try:
                        body = json.dumps(outer.alerts.to_doc(), default=repr)
                    except Exception as exc:
                        self._send_json_error(500, repr(exc))
                        return
                    ctype = "application/json"
                elif route.startswith("/snapshot") and outer.inspector is not None:
                    try:
                        body = outer.inspector.snapshot_json(
                            merged=query.get("merged", ["0"])[0]
                            in ("1", "true", "yes")
                        )
                    except Exception as exc:
                        self._send_json_error(500, repr(exc))
                        return
                    ctype = "application/json"
                elif route.startswith("/inspect") and outer.inspector is not None:
                    actor = query.get("actor", [""])[0]
                    if not actor:
                        self._send_json_error(400, "missing ?actor= parameter")
                        return
                    try:
                        body = outer.inspector.why_live_json(actor)
                    except Exception as exc:
                        self._send_json_error(500, repr(exc))
                        return
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                payload = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _send_json_error(self, code: int, message: str) -> None:
                payload = json.dumps({"error": message}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args: Any) -> None:
                pass  # scrape traffic must not spam stderr

        try:
            self._server = ThreadingHTTPServer((host, port), _Handler)
        except OSError:
            if port == 0:
                raise
            # A fixed port already bound (several systems sharing one
            # config dict in one process): degrade to an ephemeral port
            # instead of failing system construction.
            self._server = ThreadingHTTPServer((host, 0), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="uigc-telemetry-http",
            daemon=True,
        )
        self._thread.start()

    def _timeseries_doc(self, query: Dict[str, List[str]]) -> Dict[str, Any]:
        """The ``/timeseries`` body for one parsed query string."""

        def first(key: str, default: str = "") -> str:
            return query.get(key, [default])[0]

        name = first("name") or None
        window = float(first("window") or 0) or None
        merged = first("merged") in ("1", "true", "yes")
        if merged:
            q: Dict[str, Any] = {}
            if name:
                q["name"] = name
            if window:
                q["window"] = window
            return self.store.merged(q)
        if name is not None and first("labels_json"):
            # One exact series with its bucket dicts (the stable
            # range() shape); labels ride as a JSON object.
            labels = json.loads(first("labels_json"))
            return self.store.range(
                name,
                labels=labels,
                window_s=window or 120.0,
                resolution=float(first("resolution") or 0) or None,
            )
        return self.store.to_doc(name=name, window_s=window)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# ------------------------------------------------------------------- #
# JSONL event persistence + replay
# ------------------------------------------------------------------- #


class JsonlEventSink:
    """Recorder listener appending one JSON object per committed event:
    ``{"event": <name>, ...fields}``.  Values that are not JSON-native
    degrade to ``repr`` rather than breaking the commit path.

    Size-capped rotation (``uigc.telemetry.jsonl-max-bytes`` /
    ``jsonl-keep``): when the live file would exceed ``max_bytes``, it
    rotates to ``path.1`` (shifting ``path.1`` → ``path.2`` … and
    dropping the oldest beyond ``keep``) and a fresh file opens — a
    long chaos run holds at most ``(keep + 1) * max_bytes`` of events
    instead of growing without bound.  ``max_bytes=0`` (the default)
    disables rotation.  :func:`replay_jsonl` reads a rotated set oldest
    file first, so offline replay still sees one ordered stream."""

    def __init__(self, path: str, max_bytes: int = 0, keep: int = 3):
        self.path = path
        self.max_bytes = max(0, int(max_bytes))
        self.keep = max(0, int(keep))
        self._lock = threading.Lock()
        # Line-buffered: a crashed/killed process loses at most one torn
        # line, not an 8KB block of the events leading up to the crash —
        # which are exactly the ones offline replay needs.
        self._fh: Optional[TextIO] = open(path, "a", buffering=1)
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0

    def _rotate_locked(self) -> None:
        """Shift the rotated set one slot and reopen (caller holds the
        lock).  keep=0 degenerates to truncate-in-place."""
        fh = self._fh
        if fh is not None:
            fh.flush()
            fh.close()
        if self.keep:
            oldest = f"{self.path}.{self.keep}"
            if os.path.exists(oldest):
                try:
                    os.remove(oldest)
                except OSError:
                    pass
            for i in range(self.keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    try:
                        os.replace(src, f"{self.path}.{i + 1}")
                    except OSError:
                        pass
            try:
                os.replace(self.path, f"{self.path}.1")
            except OSError:
                pass
            self._fh = open(self.path, "a", buffering=1)
        else:
            self._fh = open(self.path, "w", buffering=1)
        self._bytes = 0

    def __call__(self, name: str, fields: Dict[str, Any]) -> None:
        line = json.dumps(dict(fields, event=name), default=repr) + "\n"
        with self._lock:
            if self._fh is None:
                return
            if self.max_bytes:
                # Count encoded bytes, not characters — non-ASCII field
                # values would otherwise blow past the cap on disk.
                size = len(line.encode("utf-8"))
                if self._bytes and self._bytes + size > self.max_bytes:
                    self._rotate_locked()
                self._fh.write(line)
                self._bytes += size
            else:
                self._fh.write(line)

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None


def jsonl_file_set(path: str) -> List[str]:
    """The rotated set for a sink path, oldest first: ``path.N`` …
    ``path.1`` then ``path`` itself (``path.N`` is the oldest —
    rotation shifts upward)."""
    rotated: List[Tuple[int, str]] = []
    directory = os.path.dirname(path) or "."
    base = os.path.basename(path)
    try:
        names = os.listdir(directory)
    except OSError:
        names = []
    for name in names:
        if name.startswith(base + "."):
            suffix = name[len(base) + 1 :]
            if suffix.isdigit():
                rotated.append((int(suffix), os.path.join(directory, name)))
    out = [p for _i, p in sorted(rotated, reverse=True)]
    if os.path.exists(path) or not out:
        out.append(path)
    return out


def replay_jsonl(path: str) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """Stream a JSONL event log back as ``(name, fields)`` pairs —
    feedable directly to ``RaceDetector.feed()`` or an
    :class:`~uigc_tpu.telemetry.metrics.EventMetricsBridge`.  A rotated
    set (``path.N`` … ``path.1`` ``path``) replays in write order,
    oldest file first.  Damaged lines (truncated tail of a crashed
    process) are skipped, not fatal."""
    for part in jsonl_file_set(path):
        try:
            fh = open(part)
        except OSError:
            continue
        with fh:
            for raw in fh:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    obj = json.loads(raw)
                except ValueError:
                    continue
                name = obj.pop("event", None)
                if isinstance(name, str):
                    yield name, obj


def replay_violations(path: str) -> List[Dict[str, Any]]:
    """Offline sanitizer view of a persisted event log: the
    ``analysis.violation`` records (rule + evidence fields) the online
    sanitizer emitted during the run."""
    return [
        fields for name, fields in replay_jsonl(path) if name == "analysis.violation"
    ]
