"""Live observability endpoint: a stdlib ``http.server`` thread.

``TFCluster.serve_observability(port)`` mounts the driver's live views on
a plain ThreadingHTTPServer — no framework dependency, matching the
reference's "bring your own serving" posture while still giving operators
(and Prometheus) a scrape target during a run instead of only post-mortem
artifacts:

- ``GET /metrics``  → Prometheus text exposition (v0.0.4) of the merged
  cluster metrics (``TFCluster.metrics_prometheus()``);
- ``GET /healthz``  → JSON node-health rollup from the per-node kv
  blackboards; HTTP 200 when every node is reachable and un-failed,
  503 otherwise (load-balancer semantics);
- ``GET /trace``    → the merged Chrome-trace JSON document
  (``TFCluster.dump_trace`` content, without touching disk).

The server itself is generic: routes are ``{path: callable}`` where each
callable returns ``(status_code, content_type, body)``.  A handler that
raises becomes a 500 with the error text — the endpoint must never take
the driver down.  Request logging goes to the module logger at DEBUG (the
default ``BaseHTTPRequestHandler`` stderr spam would pollute driver logs).
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

logger = logging.getLogger(__name__)

#: content type for Prometheus text exposition format
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
#: content type for the OpenMetrics flavor (exemplar-capable) — served
#: when the scraper's Accept header asks for it
OPENMETRICS_CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8")

#: GET route: no-arg callable → ``(status, content_type, body)`` or
#: ``(status, content_type, body, extra_headers)``.  ``body`` may be
#: bytes/str (sent with Content-Length) or any other iterable of
#: bytes/str chunks — a STREAMING reply, sent with ``Transfer-Encoding:
#: chunked`` so HTTP/1.1 keep-alive connections stay in sync (a
#: content-length-less body would otherwise desync the persistent
#: connection: the peer cannot tell where the reply ends and parses the
#: next response's bytes as body, or vice versa).
Route = Callable[[], tuple]
#: POST route: ``(body_bytes, request_headers)`` → the same reply tuple
#: shape.  The handler never parses the body itself — interpretation
#: (JSON, propagated ``traceparent``, …) belongs to the route.
PostRoute = Callable[[bytes, Any], tuple]


def with_headers(fn: Callable[[Any], tuple]) -> Callable[[], tuple]:
    """Mark a GET route as wanting the request headers.

    A plain GET route is a no-arg callable; some routes need the
    request headers — content negotiation on ``/fleet/metrics`` serves
    the OpenMetrics flavor only when ``Accept:
    application/openmetrics-text`` asks for it.  Wrapping the handler
    with this marker makes the server call it as ``fn(headers)``
    instead, without per-request signature inspection on every route.
    """
    def route(headers):
        return fn(headers)

    # a wrapper (not an attribute on fn): bound methods reject attribute
    # writes, and the common registrant IS a bound method
    route.wants_headers = True  # type: ignore[attr-defined]
    return route


def with_query(fn: Callable[[dict], tuple]) -> Callable[[], tuple]:
    """Mark a GET route as wanting the parsed query parameters.

    The handler strips the query string before route lookup (a path is a
    path), so a route that paginates — ``/fleet/events?since=<cursor>``
    — opts in with this marker and is called as ``fn(query)`` with a
    flat ``{key: last_value}`` dict (repeated keys keep the last value,
    the usual single-valued-parameter reading)."""
    def route(query):
        return fn(query)

    route.wants_query = True  # type: ignore[attr-defined]
    return route


def wants_openmetrics(headers: Any) -> bool:
    """Does the scraper's Accept header ask for the OpenMetrics flavor?"""
    accept = (headers.get("Accept", "") if headers is not None else "") or ""
    return "application/openmetrics-text" in accept


class ObservabilityServer:
    """Threaded HTTP server over a route table; start() → (host, port).

    ``routes`` serves GETs; ``post_routes`` (optional) serves POSTs —
    the serving-mesh router front end mounts ``POST /v1/predict`` here
    beside its read-only views.  Either kind of route may return a
    4-tuple whose last element is an extra-headers dict (e.g. a 429's
    ``Retry-After``).
    """

    def __init__(self, routes: dict[str, Route], host: str = "127.0.0.1",
                 port: int = 0,
                 post_routes: dict[str, PostRoute] | None = None):
        self.routes = dict(routes)
        self.post_routes = dict(post_routes or {})
        self._host = host
        self._port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> tuple[str, int]:
        routes = self.routes
        post_routes = self.post_routes

        class _Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every reply carries Content-Length, so
            # persistent connections are safe — scrapers and the mesh
            # router's health poll reuse one connection instead of paying
            # a reconnect per request
            protocol_version = "HTTP/1.1"

            def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                route = routes.get(path)
                if route is None:
                    body = json.dumps(
                        {"error": "not found",
                         "routes": sorted(routes)}).encode()
                    self._reply(404, "application/json", body)
                    return
                if getattr(route, "wants_headers", False):
                    headers = self.headers
                    self._run_route(path, lambda: route(headers))
                elif getattr(route, "wants_query", False):
                    from urllib.parse import parse_qs

                    raw = self.path.split("?", 1)
                    qs = parse_qs(raw[1], keep_blank_values=True) \
                        if len(raw) == 2 else {}
                    query = {k: v[-1] for k, v in qs.items()}
                    self._run_route(path, lambda: route(query))
                else:
                    self._run_route(path, route)

            def do_POST(self) -> None:  # noqa: N802 (stdlib naming)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                route = post_routes.get(path)
                # ALWAYS drain the body before replying: under HTTP/1.1
                # keep-alive an unread body stays in the socket buffer
                # and is parsed as the NEXT request line, desyncing the
                # connection (the 404 path used to skip the read)
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    payload = self.rfile.read(length) if length else b""
                except (OSError, ValueError) as e:
                    self._reply(400, "application/json", json.dumps(
                        {"error": f"unreadable body: {e}"}).encode())
                    self.close_connection = True  # body state unknown
                    return
                if route is None:
                    body = json.dumps(
                        {"error": "not found",
                         "routes": sorted(post_routes)}).encode()
                    self._reply(404, "application/json", body)
                    return
                self._run_route(path, lambda: route(payload, self.headers))

            def _run_route(self, path: str, route: Callable) -> None:
                try:
                    result = route()
                    if len(result) == 4:
                        status, ctype, body, extra = result
                    else:
                        status, ctype, body = result
                        extra = None
                except Exception as e:  # endpoint must never kill the driver
                    logger.warning("observability route %s failed: %s",
                                   path, e)
                    self._reply(500, "text/plain; charset=utf-8",
                                f"handler error: {e}".encode())
                    return
                if isinstance(body, str):
                    body = body.encode()
                if isinstance(body, bytes):
                    self._reply(status, ctype, body, extra)
                else:
                    self._reply_stream(status, ctype, body, extra)

            def _reply(self, status: int, ctype: str, body: bytes,
                       extra_headers: dict | None = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def _reply_stream(self, status: int, ctype: str, chunks,
                              extra_headers: dict | None = None) -> None:
                """Stream an iterable body.

                A reply with neither Content-Length nor chunked framing
                has no end marker, so a keep-alive peer would read the
                NEXT response's bytes as this body — the connection
                desync family the POST drain-body fix addressed.  An
                HTTP/1.1 client gets ``Transfer-Encoding: chunked`` (the
                connection stays reusable); an HTTP/1.0 client cannot
                parse chunked framing, so it gets the raw bytes and the
                connection closes to delimit the body.
                """
                chunked = self.request_version != "HTTP/1.0"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                if chunked:
                    self.send_header("Transfer-Encoding", "chunked")
                else:
                    self.close_connection = True
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                try:
                    for chunk in chunks:
                        if isinstance(chunk, str):
                            chunk = chunk.encode()
                        if not chunk:
                            continue
                        if chunked:
                            self.wfile.write(b"%x\r\n" % len(chunk))
                            self.wfile.write(chunk)
                            self.wfile.write(b"\r\n")
                        else:
                            self.wfile.write(chunk)
                        self.wfile.flush()
                    if chunked:
                        self.wfile.write(b"0\r\n\r\n")
                except Exception as e:
                    # headers (and possibly chunks) are already on the
                    # wire: the status cannot change, so the only honest
                    # signal is TRUNCATION — drop the connection without
                    # the terminal chunk instead of leaving the peer's
                    # framing desynced on a reused connection
                    logger.warning("streaming reply truncated: %s", e)
                    self.close_connection = True
                    # close the body iterator NOW (not at GC): a
                    # generator producer may be metering real work per
                    # chunk (the decode tier cancels its generation on
                    # GeneratorExit) and must learn the peer is gone at
                    # the break, not whenever the collector runs
                    close = getattr(chunks, "close", None)
                    if close is not None:
                        try:
                            close()
                        except Exception:
                            pass

            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("observability http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self._host, self._port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tfos-observability-http",
            daemon=True)
        self._thread.start()
        return self.address

    @property
    def address(self) -> tuple[str, int]:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return self.address[1]

    def url(self, path: str = "/") -> str:
        host, port = self.address
        return f"http://{host}:{port}{path}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def _split_exemplar(line: str) -> tuple[str, str | None]:
    """Split a sample line from its optional exemplar annotation.

    The separator is `` # {`` OUTSIDE any quoted label value — a sample
    like ``m{path="/a # b"} 1`` (or a value containing `` # {``) must
    not be mis-split into a bogus exemplar.
    """
    i = line.find(" # {")
    while i >= 0:
        if line.count('"', 0, i) % 2 == 0:  # even quotes = outside values
            return line[:i].rstrip(), line[i + 3:]
        i = line.find(" # {", i + 1)
    return line, None


def validate_prometheus_text(text: str, *,
                             openmetrics: bool = False) -> list[str]:
    """Schema-check Prometheus text exposition; returns problems.

    The ``tools/check_trace.py``-style gate for the ``/metrics`` route:
    every non-comment line must parse as ``name{labels} value``, every
    ``# TYPE`` names a known type, no metric family gets two TYPE lines
    (the text-format violation scrapers reject), and every sample's family
    was declared.  Empty exposition is valid (no instruments yet).

    Exemplar annotations (`` # {trace_id="..."} value [ts]``) are
    accepted on ``_bucket`` sample lines in either mode and validated for
    syntax and the OpenMetrics 128-rune label budget; label blocks are
    parsed quote-aware (a ``}`` or ``#`` inside a quoted value never
    splits the line) and checked against the ``name="escaped value"``
    pair grammar.  ``openmetrics=True`` additionally requires the
    terminal ``# EOF`` line (and nothing after it) — use
    :func:`validate_openmetrics_text` for that entry point.
    """
    import re

    problems: list[str] = []
    typed: dict[str, str] = {}
    # the label block is quote-aware: a '}' inside a quoted value (e.g.
    # path="a}b") must not terminate it early
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
        r"(\{(?:[^\"{}]|\"(?:[^\"\\]|\\.)*\")*\})?\s+(\S+)$")
    label_block_re = re.compile(
        r"^\{(?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
        r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*,?)?\}$")
    exemplar_re = re.compile(
        r"^\{([a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
        r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*)?\}"
        r"\s+(\S+)(\s+\S+)?$")
    exemplar_label_re = re.compile(
        r"([a-zA-Z_][a-zA-Z0-9_]*)=\"((?:[^\"\\]|\\.)*)\"")
    saw_eof = False
    for i, line in enumerate(text.splitlines()):
        line = line.rstrip()
        if not line:
            continue
        where = f"line {i + 1}"
        if saw_eof:
            problems.append(f"{where}: content after the '# EOF' "
                            "terminator")
            break
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    problems.append(f"{where}: malformed TYPE comment")
                    continue
                name = parts[2]
                if name in typed:
                    problems.append(
                        f"{where}: duplicate TYPE for {name} "
                        "(one family, one TYPE line)")
                typed[name] = parts[3]
            elif line == "# EOF":
                saw_eof = True
            continue
        line, exemplar = _split_exemplar(line)
        m = sample_re.match(line)
        if not m:
            problems.append(f"{where}: unparseable sample {line!r}")
            continue
        if m.group(2) and not label_block_re.match(m.group(2)):
            problems.append(
                f"{where}: malformed label block {m.group(2)!r} "
                "(expected name=\"escaped value\" pairs)")
        value = m.group(3)
        if value not in ("+Inf", "-Inf", "NaN"):
            try:
                float(value)
            except ValueError:
                problems.append(
                    f"{where}: non-numeric sample value {value!r}")
        name = m.group(1)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed:
                base = name[: -len(suffix)]
                break
        if base not in typed:
            problems.append(f"{where}: sample {name!r} has no TYPE "
                            "declaration")
        if exemplar is not None:
            if not name.endswith("_bucket"):
                problems.append(
                    f"{where}: exemplar on a non-bucket sample {name!r}")
            em = exemplar_re.match(exemplar)
            if not em:
                problems.append(
                    f"{where}: malformed exemplar {exemplar!r}")
            else:
                try:
                    float(em.group(2))
                except ValueError:
                    problems.append(
                        f"{where}: non-numeric exemplar value "
                        f"{em.group(2)!r}")
                runes = sum(len(k) + len(v) for k, v in
                            exemplar_label_re.findall(em.group(1) or ""))
                if runes > 128:
                    problems.append(
                        f"{where}: exemplar label set is {runes} runes "
                        "(OpenMetrics caps name+value length at 128)")
    if openmetrics and not saw_eof:
        problems.append("missing the terminal '# EOF' line (OpenMetrics "
                        "requires it)")
    return problems


def validate_openmetrics_text(text: str) -> list[str]:
    """Schema-check the OpenMetrics flavor: everything
    :func:`validate_prometheus_text` checks, plus exemplar syntax and the
    mandatory terminal ``# EOF``."""
    return validate_prometheus_text(text, openmetrics=True)
