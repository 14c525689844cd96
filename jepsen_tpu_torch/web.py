"""The store's HTTP server: the fleet's control plane and the metrics
scrape (the port's copy of the machine routes of `jepsen_tpu/web.py`).

A small threaded HTTP server over the store directory (stdlib
``http.server``).  The routes the fleet speaks are here:

- ``POST /fleet/<verb>`` (register / claim / heartbeat / complete /
  release) and ``POST /fleet/artifact/<run-id>`` (the chunked run-dir
  upload, its size cap checked before the body is read), routed to the
  attached `fleet.FleetCoordinator`; every POST runs under the request's
  ``Jepsen-Trace`` context;
- ``GET /fleet/status`` (joined with the attached verifier's per-host
  verdict freshness) and ``GET /fleet/cache[/<name>]``;
- ``GET /metrics``, the Prometheus text exposition of the live
  registry, the store's campaigns and warehouse, and the attached
  fleet's federated worker series.

The JAX module's HTML pages (the run table, files, zips, campaigns,
live views, timelines, the fleet and alert dashboards) and the
verifier's ``/ingest``, ``/verifier/`` and ``/verdict/`` routes are not
ported yet (ROADMAP A4): every other GET answers 404 as an unknown path
does in the JAX module, and the verifier's POSTs answer the JAX
module's 404 "no verifier service" when none is attached, and a 404
naming ROADMAP A4 when one is.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import unquote, urlparse

from . import store

logger = logging.getLogger("jepsen.web")

__all__ = ["serve"]

_NO_FLEET = {"error": "no fleet coordinator (start with "
                      "`fleet serve <spec.json>`)"}


class _Handler(BaseHTTPRequestHandler):
    base: str = store.BASE  # overridden per-server
    verifier = None         # VerifierService: the status freshness join
    fleet = None            # FleetCoordinator when served via fleet serve

    # -- helpers ----------------------------------------------------------

    def _send(self, code: int, content: bytes,
              ctype: str = "text/html; charset=utf-8",
              extra: Optional[Dict[str, str]] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(content)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(content)

    def _send_json(self, code: int, doc: Any) -> None:
        self._send(code, json.dumps(doc, indent=1, sort_keys=True,
                                    default=str).encode(),
                   "application/json")

    def _read_body(self) -> bytes:
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            n = 0
        return self.rfile.read(n) if n > 0 else b""

    def _safe_path(self, rel: str) -> Optional[str]:
        """Resolve a store-relative path, refusing traversal outside it."""
        base = os.path.realpath(self.base)
        p = os.path.realpath(os.path.join(base, rel))
        if p == base or p.startswith(base + os.sep):
            return p
        return None

    # -- routes -----------------------------------------------------------

    def do_GET(self):  # noqa: N802 (stdlib API)
        try:
            path = unquote(urlparse(self.path).path)
            if path == "/metrics":
                return self._metrics()
            if path == "/fleet/status":
                return self._fleet_status()
            if path in ("/fleet/cache", "/fleet/cache/"):
                return self._fleet_cache("")
            if path.startswith("/fleet/cache/"):
                return self._fleet_cache(
                    path[len("/fleet/cache/"):].strip("/"))
            self._send(404, b"not found", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001
            logger.exception("web handler error")
            self._send(500, f"error: {e}".encode(), "text/plain")

    def do_POST(self):  # noqa: N802 (stdlib API)
        """The fleet control plane (docs/FLEET.md), routed when the
        server was started with a coordinator attached (``fleet
        serve``).  Every POST runs under the request's ``Jepsen-Trace``
        context: the header, when present, is parsed and installed
        thread-locally so the coordinator and the artifact store stitch
        the request onto its run's distributed trace."""
        from .telemetry import spans as spans_mod

        ctx = spans_mod.parse_trace_header(
            self.headers.get(spans_mod.TRACE_HEADER))
        with spans_mod.trace_scope(ctx):
            self._do_post()

    def _do_post(self):
        try:
            parsed = urlparse(self.path)
            path = unquote(parsed.path)
            if path.startswith("/fleet/artifact/"):
                return self._fleet_artifact(
                    path[len("/fleet/artifact/"):].strip("/"),
                    parsed.query or "")
            if path.startswith("/fleet/"):
                return self._fleet_post(path[len("/fleet/"):].strip("/"))
            if self.verifier is None:
                return self._send_json(
                    404, {"error": "no verifier service (start with "
                          "`serve --ingest`)"})
            if path.startswith(("/ingest/", "/verifier/")):
                return self._send_json(
                    404, {"error": "the verifier's HTTP routes are not "
                          "ported yet (ROADMAP A4)"})
            self._send_json(404, {"error": "not found"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001
            logger.exception("web POST handler error")
            self._send_json(500, {"error": str(e)})

    def _metrics(self):
        """Prometheus text exposition (docs/TELEMETRY.md): the live
        registry's counters/gauges/histograms, federated fleet worker
        series (``host=``-labeled, retired with worker liveness),
        campaign heartbeat freshness, and warehouse rollup gauges."""
        from .telemetry import prometheus as prom

        body = prom.exposition(base=self.base, fleet=self.fleet)
        self._send(200, body.encode(), prom.CONTENT_TYPE)

    # -- fleet control plane (docs/FLEET.md) ------------------------------

    def _fleet_post(self, verb: str):
        """``POST /fleet/<verb>`` — the coordinator's control plane:
        register / claim / heartbeat / complete / release.  JSON in,
        JSON out; only routed when a `FleetCoordinator` is attached
        (``fleet serve``)."""
        if self.fleet is None:
            return self._send_json(404, _NO_FLEET)
        handlers = {
            "register": self.fleet.register,
            "claim": self.fleet.claim,
            "heartbeat": self.fleet.heartbeat,
            "complete": self.fleet.complete,
            "release": self.fleet.release,
        }
        fn = handlers.get(verb)
        if fn is None:
            return self._send_json(404,
                                   {"error": f"unknown verb {verb!r}"})
        body = self._read_body()
        doc: Dict[str, Any] = {}
        if body.strip():
            try:
                doc = json.loads(body)
            except ValueError:
                return self._send_json(400, {"error": "bad json body"})
            if not isinstance(doc, dict):
                return self._send_json(400,
                                       {"error": "body must be a dict"})
        code, out = fn(doc)
        self._send_json(code, out)

    def _fleet_artifact(self, run_id: str, query: str):
        """``POST /fleet/artifact/<run-id>`` — the store-federation
        upload seam (docs/FLEET.md): chunked run-dir upload, resumable
        by byte cursor, digest-verified, idempotent."""
        if self.fleet is None:
            return self._send_json(404, _NO_FLEET)
        from urllib.parse import parse_qs

        from .fleet.artifacts import MAX_ARTIFACT_BYTES

        # cap BEFORE buffering the body: the protocol-level total
        # check runs after the read, which would let one oversized
        # POST balloon the coordinator's RSS past the artifact cap
        try:
            clen = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            clen = 0
        if clen > MAX_ARTIFACT_BYTES:
            return self._send_json(
                413, {"error": "request body exceeds the artifact "
                      "size cap"})
        params = {k: v[0] for k, v in parse_qs(query).items()}
        code, doc = self.fleet.artifact(run_id, params,
                                        self._read_body())
        self._send_json(code, doc)

    def _fleet_cache(self, name: str):
        """``GET /fleet/cache`` (the entry advert, empty in the port)
        and ``GET /fleet/cache/<name>`` (404: the port has no compile
        cache); only routed with a coordinator attached."""
        if self.fleet is None:
            return self._send_json(404, _NO_FLEET)
        if not name:
            code, doc = self.fleet.cache_index()
        else:
            code, doc = self.fleet.cache_blob(name)
        self._send_json(code, doc)

    def _fleet_status_doc(self):
        """The coordinator's status, enriched with the co-hosted
        verifier's per-host verdict freshness: last heartbeat age says
        a worker is ALIVE, verdict freshness says its live-check stream
        is actually being VERIFIED (ingest lag on the verifier's own
        clock, no worker clock correction needed)."""
        code, doc = self.fleet.status()
        if code == 200 and self.verifier is not None:
            try:
                fresh = self.verifier.host_freshness()
                if fresh:
                    doc["verifier-freshness"] = fresh
                for w, row in (doc.get("workers") or {}).items():
                    if w in fresh:
                        row["verdict-freshness-s"] = \
                            fresh[w]["freshness-s"]
                        row["live-sessions"] = fresh[w]["sessions"]
            except Exception:  # noqa: BLE001 — decorative join
                logger.debug("verifier freshness join failed",
                             exc_info=True)
        return code, doc

    def _fleet_status(self):
        if self.fleet is None:
            return self._send_json(404, _NO_FLEET)
        code, doc = self._fleet_status_doc()
        self._send_json(code, doc)

    def log_message(self, fmt, *args):  # quiet by default
        logger.debug("web: " + fmt, *args)


def serve(port: int = 8080, base: Optional[str] = None, *,
          host: str = "127.0.0.1",
          background: bool = False,
          verifier: Any = None,
          fleet: Any = None) -> ThreadingHTTPServer:
    """Serve the store dir.  Binds localhost by default — stored test
    maps can hold cluster details; pass host="0.0.0.0" explicitly to
    expose.  With background=True, runs in a daemon thread and returns
    the server, whose ``server_close`` stops and joins that thread
    (tests use this).  Pass a `fleet.FleetCoordinator` to route the
    fleet control plane (``fleet serve``; docs/FLEET.md), and a
    `verifier.VerifierService` to join its verdict freshness into
    ``/fleet/status``."""
    handler = type("Handler", (_Handler,), {"base": base or store.BASE,
                                            "verifier": verifier,
                                            "fleet": fleet})
    srv = ThreadingHTTPServer((host, port), handler)
    logger.info("serving store %s on port %d%s%s", base or store.BASE,
                port,
                " (verifier attached)" if verifier is not None else "",
                " (fleet control plane on)" if fleet is not None else "")
    if background:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        # make server_close STOP the loop first: closing the socket
        # under a live serve_forever leaves that thread select()ing on
        # a closed fd — which returns ready instantly, i.e. a leaked
        # CPU-spinning thread per server
        orig_close = srv.server_close

        def _close_and_stop() -> None:
            srv.shutdown()       # returns once serve_forever exited
            t.join(timeout=5)
            orig_close()

        srv.server_close = _close_and_stop  # type: ignore[assignment]
        return srv
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return srv
