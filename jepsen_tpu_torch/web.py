"""Web UI for browsing the test store, with the verifier's ingest surface
and the fleet's control plane (the port's copy of `jepsen_tpu/web.py`).

Equivalent of the reference's `jepsen/src/jepsen/web.clj` (SURVEY.md §2.1,
§3.5): a small threaded HTTP server over the store directory — a run table
(name, timestamp, verdict), per-run file browsing, and zip download of a
whole run.  Stdlib-only (http.server), replacing the reference's http-kit.

Routes:

- the store's pages: ``/`` (the run table), ``/run/<dir>[/witness]``,
  ``/files/<path>``, ``/zip/<dir>``, ``/telemetry/<dir>``,
  ``/live/<dir>``, ``/timeline/<run-id>``, ``/campaigns``,
  ``/campaign/<n>[/live|/trend|/forensics|/witness-diff]``,
  ``/profile/<n>``, ``/alerts`` and ``/metrics`` (the Prometheus text
  exposition);
- the verifier's: ``POST /ingest/<s>?cursor=`` and ``POST
  /verifier/<s>/{open,seal,compact,expire}`` when a
  `verifier.VerifierService` is attached (``serve --ingest``), ``GET
  /verdict/<s>``, ``/verifier`` and ``/verifier/<s>`` with one or read
  only from the sessions' ``session.json`` without;
- the fleet's: ``POST /fleet/<verb>``, ``POST /fleet/artifact/<run>``,
  ``GET /fleet``, ``/fleet/status`` and ``/fleet/cache[/<name>]`` when a
  `fleet.FleetCoordinator` is attached (``fleet serve``).

Every page answers the JAX module's bytes over the same store; the
port's ``/fleet/cache`` advertises no entries (it has no compile cache),
and a device error in the attached service (`NoDeviceError`,
`KernelError`) answers 500 naming it.
"""

from __future__ import annotations

import html
import io
import json
import logging
import os
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import quote, unquote, urlparse

from . import store

logger = logging.getLogger("jepsen.web")

__all__ = ["serve"]

_NO_FLEET = {"error": "no fleet coordinator (start with "
                      "`fleet serve <spec.json>`)"}


def _run_summary(d: str) -> Dict[str, Any]:
    """Cheap summary of one run dir: verdict + attribution flags
    (deadline-expired, degraded-to-host) from results.json (fast path)
    or the .jepsen results block."""
    out: Dict[str, Any] = {
        "dir": d,
        "name": os.path.basename(os.path.dirname(d)),
        "timestamp": os.path.basename(d),
        "valid?": "?",
        "error": None,
        "degraded": None,
        "deadline": False,
    }
    rj = os.path.join(d, "results.json")
    try:
        if os.path.exists(rj):
            with open(rj) as f:
                res = json.load(f)
        else:
            res = store.load(d).get("results")
        if res:
            from .campaign.core import result_flags

            out["valid?"] = res.get("valid?", "?")
            out.update(result_flags(res))
    except Exception:  # noqa: BLE001 — a corrupt run still gets listed
        out["valid?"] = "corrupt"
    return out


#: shared badge CSS — every page that renders verdict cells embeds it
# /live pages stop auto-refreshing after this much write silence —
# crashed runs never emit "end", and the refresh re-parses the whole
# stream server-side each time
_LIVE_STALE_S = 300.0

_BADGE_CSS = """
.b { padding: 1px 7px; border-radius: 3px; white-space: nowrap; }
.b-true { background: #9ce29c; }
.b-false { background: #f2a3a3; }
.b-unknown { background: #ffd37a; }
.b-deadline { background: #ffb347; border: 1px solid #c07a2d; }
.b-degraded { background: #a8c8f0; border: 1px solid #5a82b4;
              font-size: 85%; margin-left: 4px; }
.b-witness { background: #e6d5f5; border: 1px solid #9a6fc0;
             font-size: 85%; margin-left: 4px; }
.b-other { background: #ddd; }
"""


def _verdict_badges(v: Any, error: Any = None, degraded: Any = None,
                    deadline: Any = None) -> str:
    """Verdict badge HTML: unknown-because-deadline and degraded-to-
    host runs get DISTINCT badges so they're tellable apart from plain
    unknowns/valids at a glance.  `deadline` takes
    a precomputed flag (campaign index records carry one); when absent
    it is derived from `error` with the canonical marker."""
    if deadline is None:
        from .resilience import DEADLINE_ERROR

        deadline = isinstance(error, str) and DEADLINE_ERROR in error
    cls = {"True": "b-true", "False": "b-false",
           "unknown": "b-unknown"}.get(str(v), "b-other")
    label = str(v)
    if deadline:
        cls = "b-deadline"
        label = f"{v} · deadline"
    out = f'<span class="b {cls}">{html.escape(label)}</span>'
    if degraded:
        out += (f'<span class="b b-degraded" title="device pipeline '
                f'degraded">{html.escape(str(degraded))}</span>')
    return out


def _verdict_cell(v: Any, error: Any = None, degraded: Any = None,
                  deadline: Any = None) -> str:
    return ('<td style="text-align:center">'
            f"{_verdict_badges(v, error, degraded, deadline)}</td>")


def _model_anomaly_html(e: Any, name: str = "") -> str:
    """Model-specific witness evidence (the invariants family + the
    queue family): bank bad-reads, long-fork/write-skew pairs, session
    violations, and kafka lost/duplicate/stale messages get readable
    renderings; anything unrecognized falls back to JSON."""
    if name == "lost-write" and isinstance(e, (list, tuple)) \
            and len(e) == 3:
        k, off, v = e
        return (f"<li>message <code>{html.escape(json.dumps(v))}</code> "
                f"on key <code>{html.escape(json.dumps(k))}</code>, acked "
                f"at offset <b>{off}</b>, was never polled although later "
                f"offsets of that key were — a lost write</li>")
    if name == "duplicate" and isinstance(e, (list, tuple)) \
            and len(e) == 3:
        k, v, offs = e
        return (f"<li>message <code>{html.escape(json.dumps(v))}</code> "
                f"on key <code>{html.escape(json.dumps(k))}</code> was "
                f"delivered at {len(offs)} distinct offsets "
                f"<code>{html.escape(json.dumps(list(offs)))}</code> — a "
                f"duplicate delivery</li>")
    if name == "inconsistent-offsets" and isinstance(e, (list, tuple)) \
            and len(e) == 3:
        k, off, vals = e
        return (f"<li>offset <b>{off}</b> of key "
                f"<code>{html.escape(json.dumps(k))}</code> was observed "
                f"holding {len(vals)} different values "
                f"<code>{html.escape(json.dumps(list(vals)))}</code></li>")
    if name == "stale-consumer-group" and isinstance(e, dict) \
            and "generation" in e:
        return (f"<li>consumer group generation <b>{e['generation']}</b> "
                f"re-polled key "
                f"<code>{html.escape(json.dumps(e.get('key')))}</code> from "
                f"offset <b>{e.get('start')}</b> {e.get('polls')} times "
                f"while the log moved past its window ({e.get('behind')} "
                f"poll(s) behind the key's head) — a stale consumer "
                f"group</li>")
    if not isinstance(e, dict):
        return f"<pre>{html.escape(json.dumps(e, indent=1))}</pre>"
    if "why" in e:  # long-fork / write-skew carry their own sentence
        extra = ""
        if e.get("keys") is not None:
            extra = f" <code>keys={html.escape(json.dumps(e['keys']))}</code>"
        return (f"<li>{html.escape(str(e['why']))}{extra}</li>")
    if "expected-total" in e:  # bank bad-read
        neg = (f"; negative balances on accounts "
               f"{html.escape(json.dumps(e['negative']))}"
               if e.get("negative") else "")
        return (f"<li>read at op {e.get('op-index')} (process "
                f"{e.get('process')}) summed to <b>{e.get('total')}</b>, "
                f"expected <b>{e.get('expected-total')}</b>{neg}</li>")
    if "key" in e and "process" in e and ("rank" in e or "read" in e
                                          or "wrote" in e):
        # session-guarantee violation (vectorized or walker entry)
        what = e.get("kind") or ("write" if "wrote" in e else "read")
        detail = ", ".join(
            f"{k}={json.dumps(e[k])}" for k in
            ("read", "wrote", "rank", "after-reading", "after-writing",
             "cross-key-dependency", "cross-key-prior-write")
            if k in e)
        return (f"<li>process {e.get('process')}, op {e.get('op')}: "
                f"{html.escape(what)} of key "
                f"<code>{html.escape(json.dumps(e.get('key')))}</code> "
                f"broke the guarantee ({html.escape(detail)})</li>")
    return f"<pre>{html.escape(json.dumps(e, indent=1))}</pre>"


class _Handler(BaseHTTPRequestHandler):
    base: str = store.BASE  # overridden per-server
    verifier = None         # VerifierService when served with --ingest
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
            if path in ("/", "/index.html"):
                return self._index()
            if path == "/metrics":
                return self._metrics()
            if path.startswith("/files/"):
                return self._files(path[len("/files/"):])
            if path.startswith("/zip/"):
                return self._zip(path[len("/zip/"):])
            if path.startswith("/telemetry/"):
                return self._telemetry(path[len("/telemetry/"):])
            if path.startswith("/live/"):
                return self._live(path[len("/live/"):])
            if path.startswith("/run/"):
                rel = path[len("/run/"):]
                if rel.rstrip("/").endswith("/witness"):
                    return self._witness(
                        rel.rstrip("/")[:-len("/witness")])
                return self._run(rel)
            if path in ("/campaigns", "/campaigns/"):
                return self._campaigns()
            if path.startswith("/campaign/"):
                rel = path[len("/campaign/"):].rstrip("/")
                if rel.endswith("/live"):
                    return self._campaign_live(rel[:-len("/live")])
                if rel.endswith("/witness-diff"):
                    return self._witness_diff(rel[:-len("/witness-diff")])
                if rel.endswith("/trend"):
                    return self._trend(rel[:-len("/trend")])
                if rel.endswith("/forensics"):
                    return self._forensics(rel[:-len("/forensics")])
                return self._campaign(rel)
            if path.startswith("/profile/"):
                return self._profile(path[len("/profile/"):])
            if path.startswith("/verdict/"):
                return self._verdict_json(path[len("/verdict/"):])
            if path in ("/verifier", "/verifier/"):
                return self._verifier_list()
            if path.startswith("/verifier/"):
                return self._verifier_session(path[len("/verifier/"):])
            if path in ("/alerts", "/alerts/"):
                return self._alerts_page()
            if path in ("/fleet", "/fleet/"):
                return self._fleet_page()
            if path == "/fleet/status":
                return self._fleet_status()
            if path in ("/fleet/cache", "/fleet/cache/"):
                return self._fleet_cache("")
            if path.startswith("/fleet/cache/"):
                return self._fleet_cache(
                    path[len("/fleet/cache/"):].strip("/"))
            if path.startswith("/timeline/"):
                return self._timeline(path[len("/timeline/"):])
            self._send(404, b"not found", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001
            logger.exception("web handler error")
            self._send(500, f"error: {type(e).__name__}: {e}".encode(),
                       "text/plain")

    def do_POST(self):  # noqa: N802 (stdlib API)
        """The verifier ingest surface (docs/VERIFIER.md) and the
        fleet control plane (docs/FLEET.md) — each only routed when
        the server was started with that service attached (``cli
        serve --ingest`` / ``cli fleet serve``).  Every POST runs
        under the request's ``Jepsen-Trace`` context: the
        header, when present, is parsed and installed thread-locally
        so the coordinator, verifier, and artifact store stitch the
        request onto its run's distributed trace."""
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
            if path.startswith("/ingest/"):
                name = path[len("/ingest/"):].strip("/")
                cursor = None
                for part in (parsed.query or "").split("&"):
                    if part.startswith("cursor="):
                        try:
                            cursor = int(part[len("cursor="):])
                        except ValueError:
                            return self._send_json(
                                400, {"error": "bad cursor"})
                code, doc = self.verifier.ingest(
                    name, self._read_body(), cursor=cursor)
                return self._send_json(code, doc)
            if path.startswith("/verifier/"):
                rest = path[len("/verifier/"):].strip("/")
                name, _, verb = rest.partition("/")
                if verb == "open":
                    cfg = None
                    body = self._read_body()
                    if body.strip():
                        try:
                            cfg = json.loads(body)
                        except ValueError:
                            return self._send_json(
                                400, {"error": "bad config json"})
                    code, doc = self.verifier.open(name, cfg)
                elif verb == "seal":
                    code, doc = self.verifier.seal(name)
                elif verb == "compact":
                    code, doc = self.verifier.compact(name)
                elif verb == "expire":
                    code, doc = self.verifier.expire(name)
                else:
                    code, doc = 404, {"error": f"unknown verb {verb!r}"}
                return self._send_json(code, doc)
            self._send_json(404, {"error": "not found"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001
            logger.exception("web POST handler error")
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    def _index(self):
        from .telemetry import alerts as alerts_mod
        from .telemetry import stream as tel_stream

        rows = []
        for d in store.tests(base=self.base):
            s = _run_summary(d)
            rel = os.path.relpath(d, self.base)
            links = []
            if os.path.exists(os.path.join(d, "telemetry.json")):
                links.append(f'<a href="/telemetry/{quote(rel)}">trace</a>')
            if tel_stream.events_path(d):
                # in-flight (or killed) streaming runs have events but
                # possibly no exported telemetry yet — the live view is
                # how those are inspected at all
                links.append(f'<a href="/live/{quote(rel)}">live</a>')
            tel = f"<td>{' '.join(links)}</td>"
            rows.append(
                "<tr>"
                f'<td><a href="/run/{quote(rel)}">{html.escape(s["name"])}</a></td>'
                f'<td><a href="/files/{quote(rel)}/">{html.escape(s["timestamp"])}</a></td>'
                f"{_verdict_cell(s['valid?'], s['error'], s['degraded'], s['deadline'])}"
                f"{tel}"
                f'<td><a href="/zip/{quote(rel)}">zip</a></td>'
                "</tr>")
        links = []
        if os.path.isdir(os.path.join(self.base, "campaigns")):
            links.append('<a href="/campaigns">campaigns</a>')
        if self.verifier is not None or \
                os.path.isdir(os.path.join(self.base, "verifier")):
            links.append('<a href="/verifier">verifier</a>')
        if self.fleet is not None:
            links.append('<a href="/fleet">fleet</a>')
        if os.path.exists(alerts_mod.alerts_path(self.base)):
            links.append('<a href="/alerts">alerts</a>')
        links.append('<a href="/metrics">metrics</a>')
        camp = "<p>" + " &middot; ".join(links) + "</p>"
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>jepsen-tpu</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<h1>jepsen-tpu runs</h1>{camp}
<table><tr><th>test</th><th>time</th><th>valid?</th><th>telemetry</th><th>download</th></tr>
{"".join(rows)}</table></body></html>"""
        self._send(200, doc.encode())

    def _run(self, rel: str):
        """Per-run page: the verdict (with deadline/degraded badges),
        the results map, and links to the artifacts."""
        rel = rel.rstrip("/")
        p = self._safe_path(rel)
        if p is None or not os.path.isdir(p):
            return self._send(404, b"no such run", "text/plain")
        s = _run_summary(p)
        results = None
        rj = os.path.join(p, "results.json")
        if os.path.exists(rj):
            try:
                with open(rj) as f:
                    results = json.dumps(json.load(f), indent=1,
                                         sort_keys=True)
            except (OSError, ValueError) as e:
                results = f"results.json unreadable: {e}"
        tel = (f'&middot; <a href="/telemetry/{quote(rel)}">telemetry</a> '
               if os.path.exists(os.path.join(p, "telemetry.json"))
               else "")
        from .telemetry import stream as tel_stream
        live = (f'&middot; <a href="/live/{quote(rel)}">live</a> '
                if tel_stream.events_path(p) else "")
        wit = (f'&middot; <a href="/run/{quote(rel)}/witness">witness</a> '
               if os.path.exists(os.path.join(p, "witness.json"))
               else "")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{html.escape(rel)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
pre {{ background: #f6f6f6; padding: 1em; overflow-x: auto; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 3px 8px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/">&larr; runs</a></p>
<h2>{html.escape(s["name"])} <small>{html.escape(s["timestamp"])}</small>
{_verdict_badges(s["valid?"], s["error"], s["degraded"], s["deadline"])}</h2>
<p><a href="/files/{quote(rel)}/">files</a> {tel}{live}{wit}&middot;
<a href="/zip/{quote(rel)}">zip</a></p>
{self._warehouse_spans_html(rel)}
<pre>{html.escape(results or "no results.json (run still in flight, "
                             "or it crashed before analysis)")}</pre>
</body></html>"""
        self._send(200, doc.encode())

    def _warehouse_spans_html(self, rel: str) -> str:
        """Span totals for one run from the warehouse's ``run_spans``
        table (when it's been ingested) — the run page then shows its
        span profile without re-parsing telemetry.json per request."""
        try:
            from .telemetry import warehouse as wmod

            wh = wmod.open_if_exists(self.base)
            if wh is None:
                return ""
            rows = wh.run_spans(rel)
        except Exception:  # noqa: BLE001 — decorative, never 500 a page
            return ""
        if not rows:
            return ""
        trs = "".join(
            f"<tr><td><code>{html.escape(name)}</code></td>"
            f"<td>{total:.4f}</td><td>{count}</td></tr>"
            for name, total, count in rows)
        return ("<h3>spans <small>(warehouse)</small></h3>"
                "<table><tr><th>span</th><th>total s</th><th>count</th>"
                f"</tr>{trs}</table>")

    def _witness(self, rel: str):
        """Minimal-witness page (docs/MINIMIZE.md): the shrunk failing
        history op by op, then each surviving anomaly's explained cycle
        — every edge rendered with the Explainer's evidence (key,
        values, the "why" sentence)."""
        from .minimize import load_witness

        rel = rel.rstrip("/")
        p = self._safe_path(rel)
        if p is None or not os.path.isdir(p):
            return self._send(404, b"no such run", "text/plain")
        w = load_witness(p)
        if w is None:
            return self._send(404, b"no witness for this run (run "
                              b"`cli shrink <dir>` first)", "text/plain")
        op_rows = []
        for op in w["history"]:
            err = op.error if op.error is not None else ""
            op_rows.append(
                f"<tr><td>{op.index}</td><td>{html.escape(str(op.process))}"
                f"</td><td>{html.escape(str(op.type))}</td>"
                f"<td>{html.escape(str(op.f))}</td>"
                f"<td><code>{html.escape(json.dumps(op.value))}</code></td>"
                f"<td>{html.escape(str(err))}</td></tr>")
        anom_html = []
        for name, entries in sorted((w.get("anomalies") or {}).items()):
            anom_html.append(f"<h3><code>{html.escape(name)}</code></h3>")
            items: list = []  # consecutive <li> fragments -> one <ul>

            def flush_items():
                if items:
                    anom_html.append(f"<ul>{''.join(items)}</ul>")
                    items.clear()

            for e in entries if isinstance(entries, list) else []:
                cyc = e.get("cycle") if isinstance(e, dict) else None
                if not cyc:
                    frag = _model_anomaly_html(e, name)
                    if frag.startswith("<li>"):
                        items.append(frag)
                    else:
                        flush_items()
                        anom_html.append(frag)
                    continue
                flush_items()
                steps = []
                for edge in cyc:
                    why = edge.get("why") or json.dumps(
                        {k: v for k, v in edge.items() if k != "rel"})
                    steps.append(
                        f"<li><b>{html.escape(str(edge.get('rel')))}"
                        f"</b> — {html.escape(str(why))}</li>")
                anom_html.append(f"<ol>{''.join(steps)}</ol>")
            flush_items()
        windows_html = ""
        fw = w.get("fault-windows") or []
        if fw:
            def _wcell(win, k):
                v = win.get(k)
                return "&mdash;" if v is None else html.escape(str(v))

            rows = "".join(
                f"<tr><td><code>{html.escape(str(win.get('f')))}</code>"
                f"</td><td>{win.get('span', ['?', '?'])[0]}&ndash;"
                f"{win.get('span', ['?', '?'])[1]}</td>"
                f"<td>{len(win.get('ops') or ())} ops</td>"
                f"<td>{_wcell(win, 'pos')}</td>"
                f"<td><code>{_wcell(win, 'digest')}</code></td>"
                f"<td>{_wcell(win, 'host')}</td>"
                f"<td>{_wcell(win, 'kept')}</td></tr>"
                for win in fw)
            windows_html = (
                "<h2>surviving fault windows</h2>"
                "<p>the nemesis-schedule ddmin kept these windows "
                "(reproduction-necessary or overlapping the witness "
                "ops); spans are source-history op indices; scheduled "
                "windows carry their schedule position/digest and the "
                "executing host (the cross-host attribution)</p>"
                "<table><tr><th>fault</th><th>span</th><th>ops</th>"
                "<th>pos</th><th>digest</th><th>host</th><th>kept</th>"
                f"</tr>{rows}</table>")
        quant = " ".join(
            f"{k.replace('_', ' ')}={w[k]}" for k in
            ("probe_p50_s", "probe_p95_s") if w.get(k) is not None)
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>witness — {html.escape(rel)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 3px 8px; }}
pre {{ background: #f6f6f6; padding: 1em; overflow-x: auto; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/run/{quote(rel)}">&larr; run</a></p>
<h1>minimal witness
{_verdict_badges(w.get("valid?"))}</h1>
<p>{w.get("ops")} ops (shrunk from {w.get("source-ops")}) &middot;
anomalies: <code>{html.escape(", ".join(w.get("anomaly-types") or ()))}
</code> &middot; checker {html.escape(str(w.get("checker")))} &middot;
{w.get("rounds")} rounds / {w.get("probes")} probes {html.escape(quant)}
&middot; digest <code>{html.escape(str(w.get("digest")))}</code></p>
<table><tr><th>#</th><th>process</th><th>type</th><th>f</th>
<th>value</th><th>error</th></tr>{"".join(op_rows)}</table>
<h2>evidence</h2>
{"".join(anom_html) or "<p>(no anomaly evidence reported)</p>"}
{windows_html}
<p><a href="/files/{quote(rel)}/witness.json">witness.json</a> &middot;
<a href="/files/{quote(rel)}/witness.jsonl">witness.jsonl</a></p>
</body></html>"""
        self._send(200, doc.encode())

    def _autoingest(self) -> None:
        """When a warehouse exists, incrementally ingest any campaign
        ledger growth before a campaign page renders
        (docs/TELEMETRY.md): the byte cursors make an unchanged ledger
        a no-op, and the Index fast paths then answer from indexed SQL
        instead of re-parsing the jsonl per request.  Ledgers ONLY —
        everything these pages render comes from campaign_records;
        run-dir/event ingest (which stats every run dir in the store)
        stays with `cli obs ingest`.  No warehouse -> no-op (the read
        surfaces never create one implicitly)."""
        try:
            from .telemetry import warehouse as wmod

            wh = wmod.open_if_exists(self.base)
            if wh is None:
                return
            cdir = os.path.join(self.base, "campaigns")
            if os.path.isdir(cdir):
                for fn in sorted(os.listdir(cdir)):
                    if fn.endswith(".jsonl"):
                        wh.ingest_ledger(os.path.join(cdir, fn),
                                         self.base)
        except Exception:  # noqa: BLE001 — rendering must survive
            logger.debug("warehouse auto-ingest failed", exc_info=True)

    def _metrics(self):
        """Prometheus text exposition (docs/TELEMETRY.md): the live
        registry's counters/gauges/histograms, federated fleet worker
        series (``host=``-labeled, retired with worker liveness),
        campaign heartbeat freshness, and warehouse rollup
        gauges."""
        from .telemetry import prometheus as prom

        body = prom.exposition(base=self.base, fleet=self.fleet)
        self._send(200, body.encode(), prom.CONTENT_TYPE)

    def _campaigns(self):
        """Campaign list: every jsonl ledger under <store>/campaigns."""
        from .campaign.index import Index

        self._autoingest()
        cdir = os.path.join(self.base, "campaigns")
        rows = []
        if os.path.isdir(cdir):
            for fn in sorted(os.listdir(cdir)):
                if not fn.endswith(".jsonl"):
                    continue
                name = fn[:-len(".jsonl")]
                try:
                    idx = Index(os.path.join(cdir, fn))
                    c = idx.verdict_counts()
                    n_reg = len(idx.regressions())
                except Exception:  # noqa: BLE001 — list corrupt ledgers too
                    c, n_reg = {}, 0
                reg = (f'<td style="background:#f2a3a3">{n_reg}</td>'
                       if n_reg else "<td>0</td>")
                rows.append(
                    "<tr>"
                    f'<td><a href="/campaign/{quote(name)}">'
                    f"{html.escape(name)}</a></td>"
                    f"<td>{c.get('true', '?')}</td>"
                    f"<td>{c.get('false', '?')}</td>"
                    f"<td>{c.get('unknown', '?')}</td>"
                    f"<td>{c.get('degraded', '?')}</td>"
                    f"<td>{c.get('deadline', '?')}</td>"
                    f"{reg}</tr>")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>campaigns</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/">&larr; runs</a></p><h1>campaigns</h1>
<table><tr><th>campaign</th><th>ok</th><th>invalid</th><th>unknown</th>
<th>degraded</th><th>deadline</th><th>regressions</th></tr>
{"".join(rows)}</table></body></html>"""
        self._send(200, doc.encode())

    def _campaign(self, name: str):
        """Campaign dashboard: the workload × fault × seed verdict grid
        (cells link to the run pages; degraded / deadline-expired runs
        carry distinct badges), plus regressions and span aggregates."""
        from .campaign.index import Index

        self._autoingest()
        name = unquote(name).rstrip("/")
        path = self._safe_path(os.path.join("campaigns", name + ".jsonl"))
        if path is None or not os.path.exists(path):
            return self._send(404, b"no such campaign", "text/plain")
        idx = Index(path)
        # warehouse-backed when fresh: the grid, the regression list,
        # and the span aggregates below then never parse the jsonl
        latest = idx.latest_by_run()
        seeds = sorted({r.get("seed") for r in latest.values()
                        if r.get("seed") is not None})
        grid: Dict[tuple, Dict[Any, Dict[str, Any]]] = {}
        for r in latest.values():
            grid.setdefault((str(r.get("workload")), str(r.get("fault"))),
                            {})[r.get("seed")] = r
        rows = []
        for (wl, fl), cells in sorted(grid.items()):
            tds = []
            for s in seeds:
                r = cells.get(s)
                if r is None:
                    tds.append("<td>-</td>")
                    continue
                badge = _verdict_badges(
                    r.get("valid?"), r.get("error"), r.get("degraded"),
                    r.get("deadline"))
                if r.get("dir"):
                    badge = (f'<a href="/run/{quote(str(r["dir"]))}">'
                             f"{badge}</a>")
                w = r.get("witness")
                if isinstance(w, dict) and w.get("ops") and r.get("dir"):
                    # the auto-shrink witness column: invalid cells
                    # link straight to their minimal witness
                    badge += (f' <a class="b b-witness" title="minimal '
                              f'witness ({w["ops"]} ops)" '
                              f'href="/run/{quote(str(r["dir"]))}/witness">'
                              f'w:{w["ops"]}</a>')
                if r.get("run") and r.get("trace"):
                    # trace-stamped cells link to their
                    # stitched cross-host waterfall
                    badge += (f' <a class="b b-other" title="cross-'
                              f'host timeline" href="/timeline/'
                              f'{quote(str(r["run"]))}">tl</a>')
                tds.append(f'<td style="text-align:center">{badge}</td>')
            rows.append(f"<tr><td>{html.escape(wl)}</td>"
                        f"<td>{html.escape(fl)}</td>{''.join(tds)}</tr>")
        regs = idx.regressions()
        reg_html = ""
        if regs:
            items = "".join(
                f"<li><code>{html.escape(str(r['key']))}</code>: "
                f"{html.escape(str(r['from']))} &rarr; "
                f"{html.escape(str(r['to']))} ({html.escape(str(r.get('when') or ''))})</li>"
                for r in regs)
            reg_html = (f'<h2 style="color:#b03030">regressions</h2>'
                        f"<ul>{items}</ul>")
        stats = idx.span_stats()
        stat_rows = "".join(
            f"<tr><td>{html.escape(n)}</td><td>{st['count']}</td>"
            f"<td>{st['p50']:.4f}</td><td>{st['p95']:.4f}</td>"
            f"<td>{st['max']:.4f}</td></tr>"
            for n, st in list(stats.items())[:24])
        stat_html = (f"<h2>checker span durations (s)</h2><table>"
                     f"<tr><th>span</th><th>n</th><th>p50</th><th>p95</th>"
                     f"<th>max</th></tr>{stat_rows}</table>"
                     if stat_rows else "")
        head = "".join(f"<th>s{s}</th>" for s in seeds)
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>campaign {html.escape(name)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
a {{ text-decoration: none; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/campaigns">&larr; campaigns</a> &middot;
<a href="/campaign/{quote(name)}/live">live</a> &middot;
<a href="/campaign/{quote(name)}/witness-diff">witness diff</a> &middot;
<a href="/campaign/{quote(name)}/trend">trend</a></p>
<h1>campaign {html.escape(name)}</h1>
<table><tr><th>workload</th><th>fault</th>{head}</tr>
{"".join(rows)}</table>
{reg_html}{stat_html}</body></html>"""
        self._send(200, doc.encode())

    def _telemetry(self, rel: str):
        """Per-run telemetry page: the span-tree/metrics summary plus
        links to the raw artifacts (trace.json loads in Perfetto)."""
        p = self._safe_path(rel.rstrip("/"))
        if p is None or not os.path.isdir(p) or \
                not os.path.exists(os.path.join(p, "telemetry.json")):
            return self._send(404, b"no telemetry for this run",
                              "text/plain")
        from .telemetry import export as tel_export
        doc_j = None
        try:
            with open(os.path.join(p, "telemetry.json")) as f:
                doc_j = json.load(f)
            summary = tel_export.summarize(p, doc=doc_j)
        except Exception as e:  # noqa: BLE001 — corrupt file still 200s
            summary = f"telemetry.json unreadable: {e}"
        # latency percentiles from the fixed-bucket histograms
        # (p50/p95/p99, not bucket dumps)
        hist_rows = []
        try:
            for h in ((doc_j or {}).get("metrics") or {}).get(
                    "histograms", []):
                if not h.get("count"):
                    continue
                quant = tel_export.histogram_quantiles(
                    h.get("buckets") or [], h.get("counts") or [])
                lbl = ",".join(f"{k}={v}" for k, v in
                               sorted((h.get("labels") or {}).items()))
                hist_rows.append(
                    f"<tr><td><code>{html.escape(h['name'])}"
                    f"{{{html.escape(lbl)}}}</code></td>"
                    f"<td>{h['count']}</td><td>{h['sum']:.6g}</td>"
                    + "".join(f"<td>{quant.get(k, '')}</td>"
                              for k in ("p50", "p95", "p99"))
                    + "</tr>")
        except Exception:  # noqa: BLE001 — percentiles are best-effort
            hist_rows = []
        hist_html = ""
        if hist_rows:
            hist_html = (
                "<h2>latency percentiles</h2><table>"
                "<tr><th>histogram</th><th>n</th><th>sum</th>"
                "<th>p50</th><th>p95</th><th>p99</th></tr>"
                + "".join(hist_rows) + "</table>")
        rel = rel.rstrip("/")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>telemetry — {html.escape(rel)}</title>
<style>body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 3px 8px; }}
pre {{ background: #f6f6f6; padding: 1em; overflow-x: auto; }}</style>
</head><body>
<p><a href="/">&larr; runs</a> &middot;
<a href="/files/{quote(rel)}/telemetry.json">telemetry.json</a> &middot;
<a href="/files/{quote(rel)}/trace.json">trace.json</a>
(open in <a href="https://ui.perfetto.dev">ui.perfetto.dev</a>)</p>
{hist_html}<pre>{html.escape(summary)}</pre></body></html>"""
        self._send(200, doc.encode())

    def _live(self, rel: str):
        """Live run view (the flight recorder, docs/TELEMETRY.md): the
        streamed events.jsonl rendered as progress lines + the replayed
        end state (open-span chain, resource gauges, counters).  Auto-
        refreshes while the run is in flight; a crashed/killed run
        shows its partial trace — this page exists precisely for runs
        that never reached store.save_1."""
        from .telemetry import stream as tel_stream

        rel = rel.rstrip("/")
        p = self._safe_path(rel)
        if p is None or not os.path.isdir(p):
            return self._send(404, b"no such run", "text/plain")
        path = tel_stream.events_path(p)
        if path is None:
            return self._send(404, b"no events.jsonl for this run (run "
                              b"with --telemetry to stream)", "text/plain")
        evs = tel_stream.read_events(path)
        st = tel_stream.replay(evs)
        t0 = st["t0"]
        lines = [tel_stream.render_line(e, t0) for e in evs[-60:]]
        # stop auto-refreshing once the stream goes quiet: a crashed
        # run never emits "end", and a forgotten tab re-parsing an
        # unbounded events.jsonl every 2 s forever is pure waste
        try:
            stale = time.time() - os.path.getmtime(path) > _LIVE_STALE_S
        except OSError:
            stale = True
        refresh = ("" if st["ended"] or stale else
                   '<meta http-equiv="refresh" content="2">')
        if st["ended"]:
            status = '<span class="b b-true">ended</span>'
        elif st["open"]:
            chain = " &gt; ".join(html.escape(str(s["name"]))
                                  for s in st["open"])
            badge = ('<span class="b b-other">stream idle</span>'
                     if stale else
                     '<span class="b b-unknown">in flight</span>')
            status = f"{badge} open: <code>{chain}</code>"
        else:
            status = '<span class="b b-other">stream truncated</span>'
        if not st["ended"] and stale:
            status += (f" &middot; no events for &gt;{_LIVE_STALE_S:.0f}s"
                       " — auto-refresh off (reload to re-check)")
        counters = "".join(
            f"<tr><td><code>{html.escape(k)}</code></td><td>{v}</td></tr>"
            for k, v in sorted(st["counters"].items()))
        gauges = "".join(
            f"<tr><td><code>{html.escape(k)}</code></td><td>{v}</td></tr>"
            for k, v in sorted(st["gauges"].items()))
        metric_html = ""
        if counters or gauges:
            metric_html = (
                "<h2>metrics (latest streamed values)</h2>"
                "<table><tr><th>instrument</th><th>value</th></tr>"
                + counters + gauges + "</table>")
        res = ""
        if st["faults"] or st["retries"] or st["fallbacks"] or \
                st["deadlines"]:
            res = (f"<p>resilience: {st['faults']} faults, "
                   f"{st['retries']} retries, {st['fallbacks']} "
                   f"fallbacks, {st['deadlines']} deadline expiries</p>")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
{refresh}<title>live — {html.escape(rel)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 3px 8px; }}
pre {{ background: #f6f6f6; padding: 1em; overflow-x: auto; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/run/{quote(rel)}">&larr; run</a> &middot;
<a href="/files/{quote(rel)}/">files</a></p>
<h1>live — {html.escape(st["meta"].get("name") or rel)}</h1>
<p>{status} &middot; {st["events"]} events, {st["spans_closed"]} spans
closed</p>{res}{metric_html}
<h2>event tail</h2>
<pre>{html.escape(chr(10).join(lines))}</pre>
</body></html>"""
        self._send(200, doc.encode())

    def _campaign_live(self, name: str):
        """Live fleet dashboard: the scheduler's heartbeat state file —
        which runs each worker holds right now, done/total progress —
        next to the latest indexed verdicts.  Auto-refreshes until the
        campaign's heartbeat says finished."""
        from .campaign.core import live_path
        from .telemetry import Heartbeat

        name = unquote(name).rstrip("/")
        path = self._safe_path(os.path.relpath(
            live_path(name, self.base), self.base))
        hb = Heartbeat.load(path) if path else None
        if hb is None:
            return self._send(404, b"no live state for this campaign "
                              b"(never run, or pre-flight-recorder)",
                              "text/plain")
        # same stale guard as /live/<rel>: a killed scheduler never
        # writes finished=True, and its dashboard must not refresh
        # forever
        upd = hb.get("updated")
        stale = (not isinstance(upd, (int, float))
                 or time.time() - upd > _LIVE_STALE_S)
        refresh = ("" if hb.get("finished") or stale else
                   '<meta http-equiv="refresh" content="2">')
        total = hb.get("total") or 0
        done = hb.get("done") or 0
        pct = f" ({100.0 * done / total:.0f}%)" if total else ""
        wrows = []
        now = time.time()
        for wid, w in sorted((hb.get("workers") or {}).items()):
            age = (f"{now - w['since']:.1f}s"
                   if isinstance(w.get("since"), (int, float)) else "?")
            wrows.append(
                f"<tr><td>{html.escape(wid)}</td>"
                f"<td><code>{html.escape(str(w.get('run')))}</code></td>"
                f"<td>{html.escape(str(w.get('workload')))}</td>"
                f"<td>{html.escape(str(w.get('fault')))}</td>"
                f"<td>{html.escape(str(w.get('seed')))}</td>"
                f"<td>{html.escape(str(w.get('slot')))}</td>"
                f"<td>{age}</td></tr>")
        workers = ("<table><tr><th>worker</th><th>run</th><th>workload</th>"
                   "<th>fault</th><th>seed</th><th>slot</th><th>running "
                   "for</th></tr>" + "".join(wrows) + "</table>"
                   if wrows else "<p>(no runs in flight)</p>")
        last = hb.get("last") or {}
        last_html = ""
        if last.get("run"):
            last_html = (f"<p>last finished: <code>"
                         f"{html.escape(str(last['run']))}</code> "
                         f"{_verdict_badges(last.get('valid?'))}</p>")
        state = ("finished" if hb.get("finished")
                 else "stalled? (heartbeat idle — auto-refresh off)"
                 if stale else "running")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
{refresh}<title>live — campaign {html.escape(name)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/campaign/{quote(name)}">&larr; campaign</a></p>
<h1>campaign {html.escape(name)} — live</h1>
<p>{state}: {done}/{total} runs done{pct}</p>
{last_html}<h2>in flight</h2>{workers}
</body></html>"""
        self._send(200, doc.encode())

    def _trend(self, name: str):
        """Span-duration trend page: per span site, the p95 per
        campaign generation (the `span_trend` query, warehouse-backed
        when fresh) — the data `cli obs gate` turns into a CI check."""
        from .campaign.index import Index

        self._autoingest()
        name = unquote(name).rstrip("/")
        path = self._safe_path(os.path.join("campaigns", name + ".jsonl"))
        if path is None or not os.path.exists(path):
            return self._send(404, b"no such campaign", "text/plain")
        idx = Index(path)
        stats = idx.span_stats()
        trends: Dict[str, Dict[str, float]] = {}
        for span in stats:
            for g, p95 in idx.span_trend(span):
                trends.setdefault(span, {})[g] = p95
        # column order must be chronological across ALL spans — gens
        # are run_campaign UTC timestamps, so a lexical sort IS time
        # order ("?" last); per-span first-seen order would scramble
        # columns when spans cover different generation subsets and
        # the >25% highlight would compare non-adjacent generations
        gens = sorted({g for t in trends.values() for g in t},
                      key=lambda g: (g == "?", g))
        rows = []
        for span in sorted(trends):
            cells = []
            prev = None
            for g in gens:
                v = trends[span].get(g)
                if v is None:
                    cells.append("<td>-</td>")
                    prev = None  # gap: don't compare across it — the
                    # highlight promises ADJACENT-generation deltas
                    continue
                mark = ""
                if prev is not None and prev > 0:
                    delta = (v - prev) / prev
                    if delta > 0.25:
                        mark = ' style="background:#f2a3a3"'
                    elif delta < -0.25:
                        mark = ' style="background:#9ce29c"'
                cells.append(f"<td{mark}>{v:.4f}</td>")
                prev = v
            rows.append(f"<tr><td><code>{html.escape(span)}</code></td>"
                        + "".join(cells) + "</tr>")
        head = "".join(f"<th>{html.escape(g)}</th>" for g in gens)
        body = ("<table><tr><th>span</th>" + head + "</tr>"
                + "".join(rows) + "</table>" if rows else
                "<p>no span samples indexed yet (runs need "
                "<code>\"telemetry\": true</code>).</p>")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>trend — {html.escape(name)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/campaign/{quote(name)}">&larr; campaign</a></p>
<h1>span p95 trend — {html.escape(name)}</h1>
<p>p95 span duration (s) per campaign generation; a &gt;25% step vs
the previous generation is highlighted.  Enforce with
<code>cli obs gate --campaign {html.escape(name)} --span &lt;name&gt;
</code> (docs/TELEMETRY.md).  Drill down:
<a href="/profile/{quote(name)}">device-call profile</a> &middot;
<a href="/campaign/{quote(name)}/forensics">regression forensics</a>.
</p>
{body}</body></html>"""
        self._send(200, doc.encode())

    def _profile(self, name: str):
        """Device-call profile treemap: per (site,
        shape-class, host) compile/execute/dispatch self-time over the
        campaign's runs — the web twin of ``cli obs profile``."""
        from .campaign.index import Index

        self._autoingest()
        name = unquote(name).rstrip("/")
        path = self._safe_path(os.path.join("campaigns", name + ".jsonl"))
        if path is None or not os.path.exists(path):
            return self._send(404, b"no such campaign", "text/plain")
        rows = Index(path).profile()
        by_site: Dict[str, list] = {}
        for r in rows:
            by_site.setdefault(r["site"], []).append(r)
        site_total = {s: sum(r["compile_s"] + r["execute_s"] for r in rs)
                      for s, rs in by_site.items()}
        grand = sum(site_total.values()) or 1e-12
        parts = []
        for site in sorted(by_site, key=lambda s: -site_total[s]):
            pct = site_total[site] / grand * 100.0
            cells = "".join(
                f"<tr><td><code>{html.escape(r['shape'])}</code></td>"
                f"<td>{html.escape(r['host'] or '-')}</td>"
                f"<td>{r['calls']}</td><td>{r['compile_s']:.3f}</td>"
                f"<td>{r['execute_s']:.3f}</td>"
                f"<td>{r['device_dispatch_s']:.3f}</td></tr>"
                for r in sorted(by_site[site],
                                key=lambda r: -(r["compile_s"]
                                                + r["execute_s"])))
            parts.append(
                f"<h2><code>{html.escape(site)}</code> — "
                f"{pct:.1f}% of device time</h2>"
                f'<div class="bar"><div style="width:{pct:.1f}%">'
                "</div></div>"
                "<table><tr><th>shape-class</th><th>host</th>"
                "<th>calls</th><th>compile s</th><th>execute s</th>"
                f"<th>dispatch s</th></tr>{cells}</table>")
        body = ("".join(parts) if parts else
                "<p>no device-call profile yet (runs need "
                "<code>\"telemetry\": true</code>; re-run "
                "<code>cli obs ingest</code> after runs land).</p>")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>profile — {html.escape(name)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
.bar {{ background: #eee; width: 60%; height: 10px; margin: 4px 0; }}
.bar div {{ background: #4a90d9; height: 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/campaign/{quote(name)}">&larr; campaign</a> &middot;
<a href="/campaign/{quote(name)}/trend">trend</a> &middot;
<a href="/campaign/{quote(name)}/forensics">forensics</a></p>
<h1>device-call profile — {html.escape(name)}</h1>
<p>Per (site, shape-class, host): jit compile / execute /
dispatch-only self-time summed over the campaign's telemetric runs
(<code>cli obs profile {html.escape(name)}</code>).</p>
{body}</body></html>"""
        self._send(200, doc.encode())

    def _forensics(self, name: str):
        """Cross-generation regression forensics panel: the
        latest generation pair gated span by span, each regression's
        delta attributed across phase buckets + forensic counters —
        the web twin of ``cli obs diff``."""
        from .telemetry import forensics

        self._autoingest()
        name = unquote(name).rstrip("/")
        path = self._safe_path(os.path.join("campaigns", name + ".jsonl"))
        if path is None or not os.path.exists(path):
            return self._send(404, b"no such campaign", "text/plain")
        report = forensics.run_diff(self.base, name)
        status = report.get("status") or "?"
        color = {"regression": "#f2a3a3", "pass": "#9ce29c"}.get(
            status, "#eee")
        parts = [f'<p>generations <code>{html.escape(str(report.get("from-gen", "?")))}'
                 f"</code> &rarr; <code>"
                 f'{html.escape(str(report.get("to-gen", "?")))}</code>: '
                 f'<span style="background:{color};padding:2px 8px">'
                 f"{html.escape(status)}</span>"
                 + (f" — {html.escape(str(report['reason']))}"
                    if report.get("reason") else "") + "</p>"]
        for e in report.get("spans") or []:
            mark = {"regression": "#f2a3a3",
                    "pass": "#9ce29c"}.get(e["status"], "#eee")
            rel = e.get("rel_delta")
            rel_txt = f"{rel * 100:+.0f}%" if isinstance(
                rel, (int, float)) else "?"
            head = (f'<h2><span style="background:{mark};'
                    f'padding:1px 6px">{html.escape(e["status"])}'
                    f"</span> <code>{html.escape(e['span'])}</code> "
                    f"{rel_txt} (mean {e['mean_from']:.4f}s &rarr; "
                    f"{e['mean_to']:.4f}s)</h2>")
            parts.append(head)
            if e["status"] != "regression":
                continue
            rows = "".join(
                f"<tr><td><code>{html.escape(p['bucket'])}</code></td>"
                f"<td>{p['from_s']:.4f}</td><td>{p['to_s']:.4f}</td>"
                f"<td>{p['delta_s']:+.4f}</td>"
                + (f"<td>{p['share'] * 100:.1f}%</td>"
                   if isinstance(p.get("share"), (int, float))
                   else "<td>-</td>") + "</tr>"
                for p in e.get("phases") or [])
            if rows:
                parts.append(
                    "<table><tr><th>phase bucket</th><th>from s</th>"
                    "<th>to s</th><th>&Delta; s</th>"
                    f"<th>share of delta</th></tr>{rows}</table>")
            crows = "".join(
                f"<tr><td><code>{html.escape(c['name'])}</code></td>"
                f"<td>{c['from']:g}</td><td>{c['to']:g}</td>"
                f"<td>{c['delta']:+g}</td></tr>"
                for c in (e.get("counters") or [])[:12])
            if crows:
                parts.append(
                    "<table><tr><th>counter</th><th>from</th>"
                    f"<th>to</th><th>&Delta;</th></tr>{crows}</table>")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>forensics — {html.escape(name)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/campaign/{quote(name)}">&larr; campaign</a> &middot;
<a href="/campaign/{quote(name)}/trend">trend</a> &middot;
<a href="/profile/{quote(name)}">profile</a></p>
<h1>regression forensics — {html.escape(name)}</h1>
<p>Latest generation pair gated span by span (Mann-Whitney + p95
threshold); each regression's delta attributed across the phase
buckets (<code>cli obs diff {html.escape(name)}</code>).</p>
{"".join(parts)}</body></html>"""
        self._send(200, doc.encode())

    def _witness_diff(self, name: str):
        """Witness drift across campaign generations: per regression
        key, how the auto-shrunk minimal witness
        changed between consecutive generations — op count, digest, and
        anomaly-set deltas.  A changed digest under an unchanged spec
        means the minimal repro MOVED: a different failure, even when
        the verdict grid still just shows False."""
        from .campaign.index import Index

        self._autoingest()
        name = unquote(name).rstrip("/")
        path = self._safe_path(os.path.join("campaigns", name + ".jsonl"))
        if path is None or not os.path.exists(path):
            return self._send(404, b"no such campaign", "text/plain")
        diffs = Index(path).witness_diffs()
        rows = []
        for d in diffs:
            digest = ("changed" if d["digest-changed"] else "same")
            style = ' style="background:#ffe9c9"' if d["changed"] else ""
            anoms = []
            for a in d["anomalies-added"]:
                anoms.append(f"+{a}")
            for a in d["anomalies-removed"]:
                anoms.append(f"&minus;{a}")
            rows.append(
                f"<tr{style}><td><code>{html.escape(str(d['key']))}"
                f"</code></td>"
                f"<td>{html.escape(str(d['from-gen']))} &rarr; "
                f"{html.escape(str(d['to-gen']))}</td>"
                f"<td>{d['from-ops']} &rarr; {d['to-ops']} "
                f"({d['ops-delta']:+d})</td>"
                f"<td>{digest}</td>"
                f"<td>{html.escape(' '.join(anoms)) or '-'}</td>"
                f"<td><code>{html.escape(str(d['from-digest'])[:12])} "
                f"&rarr; {html.escape(str(d['to-digest'])[:12])}"
                f"</code></td></tr>")
        body = ("<table><tr><th>key</th><th>generations</th><th>ops</th>"
                "<th>digest</th><th>anomaly deltas</th><th>digests</th>"
                "</tr>" + "".join(rows) + "</table>" if rows else
                "<p>no witness pairs yet — witness diffs need the same "
                "key auto-shrunk (<code>\"shrink\": true</code>) in at "
                "least two campaign generations (<code>--rerun</code>)."
                "</p>")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>witness diff — {html.escape(name)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/campaign/{quote(name)}">&larr; campaign</a></p>
<h1>witness diff — {html.escape(name)}</h1>
<p>how each key's minimal witness moved between consecutive
generations (highlighted rows changed)</p>
{body}</body></html>"""
        self._send(200, doc.encode())

    # -- verifier pages (docs/VERIFIER.md) --------------------------------

    def _verifier_rows(self):
        """Session summaries: first-hand from the attached service, or
        read-only from the on-disk ``session.json`` snapshots."""
        if self.verifier is not None:
            return self.verifier.sessions()
        from .verifier import scan_sessions

        return [dict(meta, live=False)
                for _n, meta in scan_sessions(self.base)]

    def _verdict_json(self, name: str):
        """``GET /verdict/<session>`` — the rolling verdict as JSON.
        With a service attached this sweeps dirty work first (rolling
        verdicts out); read-only servers answer from the snapshot."""
        name = name.strip("/")
        if self.verifier is not None:
            code, doc = self.verifier.verdict(name)
            return self._send_json(code, doc)
        from .verifier import VerifierService, read_meta

        if not VerifierService.valid_name(name):
            # same sanitization as the service path: the name is about
            # to be joined into a filesystem path
            return self._send_json(400, {"error": "bad session name"})
        meta = read_meta(os.path.join(self.base, "verifier", name))
        if meta is None:
            return self._send_json(
                404, {"error": f"no such session {name!r}"})
        return self._send_json(200, dict(meta.get("verdict") or {},
                                         session=name, snapshot=True,
                                         digest=meta.get("digest")))

    def _verifier_list(self):
        """Session table: state, rolling verdict, ingest freshness —
        the fleet view of the always-on checker."""
        rows = []
        now = time.time()
        for s in self._verifier_rows():
            name = str(s.get("session") or "?")
            v = (s.get("verdict") or {})
            upd = s.get("updated")
            age = (f"{now - upd:.0f}s"
                   if isinstance(upd, (int, float)) else "?")
            links = [f'<a href="/verifier/{quote(name)}">session</a>']
            d = os.path.join(self.base, "verifier", name)
            from .telemetry import stream as tel_stream
            if tel_stream.events_path(d):
                links.append(
                    f'<a href="/live/{quote("verifier/" + name)}">live</a>')
            state = str(s.get("state") or "?")
            if s.get("live"):
                state += " &middot; in memory"
            rows.append(
                "<tr>"
                f"<td><code>{html.escape(name)}</code></td>"
                f"<td>{state}</td>"
                f"{_verdict_cell(v.get('valid?', '?'), v.get('error'))}"
                f"<td>{html.escape(', '.join(v.get('anomaly-types') or []) or '-')}</td>"
                f"<td>{s.get('txns', '?')}</td>"
                f"<td>{s.get('ops', '?')}</td>"
                f"<td>{age}</td>"
                f"<td>{' '.join(links)}</td></tr>")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>verifier sessions</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/">&larr; runs</a></p><h1>verifier sessions</h1>
<p>the always-on incremental checker: stream histories in
(<code>POST /ingest/&lt;session&gt;</code>), rolling verdicts out
(<code>GET /verdict/&lt;session&gt;</code>); see docs/VERIFIER.md</p>
<table><tr><th>session</th><th>state</th><th>valid?</th>
<th>anomalies</th><th>txns</th><th>ops</th><th>updated</th>
<th>links</th></tr>
{"".join(rows) or '<tr><td colspan="8">(no sessions)</td></tr>'}</table>
</body></html>"""
        self._send(200, doc.encode())

    def _verifier_session(self, name: str):
        """Per-session page: rolling verdict with badges, anomaly
        first-seen table, seal result.  Auto-refreshes while the
        session is open and the snapshot is fresh (same stale guard as
        /live)."""
        name = unquote(name).rstrip("/")
        if not name or "/" in name:
            return self._send(404, b"no such session", "text/plain")
        # READ-ONLY rendering, service or not: a browser tab
        # auto-refreshing every 2 s must not run sweeps, append verdict
        # events, rewrite session.json, or zero the freshness gauge —
        # the mutating rolling-verdict contract lives on GET /verdict
        meta = None
        if self.verifier is not None:
            meta = {s.get("session"): s
                    for s in self.verifier.sessions()}.get(name)
        if meta is None:
            from .verifier import VerifierService, read_meta

            if not VerifierService.valid_name(name):
                return self._send(404, b"no such session", "text/plain")
            meta = read_meta(os.path.join(self.base, "verifier", name))
            if meta is None:
                return self._send(404, b"no such session", "text/plain")
        verdict: Dict[str, Any] = dict(meta.get("verdict") or {})
        if "digest" not in verdict and meta.get("digest"):
            verdict["digest"] = meta.get("digest")
        state = str(meta.get("state") or "?")
        upd = meta.get("updated")
        stale = (not isinstance(upd, (int, float))
                 or time.time() - upd > _LIVE_STALE_S)
        refresh = ("" if state == "sealed" or stale else
                   '<meta http-equiv="refresh" content="2">')
        fs = verdict.get("first-seen") or {}
        anom_rows = "".join(
            f"<tr><td><code>{html.escape(a)}</code></td>"
            f"<td>{fs.get(a, '')}</td></tr>"
            for a in (verdict.get("anomaly-types") or []))
        anom_html = (f"<h2>anomalies (first seen)</h2><table>"
                     f"<tr><th>anomaly</th><th>first seen (epoch s)</th>"
                     f"</tr>{anom_rows}</table>" if anom_rows else
                     "<p>no anomalies observed</p>")
        seal = meta.get("seal") or {}
        seal_html = ""
        if state == "sealed":
            seal_html = (
                "<h2>seal</h2><p>incremental == batch: "
                f"<b>{seal.get('equal')}</b> &middot; digest "
                f"<code>{html.escape(str(seal.get('digest')))}</code>"
                "</p>")
        edge_rows = "".join(
            f"<tr><td>{html.escape(r)}</td><td>{n}</td></tr>"
            for r, n in sorted((verdict.get("edge-counts")
                                or {}).items()))
        edges_html = (f"<h2>dependency edges</h2><table><tr><th>rel</th>"
                      f"<th>count</th></tr>{edge_rows}</table>"
                      if edge_rows else "")
        d = os.path.join(self.base, "verifier", name)
        from .telemetry import stream as tel_stream
        live_link = (
            f'&middot; <a href="/live/{quote("verifier/" + name)}">live'
            '</a> ' if tel_stream.events_path(d) else "")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
{refresh}<title>verifier — {html.escape(name)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/verifier">&larr; sessions</a> {live_link}&middot;
<a href="/files/{quote("verifier/" + name)}/">files</a> &middot;
<a href="/verdict/{quote(name)}">verdict.json</a></p>
<h1>verifier session <code>{html.escape(name)}</code>
{_verdict_badges(verdict.get("valid?", "?"), verdict.get("error"))}</h1>
<p>state: <b>{html.escape(state)}</b> &middot;
{meta.get("txns", "?")} txns / {meta.get("ops", "?")} ops over
{meta.get("segments", "?")} segments &middot; journal cursor
{meta.get("cursor", "?")} &middot; verdict digest
<code>{html.escape(str(verdict.get("digest")
                       or meta.get("digest") or "?"))}</code></p>
{anom_html}{seal_html}{edges_html}
</body></html>"""
        self._send(200, doc.encode())

    # -- fleet control plane (docs/FLEET.md) ------------------------------

    def _fleet_post(self, verb: str):
        """``POST /fleet/<verb>`` — the coordinator's control plane:
        register / claim / heartbeat / complete / release.  JSON in,
        JSON out; only routed when a `FleetCoordinator` is attached
        (``cli fleet serve``)."""
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
        verifier's per-host verdict freshness:
        the one join the fleet dashboard was missing — last heartbeat
        age says a worker is ALIVE, verdict freshness says its
        live-check stream is actually being VERIFIED (ingest lag on
        the verifier's own clock, no worker clock correction
        needed)."""
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

    def _fleet_page(self):
        """Fleet dashboard: queue counts, active leases, and worker
        liveness — the control-plane view next to the campaign's
        /campaign/<n>/live run view."""
        if self.fleet is None:
            return self._send(404, b"no fleet coordinator (start with "
                              b"`fleet serve <spec.json>`)",
                              "text/plain")
        code, s = self._fleet_status_doc()
        if code != 200:
            return self._send_json(code, s)
        c = s.get("counts") or {}

        def _fresh_cell(d):
            f = d.get("verdict-freshness-s")
            if f is None:
                return "&mdash;"
            n = d.get("live-sessions")
            return (f"{f}s over {n} session(s)" if n else f"{f}s")

        def _wwin(d):
            """Installed-window cell: digest + open positions, red when
            the worker's reported digest disagrees with the
            coordinator's authoritative set (a desynced worker must be
            visible at a glance)."""
            wd = d.get("windows")
            if not wd:
                return "&mdash;"
            open_ = ",".join(str(o.get("pos"))
                             for o in wd.get("open") or ()) or "-"
            cell = (f"<code>{html.escape(str(wd.get('digest')))}</code>"
                    f" open={html.escape(open_)}")
            if not wd.get("synced"):
                cell += ' <b style="color:#b00">DESYNCED</b>'
            return cell

        wrows = "".join(
            f"<tr><td>{html.escape(w)}</td>"
            f"<td>{html.escape(str(d.get('host')))}</td>"
            f"<td>{html.escape(str(d.get('backend')))}</td>"
            f"<td>{html.escape(str(d.get('version') or '—'))}</td>"
            f"<td>{d.get('device-slots')}</td>"
            f"<td>{d.get('age-s')}s</td>"
            f"<td>{'alive' if d.get('alive') else 'silent'}</td>"
            f"<td>{_fresh_cell(d)}</td>"
            f"<td>{_wwin(d)}</td></tr>"
            for w, d in sorted((s.get("workers") or {}).items()))
        lrows = "".join(
            f"<tr><td><code>{html.escape(str(l['run']))}</code></td>"
            f"<td>{html.escape(str(l['worker']))}</td>"
            f"<td>{l['deadline']}</td></tr>"
            for l in s.get("leases") or [])
        sched_html = ""
        sched = s.get("nemesis-schedule")
        if sched:
            grows = []
            gens = sched.get("gens") or {}
            digests = sched.get("digest-by-gen") or {}
            for g in sorted(gens, key=lambda x: int(x)):
                wins = " ".join(
                    f"[{w.get('pos')}:{html.escape(str(w.get('fault')))}"
                    f"@{w.get('at_s')}s+{w.get('dur_s')}s]"
                    for w in gens[g])
                grows.append(
                    f"<tr><td>{html.escape(str(g))}</td>"
                    f"<td><code>{html.escape(str(digests.get(g)))}"
                    f"</code></td><td>{wins}</td></tr>")
            sched_html = (
                "<h2>nemesis schedule</h2>"
                f"<p>{sched.get('windows')} synchronized window(s) per "
                f"generation over "
                f"<code>{html.escape('|'.join(sched.get('faults')))}"
                "</code> &mdash; every host's cell for a generation "
                "installs the same seeded set (workers table shows "
                "installed digests)</p>"
                "<table><tr><th>gen</th><th>digest</th>"
                f"<th>windows</th></tr>{''.join(grows)}</table>")
        ap_html = ""
        ap = s.get("autopilot")
        if ap:
            # the autopilot panel: generation counter,
            # quarantine set, last gate verdicts, managed workers
            qrows = "".join(
                f"<tr><td><code>{html.escape(k)}</code></td>"
                f"<td>{html.escape(str(q.get('span')))}</td>"
                f"<td>{q.get('rel-delta')}</td>"
                f"<td>{html.escape(str(q.get('gen')))}</td></tr>"
                for k, q in sorted(
                    (ap.get("quarantined") or {}).items()))
            vrows = "".join(
                f"<tr><td>{html.escape(str(v.get('span')))}</td>"
                f"<td>{html.escape(str(v.get('status')))}</td>"
                f"<td>{v.get('rc')}</td>"
                f"<td>{html.escape(str(v.get('reason') or ''))}</td>"
                "</tr>"
                for v in ap.get("last-verdicts") or [])
            arows = "".join(
                f"<tr><td>{html.escape(n)}</td>"
                f"<td>{html.escape(str(w.get('version')))}</td>"
                f"<td>{w.get('pid')}</td>"
                f"<td>{'running' if w.get('running') else 'exited'}"
                f"{' (draining)' if w.get('draining') else ''}"
                "</td></tr>"
                for n, w in sorted((ap.get("workers") or {}).items()))
            ap_html = (
                "<h2>autopilot</h2>"
                f"<p>generation <b>{html.escape(str(ap.get('generation')))}</b> "
                f"({ap.get('generations-closed')} closed) &middot; "
                f"target worker version "
                f"<code>{html.escape(str(ap.get('worker-version')))}</code> "
                f"&middot; journal "
                f"<code>{html.escape(str(ap.get('journal-digest')))}</code></p>"
                "<h3>quarantined cells</h3>"
                "<table><tr><th>key</th><th>span</th><th>rel delta</th>"
                f"<th>since gen</th></tr>{qrows or '<tr><td colspan=4>(none)</td></tr>'}</table>"
                "<h3>last gate verdicts</h3>"
                "<table><tr><th>span</th><th>status</th><th>rc</th>"
                f"<th>reason</th></tr>{vrows or '<tr><td colspan=4>(no closed generation yet)</td></tr>'}</table>"
                "<h3>managed workers</h3>"
                "<table><tr><th>worker</th><th>version</th><th>pid</th>"
                f"<th>state</th></tr>{arows or '<tr><td colspan=4>(none)</td></tr>'}</table>")
            al = ap.get("alerts") or {}
            alrows = "".join(
                f"<tr><td><code>{html.escape(str(a.get('rule')))}"
                "</code></td>"
                f"<td>{html.escape(str(a.get('severity')))}</td>"
                f"<td><b style=\"color:{'#b00' if a.get('state') == 'firing' else '#b60'}\">"
                f"{html.escape(str(a.get('state')))}</b></td>"
                f"<td>{a.get('value')}</td></tr>"
                for a in al.get("active") or [])
            ap_html += (
                '<h3><a href="/alerts">alerts</a></h3>'
                f"<p>{al.get('rules', 0)} rule(s) &middot; "
                f"{len(al.get('firing') or [])} firing, "
                f"{len(al.get('pending') or [])} pending &middot; "
                f"notifications {al.get('sends-ok', 0)} ok / "
                f"{al.get('sends-failed', 0)} failed &middot; journal "
                f"<code>{html.escape(str(al.get('digest')))}</code></p>"
                "<table><tr><th>rule</th><th>severity</th><th>state</th>"
                f"<th>value</th></tr>{alrows or '<tr><td colspan=4>(quiet)</td></tr>'}</table>")
        name = str(s.get("campaign"))
        state = "finished" if s.get("finished") else "running"
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>fleet — {html.escape(name)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; margin-bottom: 1.5em; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/">&larr; runs</a> &middot;
<a href="/campaign/{quote(name)}">campaign</a> &middot;
<a href="/campaign/{quote(name)}/live">live</a> &middot;
<a href="/fleet/status">status.json</a></p>
<h1>fleet — {html.escape(name)}</h1>
<p>{state}: {s.get("done")}/{s.get("total")} cells done &middot;
queue depth {s.get("queue-depth")}, claim-latency p95
{s.get("claim-latency-p95-s") if s.get("claim-latency-p95-s")
 is not None else "&mdash;"}s &middot;
{c.get("claimed")} claimed &middot;
{c.get("requeues")} requeues, {c.get("duplicates")} duplicate
completions discarded &middot; queue digest
<code>{html.escape(str(s.get("digest")))}</code></p>
{ap_html}
<h2>workers</h2>
<table><tr><th>worker</th><th>host</th><th>backend</th>
<th>version</th>
<th>device slots</th><th>last seen</th><th></th>
<th>verdict freshness</th>
<th>installed windows</th></tr>{wrows or
'<tr><td colspan="9">(none registered)</td></tr>'}</table>
<h2>active leases</h2>
<table><tr><th>run</th><th>worker</th><th>deadline</th></tr>{lrows or
'<tr><td colspan="3">(none)</td></tr>'}</table>
{sched_html}
</body></html>"""
        self._send(200, doc.encode())

    def _alerts_page(self):
        """``/alerts``: the watchtower view — every rule's
        current state from the durable ``alerts.jsonl`` journal (replayed
        read-only, so the page works on a dead store too), firing first."""
        from .telemetry import alerts as alerts_mod

        path = alerts_mod.alerts_path(self.base)
        jr = alerts_mod.AlertJournal(path) if os.path.exists(path) \
            else None
        states = dict(jr.states) if jr is not None else {}
        order = {"firing": 0, "pending": 1, "resolved": 2}

        def _hist(rule):
            return (f'<a href="/metrics">ALERTS{{alertname='
                    f'&quot;{html.escape(rule)}&quot;}}</a>')

        rows = "".join(
            f"<tr><td><code>{html.escape(r)}</code></td>"
            f"<td>{html.escape(str(d.get('severity')))}</td>"
            f"<td><b style=\"color:"
            f"{'#b00' if d.get('state') == 'firing' else '#b60' if d.get('state') == 'pending' else '#080'}\">"
            f"{html.escape(str(d.get('state')))}</b></td>"
            f"<td>{d.get('value')}</td>"
            f"<td>{d.get('since')}</td>"
            f"<td>{d.get('seq')}</td>"
            f"<td>{_hist(r)}</td></tr>"
            for r, d in sorted(
                states.items(),
                key=lambda kv: (order.get(kv[1].get("state"), 3),
                                kv[0])))
        meta = ""
        if jr is not None:
            meta = (f"<p>journal <code>{html.escape(jr.digest())}"
                    "</code> &middot; notifications "
                    f"{jr.sends_ok} ok / {jr.sends_failed} failed "
                    f"&middot; <code>{html.escape(path)}</code></p>")
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>alerts</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #bbb; padding: 4px 10px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/">&larr; runs</a>{' &middot; <a href="/fleet">fleet</a>'
 if self.fleet is not None else ''} &middot;
<a href="/metrics">metrics</a></p>
<h1>alerts</h1>
{meta}
<table><tr><th>rule</th><th>severity</th><th>state</th><th>value</th>
<th>since</th><th>seq</th><th>series</th></tr>{rows or
'<tr><td colspan="7">(no alert journal yet)</td></tr>'}</table>
</body></html>"""
        self._send(200, doc.encode())

    def _timeline(self, key: str):
        """``/timeline/<run-id>``: the run's
        stitched cross-host waterfall — enqueue wait, claim latency,
        execute phases, live-sweep overlap, upload, landing — one bar
        per host-attributed segment on absolute time, from the
        warehouse's ``trace_spans`` view (`cli obs ingest` feeds it)."""
        from .telemetry import warehouse as wmod

        key = unquote(key).rstrip("/")
        if not key:
            return self._send(404, b"timeline needs a run id",
                              "text/plain")
        wh = wmod.open_if_exists(self.base)
        if wh is None:
            return self._send(
                404, b"no warehouse (run `cli obs ingest` first)",
                "text/plain")
        tl = wh.trace_timeline(key)
        if not tl.get("spans") and not tl.get("orphans"):
            return self._send(
                404, b"no trace spans for this run (run `cli obs "
                b"ingest` after it lands; traced runs need telemetry "
                b"or a fleet ledger)", "text/plain")
        lay = wmod.Warehouse.timeline_layout(tl)
        spans, hosts, wall = lay["spans"], lay["hosts"], lay["wall"]
        palette = ("#6b8fc9", "#74b474", "#c9a35a", "#b07fc9",
                   "#c97b7b", "#6bbcbc")
        color = {h: palette[i % len(palette)]
                 for i, h in enumerate(hosts)}
        rows = []
        for s in spans:
            dur = s.get("dur_s") or 0.0
            left = 100.0 * s["frac_left"]
            width = max(100.0 * s["frac_width"], 0.3)
            host = str(s.get("host") or "-")
            rows.append(
                "<tr>"
                f"<td><code>{html.escape(host)}</code></td>"
                f"<td><code>{html.escape(str(s.get('name')))}</code>"
                f"</td><td>{s['off']:+.3f}s</td><td>{dur:.3f}s</td>"
                f'<td class="lane"><div class="bar" style="margin-left:'
                f"{left:.2f}%;width:{min(width, 100.0 - left):.2f}%;"
                f'background:{color.get(host, "#999")}"></div></td>'
                "</tr>")
        orphans = tl.get("orphans") or []
        orphan_html = ""
        if orphans:
            items = "".join(
                f"<li><code>{html.escape(str(o.get('trace_id')))}"
                f"</code> {html.escape(str(o.get('name')))} "
                f"host={html.escape(str(o.get('host')))}</li>"
                for o in orphans)
            orphan_html = (
                '<h2 style="color:#b03030">orphan spans</h2>'
                "<p>recorded against this run under a DIFFERENT trace "
                "id — the stitching contract (one run, one trace) is "
                f"broken</p><ul>{items}</ul>")
        legend = " ".join(
            f'<span class="b" style="background:{color[h]}">'
            f"{html.escape(h)}</span>" for h in hosts)
        doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>timeline — {html.escape(key)}</title><style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; width: 100%; }}
td, th {{ border: 1px solid #bbb; padding: 3px 8px;
          white-space: nowrap; }}
td.lane {{ width: 55%; background: #f6f6f6; }}
.bar {{ height: 12px; border-radius: 2px; }}
{_BADGE_CSS}</style></head><body>
<p><a href="/">&larr; runs</a></p>
<h1>timeline — <code>{html.escape(str(tl.get("run") or key))}</code></h1>
<p>trace <code>{html.escape(str(tl["trace-id"]))}</code> &middot;
{len(spans)} spans over {len(hosts) or 1} host(s) &middot;
{wall:.3f}s wall &middot; {legend}</p>
<table><tr><th>host</th><th>segment</th><th>start</th><th>dur</th>
<th>timeline</th></tr>{"".join(rows)}</table>
{orphan_html}
<p>per-segment durations are queryable: <code>cli obs sql "SELECT
host, name, dur_s FROM trace_spans WHERE run = '{html.escape(str(
    tl.get("run") or key))}' ORDER BY t0"</code>; gate control-plane
segments like any span: <code>cli obs gate --span
fleet:claim-to-start</code> (docs/TELEMETRY.md)</p>
</body></html>"""
        self._send(200, doc.encode())

    def _files(self, rel: str):
        p = self._safe_path(rel.rstrip("/"))
        if p is None or not os.path.exists(p):
            return self._send(404, b"not found", "text/plain")
        if os.path.isdir(p):
            entries = sorted(os.listdir(p))
            items = "".join(
                f'<li><a href="/files/{quote(os.path.join(rel.rstrip("/"), e))}'
                f'{"/" if os.path.isdir(os.path.join(p, e)) else ""}">'
                f"{html.escape(e)}</a></li>" for e in entries)
            doc = (f"<html><body><h2>{html.escape(rel)}</h2>"
                   f'<p><a href="/">&larr; runs</a></p><ul>{items}</ul>'
                   f"</body></html>")
            return self._send(200, doc.encode())
        ctype = {
            ".html": "text/html; charset=utf-8",
            ".json": "application/json",
            ".png": "image/png",
            ".svg": "image/svg+xml",
            ".log": "text/plain; charset=utf-8",
            ".edn": "text/plain; charset=utf-8",
        }.get(os.path.splitext(p)[1], "application/octet-stream")
        with open(p, "rb") as f:
            self._send(200, f.read(), ctype)

    def _zip(self, rel: str):
        p = self._safe_path(rel)
        if p is None or not os.path.isdir(p):
            return self._send(404, b"not found", "text/plain")
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for root, _dirs, files in os.walk(p):
                for fn in files:
                    full = os.path.join(root, fn)
                    z.write(full, os.path.relpath(full, os.path.dirname(p)))
        name = rel.replace(os.sep, "-") + ".zip"
        self._send(200, buf.getvalue(), "application/zip",
                   {"Content-Disposition": f'attachment; filename="{name}"'})

    def log_message(self, fmt, *args):  # quiet by default
        logger.debug("web: " + fmt, *args)


def serve(port: int = 8080, base: Optional[str] = None, *,
          host: str = "127.0.0.1",
          background: bool = False,
          verifier: Any = None,
          fleet: Any = None) -> ThreadingHTTPServer:
    """Serve the store dir (reference `web/serve!`).  Binds localhost by
    default — stored test maps can hold cluster details; pass
    host="0.0.0.0" explicitly to expose.  With background=True, runs in a
    daemon thread and returns the server (tests use this).  Pass a
    `verifier.VerifierService` to route the ingest endpoints
    (`cli serve --ingest`; docs/VERIFIER.md), and/or a
    `fleet.FleetCoordinator` to route the fleet control plane
    (`cli fleet serve`; docs/FLEET.md)."""
    handler = type("Handler", (_Handler,), {"base": base or store.BASE,
                                            "verifier": verifier,
                                            "fleet": fleet})
    srv = ThreadingHTTPServer((host, port), handler)
    logger.info("serving store %s on port %d%s%s", base or store.BASE,
                port,
                " (verifier ingest on)" if verifier is not None else "",
                " (fleet control plane on)" if fleet is not None else "")
    if background:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        # make server_close STOP the loop first: closing the socket
        # under a live serve_forever leaves that thread select()ing on
        # a closed fd — which returns ready instantly, i.e. a leaked
        # CPU-spinning thread per server.  A suite's worth of those was
        # measurably convoying every GIL-releasing C call (sqlite,
        # sockets) in the process — the source of its "ambient load"
        # timing flakes.
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
