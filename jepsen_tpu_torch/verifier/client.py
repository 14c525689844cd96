"""The live-check client: `core.run`'s interpreter → verifier stream (the
port's copy of `jepsen_tpu/verifier/client.py`).

A :class:`LiveCheck` turns a running test into
a verifier session *while it executes*: the interpreter's dispatch loop
feeds every history event (invokes and completions, in history order)
into :meth:`feed`, a background sender flushes them as journal-shaped
jsonl segments with the cursor protocol (resend-from-acked-cursor on
reconnect, so a lost ack or a restarted verifier never doubles ops),
and :meth:`finish` closes the loop — rolling verdict, optional seal
(incremental == batch asserted server-side).

Transports:

- ``{"url": "http://host:port"}`` — a remote verifier service
  (``serve --ingest``, or a fleet coordinator serving one), its checks
  on that server's device; every request carries the run's
  ``Jepsen-Trace`` header;
- ``{"inproc": true}`` — an in-process `VerifierService` over the
  run's own store (no daemon needed; the service's ``verifier.sweep``
  spans then land in the run's telemetry), its seal checks on the
  run's device (the CPU when the test map has ``"cpu"``, else the
  card).

Every service call rides `resilience.device_call` (fault site
``verifier.live``) with a seeded `RetryPolicy` + `is_transient_http`,
so coordinator restarts and partitions are ridden out with bounded
backoff.  An HTTP error carries the server's own ``error`` text, so a
device error on the server (a 500 naming `NoDeviceError` or
`KernelError`) is named in the degraded state's reason.

Graceful degradation is the contract: a verifier partitioned past
``budget-s`` (cumulative outage) flips the client to **degraded** —
feeding becomes a no-op, the run completes normally, the ordinary
stored-history check stands alone, and the results carry
``{"live-check": {"state": "degraded", ...}}``.  The live path is an
accelerant, never a dependency.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
import zlib
from typing import Any, Dict, Optional

from jepsen_tpu_torch import resilience, store
from jepsen_tpu_torch.resilience import RetryPolicy
from jepsen_tpu_torch.resilience.policy import is_transient_http
from jepsen_tpu_torch.telemetry import spans as spans_mod

logger = logging.getLogger("jepsen.verifier")

__all__ = ["LiveCheck", "live_check_for", "live_check_config",
           "LIVE_SITE"]

#: the client-side fault/guard site (FaultPlan target): chaos tooling
#: partitions the live stream here without touching the workload
LIVE_SITE = "verifier.live"


class LiveCheck:
    """One live-checked session for one run.  Thread contract: `feed`
    is called from the interpreter's single dispatch thread (cheap:
    serialize + append under a lock); a daemon sender thread owns all
    network/service I/O, so a slow or partitioned verifier never
    stalls the workload."""

    def __init__(self, target: Any, session: str, *,
                 seal: bool = True,
                 budget_s: float = 5.0,
                 flush_ops: int = 256,
                 flush_interval_s: float = 0.25,
                 timeout_s: float = 3.0,
                 retry: Optional[RetryPolicy] = None,
                 open_config: Optional[Dict[str, Any]] = None):
        self.session = session
        self.seal = bool(seal)
        self.budget_s = float(budget_s)
        self.flush_ops = max(1, int(flush_ops))
        self.flush_interval_s = float(flush_interval_s)
        self.timeout_s = float(timeout_s)
        self.retry = retry or RetryPolicy(
            max_attempts=4, base_delay_s=0.1, multiplier=2.0,
            max_delay_s=1.0,
            # stable per-session seed: hash() is randomized per
            # process (PYTHONHASHSEED), which would make the backoff
            # jitter — alone in this repo — non-replayable
            seed=zlib.crc32(session.encode()) & 0xFFFF,
            classify=is_transient_http)
        self._url: Optional[str] = None
        self._svc = None
        self._own_svc = False  # set by live_check_for for in-proc mode
        if isinstance(target, str):
            self._url = target.rstrip("/")
        else:
            self._svc = target
        # distributed trace: the session rides its run's
        # trace — from the open config's trace-id (fleet cells), else
        # whatever trace core.run installed on this thread.  Captured
        # here because the sender runs on its own thread, where the
        # thread-local would be empty.
        tid = (open_config or {}).get("trace-id")
        self._trace: Optional[spans_mod.TraceContext] = (
            spans_mod.trace_context(str(tid), "verifier:live") if tid
            else spans_mod.current_trace())
        self._lock = threading.Lock()
        self._buf = bytearray()      # unacked bytes (suffix of stream)
        self._cursor = 0             # acked logical stream offset
        self.ops_fed = 0
        self.ops_dropped = 0         # unserializable ops (skipped)
        self.degraded = False
        self.last_error: Optional[str] = None
        self._outage_s = 0.0
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._sender: Optional[threading.Thread] = None
        self._opened = False
        self._open(open_config)
        if not self.degraded:
            self._sender = threading.Thread(
                target=self._sender_loop, daemon=True,
                name=f"live-check-{session}")
            self._sender.start()

    # -- transport ----------------------------------------------------------

    def _call(self, what: str, fn) -> Any:
        """One guarded verifier call: fault site ``verifier.live``,
        transient retries per the seeded policy, run under the
        session's trace context (so the in-proc service's trace
        adoption sees it even from the sender thread).  Raises when
        retries are exhausted — the caller accounts the outage, this
        just names the verb (`what`) in the diagnostic."""
        try:
            with spans_mod.trace_scope(self._trace):
                return resilience.device_call(LIVE_SITE, fn,
                                              policy=self.retry)
        except Exception as e:
            logger.debug("live-check %s: %s failed (%s)",
                         self.session, what, e)
            raise

    def _http(self, method: str, path: str, body: bytes = b""
              ) -> Dict[str, Any]:
        req = urllib.request.Request(
            self._url + path, data=body if method == "POST" else None,
            method=method)
        if self._trace is not None:
            req.add_header(spans_mod.TRACE_HEADER, self._trace.header())
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            # the same status, its message the server's own error text
            raise urllib.error.HTTPError(
                e.url, e.code, f"{e.reason}: {_error_text(e)}", e.headers,
                None) from None

    def _svc_checked(self, code: int, doc: Dict[str, Any]
                     ) -> Dict[str, Any]:
        """In-proc responses mirror HTTP semantics: 5xx raises like a
        transport error (retried / counted against the budget), 4xx is
        a protocol error and propagates."""
        if code >= 500:
            raise OSError(f"verifier {code}: {doc.get('error')}")
        if code >= 400:
            raise ValueError(f"verifier {code}: {doc.get('error')}")
        return doc

    def _open(self, config: Optional[Dict[str, Any]]) -> None:
        try:
            if self._svc is not None:
                self._call("open", lambda: self._svc_checked(
                    *self._svc.open(self.session, config)))
            else:
                body = json.dumps(config or {}).encode()
                self._call("open", lambda: self._http(
                    "POST", f"/verifier/{self.session}/open", body))
            self._opened = True
        except Exception as e:  # noqa: BLE001 — a dead verifier at
            # open time degrades immediately; the run proceeds
            self._degrade(f"open failed: {type(e).__name__}: {e}")

    def _ingest(self, body: bytes, cursor: int) -> Dict[str, Any]:
        if self._svc is not None:
            return self._call("ingest", lambda: self._svc_checked(
                *self._svc.ingest(self.session, body, cursor=cursor)))
        return self._call("ingest", lambda: self._http(
            "POST", f"/ingest/{self.session}?cursor={cursor}", body))

    # -- the feed path (interpreter dispatch thread) ------------------------

    def feed(self, op: Dict[str, Any]) -> None:
        """Append one history event.  Never raises, never blocks on
        I/O; once degraded it is a no-op."""
        if self.degraded:
            return
        try:
            line = json.dumps(op).encode() + b"\n"
        except (TypeError, ValueError):
            self.ops_dropped += 1
            return
        with self._lock:
            self._buf.extend(line)
            self.ops_fed += 1
            n = len(self._buf)
        if n >= self.flush_ops * 64:  # rough bytes heuristic; the
            self._kick.set()          # sender also wakes on interval
        if self.ops_fed % self.flush_ops == 0:
            self._kick.set()

    # -- the sender (background) --------------------------------------------

    def _degrade(self, why: str) -> None:
        self.last_error = why
        if not self.degraded:
            self.degraded = True
            with self._lock:
                self._buf.clear()
            logger.warning("live-check %s degraded: %s (run proceeds; "
                           "stored-history check takes over)",
                           self.session, why)
            try:
                from jepsen_tpu_torch import telemetry

                telemetry.registry().counter(
                    "verifier-live-degraded").inc()
            except Exception:  # noqa: BLE001
                pass

    def _flush_once(self) -> bool:
        """Send the unacked buffer from the acked cursor.  Returns True
        when something was acked (or nothing needed sending)."""
        with self._lock:
            body = bytes(self._buf)
            cursor = self._cursor
        if not body:
            return True
        t0 = time.monotonic()
        try:
            r = self._ingest(body, cursor)
        except Exception as e:  # noqa: BLE001 — outage accounting
            self._outage_s += time.monotonic() - t0
            self.last_error = f"{type(e).__name__}: {e}"
            if self._outage_s > self.budget_s:
                self._degrade(
                    f"outage {self._outage_s:.1f}s past the "
                    f"{self.budget_s:.1f}s budget ({self.last_error})")
            return False
        self._outage_s = 0.0  # contact restored resets the budget
        new_cursor = int(r.get("cursor", cursor))
        if new_cursor > cursor:
            with self._lock:
                drop = new_cursor - self._cursor
                if 0 < drop <= len(self._buf):
                    del self._buf[:drop]
                self._cursor = new_cursor
        return True

    def _sender_loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(self.flush_interval_s)
            self._kick.clear()
            if self.degraded:
                return
            self._flush_once()

    # -- finish -------------------------------------------------------------

    def _verdict(self) -> Dict[str, Any]:
        if self._svc is not None:
            return self._call("verdict", lambda: self._svc_checked(
                *self._svc.verdict(self.session)))
        return self._call("verdict", lambda: self._http(
            "GET", f"/verdict/{self.session}"))

    def _seal(self) -> Dict[str, Any]:
        if self._svc is not None:
            return self._call("seal", lambda: self._svc_checked(
                *self._svc.seal(self.session)))
        return self._call("seal", lambda: self._http(
            "POST", f"/verifier/{self.session}/seal"))

    def finish(self) -> Dict[str, Any]:
        """Drain the stream and close the loop: join the sender (it
        finishes its current flush), final flush, rolling verdict,
        optional seal.  Returns the summary `core.run` stamps into
        ``results["live-check"]``.  Never raises."""
        self._stop.set()
        self._kick.set()
        if self._sender is not None:
            self._sender.join()
        # the final flush gets its own bounded budget window
        deadline = time.monotonic() + self.budget_s
        while not self.degraded:
            if self._flush_once():
                with self._lock:
                    if not self._buf:
                        break
            if time.monotonic() > deadline:
                self._degrade("final flush outlasted the budget")
                break
            time.sleep(0.05)
        base = {"session": self.session, "ops": self.ops_fed,
                "ops-dropped": self.ops_dropped,
                "cursor": self._cursor}
        try:
            if self.degraded:
                return dict(base, state="degraded",
                            **({"reason": self.last_error}
                               if self.last_error else {}))
            try:
                v = self._verdict()
                out = dict(base, state="ok", **{
                    "valid?": v.get("valid?"),
                    "anomaly-types": v.get("anomaly-types"),
                    "digest": v.get("digest"),
                    "txns": v.get("txns"),
                })
                if self.seal:
                    s = self._seal()
                    out["seal"] = {"equal": s.get("equal"),
                                   "digest": s.get("digest")}
                return out
            except Exception as e:  # noqa: BLE001
                self._degrade(f"verdict/seal failed: "
                              f"{type(e).__name__}: {e}")
                return dict(base, state="degraded",
                            reason=self.last_error)
        finally:
            self._close_own_service()

    def _close_own_service(self) -> None:
        if self._own_svc and self._svc is not None:
            try:
                self._svc.close()
            except Exception:  # noqa: BLE001
                pass
            self._svc = None

    def close(self) -> None:
        """Abandon without a verdict (crashed workloads): stop and join
        the sender, keep whatever was already journaled server-side."""
        self._stop.set()
        self._kick.set()
        if self._sender is not None:
            self._sender.join()
        self._close_own_service()


def _error_text(e: urllib.error.HTTPError) -> str:
    """The ``error`` of a JSON answer, else the answer's text."""
    try:
        raw = e.read().decode(errors="replace")
    except Exception:  # noqa: BLE001 — the status alone still counts
        return "?"
    try:
        doc = json.loads(raw)
    except ValueError:
        return raw.strip()
    return str(doc.get("error")) if isinstance(doc, dict) else raw.strip()


def live_check_config(test: dict) -> Optional[Dict[str, Any]]:
    """The run's ``"live-check"`` value as a config dict (None when the
    key is absent or false): a URL string means ``{"url": ...}``,
    ``true`` means ``{"inproc": true}``.  Raises `ValueError` on a
    malformed value — `core.run` calls this before the run starts
    anything."""
    cfg = test.get("live-check")
    if not cfg:
        return None
    if isinstance(cfg, str):
        cfg = {"url": cfg}
    elif cfg is True:
        cfg = {"inproc": True}
    if not isinstance(cfg, dict):
        raise ValueError(f"bad live-check config {cfg!r}")
    return cfg


def live_check_for(test: dict) -> Optional[LiveCheck]:
    """Build the run's `LiveCheck` from its ``"live-check"`` test key:

    - a URL string, or ``{"url": ...}`` — remote service (``serve
      --ingest``), its checks on that server's device;
    - ``{"inproc": true}`` (or ``true``) — in-process service over the
      run's store, its checks on the CPU when the test map has
      ``"cpu"``, else on the card;
    - knobs: ``session`` (default: the run dir identity), ``seal``,
      ``budget-s``, ``flush-ops``, ``flush-interval-s``, ``timeout-s``,
      plus any verifier session config under ``config`` (forwarded to
      open).
    """
    cfg = live_check_config(test)
    if cfg is None:
        return None
    session = cfg.get("session")
    if not session:
        d = store.test_dir(test)
        session = store.sanitize(
            f"{test.get('name', 'run')}-{os.path.basename(d)}"
        ).replace(" ", "_")
    own_svc = False
    target: Any
    if cfg.get("url"):
        target = str(cfg["url"])
    else:
        from .service import VerifierService

        target = VerifierService(store._base(test),
                                 device="cpu" if test.get("cpu") else None)
        own_svc = True
    open_config = dict(cfg.get("config") or {})
    # trace + host attribution: the session's journal
    # metadata names the run's trace and the executing fleet host, so
    # the warehouse can stitch live-sweep segments into the run's
    # cross-host timeline and the /fleet page can show per-host
    # verdict freshness
    if test.get("trace-id"):
        open_config.setdefault("trace-id", str(test["trace-id"]))
    if test.get("fleet-host"):
        open_config.setdefault("host", str(test["fleet-host"]))
    lc = LiveCheck(
        target, str(session),
        seal=bool(cfg.get("seal", True)),
        budget_s=float(cfg.get("budget-s", 5.0)),
        flush_ops=int(cfg.get("flush-ops", 256)),
        flush_interval_s=float(cfg.get("flush-interval-s", 0.25)),
        timeout_s=float(cfg.get("timeout-s", 3.0)),
        open_config=open_config or None)
    lc._own_svc = own_svc
    return lc
