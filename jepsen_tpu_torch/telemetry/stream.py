"""The flight recorder: streaming telemetry for in-flight runs (the port's
copy of `jepsen_tpu/telemetry/stream.py`).

Export-only telemetry — ``telemetry.json`` / ``trace.json``
appear at ``store.save_1``, so the runs this framework exists to study
(wedged checkers, crashed workers, deadline-killed campaign cells)
leave *no* observability artifact at all.  This module makes the active
collector *stream*: every span open/close, every metric delta, and
every resilience event (fault injected, retry, host fallback, deadline
expiry) is appended to an ``events.jsonl`` in the run dir **as it
happens**, fsync'd per event, so a SIGKILLed run still yields a
readable partial trace (tail-truncated at worst — the reader drops one
torn trailing line, exactly like the campaign ledger).

Pieces:

- :class:`EventStream` — the append-only fsync'd jsonl writer.  Never
  raises into the instrumented code: any IO failure marks the stream
  broken and subsequent emits are dropped.
- :class:`ResourceSampler` — a daemon thread sampling process RSS,
  thread count, and device memory (``torch.cuda.memory_stats`` when
  this process has *already* initialized CUDA — the sampler must never
  be the thing that creates a CUDA context) into gauges + ``sample``
  events; :meth:`ResourceSampler.stop` joins it.
- :func:`attach` — wire a stream + sampler onto a live
  :class:`~.spans.Collector`; ``core.run`` does this for every
  telemetric run, ``minimize.shrink`` for shrink sessions.
- :func:`read_events` / :func:`replay` / :func:`render_tail` — the
  torn-line-tolerant reader and the human renderer behind ``cli tail``
  and the web ``/live`` views.
- :class:`Heartbeat` — an atomically-replaced JSON state file for the
  campaign scheduler's per-worker in-flight heartbeats
  (``<store>/campaigns/<name>.live.json``), the data behind the live
  fleet dashboard.

Event shapes (one JSON object per line, ``t`` = epoch seconds)::

    {"t": ..., "ev": "start", ...meta}
    {"t": ..., "ev": "span-open", "name": "check:list-append", "tid": ...}
    {"t": ..., "ev": "span", "name": ..., "dur_ns": ..., "attrs": {...}}
    {"t": ..., "ev": "metrics", "counters": {"name{k=v}": value}, ...}
    {"t": ..., "ev": "sample", "rss_bytes": ..., "threads": ...}
    {"t": ..., "ev": "fault"|"retry"|"fallback"|"deadline", "site": ...}
    {"t": ..., "ev": "end", ...}

Metric events carry *changed instruments with their current values*
(incremental updates, not raw increments): replaying every metrics
event in order leaves the reader holding the final tallies, which is
what ``cli tail``'s footer prints for a killed run.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .export import _fmt_dur, _jsonable
from .metrics import Registry

__all__ = ["EventStream", "ResourceSampler", "Recorder", "Heartbeat",
           "HttpHeartbeat",
           "attach", "event", "read_events", "replay", "render_line",
           "render_tail", "segment_files", "follow_events",
           "EVENTS_FILE", "SHRINK_EVENTS_FILE", "events_path"]

EVENTS_FILE = "events.jsonl"
SHRINK_EVENTS_FILE = "events-shrink.jsonl"


def events_path(dirpath: str) -> Optional[str]:
    """The run dir's streamed-events file — whichever of the run's own
    stream and the shrink session's was written to most recently, so
    tailing a dir follows the LIVE activity (a `cli shrink` of an
    already-ended telemetric run streams events-shrink.jsonl next to
    the finished events.jsonl; preferring the run stream would replay
    the ended run and exit instead of following the shrink).  Ties go
    to the run's own stream.  THE lookup `cli tail` and the web
    `/live` + link surfaces share, so they can't disagree about which
    runs are followable."""
    best: Optional[str] = None
    best_mtime = float("-inf")
    for fn in (EVENTS_FILE, SHRINK_EVENTS_FILE):
        p = os.path.join(dirpath, fn)
        try:
            mtime = os.path.getmtime(p)
        except OSError:
            continue
        if mtime > best_mtime:
            best, best_mtime = p, mtime
    return best


def segment_files(path: str) -> List[str]:
    """All on-disk files of one rotated stream, oldest first: the
    rotation segments ``<path>.N`` (largest N = oldest) then the live
    file.  The reader-side contract behind size-based rotation: every
    surface that replays a stream (``read_events``, the warehouse
    ingest, ``cli tail``) spans segments through this one lookup."""
    d = os.path.dirname(path) or "."
    bn = os.path.basename(path)
    segs: List[Tuple[int, str]] = []
    try:
        names = os.listdir(d)
    except OSError:
        names = []
    pat = re.compile(re.escape(bn) + r"\.(\d+)$")
    for n in names:
        m = pat.match(n)
        if m:
            segs.append((int(m.group(1)), os.path.join(d, n)))
    out = [p for _, p in sorted(segs, reverse=True)]
    if os.path.exists(path):
        out.append(path)
    return out


def _remove_segments(path: str) -> None:
    for p in segment_files(path):
        if p != path:
            try:
                os.remove(p)
            except OSError:
                pass


def _label_key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    lbl = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{lbl}}}"


class _MetricsDelta:
    """Tracks last-streamed instrument values so each flush emits only
    what changed since the previous one (with current values)."""

    def __init__(self, registry: Registry):
        self.registry = registry
        self._last: Dict[Tuple[str, str], Any] = {}

    def changed(self) -> Optional[Dict[str, Dict[str, Any]]]:
        snap = self.registry.snapshot()
        out: Dict[str, Dict[str, Any]] = {}
        for c in snap["counters"]:
            k = ("c", _label_key(c["name"], c["labels"]))
            if self._last.get(k) != c["value"]:
                self._last[k] = c["value"]
                out.setdefault("counters", {})[k[1]] = c["value"]
        for g in snap["gauges"]:
            if g["value"] is None:
                continue
            k = ("g", _label_key(g["name"], g["labels"]))
            if self._last.get(k) != g["value"]:
                self._last[k] = g["value"]
                out.setdefault("gauges", {})[k[1]] = g["value"]
        for h in snap["histograms"]:
            k = ("h", _label_key(h["name"], h["labels"]))
            cur = (h["count"], h["sum"])
            if self._last.get(k) != cur:
                self._last[k] = cur
                out.setdefault("histograms", {})[k[1]] = {
                    "count": h["count"], "sum": round(h["sum"], 6)}
        return out or None


class EventStream:
    """Append-only fsync'd jsonl event sink.

    Crash-safety contract: each event is one ``write()`` of a complete
    line followed by ``fsync`` — a kill between the two leaves at most
    one torn trailing line, which :func:`read_events` drops.  Emits
    must NEVER raise into the instrumented run: any failure (disk full,
    closed fd) marks the stream broken and later emits are no-ops.

    Size-based rotation (``max_bytes``): when an append would push the
    live file past the bound, the stream records a ``rotate`` event
    in-stream, shifts ``events.jsonl`` → ``events.jsonl.1`` (… keep-N,
    the oldest segment dropped), and continues into a fresh live file
    opened with a ``rotate-cont`` marker — so soak/service runs never
    grow one unbounded file.  Readers span segments transparently via
    :func:`segment_files`."""

    def __init__(self, path: str, meta: Optional[Dict[str, Any]] = None,
                 *, max_bytes: Optional[int] = None, keep: int = 3):
        self.path = path
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.keep = max(1, int(keep))
        self._segment = 0
        self._bytes = 0
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self.broken = False
        self._metrics: Optional[_MetricsDelta] = None
        #: when a ResourceSampler is attached, its ``watermarks`` bound
        #: method — span closes stamp the current peaks into the span's
        #: attrs (so telemetry.json carries per-span high watermarks)
        self.watermarks: Optional[Any] = None
        # one session per file: truncate any previous stream (and drop
        # its rotation segments) — a --force re-shrink appending after
        # the old "end" event would make replay() render a killed
        # re-run as ended, with counters mixed across sessions
        _remove_segments(path)
        try:
            self._f = open(path, "wb", buffering=0)
        except OSError:
            self._f = None
            self.broken = True
        self.emit("start", **{k: v for k, v in (meta or {}).items()
                              if v is not None})

    def bind_registry(self, registry: Registry) -> None:
        """Attach the registry whose deltas :meth:`flush_metrics`
        streams (the collector's own, for per-run isolation)."""
        self._metrics = _MetricsDelta(registry)

    def emit(self, ev: str, **fields: Any) -> None:
        if self.broken:
            return
        rec: Dict[str, Any] = {"t": 0.0, "ev": ev}
        rec.update(fields)
        with self._lock:
            if self.broken or self._f is None:
                return
            # stamp under the lock so file order and timestamps agree
            rec["t"] = round(time.time(), 3)
            try:
                data = (json.dumps(_jsonable(rec), separators=(",", ":"))
                        + "\n").encode()
            except Exception:  # noqa: BLE001 — bad payload, stream fine
                return
            try:
                if self.max_bytes and self._bytes \
                        and self._bytes + len(data) > self.max_bytes:
                    self._rotate()
                self._f.write(data)
                self._bytes += len(data)
                os.fsync(self._f.fileno())
            except Exception:  # noqa: BLE001
                self.broken = True

    def _rotate(self) -> None:
        """Rotate the live file (caller holds the emit lock).  The old
        segment's LAST line is the ``rotate`` event and the new live
        file's FIRST line is ``rotate-cont`` — both in-stream, so a
        spanning replay sees an unbroken, self-describing sequence."""
        self._segment += 1

        def marker(ev: str) -> bytes:
            return (json.dumps({"t": round(time.time(), 3), "ev": ev,
                                "segment": self._segment},
                               separators=(",", ":")) + "\n").encode()

        self._f.write(marker("rotate"))
        os.fsync(self._f.fileno())
        self._f.close()
        oldest = f"{self.path}.{self.keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "wb", buffering=0)
        cont = marker("rotate-cont")
        self._f.write(cont)
        self._bytes = len(cont)

    # -- collector-facing hooks (spans.Collector calls these) ---------------

    def span_open(self, sp: Any) -> None:
        self.emit("span-open", name=sp.name, tid=sp.tid,
                  thread=sp.thread_name)

    def span_close(self, sp: Any) -> None:
        if self.watermarks is not None:
            # stamp the enclosing span with the run's current memory
            # high watermarks at its close — this lands in the span
            # event AND (the attrs dict is the live span's) in the
            # telemetry.json export, so peak memory is attributable to
            # the phase that drove it
            try:
                wm = self.watermarks()
                if wm:
                    sp.attrs.update(wm)
            except Exception:  # noqa: BLE001 — stamping is best-effort
                pass
        self.emit("span", name=sp.name, tid=sp.tid, dur_ns=sp.duration_ns,
                  **({"attrs": _jsonable(sp.attrs)} if sp.attrs else {}))
        # a span boundary is the natural metrics flush point: low-rate,
        # and it lands the workload counters before the check phase — a
        # run killed mid-check still shows its final op tallies
        self.flush_metrics()

    def flush_metrics(self) -> None:
        if self._metrics is None or self.broken:
            return
        # compute-delta + emit must be one atomic step: two concurrent
        # span closes could otherwise stream a stale snapshot AFTER a
        # newer one, and replay() keeps the last value seen
        with self._flush_lock:
            try:
                delta = self._metrics.changed()
            except Exception:  # noqa: BLE001
                return
            if delta:
                self.emit("metrics", **delta)

    def close(self, **fields: Any) -> None:
        self.emit("end", **fields)
        with self._lock:
            try:
                if self._f is not None:
                    self._f.close()
            except Exception:  # noqa: BLE001
                pass
            self.broken = True


def event(ev: str, **fields: Any) -> None:
    """Emit one event onto the ACTIVE collector's stream, if any — the
    module-level hook resilience sites call (fault/retry/fallback/
    deadline); a no-op for unstreamed/disabled telemetry."""
    from . import spans

    s = getattr(spans.active(), "stream", None)
    if s is not None:
        s.emit(ev, **fields)


# ---------------------------------------------------------------------------
# Resource sampler
# ---------------------------------------------------------------------------

def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm", "rb") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001 — non-linux
        try:
            import resource

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # ru_maxrss is kilobytes on Linux/BSD but BYTES on macOS
            return rss if sys.platform == "darwin" else rss * 1024
        except Exception:  # noqa: BLE001
            return None


def _hwm_bytes() -> Optional[int]:
    """Kernel-tracked RSS high watermark (``VmHWM``) — catches a
    transient allocation spike even when every sampler tick missed it
    entirely, which is exactly what a watermark series is for."""
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f:
                if line.startswith(b"VmHWM:"):
                    return int(line.split()[1]) * 1024
    except Exception:  # noqa: BLE001 — non-linux
        pass
    return None


def _device_memory_stats() -> "Dict[str, Tuple[int, Optional[int]]]":
    """Per-card ``(bytes allocated now, peak bytes allocated)`` from
    ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` and
    ``.peak``).  Only consulted when torch is imported AND this process
    has already initialized CUDA — a sampler must never be the thing
    that creates a CUDA context (hundreds of MB on the card, seconds of
    start-up) in a process that otherwise would not."""
    tm = sys.modules.get("torch")
    if tm is None:
        return {}
    out: Dict[str, Tuple[int, Optional[int]]] = {}
    try:
        if not tm.cuda.is_initialized():
            return {}
        for i in range(tm.cuda.device_count()):
            ms = tm.cuda.memory_stats(i)
            cur = ms.get("allocated_bytes.all.current")
            if cur is None:
                continue
            pk = ms.get("allocated_bytes.all.peak")
            out[f"cuda:{i}"] = (int(cur),
                                int(pk) if pk is not None else None)
    except Exception:  # noqa: BLE001 — sampling must never fail a run
        pass
    return out


def _device_memory() -> Dict[str, int]:
    return {dev: used
            for dev, (used, _pk) in _device_memory_stats().items()}


class ResourceSampler:
    """Daemon thread sampling process/device resources into gauges +
    ``sample`` events.  :meth:`start` samples once synchronously on the
    caller's thread (so even an instant run records one, and a short
    run never shares the GIL with a sampler tick — per-worker op-split
    tests stay deterministic), then the thread waits a full interval
    before its first tick; :meth:`stop` ALWAYS takes one final
    synchronous sample (marked ``"final": true``) on the caller's
    thread before detach — the state a post-mortem reads, and the
    guarantee that the peak gauges below reflect the whole run.

    Beyond instantaneous gauges the sampler maintains HIGH WATERMARKS
   : ``process-rss-peak-bytes`` (max of sampled
    RSS and the kernel's VmHWM, which catches spikes between ticks),
    ``device-memory-peak-bytes{device=}`` (the allocator's peak,
    ``allocated_bytes.all.peak``, or the sampled max if larger)
    and ``jit-cache-entries-peak``.  :meth:`watermarks` exposes them
    for span-close stamping (see :func:`attach`)."""

    def __init__(self, stream: EventStream, registry: Registry,
                 interval_s: float = 1.0):
        self.stream = stream
        self.registry = registry
        self.interval_s = max(0.02, float(interval_s))
        self.peak_rss = 0
        self.peak_dev: Dict[str, int] = {}
        self.peak_jit = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="telemetry-sampler")

    def start(self) -> None:
        try:
            self.sample()
        except Exception:  # noqa: BLE001 — sampling must never kill
            pass
        self._thread.start()

    def _run(self) -> None:
        while True:
            if self._stop.wait(self.interval_s):
                return
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — sampling must never kill
                pass

    def sample(self, final: bool = False) -> None:
        fields: Dict[str, Any] = {}
        rss = _rss_bytes()
        if rss is not None:
            self.registry.gauge("process-rss-bytes").set(rss)
            fields["rss_bytes"] = rss
            self.peak_rss = max(self.peak_rss, rss, _hwm_bytes() or 0)
            self.registry.gauge("process-rss-peak-bytes").set(
                self.peak_rss)
            fields["rss_peak_bytes"] = self.peak_rss
        n = threading.active_count()
        self.registry.gauge("process-threads").set(n)
        fields["threads"] = n
        for dev, (used, pk) in _device_memory_stats().items():
            self.registry.gauge("device-memory-bytes",
                                device=dev).set(used)
            fields.setdefault("device_bytes", {})[dev] = used
            peak = max(self.peak_dev.get(dev, 0), used, pk or 0)
            self.peak_dev[dev] = peak
            self.registry.gauge("device-memory-peak-bytes",
                                device=dev).set(peak)
            fields.setdefault("device_peak_bytes", {})[dev] = peak
        jit = self.registry.gauge("jit-cache-entries").value
        if jit:
            self.peak_jit = max(self.peak_jit, int(jit))
            self.registry.gauge("jit-cache-entries-peak").set(
                self.peak_jit)
        if final:
            fields["final"] = True
        self.stream.emit("sample", **fields)
        self.stream.flush_metrics()

    def watermarks(self) -> Dict[str, Any]:
        """The current high watermarks, in the shape span-close
        stamping writes into span attrs (empty until a sample has
        landed any)."""
        out: Dict[str, Any] = {}
        if self.peak_rss:
            out["rss_peak_bytes"] = self.peak_rss
        if self.peak_dev:
            out["device_peak_bytes"] = dict(self.peak_dev)
        if self.peak_jit:
            out["jit_cache_entries_peak"] = self.peak_jit
        return out

    def stop(self) -> None:
        """Stop and join the sampling thread, then take the final
        sample; the thread never outlives its run."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
        try:
            self.sample(final=True)
        except Exception:  # noqa: BLE001
            pass


class Recorder:
    """Handle returned by :func:`attach`: owns the stream + sampler
    lifetime; ``close()`` detaches and finalizes (idempotent)."""

    def __init__(self, collector: Any, stream: EventStream,
                 sampler: Optional[ResourceSampler]):
        self.collector = collector
        self.stream = stream
        self.sampler = sampler
        self._closed = False

    def close(self, **fields: Any) -> None:
        if self._closed:
            return
        self._closed = True
        if self.sampler is not None:
            self.sampler.stop()
        if getattr(self.collector, "stream", None) is self.stream:
            self.collector.stream = None
        self.stream.flush_metrics()
        self.stream.close(**fields)


def _env_int(name: str) -> Optional[int]:
    try:
        v = os.environ.get(name, "").strip()
        return int(v) if v else None
    except ValueError:
        return None


def attach(collector: Any, dirpath: str, *,
           meta: Optional[Dict[str, Any]] = None,
           interval_s: float = 1.0,
           filename: str = EVENTS_FILE,
           sampler: bool = True,
           max_bytes: Optional[int] = None,
           keep: Optional[int] = None) -> Recorder:
    """Attach a flight-recorder stream (and resource sampler) to a live
    collector; events land in ``<dirpath>/<filename>``.  Returns the
    :class:`Recorder` whose ``close()`` the activator must call.
    ``max_bytes``/``keep`` enable size-based rotation (soak runs);
    defaults come from ``JEPSEN_EVENTS_MAX_BYTES``/``JEPSEN_EVENTS_KEEP``
    when unset."""
    if max_bytes is None:
        max_bytes = _env_int("JEPSEN_EVENTS_MAX_BYTES")
    if keep is None:
        keep = _env_int("JEPSEN_EVENTS_KEEP") or 3
    s = EventStream(os.path.join(dirpath, filename), meta=meta,
                    max_bytes=max_bytes, keep=keep)
    reg = getattr(collector, "registry", None)
    if reg is not None:
        s.bind_registry(reg)
    smp = None
    if sampler and reg is not None:
        smp = ResourceSampler(s, reg, interval_s)
        s.watermarks = smp.watermarks
        smp.start()
    collector.stream = s
    return Recorder(collector, s, smp)


# ---------------------------------------------------------------------------
# Reading + rendering (cli tail, web /live)
# ---------------------------------------------------------------------------

def _read_one(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    try:
        f = open(path, "rb")
    except OSError:
        return out
    with f:
        for line in f:
            if not line.endswith(b"\n"):
                break  # torn tail: a kill raced the write
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                break
            if isinstance(rec, dict):
                out.append(rec)
    return out


def read_events(path: str, spanning: bool = True) -> List[Dict[str, Any]]:
    """Parse an events.jsonl, dropping a torn trailing line (crash
    mid-append) and everything after the first unparsable record — the
    same tolerance contract as the campaign ledger reader.  With
    ``spanning`` (the default) a size-rotated stream is read whole:
    rotated segments oldest-first, then the live file — callers tailing
    one physical file (the warehouse per-file ingest) pass False."""
    if spanning:
        out: List[Dict[str, Any]] = []
        for p in segment_files(path) or [path]:
            out.extend(_read_one(p))
        return out
    return _read_one(path)


def _rotated_catchup(path: str, offset: int) -> List[Dict[str, Any]]:
    """Events the follower missed across a rotation: the tail of the
    just-rotated segment (``<path>.1``) from the old cursor.  Empty
    when ``.1`` doesn't cover the cursor — that shrink was a new
    session truncating the stream, not a rotation."""
    p1 = path + ".1"
    out: List[Dict[str, Any]] = []
    try:
        if os.path.getsize(p1) < offset:
            return out
        f = open(p1, "rb")
    except OSError:
        return out
    with f:
        f.seek(offset)
        for line in f:
            if not line.endswith(b"\n"):
                break
            try:
                rec = json.loads(line) if line.strip() else None
            except ValueError:
                rec = None
            if isinstance(rec, dict):
                out.append(rec)
    return out


def read_events_incremental(
        path: str, offset: int = 0, follow_rotation: bool = True,
        stop_at_corrupt: bool = False
) -> "tuple[List[Dict[str, Any]], int]":
    """Parse complete event lines starting at byte ``offset``; returns
    ``(events, new_offset)`` with ``new_offset`` just past the last line
    consumed — the O(appended-bytes) cursor for following a live stream
    (``read_events`` re-parses the whole file each call).  A torn
    (unterminated) tail line is left unconsumed so the next poll retries
    it once the writer finishes the append; a complete-but-corrupt line
    is skipped — it will never heal, and a follower must stay live past
    it (with ``stop_at_corrupt`` it instead STOPS there, cursor before
    the bad line — the ``read_events`` scan semantics, used by the
    warehouse ingest so the two backends index the same prefix).  A
    shrunken file means either size rotation (the old bytes
    moved to ``<path>.1`` — with ``follow_rotation`` the segment's tail
    past the cursor is delivered first) or a new session truncating the
    stream; both reset the cursor to 0.  (A rotation the poll only
    sees after the NEW live file has already outgrown the old cursor
    is indistinguishable from plain growth, and two rotations between
    polls leave the cursor pointing at the wrong segment — a plain
    byte cursor cannot tell segments apart.  Followers that must
    survive arbitrary rotation cadence use :func:`follow_events`,
    whose cursor also carries the live file's first-line identity; the
    warehouse ingest re-reads segments by signature, so the durable
    record stays exact either way.)"""
    out: List[Dict[str, Any]] = []
    try:
        f = open(path, "rb")
    except OSError:
        return out, offset
    with f:
        f.seek(0, os.SEEK_END)
        if f.tell() < offset:
            if follow_rotation:
                out.extend(_rotated_catchup(path, offset))
            offset = 0
        f.seek(offset)
        for line in f:
            if not line.endswith(b"\n"):
                break  # torn tail: an append is in flight
            try:
                rec = json.loads(line) if line.strip() else None
            except ValueError:
                if stop_at_corrupt:
                    break  # scan semantics: cursor stays before it
                rec = None
            offset += len(line)
            if isinstance(rec, dict):
                out.append(rec)
    return out, offset


_FIRST_LINE_CAP = 1 << 20  # 1 MiB — no sane first event comes close


def _first_line(path: str) -> str:
    """A file's first COMPLETE line — the stream's segment/session
    identity: every live file opens with a unique first event (the
    session's attach meta, or a timestamped ``rotate-cont`` marker),
    and rotation renames preserve file content.  Shared by the
    :func:`follow_events` cursor and the warehouse event ingest, so
    the two can't disagree about what counts as the same session.
    ``""`` means no identity yet (file absent, or the first line still
    in flight).  A pathological first line longer than the cap yields
    the capped prefix once the file has grown past it — a stable
    identity rather than a permanent "" that would blind a follower
    forever."""
    try:
        with open(path, "rb") as f:
            first = f.readline(_FIRST_LINE_CAP)
            if len(first) >= _FIRST_LINE_CAP and \
                    not first.endswith(b"\n"):
                # over-cap line: identity = the capped prefix, stable
                # only once bytes BEYOND the cap exist (the prefix of a
                # still-growing line could change between polls)
                if f.read(1):
                    return first.decode("utf-8", "replace")
                return ""
    except OSError:
        return ""
    if not first.endswith(b"\n"):
        return ""
    return first.decode("utf-8", "replace")


def follow_events(path: str, cursor: Optional[Dict[str, Any]] = None
                  ) -> "tuple[List[Dict[str, Any]], Dict[str, Any]]":
    """The rotation-proof follower behind ``cli tail -f``: like
    :func:`read_events_incremental`, but the opaque ``cursor`` dict
    also carries the live file's first-line identity, so ANY number of
    rotations between polls is spanned losslessly — the follower's
    former live file is found among the rotated segments by first
    line, its tail past the old offset drained, every newer segment
    delivered whole, then the new live file read from byte 0.  A
    former segment that aged out of keep-N (or a new session, which
    removes old segments) delivers every surviving segment whole.
    Pass the returned cursor back on the next poll; start with None.
    The first poll spans existing rotated segments, matching
    :func:`read_events`."""
    cursor = cursor or {}
    offset = int(cursor.get("offset") or 0)
    head = cursor.get("head") or ""
    live_head = _first_line(path)
    out: List[Dict[str, Any]] = []
    segs = [p for p in segment_files(path) if p != path]
    # the resume anchor: identity + offset of the last position fully
    # delivered, valid even if the live-file read below can't complete
    # (rename race) — the next poll restarts the segment walk from it
    anchor_off, anchor_head = offset, head
    if not head or live_head != head:
        if head:
            # the live file was replaced since last poll (>=1
            # rotations, or a new session): locate the former live
            # file among the rotated segments by identity
            idx = next((i for i, p in enumerate(segs)
                        if _first_line(p) == head), None)
            if idx is not None:
                evs, new_off = read_events_incremental(
                    segs[idx], offset, follow_rotation=False)
                if _first_line(segs[idx]) != head:
                    # a rotation renamed another segment onto this
                    # path mid-read: the bytes may be the wrong
                    # file's — drop them, retry from the old cursor
                    return out, {"offset": anchor_off,
                                 "head": anchor_head}
                out.extend(evs)
                anchor_off = new_off
                segs = segs[idx + 1:]
            # else: former segment dropped (keep-N overrun / new
            # session, which removes old segments) — every surviving
            # segment is newer than the cursor, deliver them whole
        # fresh follower (no head): span already-rotated history,
        # matching read_events.  Fingerprint each segment BEFORE
        # reading and re-check after: a rotation racing the walk
        # renames other content onto these paths, and anchoring to a
        # fingerprint taken after such a rename would mark events as
        # delivered that never were.
        for p in segs:
            fl = _first_line(p)
            try:
                size = os.path.getsize(p)
            except OSError:
                fl = ""
            if not fl:
                continue  # segment dropped by keep-N mid-walk
            evs = read_events(p, spanning=False)
            if _first_line(p) != fl:
                # renamed under us: stop the walk; the next poll
                # resumes the chain from the last good anchor
                return out, {"offset": anchor_off, "head": anchor_head}
            out.extend(evs)
            anchor_off, anchor_head = size, fl
        offset = 0
    if not live_head:
        # live file absent or its first line still in flight (a poll
        # racing the rotation rename): deliver the segment catch-up
        # and retry the live file from the anchor next poll
        return out, {"offset": anchor_off, "head": anchor_head}
    evs, offset = read_events_incremental(path, offset,
                                          follow_rotation=False)
    if _first_line(path) != live_head:
        # a rotation raced the live read: the bytes parsed may belong
        # to a different file than live_head names — drop the live
        # batch (the next poll re-delivers it via the segment walk)
        # but keep the rename-stable segment catch-up
        return out, {"offset": anchor_off, "head": anchor_head}
    out.extend(evs)
    return out, {"offset": offset, "head": live_head}


def replay(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold an event sequence into its end state: which spans are still
    open (in open order), the final metric values, the last resource
    sample, and resilience tallies.  This is what a post-mortem of a
    killed run reads — and what the acceptance contract renders."""
    state: Dict[str, Any] = {
        "meta": {}, "open": [], "ended": False, "t0": None, "t_last": None,
        "counters": {}, "gauges": {}, "histograms": {}, "sample": {},
        "spans_closed": 0, "events": 0, "rotations": 0,
        "faults": 0, "retries": 0, "fallbacks": 0, "deadlines": 0,
        "env_anomalies": 0,
    }
    open_spans: List[Dict[str, Any]] = []
    for e in events:
        state["events"] += 1
        t = e.get("t")
        if t is not None:
            if state["t0"] is None:
                state["t0"] = t
            state["t_last"] = t
        ev = e.get("ev")
        if ev == "start":
            state["meta"] = {k: v for k, v in e.items()
                             if k not in ("t", "ev")}
        elif ev == "span-open":
            open_spans.append({"name": e.get("name"), "tid": e.get("tid"),
                               "t": t})
        elif ev == "span":
            state["spans_closed"] += 1
            for i in range(len(open_spans) - 1, -1, -1):
                if open_spans[i]["name"] == e.get("name") and \
                        open_spans[i]["tid"] == e.get("tid"):
                    del open_spans[i]
                    break
        elif ev == "metrics":
            for sect in ("counters", "gauges", "histograms"):
                state[sect].update(e.get(sect) or {})
        elif ev == "sample":
            state["sample"] = {k: v for k, v in e.items()
                               if k not in ("t", "ev")}
        elif ev in ("fault", "retry", "fallback", "deadline"):
            key = "retries" if ev == "retry" else ev + "s"
            state[key] += 1
        elif ev == "env-anomaly":
            state["env_anomalies"] += 1
        elif ev == "rotate":
            state["rotations"] += 1
        elif ev == "end":
            state["ended"] = True
    state["open"] = open_spans
    return state


def _fmt_bytes(n: Any) -> str:
    try:
        n = float(n)
    except (TypeError, ValueError):
        return str(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TB"


def _fmt_dur_ns(ns: Any) -> str:
    return _fmt_dur(ns, fallback="?")


def render_line(e: Dict[str, Any], t0: Optional[float] = None) -> str:
    """One human-readable progress line per event."""
    off = ""
    if t0 is not None and isinstance(e.get("t"), (int, float)):
        off = f"+{e['t'] - t0:8.3f}s "
    ev = e.get("ev", "?")
    if ev == "span-open":
        return f"{off}open  {e.get('name')}"
    if ev == "span":
        attrs = e.get("attrs") or {}
        extra = "".join(f" {k}={v}" for k, v in sorted(attrs.items())
                        if k not in ("open",))
        return (f"{off}span  {e.get('name')} "
                f"{_fmt_dur_ns(e.get('dur_ns'))}{extra}")
    if ev == "metrics":
        parts = []
        for sect in ("counters", "gauges"):
            for k, v in sorted((e.get(sect) or {}).items()):
                parts.append(f"{k}={v}")
        for k, v in sorted((e.get("histograms") or {}).items()):
            parts.append(f"{k}.count={v.get('count')}")
        return f"{off}metrics {' '.join(parts[:8])}" + \
            (" ..." if len(parts) > 8 else "")
    if ev == "sample":
        bits = []
        if "rss_bytes" in e:
            bits.append(f"rss={_fmt_bytes(e['rss_bytes'])}")
        if "threads" in e:
            bits.append(f"threads={e['threads']}")
        for dev, b in sorted((e.get("device_bytes") or {}).items()):
            bits.append(f"{dev}={_fmt_bytes(b)}")
        return f"{off}sample {' '.join(bits)}"
    if ev in ("fault", "retry", "fallback", "deadline"):
        extra = " ".join(f"{k}={v}" for k, v in sorted(e.items())
                         if k not in ("t", "ev"))
        return f"{off}{ev:<6}{extra}"
    extra = " ".join(f"{k}={v}" for k, v in sorted(e.items())
                     if k not in ("t", "ev"))
    return f"{off}{ev:<6}{extra}".rstrip()


def render_tail(events: List[Dict[str, Any]],
                limit: Optional[int] = None) -> str:
    """The full ``cli tail`` rendering: recent event lines, then the
    replayed end state — the still-open span chain (a killed run's
    "where was it?") and the final counter/gauge values."""
    st = replay(events)
    t0 = st["t0"]
    # limit=0 means "footer only" — lst[-0:] would be the whole list
    shown = (events if limit is None
             else events[-limit:] if limit > 0 else [])
    lines = [render_line(e, t0) for e in shown]
    if limit is not None and len(events) > limit:
        lines.insert(0, f"... ({len(events) - limit} earlier events)")
    lines.append("")
    if st["ended"]:
        lines.append("run ended cleanly")
    elif st["open"]:
        chain = " > ".join(str(s["name"]) for s in st["open"])
        lines.append(f"open spans: {chain}")
        last = st["open"][-1]
        age = ""
        if isinstance(st["t_last"], (int, float)) and \
                isinstance(last.get("t"), (int, float)):
            age = f" (open {st['t_last'] - last['t']:.1f}s at last event)"
        lines.append(f"last open span: {last['name']}{age}")
    else:
        lines.append("no open spans (stream truncated before close?)")
    if st["faults"] or st["retries"] or st["fallbacks"] or st["deadlines"] \
            or st["env_anomalies"]:
        env = (f", {st['env_anomalies']} env anomalies"
               if st["env_anomalies"] else "")
        lines.append(f"resilience: {st['faults']} faults, "
                     f"{st['retries']} retries, {st['fallbacks']} "
                     f"fallbacks, {st['deadlines']} deadline expiries"
                     f"{env}")
    if st["counters"]:
        lines.append("counters:")
        for k, v in sorted(st["counters"].items()):
            lines.append(f"  {k} = {v}")
    if st["gauges"]:
        lines.append("gauges:")
        for k, v in sorted(st["gauges"].items()):
            lines.append(f"  {k} = {v}")
    if st["histograms"]:
        lines.append("histograms:")
        for k, v in sorted(st["histograms"].items()):
            lines.append(f"  {k} count={v.get('count')} sum={v.get('sum')}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Heartbeat: atomic JSON state for live fleet dashboards
# ---------------------------------------------------------------------------

class Heartbeat:
    """Atomically-replaced JSON state file (`tmp` + ``os.replace``) the
    campaign scheduler updates as workers pick up / finish runs — the
    in-flight counterpart of the append-only ledger.  Readers (the web
    ``/campaign/<name>/live`` view, ``campaign status``) always see a
    complete document; a killed campaign leaves its last state behind,
    naming exactly the cells that were in flight.

    Writes are throttled to one per ``min_interval_s`` except when
    forced (close, and every worker-slot transition forces — those are
    the edges a dashboard cares about).

    No-raise guarantee: heartbeats are best-effort observability — the
    ledger is the record — so no public method ever raises; callers
    (the campaign scheduler's worker loop) rely on this and do not
    wrap their calls."""

    def __init__(self, path: str, *, campaign: Optional[str] = None,
                 total: int = 0, done: int = 0,
                 min_interval_s: float = 0.5):
        self.path = path
        self._lock = threading.Lock()
        self._last_write = 0.0
        self.min_interval_s = float(min_interval_s)
        self.state: Dict[str, Any] = {
            "campaign": campaign, "total": int(total), "done": int(done),
            "workers": {}, "updated": None, "finished": False,
        }
        self.write(force=True)

    def worker(self, worker_id: str,
               state: Optional[Dict[str, Any]]) -> None:
        """Set (or clear, with None) one worker's in-flight state."""
        with self._lock:
            if state is None:
                self.state["workers"].pop(str(worker_id), None)
            else:
                self.state["workers"][str(worker_id)] = dict(
                    state, since=state.get("since", round(time.time(), 3)))
        self.write(force=True)

    def record_done(self, run_id: str, valid: Any = None) -> None:
        with self._lock:
            self.state["done"] = int(self.state.get("done", 0)) + 1
            self.state["last"] = {"run": run_id, "valid?": valid}
        self.write()

    def write(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_write < self.min_interval_s:
                return
            self._last_write = now
            self.state["updated"] = round(time.time(), 3)
            # tmp write + replace stay under the lock: the tmp path is
            # shared, so an unlocked writer pair could publish the
            # other's half-written inode via os.replace
            tmp = self.path + ".tmp"
            try:
                doc = json.dumps(_jsonable(self.state), indent=1)
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                with open(tmp, "w") as f:
                    f.write(doc)
                os.replace(tmp, self.path)
            except Exception:  # noqa: BLE001 — see no-raise guarantee
                pass

    def close(self) -> None:
        with self._lock:
            self.state["workers"] = {}
            self.state["finished"] = True
        self.write(force=True)

    @staticmethod
    def load(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None


class HttpHeartbeat:
    """:class:`Heartbeat` twin that PUSHES over HTTP to a fleet
    coordinator instead of writing ``live.json`` locally.

    Same interface and the same no-raise guarantee as
    :class:`Heartbeat`; a `run_campaign` whose spec opts (or the
    ``JEPSEN_COORDINATOR`` env) name a coordinator URL uses this
    instead, and the coordinator's single `Heartbeat` writer merges
    the pushes into the exact ``live.json`` shape the file path
    writes — so ``/campaign/<name>/live`` renders both sources
    unchanged (pinned in tests/test_fleet.py).

    Best-effort by design: a dropped push loses a dashboard tick,
    never work — the ledger stays the record.  A FAILED push arms a
    cooldown (``backoff_s``) during which further pushes are skipped
    outright: heartbeats are called synchronously from the campaign
    scheduler's worker threads, and an unreachable coordinator —
    exactly the partition the fleet rides out elsewhere — must cost
    one timeout per cooldown window, not one per cell transition."""

    def __init__(self, url: str, *, campaign: Optional[str] = None,
                 total: int = 0, done: int = 0,
                 timeout_s: float = 2.0, backoff_s: float = 5.0):
        self.url = url.rstrip("/") + "/fleet/heartbeat"
        self.campaign = campaign
        self.timeout_s = float(timeout_s)
        self.backoff_s = float(backoff_s)
        self._down_until = 0.0
        self._post({"total": int(total), "init-done": int(done)})

    def _post(self, doc: Dict[str, Any]) -> None:
        import urllib.request

        if time.monotonic() < self._down_until:
            return  # coordinator recently unreachable: skip, don't stall
        body = dict(doc)
        if self.campaign:
            body["campaign"] = self.campaign
        try:
            req = urllib.request.Request(
                self.url, data=json.dumps(_jsonable(body)).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
            self._down_until = 0.0
        except Exception:  # noqa: BLE001 — see no-raise guarantee
            self._down_until = time.monotonic() + self.backoff_s

    def worker(self, worker_id: str,
               state: Optional[Dict[str, Any]]) -> None:
        self._post({"worker": str(worker_id), "state": state})

    def record_done(self, run_id: str, valid: Any = None) -> None:
        self._post({"done": {"run": run_id, "valid?": valid}})

    def write(self, force: bool = False) -> None:
        pass  # every update is already pushed

    def close(self) -> None:
        self._post({"finished": True})
