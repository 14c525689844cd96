"""Nestable timed spans — the tracing half of the telemetry layer (the
port's copy of `jepsen_tpu/telemetry/spans.py`).

A :class:`Collector` owns one span forest per run: every thread that
opens a span gets its own root chain (thread-local stacks), so the
interpreter's worker threads, the knossos race legs, and the main
orchestration loop each land on their own timeline row in the Chrome
trace export.  Spans nest via context managers (or the :func:`traced`
decorator) and carry free-form attributes (op counts, history length,
device vs host, first call vs repeat ...).

Cost contract: telemetry must be off-by-default-cheap.  The
disabled path is the module-level :data:`NOOP` singleton whose
``span()`` returns one shared no-op context manager — no allocation, no
clock read, no locks.  Hot loops additionally guard per-op work with
``collector.enabled``.

Clocks: span timing uses ``time.perf_counter_ns()`` (monotonic,
comparable across threads in one process); the collector anchors that
to wall time once at construction so exports can place the run in
absolute time.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Collector", "NoopCollector", "NOOP", "active",
           "activate", "deactivate", "span", "traced", "enabled",
           "current", "TraceContext", "TRACE_HEADER", "mint_trace",
           "trace_id_for", "parse_trace_header", "current_trace",
           "set_trace", "trace_scope", "add_phase", "PHASE_BUCKETS"]

# ---------------------------------------------------------------------------
# Distributed trace context
#
# One W3C-style (trace_id, span_id, parent_id) triple follows a run
# across every control-plane seam — coordinator claim/complete,
# verifier ingest/verdict/seal, artifact uploads — in a ``Jepsen-Trace``
# header.  The trace id is a PURE FUNCTION of the run id (minted at
# enqueue, stable across retries/resends and lease-lapse re-executions),
# so every process that knows which run it is working on derives the
# same id without coordination, and the warehouse can stitch a
# cross-host timeline from artifacts that never traveled together.
# ---------------------------------------------------------------------------

#: the HTTP header carrying the trace triple across control-plane seams
TRACE_HEADER = "Jepsen-Trace"


def trace_id_for(run_id: str) -> str:
    """The run's trace id: 32 hex chars, deterministically derived from
    the stable run id — NOT per-attempt, so a retried claim, a resent
    chunk, or a lease-lapse re-execution all land on ONE trace."""
    return hashlib.sha256(
        ("jepsen-trace:" + str(run_id)).encode()).hexdigest()[:32]


def _span_id(*parts: str) -> str:
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


class TraceContext:
    """One point on a distributed trace: ``trace_id`` names the run's
    whole cross-host story, ``span_id`` this segment, ``parent_id`` the
    segment that caused it (empty at the root)."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def child(self, name: str) -> "TraceContext":
        """A deterministic child segment: same trace, a span id derived
        from (trace, parent, name) — two hosts naming the same segment
        of the same run agree on its identity."""
        return TraceContext(self.trace_id,
                            _span_id(self.trace_id, self.span_id, name),
                            self.span_id)

    def header(self) -> str:
        """``Jepsen-Trace`` header value (W3C traceparent-shaped):
        ``00-<trace_id>-<span_id>-01``."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_dict(self) -> Dict[str, str]:
        out = {"trace-id": self.trace_id, "span-id": self.span_id}
        if self.parent_id:
            out["parent-id"] = self.parent_id
        return out

    def __repr__(self) -> str:
        return (f"<TraceContext {self.trace_id[:8]}../{self.span_id}"
                f"{' <- ' + self.parent_id if self.parent_id else ''}>")


def mint_trace(run_id: str) -> TraceContext:
    """The run's ROOT trace context, minted at enqueue (or at
    single-process execute) — seeded from the run id, so every mint of
    the same run is the same trace."""
    tid = trace_id_for(run_id)
    return TraceContext(tid, _span_id(tid, "root"))


def trace_context(trace_id: str, segment: str = "run") -> TraceContext:
    """A named segment context on an EXISTING trace (the receiver side
    of a propagated trace id): deterministic span id from (trace,
    segment), parented on the trace root."""
    tid = str(trace_id)
    return TraceContext(tid, _span_id(tid, segment),
                        _span_id(tid, "root"))


def parse_trace_header(value: Optional[str]) -> Optional["TraceContext"]:
    """Parse a ``Jepsen-Trace`` header back into a context; the
    header's span id becomes the receiver's ``parent_id`` (the sender's
    segment caused whatever the receiver does next).  Malformed values
    parse to None — a bad header must never fail a control-plane
    request."""
    if not value:
        return None
    parts = str(value).strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    return TraceContext(parts[1], parts[2], parts[2])


_trace_tls = threading.local()


def current_trace() -> Optional[TraceContext]:
    """The trace context installed on THIS thread (None outside any
    traced request/run)."""
    return getattr(_trace_tls, "ctx", None)


def set_trace(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install `ctx` as this thread's trace context; returns the
    previous one (restore it when done, or use :func:`trace_scope`)."""
    prev = getattr(_trace_tls, "ctx", None)
    _trace_tls.ctx = ctx
    return prev


@contextlib.contextmanager
def trace_scope(ctx: Optional[TraceContext]):
    """``with trace_scope(ctx): ...`` — the handler-side seam: parse
    the incoming header, run the handler under it, restore."""
    prev = set_trace(ctx)
    try:
        yield ctx
    finally:
        set_trace(prev)


class Span:
    """One timed node in the span tree.  ``t0``/``t1`` are
    perf_counter_ns values; ``t1`` is None while the span is open."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "tid",
                 "thread_name", "ann")

    def __init__(self, name: str, tid: int, thread_name: str,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t0 = time.perf_counter_ns()
        self.t1: Optional[int] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.children: List[Span] = []
        self.tid = tid
        self.thread_name = thread_name
        # profiler-bridge annotation ctx (Collector.annotate runs):
        # entered at push, exited at pop, same thread both times
        self.ann: Optional[Any] = None

    @property
    def duration_ns(self) -> Optional[int]:
        return None if self.t1 is None else self.t1 - self.t0

    def set_attr(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def __repr__(self) -> str:
        d = self.duration_ns
        return (f"<Span {self.name} "
                f"{'open' if d is None else f'{d / 1e6:.3f}ms'} "
                f"children={len(self.children)}>")


class _SpanCtx:
    """Context manager binding one Span to a collector's thread stack."""

    __slots__ = ("_collector", "_name", "_attrs", "span")

    def __init__(self, collector: "Collector", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._collector = collector
        self._name = name
        self._attrs = attrs
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        self.span = self._collector._push(self._name, self._attrs)
        return self.span

    def __exit__(self, *exc) -> bool:
        self._collector._pop(self.span)
        return False


class _NoopSpan:
    """Shared stand-in for both the no-op context manager and the span
    it yields; every operation is a cheap no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attr(self, **attrs: Any) -> "_NoopSpan":
        return self

    attrs: Dict[str, Any] = {}
    duration_ns = None


_NOOP_SPAN = _NoopSpan()


class Collector:
    """Thread-safe span collector for one run (or one process session).

    Each thread keeps its own span stack; a span opened with an empty
    stack becomes a root.  ``roots`` and cross-thread registration are
    lock-protected; within a thread, push/pop touch only thread-local
    state.

    Each collector owns a fresh metrics registry: while it is active,
    ``telemetry.registry()`` resolves to it, so a run's exported
    counters cover exactly that run (a second telemetric run in one
    process does not inherit the first run's tallies).

    Streaming: ``stream`` is an attached flight-recorder
    ``EventStream`` (see :func:`stream.attach`) — span opens/closes
    are emitted as they happen so a killed run leaves a partial trace.
    ``annotate=True`` bridges every span to ``torch.profiler``: the span
    body runs inside a ``record_function`` of the same name, so a
    ``--profile-dir`` run interleaves host spans with CUDA kernels on
    one Perfetto timeline."""

    enabled = True
    stream: Optional[Any] = None
    annotate = False
    #: the run's distributed trace context: when set, root
    #: spans carry trace_id/span_id attrs and the export stamps the
    #: triple into telemetry.json for warehouse stitching
    trace: Optional[TraceContext] = None

    def __init__(self):
        from .metrics import Registry

        self._tls = threading.local()
        self._lock = threading.Lock()
        self.roots: List[Span] = []
        self.registry = Registry()
        # wall-clock anchor: epoch_ns + (t - perf0_ns) locates any span
        # in absolute time
        self.perf0_ns = time.perf_counter_ns()
        self.epoch_ns = time.time_ns()

    # -- span API ----------------------------------------------------------

    def span(self, name: str, /, **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, name, attrs or None)

    def current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    # -- internals ---------------------------------------------------------

    def _push(self, name: str, attrs: Optional[Dict[str, Any]]) -> Span:
        t = threading.current_thread()
        sp = Span(name, t.ident or 0, t.name, attrs)
        if self.annotate:
            try:
                from jepsen_tpu_torch.utils.profiling import annotate

                sp.ann = annotate(name)
                sp.ann.__enter__()
            except Exception:  # noqa: BLE001 — bridging is best-effort
                sp.ann = None
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        if stack:
            stack[-1].children.append(sp)
        else:
            if self.trace is not None:
                # roots only: per-span stamping would bloat the export
                # for zero stitch value (children inherit by nesting)
                sp.attrs.setdefault("trace_id", self.trace.trace_id)
                sp.attrs.setdefault("span_id", self.trace.span_id)
            with self._lock:
                self.roots.append(sp)
        stack.append(sp)
        if self.stream is not None:
            self.stream.span_open(sp)
        return sp

    def _pop(self, sp: Optional[Span]) -> None:
        if sp is None:
            return
        sp.t1 = time.perf_counter_ns()
        stack = getattr(self._tls, "stack", None)
        # tolerate exits out of order (a crashed body that skipped
        # children's __exit__): unwind to and including sp
        while stack:
            top = stack.pop()
            if top.t1 is None:
                top.t1 = sp.t1
            ann, top.ann = top.ann, None
            if ann is not None:
                try:  # innermost-first pop order matches record_function
                    ann.__exit__(None, None, None)
                except Exception:  # noqa: BLE001
                    pass
            if self.stream is not None:
                self.stream.span_close(top)
            if top is sp:
                break

    # -- finalization ------------------------------------------------------

    def close_open_spans(self) -> None:
        """Stamp a provisional end on every still-open span (export can
        run mid-span, e.g. from inside store.save_1's own span).  Open
        spans also get the current memory high watermarks:
        the root ``run`` span is still open when telemetry.json is
        written, and its real close stamps only the event stream."""
        now = time.perf_counter_ns()
        wm: Dict[str, Any] = {}
        st = self.stream
        if st is not None and getattr(st, "watermarks", None) is not None:
            try:
                wm = st.watermarks() or {}
            except Exception:  # noqa: BLE001 — stamping is best-effort
                wm = {}

        def walk(sp: Span) -> None:
            if sp.t1 is None:
                sp.attrs.setdefault("open", True)
                if wm:
                    sp.attrs.update(wm)
                sp.t1 = now
            for c in sp.children:
                walk(c)

        with self._lock:
            for r in self.roots:
                walk(r)


class NoopCollector:
    """The disabled collector: a no-op singleton.  ``span()`` hands back
    one shared object; nothing is recorded."""

    enabled = False
    roots: List[Span] = []
    registry = None  # telemetry.registry() falls back to the default
    stream = None
    annotate = False
    trace = None

    def span(self, name: str, /, **attrs: Any) -> _NoopSpan:
        return _NOOP_SPAN

    def current(self) -> None:
        return None

    def close_open_spans(self) -> None:
        pass


NOOP = NoopCollector()

# process-wide active collector; module-level so instrumentation sites
# (interpreter workers, checker internals) need no plumbing
_active: Any = NOOP
_active_lock = threading.Lock()


def active() -> Any:
    """The currently-active collector (NOOP when telemetry is off)."""
    return _active


def enabled() -> bool:
    return _active.enabled


def activate(collector: Optional[Collector] = None) -> Collector:
    """Install `collector` (a fresh one by default) as the process-wide
    active collector; returns it.  The previous collector is remembered
    so nested activations restore correctly via :func:`deactivate`."""
    global _active
    c = collector or Collector()
    with _active_lock:
        prev = _active
        c._prev = prev  # type: ignore[attr-defined]
        _active = c
    return c


def deactivate(collector: Optional[Collector] = None) -> None:
    """Remove `collector` (default: whatever is active), restoring its
    predecessor."""
    global _active
    with _active_lock:
        c = collector or _active
        if c is _active and c is not NOOP:
            _active = getattr(c, "_prev", NOOP) or NOOP


def span(name: str, /, **attrs: Any):
    """Open a span on the active collector — the one-liner used by
    instrumentation sites::

        with telemetry.span("elle.infer", txns=n) as sp:
            ...
            sp.set_attr(edges=m)
    """
    return _active.span(name, **attrs)


def current() -> Optional[Span]:
    """The innermost open span on this thread (None when disabled or
    at top level) — for attaching attributes after the fact."""
    return _active.current()


#: the phase self-time taxonomy: where a span's wall time
#: actually went.  compile_s/execute_s predate this list (stamped by
#: `resilience.guard._stamp_device_time`); the rest are accumulated by
#: their owning subsystems via :func:`add_phase`.  Bucket attrs are
#: plain ``*_s`` float seconds on span attrs, so they ride the existing
#: telemetry.json → ledger → warehouse path with no schema change to
#: the span structure itself.
PHASE_BUCKETS = ("compile_s", "execute_s", "queue_wait_s",
                 "host_pack_s", "device_dispatch_s", "sweep_s",
                 "journal_fsync_s")


def add_phase(bucket: str, seconds: float) -> None:
    """Accumulate `seconds` of phase self-time into `bucket` on the
    innermost open span of this thread.  The disabled path is one
    attribute lookup returning None — cheap enough for hot loops; the
    enabled path is two dict ops.  Never raises."""
    sp = _active.current()
    if sp is None:
        return
    try:
        sp.attrs[bucket] = float(sp.attrs.get(bucket) or 0.0) + float(
            seconds)
    except Exception:  # noqa: BLE001 — accounting must never fail a run
        pass


def traced(name: Optional[str] = None, **attrs: Any):
    """Decorator form: time every call of the function as a span."""

    def deco(fn):
        sp_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with _active.span(sp_name, **attrs):
                return fn(*args, **kw)

        return wrapper

    return deco


class PhaseTimer:
    """Sequential sibling spans for long linear functions: each
    ``start()`` closes the previous phase and opens the next, without
    the re-indentation a ``with`` block per phase would force::

        ph = telemetry.phases()
        ph.start("elle.infer", txns=n)
        ...
        ph.start("elle.cycle-sweep")
        ...
        ph.end()

    An exception mid-phase leaves the span open; the collector stamps a
    provisional end at export (`close_open_spans`)."""

    __slots__ = ("_collector", "_ctx")

    def __init__(self, collector: Any):
        self._collector = collector
        self._ctx: Any = None

    def start(self, name: str, /, **attrs: Any):
        self.end()
        self._ctx = self._collector.span(name, **attrs)
        return self._ctx.__enter__()

    def end(self) -> None:
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None


def phases() -> PhaseTimer:
    """A :class:`PhaseTimer` over the active collector (no-op when
    telemetry is off)."""
    return PhaseTimer(_active)
