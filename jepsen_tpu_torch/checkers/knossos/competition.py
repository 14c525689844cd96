"""Competition: race the linearizability algorithms (the port of
`jepsen_tpu/checkers/knossos/competition.py`).

Equivalent of `knossos/competition.clj` (SURVEY.md §2.4), which races
`linear` and `wgl` on two thread pools and takes the first definitive
answer.  Here three contestants exist: JIT-linear (`linear.py`), host WGL
(`wgl.py`), and the batched frontier search on the card (`device_wgl.py`).
Small histories race linear vs wgl on threads (losers aborted via
`search.Search`), falling back to the device on "unknown"; large histories
race all THREE legs concurrently — first definitive verdict wins, losers
are aborted.

One rule differs from the JAX package on purpose.  Its race turns a
crashed leg into a loser, so a failing device leg quietly leaves the
verdict to the host legs.  The port keeps that only for a synthetic
`resilience.FaultInjected` of a plan the caller gave or installed: any
other error of the device leg (`backend.NoDeviceError`, a CUDA error or an
out-of-memory error that outlived `device_call`'s retries) ends the race
and is raised.  Host legs that crash stay losers, as in the JAX package.
Telemetric runs get the JAX package's spans: ``knossos.analysis`` with
``knossos.prep``, and one ``knossos.<leg>`` root per racing thread.
"""

from __future__ import annotations

import inspect
import logging
import queue as _queue
import threading
import time
from typing import Any, Dict

from jepsen_tpu_torch import backend, telemetry
from jepsen_tpu_torch.checkers.knossos import device_wgl, linear, wgl
from jepsen_tpu_torch.checkers.knossos.prep import prepare
from jepsen_tpu_torch.checkers.knossos.search import ChildSearch, stamp_abort
from jepsen_tpu_torch.history.ops import History
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.resilience import FaultInjected

logger = logging.getLogger("jepsen.knossos")

HOST_FIRST_MAX_OPS = 256

#: the race's name for the device leg, whose errors it raises
DEVICE_LEG = "device"


def _race(contestants, ops, model, ctl, _also_accepts=(),
          **kw) -> Dict[str, Any]:
    """Race checkers on threads; first definitive answer wins and the
    losers are aborted via the shared `ctl` (reference competition
    semantics).  Threads are NON-daemon, so every leg must stay
    cancellable: with a ctl the device leg always takes the pollable
    blocked search.  The wait loop polls `ctl` so an expired deadline
    ends the race even while every leg is mid-flight.  An error of the
    device leg other than `FaultInjected` aborts the others and is
    raised (see the module docstring).
    """
    q: _queue.Queue = _queue.Queue()

    # a kwarg no contestant accepts (e.g. a misspelled budget like
    # max_config) would otherwise be dropped by EVERY per-leg filter —
    # auto mode silently unbounded where the direct paths TypeError
    if kw:
        accepted = set()
        for fn in [fn for _, fn in contestants] + list(_also_accepts):
            accepted |= set(inspect.signature(fn).parameters)
        dropped = sorted(set(kw) - accepted)
        if dropped:
            logger.warning(
                "race kwargs %s accepted by no contestant %s — ignored",
                dropped, [n for n, _ in contestants])

    def run(name, fn):
        try:
            # per-leg kwarg filter: the legs' signatures differ (e.g.
            # max_frontier and device are device-only) and a TypeError
            # here would silently kill a leg instead of racing it
            params = inspect.signature(fn).parameters
            leg_kw = {k: v for k, v in kw.items() if k in params}
            # each leg runs on its own thread, so this span is a root
            # on its own timeline row; device=True marks the card's leg
            with telemetry.span(f"knossos.{name}", ops=len(ops),
                                device=(fn is device_wgl.check)) as sp:
                res = fn(list(ops), model, ctl=ctl, **leg_kw)
                sp.set_attr(valid=res.get("valid?"))
            q.put((name, res, None))
        except Exception as e:  # noqa: BLE001 — sorted out by the waiter
            logger.warning("%s contestant crashed", name, exc_info=True)
            q.put((name, None, e))

    fallback: Dict[str, Any] = {"valid?": "unknown"}
    pending = 0
    threads = []
    try:
        # starts inside the try: if the Nth start raises (thread
        # pressure), the finally still aborts the already-running legs
        for name, fn in contestants:
            t = threading.Thread(target=run, args=(name, fn),
                                 name=f"knossos-race-{name}")
            t.start()
            threads.append(t)
            pending += 1
        while pending:
            try:
                name, res, err = q.get(timeout=0.25)
            except _queue.Empty:
                if ctl.aborted():  # deadline fired / caller cancelled
                    # drain: a leg may have enqueued a definitive
                    # verdict in the poll window — don't discard it
                    try:
                        while True:
                            name, res, err = q.get_nowait()
                            if err is not None:
                                if name == DEVICE_LEG and not isinstance(
                                        err, FaultInjected):
                                    raise err
                            elif res.get("valid?") != "unknown":
                                res.setdefault("algorithm", name)
                                return res
                    except _queue.Empty:
                        pass
                    return stamp_abort(dict(fallback, reason="aborted"),
                                       ctl)
                continue
            pending -= 1
            if err is not None:
                if name == DEVICE_LEG and \
                        not isinstance(err, FaultInjected):
                    raise err
                fallback = {"valid?": "unknown", "error": f"{name} crashed"}
                continue
            if res.get("valid?") != "unknown":
                res.setdefault("algorithm", name)
                return res
            fallback = res
        return fallback
    finally:
        ctl.abort()
        # losers are non-daemon and a leg stuck in one long device call
        # cannot see ctl mid-call — don't block the winner's return on
        # them, but DO make slow unwinds diagnosable from the log (the
        # reaper thread itself touches no device code, so daemon is safe)
        if any(t.is_alive() for t in threads):
            def reap(ts=tuple(threads)):
                t_end = time.monotonic() + 30
                for t in ts:
                    t.join(timeout=max(0.0, t_end - time.monotonic()))
                stuck = [t.name for t in ts if t.is_alive()]
                if stuck:
                    logger.info(
                        "race losers still unwinding 30s after the "
                        "verdict: %s", stuck)

            threading.Thread(target=reap, daemon=True,
                             name="knossos-race-reaper").start()


HOST_LEGS = (("linear", linear.check), ("wgl", wgl.check))


def _polled(root, fn):
    """Run `fn` with a background poller driving `root.aborted()`.

    Deadline/parent-abort propagation is poll-driven (see
    `search.ChildSearch`): the poller makes a `deadline_s` (or a caller
    ctl abort) reach the root on the direct-algorithm paths too.  The
    poller is a daemon thread but touches no device code."""
    if root is None:
        return fn()
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            if root.aborted():
                return
            stop.wait(0.25)

    threading.Thread(target=poll, daemon=True,
                     name="knossos-deadline-poll").start()
    try:
        return fn()
    finally:
        stop.set()


def analysis(history: History, model: Model,
             algorithm: str = "auto", deadline_s=None, deadline=None,
             device: backend.DeviceLike = None, **kw) -> Dict[str, Any]:
    """Linearizability analysis.
    algorithm: auto | wgl | linear | device | competition.

    auto: small histories race linear vs wgl (cheap memoization, host
    DFS usually instant), then try the device on "unknown"; large ones
    race all THREE legs concurrently — crash-heavy (`info`-dense)
    histories can blow up any single leg, and racing bounds the analysis
    by the fastest.  `device` is where the device leg runs: the CUDA card
    unless it names another (``"cpu"``); only that leg takes it.
    `deadline_s` bounds the WHOLE analysis (race + fallback), anchored
    here; `deadline` (a cooperative `resilience.Deadline`, typically
    `check_safe`'s checker-time-limit budget) does the same but is shared
    with the caller, so one budget covers a whole composed check.  A
    deadline-driven abort returns ``{"valid?": "unknown", "error":
    "deadline-exceeded", ...partial stats}`` — never a hang.  A
    caller-supplied `ctl` is never aborted by the race — losers are
    cancelled through linked child ctls (`search.ChildSearch`), so one
    ctl can bound a whole campaign of analyses.  Remaining `**kw` (e.g.
    max_configs) is forwarded to EVERY leg, device included.  `history`
    may be a `HistoryIR`, whose memoized `lin_ops()` is reused.
    """
    from jepsen_tpu_torch.history.ir import HistoryIR

    with telemetry.span("knossos.analysis", algorithm=algorithm) as sp:
        with telemetry.span("knossos.prep"):
            ops = history.lin_ops() if isinstance(history, HistoryIR) \
                else prepare(history)
        sp.set_attr(ops=len(ops))
        res = _dispatch(ops, model, algorithm, deadline_s, deadline, kw,
                        device)
        sp.set_attr(valid=res.get("valid?"),
                    algorithm_used=res.get("algorithm", algorithm),
                    error=res.get("error"))
        return res


def _dispatch(ops, model: Model, algorithm: str, deadline_s, deadline,
              kw: Dict[str, Any], device: backend.DeviceLike = None
              ) -> Dict[str, Any]:
    parent = kw.pop("ctl", None)
    # one root per analysis: carries this call's deadline (absolute from
    # here) and observes the caller's ctl; everything below aborts
    # through children of it, so neither root nor parent gets poisoned.
    # No parent and no deadline -> no root at all: a ctl-less device
    # check keeps its single-path search, and there is nothing to poll.
    # `is not None`, not truthiness: deadline_s=0 means "already
    # expired, abort promptly", the opposite of unbounded
    root = (ChildSearch(parent, deadline_s=deadline_s, deadline=deadline)
            if parent is not None or deadline_s is not None
            or deadline is not None else None)
    if algorithm == "wgl":
        return _polled(root, lambda: wgl.check(ops, model, ctl=root, **kw))
    if algorithm == "linear":
        return _polled(root,
                       lambda: linear.check(ops, model, ctl=root, **kw))
    if algorithm == "device":
        return _polled(root, lambda: device_wgl.check(
            ops, model, ctl=root, device=device, **kw))
    if len(ops) <= HOST_FIRST_MAX_OPS:
        # the device fallback three lines down also consumes kwargs:
        # a device-only kwarg here is NOT dropped, don't warn on it
        res = _race(HOST_LEGS, ops, model, ChildSearch(root),
                    _also_accepts=(device_wgl.check,), **kw)
        if res["valid?"] != "unknown":
            return res
        # same signature-based filter as _race: a host-only kwarg must
        # not TypeError the fallback leg
        dparams = inspect.signature(device_wgl.check).parameters
        dres = device_wgl.check(
            ops, model, ctl=ChildSearch(root) if root is not None else None,
            device=device, **{k: v for k, v in kw.items() if k in dparams})
        return dres if dres["valid?"] != "unknown" else res
    return _race(HOST_LEGS + ((DEVICE_LEG, device_wgl.check),),
                 ops, model, ChildSearch(root), device=device, **kw)
