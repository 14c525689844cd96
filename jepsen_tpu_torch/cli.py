"""Command-line entry points (the port's copy of the test path of
`jepsen_tpu/cli.py`).

Equivalent of the reference's `jepsen/src/jepsen/cli.clj` (SURVEY.md §2.1):
argparse option specs (``--nodes``, ``--concurrency 10n``, ``--time-limit``,
``--test-count``, ``--username/--password``, ``--leave-db-running``), the
`single_test_cmd` / `test_all_cmd` scaffolding, and the merge of parsed
options into the test map.

A db suite calls::

    from jepsen_tpu_torch import cli

    def my_test(opts):        # opts dict -> test map
        return {**opts, "name": "etcd", "db": Etcd(), ...}

    if __name__ == "__main__":
        cli.run(cli.single_test_cmd(my_test))

The subcommands are ``test``, ``test-all``, ``analyze``, ``trace DIR
[--top N]`` (a stored run's telemetry), ``tail DIR [-f] [-n N]
[--since T]`` (its flight recorder; ``--since`` filters the stream
itself, without the JAX module's warehouse fast path), ``shrink DIR``
(`minimize.shrink`: an invalid run cut down to a minimal witness) and
``campaign run|status|report SPEC`` (`campaign`: a matrix of workload x
fault x seed with a resumable verdict index).  ``--telemetry``
collects spans and metrics into the run's store dir; ``--profile-dir
DIR`` also writes a ``torch.profiler`` trace there.  The JAX module's
``serve``, ``obs``, ``fleet`` and ``cache`` wait for the modules they
drive.  ``--cpu`` puts ``"cpu"`` in the options as the checkers'
device (``opts["cpu"]``); without it the checkers run on the CUDA card
and, with no card, a test records ``valid? unknown`` naming
`NoDeviceError`, and ``shrink`` and ``campaign run`` exit 1 naming it
(a campaign's cells are indexed as unknowns naming it).
``JT_FORCE_CPU`` is not read.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import core, store
from .generator import core as g

logger = logging.getLogger("jepsen.cli")


def parse_concurrency(spec: str, n_nodes: int) -> int:
    """"30" -> 30; "10n" -> 10 * n_nodes (reference `--concurrency`)."""
    m = re.fullmatch(r"(\d+)(n?)", str(spec).strip())
    if not m:
        raise ValueError(f"bad concurrency {spec!r} (want e.g. 30 or 3n)")
    n = int(m.group(1))
    return n * max(n_nodes, 1) if m.group(2) else n


def parse_nodes(values: Optional[Sequence[str]],
                nodes_file: Optional[str]) -> List[str]:
    nodes: List[str] = []
    for v in values or []:
        nodes.extend(x for x in v.split(",") if x)
    if nodes_file:
        with open(nodes_file) as f:
            nodes.extend(line.strip() for line in f if line.strip())
    return nodes


def base_parser(prog: str = "jepsen-tpu-torch") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--store-dir", default=store.BASE,
                   help="store directory (default ./store)")
    p.add_argument("--cpu", action="store_true",
                   help="run the checkers on the CPU (their plain torch "
                        "versions) instead of the CUDA card")
    return p


def add_test_opts(p: argparse.ArgumentParser) -> None:
    """The standard test flags (reference `test-opt-spec`)."""
    p.add_argument("-n", "--node", action="append", dest="nodes",
                   metavar="HOST", help="node to test; repeatable, or "
                   "comma-separated")
    p.add_argument("--nodes-file", help="file with one node per line")
    p.add_argument("-c", "--concurrency", default="1n",
                   help='number of workers, e.g. "30" or "10n" (per node)')
    p.add_argument("--time-limit", type=float, default=60.0,
                   help="seconds to run the workload")
    p.add_argument("--ops", type=int, default=None,
                   help="cap on generated operations; with --time-limit, "
                        "whichever bound hits first ends the workload. "
                        "Without it workload size — and checker cost — "
                        "scales with host speed")
    p.add_argument("--checker-time-limit", type=float, default=None,
                   help="seconds of analysis budget per check; past it "
                        "checkers return valid? = unknown with "
                        "error = deadline-exceeded instead of running "
                        "unbounded (see docs/RESILIENCE.md)")
    p.add_argument("--test-count", type=int, default=1,
                   help="how many times to run the test")
    p.add_argument("--username", default="root", help="ssh user")
    p.add_argument("--password", help="ssh password")
    p.add_argument("--private-key-path", dest="private_key_path",
                   help="ssh identity file")
    p.add_argument("--leave-db-running", action="store_true",
                   help="skip db teardown for post-mortem inspection")
    p.add_argument("--logging-json", action="store_true",
                   help="JSON log lines")
    p.add_argument("--telemetry", action="store_true",
                   help="collect span tracing + metrics; writes "
                        "telemetry.json and Chrome trace.json into the "
                        "store dir (view with `trace <dir>` or Perfetto), "
                        "and streams events.jsonl live (follow with "
                        "`tail <dir> -f`)")
    p.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="capture a torch.profiler trace (host operators "
                        "and CUDA kernels) into this dir; implies "
                        "telemetry, and every telemetry span is bridged "
                        "to a record_function range so host spans and "
                        "kernels share one Perfetto timeline")


def opts_to_test_map(opts: argparse.Namespace) -> Dict[str, Any]:
    """Merge parsed options into test-map keys (reference's opt merge).
    Every parsed flag passes through (so extra_opts reach test_fn);
    the standard ones are normalized on top."""
    nodes = parse_nodes(opts.nodes, opts.nodes_file)
    out: Dict[str, Any] = {k: v for k, v in vars(opts).items()
                           if k not in ("cmd", "nodes", "nodes_file")}
    out.update({
        "nodes": nodes,
        "concurrency": parse_concurrency(opts.concurrency, len(nodes)),
        "concurrency-spec": opts.concurrency,
        "time-limit": opts.time_limit,
        "checker-time-limit": getattr(opts, "checker_time_limit", None),
        "leave-db-running": opts.leave_db_running,
        "store-dir": opts.store_dir,
        "profile-dir": getattr(opts, "profile_dir", None),
    })
    return out


def _apply_time_limit(test: Dict[str, Any]) -> Dict[str, Any]:
    if test.get("generator") is None:
        return test
    tl = test.get("time-limit")
    if tl:
        test["generator"] = g.time_limit(float(tl), test["generator"])
    n = test.get("ops")
    if n:
        test["generator"] = g.limit(int(n), test["generator"])
    return test


def run_test_cmd(test_fn: Callable[[Dict[str, Any]], Dict[str, Any]],
                 opts: argparse.Namespace) -> int:
    """Run test_fn --test-count times; exit 0 iff all valid (reference
    `single-test-cmd`'s run action)."""
    failures = 0
    for i in range(opts.test_count):
        test = test_fn(opts_to_test_map(opts))
        test = _apply_time_limit(test)
        done = core.run(test)
        valid = done.get("results", {}).get("valid?")
        print(f"run {i + 1}/{opts.test_count}: "
              f"{done.get('name')} valid? = {valid} "
              f"({store.test_dir(done)})")
        if valid is not True:
            failures += 1
    if failures:
        print(f"{failures} failing run(s)", file=sys.stderr)
    return 1 if failures else 0


def campaign_cmd(opts: argparse.Namespace) -> int:
    """`campaign run|status|report <spec.json>` — drive a whole fleet
    of tests through `jepsen_tpu_torch.campaign` (see docs/CAMPAIGN.md);
    ``--cpu`` runs the cells' checkers on the CPU."""
    from . import campaign, report

    try:
        spec = campaign.load_spec(opts.spec)
        campaign.expand(spec)  # plan-time validation: an unknown
        # workload fails HERE with the registered list, not mid-fleet
    except (OSError, ValueError) as e:
        print(f"campaign: bad spec {opts.spec!r}: {e}", file=sys.stderr)
        return 2
    base = opts.store_dir
    if opts.action == "run":
        summary = campaign.run_campaign(
            spec, base, workers=opts.workers,
            device_slots=opts.device_slots, executor=opts.executor,
            rerun=opts.rerun, run_deadline_s=opts.run_deadline,
            cpu=bool(getattr(opts, "cpu", False)))
        print(report.render_campaign(summary))
        bad = summary["counts"]["false"]
        if bad:
            print(f"{bad} invalid run(s)", file=sys.stderr)
        from .minimize.probe import device_error

        dev_err = next((e for e in (device_error(r) for r in
                                    summary["rows"]) if e), None)
        if dev_err:
            # a card that cannot check is never a quiet unknown
            print(f"campaign: the card could not check: "
                  f"{dev_err.strip().splitlines()[-1]}", file=sys.stderr)
            return 1
        return 1 if bad else 0
    if opts.action == "status":
        s = campaign.status_campaign(spec, base)
        c = s["counts"]
        print(f"campaign {s['campaign']}: {s['total']} runs, "
              f"{s['pending']} pending — {c['true']} ok, "
              f"{c['false']} invalid, {c['unknown']} unknown "
              f"({c['degraded']} degraded, {c['deadline']} "
              f"deadline-expired)\nindex: {s['index']}")
        return 0
    if opts.action == "report":
        print(campaign.report_campaign(spec, base))
        return 0
    print(f"campaign: unknown action {opts.action!r}", file=sys.stderr)
    return 2


def shrink_cmd(opts: argparse.Namespace,
               checker_fn: Optional[Callable[[], Any]] = None) -> int:
    """`shrink <run-dir>` — delta-debug an invalid run's history to a
    minimal failing witness (see docs/MINIMIZE.md).  The checker is the
    one `checker_fn` gives, as for `analyze`, else the one the stored
    run resolves to, on the CPU under ``--cpu``."""
    from . import minimize
    from .backend import NoDeviceError
    from .ops.kernels import KernelError

    chk = checker_fn() if checker_fn else None
    try:
        s = minimize.shrink(
            opts.dir, checker=chk, rounds=opts.rounds,
            probe_deadline_s=opts.probe_deadline,
            workers=opts.workers, device_slots=opts.device_slots,
            host_oracle=opts.host_oracle, anomalies=opts.anomaly,
            force=opts.force,
            device="cpu" if getattr(opts, "cpu", False) else None)
    except (ValueError, FileNotFoundError) as e:
        print(f"shrink: {e}", file=sys.stderr)
        return 2
    except (KernelError, NoDeviceError) as e:
        print(f"shrink: the card could not check: {type(e).__name__}: "
              f"{str(e).strip().splitlines()[-1]}", file=sys.stderr)
        return 1
    if s.get("error") == "not-invalid":
        print(f"shrink: run is valid? = {s.get('valid?')}; nothing to "
              "shrink", file=sys.stderr)
        return 1
    if s.get("error") == "target-absent":
        print(f"shrink: requested anomaly {s.get('requested')} not in "
              f"this run's set {s.get('anomaly-types')}", file=sys.stderr)
        return 1
    kinds = ",".join(s.get("anomaly-types") or ()) or "?"
    src = s.get("source-ops", "?")
    print(f"witness: {s['ops']} ops (from {src}) — {kinds}"
          f"{' [cached]' if s.get('cached') else ''}")
    print(f"rounds: {s.get('rounds', 0)}  probes: {s.get('probes', 0)}"
          f"  digest: {s.get('digest')}")
    print(f"written: {s['paths']['ops']}")
    return 0 if s.get("valid?") is False else 1


def analyze_cmd(opts: argparse.Namespace,
                checker_fn: Optional[Callable[[], Any]] = None) -> int:
    """Re-check a stored run (reference: store/load + re-check path)."""
    chk = checker_fn() if checker_fn else None
    try:
        t = core.analyze(opts.dir, checker=chk)
    except (ValueError, FileNotFoundError) as e:
        print(f"analyze: {e}", file=sys.stderr)
        return 2
    valid = t.get("results", {}).get("valid?")
    print(f"re-analysis: valid? = {valid}")
    return 0 if valid is True else 1


def trace_cmd(opts: argparse.Namespace) -> int:
    """Summarize a stored run's telemetry (span tree + metrics); with
    ``--top N``, append the slowest-spans-by-self-time table."""
    import json

    from .telemetry import export as tel_export
    d = opts.dir
    if not os.path.isdir(d):
        print(f"trace: no such directory {d!r}", file=sys.stderr)
        return 2
    try:
        with open(os.path.join(d, tel_export.TELEMETRY_FILE)) as f:
            doc = json.load(f)
        print(tel_export.summarize(d, doc=doc))
    except FileNotFoundError:
        print(f"trace: {d} has no telemetry.json (run the test with "
              "--telemetry or JEPSEN_TELEMETRY=1)", file=sys.stderr)
        return 2
    top = getattr(opts, "top", None)
    if top:
        print(f"\ntop {top} spans by self time:")
        print(tel_export.render_top_spans(tel_export.top_spans(doc, top)))
    return 0


def parse_since(spec: str, now: Optional[float] = None) -> float:
    """``--since`` argument → epoch seconds: a duration back from now
    (``90s``, ``5m``, ``2h``, ``1d``, bare seconds), a large bare
    number taken as an epoch timestamp, or a UTC ISO timestamp."""
    import time as _time

    s = str(spec).strip()
    now = _time.time() if now is None else now
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([smhd]?)", s)
    if m:
        mult = {"": 1.0, "s": 1.0, "m": 60.0, "h": 3600.0,
                "d": 86400.0}[m.group(2)]
        v = float(m.group(1)) * mult
        if m.group(2) == "" and v > 1e9:
            return v  # an epoch timestamp, not a duration
        return now - v
    for fmt in ("%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            import calendar
            import time as _t

            return float(calendar.timegm(_t.strptime(s, fmt)))
        except ValueError:
            continue
    raise ValueError(f"bad --since {spec!r} (want e.g. 5m, 2h, 1d, "
                     "epoch seconds, or YYYY-MM-DDTHH:MM:SS UTC)")


def tail_cmd(opts: argparse.Namespace) -> int:
    """`tail <run-dir>` — render a run's streamed events.jsonl as
    human-readable progress lines; ``-f`` follows a live run; `--since
    <ts|duration>` filters to recent events (a scan of the stream: the
    JAX module's warehouse fast path waits for the port's warehouse).
    The footer names the still-open span chain and the final counter
    values — the post-mortem view for killed/wedged runs."""
    import time as _time

    from .telemetry import stream as tel_stream

    since = None
    if getattr(opts, "since", None):
        try:
            since = parse_since(opts.since)
        except ValueError as e:
            print(f"tail: {e}", file=sys.stderr)
            return 2
    path = opts.dir
    if os.path.isdir(path):
        path = (tel_stream.events_path(path)
                or os.path.join(path, tel_stream.EVENTS_FILE))
    if not os.path.exists(path):
        print(f"tail: {opts.dir} has no events.jsonl (run with "
              "--telemetry or JEPSEN_TELEMETRY=1 to stream)",
              file=sys.stderr)
        return 2

    def since_filter(evs):
        if since is None:
            return evs
        return [e for e in evs
                if isinstance(e.get("t"), (int, float))
                and e["t"] >= since]

    if not getattr(opts, "follow", False):
        evs = since_filter(tel_stream.read_events(path))
        print(tel_stream.render_tail(evs, limit=opts.lines))
        return 0
    cursor = None
    t0 = None
    first = True
    try:
        while True:
            # rotation-proof byte cursor, not a re-parse: a multi-hour
            # soak's events.jsonl is unbounded (and may size-rotate any
            # number of times between polls) and a full-file read per
            # poll is O(n^2) over the run
            evs, cursor = tel_stream.follow_events(path, cursor)
            if evs:
                # "end" can be followed by a straggler (e.g. a sampler
                # tick racing close) — scan the batch, not just its tail
                ended = any(e.get("ev") == "end" for e in evs)
                evs = since_filter(evs)
                if t0 is None and evs:
                    t0 = evs[0].get("t")
                if first and opts.lines is not None \
                        and len(evs) > opts.lines:
                    print(f"... ({len(evs) - opts.lines} earlier events)",
                          flush=True)
                    evs = evs[-opts.lines:] if opts.lines else []
                first = False
                for e in evs:
                    if e.get("ev") == "start":
                        t0 = e.get("t")  # new session replaced the file
                    print(tel_stream.render_line(e, t0), flush=True)
                if ended:
                    return 0
            _time.sleep(0.5)
    except KeyboardInterrupt:
        return 0



def single_test_cmd(test_fn, *, extra_opts: Optional[Callable] = None,
                    checker_fn: Optional[Callable] = None,
                    prog: str = "jepsen-tpu-torch"):
    """Build the standard CLI: `test`, `analyze`, `trace`, `tail`,
    `shrink` and `campaign` subcommands.  Returns (parser, dispatch)."""
    p = base_parser(prog)
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("test", help="run the test")
    add_test_opts(pt)
    if extra_opts:
        extra_opts(pt)

    pa = sub.add_parser("analyze", help="re-check a stored run")
    pa.add_argument("dir", help="store run directory")

    ptr = sub.add_parser("trace",
                         help="summarize a stored run's telemetry")
    ptr.add_argument("dir", help="store run directory")
    ptr.add_argument("--top", type=int, default=None, metavar="N",
                     help="also print the N slowest spans by self-time "
                          "(name, count, total/p95)")

    ptl = sub.add_parser("tail",
                         help="render a run's streamed events.jsonl "
                              "(the flight recorder)")
    ptl.add_argument("dir", help="store run directory (or events.jsonl)")
    ptl.add_argument("-f", "--follow", action="store_true",
                     help="poll for new events until the run ends")
    ptl.add_argument("-n", "--lines", type=int, default=None,
                     help="only show the last N event lines")
    ptl.add_argument("--since", default=None, metavar="TS|DUR",
                     help="only events at/after this time: a duration "
                          "back from now (90s, 5m, 2h, 1d), epoch "
                          "seconds, or a UTC timestamp "
                          "(YYYY-MM-DDTHH:MM:SS)")

    psh = sub.add_parser("shrink",
                         help="delta-debug an invalid run to a minimal "
                              "failing witness (docs/MINIMIZE.md)")
    psh.add_argument("dir", help="store run directory")
    psh.add_argument("--rounds", type=int, default=None,
                     help="cap on probe rounds (default: run to "
                          "1-minimality)")
    psh.add_argument("--probe-deadline", type=float, default=30.0,
                     help="seconds of checker budget per candidate "
                          "probe (expired probes count as "
                          "non-reproducing)")
    psh.add_argument("--workers", type=int, default=2,
                     help="concurrent probe workers (host probes run "
                          "wide; device probes serialize through "
                          "--device-slots)")
    psh.add_argument("--device-slots", type=int, default=1,
                     help="concurrent device-pipeline probes")
    psh.add_argument("--host-oracle", action="store_true",
                     help="probe through the exact host reference "
                          "checker where one exists (much cheaper for "
                          "the many small candidates)")
    psh.add_argument("--anomaly", action="append", default=None,
                     help="pin the shrink target to this anomaly type "
                          "(repeatable; default: any of the run's)")
    psh.add_argument("--force", action="store_true",
                     help="re-shrink even when a cached witness "
                          "matches the history digest")

    pc = sub.add_parser("campaign",
                        help="run/inspect a fleet of tests from a "
                             "campaign spec (docs/CAMPAIGN.md)")
    pc.add_argument("action", choices=("run", "status", "report"))
    pc.add_argument("spec", help="campaign spec JSON file")
    pc.add_argument("--workers", type=int, default=2,
                    help="concurrent campaign workers")
    pc.add_argument("--device-slots", type=int, default=1,
                    help="concurrent device-pipeline runs (host-only "
                         "runs are unthrottled)")
    pc.add_argument("--executor", choices=("thread", "subprocess"),
                    default="thread",
                    help="per-run isolation: in-process threads (the "
                         "kernels stay loaded) or one subprocess per "
                         "run (crash/hang isolation)")
    pc.add_argument("--rerun", action="store_true",
                    help="re-execute runs already in the index "
                         "(appends fresh records; this is what makes "
                         "verdict flips observable)")
    pc.add_argument("--run-deadline", type=float, default=None,
                    help="per-run budget in seconds (the runner's "
                         "process group killed under the subprocess "
                         "executor; cooperative checker deadline "
                         "otherwise)")

    def dispatch(opts: argparse.Namespace) -> int:
        if opts.cmd == "test":
            return run_test_cmd(test_fn, opts)
        if opts.cmd == "analyze":
            return analyze_cmd(opts, checker_fn)
        if opts.cmd == "shrink":
            return shrink_cmd(opts, checker_fn)
        if opts.cmd == "campaign":
            return campaign_cmd(opts)
        if opts.cmd == "trace":
            return trace_cmd(opts)
        if opts.cmd == "tail":
            return tail_cmd(opts)
        p.error(f"unknown command {opts.cmd}")
        return 2

    return p, dispatch


def test_all_cmd(test_fns: Dict[str, Callable], **kw):
    """Like single_test_cmd but runs a whole named suite via
    `test-all [names...]` (reference `test-all-cmd`)."""

    def all_fn(topts: Dict[str, Any]) -> Dict[str, Any]:
        raise RuntimeError("use dispatch, not all_fn")

    p, base_dispatch = single_test_cmd(all_fn, **kw)
    sub = next(a for a in p._actions
               if isinstance(a, argparse._SubParsersAction))
    pall = sub.add_parser("test-all", help="run every named test")
    add_test_opts(pall)
    pall.add_argument("--only", action="append",
                      help="subset of test names to run")

    def dispatch(opts: argparse.Namespace) -> int:
        if opts.cmd == "test-all":
            rc = 0
            names = opts.only or list(test_fns)
            unknown = [n for n in names if n not in test_fns]
            if unknown:
                print(f"unknown test(s): {', '.join(unknown)} "
                      f"(have: {', '.join(test_fns)})", file=sys.stderr)
                return 2
            for name in names:
                logger.info("test-all: %s", name)
                rc |= run_test_cmd(test_fns[name], opts)
            return rc
        if opts.cmd == "test":
            if len(test_fns) != 1:
                print("multiple tests defined; use test-all "
                      f"(have: {', '.join(test_fns)})", file=sys.stderr)
                return 2
            return run_test_cmd(next(iter(test_fns.values())), opts)
        return base_dispatch(opts)

    return p, dispatch


class _JsonFormatter(logging.Formatter):
    """JSON log lines with properly escaped messages (--logging-json)."""

    def format(self, record: logging.LogRecord) -> str:
        return json.dumps({
            "t": self.formatTime(record),
            "lvl": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        })


def run(parser_dispatch, argv: Optional[Sequence[str]] = None) -> int:
    """-main scaffold: parse, set up logging, dispatch, exit code."""
    p, dispatch = parser_dispatch
    opts = p.parse_args(argv)
    if getattr(opts, "logging_json", False):
        h = logging.StreamHandler()
        h.setFormatter(_JsonFormatter())
        logging.basicConfig(level=logging.INFO, handlers=[h])
    else:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    return dispatch(opts)


def main(parser_dispatch, argv: Optional[Sequence[str]] = None) -> None:
    sys.exit(run(parser_dispatch, argv))
