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

The subcommands are ``test``, ``test-all``, ``serve`` (the store's web
pages; with ``--ingest`` also the always-on verifier service that a
test's ``"live-check": "http://host:port"`` streams to), ``analyze``,
``trace DIR
[--top N]`` (a stored run's telemetry), ``tail DIR [-f] [-n N]
[--since T]`` (its flight recorder; ``--since`` answers from the
store's warehouse when it covers the run, else from the stream),
``shrink DIR`` (`minimize.shrink`: an invalid run cut down to a minimal
witness), ``campaign run|status|report SPEC`` (`campaign`: a matrix of
workload x fault x seed with a resumable verdict index) and ``obs
ingest|rebuild|gate|sql|bench|timeline|profile|diff|gc|alerts|compact``
(the sqlite telemetry warehouse over the store, its queries and the
alert engine), ``fleet serve|work|status|autopilot`` (a campaign served
as a leased work queue over HTTP to workers on this or other hosts, and
the autopilot that streams generations into it) and ``cache
warm|ls|stats|clear`` (the kernel build in ``build/jepsen_tpu_torch/``;
``warm`` raises `KernelError` where the build fails).  ``--telemetry``
collects spans and metrics into the run's store dir; ``--profile-dir
DIR`` also writes a ``torch.profiler`` trace there.  ``--cpu`` puts
``"cpu"`` in the options as the checkers' device (``opts["cpu"]``, and
the device of ``serve --ingest``'s sweeps and seals); without it the
checkers run on the CUDA card and, with no card, a test records
``valid? unknown`` naming
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


def serve_cmd(opts: argparse.Namespace) -> int:
    """`serve` — the store's web pages; with ``--ingest`` also the
    verifier service (docs/VERIFIER.md), its sweeps and seals on the
    card, or on the CPU under ``--cpu``, and its maintenance loop."""
    from . import web

    verifier = None
    if getattr(opts, "ingest", False):
        from .verifier import VerifierService

        cfg = {}
        if getattr(opts, "compact_bytes", None):
            cfg["compact-bytes"] = int(opts.compact_bytes)
        if getattr(opts, "gc_idle", None):
            cfg["gc-idle-s"] = float(opts.gc_idle)
        if getattr(opts, "archive_sealed", None):
            cfg["archive-sealed-s"] = float(opts.archive_sealed)
        verifier = VerifierService(
            opts.store_dir, default_config=cfg,
            device="cpu" if getattr(opts, "cpu", False) else None)
        # the production-service loop: batched multi-tenant sweeps +
        # GC/retention on a maintenance thread
        verifier.start_maintenance(
            float(getattr(opts, "maintain_interval", 5.0) or 5.0))
    try:
        web.serve(port=opts.port, base=opts.store_dir,
                  host=getattr(opts, "host", "127.0.0.1"),
                  verifier=verifier)
    finally:
        if verifier is not None:
            verifier.close()
    return 0


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


def fleet_cmd(opts: argparse.Namespace) -> int:
    """`fleet serve|work|status|autopilot` — the distributed campaign
    control plane (docs/FLEET.md): a coordinator serves a spec as a
    leased work queue over HTTP; remote workers claim, execute, and
    upload verdicts; every cell lands exactly one attributable record.
    `autopilot` (docs/AUTOPILOT.md) is the continuous driver on top:
    stream template generations forever, gate each one, quarantine +
    auto-shrink regressions, scale the worker pool.  ``--cpu`` (before
    the subcommand, or after ``fleet``) runs a worker's cells, or the
    autopilot's managed workers' cells, on the CPU; ``--cache-warm``
    builds the kernels first and fails the command where they cannot
    be built."""
    import json
    import signal
    import time as _time
    import urllib.request

    from . import report, web
    from .fleet import Autopilot, FleetCoordinator, FleetWorker

    base = opts.store_dir
    if getattr(opts, "cache_warm", False) and opts.action in (
            "serve", "work", "autopilot"):
        # before the service loop starts: a build that fails here would
        # fail every device cell anyway
        _cache_warm()
    if opts.action == "autopilot":
        if not opts.spec:
            print("fleet autopilot needs a campaign spec template",
                  file=sys.stderr)
            return 2
        url = f"http://{opts.host}:{opts.port}"
        mutate = None
        if getattr(opts, "rotate", 0):
            from .fleet import scenario_rotation
            mutate = scenario_rotation(
                pivot=tuple(getattr(opts, "pivot", None) or ()),
                slots=opts.rotate)
        try:
            ap = Autopilot(
                opts.spec, base, lease_s=opts.lease,
                run_deadline_s=opts.run_deadline,
                generations=getattr(opts, "generations", None),
                spans=tuple(getattr(opts, "gate_span", None)
                            or ("workload", "check:*")),
                parole_after=getattr(opts, "parole_after", None),
                mutate=mutate,
                coordinator_url=url,
                min_workers=getattr(opts, "workers_min", 0),
                max_workers=getattr(opts, "workers_max", 0),
                worker_version=getattr(opts, "worker_version", None)
                or "dev",
                worker_extra=("--cpu",) if getattr(opts, "cpu", False)
                else ())
        except (OSError, ValueError) as e:
            print(f"fleet: bad spec {opts.spec!r}: {e}",
                  file=sys.stderr)
            return 2
        try:
            signal.signal(signal.SIGTERM, lambda *_: ap.stop.set())
        except ValueError:
            pass  # not the main thread (embedded use)
        srv = web.serve(port=opts.port, base=base, host=opts.host,
                        fleet=ap.coordinator, background=True)
        print(f"autopilot {ap.name}: serving {url}, journal digest "
              f"{ap.journal.digest()}, {len(ap.journal.order)} "
              f"generation(s) journaled, "
              f"{len(ap.journal.quarantined)} quarantined", flush=True)
        try:
            out = ap.run()
        except KeyboardInterrupt:
            ap.close()
            return 1
        finally:
            srv.server_close()
            ap.coordinator.close()
        print(f"autopilot {ap.name}: {out['generations']} "
              f"generation(s) closed, quarantined="
              f"{out['quarantined'] or '[]'}, digest {out['digest']}")
        return 0
    if opts.action == "serve":
        if not opts.spec:
            print("fleet serve needs a campaign spec", file=sys.stderr)
            return 2
        try:
            retention = getattr(opts, "staging_retention", None)
            coord = FleetCoordinator(
                opts.spec, base, lease_s=opts.lease,
                run_deadline_s=opts.run_deadline,
                staging_retention_s=(retention if retention is not None
                                     else 24 * 3600.0))
        except (OSError, ValueError) as e:
            print(f"fleet: bad spec {opts.spec!r}: {e}", file=sys.stderr)
            return 2
        verifier = None
        if getattr(opts, "ingest", False):
            # live verification at fleet scale: the coordinator also
            # serves the verifier, so workers' cells with "live-check"
            # opts stream here — no shared filesystem, one
            # control-plane URL
            from .verifier import VerifierService

            verifier = VerifierService(
                base, device="cpu" if getattr(opts, "cpu", False)
                else None)
            verifier.start_maintenance()
        print(f"fleet {coord.name}: {len(coord.specs)} cells, "
              f"{len(coord._done_ids)} already indexed, lease "
              f"{coord.lease_s}s, boot digest {coord.boot_digest}",
              flush=True)
        if not getattr(opts, "until_done", False):
            try:
                web.serve(port=opts.port, base=base, host=opts.host,
                          fleet=coord, verifier=verifier)
            finally:
                coord.close()
                if verifier is not None:
                    verifier.close()
            return 0
        srv = web.serve(port=opts.port, base=base, host=opts.host,
                        fleet=coord, verifier=verifier,
                        background=True)
        try:
            while not coord.finished:
                _time.sleep(0.2)
        except KeyboardInterrupt:
            return 1
        finally:
            coord.close()
            if verifier is not None:
                verifier.close()
            srv.server_close()
        summary = coord.summary()
        print(report.render_campaign(summary))
        bad = summary["counts"]["false"]
        if bad:
            print(f"{bad} invalid run(s)", file=sys.stderr)
        return 1 if bad else 0
    if opts.action == "work":
        if not opts.coordinator:
            print("fleet work needs --coordinator URL", file=sys.stderr)
            return 2
        worker = FleetWorker(opts.coordinator, base, name=opts.name,
                             device_slots=opts.device_slots,
                             backend=opts.backend, mesh=opts.mesh,
                             poll_s=opts.poll,
                             claim_budget_s=opts.claim_budget,
                             upload=getattr(opts, "upload", False),
                             version=getattr(opts, "worker_version",
                                             None),
                             cpu=bool(getattr(opts, "cpu", False)))
        # SIGTERM drains gracefully: finish the in-flight cell, release
        # unstarted claims, exit — the lease protocol covers kill -9
        try:
            signal.signal(signal.SIGTERM,
                          lambda *_: worker.stop.set())
        except ValueError:
            pass  # not the main thread (embedded use)
        try:
            n = worker.run()
        except KeyboardInterrupt:
            return 1
        print(f"worker {worker.name}: {n} cells completed")
        return 0
    if opts.action == "status":
        if not opts.coordinator:
            print("fleet status needs --coordinator URL",
                  file=sys.stderr)
            return 2
        url = opts.coordinator.rstrip("/") + "/fleet/status"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                s = json.loads(r.read().decode())
        except Exception as e:  # noqa: BLE001 — network errors surfaced
            print(f"fleet: status fetch failed: {e}", file=sys.stderr)
            return 2
        c = s.get("counts") or {}
        print(f"fleet {s.get('campaign')}: {s.get('done')}/"
              f"{s.get('total')} cells done "
              f"({'finished' if s.get('finished') else 'running'}) — "
              f"{c.get('queued')} queued, {c.get('claimed')} claimed, "
              f"{c.get('requeues')} requeues, {c.get('duplicates')} "
              f"duplicates discarded")
        # the scaler's two inputs
        p95 = s.get("claim-latency-p95-s")
        print(f"queue depth: {s.get('queue-depth')}  "
              f"claim-latency p95: "
              f"{'-' if p95 is None else f'{p95:.3f}s'}")
        print(f"digest: {s.get('digest')}  boot: {s.get('boot-digest')}")
        for w, d in sorted((s.get("workers") or {}).items()):
            line = (f"  worker {w}: host={d.get('host')} "
                    f"slots={d.get('device-slots')} "
                    f"version={d.get('version') or '-'} "
                    f"seen {d.get('age-s')}s ago "
                    f"({'alive' if d.get('alive') else 'silent'})")
            wd = d.get("windows")
            if wd:
                open_ = ",".join(str(o.get("pos"))
                                 for o in wd.get("open") or ()) or "-"
                line += (f" windows[gen {wd.get('gen')}] "
                         f"{wd.get('digest')} open={open_}"
                         f"{'' if wd.get('synced') else ' DESYNCED'}")
                if wd.get("t0-skew") is not None:
                    line += (f" t0-skew={wd['t0-skew']}s"
                             f"{'' if wd.get('clock-synced') else ' CLOCK-DESYNCED'}")
            print(line)
        sched = s.get("nemesis-schedule")
        if sched:
            print(f"nemesis schedule: {sched.get('windows')} "
                  f"window(s)/gen over {'|'.join(sched.get('faults'))}")
            gens = sched.get("gens") or {}
            digests = sched.get("digest-by-gen") or {}
            t0s = sched.get("t0-by-gen") or {}
            for g in sorted(gens, key=lambda x: int(x)):
                wins = " ".join(
                    f"[{w.get('pos')}:{w.get('fault')}@"
                    f"{w.get('at_s')}s+{w.get('dur_s')}s]"
                    for w in gens[g])
                anchor = (f" t0={t0s[g]}" if g in t0s else "")
                print(f"  gen {g}: {digests.get(g)}{anchor} {wins}")
        ap = s.get("autopilot")
        if ap:
            print(f"autopilot: generation {ap.get('generation')} "
                  f"({ap.get('generations-closed')} closed), "
                  f"{len(ap.get('quarantined') or {})} quarantined, "
                  f"worker version {ap.get('worker-version')}, "
                  f"journal {ap.get('journal-digest')}")
            for k, q in sorted((ap.get("quarantined") or {}).items()):
                print(f"  quarantined {k}: {q.get('span')} "
                      f"{q.get('rel-delta')} at {q.get('gen')}")
            for v in ap.get("last-verdicts") or []:
                print(f"  gate[{v.get('to-gen')}] "
                      f"{v.get('span')}: {v.get('status')} "
                      f"(rc {v.get('rc')})")
        return 0
    print(f"fleet: unknown action {opts.action!r}", file=sys.stderr)
    return 2


def cache_cmd(opts: argparse.Namespace) -> int:
    """`cache warm|ls|stats|clear` — the port's one ahead-of-time
    artefact, the kernel build in ``build/jepsen_tpu_torch/`` (the JAX
    module's command manages its shape-bucketed AOT compile cache; the
    port compiles nothing per shape).  ``warm`` builds the kernels
    unless the library for the current sources is there, and raises
    `KernelError` where the build fails; ``ls`` and ``stats`` list and
    count the build's files; ``clear`` removes them."""
    from .ops import kernels

    d = str(kernels.BUILD_DIR)
    if opts.action == "warm":
        so, built = _cache_warm(verbose=not opts.json)
        if opts.json:
            print(json.dumps({"dir": d, "library": os.path.basename(so),
                              "built": built}, indent=1))
        return 0
    files = _build_files(d)
    if opts.action == "ls":
        for name, size in files:
            print(f"{name}  {size:>9}")
        print(f"{len(files)} files, {sum(s for _, s in files)} bytes "
              f"({d})")
        return 0
    if opts.action == "stats":
        libs = [n for n, _ in files if n.endswith(".so")]
        print(json.dumps({"dir": d, "files": len(files),
                          "bytes": sum(s for _, s in files),
                          "libraries": libs}, indent=1))
        return 0
    if opts.action == "clear":
        n = 0
        for name, _ in files:
            try:
                os.remove(os.path.join(d, name))
                n += 1
            except OSError:
                pass
        print(f"cache clear: {n} files removed ({d})")
        return 0
    print(f"cache: unknown action {opts.action!r}", file=sys.stderr)
    return 2


def _build_files(d: str) -> List[tuple]:
    """(name, bytes) of every file of the kernel build at `d`."""
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return []
    out = []
    for name in names:
        p = os.path.join(d, name)
        if os.path.isfile(p):
            out.append((name, os.path.getsize(p)))
    return out


def _cache_warm(verbose: bool = True) -> tuple:
    """Build the kernels unless the library for the current sources is
    built (`ops.kernels.build`); returns (its path, whether this call
    built it).  A failed build raises `KernelError`: unlike the JAX
    module's warm-up, which continues cold, every device cell would
    raise it anyway."""
    import time as _time

    from .ops import kernels

    t0 = _time.perf_counter()
    before = {n for n, _ in _build_files(str(kernels.BUILD_DIR))}
    so = kernels.build()
    built = os.path.basename(so) not in before
    if verbose:
        what = (f"built in {_time.perf_counter() - t0:.2f} s" if built
                else "already built")
        print(f"cache warm: {os.path.basename(so)} ({what}; "
              f"{kernels.BUILD_DIR})", flush=True)
    return str(so), built


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


def _warehouse_events(d: str, since: Optional[float]):
    """The ``tail --since`` warehouse fast path: when a warehouse
    exists two levels up (the store base) and fully covers this dir's
    event stream, answer from the indexed event table.  None -> the
    caller falls back to the stream scan."""
    from .telemetry import warehouse as wmod

    base = os.path.dirname(os.path.dirname(os.path.abspath(d)))
    try:
        wh = wmod.open_if_exists(base)
        if wh is None or not wh.events_fresh(d, base):
            return None
        return wh.events_since(d, base, since)
    except Exception:  # noqa: BLE001 — fast path only
        return None


def tail_cmd(opts: argparse.Namespace) -> int:
    """`tail <run-dir>` — render a run's streamed events.jsonl as
    human-readable progress lines; ``-f`` follows a live run; `--since
    <ts|duration>` filters to recent events (served from the warehouse
    event table when one covers the run, stream scan otherwise).  The
    warehouse is a derived index with no device path, so an error
    reading it falls back to the scan.  The footer names the still-open
    span chain and the final counter values — the post-mortem view for
    killed/wedged runs."""
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
        evs = None
        if since is not None and os.path.isdir(opts.dir) and \
                os.path.basename(path) == tel_stream.EVENTS_FILE:
            evs = _warehouse_events(opts.dir, since)
        if evs is None:
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



def _render_timeline(tl: Dict[str, Any]) -> str:
    """One stitched cross-host trace as a text waterfall:
    ordered, host-attributed segments with offsets from the trace's
    first event and proportional duration bars.  Geometry comes from
    the shared `Warehouse.timeline_layout` (one layout, two
    renderers), which is empty-safe for the only-orphans case."""
    from .telemetry.warehouse import Warehouse

    lay = Warehouse.timeline_layout(tl)
    spans, hosts, wall = lay["spans"], lay["hosts"], lay["wall"]
    lines = [f"trace {tl['trace-id']} — run {tl.get('run') or '?'} "
             f"({len(spans)} spans, {len(hosts) or 1} host(s), "
             f"{wall:.3f}s wall)"]
    if spans:
        lines.append(f"{'host':<14} {'segment':<28} {'start':>9} "
                     f"{'dur':>9}  timeline")
    width = 32
    for s in spans:
        left = int(round(s["frac_left"] * width))
        bar = " " * min(left, width - 1) + "#" * max(
            1, int(round(s["frac_width"] * width)))
        lines.append(
            f"{str(s.get('host') or '-'):<14} "
            f"{str(s.get('name')):<28} {s['off']:>8.3f}s "
            f"{s.get('dur_s') or 0.0:>8.3f}s  "
            f"|{bar[:width]:<{width}}|")
    orphans = tl.get("orphans") or []
    if orphans:
        lines.append("")
        lines.append(f"ORPHAN spans ({len(orphans)} recorded against "
                     "this run under a DIFFERENT trace id):")
        for s in orphans:
            lines.append(f"  {s.get('trace_id')} {s.get('name')} "
                         f"host={s.get('host')}")
    return "\n".join(lines)


def obs_cmd(opts: argparse.Namespace) -> int:
    """`obs ingest|rebuild|gate|sql|bench|timeline|profile|diff` — the
    sqlite telemetry warehouse over the store dir (docs/TELEMETRY.md):
    build/refresh it, query it, gate span regressions statistically,
    render stitched cross-host run timelines, and run the performance
    observatory (device-call profiles, cross-generation forensics)."""
    import glob as _glob

    from .telemetry import warehouse as wmod

    base = opts.store_dir
    if opts.action in ("ingest", "rebuild"):
        wh = wmod.open_or_create(base)
        stats = (wh.rebuild(base) if opts.action == "rebuild"
                 else wh.ingest_store(base))
        for pat in opts.bench or []:
            paths = sorted(_glob.glob(pat)) or [pat]
            for p in paths:
                if wh.ingest_bench_file(p):
                    stats["bench"] = stats.get("bench", 0) + 1
                else:
                    print(f"obs: bench file skipped: {p}",
                          file=sys.stderr)
        counts = wh.counts()
        print(f"warehouse: {wmod.warehouse_path(base)}")
        print("ingested: " + ", ".join(
            f"{v} {k}" for k, v in sorted(stats.items())))
        print("tables: " + ", ".join(
            f"{k}={v}" for k, v in sorted(counts.items()) if v))
        if opts.bench and not stats.get("bench"):
            # an explicitly requested bench ingest that landed nothing
            # (typo'd glob, unparsable files) must not leave CI green
            # while the bench series silently stops updating
            print("obs: --bench matched/ingested no files",
                  file=sys.stderr)
            return 2
        return 0
    if opts.action == "gc":
        # store retention: archive
        # landed run dirs past --retention to _archive/ — needs no
        # warehouse (it operates on the store itself; the next ingest
        # simply no longer sees the archived dirs)
        from . import store as store_mod

        retention = getattr(opts, "retention", None)
        if retention is None:
            print("obs: gc needs --retention <seconds>",
                  file=sys.stderr)
            return 2
        stats = store_mod.gc_runs(base, retention_s=float(retention))
        print(f"obs gc: archived {stats['archived']} run dir(s) to "
              f"{store_mod.archive_dir(base)} "
              f"({stats['kept']} kept within retention, "
              f"{stats['skipped']} unlanded skipped)")
        return 0
    if opts.action in ("gate", "profile", "diff"):
        # campaign analytics: Index answers from the warehouse when it
        # is fresh and falls back to the jsonl scan otherwise, so these
        # work (identically) with or without an ingested warehouse
        return _obs_campaign_cmd(opts, base)
    if opts.action == "alerts":
        # the watchtower: warehouse signals are best-effort,
        # so this works on a store with no warehouse at all
        return _obs_alerts_cmd(opts, base)
    wh = wmod.open_if_exists(base)
    if wh is None:
        print(f"obs: no warehouse at {wmod.warehouse_path(base)} "
              "(run `obs ingest` first)", file=sys.stderr)
        return 2
    if opts.action == "compact":
        cdir = os.path.join(base, "campaigns")
        want = opts.campaign or opts.query
        names = ([want] if want else sorted(
            fn[:-len(".jsonl")] for fn in (
                os.listdir(cdir) if os.path.isdir(cdir) else ())
            if fn.endswith(".jsonl")))
        if not names:
            print("obs: no campaign ledgers to compact", file=sys.stderr)
            return 2
        total = {"gens-compacted": 0, "dropped-records": 0,
                 "dropped-spans": 0, "kept-witnesses": 0}
        for name in names:
            path = os.path.join(cdir, f"{name}.jsonl")
            if not os.path.exists(path):
                print(f"obs: no ledger for campaign {name!r}",
                      file=sys.stderr)
                return 2
            stats = wh.compact_ledger(path, base,
                                      keep_gens=opts.keep_gens)
            print(f"compact {name}: " + ", ".join(
                f"{v} {k}" for k, v in sorted(stats.items())))
            for k, v in stats.items():
                total[k] = total.get(k, 0) + v
        if len(names) > 1:
            print("total: " + ", ".join(
                f"{v} {k}" for k, v in sorted(total.items())))
        return 0
    if opts.action == "bench":
        rows = wh.bench_series()
        if not rows:
            print("obs: no bench results ingested (try `obs ingest "
                  "--bench 'BENCH_r0*.json'`)", file=sys.stderr)
            return 2
        print(f"{'source':<24} {'value':>12} {'unit':<10} "
              f"{'vs_baseline':>11} {'n_txns':>9} backend")
        for r in rows:
            print(f"{str(r['source']):<24} {r['value'] or 0:>12.1f} "
                  f"{str(r['unit']):<10} {r['vs_baseline'] or 0:>11.3f} "
                  f"{r['n_txns'] or 0:>9} {r['backend']}")
        return 0
    if opts.action == "timeline":
        if not opts.query:
            print("obs: timeline needs a run id (or 32-hex trace id)",
                  file=sys.stderr)
            return 2
        tl = wh.trace_timeline(opts.query)
        if not tl["spans"] and not tl["orphans"]:
            print(f"obs: no trace spans for {opts.query!r} (run "
                  "`obs ingest` after the run lands; traced runs need "
                  "telemetry or a fleet ledger)", file=sys.stderr)
            return 2
        print(_render_timeline(tl))
        # orphans are a stitching failure worth a red exit: the run's
        # artifacts disagree about which trace they belong to
        return 1 if tl["orphans"] else 0
    if opts.action == "sql":
        if not opts.query:
            print("obs: sql needs a query argument", file=sys.stderr)
            return 2
        try:
            cols, rows = wh.query(opts.query)
        except Exception as e:  # noqa: BLE001 — sqlite/read-only errors
            print(f"obs: sql failed: {e}", file=sys.stderr)
            return 2
        print("\t".join(cols))
        for r in rows:
            print("\t".join(str(v) for v in r))
        return 0
    print(f"obs: unknown action {opts.action!r}", file=sys.stderr)
    return 2


def _obs_alerts_cmd(opts: argparse.Namespace, base: str) -> int:
    """`obs alerts` — render the watchtower's durable alert state
    (docs/ALERTS.md).  Plain: replay <store>/alerts.jsonl read-only.
    With --eval: run one engine tick against the live registry,
    campaign heartbeats, store counters, and warehouse rollups first
    (journaling transitions + notifying sinks — the headless cron
    form of the autopilot's alert tick).  Exit 1 while anything is
    firing, so CI and cron wrappers get the red exit for free."""
    import json as _json

    from .telemetry import alerts as alerts_mod

    if opts.alerts_eval:
        from .telemetry import warehouse as wmod

        eng = alerts_mod.AlertEngine(base)
        eng.evaluate(warehouse=wmod.open_if_exists(base))
        jr = eng.journal
    else:
        path = alerts_mod.alerts_path(base)
        if not os.path.exists(path):
            print(f"obs: no alert journal at {path} (the autopilot's "
                  "alert tick or `obs alerts --eval` creates it)",
                  file=sys.stderr)
            return 2
        jr = alerts_mod.AlertJournal(path)
    order = {"firing": 0, "pending": 1, "resolved": 2}
    rows = sorted(jr.states.items(),
                  key=lambda kv: (order.get(kv[1].get("state"), 3),
                                  kv[0]))
    if opts.json_out:
        doc = {"digest": jr.digest(),
               "sends-ok": jr.sends_ok,
               "sends-failed": jr.sends_failed,
               "states": {r: dict(d) for r, d in rows}}
        if opts.json_out == "-":
            _json.dump(doc, sys.stdout, indent=2, sort_keys=True)
            print()
        else:
            with open(opts.json_out, "w") as f:
                _json.dump(doc, f, indent=2, sort_keys=True)
            print(f"report written: {opts.json_out}")
    firing = [r for r, d in rows if d.get("state") == "firing"]
    if opts.json_out != "-":
        print(f"alerts: {len(firing)} firing, "
              f"{sum(1 for _r, d in rows if d.get('state') == 'pending')} "
              f"pending ({len(rows)} rule(s) journaled) · digest "
              f"{jr.digest()} · notifications {jr.sends_ok} ok / "
              f"{jr.sends_failed} failed")
        if rows:
            w = max(len(r) for r, _d in rows)
            print(f"{'rule':<{w}} {'severity':<8} {'state':<8} "
                  f"{'value':>12} since")
            for r, d in rows:
                v = d.get("value")
                print(f"{r:<{w}} {str(d.get('severity')):<8} "
                      f"{str(d.get('state')):<8} "
                      f"{(f'{v:.4g}' if isinstance(v, (int, float)) else '-'):>12} "
                      f"{d.get('since')}")
    return 1 if firing else 0


def _obs_campaign_cmd(opts: argparse.Namespace, base: str) -> int:
    """`obs gate|profile|diff` — the campaign-scoped observatory
    queries (docs/TELEMETRY.md "Performance observatory").  Exit codes:
    0 pass / rendered, 1 regression, 2 cannot evaluate; for a multi-
    span gate the rc is the WORST single-span verdict (regression >
    insufficient-data > pass)."""
    import json as _json

    from .campaign.core import index_path
    from .campaign.index import Index
    from .telemetry import forensics
    from .telemetry import gate as gate_mod

    campaign = opts.campaign or opts.query
    if not campaign:
        print(f"obs: {opts.action} needs a campaign (positional or "
              "--campaign)", file=sys.stderr)
        return 2
    if opts.action == "profile":
        rows = Index(index_path(campaign, base)).profile()
        if not rows:
            print(f"obs: no device-call profile for campaign "
                  f"{campaign!r} (profiles come from runs recorded "
                  "with telemetry; re-run `obs ingest` after runs "
                  "land)", file=sys.stderr)
            return 2
        print(f"obs profile: campaign {campaign} "
              f"({len(rows)} site/shape cells)")
        print(forensics.render_profile(rows))
        return 0
    if opts.action == "diff":
        report = forensics.run_diff(
            base, campaign, from_gen=opts.from_gen, to_gen=opts.to_gen,
            spans=opts.span or None, alpha=opts.alpha,
            threshold=opts.threshold, min_runs=opts.min_runs)
        if opts.json_out == "-":
            # machine form on stdout: the human
            # rendering moves to stderr so `obs diff --json - | jq`
            # sees pure JSON
            print(forensics.render_diff(report), file=sys.stderr)
            _json.dump(report, sys.stdout, indent=2, sort_keys=True)
            print()
        else:
            print(forensics.render_diff(report))
            if opts.json_out:
                with open(opts.json_out, "w") as f:
                    _json.dump(report, f, indent=2, sort_keys=True)
                print(f"report written: {opts.json_out}")
        return {"pass": 0, "regression": 1}.get(report.get("status"), 2)
    # gate: repeated --span flags, each an exact name or a * glob
    if not opts.span:
        print("obs: gate needs --campaign and --span", file=sys.stderr)
        return 2
    idx = Index(index_path(campaign, base))
    records = idx.forensic_records()
    known = {n for _g, sp, _p, _c in records for n in sp}
    wanted = forensics.resolve_spans(known, opts.span)
    if not wanted:
        print(f"obs: --span {opts.span} matched no recorded span of "
              f"campaign {campaign!r} (known: "
              f"{', '.join(sorted(known)) or 'none'})", file=sys.stderr)
        return 2
    statuses = []
    results = []
    out = sys.stderr if opts.json_out == "-" else sys.stdout
    for i, span in enumerate(wanted):
        res = gate_mod.run_gate(
            base, campaign, span,
            from_gen=opts.from_gen, to_gen=opts.to_gen,
            alpha=opts.alpha, threshold=opts.threshold,
            min_runs=opts.min_runs)
        statuses.append(res.get("status"))
        if i:
            print(file=out)
        print(gate_mod.render_gate(res), file=out)
        entry = None
        if opts.explain and res.get("status") == "regression":
            entry = forensics.attribute_span(
                span, records, res["from-gen"], res["to-gen"])
            for line in forensics.render_attribution(entry):
                print("  " + line, file=out)
        results.append({"span": span, **res,
                        **({"attribution": entry} if entry else {})})
    if opts.json_out:
        # machine form: '-' puts pure JSON on
        # stdout for webhook payloads / CI without a tempfile
        report = {"campaign": campaign,
                  "status": ("regression" if "regression" in statuses
                             else "pass" if all(s == "pass"
                                                for s in statuses)
                             else "insufficient-data"),
                  "gates": results}
        if opts.json_out == "-":
            _json.dump(report, sys.stdout, indent=2, sort_keys=True)
            print()
        else:
            with open(opts.json_out, "w") as f:
                _json.dump(report, f, indent=2, sort_keys=True)
            print(f"report written: {opts.json_out}")
    if "regression" in statuses:
        return 1
    return 0 if all(s == "pass" for s in statuses) else 2


def single_test_cmd(test_fn, *, extra_opts: Optional[Callable] = None,
                    checker_fn: Optional[Callable] = None,
                    prog: str = "jepsen-tpu-torch"):
    """Build the standard CLI: `test`, `serve`, `analyze`, `trace`,
    `tail`, `shrink`, `campaign`, `obs`, `fleet` and `cache`
    subcommands.  Returns (parser, dispatch)."""
    p = base_parser(prog)
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("test", help="run the test")
    add_test_opts(pt)
    if extra_opts:
        extra_opts(pt)

    ps = sub.add_parser("serve", help="serve the store web UI")
    ps.add_argument("-p", "--port", type=int, default=8080)
    ps.add_argument("--host", default="127.0.0.1",
                    help='bind address (use "0.0.0.0" to expose)')
    ps.add_argument("--ingest", action="store_true",
                    help="run the always-on verifier service: accept "
                         "streamed history segments on POST "
                         "/ingest/<session> and publish rolling "
                         "verdicts on GET /verdict/<session> "
                         "(docs/VERIFIER.md); its checks run on the "
                         "card, on the CPU under --cpu")
    ps.add_argument("--compact-bytes", type=int, default=None,
                    help="auto-compact a session's journal once it "
                         "exceeds this many bytes (checkpoint + "
                         "truncate; docs/VERIFIER.md)")
    ps.add_argument("--gc-idle", type=float, default=None,
                    help="expire open sessions idle for this many "
                         "seconds (journal stays; a later touch "
                         "recovers them)")
    ps.add_argument("--archive-sealed", type=float, default=None,
                    help="archive sealed sessions idle for this many "
                         "seconds under <store>/verifier/_archive/")
    ps.add_argument("--maintain-interval", type=float, default=5.0,
                    help="seconds between maintenance ticks (batched "
                         "sweep + gc)")

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

    po = sub.add_parser("obs",
                        help="telemetry warehouse: ingest/rebuild the "
                             "sqlite index over the store, query it, "
                             "gate span regressions, and render "
                             "stitched cross-host run timelines "
                             "(docs/TELEMETRY.md)")
    po.add_argument("action",
                    choices=("ingest", "rebuild", "gate", "sql",
                             "bench", "timeline", "profile", "diff",
                             "gc", "alerts", "compact"))
    po.add_argument("query", nargs="?",
                    help="SQL for the sql action (read-only); run id "
                         "or 32-hex trace id for the timeline action; "
                         "campaign name for profile/diff")
    po.add_argument("--bench", action="append", metavar="GLOB",
                    help="BENCH json file(s) to ingest alongside the "
                         "store (repeatable; glob ok)")
    po.add_argument("--campaign", help="gate/profile/diff: campaign "
                                       "name")
    po.add_argument("--span", action="append",
                    help="gate/diff: span site(s) to compare "
                         "(repeatable; * globs match known spans, "
                         "e.g. --span 'check:*')")
    po.add_argument("--explain", action="store_true",
                    help="gate: on regression, attribute the delta "
                         "across phase buckets and forensic counters")
    po.add_argument("--json", dest="json_out", metavar="PATH",
                    help="gate/diff/alerts: also write the full "
                         "report as a JSON artifact; '-' writes it to "
                         "stdout (webhook payloads / CI embedding "
                         "without a tempfile round-trip)")
    po.add_argument("--eval", dest="alerts_eval", action="store_true",
                    help="alerts: run one evaluation tick (registry + "
                         "heartbeats + warehouse rollups) against the "
                         "store's rule pack, journaling transitions "
                         "and notifying sinks, before rendering")
    po.add_argument("--keep-gens", dest="keep_gens", type=int,
                    default=2,
                    help="compact: generations of raw rows to keep "
                         "live per ledger (default 2); older fold "
                         "into bounded summary rows")
    po.add_argument("--from-gen", dest="from_gen", default=None,
                    help="gate: baseline generation (default: "
                         "second-latest)")
    po.add_argument("--to-gen", dest="to_gen", default=None,
                    help="gate: candidate generation (default: latest)")
    po.add_argument("--alpha", type=float, default=0.05,
                    help="gate: Mann-Whitney one-sided significance "
                         "level (default 0.05)")
    po.add_argument("--threshold", type=float, default=0.25,
                    help="gate: hard relative p95 regression bound "
                         "(default 0.25 = +25%%)")
    po.add_argument("--min-runs", dest="min_runs", type=int, default=3,
                    help="gate: minimum runs per generation; fewer "
                         "exits 2 (cannot evaluate), never a silent "
                         "pass/fail")
    po.add_argument("--retention", type=float, default=None,
                    metavar="SECONDS",
                    help="gc: archive landed run dirs older than this "
                         "to <store>/_archive/ (they leave store "
                         "scans and future warehouse ingests)")

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

    pfl = sub.add_parser("fleet",
                         help="distributed campaign execution: a "
                              "leased work queue served over HTTP + "
                              "remote workers (docs/FLEET.md)")
    pfl.add_argument("action", choices=("serve", "work", "status",
                                        "autopilot"))
    pfl.add_argument("spec", nargs="?",
                     help="campaign spec JSON file (serve), or spec "
                          "TEMPLATE (autopilot: expanded into "
                          "generations forever)")
    pfl.add_argument("-p", "--port", type=int, default=8080)
    pfl.add_argument("--host", default="127.0.0.1",
                     help='bind address (use "0.0.0.0" so remote '
                          "workers can reach the control plane)")
    pfl.add_argument("--coordinator", default=None, metavar="URL",
                     help="coordinator base URL (work/status), e.g. "
                          "http://host:8080")
    pfl.add_argument("--lease", type=float, default=15.0,
                     help="claim lease seconds; a worker that stops "
                          "renewing for this long loses the cell, "
                          "which requeues (serve)")
    pfl.add_argument("--run-deadline", type=float, default=None,
                     help="per-cell checker budget in seconds, merged "
                          "into cells without their own (serve)")
    pfl.add_argument("--until-done", action="store_true",
                     help="serve: exit with the campaign summary once "
                          "every cell has a verdict (default: keep "
                          "serving)")
    pfl.add_argument("--name", default=None,
                     help="worker name (default: host-pid)")
    pfl.add_argument("--device-slots", type=int, default=1,
                     help="device pipelines this worker can run; 0 "
                          "claims host-only cells")
    pfl.add_argument("--poll", type=float, default=0.5,
                     help="idle claim poll interval seconds (work)")
    pfl.add_argument("--backend", default=None,
                     help="advertised device backend capability "
                          "(work): device cells whose opts pin a "
                          '"backend" land only on matching workers')
    pfl.add_argument("--mesh", default=None,
                     help='advertised mesh shape, e.g. "2x2" (work)')
    pfl.add_argument("--claim-budget", type=float, default=120.0,
                     help="seconds of seeded-jittered backoff a worker "
                          "spends riding out claim outages before "
                          "giving up (work)")
    pfl.add_argument("--upload", action="store_true",
                     help="work: upload each cell's run dir to the "
                          "coordinator's artifact endpoint — no "
                          "shared store filesystem needed "
                          "(docs/FLEET.md federation)")
    pfl.add_argument("--ingest", action="store_true",
                     help="serve: also run the verifier service on "
                          "the same port, so cells with "
                          '"live-check" opts stream here '
                          "(docs/VERIFIER.md)")
    pfl.add_argument("--generations", type=int, default=None,
                     help="autopilot: stop after this many gated "
                          "generations (default: stream forever)")
    pfl.add_argument("--gate-span", dest="gate_span", action="append",
                     help="autopilot: span site(s) gated per "
                          "generation (repeatable, * globs; default "
                          "workload + check:*)")
    pfl.add_argument("--workers-min", dest="workers_min", type=int,
                     default=0,
                     help="autopilot: scaler lower bound on managed "
                          "local workers (0 = bring your own workers)")
    pfl.add_argument("--workers-max", dest="workers_max", type=int,
                     default=0,
                     help="autopilot: scaler upper bound; 0 disables "
                          "the scaler entirely")
    pfl.add_argument("--worker-version", dest="worker_version",
                     default=None,
                     help="work: advertised build version (default "
                          "$JEPSEN_WORKER_VERSION or 'dev'); "
                          "autopilot: target version — changing it on "
                          "a live loop rolls the pool one worker at "
                          "a time")
    pfl.add_argument("--parole-after", dest="parole_after",
                     type=int, default=None, metavar="N",
                     help="autopilot: re-admit a quarantined cell "
                          "after N closed generations with no "
                          "regression since its quarantine — a "
                          "re-offender is re-quarantined "
                          "(docs/AUTOPILOT.md; default: quarantine "
                          "is forever)")
    pfl.add_argument("--rotate", dest="rotate", type=int, default=0,
                     metavar="N",
                     help="autopilot: rotate scenarios, not just "
                          "seeds — each generation keeps the pivot "
                          "cells and fills N slots by walking the "
                          "template's remaining cells in order "
                          "(docs/AUTOPILOT.md; 0 = run the full "
                          "template every generation)")
    pfl.add_argument("--pivot", dest="pivot", action="append",
                     metavar="LABEL",
                     help="autopilot --rotate: cell label/workload "
                          "kept in EVERY generation so its span "
                          "stays gate-comparable (repeatable; "
                          "default: the template's first cell)")
    pfl.add_argument("--staging-retention", dest="staging_retention",
                     type=float, default=None,
                     help="serve: expire abandoned artifact-upload "
                          "partials under <store>/fleet/staging/ "
                          "after this many seconds (default 86400); "
                          "staged bytes are visible either way as "
                          "jepsen_fleet_artifact_staging_bytes on "
                          "/metrics")
    pfl.add_argument("--cache-warm", dest="cache_warm",
                     action="store_true",
                     help="build the CUDA kernels at service start "
                          "(serve/work/autopilot) unless they are "
                          "built; a failed build fails the command")
    pfl.add_argument("--cpu", action="store_true",
                     default=argparse.SUPPRESS,
                     help="work/autopilot: run the cells' checkers on "
                          "the CPU instead of the CUDA card (as the "
                          "top-level --cpu); serve --ingest: the "
                          "verifier's checks")

    pcc = sub.add_parser("cache",
                         help="the kernel build in "
                              "build/jepsen_tpu_torch/: build it, "
                              "list or count its files, or remove them")
    pcc.add_argument("action", choices=("warm", "ls", "stats", "clear"))
    pcc.add_argument("--json", action="store_true",
                     help="machine-readable output (warm)")

    def dispatch(opts: argparse.Namespace) -> int:
        if opts.cmd == "test":
            return run_test_cmd(test_fn, opts)
        if opts.cmd == "serve":
            return serve_cmd(opts)
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
        if opts.cmd == "obs":
            return obs_cmd(opts)
        if opts.cmd == "fleet":
            return fleet_cmd(opts)
        if opts.cmd == "cache":
            return cache_cmd(opts)
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
