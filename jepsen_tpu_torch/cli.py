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

The subcommands are ``test``, ``test-all`` and ``analyze``.  The JAX
module's ``serve``, ``trace``, ``tail``, ``shrink``, ``obs``,
``campaign``, ``fleet`` and ``cache``, and its ``--telemetry`` and
``--profile-dir`` flags, wait for the modules they drive.  ``--cpu``
puts ``"cpu"`` in the options as the checkers' device (``opts["cpu"]``);
without it the checkers run on the CUDA card and, with no card, record
``valid? unknown`` naming `NoDeviceError`.  ``JT_FORCE_CPU`` is not read.
"""

from __future__ import annotations

import argparse
import json
import logging
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


def single_test_cmd(test_fn, *, extra_opts: Optional[Callable] = None,
                    checker_fn: Optional[Callable] = None,
                    prog: str = "jepsen-tpu-torch"):
    """Build the standard CLI: `test` and `analyze` subcommands.
    Returns (parser, dispatch)."""
    p = base_parser(prog)
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("test", help="run the test")
    add_test_opts(pt)
    if extra_opts:
        extra_opts(pt)

    pa = sub.add_parser("analyze", help="re-check a stored run")
    pa.add_argument("dir", help="store run directory")

    def dispatch(opts: argparse.Namespace) -> int:
        if opts.cmd == "test":
            return run_test_cmd(test_fn, opts)
        if opts.cmd == "analyze":
            return analyze_cmd(opts, checker_fn)
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
