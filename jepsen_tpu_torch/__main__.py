"""`python -m jepsen_tpu_torch` — the framework's own CLI (the port's copy of
`jepsen_tpu/__main__.py`).

Ships a self-contained demo suite over the in-process sim cluster (so the
zero-to-aha path needs no real nodes), plus `analyze` (SURVEY.md §2.1 L7).
A real db suite builds its own CLI with
`jepsen_tpu_torch.cli.single_test_cmd`.  The JAX module's
``"client-latency"`` option, which only its campaign specs set, waits
for the port's campaigns.

The demos are the two Elle workloads, ``append`` and ``wr``.  Their
checkers run on the CUDA card, or on the CPU under ``--cpu``.  The JAX
package's other nine demos wait for their workloads (ROADMAP A).
`analyze DIR` re-checks a stored demo run with the checker of the demo
its stored name names (`suite`).
"""

from __future__ import annotations

import random
import sys
from typing import Any, Dict

from . import cli
from .generator import core as g


def _wl(name: str, opts: Dict[str, Any]):
    from .workloads import append, wr
    from .workloads.mem import MemClient

    rng = random.Random(opts.get("seed"))
    device = "cpu" if opts.get("cpu") else None
    if name == "append":
        return append.workload(rng=rng, device=device), MemClient()
    if name == "wr":
        return (wr.workload(rng=rng, device=device),
                MemClient(txn_kind="rw-register"))
    raise ValueError(f"unknown workload {name!r}")


def _demo_test(name: str):
    def test_fn(opts: Dict[str, Any]) -> Dict[str, Any]:
        wl, client = _wl(name, opts)
        nodes = opts.get("nodes") or ["n1", "n2", "n3"]
        # re-derive concurrency from the raw spec against the *defaulted*
        # node list, so "1n" with no -n flags means 3 workers, not 1
        spec = opts.get("concurrency-spec")
        concurrency = (cli.parse_concurrency(spec, len(nodes)) if spec
                       else opts.get("concurrency") or 5)
        t = dict(opts)
        t.update({
            "name": f"demo-{name}",
            "nodes": nodes,
            "concurrency": concurrency,
            "client": client,
            **{k: v for k, v in wl.items()
               if k not in ("generator", "checker", "final-generator")},
            "generator": g.clients(wl["generator"]),
            "checker": wl["checker"],
        })
        if "final-generator" in wl:
            t["final-generator"] = wl["final-generator"]
        return t

    return test_fn


DEMOS = {n: _demo_test(n) for n in ("append", "wr")}


def demo_checker(name: str, cpu: bool = False):
    """The checker of the demo that a stored run's name (``demo-<name>``)
    names, on the CPU under `cpu`."""
    demo = name[len("demo-"):] if name.startswith("demo-") else None
    if demo not in DEMOS:
        raise ValueError(f"no demo named by the stored run {name!r} "
                         f"(have: {', '.join('demo-' + d for d in DEMOS)})")
    return _wl(demo, {"cpu": cpu})[0]["checker"]


def suite():
    """The demos' (parser, dispatch).  `analyze DIR`'s checker is the
    one of the demo that the stored run at DIR names, on the CPU under
    ``--cpu``: `checker_fn` reads both from the options being
    dispatched."""
    seen: Dict[str, Any] = {}

    def checker_fn():
        from . import store

        opts = seen["opts"]
        try:
            name = str(store.load(opts.dir).get("name") or "")
            return demo_checker(name, opts.cpu)
        except (ValueError, FileNotFoundError) as e:
            # with no checker, analyze reports the run it cannot check
            print(f"analyze: {e}", file=sys.stderr)
            return None

    p, dispatch = cli.test_all_cmd(DEMOS, checker_fn=checker_fn,
                                   prog="python -m jepsen_tpu_torch")

    def remember(opts):
        seen["opts"] = opts
        return dispatch(opts)

    return p, remember


def main(argv=None) -> None:
    cli.main(suite(), argv)


if __name__ == "__main__":
    main()
