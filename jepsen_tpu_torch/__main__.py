"""`python -m jepsen_tpu_torch` — the framework's own CLI (the port's copy of
`jepsen_tpu/__main__.py`).

Ships a self-contained demo suite over the in-process sim cluster (so the
zero-to-aha path needs no real nodes), plus `analyze` (SURVEY.md §2.1 L7).
A real db suite builds its own CLI with
`jepsen_tpu_torch.cli.single_test_cmd`.

The demos are the JAX package's eleven: ``append``, ``wr``,
``lin-register``, ``bank``, ``long-fork``, ``set``, ``queue``, ``kafka``,
``causal``, ``write-skew`` and ``session``.  Their checkers run on the
CUDA card, or on the CPU under ``--cpu``.  `analyze DIR` re-checks a
stored demo run with the checker of the demo its stored name names
(`suite`).
"""

from __future__ import annotations

import random
import sys
from typing import Any, Dict

from . import cli
from .generator import core as g


def _wl(name: str, opts: Dict[str, Any]):
    from .workloads import (append, bank, causal, linearizable_register,
                            long_fork, queue, session, sets, wr,
                            write_skew)
    from .workloads.mem import MemClient, MemStore

    rng = random.Random(opts.get("seed"))
    device = "cpu" if opts.get("cpu") else None
    # per-op client latency (seconds): campaign specs use it to pace
    # the unbounded in-memory cluster so nemesis windows actually
    # overlap a bounded op count
    lat = float(opts.get("client-latency") or 0.0)
    if name == "append":
        return (append.workload(rng=rng, device=device),
                MemClient(latency=lat))
    if name == "wr":
        return (wr.workload(rng=rng, device=device),
                MemClient(txn_kind="rw-register", latency=lat))
    if name == "lin-register":
        return (linearizable_register.workload(rng=rng, device=device),
                MemClient(latency=lat))
    if name == "bank":
        wl = bank.workload(rng=rng, device=device)
        s = MemStore()
        s.accounts = dict(wl["accounts"])
        return wl, MemClient(s, latency=lat)
    if name == "long-fork":
        return (long_fork.workload(rng=rng, device=device),
                MemClient(txn_kind="rw-register", latency=lat))
    if name == "set":
        return sets.workload(rng=rng), MemClient(latency=lat)
    if name == "queue":
        adv = opts.get("queue-adversary") or {}
        return (queue.workload(rng=rng, fifo=bool(adv.get("fifo")),
                               device=device),
                MemClient(
                    latency=lat, rng=random.Random(opts.get("seed")),
                    dup_enqueue_p=float(adv.get("dup-enqueue-p") or 0.0),
                    lose_enqueue_p=float(adv.get("lose-enqueue-p") or 0.0),
                    reorder_dequeue_p=float(
                        adv.get("reorder-dequeue-p") or 0.0)))
    if name == "kafka":
        from .workloads import kafka as kafka_wl

        adv = opts.get("queue-adversary") or {}
        store = kafka_wl.KafkaStore()
        store.freeze_commits = bool(adv.get("freeze-commits"))
        client = kafka_wl.KafkaClient(
            store, rng=random.Random(opts.get("seed")),
            lose_tail_p=float(adv.get("lose-tail-p") or 0.0),
            dup_p=float(adv.get("dup-p") or 0.0),
            dup_send_p=float(adv.get("dup-send-p") or 0.0),
            reorder_p=float(adv.get("reorder-p") or 0.0),
            zombie_p=float(adv.get("zombie-p") or 0.0),
            torn_p=float(adv.get("torn-p") or 0.0))
        return (kafka_wl.workload(
            key_count=int(opts.get("kafka-key-count") or 4),
            subscribe_frac=float(opts.get("kafka-subscribe-frac", 0.2)),
            txn_frac=float(opts.get("kafka-txn-frac", 0.3)),
            crash_frac=float(opts.get("kafka-crash-frac", 0.05)),
            rng=rng, device=device), client)
    if name == "causal":
        return (causal.workload(rng=rng, device=device),
                MemClient(txn_kind="rw-register", latency=lat))
    if name == "write-skew":
        return (write_skew.workload(rng=rng, device=device),
                MemClient(txn_kind="rw-register", latency=lat))
    if name == "session":
        return (session.workload(rng=rng, device=device),
                MemClient(txn_kind="rw-register", latency=lat))
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


DEMOS = {n: _demo_test(n) for n in
         ("append", "wr", "lin-register", "bank", "long-fork", "set",
          "queue", "kafka", "causal", "write-skew", "session")}


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
