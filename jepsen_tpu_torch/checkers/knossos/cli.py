"""Standalone linearizability-checker CLI (the port's copy of
`jepsen_tpu/checkers/knossos/cli.py`).

Equivalent of the reference's `knossos/cli.clj` (SURVEY.md §2.4 "Op
ctors / standalone CLI"): check a STORED single-object history — a JSON
file of op dicts, or a `.jepsen` store run — against a named model,
without building a test map.

    python -m jepsen_tpu_torch.checkers.knossos.cli history.json \
        --model cas-register [--algorithm competition] [--cpu]

History file format: a JSON array of op dicts
``{"type": "invoke|ok|fail|info", "process": 0, "f": "write",
"value": 1}`` in history order (the reference reads EDN; JSON is this
framework's serialization).  A path to a store run directory loads the
run's history instead.  The analysis's device leg runs on the CUDA
card unless ``--cpu`` is given; with no card it raises
`backend.NoDeviceError` where the device leg is asked.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from jepsen_tpu_torch.models import (
    FIFOQueue,
    GrowOnlySet,
    Mutex,
    UnorderedQueue,
    cas_register,
    register,
)

MODELS = {
    "register": register,
    "cas-register": cas_register,
    "mutex": Mutex,
    "fifo-queue": FIFOQueue,
    "unordered-queue": UnorderedQueue,
    "set": GrowOnlySet,
}

ALGORITHMS = ("auto", "wgl", "linear", "device", "competition")


def load_history(path: str):
    from jepsen_tpu_torch.history.ops import history

    if os.path.isdir(path):
        from jepsen_tpu_torch import store

        test = store.load(path)
        hist = test.get("history")
        if hist is None:
            raise SystemExit(f"no history stored in {path}")
        return hist.materialize() if hasattr(hist, "materialize") else hist
    with open(path) as f:
        ds = json.load(f)
    if not isinstance(ds, list):
        raise SystemExit("history file must be a JSON array of op dicts")
    # files without explicit indices use array order as history order
    return history(ds, reindex=any(d.get("index", -1) < 0 for d in ds))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="knossos",
        description="Check a stored history for linearizability "
                    "(knossos/cli.clj equivalent)")
    p.add_argument("history", help="JSON history file or store run dir")
    p.add_argument("--model", default="cas-register",
                   choices=sorted(MODELS),
                   help="sequential model to check against")
    p.add_argument("--algorithm", default="auto", choices=ALGORITHMS)
    p.add_argument("--max-configs", type=int, default=5_000_000)
    p.add_argument("--cpu", action="store_true",
                   help="run the device leg on the CPU instead of the "
                        "CUDA card")
    opts = p.parse_args(argv)

    from jepsen_tpu_torch.checkers.knossos import analysis

    h = load_history(opts.history)
    model = MODELS[opts.model]()
    res = analysis(h, model, algorithm=opts.algorithm,
                   max_configs=opts.max_configs,
                   device="cpu" if opts.cpu else None)
    print(json.dumps(res, default=str, indent=2))
    if res["valid?"] is True:
        return 0
    return 1 if res["valid?"] is False else 2


if __name__ == "__main__":
    sys.exit(main())
