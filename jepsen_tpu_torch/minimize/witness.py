"""Minimal-witness persistence (the port's copy of
`jepsen_tpu/minimize/witness.py`: the same files and the same digests,
so a witness written by either package is a cache hit for the other).

Two artifacts land in the run's store dir when a shrink completes:

- ``witness.jsonl`` — the minimal failing sub-history, one op per line
  (the same codec/shape as ``history.json``, so every existing loader
  and differ applies);
- ``witness.json``  — the metadata: content digests (witness + the
  source history it was shrunk from), op/txn counts, the surviving
  anomaly types, the re-check's full anomaly map — including the
  explained cycles whose edges carry the elle Explainer's per-edge
  justification (key, values, the "why" sentence; see
  ``checkers/elle/explain.py``) — and the shrink run's stats (rounds,
  probes, probe latency quantiles).

The **source digest** is what makes re-shrinking a no-op: ``shrink``
compares the stored ``source-digest`` against the current history's
digest and returns the cached witness instantly when they match — a
campaign that auto-shrinks on every generation pays for each distinct
failure once.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Iterable, Optional

from jepsen_tpu_torch.history.ops import History, Op
from jepsen_tpu_torch.store import codec

__all__ = ["history_digest", "save_witness", "load_witness",
           "witness_paths", "WITNESS_META", "WITNESS_OPS"]

WITNESS_META = "witness.json"
WITNESS_OPS = "witness.jsonl"


def history_digest(history: Iterable[Op], n: int = 16) -> str:
    """Content digest of a history: op dicts, canonical JSON, in
    order.  Index-independent fields only would be wrong here — the
    interleaving IS the anomaly — so the full dict (index, time,
    process, type, f, value, error) feeds the hash."""
    h = hashlib.sha256()
    for op in history:
        d = op.to_dict() if hasattr(op, "to_dict") else dict(op)
        h.update(json.dumps(d, sort_keys=True, default=str).encode())
        h.update(b"\n")
    return h.hexdigest()[:n]


def witness_paths(run_dir: str) -> Dict[str, str]:
    return {"meta": os.path.join(run_dir, WITNESS_META),
            "ops": os.path.join(run_dir, WITNESS_OPS)}


def save_witness(run_dir: str, witness: History,
                 meta: Dict[str, Any]) -> Dict[str, str]:
    """Persist both artifacts; returns their paths.  `meta` is written
    verbatim plus the witness digest/op count (the caller supplies
    source-digest, anomalies, stats)."""
    paths = witness_paths(run_dir)
    os.makedirs(run_dir, exist_ok=True)
    with open(paths["ops"], "w") as f:
        for op in witness:
            f.write(codec.dumps(op.to_dict()).decode() + "\n")
    doc = {
        "version": 1,
        "digest": history_digest(witness),
        "ops": len(witness),
        **meta,
    }
    tmp = paths["meta"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_jsonable(doc), f, indent=1, sort_keys=True)
    os.replace(tmp, paths["meta"])
    return paths


def load_witness(run_dir: str) -> Optional[Dict[str, Any]]:
    """Load a stored witness: the meta doc with ``"history"`` attached
    (the re-closed History from witness.jsonl).  None when absent or
    unreadable — a corrupt witness just means re-shrinking."""
    paths = witness_paths(run_dir)
    if not (os.path.exists(paths["meta"]) and os.path.exists(paths["ops"])):
        return None
    try:
        with open(paths["meta"]) as f:
            doc = json.load(f)
        ops = []
        with open(paths["ops"], "rb") as f:
            for line in f:
                if line.strip():
                    # the codec, not json.loads: save_witness writes
                    # codec-tagged dicts (tuples, int-keyed poll maps)
                    ops.append(Op.from_dict(codec.loads(line)))
    except (OSError, ValueError, KeyError):
        return None
    doc["history"] = History(ops, reindex=False)
    return doc


def _jsonable(v: Any) -> Any:
    """Same best-effort coercion rule as telemetry export: a witness
    save must never crash on a numpy scalar inside an anomaly map."""
    from jepsen_tpu_torch.telemetry.export import _jsonable as tj

    return tj(v)
