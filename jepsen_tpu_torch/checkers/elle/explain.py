"""Per-edge justifications for reported cycles (the Explainer; the port's
copy of `jepsen_tpu/checkers/elle/explain.py`).

Equivalent of the reference's Explainer protocol (`elle/core.clj`,
SURVEY.md §2.3 "Core analyzers"): each analyzer there yields an explainer
that turns a graph edge into human-readable evidence — which key, which
values, why the edge must exist.  Here an explainer is a plain callable
``(src_txn, rel_name, dst_txn) -> dict`` returning justification fields
merged into the reported cycle edge:

  ww       {key, value, value'}  — src appended value, dst appended
           value', its immediate successor in key's version order
  wr       {key, value}          — dst read a list ending in value, which
           src appended
  rw       {key, value'}         — src read a prefix NOT containing
           value'; dst appended value' (the anti-dependency)
  process  {process}             — same process, program order
  realtime {positions}           — src completed before dst invoked

plus a ``"why"`` sentence rendering the evidence.  Lookups are exact
replays of the inference that created the edge, evaluated lazily on the
(small) reported cycle only — the device returns witnesses, the host
explains them (SURVEY.md §7 "Explanations").  `la_explainer` serves the
list-append checker, `rw_explainer` the rw-register checker.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from jepsen_tpu_torch.history.soa import MOP_READ, PackedTxns

Explainer = Callable[[int, str, int], Dict]


def _vname(p: PackedTxns, v: int):
    """Original (uninterned) value for a value id."""
    if 0 <= v < len(p.val_names):
        return p.val_names[int(v)][1]
    return None


def _kname(p: PackedTxns, k: int):
    return p.key_names[int(k)] if 0 <= k < len(p.key_names) else None


def la_explainer(p: PackedTxns, order: Dict[str, np.ndarray]) -> Explainer:
    """Explainer over a list-append history.

    `order` is the inferred version-order block (`device_infer.infer`'s
    ``out["order"]`` pulled to host): elems/start/len per key plus the
    value->writer map.
    """
    ord_elems = np.asarray(order["elems"])
    ord_start = np.asarray(order["start"])
    ord_len = np.asarray(order["len"])
    writer = np.asarray(order["writer"])
    kind = np.asarray(p.mop_kind)
    mtxn = np.asarray(p.mop_txn)
    mkey = np.asarray(p.mop_key)
    rd_start = np.asarray(p.mop_rd_start)
    rd_len = np.asarray(p.mop_rd_len)
    rd_elems = np.asarray(p.rd_elems)
    orig = np.asarray(p.txn_orig_index)

    nk = len(ord_len)
    V = len(writer)

    def T(t: int):
        return int(orig[t]) if 0 <= t < p.n_txns else t

    # consecutive version pairs (u, v) per key, vectorized once: slot j
    # pairs with j+1 when both lie inside the same key's order segment
    n_slots = len(ord_elems)
    slots = np.arange(max(n_slots - 1, 0))
    if n_slots > 1:
        slot_key = np.clip(
            np.searchsorted(ord_start, slots, side="right") - 1, 0,
            max(nk - 1, 0))
        seg_end = ord_start[slot_key] + ord_len[slot_key]
        pair_ok = (slots + 1 < seg_end)
        pu = ord_elems[:-1]
        pv = ord_elems[1:]
        pair_ok &= (pu >= 0) & (pu < V) & (pv >= 0) & (pv < V)
        pair_wu = np.where(pair_ok, writer[np.clip(pu, 0, V - 1)], -1)
        pair_wv = np.where(pair_ok, writer[np.clip(pv, 0, V - 1)], -1)
    else:
        slot_key = np.zeros(0, np.int64)
        pu = pv = pair_wu = pair_wv = np.zeros(0, np.int64)

    def explain(a: int, rel: str, b: int) -> Dict:
        if rel == "ww":
            # consecutive versions (u, v) of some key with writer(u)=a,
            # writer(v)=b (vectorized: a reported cycle must stay cheap
            # to justify even on 1M-op histories)
            hits = np.nonzero((pair_wu == a) & (pair_wv == b))[0]
            if len(hits):
                j = int(hits[0])
                k, u, v = int(slot_key[j]), int(pu[j]), int(pv[j])
                return {
                    "key": _kname(p, k), "value": _vname(p, u),
                    "value'": _vname(p, v),
                    "why": (f"T{T(a)} appended {_vname(p, u)!r} to "
                            f"key {_kname(p, k)!r}; T{T(b)} appended "
                            f"{_vname(p, v)!r}, its immediate "
                            f"successor in the version order"),
                }
        elif rel == "wr":
            # b read a list whose final element a appended
            for m in np.nonzero((mtxn == b) & (kind == MOP_READ)
                                & (rd_len > 0))[0]:
                last = int(rd_elems[int(rd_start[m]) + int(rd_len[m]) - 1])
                if 0 <= last < V and writer[last] == a:
                    k = int(mkey[m])
                    return {
                        "key": _kname(p, k), "value": _vname(p, last),
                        "mop": int(m),
                        "why": (f"T{T(b)} read key {_kname(p, k)!r} ending "
                                f"in {_vname(p, last)!r}, which T{T(a)} "
                                f"appended"),
                    }
        elif rel == "rw":
            # a read a prefix of k missing the next version, appended by b
            for m in np.nonzero((mtxn == a) & (kind == MOP_READ)
                                & (rd_len >= 0))[0]:
                k = int(mkey[m])
                L = int(rd_len[m])
                if k < nk and L < int(ord_len[k]):
                    succ = int(ord_elems[int(ord_start[k]) + L])
                    if 0 <= succ < V and writer[succ] == b:
                        seen = (_vname(p, int(
                            rd_elems[int(rd_start[m]) + L - 1]))
                            if L > 0 else None)
                        read_desc = (f"up to {seen!r}" if L
                                     else "as empty")
                        return {
                            "key": _kname(p, k), "value'": _vname(p, succ),
                            "mop": int(m),
                            "why": (f"T{T(a)} read key {_kname(p, k)!r} "
                                    f"{read_desc}, before T{T(b)}'s append "
                                    f"of {_vname(p, succ)!r} (unobserved "
                                    f"successor: anti-dependency)"),
                        }
        elif rel in ("process", "proc"):
            pa = int(p.txn_process[a]) if a < p.n_txns else None
            return {
                "process": pa,
                "why": (f"T{T(a)} and T{T(b)} both ran on process {pa}; "
                        f"T{T(a)} completed first (program order)"),
            }
        elif rel in ("realtime", "rt"):
            ca = int(p.txn_complete_pos[a]) if a < p.n_txns else None
            ib = int(p.txn_invoke_pos[b]) if b < p.n_txns else None
            return {
                "completed-at": ca, "invoked-at": ib,
                "why": (f"T{T(a)} completed (event {ca}) before T{T(b)} "
                        f"invoked (event {ib}): a real-time edge"),
            }
        return {}

    return explain


def rw_explainer(p: PackedTxns, writer: np.ndarray,
                 v_src: np.ndarray, v_dst: np.ndarray,
                 ext_read_txn: np.ndarray,
                 ext_read_val: np.ndarray) -> Explainer:
    """Explainer over an rw-register history.

    writer: value id -> writing txn.  (v_src, v_dst): inferred direct
    version edges (value ids; ids >= V encode the initial state).
    ext_read_txn/val: external reads (txn, value-id-or-init).
    """
    orig = np.asarray(p.txn_orig_index)
    V = len(writer)

    def T(t: int):
        return int(orig[t]) if 0 <= t < p.n_txns else t

    def vname(v: int):
        return _vname(p, v) if v < V else None  # init encodes as None

    def key_of_val(v: int):
        if 0 <= v < V:
            return _kname(p, int(p.val_names[int(v)][0]))
        return None

    def explain(a: int, rel: str, b: int) -> Dict:
        if rel == "wr":
            sel = (ext_read_txn == b) & (ext_read_val < V)
            for v in ext_read_val[sel]:
                if writer[int(v)] == a:
                    return {
                        "key": key_of_val(int(v)), "value": vname(int(v)),
                        "why": (f"T{T(b)} read {vname(int(v))!r} of key "
                                f"{key_of_val(int(v))!r}, which T{T(a)} "
                                f"wrote"),
                    }
        elif rel == "ww":
            for u, v in zip(v_src, v_dst):
                u, v = int(u), int(v)
                if u < V and v < V and writer[u] == a and writer[v] == b:
                    return {
                        "key": key_of_val(v), "value": vname(u),
                        "value'": vname(v),
                        "why": (f"T{T(a)} wrote {vname(u)!r}, which T{T(b)} "
                                f"overwrote with {vname(v)!r} (key "
                                f"{key_of_val(v)!r})"),
                    }
        elif rel == "rw":
            for u, v in zip(v_src, v_dst):
                u, v = int(u), int(v)
                if v < V and writer[v] == b:
                    sel = (ext_read_txn == a) & (ext_read_val == u)
                    if sel.any():
                        return {
                            "key": key_of_val(v), "value": vname(u),
                            "value'": vname(v),
                            "why": (f"T{T(a)} read {vname(u)!r}, which "
                                    f"T{T(b)} overwrote with {vname(v)!r} "
                                    f"(key {key_of_val(v)!r}: "
                                    f"anti-dependency)"),
                        }
        elif rel in ("process", "proc"):
            pa = int(p.txn_process[a]) if a < p.n_txns else None
            return {
                "process": pa,
                "why": (f"T{T(a)} and T{T(b)} both ran on process {pa}; "
                        f"T{T(a)} completed first (program order)"),
            }
        elif rel in ("realtime", "rt"):
            ca = int(p.txn_complete_pos[a]) if a < p.n_txns else None
            ib = int(p.txn_invoke_pos[b]) if b < p.n_txns else None
            return {
                "completed-at": ca, "invoked-at": ib,
                "why": (f"T{T(a)} completed (event {ca}) before T{T(b)} "
                        f"invoked (event {ib}): a real-time edge"),
            }
        return {}

    return explain
