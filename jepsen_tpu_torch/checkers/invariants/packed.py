"""The shared packed-history core for the invariants checker family (the
port's copy of `jepsen_tpu/checkers/invariants/packed.py`: host numpy).

Two packings, one idiom (SoA arrays the device can consume directly,
like `history/soa.py` does for the elle pipelines):

- :func:`pack_bank` flattens a bank history (transfer / whole-state
  read ops) into dense arrays: a ``[n_reads, n_accounts]`` balance
  matrix plus transfer columns.  The bank checker's invariants are then
  whole-history array reductions over these.

- :func:`pack_rw` + :func:`infer_rw` pack a transactional rw-register
  shaped history (the long-fork / write-skew / session workloads) via
  the elle `TxnPacker` and derive the per-key version orders and the
  txn dependency edges (ww / wr / rw — including the predicate
  "absence" anti-dependencies a read of the unwritten initial state
  creates) as one vectorized pass.  `RwInference` is what
  `predicate.py` sweeps for cycles and `session.py` ranks sessions
  against — one derivation, shared.

Rel codes and the :class:`~jepsen_tpu_torch.checkers.elle.graph.EdgeList`
container are the elle core's own, so the device rank sweep and the host
Tarjan path apply unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from jepsen_tpu_torch.checkers.elle.graph import (
    REL_RW,
    REL_WR,
    REL_WW,
    EdgeList,
    process_edges,
    realtime_edges_subset,
)
from jepsen_tpu_torch.history.ops import FAIL, INFO, INVOKE, OK, History
from jepsen_tpu_torch.history.soa import (
    MOP_APPEND,
    MOP_READ,
    TXN_FAIL,
    TXN_INFO,
    TXN_OK,
    PackedTxns,
    pack_txns,
)

__all__ = ["PackedBank", "pack_bank", "pack_rw", "RwInference", "infer_rw"]


# ---------------------------------------------------------------------------
# bank packing
# ---------------------------------------------------------------------------

_TXN_TYPE = {OK: TXN_OK, FAIL: TXN_FAIL, INFO: TXN_INFO}


@dataclasses.dataclass
class PackedBank:
    """A bank history flattened to structure-of-arrays."""

    accounts: List[Any]          # sorted account ids (column order)
    # committed whole-state reads
    balances: np.ndarray         # i64 [R, A]
    read_op_index: np.ndarray    # i64 [R] completion op index
    read_process: np.ndarray     # i64 [R]
    # transfers (all completions, type-tagged for attribution)
    tr_type: np.ndarray          # i8 [N] TXN_OK / TXN_FAIL / TXN_INFO
    tr_from: np.ndarray          # i64 [N] account column index
    tr_to: np.ndarray            # i64 [N]
    tr_amount: np.ndarray        # i64 [N]
    tr_op_index: np.ndarray      # i64 [N]

    @property
    def n_reads(self) -> int:
        return len(self.read_op_index)

    @property
    def n_accounts(self) -> int:
        return len(self.accounts)


def pack_bank(history, accounts: Optional[Any] = None) -> PackedBank:
    """Flatten a bank history's committed reads + transfers to SoA.

    `accounts` (optional iterable) pre-pins the column order so the
    initial-balance vector a test map carries lines up; accounts only
    seen in reads/transfers are appended after."""
    h = history if isinstance(history, History) else History(list(history))
    order: List[Any] = []
    for a in sorted(accounts, key=repr) if accounts else ():
        if a not in order:
            order.append(a)
    cols: Dict[Any, int] = {a: i for i, a in enumerate(order)}

    def col(a) -> int:
        i = cols.get(a)
        if i is None:
            i = cols[a] = len(order)
            order.append(a)
        return i

    reads: List[Tuple[dict, int, int]] = []
    trs: List[Tuple[int, int, int, int, int]] = []
    for op in h.ops:
        if op.type == INVOKE or not op.is_client_op():
            continue
        if op.f == "read" and op.type == OK and isinstance(op.value, dict):
            reads.append((op.value, op.index, int(op.process)))
            for a in op.value:
                col(a)
        elif op.f == "transfer" and op.type in _TXN_TYPE:
            v = op.value or {}
            if not isinstance(v, dict):
                continue
            trs.append((_TXN_TYPE[op.type], col(v.get("from")),
                        col(v.get("to")), int(v.get("amount") or 0),
                        op.index))
    A = len(order)
    bal = np.zeros((len(reads), A), dtype=np.int64)
    for i, (v, _, _) in enumerate(reads):
        for a, x in v.items():
            bal[i, cols[a]] = int(x)
    return PackedBank(
        accounts=order,
        balances=bal,
        read_op_index=np.asarray([i for _, i, _ in reads], np.int64),
        read_process=np.asarray([p for _, _, p in reads], np.int64),
        tr_type=np.asarray([t for t, *_ in trs], np.int8),
        tr_from=np.asarray([f for _, f, *_ in trs], np.int64),
        tr_to=np.asarray([t for _, _, t, *_ in trs], np.int64),
        tr_amount=np.asarray([a for *_, a, _ in trs], np.int64),
        tr_op_index=np.asarray([i for *_, i in trs], np.int64),
    )


# ---------------------------------------------------------------------------
# rw packing + shared inference
# ---------------------------------------------------------------------------


def pack_rw(history) -> PackedTxns:
    """Pack a transactional (``txn`` of ``[w k v] / [r k v]`` mops)
    history with the elle rw-register packer — the packed form every
    invariants checker over txn histories consumes."""
    if isinstance(history, PackedTxns):
        return history
    return pack_txns(history, "rw-register")


@dataclasses.dataclass
class RwInference:
    """Everything the predicate / session checkers derive once from a
    packed rw history.  Value-id space: ids < V are written versions;
    id ``V + k`` encodes key k's unwritten initial state (the version a
    predicate read of "absent" observes)."""

    p: PackedTxns
    writer: np.ndarray           # i64 [V] value id -> writing txn (-1)
    v_src: np.ndarray            # i64 version edges u -> v (init-encoded)
    v_dst: np.ndarray
    ext_read_txn: np.ndarray     # i64 external reads: reading txn
    ext_read_val: np.ndarray     # i64 observed value id (init-encoded)
    ext_read_mop: np.ndarray     # i64 mop row of the read
    edges: EdgeList              # ww/wr/rw + process + realtime(barriers)
    n_nodes: int                 # txns + barrier nodes
    rank: np.ndarray             # per-node completion rank (device sweep)
    # per-key chain ranks: rank_of[val_id] = position in its key's
    # version chain (init = 0), or -1 when the key's version graph is
    # not a simple chain (session checks then fall back to the walker)
    chain_rank: np.ndarray       # i64 [V + n_keys]
    chain_ok: np.ndarray         # bool [n_keys]


def infer_rw(p: PackedTxns) -> RwInference:
    """One vectorized pass: version orders, dependency edges, chains.

    Version-order sources are the rw-register defaults (initial state +
    txn-internal read-then-write / write-after-write), which are exact
    for the single-writer-per-key predicate workloads and for the
    session workloads' register traffic.  Mirrors the inference
    `elle/rw_register.check` runs inline; kept as a standalone pass so
    every invariants checker shares the arrays instead of re-deriving.
    """
    T, M, V = p.n_txns, p.n_mops, p.n_vals
    nk = max(p.n_keys, 1)

    ttype = p.txn_type.astype(np.int32)
    ok = ttype == TXN_OK
    graph_txn = ok | (ttype == TXN_INFO)

    kind = p.mop_kind.astype(np.int32)
    mtxn = p.mop_txn.astype(np.int64)
    mkey = p.mop_key.astype(np.int64)
    mval = p.mop_val.astype(np.int64)
    known = np.where(kind == MOP_READ, p.mop_rd_len >= 0, True)

    # writers (priority: ok > info > fail, like the rw checker)
    writer = np.full(V, -1, np.int64)
    wsel = np.nonzero(kind == MOP_APPEND)[0]
    if len(wsel):
        wvals = mval[wsel]
        prio = np.select([ok[mtxn[wsel]], ttype[mtxn[wsel]] == TXN_INFO],
                         [0, 1], 2)
        order = np.lexsort((wsel, prio, wvals))
        sv = wvals[order]
        first = np.concatenate([[True], sv[1:] != sv[:-1]])
        writer[sv[first]] = mtxn[wsel][order][first]

    # per-(txn, key) runs in mop order: the txn-local version state
    run_order = np.lexsort((np.arange(M), mkey, mtxn))
    rt, rk = mtxn[run_order], mkey[run_order]
    rkind = kind[run_order]
    rval = mval[run_order]
    rknown = known[run_order]
    run_start = np.concatenate([[True], (rt[1:] != rt[:-1]) |
                                (rk[1:] != rk[:-1])]) \
        if M else np.zeros(0, bool)
    seg_id = np.cumsum(run_start) - 1 if M else np.zeros(0, np.int64)

    from jepsen_tpu_torch.checkers.elle.rw_register import _seg_exclusive_max

    defines = (rkind == MOP_APPEND) | ((rkind == MOP_READ) & rknown)
    def_val = np.where(rkind == MOP_APPEND, rval,
                       np.where(rval >= 0, rval, V + rk))
    def_pos = np.where(defines, np.arange(M), -1)
    prev_def = _seg_exclusive_max(def_pos, seg_id)
    NO_PREV = -3
    cur_before = np.where(prev_def >= 0, def_val[np.maximum(prev_def, 0)],
                          NO_PREV)

    # external reads: first defining mop of the run is this read
    r_is_read = (rkind == MOP_READ) & rknown & ok[rt]
    external_read = r_is_read & (cur_before == NO_PREV)
    ext_idx = np.nonzero(external_read)[0]
    ext_read_txn = rt[ext_idx]
    ext_read_val = def_val[ext_idx]
    ext_read_mop = run_order[ext_idx] if M else np.zeros(0, np.int64)

    # version edges: write with known predecessor u -> v (blind: init)
    w_idx = np.nonzero((rkind == MOP_APPEND) & graph_txn[rt])[0]
    u = np.where(cur_before[w_idx] >= 0, cur_before[w_idx], V + rk[w_idx])
    v_src = u.astype(np.int64)
    v_dst = rval[w_idx].astype(np.int64)

    # ---- txn dependency edges -------------------------------------------
    es: List[np.ndarray] = []
    ed: List[np.ndarray] = []
    er: List[np.ndarray] = []

    def add(src, dst, rel):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        m = (src >= 0) & (dst >= 0) & (src != dst)
        m &= graph_txn[np.maximum(src, 0)] & graph_txn[np.maximum(dst, 0)]
        es.append(src[m].astype(np.int32))
        ed.append(dst[m].astype(np.int32))
        er.append(np.full(int(m.sum()), rel, np.int8))

    # wr: external reader of a real version <- its writer
    real = ext_read_val < V
    wr_src = (writer[ext_read_val[real]] if V
              else np.zeros(0, np.int64))
    add(wr_src, ext_read_txn[real], REL_WR)
    # ww: writer(u) -> writer(v) over real-u version edges
    real_u = v_src < V
    ww_src = np.where(real_u, writer[np.minimum(v_src, max(V - 1, 0))], -1) \
        if V else np.full(len(v_src), -1, np.int64)
    ww_dst = np.where(v_dst < V, writer[np.minimum(v_dst, max(V - 1, 0))],
                      -1) if V else np.full(len(v_dst), -1, np.int64)
    add(ww_src, ww_dst, REL_WW)
    # rw: external readers of u -> writer(v) per version edge u -> v —
    # the predicate anti-dependency: a read observing the INIT state of
    # key k (absence) has u == V + k, so the edge lands on the writer
    # of k's first installed version
    if len(ext_idx) and len(v_src):
        r_ord = np.argsort(ext_read_val, kind="stable")
        rv_sorted = ext_read_val[r_ord]
        rt_sorted = ext_read_txn[r_ord]
        lo = np.searchsorted(rv_sorted, v_src, side="left")
        hi = np.searchsorted(rv_sorted, v_src, side="right")
        cnt = hi - lo
        tot = int(cnt.sum())
        if tot:
            eidx = np.repeat(np.arange(len(v_src)), cnt)
            off = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            readers = rt_sorted[lo[eidx] + off]
            wdst = np.where(v_dst[eidx] < V,
                            writer[np.minimum(v_dst[eidx], max(V - 1, 0))],
                            -1)
            add(readers, wdst, REL_RW)

    dep = EdgeList()
    dep.src = np.concatenate(es) if es else np.zeros(0, np.int32)
    dep.dst = np.concatenate(ed) if ed else np.zeros(0, np.int32)
    dep.rel = np.concatenate(er) if er else np.zeros(0, np.int8)

    proc = p.txn_process.astype(np.int64)
    inv = p.txn_invoke_pos.astype(np.int64)
    comp = p.txn_complete_pos.astype(np.int64)
    pe = process_edges(np.where(graph_txn, proc, -10 ** 9 - np.arange(T)),
                      inv)
    ok_ids = np.nonzero(ok)[0]
    rte, n_b, b_ranks = realtime_edges_subset(inv, comp, ok_ids,
                                              graph_txn, T)
    edges = EdgeList.concat([dep, pe, rte]).dedup()
    rank = np.concatenate([2 * comp, b_ranks]).astype(np.int32)

    chain_rank, chain_ok = _chain_ranks(V, nk, v_src, v_dst)
    return RwInference(
        p=p, writer=writer, v_src=v_src, v_dst=v_dst,
        ext_read_txn=ext_read_txn, ext_read_val=ext_read_val,
        ext_read_mop=ext_read_mop,
        edges=edges, n_nodes=T + n_b, rank=rank,
        chain_rank=chain_rank, chain_ok=chain_ok)


def _chain_ranks(V: int, nk: int,
                 v_src: np.ndarray, v_dst: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-key version-chain ranks from the direct version edges.

    A key whose version graph is a simple chain rooted at init (every
    node <= 1 successor and <= 1 predecessor, no cycle) gets exact
    ranks: init = 0, then 1, 2, ...  Branched / cyclic keys are marked
    not-ok (`chain_ok[k] = False`) and their versions rank -1 — the
    session checker falls back to the exact DAG walker there, so
    branching can never manufacture a false violation."""
    rank = np.full(V + nk, -1, np.int64)
    ok = np.ones(nk, bool)
    if not len(v_src):
        rank[V:] = 0
        return rank, ok
    succ: Dict[int, List[int]] = {}
    pred_count = np.zeros(V + nk, np.int64)
    for u, v in zip(v_src.tolist(), v_dst.tolist()):
        succ.setdefault(u, []).append(v)
        pred_count[v] += 1
    for k in range(nk):
        root = V + k
        rank[root] = 0
        seen = {root}
        node, r = root, 0
        good = True
        while True:
            nxt = sorted(set(succ.get(node, ())))
            if not nxt:
                break
            if len(nxt) > 1 or nxt[0] in seen or pred_count[nxt[0]] > 1:
                good = False
                break
            node = nxt[0]
            seen.add(node)
            r += 1
            rank[node] = r
        # versions of this key not reached by the chain (disconnected
        # writes) also break chain-exactness
        if good:
            ok[k] = True
        else:
            ok[k] = False
            for n in seen - {root}:
                rank[n] = -1
    # any version never reached from its key's init root stays -1; mark
    # its key not-ok so rank comparisons there are never trusted
    unreached = np.nonzero(rank[:V] < 0)[0]
    if len(unreached):
        # key of a version = key of its init ancestor; derive from edges
        # by walking v_src/v_dst once (init-encoded sources carry keys)
        vk = _version_keys(V, nk, v_src, v_dst)
        for v in unreached.tolist():
            k = int(vk[v])
            if 0 <= k < nk:
                ok[k] = False
    return rank, ok


def _version_keys(V: int, nk: int, v_src: np.ndarray,
                  v_dst: np.ndarray) -> np.ndarray:
    """value id -> key id, propagated from init-encoded edge sources."""
    vk = np.full(V, -1, np.int64)
    init_src = v_src >= V
    vk[v_dst[init_src & (v_dst < V)]] = v_src[init_src & (v_dst < V)] - V
    # propagate along real->real edges until fixpoint (chains are short)
    for _ in range(max(1, nk)):
        m = (v_src < V) & (v_dst < V)
        src_k = np.where(v_src < V, vk[np.minimum(v_src, max(V - 1, 0))],
                         -1)
        upd = m & (src_k >= 0)
        if not upd.any():
            break
        before = vk.copy()
        vk[v_dst[upd]] = src_k[upd]
        if np.array_equal(before, vk):
            break
    return vk
