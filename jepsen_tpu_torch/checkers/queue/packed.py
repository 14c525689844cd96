"""SoA packing for the queue/kafka checker family (the port's copy of
`jepsen_tpu/checkers/queue/packed.py`).

Flattens send/poll/assign/offset-commit histories into the columnar
views the vectorized anomaly passes (:mod:`.kafka`, :mod:`.fifo`)
reduce over, the same treatment `history/soa.py` gives transactions and
`checkers/invariants/packed.py` gives bank reads:

- :class:`PackedKafka` — per-key **offset ladders** (send columns +
  the unique observed ``(key, offset)`` table), flattened poll-message
  columns, and per-consumer **observation rows** (one per ``(poll op,
  key)`` batch, carrying the assignment epoch the host scan checker
  computes via bisect);
- :class:`PackedFifo` — per-value enqueue/dequeue count columns plus
  the per-consumer dequeue order (the FIFO pass's input).

The facts are extracted by the SAME traversal the host scan twins use
(`workloads.kafka._observations`, `TotalQueueChecker`'s counting
model), so the packed columns cannot drift from the oracle semantics.
All derived ORDERS (lexsort permutations, unique tables, epoch codes)
are computed here at pack time on the host — the device reduction then
needs only adjacency compares, searchsorted membership tests, and
segment reductions over already-sorted columns (the derived-order
idiom; docs/QUEUE.md lists the exact column set).

Composite codes: offsets/values/keys are small non-negative ints after
interning, so ``(key, offset)`` packs into one int64 as ``key *
off_base + offset`` (bases are pow2, ``class_label``-stable), which is
what makes the membership tests single searchsorted calls.

The port's kafka checker does not read `PackedKafka.device_safe`: torch
has int64 on the card and the port pads no column, so no `SENTINEL` row
enters a searchsorted table and every history runs on the card.  The
property and the sentinel are kept, equal to the JAX package's, as the
record of where the JAX device path stops.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PackedKafka", "PackedFifo", "pack_kafka", "pack_fifo",
           "SENTINEL"]

#: searchsorted padding sentinel: larger than any real composite code,
#: so padded table rows can never test as members.  2**30 keeps the
#: device path int32-exact (the repo's device dtype convention — see
#: `device_infer.BIG`); histories whose codes would exceed it report
#: ``device_safe == False`` and stay on the int64 host path.
SENTINEL = np.int64(2 ** 30)


def _pow2(n: int, floor: int = 2) -> int:
    x = floor
    while x < n:
        x *= 2
    return x


def _intern(table: Dict[Any, int], order: List[Any], v: Any) -> int:
    i = table.get(v)
    if i is None:
        i = table[v] = len(order)
        order.append(v)
    return i


@dataclass
class PackedKafka:
    """Columnar kafka history: send rows, poll-batch rows (one per
    ``(poll op, key)`` entry, empty batches included for poll-count
    parity but flagged), flattened poll-message rows, the unique
    observed-offset tables, and the pack-time sort permutations the
    reductions consume.  All columns int64; id tables map back."""

    keys: List[Any]                 # key id -> source key
    values: List[Any]               # value id -> source value
    procs: List[Any]                # proc id -> process
    off_base: int                   # pow2 composite base for offsets
    n_sends: int
    n_polls: int                    # batches INCLUDING empty ones
    # send columns (history order)
    s_key: np.ndarray = field(default=None)
    s_off: np.ndarray = field(default=None)
    s_val: np.ndarray = field(default=None)
    s_op: np.ndarray = field(default=None)
    s_proc: np.ndarray = field(default=None)
    # poll-batch columns (non-empty batches, _observations order)
    b_key: np.ndarray = field(default=None)
    b_proc: np.ndarray = field(default=None)
    b_op: np.ndarray = field(default=None)
    b_start: np.ndarray = field(default=None)   # first polled offset
    b_last: np.ndarray = field(default=None)    # last polled offset
    b_ep: np.ndarray = field(default=None)      # epoch code (see pack)
    b_gen: np.ndarray = field(default=None)     # broker gen, -1 = none
    # poll-message columns (batch-major, batch order)
    m_batch: np.ndarray = field(default=None)   # row into b_*
    m_key: np.ndarray = field(default=None)
    m_off: np.ndarray = field(default=None)
    m_val: np.ndarray = field(default=None)
    m_op: np.ndarray = field(default=None)
    m_sendinv: np.ndarray = field(default=None)  # send INVOKE idx, -1
    # derived tables (pack-time sorted/unique)
    u_comp: np.ndarray = field(default=None)    # unique polled k*B+off
    polled_max: np.ndarray = field(default=None)  # per key id, -1=none
    key_max: np.ndarray = field(default=None)   # max SENT|polled, -1
    dv_key: np.ndarray = field(default=None)    # unique polled (k,v,o)
    dv_val: np.ndarray = field(default=None)
    dv_off: np.ndarray = field(default=None)
    av_key: np.ndarray = field(default=None)    # unique seen (k,o,v)
    av_off: np.ndarray = field(default=None)
    av_val: np.ndarray = field(default=None)
    # derived orders (pack-time lexsort permutations)
    s_by_pk: np.ndarray = field(default=None)   # sends by (proc,key,seq)
    s_by_ok: np.ndarray = field(default=None)   # sends by (op,key,seq)
    b_by_pk: np.ndarray = field(default=None)   # batches by (proc,key,seq)
    b_by_kg: np.ndarray = field(default=None)   # batches by (key,gen,start,seq)

    @property
    def empty(self) -> bool:
        return self.n_sends == 0 and self.n_polls == 0

    @property
    def device_safe(self) -> bool:
        """Every composite code / index the kernel computes fits below
        :data:`SENTINEL` (int32-exact on device).  False forces the
        int64 host path."""
        m = self.off_base * max(len(self.keys), 1)
        for a in (self.b_ep, self.s_op, self.m_op, self.m_sendinv):
            if len(a):
                m = max(m, int(a.max()) + 1)
        return m < int(SENTINEL)


def pack_kafka(history) -> PackedKafka:
    """Pack a kafka history.  Facts come from the host twin's own
    traversal (`workloads.kafka._observations`) — identical send/poll/
    reassign extraction, then columnized with epochs precomputed the
    way the twin computes them (per-process reassign bisect + the
    broker rebalance generation riding on subscribe-mode
    completions)."""
    from jepsen_tpu_torch.workloads.kafka import _observations

    sends, polls, reassigns, send_invoked = _observations(history)

    ktab: Dict[Any, int] = {}
    korder: List[Any] = []
    vtab: Dict[Any, int] = {}
    vorder: List[Any] = []
    ptab: Dict[Any, int] = {}
    porder: List[Any] = []

    max_off = 0
    for (_k, off, _v, _i, _p) in sends:
        max_off = max(max_off, off)
    for (_k, msgs, _p, _i, _s, _g) in polls:
        for (off, _v) in msgs:
            max_off = max(max_off, off)

    reassign_by_proc: Dict[Any, List[int]] = {}
    for (p, i) in reassigns:
        reassign_by_proc.setdefault(p, []).append(i)
    max_gen = max([g for (_k, _m, _p, _i, _s, g) in polls
                   if g is not None] or [0])
    gen_base = _pow2(int(max_gen) + 2)

    # -- send columns -------------------------------------------------
    s_key = np.empty(len(sends), np.int64)
    s_off = np.empty(len(sends), np.int64)
    s_val = np.empty(len(sends), np.int64)
    s_op = np.empty(len(sends), np.int64)
    s_proc = np.empty(len(sends), np.int64)
    for n, (k, off, v, i, p) in enumerate(sends):
        s_key[n] = _intern(ktab, korder, k)
        s_off[n] = int(off)
        s_val[n] = _intern(vtab, vorder, v)
        s_op[n] = int(i)
        s_proc[n] = _intern(ptab, porder, p)

    # -- poll batches + messages --------------------------------------
    # the twin iterates sorted(polls, key=(op, slot)) — the polls list
    # is already in that order (one ordered history pass), so the list
    # index IS the batch sequence number
    bk: List[int] = []
    bp: List[int] = []
    bo: List[int] = []
    bstart: List[int] = []
    blast: List[int] = []
    bep: List[int] = []
    bgen: List[int] = []
    mb: List[int] = []
    mk: List[int] = []
    mo: List[int] = []
    mv: List[int] = []
    mop: List[int] = []
    msi: List[int] = []
    n_polls = len(polls)
    for (k, msgs, p, i, _slot, gen) in polls:
        if not msgs:
            continue  # counted in n_polls; excluded from order passes
        kid = _intern(ktab, korder, k)
        pid = _intern(ptab, porder, p)
        # the twin's epoch: (count of p's reassigns before this op,
        # broker generation) — encode the tuple as one comparable code
        epc = bisect.bisect_left(reassign_by_proc.get(p, ()), i)
        gcode = 0 if gen is None else int(gen) + 1
        row = len(bk)
        bk.append(kid)
        bp.append(pid)
        bo.append(int(i))
        bstart.append(int(msgs[0][0]))
        blast.append(int(msgs[-1][0]))
        bep.append(epc * gen_base + gcode)
        bgen.append(-1 if gen is None else int(gen))
        for (off, v) in msgs:
            mb.append(row)
            mk.append(kid)
            mo.append(int(off))
            mv.append(_intern(vtab, vorder, v))
            mop.append(int(i))
            j = send_invoked.get((k, v))
            msi.append(-1 if j is None else int(j))

    b_key = np.asarray(bk, np.int64)
    b_proc = np.asarray(bp, np.int64)
    b_op = np.asarray(bo, np.int64)
    b_start = np.asarray(bstart, np.int64)
    b_last = np.asarray(blast, np.int64)
    b_ep = np.asarray(bep, np.int64)
    b_gen = np.asarray(bgen, np.int64)
    m_batch = np.asarray(mb, np.int64)
    m_key = np.asarray(mk, np.int64)
    m_off = np.asarray(mo, np.int64)
    m_val = np.asarray(mv, np.int64)
    m_op = np.asarray(mop, np.int64)
    m_sendinv = np.asarray(msi, np.int64)

    n_keys = max(len(korder), 1)
    off_base = _pow2(max_off + 2)
    val_base = _pow2(len(vorder) + 1)

    # -- derived tables -----------------------------------------------
    # unique polled (key, offset): the ladder the membership tests
    # (lost-write, poll-skip intervening-offset) searchsorted against
    u_comp = np.unique(m_key * off_base + m_off) if len(m_key) \
        else np.zeros(0, np.int64)
    polled_max = np.full(n_keys, -1, np.int64)
    if len(m_key):
        np.maximum.at(polled_max, m_key, m_off)
    key_max = polled_max.copy()
    if len(s_key):
        np.maximum.at(key_max, s_key, s_off)
    # unique polled (key, value, offset): the duplicate pass's rows
    if len(m_key):
        dvc = np.unique((m_key * val_base + m_val) * off_base + m_off)
        dv_off = dvc % off_base
        dv_val = (dvc // off_base) % val_base
        dv_key = dvc // (off_base * val_base)
    else:
        dv_key = dv_val = dv_off = np.zeros(0, np.int64)
    # unique observed (key, offset, value) over sends AND polls: the
    # inconsistent-offsets pass's version map
    all_k = np.concatenate([s_key, m_key])
    all_o = np.concatenate([s_off, m_off])
    all_v = np.concatenate([s_val, m_val])
    if len(all_k):
        avc = np.unique((all_k * off_base + all_o) * val_base + all_v)
        av_val = avc % val_base
        av_off = (avc // val_base) % off_base
        av_key = avc // (val_base * off_base)
    else:
        av_key = av_off = av_val = np.zeros(0, np.int64)

    # -- derived orders -----------------------------------------------
    seq_s = np.arange(len(s_key), dtype=np.int64)
    seq_b = np.arange(len(b_key), dtype=np.int64)
    return PackedKafka(
        keys=korder, values=vorder, procs=porder, off_base=off_base,
        n_sends=len(sends), n_polls=n_polls,
        s_key=s_key, s_off=s_off, s_val=s_val, s_op=s_op,
        s_proc=s_proc,
        b_key=b_key, b_proc=b_proc, b_op=b_op, b_start=b_start,
        b_last=b_last, b_ep=b_ep, b_gen=b_gen,
        m_batch=m_batch, m_key=m_key, m_off=m_off, m_val=m_val,
        m_op=m_op, m_sendinv=m_sendinv,
        u_comp=u_comp, polled_max=polled_max, key_max=key_max,
        dv_key=dv_key, dv_val=dv_val, dv_off=dv_off,
        av_key=av_key, av_off=av_off, av_val=av_val,
        s_by_pk=np.lexsort((seq_s, s_key, s_proc)),
        s_by_ok=np.lexsort((seq_s, s_key, s_op)),
        b_by_pk=np.lexsort((seq_b, b_key, b_proc)),
        b_by_kg=np.lexsort((seq_b, b_start, b_gen, b_key)),
    )


@dataclass
class PackedFifo:
    """Columnar queue history: per-value enqueue/dequeue counts (the
    total-queue counting model) plus the per-consumer dequeue order
    with each value's enqueue invoke/complete indices (the FIFO
    pass's input)."""

    values: List[Any]               # value id -> source value
    procs: List[Any]
    enqueue_count: int              # total enqueue ATTEMPTS (invokes)
    dequeue_count: int
    # per-value-id count columns
    e_ok: np.ndarray = field(default=None)
    e_maybe: np.ndarray = field(default=None)
    d_cnt: np.ndarray = field(default=None)
    v_inv: np.ndarray = field(default=None)    # earliest enq INVOKE, -1
    v_done: np.ndarray = field(default=None)   # earliest enq OK idx, -1
    v_first_ok: np.ndarray = field(default=None)  # order for rendering
    # ok-dequeue rows (history order)
    q_val: np.ndarray = field(default=None)
    q_op: np.ndarray = field(default=None)
    q_proc: np.ndarray = field(default=None)
    q_by_proc: np.ndarray = field(default=None)  # rows by (proc, seq)

    @property
    def empty(self) -> bool:
        return self.enqueue_count == 0 and self.dequeue_count == 0


def pack_fifo(history) -> PackedFifo:
    """Pack an enqueue/dequeue history under the `TotalQueueChecker`
    counting model: OK enqueues are definite, INFO enqueues possible,
    FAIL enqueues absent; OK dequeues count."""
    from jepsen_tpu_torch.history.ops import INFO, INVOKE, OK

    vtab: Dict[Any, int] = {}
    vorder: List[Any] = []
    ptab: Dict[Any, int] = {}
    porder: List[Any] = []
    eok: List[int] = []
    emaybe: List[int] = []
    dcnt: List[int] = []
    vinv: List[int] = []
    vdone: List[int] = []
    vfirst: List[int] = []
    qv: List[int] = []
    qo: List[int] = []
    qp: List[int] = []
    n_att = 0
    n_deq = 0

    def vid(v: Any) -> int:
        i = vtab.get(v)
        if i is None:
            i = vtab[v] = len(vorder)
            vorder.append(v)
            eok.append(0)
            emaybe.append(0)
            dcnt.append(0)
            vinv.append(-1)
            vdone.append(-1)
            vfirst.append(-1)
        return i

    for op in history:
        if not op.is_client_op():
            continue
        if op.f == "enqueue":
            i = vid(op.value)
            if op.type == INVOKE:
                n_att += 1
                if vinv[i] < 0:
                    vinv[i] = op.index
            elif op.type == OK:
                eok[i] += 1
                if vdone[i] < 0:
                    vdone[i] = op.index
                if vfirst[i] < 0:
                    vfirst[i] = op.index
            elif op.type == INFO:
                emaybe[i] += 1
        elif op.f == "dequeue" and op.type == OK:
            i = vid(op.value)
            dcnt[i] += 1
            n_deq += 1
            qv.append(i)
            qo.append(op.index)
            qp.append(_intern(ptab, porder, op.process))

    q_val = np.asarray(qv, np.int64)
    q_op = np.asarray(qo, np.int64)
    q_proc = np.asarray(qp, np.int64)
    seq = np.arange(len(q_val), dtype=np.int64)
    return PackedFifo(
        values=vorder, procs=porder,
        enqueue_count=n_att, dequeue_count=n_deq,
        e_ok=np.asarray(eok, np.int64),
        e_maybe=np.asarray(emaybe, np.int64),
        d_cnt=np.asarray(dcnt, np.int64),
        v_inv=np.asarray(vinv, np.int64),
        v_done=np.asarray(vdone, np.int64),
        v_first_ok=np.asarray(vfirst, np.int64),
        q_val=q_val, q_op=q_op, q_proc=q_proc,
        q_by_proc=np.lexsort((seq, q_proc)),
    )
