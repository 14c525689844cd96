"""Device-side edge inference + anomaly scans for list-append histories.

Counterpart of `jepsen_tpu/checkers/elle/device_infer.py`, bit for bit on
every returned array.  Every per-key computation is a flat segment op over
arrays sorted by key; dependency edges come out as fixed-capacity masked
COO arrays (ww, wr, rw, and the realtime-barrier tb/bt families), plus the
process and barrier chains and the node ranks the cycle sweep consumes.

The expansion of per-key and per-read tables onto the slot and
read-element axes is the forward-fill structure of the JAX package's
kernel branch on every device: values are seeded at segment starts and
filled forward by `ops.fill.locf` (the LOCF kernel on a CUDA tensor, its
plain version on a CPU tensor).  The JAX package's other expansion
(cummax plus gathers) is bit-equal to it and is not carried over.

JAX semantics kept explicitly, since torch raises where JAX does not:
gathers here only ever see indices that the JAX code clips first, and
every `.at[]` scatter goes through `_scatter`, which wraps a negative
index once and drops an out-of-range one, as a JAX scatter does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from jepsen_tpu_torch import backend
from jepsen_tpu_torch.history.soa import (
    MOP_APPEND,
    MOP_READ,
    TXN_FAIL,
    TXN_INFO,
    TXN_OK,
    PackedTxns,
)
from jepsen_tpu_torch.ops.fill import locf
from jepsen_tpu_torch.ops.segments import (
    SINKS,
    segmented_cummax,
    segmented_cumsum,
    sink_rows,
)

BIG = 2 ** 30

I32 = torch.int32


@dataclasses.dataclass
class PaddedLA:
    """Padded device inputs for a list-append history (torch tensors).

    T/M/R are padded capacities; *_mask mark real rows.  Fields, dtypes
    and static facts are those of the JAX package's `PaddedLA`: int8
    `txn_type`/`mop_kind`, bool masks, int32 everything else.  A static
    fact that is False/0 (or an IR column that is None) means unknown:
    `infer` then derives the order in-program.
    """

    txn_type: torch.Tensor          # (T,) i8 (0 = padding)
    txn_process: torch.Tensor       # (T,) i32
    txn_invoke_pos: torch.Tensor    # (T,) i32
    txn_complete_pos: torch.Tensor  # (T,) i32
    txn_mask: torch.Tensor          # (T,) bool
    mop_txn: torch.Tensor           # (M,) i32
    mop_kind: torch.Tensor          # (M,) i8
    mop_key: torch.Tensor           # (M,) i32
    mop_val: torch.Tensor           # (M,) i32 (append value id or -1)
    mop_rd_start: torch.Tensor      # (M,) i32
    mop_rd_len: torch.Tensor        # (M,) i32 (-1 unknown)
    mop_mask: torch.Tensor          # (M,) bool
    rd_elems: torch.Tensor          # (R,) i32
    rd_elem_mask: torch.Tensor      # (R,) bool
    n_keys: int
    n_vals: int
    txn_major: bool = False         # mop_txn nondecreasing, mops contiguous
    run_cap: int = 0                # pow2 >= max mops/txn (0 = unknown)
    complete_monotone: bool = False  # complete_pos strictly increasing
    v_cap: int = 0                  # pow2 > max value id (0: use R)
    o_cap: int = 0                  # pow2 >= version-order slots (0: use R)
    app_val_mono: bool = False      # append val ids nondecreasing
    rd_start_mono: bool = False     # rd_start strictly increasing
    proc_seq: bool = False          # per process, invoke order == row order
    run_sort: Optional[torch.Tensor] = None       # (M,) (txn,key,pos) order
    inv_run: Optional[torch.Tensor] = None        # (M,) its inverse
    key_ord_len: Optional[torch.Tensor] = None    # (K,) longest known read
    key_ord_read: Optional[torch.Tensor] = None   # (K,) its mop (-1 none)
    proc_order: Optional[torch.Tensor] = None     # (T,) (process, invoke)
    barrier_order: Optional[torch.Tensor] = None  # (T,) ok-completion order
    barrier_bi: Optional[torch.Tensor] = None     # (T,) barrier before invoke


DATA_FIELDS = (
    "txn_type", "txn_process", "txn_invoke_pos", "txn_complete_pos",
    "txn_mask", "mop_txn", "mop_kind", "mop_key", "mop_val", "mop_rd_start",
    "mop_rd_len", "mop_mask", "rd_elems", "rd_elem_mask", "run_sort",
    "inv_run", "key_ord_len", "key_ord_read", "proc_order", "barrier_order",
    "barrier_bi")
STATIC_FIELDS = (
    "n_keys", "n_vals", "txn_major", "run_cap", "complete_monotone", "v_cap",
    "o_cap", "app_val_mono", "rd_start_mono", "proc_seq")


def padded_from_numpy(fields: Dict[str, Optional[np.ndarray]],
                      statics: Dict[str, object],
                      device: backend.DeviceLike = None) -> PaddedLA:
    """A `PaddedLA` on `device` from `{name: numpy array or None}` for
    every data field and `{name: value}` for every static fact (e.g.
    `np.asarray` of a JAX `PaddedLA`'s fields).  One host->device copy
    per array."""
    dev = backend.resolve(device)
    data = {name: None if fields.get(name) is None
            else torch.from_numpy(np.require(fields[name],
                                             requirements="CW")).to(dev)
            for name in DATA_FIELDS}
    return PaddedLA(**data, **{name: statics[name] for name in STATIC_FIELDS})


def to_device(h: PaddedLA, device: torch.device) -> PaddedLA:
    """`h` with every tensor on `device` (no copy where one is already)."""
    return dataclasses.replace(h, **{
        name: getattr(h, name).to(device) for name in DATA_FIELDS
        if getattr(h, name) is not None})


def padded_to_numpy(h: PaddedLA) -> tuple[dict, dict]:
    """(fields, statics) of `h`, the inverse of `padded_from_numpy`."""
    fields = {name: None if getattr(h, name) is None
              else getattr(h, name).cpu().numpy() for name in DATA_FIELDS}
    return fields, {name: getattr(h, name) for name in STATIC_FIELDS}


# Above this many mops in one txn the shifted-compare ranking (2*(cap-1)
# M-sized passes) stops beating a full device sort.
_RUN_CAP_MAX = 32


def pow2_at_least(n: int, floor: int = 8) -> int:
    x = floor
    while x < n:
        x *= 2
    return x


def run_cap_of(longest: int) -> int:
    """Pow2 bucket for the longest per-txn mop run; 0 = too long, use the
    device-sort path."""
    return pow2_at_least(max(longest, 1), floor=1) \
        if longest <= _RUN_CAP_MAX else 0


def _layout_facts(p: PackedTxns) -> tuple[bool, int, bool]:
    """Host-verify the packing-layout invariants that let `infer` skip
    device sorts (cheap numpy scans)."""
    txn_major = bool(
        p.n_mops == 0
        or (np.all(np.diff(p.mop_txn) >= 0)
            and p.mop_txn[0] >= 0 and p.mop_txn[-1] < p.n_txns))
    run_cap = 0
    if txn_major:
        longest = int(np.bincount(
            p.mop_txn, minlength=max(p.n_txns, 1)).max()) if p.n_mops \
            else 1
        run_cap = run_cap_of(longest)
    complete_monotone = bool(np.all(np.diff(p.txn_complete_pos) > 0)) \
        if p.n_txns > 1 else True
    return txn_major, run_cap, complete_monotone


def _ir_facts(p: PackedTxns) -> dict:
    """Host-verify the capacity/layout facts (cheap numpy).  Every fact
    degrades to the in-program path when False/0, so exotic hand-built
    histories stay exact.  Not memoized: tests mutate PackedTxns arrays
    in place and pad again."""
    nk = max(p.n_keys, 1)
    kind = p.mop_kind
    # ---- v_cap: one past the max value id anywhere ----------------------
    mx = p.n_vals - 1
    if p.n_mops:
        mx = max(mx, int(p.mop_val.max()))
    if len(p.rd_elems):
        mx = max(mx, int(p.rd_elems.max()))
    v_cap = pow2_at_least(mx + 1, floor=8)
    # ---- o_cap: sum of per-key longest known-read lengths ---------------
    # only when every real mop key is in range (out-of-range keys keep the
    # R-sized table)
    o_cap = 0
    keys_ok = p.n_mops == 0 or (
        int(p.mop_key.min()) >= 0 and int(p.mop_key.max()) < nk)
    if keys_ok:
        rd = (kind == MOP_READ) & (p.mop_rd_len >= 0)
        total = 0
        if rd.any():
            mk = np.zeros(nk, np.int64)
            np.maximum.at(mk, p.mop_key[rd], p.mop_rd_len[rd])
            total = int(mk.sum())
        o_cap = pow2_at_least(max(total, 1), floor=8)
    # ---- append-val monotonicity ----------------------------------------
    app = (kind == MOP_APPEND) & (p.mop_val >= 0)
    app_val_mono = bool(np.all(np.diff(p.mop_val[app]) >= 0)) \
        if app.any() else True
    # ---- read-element allocation monotonicity ---------------------------
    he = (kind == MOP_READ) & (p.mop_rd_len > 0)
    if he.any():
        hs = p.mop_rd_start[he]
        rd_start_mono = bool(
            hs[0] >= 0 and np.all(np.diff(hs) > 0)
            and int(hs[-1] + p.mop_rd_len[he][-1]) <= len(p.rd_elems))
    else:
        rd_start_mono = True
    # ---- per-process invoke order == row order --------------------------
    if p.n_txns > 1:
        order = np.argsort(p.txn_process, kind="stable")
        inv_s = p.txn_invoke_pos[order]
        same = p.txn_process[order][1:] == p.txn_process[order][:-1]
        proc_seq = bool(np.all(inv_s[1:][same] > inv_s[:-1][same]))
    else:
        proc_seq = True
    return {"v_cap": v_cap, "o_cap": o_cap, "app_val_mono": app_val_mono,
            "rd_start_mono": rd_start_mono, "proc_seq": proc_seq}


def _ir_columns(p: PackedTxns, T: int, M: int, txn_major: bool,
                run_cap: int) -> Optional[dict]:
    """Host-derive the order columns over the PADDED index spaces,
    bit-for-bit the orders `infer` would compute in-program (same
    sentinel placement, same stable tie-breaks).  None when ids are out
    of range: `infer` then derives everything in-program."""
    n, m = p.n_txns, p.n_mops
    nk = max(p.n_keys, 1)
    if m and (int(p.mop_txn.min()) < 0 or int(p.mop_txn.max()) >= max(n, 1)
              or int(p.mop_key.min()) < 0 or int(p.mop_key.max()) >= nk):
        return None

    # ---- (txn, key, pos) run permutation --------------------------------
    if txn_major and run_cap:
        # within-txn counting by shifted compares
        te = p.mop_txn.astype(np.int64)
        ke = p.mop_key.astype(np.int64)
        rank = np.zeros(m, np.int64)
        for d in range(1, run_cap):
            same = te[d:] == te[:-d]
            rank[d:] += same & (ke[:-d] <= ke[d:])
            rank[:-d] += same & (ke[d:] < ke[:-d])
        first_mop = np.searchsorted(te, np.arange(n, dtype=np.int64))
        inv_v = first_mop[te] + rank
    else:
        inv_v = np.empty(m, np.int64)
        inv_v[np.lexsort((np.arange(m), p.mop_key.astype(np.int64),
                          p.mop_txn.astype(np.int64)))] = np.arange(m)
    inv_run = np.concatenate([inv_v, np.arange(m, M)]).astype(np.int32)
    run_sort = np.zeros(M, np.int32)
    run_sort[inv_run] = np.arange(M, dtype=np.int32)

    # ---- per-key longest known read -------------------------------------
    ok = p.txn_type == TXN_OK
    K = pow2_at_least(nk, floor=8)
    kl = np.zeros(K, np.int64)
    kr_read = np.full(K, M, np.int64)
    if m:
        kr = (p.mop_kind == MOP_READ) & (p.mop_rd_len >= 0) & ok[p.mop_txn]
        np.maximum.at(kl, p.mop_key[kr], p.mop_rd_len[kr])
        longest = kr & (p.mop_rd_len == kl[p.mop_key])
        np.minimum.at(kr_read, p.mop_key[longest],
                      np.nonzero(longest)[0])
    key_ord_read = np.where(kr_read < M, kr_read, -1).astype(np.int32)

    # ---- process / realtime orders --------------------------------------
    graph = ok | (p.txn_type == TXN_INFO)
    pslot = np.full(T, BIG, np.int64)
    pslot[:n] = np.where(graph, p.txn_process, BIG)
    inv_pad = np.zeros(T, np.int64)
    inv_pad[:n] = p.txn_invoke_pos
    proc_order = np.lexsort((np.arange(T), inv_pad, pslot)).astype(np.int32)
    bslot = np.full(T, BIG, np.int64)
    bslot[:n] = np.where(ok, p.txn_complete_pos, BIG)
    border = np.argsort(bslot, kind="stable").astype(np.int32)
    comp_sorted = np.where(bslot[border] < BIG, bslot[border], BIG)
    bi = (np.searchsorted(comp_sorted, inv_pad, side="left") - 1) \
        .astype(np.int32)
    return {
        "run_sort": run_sort, "inv_run": inv_run,
        "key_ord_len": kl.astype(np.int32), "key_ord_read": key_ord_read,
        "proc_order": proc_order, "barrier_order": border,
        "barrier_bi": bi,
    }


def pad_packed(p: PackedTxns, t_pad: int = 0, m_pad: int = 0,
               r_pad: int = 0, v_pad: int = 0, o_pad: int = 0,
               ir_facts: Optional[dict] = None,
               device: backend.DeviceLike = None) -> PaddedLA:
    """Pad a PackedTxns to pow2 capacities on the host (numpy), then move
    the result to `device` (the CUDA card unless the caller names the
    CPU) in one copy per array.

    `v_pad`/`o_pad` pin the value-table / order-table capacities; 0 =
    derive from the data (`_ir_facts`).  `ir_facts` (a dict `_ir_facts(p)`
    produced for THIS packing) skips deriving the facts again."""
    dev = backend.resolve(device)
    T = t_pad or pow2_at_least(p.n_txns)
    M = m_pad or pow2_at_least(p.n_mops)
    R = r_pad or pow2_at_least(max(len(p.rd_elems), p.n_vals, p.n_keys + 1))
    txn_major, run_cap, complete_monotone = _layout_facts(p)
    ir = dict(ir_facts) if ir_facts is not None else _ir_facts(p)
    if v_pad:
        ir["v_cap"] = v_pad
    if o_pad:
        ir["o_cap"] = o_pad
    # capacities never exceed R: a degenerate history whose id space
    # outruns its element table keeps the R-sized layout
    ir["v_cap"] = min(ir["v_cap"], R) if ir["v_cap"] else 0
    ir["o_cap"] = min(ir["o_cap"], R) if ir["o_cap"] else 0
    cols = _ir_columns(p, T, M, txn_major, run_cap) or {}

    def pad(a, n, fill=0):
        out = np.full(n, fill, dtype=a.dtype)
        out[: len(a)] = a
        return out

    fields = dict(
        txn_type=pad(p.txn_type, T),
        txn_process=pad(p.txn_process, T),
        txn_invoke_pos=pad(p.txn_invoke_pos, T),
        txn_complete_pos=pad(p.txn_complete_pos, T),
        txn_mask=np.arange(T) < p.n_txns,
        mop_txn=pad(p.mop_txn, M),
        mop_kind=pad(p.mop_kind, M, fill=-1),
        mop_key=pad(p.mop_key, M),
        mop_val=pad(p.mop_val, M, fill=-1),
        mop_rd_start=pad(p.mop_rd_start, M, fill=-1),
        mop_rd_len=pad(p.mop_rd_len, M, fill=-1),
        mop_mask=np.arange(M) < p.n_mops,
        rd_elems=pad(p.rd_elems, R, fill=-1),
        rd_elem_mask=np.arange(R) < len(p.rd_elems),
        **cols,
    )
    statics = dict(n_keys=p.n_keys, n_vals=p.n_vals, txn_major=txn_major,
                   run_cap=run_cap, complete_monotone=complete_monotone,
                   **ir)
    return padded_from_numpy(fields, statics, dev)


# ---------------------------------------------------------------------------
# JAX indexing semantics on torch tensors
# ---------------------------------------------------------------------------


def _g(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[idx] for indices the caller has already clipped into range."""
    return a[idx.long()]


def _scatter(size: int, fill: int, idx: torch.Tensor, vals: torch.Tensor,
             reduce: str, dtype: torch.dtype = I32,
             keep: Optional[int] = None) -> torch.Tensor:
    """`jnp.full(size, fill, dtype).at[idx].<reduce>(vals)[:keep]`: a
    negative index wraps once (by `size`), an index still outside [0,
    size) is dropped, as in JAX.  Indices at or past `keep` only reach
    slots that are cut off, so they go to the spread sink slots instead.
    `reduce` is "amax", "amin", "sum" or "set" (only used with indices
    free of duplicates)."""
    keep = size if keep is None else keep
    i = idx.long()
    i = torch.where(i < 0, i + size, i)
    i = torch.where((i < 0) | (i >= keep),
                    sink_rows(keep, i.shape[0], i.device), i)
    out = torch.full((keep + SINKS,), fill, dtype=dtype, device=idx.device)
    v = vals.to(dtype)
    if reduce == "set":
        out[i] = v
    else:
        out.scatter_reduce_(0, i, v, reduce, include_self=True)
    return out[:keep]


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """`jnp.argmax` of a bool vector: the first True index, else 0."""
    n = x.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=x.device)
    first = torch.where(x, pos, n).min()
    return torch.where(first < n, first, 0)


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Stable permutation ordering by (primary, secondary), ties in index
    order (`lax.sort(..., num_keys=2, is_stable=True)`)."""
    perm = torch.argsort(secondary, stable=True)
    return perm[torch.argsort(primary[perm], stable=True)]


def _count(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.to(I32), dtype=I32)


def _cat_flag(first: bool, rest: torch.Tensor) -> torch.Tensor:
    head = torch.full((1,), first, dtype=torch.bool, device=rest.device)
    return torch.cat([head, rest])


def infer(h: PaddedLA, n_keys: int) -> Dict[str, dict]:
    """Full inference: anomaly flags + dependency edges + chains + ranks.
    Same dict layout as the JAX `infer`; arrays stay on `h`'s device."""
    dev = h.txn_type.device
    T = h.txn_type.shape[0]
    M = h.mop_txn.shape[0]
    R = h.rd_elems.shape[0]
    V = h.v_cap or R
    O = h.o_cap or R
    nk = max(n_keys, 1)

    def arange(n):
        return torch.arange(n, dtype=I32, device=dev)

    ok = h.txn_type == TXN_OK
    graph_txn = ok | (h.txn_type == TXN_INFO)  # fail txns carry no edges

    is_append = h.mop_mask & (h.mop_kind == MOP_APPEND) & (h.mop_val >= 0)
    is_read = h.mop_mask & (h.mop_kind == MOP_READ)
    mop_txn_c = h.mop_txn.clamp(0, T - 1)
    reader_ok = _g(ok, mop_txn_c)
    known_read = is_read & (h.mop_rd_len >= 0) & reader_ok
    mop_pos = arange(M)

    # ---- writers ---------------------------------------------------------
    app_txn = torch.where(is_append, h.mop_txn, -1)
    if h.app_val_mono:
        # append val ids nondecreasing in mop order (host-verified): the
        # forward-filled index vector is sorted, masked rows land on the
        # previous append's slot with a no-op payload.  The JAX package
        # takes a cummax here (jepsen_tpu/checkers/elle/device_infer.py:395);
        # under app_val_mono the running max of these seeds is the last
        # non-hole value, which is what LOCF gives (appends have val >= 0,
        # so no seed that is not a hole equals the hole -1)
        seeds = torch.where(is_append, h.mop_val, -1)
        assert seeds.dtype == I32, seeds.dtype
        w_idx = locf(seeds).clamp(0, V)
    else:
        w_idx = torch.where(is_append, h.mop_val, V)
    writer = _scatter(V + 1, -1, w_idx, app_txn, "amax", keep=V)
    app_count = _scatter(V + 1, 0, w_idx, is_append, "sum", keep=V)
    writer_type = torch.where(writer >= 0,
                              _g(h.txn_type, writer.clamp(0, T - 1)), 0)
    duplicate_appends = _count(app_count > 1)

    # ---- (txn, key, pos) run order ---------------------------------------
    txn_eff = torch.where(h.mop_mask, h.mop_txn, T)
    key_eff = torch.where(h.mop_mask, h.mop_key, nk)
    if h.run_sort is not None:
        run_sort = h.run_sort
        inv_run = h.inv_run
    elif h.txn_major and h.run_cap:
        # within-txn ranking by (key, pos) over runs of <= run_cap mops:
        # earlier pos wins key ties (backward compare <=, forward <)
        rank = torch.zeros(M, dtype=I32, device=dev)
        for d in range(1, h.run_cap):
            same_p = txn_eff[d:] == txn_eff[:-d]
            rank[d:] += (same_p & (key_eff[:-d] <= key_eff[d:])).to(I32)
            rank[:-d] += (same_p & (key_eff[d:] < key_eff[:-d])).to(I32)
        first_mop = _scatter(
            T + 1, M, torch.where(h.mop_mask, mop_txn_c, T),
            torch.where(h.mop_mask, mop_pos, M), "amin", keep=T)
        inv_run = torch.where(h.mop_mask, _g(first_mop, mop_txn_c) + rank,
                              mop_pos)
        run_sort = _scatter(M, 0, inv_run, mop_pos, "set")
    else:
        run_sort = _lexsort(txn_eff, key_eff).to(I32)
        inv_run = _scatter(M, 0, run_sort, mop_pos, "set")
    t2 = _g(txn_eff, run_sort)
    k2 = _g(key_eff, run_sort)
    app2 = _g(is_append, run_sort)
    known2 = _g(known_read, run_sort)
    len2 = _g(h.mop_rd_len, run_sort)
    val2 = _g(h.mop_val, run_sort)
    run_start = _cat_flag(True, (t2[1:] != t2[:-1]) | (k2[1:] != k2[:-1]))
    run_end = torch.cat([run_start[1:], run_start[:1]])  # run_start[0]: True
    q = arange(M)

    # final vs intermediate appends: an append is final iff its run's
    # exclusive suffix holds no append (reverse segmented cummax)
    suf_app_q = segmented_cummax(
        torch.where(app2, q, -1).flip(0), run_end.flip(0),
        exclusive=True, neutral=-1).flip(0)
    run_final = app2 & (suf_app_q < 0)
    if h.app_val_mono:
        is_final = _scatter(V + 1, 0, w_idx,
                            is_append & _g(run_final, inv_run), "amax",
                            torch.int8, keep=V) != 0
    else:
        is_final = _scatter(V + 1, 0, torch.where(app2, val2, V), run_final,
                            "amax", torch.int8, keep=V) != 0

    # ---- version orders (longest known read per key) ---------------------
    if h.key_ord_len is not None and h.key_ord_len.shape[0] >= nk:
        ord_len = h.key_ord_len[:nk]
        ord_read = h.key_ord_read[:nk]
    else:
        key_slot = torch.where(known_read, h.mop_key, nk)
        ord_len = _scatter(nk + 1, 0, key_slot,
                           torch.where(known_read, h.mop_rd_len, 0),
                           "amax", keep=nk)
        # ties take the earliest read
        is_longest = known_read & (
            h.mop_rd_len == _g(ord_len, h.mop_key.clamp(0, nk - 1)))
        ord_read_raw = _scatter(
            nk + 1, M, torch.where(is_longest, h.mop_key, nk),
            torch.where(is_longest, mop_pos, M), "amin", keep=nk)
        ord_read = torch.where(ord_read_raw < M, ord_read_raw, -1)
    ord_start = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                           torch.cumsum(ord_len, 0, dtype=I32)[:-1]])
    total_ord = torch.sum(ord_len, dtype=I32)

    # materialize ord_elems: slot j belongs to key k(j) at offset o(j)
    slot = arange(O)
    slot_valid = slot < total_ord
    if nk == 1:
        slot_key = torch.zeros(O, dtype=I32, device=dev)
        slot_off = slot
        src_read0 = ord_read[0]
        src_start = torch.where(
            src_read0 >= 0, _g(h.mop_rd_start, src_read0.clamp(0, M - 1)), 0)
    else:
        # per-key values seeded at the segment starts and forward-filled.
        # slot_key's seed is scatter-MAX over possibly shared starts
        # (zero-length keys) and non-decreasing; the value channels seed
        # only keys with elements (unique starts) — every valid slot's key
        # has elements, invalid slots are masked by slot_valid
        key_ids = arange(nk)
        sk_seed = _scatter(O + 1, -1, ord_start.clamp(0, O), key_ids,
                           "amax", keep=O)
        slot_key = locf(sk_seed).clamp(0, nk - 1)
        nonempty = ord_len > 0
        pos_ne = torch.where(nonempty, ord_start, O).clamp(0, O)
        osv_seed = _scatter(O + 1, -1, pos_ne,
                            torch.where(nonempty, ord_start, -1), "amax",
                            keep=O)
        # per-key rd_start of the chosen longest read (ord_len > 0 implies
        # ord_read >= 0)
        srcst_k = _g(h.mop_rd_start, ord_read.clamp(0, M - 1))
        srcst_seed = _scatter(O + 1, -1, pos_ne,
                              torch.where(nonempty, srcst_k, -1),
                              "amax", keep=O)
        ord_start_f = locf(osv_seed)
        src_start = locf(srcst_seed)
        slot_off = slot - torch.where(ord_start_f >= 0, ord_start_f, 0)
        src_start = torch.where(src_start >= 0, src_start, 0)
    ord_elems = torch.where(
        slot_valid, _g(h.rd_elems, (src_start + slot_off).clamp(0, R - 1)),
        -1)
    cv = ord_elems.clamp(0, V - 1)

    # ---- read-element table ----------------------------------------------
    # elem -> owning read mop: read ids seeded at their start slots, then
    # forward-filled (extents are contiguous and allocated in mop order)
    has_elems = known_read & (h.mop_rd_len > 0)
    rd_slot = torch.where(has_elems, h.mop_rd_start, R)
    if h.rd_start_mono:
        # rd_start strictly increasing over reads with elements, and >= 0
        # (host-verified): the JAX package's cummax
        # (jepsen_tpu/checkers/elle/device_infer.py:588) of these seeds is
        # their last non-hole value, which is what LOCF gives
        seeds = torch.where(has_elems, h.mop_rd_start, -1)
        assert seeds.dtype == I32, seeds.dtype
        seed_idx = locf(seeds).clamp(0, R)
    else:
        seed_idx = rd_slot
    seed = _scatter(R + 1, -1, seed_idx,
                    torch.where(has_elems, mop_pos, -1), "amax", keep=R)

    def _aseed(vals):
        # value channel seeded at the same (unique) read-start slots
        return _scatter(R + 1, -1, rd_slot,
                        torch.where(has_elems, vals.to(I32), -1),
                        "amax", keep=R)

    # the owning-read id and four per-read values, each one fill; the
    # leading elem_read == -1 prefix takes mop 0's values, as a gather of
    # the read table at the clipped id would
    elem_read = locf(seed)
    hole = elem_read < 0

    def _rfill(vals_m):
        return torch.where(hole, vals_m[0].to(I32), locf(_aseed(vals_m)))

    erd_start = _rfill(h.mop_rd_start)
    erd_len = _rfill(h.mop_rd_len)
    elem_key = _rfill(h.mop_key)
    elem_txn = _rfill(h.mop_txn)
    elem_off = arange(R) - erd_start
    elem_in_read = h.rd_elem_mask & (elem_read >= 0) & (elem_off >= 0) & \
        (elem_off < erd_len)
    ev = h.rd_elems.clamp(0, V - 1)

    # incompatible-order: element disagrees with its key's version order
    expect = _g(ord_elems, (_g(ord_start, elem_key.clamp(0, nk - 1))
                            + elem_off).clamp(0, O - 1))
    incompat = elem_in_read & (h.rd_elems != expect)
    incompatible_order = _count(incompat)
    incompat_witness = _first_true(incompat)

    # G1a: reading a failed txn's append
    g1a = elem_in_read & (_g(writer_type, ev) == TXN_FAIL)
    g1a_count = _count(g1a)
    g1a_witness = _first_true(g1a)

    # duplicate elements inside one read: one scatter-add over the order
    # table suffices while every read agrees with its key's order; an
    # already-invalid history (incompatible_order > 0) takes the exact
    # per-read sort.  Presence (0/1) is the contract.
    ord_cnt = _scatter(V + 1, 0, torch.where(slot_valid, cv, V),
                       torch.ones(O, dtype=I32, device=dev), "sum", keep=V)
    if int(incompatible_order) > 0:
        # adjacent equal (read, value) pairs after one stable sort by
        # value — exact because elem_read is monotone over slots
        d_val, order = torch.sort(torch.where(elem_in_read, ev, V),
                                  stable=True)
        d_read = _g(torch.where(elem_in_read, elem_read, M), order)
        dups = (d_read[1:] == d_read[:-1]) & (d_val[1:] == d_val[:-1]) & \
            (d_read[1:] < M)
        n_dup = _count(dups)
    else:
        n_dup = torch.sum(torch.clamp(ord_cnt - 1, min=0), dtype=I32)
    duplicate_elements = torch.clamp(n_dup, max=1)

    # G1b: last element of a read is an intermediate append of another txn
    is_last_elem = elem_in_read & (elem_off == erd_len - 1)
    w_ev = _g(writer, ev)
    g1b = is_last_elem & (w_ev >= 0) & ~_g(is_final, ev) & (w_ev != elem_txn)
    g1b_count = _count(g1b)
    g1b_witness = _first_true(g1b)

    # dirty-update: aborted write immediately followed by a committed one
    nxt = (slot + 1).clamp(0, O - 1)
    nxt_slot_same_key = slot_valid & (slot + 1 < total_ord) & \
        (slot_key == _g(slot_key, nxt))
    nv = _g(ord_elems, nxt).clamp(0, V - 1)
    dirty = nxt_slot_same_key & (_g(writer_type, cv) == TXN_FAIL) & \
        (_g(writer_type, nv) == TXN_OK)
    dirty_update = _count(dirty)

    # ---- internal consistency --------------------------------------------
    # mops sorted by (txn, key, pos) form per-(txn,key) runs.  A read of
    # length L with previous read of length P must satisfy L == P +
    # appends-since, and its elements in the appended window must equal
    # those appends in order.
    app2_i = app2.to(I32)
    cum_app_excl = segmented_cumsum(app2_i, run_start, exclusive=True)
    prev_q = segmented_cummax(torch.where(known2, q, -1), run_start,
                              exclusive=True, neutral=-1)
    have_prev = prev_q >= 0
    prev_c = prev_q.clamp(0, M - 1)
    prev_app_base = torch.where(have_prev, _g(cum_app_excl + app2_i, prev_c),
                                0)
    n_app_before = cum_app_excl - prev_app_base
    prev_len = torch.where(have_prev, _g(len2, prev_c), 0)

    bad_len = known2 & have_prev & (len2 != prev_len + n_app_before)
    bad_suffix = known2 & ~have_prev & (len2 < n_app_before)
    internal_len_bad = _count(bad_len | bad_suffix)

    # element-side content check: the four per-read constants composed
    # per mop, seeded at the read starts and filled
    erc = inv_run.clamp(0, M - 1)
    er_run = _rfill(inv_run)
    er_n = _rfill(_g(n_app_before, erc))
    er_have = _rfill(_g(have_prev, erc).to(I32)) != 0
    er_prev_len = _rfill(_g(prev_len, erc))
    base = torch.where(er_have, er_prev_len, erd_len - er_n)
    j = elem_off - base
    in_window = elem_in_read & (j >= 0) & (j < er_n)
    exp_val = _g(val2, (er_run - er_n + j).clamp(0, M - 1))
    internal_content = in_window & (h.rd_elems != exp_val)
    internal = internal_len_bad + _count(internal_content)

    # ---- dependency edges -------------------------------------------------
    def graph_at(t):
        return _g(graph_txn, t.clamp(0, T - 1))

    ww_src = torch.where(slot_valid, _g(writer, cv), -1)
    ww_dst = torch.where(nxt_slot_same_key, _g(writer, nv), -1)
    ww_ok = nxt_slot_same_key & (ww_src >= 0) & (ww_dst >= 0) & \
        (ww_src != ww_dst) & graph_at(ww_src) & graph_at(ww_dst)

    last_val = torch.where(
        has_elems,
        _g(h.rd_elems, (h.mop_rd_start + h.mop_rd_len - 1).clamp(0, R - 1)),
        -1)
    wr_src = torch.where(last_val >= 0,
                         _g(writer, last_val.clamp(0, V - 1)), -1)
    wr_dst = h.mop_txn
    wr_ok = has_elems & (wr_src >= 0) & (wr_src != wr_dst) & graph_at(wr_src)

    key_c = h.mop_key.clamp(0, nk - 1)
    has_next = known_read & (h.mop_rd_len < _g(ord_len, key_c))
    nxt_val = torch.where(
        has_next,
        _g(ord_elems,
           (_g(ord_start, key_c) + h.mop_rd_len).clamp(0, O - 1)), -1)
    rw_dst = torch.where(nxt_val >= 0,
                         _g(writer, nxt_val.clamp(0, V - 1)), -1)
    rw_src = h.mop_txn
    rw_ok = has_next & (rw_dst >= 0) & (rw_dst != rw_src) & graph_at(rw_dst)

    # ---- node ranks -------------------------------------------------------
    # txn = 2*complete_pos (even), barrier = 2*complete_pos + 1 (odd);
    # padding gets unique high ranks with no edges attached
    tidx = arange(T)
    rank_txn = torch.where(h.txn_mask, 2 * h.txn_complete_pos, BIG + tidx)

    # ---- chains -----------------------------------------------------------
    # process chains: ok/info txns by (process, invoke_pos)
    pslot = torch.where(h.txn_mask & graph_txn, h.txn_process, BIG)
    if h.proc_order is not None:
        porder = h.proc_order
    elif h.proc_seq:
        # within each process invoke order == row order (host-verified),
        # so a stable 1-key sort by process gives the chain order
        porder = torch.argsort(pslot, stable=True)
    else:
        porder = _lexsort(pslot, h.txn_invoke_pos)
    p_sorted = _g(pslot, porder)
    p_nodes = porder.to(I32)
    p_mask = p_sorted < BIG
    p_starts = _cat_flag(True, p_sorted[1:] != p_sorted[:-1])

    # realtime barriers: one per ok txn, ordered by completion
    bslot = torch.where(h.txn_mask & ok, h.txn_complete_pos, BIG)
    if h.barrier_order is not None:
        border = h.barrier_order
    elif h.complete_monotone:
        # complete_pos strictly increasing over valid txns: argsort(bslot)
        # is a stable partition (ok txns first, in index order)
        okm = bslot < BIG
        n_ok_incl = torch.cumsum(okm.to(I32), 0, dtype=I32)
        dest_b = torch.where(
            okm, n_ok_incl - 1,
            n_ok_incl[-1] + torch.cumsum((~okm).to(I32), 0, dtype=I32) - 1)
        border = _scatter(T, 0, dest_b, tidx, "set")
    else:
        border = torch.argsort(bslot, stable=True)
    b_txn = border.to(I32)
    b_sorted = _g(bslot, border)
    b_mask = b_sorted < BIG
    barrier_node = T + tidx
    rank_barrier = torch.where(b_mask, 2 * b_sorted + 1, BIG + T + tidx)
    b_starts = torch.zeros(T, dtype=torch.bool, device=dev)
    b_starts[0] = True
    if h.barrier_bi is not None:
        bi = h.barrier_bi
    else:
        comp_sorted = torch.where(b_mask, b_sorted, BIG)
        bi = (torch.searchsorted(comp_sorted, h.txn_invoke_pos, side="left")
              - 1).to(I32)
    bt_ok = h.txn_mask & graph_txn & (bi >= 0)
    bt_src = T + bi.clamp(0, T - 1)
    bt_dst = tidx

    return {
        "counts": {
            "duplicate-appends": duplicate_appends,
            "duplicate-elements": duplicate_elements,
            "incompatible-order": incompatible_order,
            "G1a": g1a_count,
            "G1b": g1b_count,
            "dirty-update": dirty_update,
            "internal": internal,
        },
        "witness": {
            "incompatible-order": incompat_witness,
            "G1a": g1a_witness,
            "G1b": g1b_witness,
        },
        "edges": {
            "ww": (ww_src, ww_dst, ww_ok),
            "wr": (wr_src, wr_dst, wr_ok),
            "rw": (rw_src, rw_dst, rw_ok),
            "tb": (b_txn, barrier_node, b_mask),
            "bt": (bt_src, bt_dst, bt_ok),
        },
        "chains": {
            "process": (p_nodes, p_starts, p_mask),
            "barrier": (barrier_node, b_starts, b_mask),
        },
        "ranks": {
            "txn": rank_txn,
            "barrier": rank_barrier,
        },
        "order": {
            "elems": ord_elems, "start": ord_start, "len": ord_len,
            "writer": writer,
        },
    }
