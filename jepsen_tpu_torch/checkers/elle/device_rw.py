"""Device-side rw-register inference + core check (PyTorch).

Counterpart of `jepsen_tpu/checkers/elle/device_rw.py`, bit for bit on
every returned array: version-graph inference, non-cycle anomaly scans,
txn dependency edges and the 5-projection cycle sweep over the padded SoA
arrays — the rw-register analogue of `device_core.core_check`.  The
inference is an exact port of the host checker's vectorized numpy
(`rw_register.py`, which stays the semantic oracle):

- writers: committed-priority scatter-min (ok > info > fail) so an
  aborted duplicate cannot fabricate a G1a;
- per-(txn, key) runs via one lexsort; txn-local state (cur-before),
  final writes and last-write positions from segmented scans;
- version edges u -> v (or init(k) -> v for blind writes); cyclic
  versions detected by a rank sweep over the version graph (value-id
  ranks: inference contradictions are the backward edges);
- txn edges: wr (reader of v <- writer(v)), ww (writer(u) -> writer(v)),
  rw (external readers of u -> writer(v)) — the reader x version-edge
  join is shape-static: prefix-sum offsets + searchsorted expansion into
  a fixed `rw_cap` slot budget with exact overflow reporting (the device
  never silently truncates; `check` grows the budget).

The cycle sweeps' chain passes run the seg-OR kernel on a CUDA tensor
(`ops/scan.py`); the version sweep has no chains, so on a history without
cyclic versions it launches nothing.

Bit layout of the result: [duplicate-writes, internal, G1a, G1b,
lost-update, cyclic-versions, cycle-proj0..4, converged].

Parity hazards (JAX semantics torch does not share), each kept explicitly
and pinned by `tests/test_torch_rw_register.py`:

- The `.at[].min` (writers), `.at[].add` (write counts) and `.at[].max`
  on bool (final writes) scatters go through `device_infer._scatter`
  (int64 indices, a negative index wraps once, one out of range drops;
  the slot V takes the dropped entries and is cut off).  `scatter_reduce_`
  takes no `bool` on CUDA, so the final-write flags scatter as uint8.
- `jnp.lexsort` (last key primary) becomes chained stable `argsort`s
  (`device_infer._lexsort`), and both `jnp.argsort` calls (stable by
  default in JAX) are `stable=True`.
- `jnp.searchsorted` becomes `torch.searchsorted` on contiguous int32
  inputs of one dtype, `right=` for `side=`; `offsets` stays an int32
  cumsum so that `e_j` matches.
- The reversed segmented cummax is `torch.flip` around
  `segments.segmented_cummax`, the exclusive one takes `neutral=-1`.
- Every gather that JAX would clamp goes through an explicit `clamp`
  (`writer[ev]`, `rt_sorted[...]`, `offsets[...]`, `lo[...]`): torch
  raises where JAX clamps.
- The version sweep has `V + n_keys` nodes (not a power of two) and no
  chains; `_sweep_arrays` and the seg-OR wrapper take both.

`check` is the grow loop of the JAX `check` under `resilience.device_call`
with a deadline poll before each try.  There is no compile cache: it
calls `rw_core_check` directly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from jepsen_tpu_torch import backend, resilience
from jepsen_tpu_torch.checkers.elle.device_core import (
    EDGE_FAMILIES,
    MAX_K_CAP,
    MAX_ROUNDS_CAP,
    PROJECTIONS,
    chain_include_stack,
    proj_include_stack,
)
from jepsen_tpu_torch.checkers.elle.device_infer import (
    BIG,
    I32,
    PaddedLA,
    _cat_flag,
    _count,
    _lexsort,
    _scatter,
    pad_packed,
    to_device,
)
from jepsen_tpu_torch.history.ir import HistoryIR
from jepsen_tpu_torch.history.soa import (
    MOP_APPEND,
    MOP_READ,
    TXN_FAIL,
    TXN_INFO,
    TXN_OK,
)
from jepsen_tpu_torch.ops.cycle_sweep import _sweep_arrays, projection_scan
from jepsen_tpu_torch.ops.segments import segmented_cummax, segmented_cumsum

NO_PREV = -3

COUNT_NAMES_RW = ("duplicate-writes", "internal", "G1a", "G1b",
                  "lost-update", "cyclic-versions")

RW_CAP_LIMIT = 1 << 24


def infer_rw(h: PaddedLA, n_keys: int, rw_cap: int = 0) -> Dict[str, dict]:
    """Inference over a padded rw-register history.  Returns a dict of
    counts, edges, chains, ranks (same shape contract as
    `device_infer.infer`) plus version-graph arrays and the rw-join
    overflow (edges beyond rw_cap that could NOT be emitted); arrays stay
    on `h`'s device."""
    dev = h.txn_type.device
    T = h.txn_type.shape[0]
    M = h.mop_txn.shape[0]
    V = h.rd_elems.shape[0]  # value-id capacity (same convention as la)
    nk = max(n_keys, 1)
    VN = V + nk              # version nodes: values + one init per key
    CAP = rw_cap or M

    def arange(n):
        return torch.arange(n, dtype=I32, device=dev)

    def clip(x, hi):
        return x.clamp(0, hi).long()

    ttype = h.txn_type
    ok = ttype == TXN_OK
    graph_txn = ok | (ttype == TXN_INFO)

    kind = torch.where(h.mop_mask, h.mop_kind, -1)
    mtxn = h.mop_txn.clamp(0, T - 1)
    is_w = h.mop_mask & (kind == MOP_APPEND) & (h.mop_val >= 0)
    is_r = h.mop_mask & (kind == MOP_READ)
    known = torch.where(is_r, h.mop_rd_len >= 0, h.mop_mask)
    mop_pos = arange(M)

    # ---- writers: committed-priority (ok=0 < info=1 < fail=2, then pos)
    wt = ttype[mtxn.long()]
    prio = torch.where(ok[mtxn.long()], 0,
                       torch.where(wt == TXN_INFO, 1, 2)).to(I32)
    enc = prio * M + mop_pos
    none = 3 * M + M
    val_slot = torch.where(is_w, h.mop_val, V)
    enc_min = _scatter(V + 1, none, val_slot,
                       torch.where(is_w, enc, none), "amin", keep=V)
    have_writer = enc_min < none
    writer = torch.where(have_writer, mtxn[clip(enc_min % M, M - 1)], -1)
    writer_type = torch.where(writer >= 0, ttype[clip(writer, T - 1)], 0)
    w_count = _scatter(V + 1, 0, val_slot, is_w, "sum", keep=V)
    duplicate_writes = _count(w_count > 1)

    # ---- (txn, key) runs --------------------------------------------------
    # jnp.lexsort((mop_pos, key, txn)): txn primary, then key, then
    # position — the stable sorts keep position order among ties
    masked_key = torch.where(h.mop_mask, h.mop_key, nk)
    run_sort = _lexsort(torch.where(h.mop_mask, h.mop_txn, T), masked_key)
    rt = mtxn[run_sort]
    rk = masked_key[run_sort]
    rkind = kind[run_sort]
    rval = h.mop_val[run_sort]
    rknown = known[run_sort]
    rmask = h.mop_mask[run_sort]
    t2 = torch.where(rmask, rt, T)
    run_start = _cat_flag(True, (t2[1:] != t2[:-1]) | (rk[1:] != rk[:-1]))
    run_end = torch.cat([run_start[1:],
                         torch.ones(1, dtype=torch.bool, device=dev)])
    q = arange(M)

    # last write position within the run (suffix max = reversed cummax)
    wpos = torch.where(rmask & (rkind == MOP_APPEND), q, -1)
    last_w = torch.flip(segmented_cummax(torch.flip(wpos, (0,)),
                                         torch.flip(run_end, (0,))), (0,))

    # final write per value: the run's last write mop (a bool scatter-max,
    # as uint8: scatter_reduce_ takes no bool on CUDA)
    r_final = rmask & (rkind == MOP_APPEND) & (q == last_w)
    is_final = _scatter(V + 1, 0, torch.where(r_final, rval, V), r_final,
                        "amax", dtype=torch.uint8, keep=V) > 0

    # txn-local state before each mop (cur-before): previous defining mop
    defines = rmask & ((rkind == MOP_APPEND) |
                       ((rkind == MOP_READ) & rknown))
    def_val = torch.where(rkind == MOP_APPEND, rval,
                          torch.where(rval >= 0, rval, V + rk)).to(I32)
    def_pos = torch.where(defines, q, -1)
    prev_def = segmented_cummax(def_pos, run_start, exclusive=True,
                                neutral=-1)
    cur_before = torch.where(prev_def >= 0, def_val[clip(prev_def, M - 1)],
                             NO_PREV)

    r_is_read = rmask & (rkind == MOP_READ) & rknown & ok[rt.long()]
    external_read = r_is_read & (cur_before == NO_PREV)

    # ---- internal ---------------------------------------------------------
    internal_bad = r_is_read & (cur_before != NO_PREV) & \
        (def_val != cur_before)
    internal = _count(internal_bad)

    # ---- G1a / G1b on external reads of real values -----------------------
    ev = clip(def_val, V - 1)
    ext_real = external_read & (def_val < V)
    writer_ev = writer[ev]
    has_w = ext_real & (writer_ev >= 0)
    g1a = has_w & (writer_type[ev] == TXN_FAIL)
    g1a_count = _count(g1a)
    g1b = has_w & ~is_final[ev] & (writer_ev != rt)
    g1b_count = _count(g1b)

    # ---- version edges ----------------------------------------------------
    ve_ok = rmask & (rkind == MOP_APPEND) & (rval >= 0) & graph_txn[rt.long()]
    ve_u = torch.where(cur_before >= 0, cur_before, V + rk).to(I32)
    ve_v = rval.clamp(0, V - 1).to(I32)
    # version-node ranks: init(k) -> k (first), value v -> nk + v; edges
    # against value-id order are the backward edges of the version sweep
    rank_v = torch.cat([nk + arange(V), arange(nk)])  # node V+k = init(k)

    # ---- lost update ------------------------------------------------------
    # external reads of u whose txn later writes the key; >= 2 distinct
    # txns per u is a lost update
    upd = external_read & (last_w > q)
    u_key = torch.where(upd, def_val, VN + 1)
    u_txn = torch.where(upd, rt, T)
    lo_ord = _lexsort(u_key, u_txn)
    su = u_key[lo_ord]
    st = u_txn[lo_ord]
    s_valid = su < VN + 1
    uniq_pair = s_valid & _cat_flag(
        True, (su[1:] != su[:-1]) | (st[1:] != st[:-1]))
    grp_start = _cat_flag(True, su[1:] != su[:-1])
    grp_end = torch.cat([grp_start[1:],
                         torch.ones(1, dtype=torch.bool, device=dev)])
    grp_cnt = segmented_cumsum(uniq_pair.to(I32), grp_start)
    lost_update = _count(grp_end & s_valid & (grp_cnt >= 2))

    # ---- txn dependency edges --------------------------------------------
    def edge_mask(src, dst, base):
        return base & (src >= 0) & (dst >= 0) & (src != dst) & \
            graph_txn[clip(src, T - 1)] & graph_txn[clip(dst, T - 1)]

    # wr: writer(v) -> external reader of v
    wr_src = torch.where(ext_real, writer_ev, -1)
    wr_dst = rt
    wr_ok = edge_mask(wr_src, wr_dst, ext_real)

    # ww: writer(u) -> writer(v) over version edges with real u
    ww_u_real = ve_ok & (ve_u < V)
    ww_src = torch.where(ww_u_real, writer[clip(ve_u, V - 1)], -1)
    writer_v = writer[ve_v.long()]
    ww_dst = torch.where(ve_ok, writer_v, -1)
    ww_ok = edge_mask(ww_src, ww_dst, ww_u_real)

    # rw: external readers of u -> writer(v) per version edge (u, v);
    # shape-static join: sort readers by value, prefix-sum slot offsets,
    # expand into CAP slots via searchsorted
    rdv = torch.where(external_read, def_val, VN + 2).contiguous()
    r_ord = torch.argsort(rdv, stable=True)
    rv_sorted = rdv[r_ord].contiguous()
    rt_sorted = rt[r_ord]
    e_wdst = torch.where(ve_ok, writer_v, -1)
    e_usable = ve_ok & (e_wdst >= 0) & graph_txn[clip(e_wdst, T - 1)]
    e_u = torch.where(e_usable, ve_u, VN + 3).contiguous()
    lo = torch.searchsorted(rv_sorted, e_u, out_int32=True)
    hi = torch.searchsorted(rv_sorted, e_u, right=True, out_int32=True)
    cnt = torch.where(e_usable, hi - lo, 0).to(I32)
    offsets = torch.cumsum(cnt, 0, dtype=I32)
    total = offsets[-1]
    j = arange(CAP)
    e_j = torch.searchsorted(offsets, j, right=True, out_int32=True)
    e_jc = clip(e_j, M - 1)
    prev_off = torch.where(e_j > 0, offsets[clip(e_j - 1, M - 1)], 0)
    off = j - prev_off
    valid_j = (j < total) & (e_j < M)
    reader_j = rt_sorted[clip(lo[e_jc] + off, M - 1)]
    rw_src = torch.where(valid_j, reader_j, -1)
    rw_dst = torch.where(valid_j, e_wdst[e_jc], -1)
    rw_ok = edge_mask(rw_src, rw_dst, valid_j)
    rw_overflow = torch.clamp(total - CAP, min=0)

    # ---- process chains + realtime barriers (same as la infer) ------------
    tidx = arange(T)
    rank_txn = torch.where(h.txn_mask, 2 * h.txn_complete_pos, BIG + tidx)
    pslot = torch.where(h.txn_mask & graph_txn, h.txn_process, BIG)
    porder = _lexsort(pslot, h.txn_invoke_pos)
    p_nodes = porder.to(I32)
    p_sorted = pslot[porder]
    p_mask = p_sorted < BIG
    p_starts = _cat_flag(True, p_sorted[1:] != p_sorted[:-1])
    bslot = torch.where(h.txn_mask & ok, h.txn_complete_pos, BIG)
    border = torch.argsort(bslot, stable=True)
    b_txn = border.to(I32)
    b_sorted = bslot[border]
    b_mask = b_sorted < BIG
    barrier_node = T + tidx
    rank_barrier = torch.where(b_mask, 2 * b_sorted + 1, BIG + T + tidx)
    b_starts = _cat_flag(True, torch.zeros(T - 1, dtype=torch.bool,
                                           device=dev))
    comp_sorted = torch.where(b_mask, b_sorted, BIG).contiguous()
    bi = torch.searchsorted(comp_sorted, h.txn_invoke_pos.contiguous(),
                            out_int32=True) - 1
    bt_ok = h.txn_mask & graph_txn & (bi >= 0)
    bt_src = (T + bi.clamp(0, T - 1)).to(I32)

    return {
        "counts": {
            "duplicate-writes": duplicate_writes,
            "internal": internal,
            "G1a": g1a_count,
            "G1b": g1b_count,
            "lost-update": lost_update,
        },
        "edges": {
            "ww": (ww_src, ww_dst, ww_ok),
            "wr": (wr_src, wr_dst, wr_ok),
            "rw": (rw_src, rw_dst, rw_ok),
            "tb": (b_txn, barrier_node, b_mask),
            "bt": (bt_src, tidx, bt_ok),
        },
        "chains": {
            "process": (p_nodes, p_starts, p_mask),
            "barrier": (barrier_node, b_starts, b_mask),
        },
        "ranks": {
            "txn": rank_txn.to(I32),
            "barrier": rank_barrier.to(I32),
        },
        "versions": {
            "src": torch.where(ve_ok, ve_u, 0),
            "dst": torch.where(ve_ok, ve_v, 0),
            "mask": ve_ok,
            "rank": rank_v,
        },
        "rw_overflow": rw_overflow,
    }


def rw_core_check(h: PaddedLA, n_keys: int, max_k: int = 128,
                  max_rounds: int = 64, rw_cap: int = 0,
                  device: backend.DeviceLike = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device verdict for an rw-register history on `device` (the CUDA
    card unless the caller names the CPU).

    Returns (bits, overflowed, rw_overflow):
    bits: (12,) int32 — [6 counts per COUNT_NAMES_RW, 5 projection cycle
    flags, converged]; overflowed: backward edges beyond max_k across all
    sweeps (grow and retry); rw_overflow: rw-join edges beyond rw_cap
    (grow rw_cap)."""
    h = to_device(h, backend.resolve(device))
    out = infer_rw(h, n_keys, rw_cap=rw_cap)
    T = h.txn_type.shape[0]
    dev = h.txn_type.device
    edges = out["edges"]
    pc_nodes, pc_starts, pc_mask = out["chains"]["process"]
    bc_nodes, bc_starts, bc_mask = out["chains"]["barrier"]

    # one sweep per projection via the shared hoisted form (family-include
    # flags + one shared backward enumeration; see
    # cycle_sweep.projection_scan)
    conv_all, overflow, cyc_bits = projection_scan(
        2 * T, max_k, max_rounds,
        torch.cat([out["ranks"]["txn"], out["ranks"]["barrier"]]),
        torch.cat([edges[k][0] for k in EDGE_FAMILIES]),
        torch.cat([edges[k][1] for k in EDGE_FAMILIES]),
        [edges[k][2] for k in EDGE_FAMILIES],
        proj_include_stack(PROJECTIONS).tolist(),
        torch.cat([pc_nodes, bc_nodes]), torch.cat([pc_starts, bc_starts]),
        [pc_mask, bc_mask], chain_include_stack(PROJECTIONS).tolist())

    # cyclic versions: rank sweep over the version graph (no chains)
    ver = out["versions"]
    vempty_i = torch.zeros(0, dtype=I32, device=dev)
    vempty_b = torch.zeros(0, dtype=torch.bool, device=dev)
    v_has, _, v_back, v_conv = _sweep_arrays(
        h.rd_elems.shape[0] + max(n_keys, 1), max_k, max_rounds,
        ver["rank"], ver["src"], ver["dst"], ver["mask"], vempty_i,
        vempty_b, vempty_b)
    conv_all = conv_all and v_conv
    overflow = max(overflow, v_back - max_k, 0)

    counts = torch.stack([out["counts"][n].to(I32)
                          for n in COUNT_NAMES_RW[:-1]])
    tail = torch.tensor([int(v_has)] + cyc_bits + [int(conv_all)],
                        dtype=I32, device=dev)
    return (torch.cat([counts, tail]),
            torch.tensor(overflow, dtype=I32, device=dev),
            out["rw_overflow"].to(I32))


def check(p, n_keys: int = None, max_k: int = 128, max_rounds: int = 64,
          deadline=None, policy=None, plan=None,
          device: backend.DeviceLike = None) -> dict:
    """Device check of an rw-register history on `device` (the CUDA card
    unless the caller names the CPU); summary dict in the JAX package's
    row format.  `p` is a PackedTxns, a `PaddedLA` or a `HistoryIR`, whose
    padded rw-register section is built once per device.  Grows the
    rw-join and backward-edge budgets on overflow (exactness first);
    returns "unknown" only when every budget is exhausted.

    The check runs under the device guard (transient retries per
    `policy`, synthetic faults per `plan`); `deadline` is polled before
    each try and raises `DeadlineExceeded` on expiry —
    `rw_register.check` maps that to an unknown verdict."""
    dev = backend.resolve(device)
    if isinstance(p, HistoryIR):
        h = p.padded("rw-register", dev)
    elif isinstance(p, PaddedLA):
        h = to_device(p, dev)
    else:
        h = pad_packed(p, device=dev)
    n_keys = h.n_keys if n_keys is None else n_keys
    rw_cap = h.mop_txn.shape[0]

    while True:
        if deadline is not None:
            deadline.check("elle.rw-core-check")
        bits, over, rw_over = resilience.device_call(
            "elle.rw-core-check",
            lambda: rw_core_check(h, n_keys, max_k, max_rounds, rw_cap,
                                  device=dev),
            policy=policy, deadline=deadline, plan=plan)
        row = bits.cpu().numpy()
        over_i = int(over)
        rw_over_i = int(rw_over)
        conv = int(row[-1]) == 1
        if rw_over_i > 0 and rw_cap < RW_CAP_LIMIT:
            need = min(rw_cap + rw_over_i, RW_CAP_LIMIT)
            while rw_cap < need:
                rw_cap *= 2
            rw_cap = min(rw_cap, RW_CAP_LIMIT)
            continue
        if over_i > 0 and max_k < MAX_K_CAP:
            need = max_k + over_i
            while max_k < need:
                max_k *= 2
            max_k = min(max_k, MAX_K_CAP)
            continue
        if not conv and over_i == 0 and max_rounds < MAX_ROUNDS_CAP:
            max_rounds = min(max_rounds * 2, MAX_ROUNDS_CAP)
            continue
        break

    nc = len(COUNT_NAMES_RW)
    counts = {n: int(row[i]) for i, n in enumerate(COUNT_NAMES_RW)}
    cycles = [bool(x) for x in row[nc:-1]]
    exact = bool(row[-1]) and over_i == 0 and rw_over_i == 0
    invalid = any(v > 0 for v in counts.values()) or any(cycles)
    return {
        "valid?": (not invalid) if exact else "unknown",
        "counts": counts,
        "cycles": {
            "G0": cycles[0], "G1c": cycles[1], "G2-family": cycles[2],
            "G2-family-process": cycles[3],
            "G2-family-realtime": cycles[4],
        },
        "exact": exact,
    }
