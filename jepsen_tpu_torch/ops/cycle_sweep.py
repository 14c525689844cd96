"""Device cycle detection over dependency graphs (PyTorch).

Counterpart of `jepsen_tpu/ops/cycle_sweep.py` (its K windows, one a
shard of a mesh axis, in `_sweep_window(devices=)`):

1. Rank decomposition: edges split into forward (rank increases) and
   backward; forward edges alone form a DAG, so every cycle holds a
   backward edge, and a graph with none is acyclic.
2. Forward reachability from backward-edge heads as (N, K) 0/1 int8
   label planes: chains (process order, the realtime barrier chain) are
   resolved by segmented prefix-OR scans (the seg-OR kernel on a CUDA
   tensor), other forward edges by scatter-max relaxation, to a fixpoint.
3. Meta-closure: a cycle exists iff the K-node meta-graph (e -> e' iff
   dst(e) ->* src(e')) has one; closure by repeated squaring
   (`_closure_diagonal`).

Control flow runs on the host: the fixpoint is a Python loop with one
scalar read per round, the skips for zero backward edges are Python
branches, and the scan over projections is a Python loop.  A result with
`converged=False` must not be trusted (`list_append.check` raises on it;
the JAX package falls back to its host oracle).

One change from the JAX module: the fixpoint is read on rank windows
(`_rank_window`), so its rounds are bounded by the backward edges' rank
drops, not by how far the history runs past them.  Its witnesses are
the JAX module's wherever that one converges, and it converges in at
most as many rounds; a history that is long after an early backward
edge, which the JAX module cannot sweep within `MAX_ROUNDS_CAP`,
converges here.  And past `MAX_K_CAP` backward edges, where the JAX
module reports itself inexact, `detect_cycles` sweeps the components of
their rank intervals in groups (`_by_components`).  Each group has its
label columns swept at most `MAX_K_CAP` at a time and is closed as one
meta matrix (`_close_group`), so a component of more than `MAX_K_CAP`
edges is exact too, up to `MAX_COMPONENT_BATCHES` column batches; only
past that is the result inexact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import backend
from jepsen_tpu_torch.ops.segments import (
    gather_rows,
    scatter_or,
    segmented_prefix_or,
)

I8 = torch.int8
I32 = torch.int32

#: budget ceilings shared by every sweep driver (detect_cycles here,
#: grow_until_exact in device_core): past these, callers fall back to
#: the host oracle rather than approximate
MAX_K_CAP = 8192
MAX_ROUNDS_CAP = 1024
#: a component of more than MAX_K_CAP backward edges is swept in column
#: batches of MAX_K_CAP and closed as one (m, m) meta matrix
#: (`_close_group`); past this many batches `detect_cycles` reports
#: itself inexact.  The closure holds two bfloat16 (m, m) matrices on the
#: card, 4 m^2 B; half of an 80 GB card for them gives m <= 100,000, so
#: 12 batches: 98,304 edges, 2 x 19.3 GB, the other half left to the
#: graph and the checker that hold the card meanwhile
MAX_COMPONENT_BATCHES = 12


@dataclasses.dataclass
class SweepGraph:
    """Static, padded graph layout for the sweep (tensors on one device).

    Non-chain edges are COO (src, dst, mask).  Chain edges are given as
    concatenated node sequences: chain_nodes with chain_starts flags; the
    implied edges are chain_nodes[i] -> chain_nodes[i+1] within a segment.
    chain_mask disables whole entries.  Ranks are unique per node; forward
    = rank increases.
    """

    n_nodes: int
    rank: torch.Tensor          # (N,) int32, unique
    nc_src: torch.Tensor        # (E,) int32 non-chain edges
    nc_dst: torch.Tensor        # (E,) int32
    nc_mask: torch.Tensor       # (E,) bool
    chain_nodes: torch.Tensor   # (C,) int32
    chain_starts: torch.Tensor  # (C,) bool
    chain_mask: torch.Tensor    # (C,) bool


def backward_test(rank, nc_src, nc_dst, n_nodes: int) -> torch.Tensor:
    """Edge goes backward iff rank does not increase."""
    return rank[nc_src.clamp(0, n_nodes - 1).long()] >= \
        rank[nc_dst.clamp(0, n_nodes - 1).long()]


def _endpoint_table(k: int, back_id, in_k, ends) -> torch.Tensor:
    """(k,) table t[back_id[e]] = ends[e] over edges `in_k` (others 0) —
    the JAX scatter-max onto a sink slot; ids are unique."""
    slot = torch.where(in_k, back_id, k).long()
    out = torch.zeros(k + 1, dtype=I32, device=ends.device)
    out.scatter_reduce_(0, slot, torch.where(in_k, ends, 0).to(I32), "amax",
                        include_self=True)
    return out[:k]


def _seed_labels(n_nodes: int, k: int, bdst, bvalid) -> torch.Tensor:
    """(N, k) int8 plane with label[bdst[e], e] = 1 for valid e.  A row
    index that is negative wraps once and one still out of range is
    dropped (a sink row cut off), as the JAX scatter does."""
    rows = torch.where(bvalid, bdst, 0).long()
    rows = torch.where(rows < 0, rows + n_nodes, rows)
    rows = torch.where((rows < 0) | (rows >= n_nodes), n_nodes, rows)
    labels = torch.zeros((n_nodes + 1, k), dtype=I8, device=bdst.device)
    cols = torch.arange(k, device=bdst.device)
    # columns are distinct, so every (row, col) pair is written once and
    # a plain store equals the scatter-max onto zeros
    labels[rows, cols] = bvalid.to(I8)
    return labels[:n_nodes]


def _rank_window(rank, bsrc, bdst, bvalid) -> torch.Tensor:
    """(k,) int64: backward edge e's window, the greatest rank that any
    cycle through e can reach (-1 for an invalid e).

    Forward edges raise rank and only backward edges lower it, so a
    cycle's backward edges cover its whole rank range with their
    [rank(dst), rank(src)] intervals (every step up the ranks is stepped
    down again), and its forward stretches span at most the sum of its
    backward edges' drops.  So a cycle through e ends, in rank, at the
    right end of the component of overlapping intervals that holds e's,
    and within rank(dst(e)) + S, S summing every backward edge's drop.
    Reachability past the window closes no cycle through e.  Every
    backward edge of the graph must be among the valid ones."""
    rs = rank[bsrc.long()].to(torch.int64)
    rd = rank[bdst.long()].to(torch.int64)
    drops = torch.where(bvalid, rs - rd, 0).sum()
    order, comp = _interval_components(rd, rs, bvalid)
    rs_o = torch.where(bvalid[order], rs[order], -1)
    right = torch.full_like(rs_o, -1).scatter_reduce_(
        0, comp, rs_o, "amax", include_self=True)
    right_of = torch.empty_like(right)
    right_of[order] = right[comp]
    return torch.where(bvalid, torch.minimum(rd + drops, right_of), -1)


def _interval_components(rd, rs, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The components of overlapping [rd, rs] intervals: (order, comp),
    the intervals sorted by rd (the invalid last, each a component of its
    own) and each one's component id in that order, ids rising with rd.
    A component starts where rd passes every earlier interval's right
    end.  Every cycle's backward edges lie in one component."""
    big = torch.iinfo(torch.int64).max
    order = torch.argsort(torch.where(valid, rd, big), stable=True)
    rd_o = torch.where(valid[order], rd[order], big)
    rs_o = torch.where(valid[order], rs[order], -1)
    reach = torch.cummax(rs_o, 0).values
    starts = torch.ones_like(valid)
    starts[1:] = rd_o[1:] > reach[:-1]
    return order, torch.cumsum(starts.to(torch.int64), 0) - 1


def _changed_in_window(diff, rank, limit) -> bool:
    """Whether `diff` (N, k) bool holds a change at a node inside its
    column's window (rank <= limit), read over blocks of rows so that no
    second (N, k) plane is made."""
    n, k = diff.shape
    rows = max(1, (1 << 24) // max(k, 1))
    hit = torch.zeros((), dtype=torch.bool, device=diff.device)
    for a in range(0, n, rows):
        b = min(a + rows, n)
        r = rank[a:b].to(torch.int64)
        hit |= (diff[a:b] & (r[:, None] <= limit[None, :])).any()
    return bool(hit)


def _fixpoint(n_nodes: int, k: int, max_rounds: int, rank, nc_src, nc_dst,
              fwd_mask, chain_nodes, chain_starts, chain_mask, bdst, bvalid,
              limit) -> Tuple[torch.Tensor, bool]:
    """The (N, k) int8 label plane of forward reachability from the heads
    `bdst` of the valid columns, through the chains and the forward
    non-chain edges `fwd_mask` only (so no column reads another), and
    whether it converged within `max_rounds`.  With `limit` (k,), each
    column's rank window, a round that changes nothing inside the windows
    ends the fixpoint; without it, one that changes nothing at all."""

    def chain_pass(labels):
        vals = gather_rows(labels, chain_nodes, chain_mask)
        pref = segmented_prefix_or(vals, chain_starts, exclusive=True)
        return scatter_or(labels, chain_nodes, pref, chain_mask)

    def relax_pass(labels):
        vals = gather_rows(labels, nc_src, fwd_mask)
        return scatter_or(labels, nc_dst, vals, fwd_mask)

    labels = chain_pass(_seed_labels(n_nodes, k, bdst, bvalid))
    changed, rounds = True, 0
    while changed and rounds < max_rounds:
        new = chain_pass(relax_pass(chain_pass(labels)))
        diff = new != labels
        changed = bool(torch.any(diff))
        if changed and limit is not None:
            changed = _changed_in_window(diff, rank, limit)
        labels = new
        rounds += 1
    return labels, not (changed and rounds >= max_rounds)


def _sweep_window(n_nodes: int, k: int, max_rounds: int,
                  rank, nc_src, nc_dst, nc_mask,
                  chain_nodes, chain_starts, chain_mask,
                  back_raw=None, back_pre=None, back_tables=None,
                  devices=None, place=None
                  ) -> Tuple[bool, torch.Tensor, int, bool]:
    """Sweep over the first `k` backward edges.  Returns (has_cycle,
    witness_bits (k,) int8, n_backward, converged); n_backward may
    exceed k (the first k are exact and the caller must grow the
    budget).

    `back_pre` = (is_back, back_id, n_back) and `back_tables` = (bsrc,
    bdst) let `projection_scan` hand in the enumeration it hoisted;
    without them the edges are enumerated here in position order.  When
    the first k hold every backward edge, the fixpoint has converged once
    nothing changes inside the rank windows (`_rank_window`); otherwise
    the windows are unknown and it runs until nothing changes at all.

    `devices` (the shards of one mesh axis, in order; they may repeat)
    splits the k columns as the JAX module's sharded window does: shard i
    sweeps the columns [i k / n, (i + 1) k / n) on its own device
    (`_window_rows`).  The windows' meta rows are gathered on the first
    device (`mesh.all_gather_rows`, the JAX ``all_gather``) and closed
    there once, and the sweep has converged iff every window has (the
    JAX ``psum`` of the flags).  Columns never read each other, so the
    result is the same for every split; None is one window on the
    graph's device.  `place(t, dev)` (a `replica_placer`, new when None)
    copies an input to a shard's device; a caller that sweeps several
    times passes one, so that each fixed tensor reaches each device
    once."""
    from jepsen_tpu_torch.parallel.mesh import all_gather_rows, psum

    devices = [nc_src.device] if devices is None \
        else [torch.device(d) for d in devices]
    assert k % len(devices) == 0, (k, len(devices))
    if back_pre is None:
        if back_raw is None:
            back_raw = backward_test(rank, nc_src, nc_dst, n_nodes)
        is_back = nc_mask & back_raw
        back_id = torch.where(is_back,
                              torch.cumsum(is_back.to(I32), 0, dtype=I32) - 1,
                              -1)
        n_back = int(torch.sum(is_back.to(I32)))
    else:
        is_back, back_id, n_back = back_pre
    first = devices[0]
    if n_back == 0:
        # forward edges strictly increase rank: a DAG, nothing to propagate
        return False, torch.zeros(k, dtype=I8, device=first), 0, True

    if back_tables is not None:
        bsrc, bdst = back_tables
    else:
        in_k = is_back & (back_id < k)
        bsrc = _endpoint_table(k, back_id, in_k, nc_src)
        bdst = _endpoint_table(k, back_id, in_k, nc_dst)
    fwd_mask = nc_mask & ~is_back  # forward non-chain edges only
    # the caller's tensors through `place`, this sweep's own through a
    # placer that ends with the call
    place, own = place or replica_placer(), replica_placer()
    k_local = k // len(devices)
    rows, bad = [], []
    for i, dev in enumerate(devices):
        r, conv = _window_rows(
            n_nodes, k, max_rounds, n_back, i * k_local, k_local,
            *(place(t, dev) for t in (rank, nc_src, nc_dst)),
            own(fwd_mask, dev),
            *(place(t, dev) for t in (chain_nodes, chain_starts,
                                      chain_mask)),
            own(bsrc, dev), own(bdst, dev))
        rows.append(r)
        bad.append(not conv)
    # backward edge e is on a cycle iff its closure's diagonal holds e
    valid8 = (torch.arange(k, device=first) < n_back).to(I8)
    meta = all_gather_rows(rows, first)
    witness = _closure_diagonal(meta.to(_closure_dtype(first))).to(I8) \
        & valid8
    return bool(torch.any(witness == 1)), witness, n_back, psum(bad) == 0


def _window_rows(n_nodes: int, k: int, max_rounds: int, n_back: int,
                 k_offset: int, k_local: int, rank, nc_src, nc_dst,
                 fwd_mask, chain_nodes, chain_starts, chain_mask,
                 bsrc, bdst) -> Tuple[torch.Tensor, bool]:
    """One window of `_sweep_window`: the label columns [k_offset,
    k_offset + k_local) of the k, propagated through the chains and the
    forward edges `fwd_mask`, each with its own rank window (taken over
    all k).  Returns (the window's (k_local, k) int8 rows of the meta
    graph, converged)."""
    dev = nc_src.device
    bvalid = torch.arange(k, device=dev) < n_back
    cols = slice(k_offset, k_offset + k_local)
    limit = _rank_window(rank, bsrc, bdst, bvalid)[cols] \
        if n_back <= k else None
    labels, converged = _fixpoint(n_nodes, k_local, max_rounds, rank,
                                  nc_src, nc_dst, fwd_mask, chain_nodes,
                                  chain_starts, chain_mask, bdst[cols],
                                  bvalid[cols], limit)
    # meta[e, e2] = dst(e) ->* src(e2), read from labels[src(e2), e]
    valid8 = bvalid.to(I8)
    meta = gather_rows(labels, bsrc, bvalid).T
    return meta & valid8[cols, None] & valid8[None, :], converged


def shard_budget(max_k: int, n_shards: int) -> int:
    """`max_k` rounded up to a multiple of `n_shards`, so that a sweep
    split over that many shards gives each the same number of columns
    (a mesh of 3 takes 129 for 128)."""
    return -(-max_k // n_shards) * n_shards


def replica_placer():
    """A `place(t, dev)` for `_sweep_window` that copies each tensor to
    each device once: the fixed rank, edge and chain tensors of a check
    reach every distinct device of a mesh once, whatever the number of
    projections, retries or shards on that device."""
    copies: dict = {}

    def place(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        if t.device == dev:
            return t
        key = (id(t), dev)
        if key not in copies:
            # the source is kept too, so that no id is reused meanwhile
            copies[key] = (t, t.to(dev))
        return copies[key][1]

    return place



def projection_scan(n_nodes: int, max_k: int, max_rounds: int,
                    rank, e_src, e_dst, fam_masks: Sequence[torch.Tensor],
                    inc_stack: Sequence[Sequence[int]],
                    chain_nodes, chain_starts,
                    chain_masks: Sequence[torch.Tensor],
                    cinc_stack: Sequence[Sequence[int]],
                    devices=None, place=None
                    ) -> Tuple[bool, int, List[int]]:
    """`_sweep_window` over projections given per-family masks and
    per-projection family-include flags.  `devices` and `place` go to
    every projection's `_sweep_window`: the sharded paths
    (`parallel/op_shard.py`, `parallel/hybrid.py`) split each
    projection's columns over a mesh axis that way.

    Backward-edge enumeration is hoisted to ONE cumsum over the union of
    the families plus per-family count offsets: families are concatenated
    blocks, so a projection's position-stable enumeration equals its
    within-family ids shifted by the counts of its included predecessor
    families.  The (max_k,) endpoint tables come from binary searches over
    that cumsum.

    fam_masks: per-family (E_f,) bool masks, concat order == e_src.
    inc_stack: (P, F) 0/1 — family f included in projection p.
    chain_masks: per-chain-group (C_g,) bool, concat order ==
    chain_nodes.  cinc_stack: (P, G) 0/1.
    Returns (conv_all, overflow, cyc_bits: P ints)."""
    dev = e_src.device
    fam_lens = [int(m.shape[0]) for m in fam_masks]
    bounds = np.cumsum([0] + fam_lens)
    E = int(bounds[-1])
    union_mask = torch.cat(list(fam_masks))
    n_proj = len(inc_stack)

    back_all = union_mask & backward_test(rank, e_src, e_dst, n_nodes)
    cum = torch.cumsum(back_all.to(I32), 0, dtype=I32)      # ONE E-cumsum
    if E == 0 or int(cum[-1]) == 0:
        # zero backward edges across the union: every projection is a DAG
        return True, 0, [0] * n_proj
    # the cumsum just before every family boundary, read to the host once
    at = cum[torch.tensor([max(int(b) - 1, 0) for b in bounds],
                          device=dev)].tolist()
    cum_at = [c if b > 0 else 0 for c, b in zip(at, bounds)]
    cum_start = cum_at[:-1]
    count_f = [e - s for s, e in zip(cum_at[:-1], cum_at[1:])]
    lens_t = torch.tensor(fam_lens, device=dev)

    def rep(vals):
        return torch.repeat_interleave(
            torch.tensor(vals, dtype=I32, device=dev), lens_t, output_size=E)

    within = (cum - 1) - rep(cum_start)
    tgt = torch.arange(max_k, dtype=I32, device=dev)

    conv_all, overflow, cyc_bits = True, 0, []
    for inc, cinc in zip(inc_stack, cinc_stack):
        inc_b = rep([int(bool(i)) for i in inc]) != 0
        m = union_mask & inc_b
        cm = torch.cat([cmask & (cinc[g] > 0)
                        for g, cmask in enumerate(chain_masks)])
        inc_counts = [c * int(bool(i)) for c, i in zip(count_f, inc)]
        offs = [0] + list(np.cumsum(inc_counts)[:-1].astype(int))
        is_back = back_all & inc_b
        back_id = torch.where(is_back, within + rep(offs), -1)
        n_back = int(sum(inc_counts))

        # the edge with projection id i in family f is the first position
        # of f's block where `cum` reaches cum_start[f] + (i - offs[f]) + 1
        bsrc = torch.zeros(max_k, dtype=I32, device=dev)
        bdst = torch.zeros(max_k, dtype=I32, device=dev)
        for f, L in enumerate(fam_lens):
            if L == 0 or not inc[f]:
                continue
            lo, hi = int(bounds[f]), int(bounds[f + 1])
            j = tgt - int(offs[f])
            pos = lo + torch.searchsorted(cum[lo:hi], cum_start[f] + j + 1,
                                          side="left")
            pos = pos.clamp(0, E - 1)
            sel = (j >= 0) & (j < count_f[f])
            bsrc = torch.where(sel, e_src[pos], bsrc)
            bdst = torch.where(sel, e_dst[pos], bdst)

        has, _, n_back_out, conv = _sweep_window(
            n_nodes, max_k, max_rounds, rank, e_src, e_dst, m,
            chain_nodes, chain_starts, cm,
            back_pre=(is_back, back_id, n_back), back_tables=(bsrc, bdst),
            devices=devices, place=place)
        conv_all = conv_all and conv
        overflow = max(overflow, n_back_out - max_k, 0)
        cyc_bits.append(int(has))
    return conv_all, overflow, cyc_bits


@dataclasses.dataclass
class SweepResult:
    has_cycle: bool
    witness_edge_ids: np.ndarray  # indices into the non-chain edge arrays
    n_backward: int
    converged: bool
    #: backward edges in the largest component of their rank intervals,
    #: where `detect_cycles` sweeps by components (0 otherwise)
    largest_component: int = 0


def detect_cycles(g: SweepGraph, max_k: int = 128, max_rounds: int = 64,
                  deadline=None, device: backend.DeviceLike = None,
                  mesh=None) -> SweepResult:
    """Run the sweep on `device` (the CUDA card unless the caller names
    the CPU); grow the budget if backward edges exceed max_k or the
    fixpoint needs more rounds, up to the caps.

    Exact: a cycle is reported iff one exists in the (masked) graph,
    provided converged=True.  Witnesses identify backward edges on cycles
    (of the first max_k).

    `deadline` (a `resilience.Deadline`) is polled on entry and before
    each grow retry — the budget-doubling fixpoint is this driver's
    unbounded loop; expiry raises `DeadlineExceeded`.

    `mesh` (a 1-D `parallel.mesh.Mesh`, as `parallel.slots.default_mesh`
    resolves it) splits the backward-edge axis over its shards
    (`_sweep_window`), the budget rounded up to a multiple of their
    count (`shard_budget`); the graph goes to the mesh's first device.
    The verdict is the single-device sweep's.  Past `MAX_K_CAP` the
    components are swept on that first device."""
    if mesh is not None:
        assert mesh.devices.ndim == 1, mesh
        devices = list(mesh.devices)
    else:
        devices = [backend.resolve(device)]
    arrays = [t.to(devices[0]) for t in (
        g.rank, g.nc_src, g.nc_dst, g.nc_mask, g.chain_nodes,
        g.chain_starts, g.chain_mask)]
    place = replica_placer()
    while True:
        if deadline is not None:
            deadline.check("cycle-sweep")
        max_k = shard_budget(max_k, len(devices))
        has, wit, n_back, conv = _sweep_window(
            g.n_nodes, max_k, max_rounds, *arrays, devices=devices,
            place=place)
        if n_back > max_k:
            if n_back > MAX_K_CAP or max_k >= MAX_K_CAP:
                # past the bit budget: sweep the components of the
                # backward edges in batches, or report inexact
                return _by_components(g, arrays, has, n_back, max_rounds,
                                      deadline)
            max_k = min(max(max_k * 2, _pow2(n_back)), MAX_K_CAP)
            continue
        if not conv and max_rounds < MAX_ROUNDS_CAP:
            max_rounds = min(max_rounds * 2, MAX_ROUNDS_CAP)
            continue
        break
    if not has:
        # no witness bit is set: skip pulling the edge arrays to the host
        return SweepResult(has_cycle=False,
                           witness_edge_ids=np.zeros(0, np.int64),
                           n_backward=n_back, converged=conv)
    wit = wit.cpu().numpy()
    # map witness backward-edge ids back to edge-array positions
    mask = g.nc_mask.cpu().numpy()
    rank = g.rank.cpu().numpy()
    src = np.clip(g.nc_src.cpu().numpy(), 0, g.n_nodes - 1)
    dst = np.clip(g.nc_dst.cpu().numpy(), 0, g.n_nodes - 1)
    is_back = mask & (rank[src] >= rank[dst])
    back_pos = np.nonzero(is_back)[0]
    wit_ids = back_pos[np.nonzero(wit[:len(back_pos)])[0]] \
        if len(back_pos) else np.zeros(0, np.int64)
    return SweepResult(has_cycle=has, witness_edge_ids=wit_ids,
                       n_backward=n_back, converged=conv)


def unconverged_reason(res: SweepResult) -> str:
    """Why `res` (converged=False) is inexact, for the error that
    reports it: a component past the cap, or a fixpoint past
    `MAX_ROUNDS_CAP` rounds."""
    cap = MAX_COMPONENT_BATCHES * MAX_K_CAP
    if res.largest_component > cap:
        return (f"{res.n_backward} backward edges, "
                f"{res.largest_component} of them in one component of "
                f"their rank intervals, past the cap of {cap} that the "
                f"card closes")
    return (f"{res.n_backward} backward edges, no fixpoint within "
            f"{MAX_ROUNDS_CAP} rounds")


def _by_components(g: SweepGraph, arrays, has: bool, n_back: int,
                   max_rounds: int, deadline) -> SweepResult:
    """`detect_cycles` past `MAX_K_CAP` backward edges (the JAX module
    reports itself inexact there).  Every cycle's backward edges lie in
    one component of overlapping rank intervals
    (`_interval_components`), so a sweep over whole components, with the
    other backward edges left out of the graph, finds every cycle
    through them.  The components go, in rank order, into groups of at
    most k edges, k the least power of two (from 128, at most
    `MAX_K_CAP`) that holds the largest; a component larger than k is a
    group of its own.  Each group is swept k columns at a time and
    closed whole (`_close_group`).  A component of more than
    `MAX_COMPONENT_BATCHES` * `MAX_K_CAP` edges leaves the result
    inexact."""
    rank, nc_src, nc_dst, nc_mask = arrays[:4]
    is_back = nc_mask & backward_test(rank, nc_src, nc_dst, g.n_nodes)
    pos = torch.nonzero(is_back).flatten()
    rs = rank[nc_src[pos].clamp(0, g.n_nodes - 1).long()].to(torch.int64)
    rd = rank[nc_dst[pos].clamp(0, g.n_nodes - 1).long()].to(torch.int64)
    order, comp = _interval_components(rd, rs,
                                       torch.ones_like(pos, dtype=torch.bool))
    sizes = torch.bincount(comp).tolist()
    largest = max(sizes)
    if largest > MAX_COMPONENT_BATCHES * MAX_K_CAP:
        return SweepResult(has_cycle=has,
                           witness_edge_ids=np.zeros(0, np.int64),
                           n_backward=n_back, converged=False,
                           largest_component=largest)
    k = max(128, _pow2(min(largest, MAX_K_CAP)))
    # whole components in rank order, at most k edges a group unless one
    # component alone holds more
    cuts, filled = [0], 0
    for size in sizes:
        if filled and filled + size > k:
            cuts.append(cuts[-1] + filled)
            filled = 0
        filled += size
    cuts.append(len(pos))
    forward = nc_mask & ~is_back
    found, converged = [], True
    for a, b in zip(cuts[:-1], cuts[1:]):
        batch = torch.sort(pos[order[a:b]]).values
        wit, conv = _close_group(g.n_nodes, arrays, forward, batch, k,
                                 max_rounds, deadline)
        converged = converged and conv
        found.append(batch[wit])
    wit_ids = torch.sort(torch.cat(found)).values.cpu().numpy() \
        .astype(np.int64)
    return SweepResult(has_cycle=bool(len(wit_ids)),
                       witness_edge_ids=wit_ids, n_backward=n_back,
                       converged=converged, largest_component=largest)


def _close_group(n_nodes: int, arrays, forward, batch, k: int,
                 max_rounds: int, deadline) -> Tuple[torch.Tensor, bool]:
    """The backward edges at positions `batch`, whole components of their
    rank intervals, m of them: (which lie on a cycle, as an (m,) bool,
    and whether every column batch converged).

    Label column e is seeded at dst(e) and relaxed through chains and
    forward edges only (`_fixpoint`), so the columns never read each
    other and can be swept k at a time, each batch to its own fixpoint
    with its rounds grown up to `MAX_ROUNDS_CAP`.  Every backward edge
    of the group stays out of the relaxation, and each column's rank
    window comes from all of them (`_rank_window` holds only when every
    backward edge of the graph is among its valid ones).  Each batch
    fills its rows of one (m, m) meta matrix, meta[e, e2] =
    labels_e[src(e2)]; `_closure_diagonal` closes it."""
    rank, nc_src, nc_dst = arrays[:3]
    dev = rank.device
    m = len(batch)
    bsrc, bdst = nc_src[batch].to(I32), nc_dst[batch].to(I32)
    every = torch.ones(m, dtype=torch.bool, device=dev)
    limit = _rank_window(rank, bsrc, bdst, every)
    meta = torch.zeros((m, m), dtype=_closure_dtype(dev), device=dev)
    converged = True
    for a in range(0, m, k):
        if deadline is not None:
            deadline.check("cycle-sweep")
        b = min(a + k, m)
        # k columns a batch, the last one's tail invalid: no seed, and a
        # window of -1 that no change falls inside
        cols = torch.arange(a, a + k, device=dev).clamp(max=m - 1)
        valid = torch.arange(a, a + k, device=dev) < b
        rounds = max_rounds
        while True:
            labels, conv = _fixpoint(
                n_nodes, k, rounds, rank, nc_src, nc_dst, forward,
                *arrays[4:], bdst[cols], valid,
                torch.where(valid, limit[cols], -1))
            if conv or rounds >= MAX_ROUNDS_CAP:
                break
            rounds = min(rounds * 2, MAX_ROUNDS_CAP)
        converged = converged and conv
        meta[a:b] = gather_rows(labels, bsrc, every).T[:b - a].to(meta.dtype)
        del labels
    return _closure_diagonal(meta), converged


def _closure_dtype(dev: torch.device) -> torch.dtype:
    """The meta closure's operand type: bfloat16 on the card (half the
    memory of float32, and the tensor cores' rate), float32 on the CPU,
    where bfloat16 products are slow.  Either gives the same 0/1
    closure (`_closure_diagonal`)."""
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def _closure_diagonal(meta: torch.Tensor) -> torch.Tensor:
    """(m,) bool: which nodes of the 0/1 meta graph `meta` (m, m), in a
    floating type, lie on a cycle, the diagonal of its transitive
    closure.  Closed in place by repeated squaring, c <- min(c + c @ c,
    1), until the count of ones stops growing (c is then transitive) or
    ceil(log2 m) squarings have covered every path; one (m, m) product
    buffer besides `meta`, so two matrices at most.

    Exact in bfloat16 or float32, at any accumulation: every term of
    c @ c is a product of two 0/1 entries, so no term is negative and
    nothing cancels.  A sum of such terms is 0 exactly when every term
    is 0, and is at least 1 once one term is 1, however its partial
    sums are rounded (rounding to nearest never takes a value of at
    least 1 below 1, and a sum of at most m ones overflows neither
    type).  So the clamp leaves exactly the 0/1 entries of the boolean
    product."""
    c = meta
    p = torch.empty_like(c)
    ones = _count_ones(c)
    for _ in range(max(1, math.ceil(math.log2(max(2, c.shape[0]))))):
        torch.matmul(c, c, out=p)
        c.add_(p).clamp_(max=1)
        grown = _count_ones(c)
        if grown == ones:
            break
        ones = grown
    del p
    return torch.diagonal(c) > 0


def _count_ones(c: torch.Tensor) -> int:
    """The nonzero entries of matrix `c`, counted over blocks of rows of
    at most 2^26 entries: one `count_nonzero` of the whole matrix makes
    an int64 copy of it."""
    rows = max(1, (1 << 26) // max(c.shape[1], 1))
    total = torch.zeros((), dtype=torch.int64, device=c.device)
    for a in range(0, c.shape[0], rows):
        total += torch.count_nonzero(c[a:a + rows])
    return int(total)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
