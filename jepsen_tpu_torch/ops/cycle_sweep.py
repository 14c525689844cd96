"""Device cycle detection over dependency graphs (PyTorch).

Counterpart of `jepsen_tpu/ops/cycle_sweep.py`, single window:

1. Rank decomposition: edges split into forward (rank increases) and
   backward; forward edges alone form a DAG, so every cycle holds a
   backward edge, and a graph with none is acyclic.
2. Forward reachability from backward-edge heads as (N, K) 0/1 int8
   label planes: chains (process order, the realtime barrier chain) are
   resolved by segmented prefix-OR scans (the seg-OR kernel on a CUDA
   tensor), other forward edges by scatter-max relaxation, to a fixpoint.
3. Meta-closure: a cycle exists iff the K-node meta-graph (e -> e' iff
   dst(e) ->* src(e')) has one; closure by repeated squaring.

Control flow runs on the host: the fixpoint is a Python loop with one
scalar read per round, the skips for zero backward edges are Python
branches, and the scan over projections is a Python loop.  A result with
`converged=False` must not be trusted (`list_append.check` raises on it;
the JAX package falls back to its host oracle).
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


def _sweep_window(n_nodes: int, k: int, max_rounds: int,
                  rank, nc_src, nc_dst, nc_mask,
                  chain_nodes, chain_starts, chain_mask,
                  back_raw=None, back_pre=None, back_tables=None
                  ) -> Tuple[bool, torch.Tensor, int, bool]:
    """Sweep over the first `k` backward edges.  Returns (has_cycle,
    witness_bits (k,) int8, n_backward, converged).

    `back_pre` = (is_back, back_id, n_back) and `back_tables` = (bsrc,
    bdst) let `projection_scan` hand in the enumeration it hoisted;
    without them the edges are enumerated here in position order."""
    if back_pre is not None:
        is_back, back_id, n_back = back_pre
    else:
        if back_raw is None:
            back_raw = backward_test(rank, nc_src, nc_dst, n_nodes)
        is_back = nc_mask & back_raw
        back_id = torch.where(is_back,
                              torch.cumsum(is_back.to(I32), 0, dtype=I32) - 1,
                              -1)
        n_back = int(torch.sum(is_back.to(I32)))
    dev = nc_src.device
    if n_back == 0:
        # forward edges strictly increase rank: a DAG, nothing to propagate
        return False, torch.zeros(k, dtype=I8, device=dev), 0, True

    if back_tables is not None:
        bsrc, bdst = back_tables
    else:
        in_k = is_back & (back_id < k)
        bsrc = _endpoint_table(k, back_id, in_k, nc_src)
        bdst = _endpoint_table(k, back_id, in_k, nc_dst)
    bvalid = torch.arange(k, device=dev) < n_back
    fwd_mask = nc_mask & ~is_back  # forward non-chain edges only

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
        changed = bool(torch.any(new != labels))
        labels = new
        rounds += 1
    converged = not (changed and rounds >= max_rounds)

    # meta[e, e2] = dst(e) ->* src(e2), read from labels[src(e2), e]
    valid8 = bvalid.to(I8)
    meta = gather_rows(labels, bsrc, bvalid).T
    meta = meta & valid8[:, None] & valid8[None, :]
    # closure by repeated squaring.  The product runs in float32 and is
    # exact: entries are 0/1 and every sum is at most k <= MAX_K_CAP =
    # 8192 < 2^24, so even TF32 inputs (0 and 1 are exact in it) with
    # float32 accumulation cannot turn a positive sum into 0.
    closure = meta
    for _ in range(max(1, math.ceil(math.log2(max(2, k))))):
        r = closure.to(torch.float32)
        closure = closure | ((r @ r) > 0).to(I8)
    # backward edge e is on a cycle iff closure[e][e]
    witness = torch.diagonal(closure) & valid8
    return bool(torch.any(witness == 1)), witness, n_back, converged


def _sweep_arrays(n_nodes: int, max_k: int, max_rounds: int,
                  rank, nc_src, nc_dst, nc_mask,
                  chain_nodes, chain_starts, chain_mask, back_raw=None,
                  back_pre=None, back_tables=None):
    """Single-window sweep.  Returns (has_cycle, witness_bits (max_k,)
    int8, n_backward, converged); n_backward may exceed max_k (the first
    max_k are exact and the caller must grow the budget)."""
    return _sweep_window(n_nodes, max_k, max_rounds, rank, nc_src, nc_dst,
                         nc_mask, chain_nodes, chain_starts, chain_mask,
                         back_raw=back_raw, back_pre=back_pre,
                         back_tables=back_tables)


def projection_scan(n_nodes: int, max_k: int, max_rounds: int,
                    rank, e_src, e_dst, fam_masks: Sequence[torch.Tensor],
                    inc_stack: Sequence[Sequence[int]],
                    chain_nodes, chain_starts,
                    chain_masks: Sequence[torch.Tensor],
                    cinc_stack: Sequence[Sequence[int]]
                    ) -> Tuple[bool, int, List[int]]:
    """`_sweep_arrays` over projections given per-family masks and
    per-projection family-include flags.

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

        has, _, n_back_out, conv = _sweep_arrays(
            n_nodes, max_k, max_rounds, rank, e_src, e_dst, m,
            chain_nodes, chain_starts, cm,
            back_pre=(is_back, back_id, n_back), back_tables=(bsrc, bdst))
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


def detect_cycles(g: SweepGraph, max_k: int = 128, max_rounds: int = 64,
                  deadline=None, device: backend.DeviceLike = None
                  ) -> SweepResult:
    """Run the sweep on `device` (the CUDA card unless the caller names
    the CPU); grow the budget if backward edges exceed max_k or the
    fixpoint needs more rounds, up to the caps.

    Exact: a cycle is reported iff one exists in the (masked) graph,
    provided converged=True.  Witnesses identify backward edges on cycles
    (of the first max_k).

    `deadline` (a `resilience.Deadline`) is polled on entry and before
    each grow retry — the budget-doubling fixpoint is this driver's
    unbounded loop; expiry raises `DeadlineExceeded`."""
    dev = backend.resolve(device)
    arrays = [t.to(dev) for t in (g.rank, g.nc_src, g.nc_dst, g.nc_mask,
                                  g.chain_nodes, g.chain_starts,
                                  g.chain_mask)]
    while True:
        if deadline is not None:
            deadline.check("cycle-sweep")
        has, wit, n_back, conv = _sweep_arrays(g.n_nodes, max_k, max_rounds,
                                               *arrays)
        if n_back > max_k:
            if n_back > MAX_K_CAP or max_k >= MAX_K_CAP:
                # bit budget unreachable or exhausted: report inexact
                return SweepResult(has_cycle=has,
                                   witness_edge_ids=np.zeros(0, np.int64),
                                   n_backward=n_back, converged=False)
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


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
