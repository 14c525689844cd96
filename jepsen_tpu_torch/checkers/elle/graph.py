"""Host-side dependency-graph machinery (the port's copy of
`jepsen_tpu/checkers/elle/graph.py`).

Equivalent of the reference's `elle/graph.clj` + the bifurcan Java layer
(SURVEY.md §2.3, §2.5 #1): SCC computation, rel-constrained shortest-cycle
search (the `elle.bfs` analogue), and the sparse realtime-order construction.

The reference uses bifurcan's sequential Tarjan; here Tarjan is an iterative
host implementation used (a) as the exact oracle and (b) to classify the
small offending subgraphs that the device cycle sweep reports as witnesses.
The at-scale cycle *detection* path is the device sweep in
`jepsen_tpu_torch.ops.cycle_sweep`.  `tarjan_scc` runs the C++ Tarjan of
`jepsen_tpu_torch.native` unless `JT_NO_NATIVE` is set; its Python body is
the anchor the C++ one is held equal to.

Rel codes are shared with the device pipeline.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Dependency relationship codes (device + host shared).
REL_WW = 0
REL_WR = 1
REL_RW = 2
REL_PROCESS = 3
REL_REALTIME = 4

REL_NAMES = {REL_WW: "ww", REL_WR: "wr", REL_RW: "rw",
             REL_PROCESS: "process", REL_REALTIME: "realtime"}
REL_CODES = {v: k for k, v in REL_NAMES.items()}


class EdgeList:
    """A typed edge list over integer node ids (txns + barrier nodes)."""

    def __init__(self, src=(), dst=(), rel=()):
        self.src = np.asarray(src, dtype=np.int32)
        self.dst = np.asarray(dst, dtype=np.int32)
        self.rel = np.asarray(rel, dtype=np.int8)

    def __len__(self):
        return len(self.src)

    @staticmethod
    def concat(parts: Sequence["EdgeList"]) -> "EdgeList":
        parts = [p for p in parts if len(p)]
        if not parts:
            return EdgeList()
        e = EdgeList()
        e.src = np.concatenate([p.src for p in parts])
        e.dst = np.concatenate([p.dst for p in parts])
        e.rel = np.concatenate([p.rel for p in parts])
        return e

    def project(self, rels: Iterable[int]) -> "EdgeList":
        rels = set(rels)
        mask = np.isin(self.rel, list(rels))
        e = EdgeList()
        e.src, e.dst, e.rel = self.src[mask], self.dst[mask], self.rel[mask]
        return e

    def dedup(self) -> "EdgeList":
        if not len(self):
            return self
        key = np.stack([self.src.astype(np.int64), self.dst.astype(np.int64),
                        self.rel.astype(np.int64)], axis=1)
        _, idx = np.unique(key, axis=0, return_index=True)
        e = EdgeList()
        e.src, e.dst, e.rel = self.src[idx], self.dst[idx], self.rel[idx]
        return e


def realtime_edges(invoke_pos: np.ndarray, complete_pos: np.ndarray,
                   node_offset: int = 0) -> Tuple[EdgeList, int]:
    """Sparse realtime order via barrier nodes.

    The reference's `elle.core/realtime-graph` links each completed op to ops
    invoked after it; materializing that relation is O(n * concurrency)
    edges.  We instead thread a chain of *barrier* nodes through the history
    — one per completion event — giving an O(n)-edge graph whose transitive
    closure restricted to txn nodes equals the realtime relation exactly:

        txn T  --(completes at event e)-->  barrier(e)
        barrier(e) --> barrier(e')          (consecutive completions)
        barrier(e) --> txn U                (latest completion event < U's invoke)

    Barrier node ids start at `node_offset` (pass n_txns).  Returns the
    edges and the number of barrier nodes created.
    """
    n = len(invoke_pos)
    if n == 0:
        return EdgeList(), 0
    e, n_b, _ = realtime_edges_subset(invoke_pos, complete_pos,
                                      np.arange(n), np.ones(n, bool),
                                      node_offset)
    return e, n_b


def realtime_edges_subset(inv: np.ndarray, comp: np.ndarray,
                          ok_ids: np.ndarray, in_mask: np.ndarray,
                          n_nodes: int) -> Tuple[EdgeList, int, np.ndarray]:
    """Barrier-mediated realtime edges where only `ok_ids` complete and
    nodes with `in_mask` receive in-edges (invoked).  Barrier node ids
    start at n_nodes; returns (edges, n_barriers, barrier_ranks).  Barrier
    i corresponds to the i-th completion in completion order; its rank
    (2*comp+1) interleaves with txn ranks 2*comp."""
    ok_comp = comp[ok_ids]
    order = np.argsort(ok_comp, kind="stable")
    comp_sorted = ok_comp[order]
    n_b = len(ok_ids)
    if n_b == 0:
        return EdgeList(), 0, np.zeros(0, np.int64)
    src: List[np.ndarray] = [ok_ids[order].astype(np.int32)]
    dst: List[np.ndarray] = [(n_nodes + np.arange(n_b)).astype(np.int32)]
    if n_b > 1:
        src.append((n_nodes + np.arange(n_b - 1)).astype(np.int32))
        dst.append((n_nodes + np.arange(1, n_b)).astype(np.int32))
    cand = np.nonzero(in_mask)[0]
    b_idx = np.searchsorted(comp_sorted, inv[cand], side="left") - 1
    mask = b_idx >= 0
    if mask.any():
        src.append((n_nodes + b_idx[mask]).astype(np.int32))
        dst.append(cand[mask].astype(np.int32))
    e = EdgeList()
    e.src = np.concatenate(src)
    e.dst = np.concatenate(dst)
    e.rel = np.full(len(e.src), REL_REALTIME, dtype=np.int8)
    return e, n_b, (2 * comp_sorted + 1).astype(np.int64)


def process_edges(process: np.ndarray, invoke_pos: np.ndarray) -> EdgeList:
    """Chain each process's txns in invocation order (elle.core/process-graph)."""
    if len(process) == 0:
        return EdgeList()
    order = np.lexsort((invoke_pos, process))
    same = process[order[:-1]] == process[order[1:]]
    s = order[:-1][same].astype(np.int32)
    d = order[1:][same].astype(np.int32)
    e = EdgeList()
    e.src, e.dst = s, d
    e.rel = np.full(len(s), REL_PROCESS, dtype=np.int8)
    return e


def _adjacency(n: int, src: np.ndarray, dst: np.ndarray):
    """CSR-ish adjacency: sorted-by-src edge array + per-node slices."""
    order = np.argsort(src, kind="stable")
    ss, dd = src[order], dst[order]
    starts = np.searchsorted(ss, np.arange(n))
    ends = np.searchsorted(ss, np.arange(n), side="right")
    return dd, starts, ends, order


def tarjan_scc(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Iterative Tarjan SCC.  Returns component label per node (arbitrary ids).

    Host equivalent of bifurcan `Graphs.stronglyConnectedComponents`
    (SURVEY.md §2.5 #1).  Iterative to survive deep graphs.  Runs the
    C++ implementation (`jepsen_tpu_torch.native`, which raises when it
    cannot be built) unless `JT_NO_NATIVE` is set — the Python body
    below is the semantic anchor it is differentially tested against.
    """
    if n and not os.environ.get("JT_NO_NATIVE"):
        from jepsen_tpu_torch import native

        return native.scc(n, src, dst)
    adj_dst, starts, ends, _ = _adjacency(n, src, dst)
    UNVISITED = -1
    index = np.full(n, UNVISITED, dtype=np.int64)
    low = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int64)
    stack: List[int] = []
    next_index = 0
    n_comps = 0
    ptr = starts.copy().astype(np.int64)

    for root in range(n):
        if index[root] != UNVISITED:
            continue
        work = [root]
        while work:
            v = work[-1]
            if index[v] == UNVISITED:
                index[v] = low[v] = next_index
                next_index += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            while ptr[v] < ends[v]:
                w = int(adj_dst[ptr[v]])
                ptr[v] += 1
                if index[w] == UNVISITED:
                    work.append(w)
                    advanced = True
                    break
                elif on_stack[w]:
                    if index[w] < low[v]:
                        low[v] = index[w]
            if advanced:
                continue
            # all neighbors done
            work.pop()
            if work:
                u = work[-1]
                if low[v] < low[u]:
                    low[u] = low[v]
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp[w] = n_comps
                    if w == v:
                        break
                n_comps += 1
    return comp


def nontrivial_sccs(n: int, src: np.ndarray, dst: np.ndarray) -> List[np.ndarray]:
    """SCCs with >1 node, or a single node with a self-loop."""
    comp = tarjan_scc(n, src, dst)
    out: List[np.ndarray] = []
    if n == 0:
        return out
    order = np.argsort(comp, kind="stable")
    cs = comp[order]
    bounds = np.nonzero(np.diff(cs))[0] + 1
    groups = np.split(order, bounds)
    self_loop_nodes = set(src[src == dst].tolist())
    for g in groups:
        if len(g) > 1 or int(g[0]) in self_loop_nodes:
            out.append(g.astype(np.int64))
    return out


# ---------------------------------------------------------------------------
# Rel-constrained shortest-cycle search (the elle.bfs analogue).
#
# A cycle spec constrains which rels may appear and how rw (anti-dependency)
# edges may occur:
#   rw_mode: "any"          — no constraint on rw count
#            "none"         — no rw edges at all
#            "single"       — exactly one rw edge            (G-single)
#            "multi-nonadj" — >= 2 rw edges, no two adjacent (G-nonadjacent)
#            "some"         — >= 1 rw edge                   (G2-item)
# ---------------------------------------------------------------------------


class CycleSpec:
    def __init__(self, rels: Iterable[int], rw_mode: str = "any"):
        self.rels = frozenset(rels)
        self.rw_mode = rw_mode

    def __repr__(self):
        return f"CycleSpec({sorted(self.rels)}, {self.rw_mode})"


class _Adj:
    """Adjacency over a filtered edge list restricted to a node set."""

    def __init__(self, nodes: np.ndarray, edges: EdgeList,
                 rels: Optional[frozenset] = None,
                 drop_rels: Optional[frozenset] = None):
        self.node_set = set(int(x) for x in nodes)
        mask = np.isin(edges.src, nodes) & np.isin(edges.dst, nodes)
        if rels is not None:
            mask &= np.isin(edges.rel, list(rels))
        if drop_rels:
            mask &= ~np.isin(edges.rel, list(drop_rels))
        es, ed, er = edges.src[mask], edges.dst[mask], edges.rel[mask]
        order = np.argsort(es, kind="stable")
        self.src = es[order]
        self.dst = ed[order]
        self.rel = er[order]
        self._starts: Dict[int, int] = {}
        self._ends: Dict[int, int] = {}
        prev = None
        for i, s in enumerate(self.src.tolist()):
            if s != prev:
                self._starts[s] = i
                prev = s
        prev = None
        for i in range(len(self.src) - 1, -1, -1):
            s = int(self.src[i])
            if s != prev:
                self._ends[s] = i + 1
                prev = s
        self._nbrs: Dict[int, list] = {}

    def __len__(self):
        return len(self.src)

    def neighbors(self, v: int):
        """v's (dst, rel) pairs in edge order, built once per node: the
        searches visit the same nodes many times."""
        out = self._nbrs.get(v)
        if out is None:
            a = self._starts.get(v)
            if a is None:
                out = []
            else:
                b = self._ends[v]
                out = list(zip(self.dst[a:b].tolist(),
                               self.rel[a:b].tolist()))
            self._nbrs[v] = out
        return out

    def rw_edges(self):
        m = self.rel == REL_RW
        return zip(self.src[m].tolist(), self.dst[m].tolist())


def _bfs_path(adj: _Adj, src: int, dst: int, budget: List[int]
              ) -> Optional[List[Tuple[int, int, int]]]:
    """Shortest (simple) path src -> dst; list of (u, rel, v) steps.
    src == dst finds a shortest cycle through src."""
    parents: Dict[int, Tuple[int, int]] = {}
    q = deque([src])
    seen = {src} if src != dst else set()
    # the budget is counted in a local and written back at every return
    left = budget[0]
    neighbors, popleft, push, mark = adj.neighbors, q.popleft, q.append, \
        seen.add
    while q:
        v = popleft()
        for (w, rel) in neighbors(v):
            left -= 1
            if left <= 0:
                budget[0] = left
                return None
            if w == dst:
                budget[0] = left
                path = [(v, rel, w)]
                while v != src:
                    pv, prel = parents[v]
                    path.append((pv, prel, v))
                    v = pv
                path.reverse()
                return path
            if w not in seen:
                mark(w)
                parents[w] = (v, rel)
                push(w)
    budget[0] = left
    return None


def find_cycle(nodes: np.ndarray, edges: EdgeList, spec: CycleSpec,
               max_steps: int = 2_000_000) -> Optional[List[Tuple[int, int, int]]]:
    """Shortest simple cycle within `nodes` satisfying `spec`.

    Returns a list of (src, rel, dst) steps forming the cycle, or None.
    Exact, per-mode strategies (all produce *simple* cycles — Adya phenomena
    are simple cycles in the DSG, and closed non-simple walks must not be
    reported; cf. the reference's elle.txn cycle search):

      any          — shortest cycle through any node (plain BFS).
      single       — for each rw edge (a, b): shortest b->a path avoiding rw;
                     BFS paths are simple and rw-free, so edge + path is a
                     simple cycle with exactly one rw.
      some         — same but the return path may use any rel (>=1 rw).
      multi-nonadj — NFA-guided BFS; a found walk is verified simple, else a
                     budgeted DFS over simple paths; None if budget exhausts
                     (conservative: never a false positive).
    """
    budget = [max_steps]
    mode = spec.rw_mode
    if mode in ("any", "none"):
        adj = _Adj(nodes, edges, spec.rels,
                   drop_rels=frozenset([REL_RW]) if mode == "none" else None)
        if not len(adj):
            return None
        for start in (int(x) for x in nodes):
            path = _bfs_path(adj, start, start, budget)
            if path is not None:
                return path
            if budget[0] <= 0:
                return None
        return None
    if mode in ("single", "some"):
        adj_full = _Adj(nodes, edges, spec.rels)
        ret_adj = (_Adj(nodes, edges, spec.rels, drop_rels=frozenset([REL_RW]))
                   if mode == "single" else adj_full)
        for (a, b) in adj_full.rw_edges():
            path = _bfs_path(ret_adj, b, a, budget)
            if path is not None:
                return path + [(a, REL_RW, b)]
            if budget[0] <= 0:
                return None
        return None
    if mode == "multi-nonadj":
        return _find_nonadjacent_cycle(nodes, edges, spec, budget)
    raise ValueError(mode)


def _find_nonadjacent_cycle(nodes, edges, spec, budget):
    """Simple cycle with >=2 rw edges, no two cyclically adjacent.

    DFS over simple paths with on-path visited set, pruned by the
    nonadjacency NFA.  Budgeted: gives up (returns None) rather than
    reporting a non-simple walk.

    The JAX module's search, step for step: a stack of entries, each
    node's edges scanned when it is popped.  Where that one copies its
    path and on-path set into every entry, here an entry holds its
    depth, and one path and set are cut back to the popped entry's
    parent and extended by its edge: the stack is last in, first out,
    so the path above the parent's depth then belongs to subtrees
    already done.  The same cycle, or None at the same budget step.
    """
    adj = _Adj(nodes, edges, spec.rels)
    if not len(adj):
        return None
    neighbors = adj.neighbors
    left = budget[0]
    # start DFS only at rw edge tails: every qualifying cycle has one
    for (a0, b0) in adj.rw_edges():
        # entries (node, parent, rel, depth, rw_count, last_was_rw): the
        # path to node is `depth` edges, the first a0 -rw-> b0
        path, on_path = [], {a0}
        stack = [(b0, a0, REL_RW, 1, 1, True)]
        while stack:
            if left <= 0:
                budget[0] = left
                return None
            v, u, rel_in, depth, rw_n, last_rw = stack.pop()
            while len(path) >= depth:
                on_path.discard(path.pop()[2])
            path.append((u, rel_in, v))
            on_path.add(v)
            for (w, rel) in neighbors(v):
                left -= 1
                is_rw = rel == REL_RW
                if is_rw and last_rw:
                    continue  # adjacent rw
                if w == a0:
                    # closing edge: wraparound adjacency vs the initial rw
                    if is_rw:
                        continue
                    if rw_n >= 2:
                        budget[0] = left
                        return path + [(v, rel, a0)]
                    continue
                if w in on_path:
                    continue
                stack.append((w, v, rel, depth + 1,
                              rw_n + (1 if is_rw else 0), is_rw))
    budget[0] = left
    return None
