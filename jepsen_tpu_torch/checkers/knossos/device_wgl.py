"""Linearizability search on the card: a batched frontier BFS over the
config lattice (the port of `jepsen_tpu/checkers/knossos/device_wgl.py`).

The reference's WGL is a sequential DFS with a JVM-bitset visited cache
(`knossos/wgl.clj`).  Here the DFS branch set becomes a *wave* — all
configurations with k linearized ops — processed as one wide tensor step:

  config   = (model state int32, linearized bitset W x 32-bit words)
  wave     = frontier (F, W+1) in device memory
  expand   = for every config x every op: candidate iff op not yet
             linearized, its invocation precedes every unlinearized
             return (real-time order), and the memoized transition table
             admits it — all as (F, n) masked gathers
  dedup    = Zobrist hashing (h(S ^ op) = h(S) ^ z[op]) so children hash
             incrementally without materializing (F*n, W) bitsets; unique
             by (h1, h2, state') via a lexicographic sort + adjacent-compare
  success  = some config linearizes every op that returned

`info` (crashed) ops never return and may stay unlinearized — exactly the
reference's forever-concurrent treatment.

Exactness: a 64-bit hash collision could merge two distinct configs
(collision odds < 1e-9 per wave at the default frontier cap).  The result
therefore carries `hash_dedup: True`; `competition.analysis` anchors
definitive verdicts on the exact host search when the history is small and
uses the device verdict beyond that, as the reference races wgl/linear.

Scaling beyond the single-path wave: histories past 1024 ops, frontiers
past the device cap, and every search with a `ctl` go through the
*blocked* search — the frontier lives on the host as a list of <= F-row
blocks, each wave expands block by block on the card (`_expand_block`),
and cross-block dedup happens on the host with one vectorized sort-unique
per wave — per WAVE only, because configs in different waves have
different popcounts and so can never collide.  A block whose unique
children exceed the output capacity is split in half and re-expanded —
never truncated.  Waves of `HOST_EXPAND_MAX` rows or fewer expand in numpy
(`expand_host`): at that size the transfers cost more than the math.
Only the cumulative explored-config counter passing `max_configs` returns
"unknown"; frontier size alone does not.

Expansion is restricted per wave to the ACTIVE op window (ops not
linearized in every config, invokable below the wave's minret bound), so
per-wave cost tracks the real concurrency window.

Crash-heavy histories (`info` ops): each crashed op stays
forever-concurrent, so a naive BFS enumerates every did/didn't-linearize-it
subset per wave.  The blocked search prunes that dimension with a sound
cross-wave dominance rule: a config (state, R, X₁) — R the linearized
*returned* ops, X the linearized *crashed* ops — simulates every future of
(state, R, X₂) when X₁ ⊂ X₂.  Crashed ops never drive `minret` (their
returns sit at the 2^29 cap, above every real invoke), so the extra
unlinearized crashed ops on the X₁ side only add options, never
constraints.  The search keeps a host-side store of minimal X-sets per
(state, R) and drops dominated children as they are generated.  The prune
is host numpy, as in the JAX package.

Where the port differs from the JAX code, and why (each pinned by
`tests/test_torch_knossos.py`):

- *32-bit words.*  The JAX package holds `bits`, `must`, `z1`, `z2`, `h1`
  and `h2` as uint32, which torch barely supports (no sort, few ops).  The
  port holds the same bits in int32: numpy uint32 arrays cross as
  `.view(np.int32)`, `(w >> b) & 1` reads bit 31 right under the
  arithmetic shift, and `1 << 31` sets it.  Results come back to numpy
  as `.view(np.uint32)`.
- *Sort order of the hashes.*  `jnp.lexsort((state, h2, h1, ~mask))`
  orders `h1` and `h2` as unsigned.  The port widens both to int64 in
  [0, 2^32) and sorts twice, stably: first by `(h2 << 31) | (state + 1)`,
  then by `((~mask) << 32) | h1` (mask 0/1; `state` is -1 where the table
  refuses the op, hence the `+ 1`).  Both keys are non-negative int64, and
  the two passes give the lexicographic order of (~mask, h1, h2, state).
  Rows whose whole key ties are equal configs, so the order among them
  changes no output.
- *Compaction without a scatter.*  JAX compacts the kept children with
  `.at[tgt].max(arange)` onto F + 1 (or C + 1) rows, every dropped child
  aimed at the last.  As a `scatter_reduce_` that is 2^24 same-address
  atomics per wave at config 1, hundreds of times the rest of the wave on
  the H100 (`chip_smoke.py` phase 8b times both compactions).
  Row j of JAX's `take` is the sorted position of the (j+1)-th kept
  child, or -1, so the port reads it with `searchsorted` over the
  running kept count: the same rows, no atomics.
- *Gathers and sets.*  `.at[arange, word].set(bit)` is `index_put_`.
  JAX clamps gather indices where torch raises, so `act_word`, `act_sym`
  and `tk` are clamped explicitly.  `bits[p]` gathers (F, W) rows:
  nothing holds F x n x W.
- *The wave loop.*  `lax.while_loop` is a host loop that reads one packed
  (done, overflow, any-valid) tensor per wave: one device-to-host copy.
- *Zobrist keys* come from `np.random.default_rng(0xC0FFEE)`, in numpy,
  exactly as in the JAX package.

The JAX package's `JT_WGL_DEBUG` wave print is left out.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from jepsen_tpu_torch import backend
from jepsen_tpu_torch.checkers.knossos.memo import Memo, StateExplosion, memoize
from jepsen_tpu_torch.checkers.knossos.prep import NEVER, LinOp
from jepsen_tpu_torch.checkers.knossos.search import stamp_abort
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.resilience import active_plan, device_call

INF = 2 ** 30
MAX_DEVICE_OPS = 32768
#: waves of at most this many rows expand on the host (`expand_host`)
HOST_EXPAND_MAX = 4096

#: `_expand_block` calls, block splits and waves the blocked search
#: expanded on the host, since the caller last set them to 0
EXPAND_CALLS = 0
SPLITS = 0
HOST_WAVES = 0

_U32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words as the unsigned values they hold, in int64."""
    return x.to(torch.int64) & _U32


def _i32(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy uint32/int32 array on `dev` as int32 with the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(a).view(np.int32)).to(dev)


def _expand(states, bits, h1, h2, valid, in_s, invokes, returns, sym,
            z1, z2, table):
    """The children of a (F,)-row frontier over an op axis of n columns:
    their hashes, states and candidate mask, each (F * n,)."""
    ret_masked = torch.where(in_s, INF, returns[None, :])
    minret = ret_masked.min(dim=1).values
    cand = (~in_s) & (invokes[None, :] < minret[:, None]) & valid[:, None]
    n_sym = table.shape[1]
    nxt_state = table.reshape(-1)[states.to(torch.int64)[:, None] * n_sym
                                  + sym.to(torch.int64)[None, :]]
    cand = cand & (nxt_state >= 0)
    ch_h1 = (h1[:, None] ^ z1[None, :]).reshape(-1)
    ch_h2 = (h2[:, None] ^ z2[None, :]).reshape(-1)
    return ch_h1, ch_h2, nxt_state.reshape(-1), cand.reshape(-1)


def _dedup(ch_h1, ch_h2, ch_state, ch_mask):
    """`order`, the permutation of `jnp.lexsort((ch_state, ch_h2, ch_h1,
    ~ch_mask))`, and `keep`: the first child of each distinct (h1, h2,
    state) among the candidates, in sorted order."""
    k1 = (_u32(ch_h2) << 31) | (ch_state.to(torch.int64) + 1)
    o1 = torch.sort(k1, stable=True).indices
    k2 = ((~ch_mask).to(torch.int64) << 32) | _u32(ch_h1)
    s2, o2 = torch.sort(k2[o1], stable=True)
    order = o1[o2]
    s1 = k1[order]
    first = torch.ones_like(ch_mask)
    first[1:] = (s2[1:] != s2[:-1]) | (s1[1:] != s1[:-1])
    return order, (s2 <= _U32) & first


def _compact(order, keep, cap: int):
    """The source child of each of the first `cap` kept rows, and which
    rows hold one: JAX's `take`, the sorted position of the (j+1)-th kept
    child or -1, read with `searchsorted` over the running kept count."""
    N = keep.numel()
    count = torch.cumsum(keep, 0)
    take = torch.searchsorted(
        count, torch.arange(1, cap + 1, device=keep.device))
    valid = take < N
    take = torch.where(valid, take, -1)
    return valid, order[take.clamp(0, N - 1)]


def _children(bits, word, op_bit, valid, src, n: int, ch_h1, ch_h2,
              ch_state, W: int):
    """The compacted frontier: states, bits, h1, h2 of the rows `src`."""
    rows = valid.shape[0]
    p = src // n
    o = src % n
    oh = torch.zeros((rows, W), dtype=torch.int32, device=valid.device)
    oh.index_put_((torch.arange(rows, device=valid.device),
                   word[o].clamp(0, W - 1)), op_bit[o])
    new_bits = torch.where(valid[:, None], bits[p] | oh, 0)
    return (torch.where(valid, ch_state[src], 0), new_bits,
            torch.where(valid, ch_h1[src], 0),
            torch.where(valid, ch_h2[src], 0))


def _frontier_search(n: int, W: int, max_frontier: int, n_waves: int,
                     invokes, returns, op_sym, must, table, z1, z2,
                     init_state: int):
    """Returns (linearizable, exhausted, overflow, waves).

    linearizable: some config covered every must-op.
    exhausted: frontier emptied without success (=> not linearizable).
    overflow: frontier cap exceeded at some wave (result unreliable).
    waves: the waves run (the JAX loop counter `w`).

    Every tensor lies on one device; the wave loop runs on the host and
    reads one packed flag tensor per wave."""
    dev = invokes.device
    F = max_frontier
    ar = np.arange(n)
    word_idx = torch.from_numpy((ar // 32).astype(np.int64)).to(dev)
    bit = torch.from_numpy((ar % 32).astype(np.int32)).to(dev)
    op_bit = torch.ones(n, dtype=torch.int32, device=dev) << bit

    states = torch.zeros(F, dtype=torch.int32, device=dev)
    states[0] = init_state
    bits = torch.zeros((F, W), dtype=torch.int32, device=dev)
    h1 = torch.zeros(F, dtype=torch.int32, device=dev)
    h2 = torch.zeros(F, dtype=torch.int32, device=dev)
    valid = torch.zeros(F, dtype=torch.bool, device=dev)
    valid[0] = True

    def success_of(states, bits, valid):
        covered = ((bits & must[None, :]) == must[None, :]).all(dim=1)
        return (valid & covered).any()

    done = success_of(states, bits, valid)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    w = 0
    d, o, v = torch.stack([done, overflow, valid.any()]).tolist()
    while not d and not o and v and w < n_waves:
        in_s = ((bits[:, word_idx] >> bit) & 1).to(torch.bool)
        ch_h1, ch_h2, ch_state, ch_mask = _expand(
            states, bits, h1, h2, valid, in_s, invokes, returns, op_sym,
            z1, z2, table)
        order, keep = _dedup(ch_h1, ch_h2, ch_state, ch_mask)
        overflow = overflow | (keep.sum() > F)
        valid, src = _compact(order, keep, F)
        states, bits, h1, h2 = _children(bits, word_idx, op_bit, valid,
                                         src, n, ch_h1, ch_h2, ch_state, W)
        done = done | success_of(states, bits, valid)
        w += 1
        d, o, v = torch.stack([done, overflow, valid.any()]).tolist()
    exhausted = (not d) and (not o) and ((not v) or w >= n_waves)
    return bool(d), exhausted, bool(o), w


def _setup(ops: Sequence[LinOp], memo: Memo):
    """Padded arrays shared by both search shapes."""
    n = len(ops)
    n_pad = 8
    while n_pad < n:
        n_pad *= 2
    W = (n_pad + 31) // 32
    # padding ops: invoke at +inf so they are never candidates; returns just
    # above the info-op cap so they never constrain minret below real ops
    invokes = np.full(n_pad, 2 ** 30, np.int32)
    returns = np.full(n_pad, 2 ** 29 + 1, np.int32)
    op_sym = np.zeros(n_pad, np.int32)
    must = np.zeros(W, np.uint32)
    for i, op in enumerate(ops):
        invokes[i] = op.invoke_pos
        returns[i] = min(op.return_pos, 2 ** 29)
        op_sym[i] = memo.op_sym[i]
        if op.return_pos < NEVER:
            must[i // 32] |= np.uint32(1 << (i % 32))
    rng = np.random.default_rng(0xC0FFEE)
    z1 = rng.integers(0, 2 ** 32, n_pad, dtype=np.uint32)
    z2 = rng.integers(0, 2 ** 32, n_pad, dtype=np.uint32)
    return n_pad, W, invokes, returns, op_sym, must, z1, z2


def check(ops: Sequence[LinOp], model: Model,
          max_frontier: int = 16384,
          max_configs: int = 20_000_000, ctl=None,
          device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Device linearizability check of prepared ops against a model, on
    the CUDA card unless `device` names another (``"cpu"``).

    `ctl` (a `search.Search`) aborts the blocked search between waves,
    between blocks, and inside the dominance-prune row loop — a
    competition can cancel this leg, and a deadline bounds it.  Passing
    a ctl also forces the blocked search for small histories: the
    single path is one wave loop that polls nothing, fine standalone
    but not as a cancellable race leg."""
    dev = backend.resolve(device)
    n = len(ops)
    if n == 0:
        return {"valid?": "unknown", "op-count": 0}
    if n > MAX_DEVICE_OPS:
        return {"valid?": "unknown", "op-count": n,
                "reason": "too many ops for device WGL"}
    if ctl is not None and ctl.aborted():
        # an expired/cancelled ctl skips the memoize/setup/transfer cost
        return stamp_abort({"valid?": "unknown", "op-count": n,
                            "reason": "aborted"}, ctl)
    try:
        memo = memoize(model, ops)
    except StateExplosion:
        return {"valid?": "unknown", "op-count": n,
                "reason": "model state explosion"}
    n_pad, W, invokes, returns, op_sym, must, z1, z2 = _setup(ops, memo)
    table = memo.table

    # The single path burns F x n_pad work EVERY wave regardless of
    # frontier occupancy — past ~1k ops a serial history pays thousands
    # of full-width waves and the blocked search (blocks sized to the
    # live frontier) is strictly faster as well as memory-spilled.
    # With a ctl we go blocked regardless of size: a competition loser
    # must stay cancellable.
    if n <= 1024 and ctl is None:
        # guarded device seam: transient failures (or injected faults)
        # retry per policy; persistent ones propagate to the caller
        lin, _, overflow, _ = device_call(
            "knossos.device-wgl", _frontier_search,
            n_pad, W, max_frontier, n + 1,
            _i32(invokes, dev), _i32(returns, dev), _i32(op_sym, dev),
            _i32(must, dev), _i32(table, dev), _i32(z1, dev),
            _i32(z2, dev), memo.init_state)
        if not overflow:
            return {"valid?": True if lin else False, "op-count": n,
                    "hash_dedup": True}
        # fall through: re-run with host-spilled frontier blocks

    return stamp_abort(
        _blocked_search(n, n_pad, W, invokes, returns, op_sym, must,
                        table, memo.init_state, z1, z2,
                        max_frontier, max_configs, ctl, dev), ctl)


def _blocked_and_check(ops: Sequence[LinOp], model: Model,
                       max_frontier: int = 16384,
                       max_configs: int = 20_000_000,
                       ctl=None,
                       device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Route straight to the blocked (host-spill) search — used by tests
    and by callers that know the frontier will overflow."""
    dev = backend.resolve(device)
    n = len(ops)
    if ctl is not None and ctl.aborted():
        return stamp_abort({"valid?": "unknown", "op-count": n,
                            "reason": "aborted"}, ctl)
    try:
        memo = memoize(model, ops)
    except StateExplosion:
        return {"valid?": "unknown", "op-count": n,
                "reason": "model state explosion"}
    n_pad, W, invokes, returns, op_sym, must, z1, z2 = _setup(ops, memo)
    return stamp_abort(
        _blocked_search(n, n_pad, W, invokes, returns, op_sym, must,
                        memo.table, memo.init_state, z1, z2,
                        max_frontier, max_configs, ctl, dev), ctl)


# ---------------------------------------------------------------------------
# Blocked search: host-resident frontier, device per-block expansion.
# ---------------------------------------------------------------------------


def _expand_block(A: int, W: int, F: int, C: int,
                  act_mask, act_invokes, act_returns, act_sym,
                  act_z1, act_z2, act_word, act_bit,
                  table, states, bits, h1, h2, valid):
    """Expand one frontier block of F configs into <= C unique children,
    over a WINDOW of A active ops (gathered on host).

    The window restriction is what makes long histories tractable: at
    wave k, ops linearized in every config and ops not yet invokable
    (invoke >= the (k+1)-th smallest return) can never be candidates, so
    the op axis shrinks from n to the concurrency window.  `minret` over
    active unlinearized ops is exact for the candidate test: excluded ops
    are either linearized (no contribution) or have returns strictly
    above the window bound every candidate's invoke is below.

    Every tensor lies on one device; words are int32 (see the module
    docstring).  Returns (out_states, out_bits, out_h1, out_h2, out_valid,
    n_unique): children deduped within the block; n_unique may exceed C
    (the caller must then split the block and retry — nothing is
    silently dropped)."""
    global EXPAND_CALLS
    EXPAND_CALLS += 1
    dev = states.device
    op_bit = torch.ones(A, dtype=torch.int32, device=dev) << act_bit
    word = act_word.to(torch.int64).clamp(0, W - 1)
    in_s = ((bits[:, word] >> act_bit) & 1).to(torch.bool)
    in_s = in_s | ~act_mask[None, :]
    ch_h1, ch_h2, ch_state, ch_mask = _expand(
        states, bits, h1, h2, valid, in_s, act_invokes, act_returns,
        act_sym.clamp(min=0), act_z1, act_z2, table)
    order, keep = _dedup(ch_h1, ch_h2, ch_state, ch_mask)
    n_unique = keep.sum()
    out_valid, src = _compact(order, keep, C)
    out_states, out_bits, out_h1, out_h2 = _children(
        bits, word, op_bit, out_valid, src, A, ch_h1, ch_h2, ch_state, W)
    return out_states, out_bits, out_h1, out_h2, out_valid, n_unique


class _Aborted(Exception):
    """Raised inside long per-row host loops when `ctl` aborts mid-wave."""


def _blocked_search(n, n_pad, W, invokes, returns, op_sym, must, table,
                    init_state, z1, z2, max_frontier, max_configs,
                    ctl=None, dev: torch.device = None) -> Dict[str, Any]:
    """Breadth-first over waves; frontier spilled to host as block lists.

    Every wave holds configs with the same linearized-count, so the
    cross-wave dedup set only needs the current wave's keys.  Device
    memory is bounded by one (F, n_pad) expansion; host memory holds
    everything else.
    """
    global HOST_WAVES, SPLITS
    # resolve the fault plan once per search, so every block of the
    # expand loop below counts against the same plan
    fault_plan = active_plan()
    F_max = max(64, min(max_frontier, 16384))

    table_dev = _i32(table, dev)
    word_idx_h = (np.arange(n_pad) // 32).astype(np.int32)
    bit_h = (np.arange(n_pad) % 32).astype(np.int32)
    must_row = must[None, :]
    # (k+1)-th smallest real return bounds every wave-k config's minret
    real_rets = np.sort(returns[returns < 2 ** 29])

    # crashed-op dominance prune (see module doc): minimal linearized-
    # crashed bitsets per (state, returned-lin) key.  Engaged only when
    # crashed ops are numerous enough for subset blowup to matter — the
    # per-row host loop costs more than it saves on a near-clean history
    # (blowup is bounded by 2^n_info), and skipping both the prune AND
    # the store is sound: pruning only ever removes simulated configs.
    n_info = int(np.sum(returns[:n] == 2 ** 29))
    use_dominance = n_info >= 3
    info_mask = ~must  # words: bits of crashed (+ padding, always-0) ops
    dom: Dict[bytes, list] = {}

    def dominance_prune(s, b, h1u, h2u):
        """Drop configs whose crashed-lin set is a strict superset of a
        previously kept one at the same (state, returned-lin).  Keeps
        (and records) the survivors.  The store holds a python LIST of
        minimal-X rows per key (append is O(1); antichains stay small).

        Polls `ctl` every 1024 rows: this per-row python loop is the
        longest uninterruptible stretch in a crash-heavy wave, and an
        aborted competition loser must not keep burning the core until
        the wave ends."""
        R = b & must_row
        X = b & info_mask[None, :]
        keep_rows = np.ones(len(s), bool)
        for i in range(len(s)):
            if ctl is not None and i % 1024 == 1023 and ctl.aborted():
                raise _Aborted
            key = s[i].tobytes() + R[i].tobytes()
            stored = dom.get(key)
            xi = X[i]
            if stored is not None:
                # dominated iff some stored X' ⊆ X (strict or equal;
                # equal can't happen across waves, and within a wave the
                # exact dedup already removed duplicates)
                if any(bool(np.all((x & ~xi) == 0)) for x in stored):
                    keep_rows[i] = False
                    continue
                stored.append(xi.copy())
            else:
                dom[key] = [xi.copy()]
        return s[keep_rows], b[keep_rows], h1u[keep_rows], h2u[keep_rows]

    def active_window(blocks, k):
        """Op ids that can still be candidates at wave k: not linearized
        in EVERY config, and invokable below the wave's minret bound."""
        all_ones = np.full(W, 0xFFFFFFFF, np.uint64).astype(np.uint32)
        for st, bi, a1, a2, va in blocks:
            if va.any():
                all_ones &= np.bitwise_and.reduce(bi[va], axis=0)
        everywhere = ((all_ones[word_idx_h] >> bit_h) & 1).astype(bool)
        bound = (real_rets[k] if k < len(real_rets)
                 else np.int64(2 ** 62))
        act = ~everywhere & (invokes < bound)
        return np.nonzero(act)[0].astype(np.int32)

    def cap_of(F, A):
        # one config can have up to A children, so C >= A guarantees a
        # single-row block never needs splitting (split progress)
        return min(max(4 * F, A), F * A)

    def expand_host(act, states, bits, h1, h2):
        """Exact children of a small frontier over the active window —
        the numpy mirror of `_expand_block` (no caps, no splitting)."""
        aw = word_idx_h[act]
        ab = bit_h[act]
        in_s = ((bits[:, aw] >> ab) & 1).astype(bool)          # (m, A)
        ret = np.where(in_s, np.int64(2 ** 30), returns[act][None, :])
        minret = ret.min(axis=1)
        cand = (~in_s) & (invokes[act][None, :] < minret[:, None])
        nxt = table[states[:, None], op_sym[act][None, :]]
        cand &= nxt >= 0
        rows, cols = np.nonzero(cand)
        ch_state = nxt[rows, cols].astype(np.int32)
        ch_h1 = h1[rows] ^ z1[act][cols]
        ch_h2 = h2[rows] ^ z2[act][cols]
        ch_bits = bits[rows].copy()
        ch_bits[np.arange(len(rows)), aw[cols]] |= (
            np.uint32(1) << ab[cols].astype(np.uint32))
        return ch_state, ch_bits, ch_h1, ch_h2

    def pad_block(states, bits, h1, h2, m):
        # right-size the block: a sparse wave (serial history) must not
        # pay full-F_max expansion work
        F = 64
        while F < m and F < F_max:
            F *= 2
        out = (np.zeros(F, np.int32), np.zeros((F, W), np.uint32),
               np.zeros(F, np.uint32), np.zeros(F, np.uint32),
               np.zeros(F, bool))
        out[0][:m] = states[:m]
        out[1][:m] = bits[:m]
        out[2][:m] = h1[:m]
        out[3][:m] = h2[:m]
        out[4][:m] = True
        return out

    # initial frontier: the empty config
    blocks = [pad_block(np.array([init_state], np.int32),
                        np.zeros((1, W), np.uint32),
                        np.zeros(1, np.uint32), np.zeros(1, np.uint32), 1)]
    if bool(np.all((blocks[0][1][:1] & must_row) == must_row)):
        return {"valid?": True, "op-count": n, "hash_dedup": True,
                "blocked": True}

    aborted = {"valid?": "unknown", "op-count": n, "reason": "aborted",
               "hash_dedup": True, "blocked": True}
    total_seen = 0
    for k in range(n + 1):
        if ctl is not None and ctl.aborted():
            return dict(aborted, explored=total_seen)
        # collect every block's (block-deduped) children, then do ONE
        # vectorized cross-block dedup + success check for the wave.
        # Configs in different waves have different popcounts, so no
        # cross-wave seen-set is needed.
        ch_s: List[np.ndarray] = []
        ch_b: List[np.ndarray] = []
        ch_h1: List[np.ndarray] = []
        ch_h2: List[np.ndarray] = []

        act = active_window(blocks, k)
        total_rows = int(sum(b[4].sum() for b in blocks))

        if total_rows <= HOST_EXPAND_MAX and len(act):
            HOST_WAVES += 1
            st = np.concatenate([b[0][b[4]] for b in blocks])
            bi = np.concatenate([b[1][b[4]] for b in blocks])
            a1 = np.concatenate([b[2][b[4]] for b in blocks])
            a2 = np.concatenate([b[3][b[4]] for b in blocks])
            o_st, o_bi, o_h1, o_h2 = expand_host(act, st, bi, a1, a2)
            if len(o_st):
                ch_s.append(o_st)
                ch_b.append(o_bi)
                ch_h1.append(o_h1)
                ch_h2.append(o_h2)
            work = []
        else:
            work = list(blocks)

        A = 8
        while A < len(act):
            A *= 2
        act_mask = np.zeros(A, bool)
        act_mask[:len(act)] = True
        act_pad = np.zeros(A, np.int32)
        act_pad[:len(act)] = act
        win = None
        if work:
            win = (torch.from_numpy(act_mask).to(dev),
                   _i32(invokes[act_pad], dev), _i32(returns[act_pad], dev),
                   _i32(op_sym[act_pad], dev), _i32(z1[act_pad], dev),
                   _i32(z2[act_pad], dev), _i32(word_idx_h[act_pad], dev),
                   _i32(bit_h[act_pad], dev))
        while work:
            if ctl is not None and ctl.aborted():
                return dict(aborted, explored=total_seen)
            st, bi, a1, a2, va = work.pop()
            F = len(st)
            C = cap_of(F, A)
            outs = device_call(
                "knossos.device-wgl.expand", _expand_block,
                A, W, F, C, *win, table_dev,
                _i32(st, dev), _i32(bi, dev), _i32(a1, dev), _i32(a2, dev),
                torch.from_numpy(va).to(dev), plan=fault_plan)
            o_st, o_bi, o_h1, o_h2, o_va, n_uniq = (x.cpu().numpy()
                                                    for x in outs)
            if int(n_uniq) > C:
                # children overflow the output capacity: split the block
                # rows in half and re-expand — exact, never truncating
                SPLITS += 1
                half = max(1, int(va.sum()) // 2)
                idx = np.nonzero(va)[0]
                lo, hi = idx[:half], idx[half:]
                for part in (lo, hi):
                    if len(part):
                        work.append(pad_block(st[part], bi[part],
                                              a1[part], a2[part],
                                              len(part)))
                continue
            m = o_va
            ch_s.append(o_st[m])
            ch_b.append(o_bi.view(np.uint32)[m])
            ch_h1.append(o_h1.view(np.uint32)[m])
            ch_h2.append(o_h2.view(np.uint32)[m])

        if not ch_s or not sum(len(x) for x in ch_s):
            return {"valid?": False, "op-count": n, "hash_dedup": True,
                    "blocked": True}
        if ctl is not None and ctl.aborted():
            return dict(aborted, explored=total_seen)
        s = np.concatenate(ch_s)
        b = np.concatenate(ch_b)
        h1_all = np.concatenate(ch_h1)
        h2_all = np.concatenate(ch_h2)
        key = (h1_all.astype(np.uint64) << np.uint64(32)) | h2_all
        order = np.lexsort((s, key))
        sk = key[order]
        ss = s[order]
        first = np.concatenate([[True],
                                (sk[1:] != sk[:-1]) | (ss[1:] != ss[:-1])])
        uniq = order[first]
        s, b = s[uniq], b[uniq]
        h1u = h1_all[uniq]
        h2u = h2_all[uniq]

        if bool(np.all((b & must[None, :]) == must[None, :],
                       axis=1).any()):
            return {"valid?": True, "op-count": n, "hash_dedup": True,
                    "blocked": True}
        if use_dominance:
            try:
                s, b, h1u, h2u = dominance_prune(s, b, h1u, h2u)
            except _Aborted:
                return dict(aborted, explored=total_seen)
            if not len(s):
                return {"valid?": False, "op-count": n,
                        "hash_dedup": True, "blocked": True}
        total_seen += len(s)
        if total_seen > max_configs:
            return {"valid?": "unknown", "op-count": n,
                    "reason": "config budget exhausted",
                    "explored": total_seen, "hash_dedup": True,
                    "blocked": True}
        blocks = [pad_block(s[i:], b[i:], h1u[i:], h2u[i:],
                            min(F_max, len(s) - i))
                  for i in range(0, len(s), F_max)]
    return {"valid?": False, "op-count": n, "hash_dedup": True,
            "blocked": True}
