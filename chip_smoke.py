"""Drive the PyTorch/H100 port (`jepsen_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

`--parent DIR` names an unpacked checkout of another commit (for example
`git archive <parent> | tar -x -C build/parent`): phase 2 then also times
that commit's kernel wrappers (`ops/fill.locf_cuda`, `ops/scan.seg_or_cuda`)
against this tree's in turns (parent, change, change, parent) on the same
inputs, after checking that both give the same bits.

Phases, each asserting; any failure exits non-zero:
  0. environment: the card's name and power limit (no card: exit 2);
  1. build the hand-written CUDA kernels from `jepsen_tpu_torch/csrc/`;
  2. each kernel against its plain PyTorch version on the card, bit for
     bit, twice back to back, at the main path's shapes and at the edges
     of the look-back (seg-OR inclusive and exclusive), with its time, the
     plain version's, the bound, and the one-call library yardstick where
     there is one; seg-OR's fused exclusive call against the exclusive
     scan composed of a shift, a `where` and the inclusive kernel;
  3. the main path at full width: the bench's 1M-txn list-append history
     through `pad_packed` and `core_check` (one warm-up, three timed runs),
     valid verdict bits, 14 forward-fill launches per check, and
     `torch.cummax` left only in `segmented_cummax` (2 calls);
  4. the same history with 64 seeded stale reads through
     `core_check_exact`: G-single cycles in projections 2-4, converged,
     14 forward-fill launches, the segmented-OR kernel's launches;
  5. card == CPU on every `infer` array and on `core_check_exact` for a
     65,536-txn stale-read history;
  6. the checker API, `list_append.check`, on the card:
     a. the 1M-txn valid history under strict serializability (one
        warm-up, three timed calls): valid, no anomaly, not degraded, 14
        forward-fill and no segmented-OR launches per call, and its time
        beside phase 3's `core_check`;
     b. the stale-read corpus of phase 4 under strong snapshot isolation
        at 65,536 txns: a G-single-family anomaly with explained cycles,
        segmented-OR launches, and the check's time split into pad, infer,
        sweeps and host classification (witness BFS, cycle search,
        rendering);
     c. card == CPU: the whole result dict of 6b's check against the same
        check on the CPU;
     d. two op histories built with the port's `history` module (a G1c
        pair; G1a, G1b and internal) with their anomaly types, card ==
        CPU;
  7. the rw-register checker (BASELINE config 3) and `HistoryIR`:
     a. config 3, `packed_rw_history(1M, n_keys=125,000, **RW_KW)`, through
        `rw_register.check(..., ["snapshot-isolation"])` (one warm-up,
        three timed calls): valid, fused, not degraded, no launch of
        either kernel (no fill on the rw path, no backward edge to sweep),
        each call split into `pad_packed`, `infer_rw`, the five-projection
        sweep and the version sweep, peak device memory; then
        `rw_core_check` alone on the padded history, its bits and time
        beside phase 3's `core_check`;
     b. 64 stale reads (`stale_reads_rw`) in the same history through
        `device_rw.check`: invalid, exact, a cycle in the realtime
        projection, segmented-OR launches;
     c. the full report: the same corpus at 131,072 txns (65,536 if that
        takes over 120 s) through `rw_register.check` under strong
        snapshot isolation: G-single-family cycles, every edge explained,
        the time split into fused path, sweeps, witness BFS, `find_cycle`,
        rendering and the rest (host inference);
     d. card == CPU: the whole result dict of `rw_register.check` on a
        16,384-txn stale-read history (fused path first), every `infer_rw`
        array and the `rw_core_check` outputs at 65,536 txns, and
        `rw_core_check` on three op histories (one with cyclic versions);
     e. two `list_append.check` calls on one `HistoryIR` of phase 3's
        history: the first pads, the second calls `pad_packed` zero times;
        both times and the IR's `build_s`;
  8. Knossos linearizability (BASELINE config 1, `lin_register_history(
     n_ops=1000, concurrency=10, seed=0)`: 887 ops, 61 crashed) on the
     card; `device_wgl` is plain torch and launches neither kernel:
     a. config 1 through `check_safe(Linearizable(cas_register()))` and
        `compose` with `Stats`: valid, the winning leg and the wall time
        (a host leg usually wins the race), and the native C++ search
        called (`native.CALLS` > 0); `wgl.check` alone on the native
        search and on the Python one (`JT_NO_NATIVE=1`), the same verdict,
        both times; and 7c's time, whose host inference runs the native
        Tarjan;
     b. the same generator without crashed ops (867 ops) through
        `analysis(algorithm="device")`, the single path over its whole
        length (one warm-up, three timed calls, one if the warm-up takes
        over 30 s): valid, its waves, time per call and per wave, peak
        device memory; the stale-read variant against the host
        `wgl.check` (and under the profiler: device time and idle share);
        one wave's compaction timed as JAX writes it (a `scatter_reduce_`)
        and as the port reads it (`searchsorted`), the same rows;
        `_frontier_search` alone on 8a's history, which overflows its
        16,384-row frontier, and the wave at which it did;
     c. `_blocked_and_check` on a 258-op, 20-process history whose waves
        pass `HOST_EXPAND_MAX` rows: `_expand_block` calls on the card
        (more than 0), splits, waves expanded on the host, the verdict
        against the host `wgl.check`;
     d. card == CPU: the `device_wgl.check` dict of a 200-op history
        (`max_frontier` 1024), and the six outputs of 8c's widest
        `_expand_block` call, bit for bit;
  9. the invariants checkers and the closed predicate on the card, on
     corpora made by copies of `tests/test_invariants.py`'s generators.
     Each of a-d runs one warm-up and three timed calls (one above 5 s) on
     one `HistoryIR`, so that only the warm-up packs and infers, and
     prints the times, the pack and `infer_rw` builds, the device part
     (`with_fallback`'s call) and the sweeps per timed call, and peak
     device memory; each injected corpus runs once; every verdict and anomaly
     set is the host twin's (`use_device=False`):
     a. bank, `jepsen.tests.bank`'s defaults (8 accounts, total 100,
        transfers of at most 5), 200,000 ops: valid, and each of the
        wrong-total and negative-balance injections; then a `PackedBank`
        of 1,000,000 reads x 8 accounts (64 MB int64), valid and with
        both anomalies;
     b. long fork, `lf_history(groups=256, group_size=4, n_reads=50,000)`
        (1,024 keys): valid and `inject_long_fork`;
     c. write skew, `ws_history(pairs=512, n_txns=100,000)`: valid and
        `inject_write_skew`;
     d. session, `sess_history(n_keys=64, n_txns=100,000)` with pinned
        keys and without: valid and `inject_session_break`, two LOCF
        launches per check; `predicate.check` on the same `HistoryIR`,
        `infer_rw` run once for both;
     e. the seven closed-predicate histories of
        `tests/test_closed_predicate.py`;
     f. card == CPU: the whole result dict of a-e, at full size where the
        CPU run takes seconds and at 20,000 txns for the injected write
        skew and the unpinned session.
 10. the queue/kafka checker family on the card, on copies of
     `tests/test_queue_checkers.py`'s corpus builders (`sim_kafka`,
     `sim_mem_queue`); `_math` is plain torch and launches neither kernel.
     Every dict equals the host twin's (`use_device=False`):
     a. kafka, `sim_kafka(0, ops=500,000, n_clients=10)` with the tests'
        generator knobs, through `kafka.check` on one `HistoryIR` (one
        warm-up, three timed calls): valid, not degraded; the simulator's
        time, `build_s["queue:kafka"]`, the device part of each call
        (`with_fallback`'s), peak device memory, and whether JAX's
        `device_safe` bound would have sent the history to the host;
     b. 50,000 ops with each of the six adversarial knobs at 0.002, and
        with frozen commits (seeds in order until `stale-consumer-group`
        shows); at 25,000 ops the card == the scan twin `KafkaChecker`;
     c. the total queue, `sim_mem_queue(0, ops=500,000)` drained: valid
        with `fifo=False` and `fifo=True`; `lose_enqueue_p` gives
        `queue-lost`, `dup_enqueue_p` `queue-phantom`, and
        `reorder_dequeue_p` `queue-fifo-violation` with `fifo=True` only;
     d. the int64 route: `sim_kafka(0, ops=86,000)`, whose epoch codes
        pass 2^30 (JAX's `device_safe` is False), runs on the card and
        equals `host_verdict`;
 11. BASELINE config 4 on the card: `packed_la_history(10M,
     n_keys=1,250,000)` in one `HistoryIR`, `ir.padded()` (T = 2^24,
     M = 2^26, R = 2^28):
     a. `core_check` (one warm-up, three timed runs): valid bits, 14
        forward-fill launches per check, txns/s, peak device memory, the
        generation and pad times;
     b. each kernel once against its plain version, bit for bit: LOCF on
        11a's largest fill input (n = 2^28), seg-OR inclusive and
        exclusive on a seeded (2^25, 128) int8 plane (2^32 elements);
     d. `list_append.check(ir, ["strict-serializable"])` once: valid, not
        degraded, no `pad_packed` call;
     c. 64 stale reads, `core_check_exact` from `max_k` 32 (at 128 the
        sweep asks for more than the card holds): G-single cycles in
        projections 2-4, converged; the budget of each sweep, seg-OR
        launches, time and peak device memory.
 12. BASELINE config 5 on one card: 16 of its 100 histories, each
     `packed_la_history(1M, n_keys=125,000, mops_per_txn=4,
     read_frac=0.25, seed=i)` (`scripts/config5_batch.py`'s generator and
     key rule), every 4th with a failed writer (`seed_invalid`, a copy of
     that script's) and history 2 with 64 stale reads:
     a. `parallel.batch.check_batch_checkpointed` in groups of 8, whose
        `on_group` raises after the first durable group (the simulated
        crash); the call again resumes and computes group 1 only; the
        failed writers and the stale reads invalid, the rest valid, all
        exact, and every row's dict equal to the same history alone
        through `pad_packed` and `core_check_exact`;
     b. each group's wall time split into the pad (host, with the copy
        of the stack to the card) and the card, txns/s over the 16M txns,
        peak device memory and the launches of both kernels;
     c. card == CPU: `check_batch` of 4 histories of 65,536 txns (two
        valid, a failed writer, stale reads);
 13. a stored run streamed to the card through `store` and
     `checkers.elle.stream`:
     a. `synth.la_history(n_txns=100,000, n_keys=12,500, concurrency=10)`
        (200,000 ops) saved with `store.save_0` into a temporary store and
        checked by `stream.check_stored`: valid, equal to `core_check_exact`
        on `pad_packed(pack_txns(h))`; the save, the staging (decode,
        pack and copies) against the decode and pack alone, the check,
        the chunks, peak device memory and launches;
     b. the same history with `inject_wr_cycle`: invalid, G1c;
     c. `rw_history(n_txns=50,000)` through
        `check_stored(workload="rw-register")`, equal to `device_rw.check`;
     d. card == CPU at 16,384 txns: every staged array and the dicts of
        both routes.
The launch counters are set to 0 just before the checks of phase 3, just
before `core_check_exact` in phase 4, just before each `check` of phase
6a and 6b, each counted call of phase 7, each check on the card of phase
9, each counted check of phase 11, the first `check_batch_checkpointed`
call of phase 12 and each `check_stored` of 13a-13c, and read just after
each (phase 12: after the resumed call); the kernels' `launches` are
their sum (phases 8 and 10 assert that they launch neither).  The command's total time,
the card's name and power limit, and a JSON object with one entry per
kernel come before the last line, `{"ok": true, "device": {...}}`.
Longer output (the profiler's tables) goes to `chiprun_out/`.

Imports `torch`, `numpy` and the port; never `jax` or `jepsen_tpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

N_TXNS = 1_000_000          # the bench ladder's top rung (bench.py)
N_KEYS = N_TXNS // 8        # bench.py's key count for that rung
N_STALE = 64
N_SMALL = 65_536
G_SINGLE_FAMILY = {"G-single", "G-single-process", "G-single-realtime"}
#: the stale-read checks' model: it proscribes the G-single family and not
#: G-nonadjacent, whose budgeted simple-cycle search on the host holds a
#: check for minutes (PERF.md)
STALE_MODELS = ["strong-snapshot-isolation"]
LOCF_PER_CHECK = 14          # forward fills in `infer` when n_keys > 1 and
                             # both monotone layout facts hold
MOP_APPEND, MOP_READ = 0, 1  # jepsen_tpu_torch.history.soa's
RW_STALE_WINDOW = 256        # stale_reads_rw: reads at most this many txns
                             # after the write they observed
N_REPORT = 131_072           # 7c: the first power of two above
                             # rw_register.FUSED_MIN_TXNS
N_REPORT_SMALL = 65_536      # ... and its size when that takes too long
REPORT_LIMIT_S = 120.0
N_CMP = 16_384               # 7d: the card == CPU result dicts
#: 8a/8b: BASELINE config 1, "Knossos :linear checker on single CAS-register
#: history (1k ops, etcd register test)", as `lin_register_history` builds it
LIN_KW = dict(n_ops=1000, concurrency=10, seed=0)
LIN_STALE = 0.01             # 8b: stale-read rate the host WGL rejects
LIN_WIDE = dict(n_ops=300, concurrency=20, info_prob=0.0, seed=0)  # 8c
LIN_CMP = dict(n_ops=200, concurrency=10, info_prob=0.0, seed=1)   # 8d
CMP_FRONTIER = 1024          # 8d: the single path's frontier on both sides
FRONTIER = 16384             # device_wgl.check's default max_frontier
ONE_CALL_S = 30.0            # 8b: above this a warm-up, one timed call
COMPACT_WAVE = 100           # 8b: the stale search's wave whose compaction
                             # is timed both ways (it runs 137)
#: 9a: jepsen.tests.bank's defaults: 8 accounts holding 100 in all (12 or
#: 13 each), transfers of at most 5; 200,000 ops give about 100,000 reads
BANK_KW = dict(n_ops=200_000, n_accounts=8, balance=[13] * 4 + [12] * 4,
               seed=0, max_transfer=5)
BANK_TEST = {"total-amount": 100}
N_BANK_READS = 1_000_000     # 9a: the reduction at scale, a PackedBank
LF_KW = dict(groups=256, group_size=4, n_reads=50_000, seed=0)     # 9b
WS_KW = dict(pairs=512, n_txns=100_000, seed=0)                    # 9c
SESS_KW = dict(n_keys=64, n_txns=100_000, seed=0)                  # 9d
N_INV_CMP = 20_000           # 9f: txns where the CPU twin takes seconds
INV_ONE_CALL_S = 5.0         # 9: above this a warm-up, one timed call
#: 10: the kafka corpus's generator knobs (tests/test_queue_checkers.py)
KAFKA_GEN = dict(key_count=3, crash_frac=0.05, subscribe_frac=0.5,
                 txn_frac=0.3)
#: 10a: about what a long Jepsen kafka run records: 10 workers for about
#: 15 minutes at about 550 ops/s
KAFKA_FULL = dict(ops=500_000, n_clients=10)
KAFKA_KNOBS = ("lose_tail_p", "dup_p", "dup_send_p", "reorder_p",
               "zombie_p", "torn_p")
KAFKA_INJECT_P = 0.002       # 10b: each knob's rate
KAFKA_INJECT_OPS = 50_000
#: 10b: what those knobs give at 50,000 ops (the frozen run adds
#: stale-consumer-group)
KAFKA_INJECTED = ("duplicate", "inconsistent-offsets", "int-send-skip",
                  "lost-write", "nonmonotonic-send")
KAFKA_TWIN_OPS = 25_000      # 10b: the scan twin grows too fast for more
QUEUE_OPS = 500_000          # 10c
QUEUE_INJECT_P = 0.001
INT64_OPS = 86_000           # 10d: the smallest sim_kafka(0, ops=n), n a
                             # multiple of 1,000, whose epoch codes pass 2^30
#: 11: BASELINE config 4 ("ops/sec verified on 10M-op history"), with
#: bench.py's key rule; `ir.padded()` gives T = 2^24, M = 2^26 and
#: R = 2^28 (the history's reads hold about 1.5e8 elements)
N_10M = 10_000_000
N_KEYS_10M = N_10M // 8
SHAPES_10M = (1 << 24, 1 << 26, 1 << 28)
#: 11c: the sweep's first backward-edge budget.  At the default 128 the
#: stale check asks for more than the card's 80 GB (the relax pass gathers
#: a (3 * 2^26, 128) int8 plane, 24 GiB); 32 is scripts/tpu_10m.py's, and
#: `core_check_exact` grows it while the sweep overflows
MAX_K_10M = 32
N_C5 = 16                    # 12: of BASELINE config 5's 100 histories
C5_GROUP = 8                 # check_batch_checkpointed's group size
C5_KW = dict(mops_per_txn=4, read_frac=0.25)   # scripts/config5_batch.py
C5_INVALID_EVERY = 4         # every 4th history carries a failed writer
C5_STALE_AT = 2              # ... and this one N_STALE stale reads
N_C5_CMP = 65_536            # 12c: card == CPU on 4 histories this size
#: 13a: 100,000 txns, half the size first planned: at 200,000 the whole
#: script took 876.5 s of its 1,200 s on one NVIDIA H100 80GB HBM3 host,
#: phase 13 187.5 s of it, most of that the Python decode and pack of the
#: stored ops (PERF.md)
STREAM_KW = dict(n_txns=100_000, n_keys=12_500, concurrency=10, seed=0)
STREAM_RW_KW = dict(n_txns=50_000, n_keys=6_250, concurrency=10, seed=0)
N_STREAM_CMP = 16_384        # 13d: card == CPU

T_START = time.perf_counter()

# Published device-memory rates (NVIDIA data sheets), bytes/s, and the
# int32 rate outside the tensor cores (half the 67 TFLOP/s float32 rate:
# Hopper has 64 INT32 lanes per SM against 128 FP32 lanes).
MEM_RATE = {"H100 PCIe": 2.0e12, "H100": 3.35e12}
INT32_RATE = 33.5e12


def stale_reads(p, n_reads: int = N_STALE, seed: int = 0):
    """A copy of PackedTxns `p` in which `n_reads` seeded reads miss their
    last element: each becomes a stale read, whose reader then
    anti-depends (rw) on a writer that committed before it — a backward
    edge, and a G-single cycle where the writer reaches the reader.
    Candidates are reads with at least one element and no earlier append
    to their key in their own txn, so that no read misses its own write
    (an `internal` anomaly besides the cycles)."""
    rng = np.random.default_rng(seed)
    m = len(p.mop_txn)
    order = np.lexsort((np.arange(m), p.mop_key, p.mop_txn))
    t, k = p.mop_txn[order], p.mop_key[order]
    app = (p.mop_kind[order] == MOP_APPEND).astype(np.int64)
    run_start = np.r_[True, (t[1:] != t[:-1]) | (k[1:] != k[:-1])]
    before = np.cumsum(app) - app                  # appends before, global
    before -= before[run_start][np.cumsum(run_start) - 1]  # ... in the run
    own_append_before = np.empty(m, bool)
    own_append_before[order] = before > 0
    cand = np.nonzero((p.mop_kind == MOP_READ) & (p.mop_rd_len >= 1)
                      & ~own_append_before)[0]
    pick = rng.choice(cand, size=min(n_reads, len(cand)), replace=False)
    q = dataclasses.replace(p, mop_rd_len=p.mop_rd_len.copy())
    q.mop_rd_len[pick] -= 1
    return q


def stale_reads_rw(p, n_reads: int = N_STALE, seed: int = 0,
                   window: int = RW_STALE_WINDOW):
    """A copy of rw-register PackedTxns `p` in which `n_reads` seeded
    external reads return the version before the one they observed: reads
    of their key's first version, written by an earlier txn at most
    `window` txns before, return the key's initial state (nil) instead.

    rw-register infers version orders only from the initial state and from
    txn-internal structure, so a read of an older *written* version has no
    anti-dependency out of it and no checker can see it (both packages
    call such a history valid).  The initial state precedes every version:
    the stale reader anti-depends (rw) on the writer that committed before
    it, a backward edge that process or real-time order closes into a
    G-single cycle.  The window keeps each cycle's region small for the
    host classification.  As in `stale_reads`, a read whose txn writes
    its key is skipped: candidates are the only mop of their (txn, key)
    run."""
    rng = np.random.default_rng(seed)
    m = len(p.mop_txn)
    order = np.lexsort((np.arange(m), p.mop_key, p.mop_txn))
    t, k = p.mop_txn[order], p.mop_key[order]
    run_start = np.r_[True, (t[1:] != t[:-1]) | (k[1:] != k[:-1])]
    alone = np.empty(m, bool)
    alone[order] = run_start & np.r_[run_start[1:], True]
    w = np.nonzero(p.mop_kind == MOP_APPEND)[0]
    first = w[np.unique(p.mop_key[w], return_index=True)[1]]
    is_first = np.zeros(p.n_vals, bool)
    is_first[p.mop_val[first]] = True
    w_txn = np.zeros(p.n_vals, np.int64)
    w_txn[p.mop_val[w]] = p.mop_txn[w]
    v = np.maximum(p.mop_val, 0)
    cand = np.nonzero((p.mop_kind == MOP_READ) & (p.mop_val >= 0) & alone
                      & is_first[v] & (p.mop_txn - w_txn[v] <= window))[0]
    pick = rng.choice(cand, size=min(n_reads, len(cand)), replace=False)
    q = dataclasses.replace(p, mop_val=p.mop_val.copy())
    q.mop_val[pick] = -1
    return q


def log(*args):
    print(*args, flush=True)


def call_ms(fn, reps: int = 10) -> float:
    """Median device time of `fn()` over `reps` calls, CUDA events around
    each, after two warm-up calls: for the plain versions, which take
    milliseconds and allocate as they go."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms(fn, reps: int = 20) -> float:
    """Device time of one `fn()`: `reps` calls captured in a CUDA graph
    after two warm-up calls, the median of 7 replays (CUDA events around
    each) over `reps`.  Replaying the graph keeps the host's launch gaps
    out of the time, which at the main path's sizes are as long as the
    kernels.  Inputs of 32 MiB or less stay in L2 across the replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def in_turns(parent, change) -> tuple[list[float], list[float]]:
    """parent, change, change, parent: the two times of each."""
    t = [cuda_ms(parent), cuda_ms(change), cuda_ms(change), cuda_ms(parent)]
    return [t[0], t[3]], [t[1], t[2]]


def load_parent(root: str):
    """The `ops.fill` and `ops.scan` modules of the checkout at `root`,
    imported beside this tree's under the same package name: this tree's
    modules are set aside while the parent's load, then put back."""
    def ours():
        return [m for m in sys.modules if m == "jepsen_tpu_torch"
                or m.startswith("jepsen_tpu_torch.")]

    saved = {m: sys.modules.pop(m) for m in ours()}
    sys.path.insert(0, os.path.abspath(root))
    try:
        from jepsen_tpu_torch.ops import fill, scan
        return fill, scan
    finally:
        sys.path.pop(0)
        for m in ours():
            del sys.modules[m]
        sys.modules.update(saved)


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    raise SystemExit(f"no published memory rate for {name!r}")


def bound(n_bytes: int, n_ops: int, rate: float) -> tuple[float, str]:
    t_bytes = n_bytes / rate * 1e3
    t_ops = n_ops / INT32_RATE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="checkout of another commit to time in turns")
    opts = ap.parse_args(argv)
    # ---- 0. environment ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from jepsen_tpu_torch.checkers.elle import device_core, device_infer
    from jepsen_tpu_torch.ops import fill, kernels, scan
    from jepsen_tpu_torch.workloads.synth import packed_la_history

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[0] device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)
    rate = mem_rate(name)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    log(f"[1] built {os.path.basename(so)} in "
        f"{time.perf_counter() - t0:.2f} s")
    if opts.parent:
        t0 = time.perf_counter()
        p_fill, p_scan = load_parent(opts.parent)
        p_fill.kernels.lib()
        log(f"[1] built the parent's kernels ({opts.parent}) in "
            f"{time.perf_counter() - t0:.2f} s")
    ab = {}

    def parent_vs_change(case, parent, change):
        assert torch.equal(parent(), change()), case
        ab[case] = in_turns(parent, change)
        (p0, p1), (c0, c1) = ab[case]
        log(f"[2] in turns {case}: parent {p0:.4f} / {p1:.4f} ms, change "
            f"{c0:.4f} / {c1:.4f} ms")

    # ---- 2. kernels vs plain, bit for bit, at the main path's shapes ------
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"locf": 0, "seg_or": 0}

    def same(kname, case, got, want):
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        errs[kname] = max(errs[kname], err)
        assert err == 0 and torch.equal(got, want), (kname, case, err)
        log(f"[2] {kname} {case}: equal")

    def holes(n, density, monotone=False):
        keep = torch.rand(n, device=dev, generator=gen) < density
        vals = torch.randint(0, 1 << 30, (n,), device=dev, generator=gen,
                             dtype=torch.int32)
        if monotone:
            vals = torch.sort(vals).values
        return torch.where(keep, vals, -1).to(torch.int32)

    def twice(kname, case, kernel, plain, *args, **kw):
        # back to back, so a status word or tile counter left over from
        # the first launch would show in the second
        want = plain(*args, **kw)
        for run in ("", " (again)"):
            same(kname, case + run, kernel(*args, **kw), want)

    n_fill = 1 << 24        # R at 1M txns: 9 of the 14 fills per check
    tile = fill.TILE
    one_in_tile0 = torch.full((n_fill,), -1, dtype=torch.int32, device=dev)
    one_in_tile0[tile // 2] = 7
    locf_cases = {
        "random holes": holes(n_fill, 0.3),
        "monotone seeds": holes(n_fill, 0.05, monotone=True),
        "all holes": torch.full((n_fill,), -1, dtype=torch.int32,
                                device=dev),
        "no holes": holes(n_fill, 1.0),
        "value at each tile boundary": torch.where(
            torch.arange(n_fill, device=dev) % tile == 0,
            torch.arange(n_fill, device=dev, dtype=torch.int32), -1
        ).to(torch.int32),
        "one value, in tile 0 only": one_in_tile0,
        "ragged n = 2^24 - 1234": holes(n_fill - 1234, 0.01),
        "unaligned view, n = 2^24 - 1": holes(n_fill, 0.001)[1:],
        "n = 1": holes(1, 1.0),
        "n = 1000 < one tile": holes(1000, 0.1),
    }
    for case, x in locf_cases.items():
        twice("locf", case, fill.locf_cuda, fill.locf_plain, x)
    x = locf_cases["monotone seeds"]
    same("locf", "monotone seeds == torch.cummax", fill.locf_cuda(x),
         torch.cummax(x, 0).values)
    locf_b, locf_by = bound(8 * n_fill, n_fill, rate)
    locf_t = {
        "ms": cuda_ms(lambda: fill.locf_cuda(x)),
        "plain_ms": call_ms(lambda: fill.locf_plain(x)),
        "library_ms": cuda_ms(lambda: torch.cummax(x, 0)),
        "bound_ms": locf_b, "bound_by": locf_by,
    }
    xr = locf_cases["random holes"]
    log(f"[2] locf n=2^24 monotone seeds: kernel {locf_t['ms']:.4f} ms, "
        f"plain {locf_t['plain_ms']:.4f} ms, torch.cummax "
        f"{locf_t['library_ms']:.4f} ms, bound {locf_b:.4f} ms ({locf_by}); "
        f"random holes: kernel {cuda_ms(lambda: fill.locf_cuda(xr)):.4f} ms")
    for lg, what in ((21, "O"), (22, "M")):  # the other fills of a check
        xs = x[:1 << lg].contiguous()
        twice("locf", f"monotone seeds n=2^{lg}", fill.locf_cuda,
              fill.locf_plain, xs)
        b_s, _ = bound(8 << lg, 1 << lg, rate)
        log(f"[2] locf n=2^{lg} ({what}) monotone seeds: kernel "
            f"{cuda_ms(lambda: fill.locf_cuda(xs)):.4f} ms (in L2 across "
            f"the replays), HBM bound {b_s:.4f} ms; torch.cummax "
            f"{cuda_ms(lambda: torch.cummax(xs, 0)):.4f} ms")
        if opts.parent:
            parent_vs_change(f"locf n=2^{lg} monotone seeds",
                             lambda: p_fill.locf_cuda(xs),
                             lambda: fill.locf_cuda(xs))
    if opts.parent:
        for case in ("monotone seeds", "random holes", "all holes"):
            xc = locf_cases[case]
            parent_vs_change(f"locf n=2^24 {case}",
                             lambda: p_fill.locf_cuda(xc),
                             lambda: fill.locf_cuda(xc))

    n_rows, k = 1 << 21, 128     # 2T chain rows at 1M txns, default max_k
    tile_rows = scan.seg_or_geometry(n_rows, k).tile_rows

    def plane(n, kk):
        return (torch.rand(n, kk, device=dev, generator=gen) < 0.05) \
            .to(torch.int8)

    def starts(n, p, first=True):
        s = torch.rand(n, device=dev, generator=gen) < p
        s[0] = first
        return s

    v = plane(n_rows, k)
    one_seg = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    one_seg[0] = True
    last_tile_only = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    last_tile_only[n_rows - tile_rows // 2] = True
    seg_cases = {
        "random starts": (v, starts(n_rows, 0.01)),
        "single segment": (v, one_seg),
        "every row a start": (v, torch.ones(n_rows, dtype=torch.bool,
                                            device=dev)),
        "starts at tile boundaries": (
            v, torch.arange(n_rows, device=dev) % tile_rows == 0),
        "first start only in the last tile": (v, last_tile_only),
        "ragged n = 2^21 - 77, row 0 no start": (
            v[:n_rows - 77], starts(n_rows - 77, 0.001, first=False)),
        "n = 1": (plane(1, k), starts(1, 0.0, first=False)),
        "n = 100 < one tile": (plane(100, k), starts(100, 0.05)),
    }
    for kk in (1, 16, 100, 777, 8192):
        seg_cases[f"K={kk} n=4099"] = (plane(4099, kk), starts(4099, 0.02))
    for case, (vv, ss) in seg_cases.items():
        for excl in (False, True):
            twice("seg_or", f"{case}{' exclusive' if excl else ''}",
                  scan.seg_or_cuda, scan.seg_or_plain, vv, ss,
                  exclusive=excl)
    vv, ss = seg_cases["random starts"]
    seg_b, seg_by = bound(2 * n_rows * k + n_rows, n_rows * k, rate)

    def exclusive_composed(seg_or_cuda=scan.seg_or_cuda):
        # the exclusive scan as a shift, a zeroing of the start rows and
        # the inclusive kernel, which the fused call replaces
        shifted = torch.cat([torch.zeros_like(vv[:1]), vv[:-1]])
        return seg_or_cuda(
            torch.where(ss[:, None], torch.zeros_like(shifted), shifted), ss)

    same("seg_or", "exclusive, composed == fused", exclusive_composed(),
         scan.seg_or_cuda(vv, ss, exclusive=True))
    seg_t = {
        "ms": cuda_ms(lambda: scan.seg_or_cuda(vv, ss)),
        "plain_ms": call_ms(lambda: scan.seg_or_plain(vv, ss)),
        "library_ms": None,
        "bound_ms": seg_b, "bound_by": seg_by,
        "exclusive_ms": cuda_ms(
            lambda: scan.seg_or_cuda(vv, ss, exclusive=True)),
        "exclusive_composed_ms": cuda_ms(exclusive_composed),
    }
    v1 = seg_cases["single segment"]
    log(f"[2] seg_or (2^21, 128) random starts: kernel {seg_t['ms']:.4f} ms, "
        f"exclusive {seg_t['exclusive_ms']:.4f} ms, exclusive composed "
        f"(cat + where + kernel) {seg_t['exclusive_composed_ms']:.4f} ms, "
        f"plain {seg_t['plain_ms']:.4f} ms, bound {seg_b:.4f} ms ({seg_by}); "
        f"single segment: kernel "
        f"{cuda_ms(lambda: scan.seg_or_cuda(*v1)):.4f} ms")
    if opts.parent:
        for case in ("random starts", "single segment"):
            vc, sc = seg_cases[case]
            parent_vs_change(f"seg_or (2^21, 128) {case}",
                             lambda: p_scan.seg_or_cuda(vc, sc),
                             lambda: scan.seg_or_cuda(vc, sc))
        parent_vs_change(
            "seg_or (2^21, 128) exclusive: parent's composition vs fused",
            lambda: exclusive_composed(p_scan.seg_or_cuda),
            lambda: scan.seg_or_cuda(vv, ss, exclusive=True))
        seg_t["in_turns_ms"] = ab["seg_or (2^21, 128) random starts"]
        locf_t["in_turns_ms"] = ab["locf n=2^24 monotone seeds"]
    del locf_cases, seg_cases, v, vv, ss, v1, x, xr, one_in_tile0
    torch.cuda.empty_cache()

    # ---- 3. main path, full width -----------------------------------------
    t0 = time.perf_counter()
    p = packed_la_history(N_TXNS, n_keys=N_KEYS, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = device_infer.pad_packed(p, device=dev)
    torch.cuda.synchronize()
    t_pad = time.perf_counter() - t0
    log(f"[3] {N_TXNS} txns, {N_KEYS} keys: generated in {t_gen:.2f} s, "
        f"padded + staged in {t_pad:.2f} s (T={h.txn_type.shape[0]}, "
        f"M={h.mop_txn.shape[0]}, R={h.rd_elems.shape[0]}, V={h.v_cap}, "
        f"O={h.o_cap})")

    fill.LAUNCHES = 0
    scan.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    (bits, over), t_warm = wall_s(lambda: device_core.core_check(
        h, p.n_keys, device=dev))
    checks = [t_warm]
    for _ in range(3):
        (bits, over), t = wall_s(lambda: device_core.core_check(
            h, p.n_keys, device=dev))
        checks.append(t)
        b = bits.cpu().tolist()
        assert b[:12] == [0] * 12 and b[12] == 1, b
        assert int(over) == 0
    n_checks = len(checks)
    launches = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
    assert launches["locf"] == LOCF_PER_CHECK * n_checks, launches
    out, t_infer = wall_s(lambda: device_infer.infer(h, p.n_keys))
    _, t_sweep = wall_s(lambda: device_core._verdict(out, 128, 64))
    del out
    best = min(checks[1:])
    log(f"[3] bits {b}; checks (s): warm-up {t_warm:.4f}, timed "
        f"{', '.join(f'{t:.4f}' for t in checks[1:])}; "
        f"{N_TXNS / best:.1f} ops/s; infer {t_infer * 1e3:.2f} ms, sweep "
        f"{t_sweep * 1e3:.2f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; launches over {n_checks} "
        f"checks {launches}")
    ops = profile(3, "valid check", "chip_smoke_profile_valid.txt",
                  lambda: device_core.core_check(h, p.n_keys, device=dev))
    # the monotone fills went to the LOCF kernel: what is left of
    # torch.cummax is segmented_cummax's two calls (aten::cummax is listed
    # twice per call, nested; its helper once)
    n_cummax = ops.get("aten::_cummax_helper", 0)
    log(f"[3] torch.cummax calls in one valid check: {n_cummax}")
    assert n_cummax == 2, n_cummax

    # ---- 4. cyclic path, full width ---------------------------------------
    hs = device_infer.pad_packed(stale_reads(p), device=dev)
    torch.cuda.reset_peak_memory_stats()
    fill.LAUNCHES = 0
    scan.LAUNCHES = 0
    (bits, over), t_cyc = wall_s(lambda: device_core.core_check_exact(
        hs, p.n_keys, device=dev))
    exact = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
    b = bits.cpu().tolist()
    assert b[0:9] == [0] * 9 and b[9:12] == [1, 1, 1] and b[12] == 1, b
    assert int(over) == 0
    # converged with no overflow: one sweep, `_verdict(out, 128, 64)`
    assert exact["locf"] == LOCF_PER_CHECK and exact["seg_or"] > 0, exact
    for kname in launches:
        launches[kname] += exact[kname]
    out, t_infer = wall_s(lambda: device_infer.infer(hs, p.n_keys))
    _, t_sweep = wall_s(lambda: device_core._verdict(out, 128, 64))
    n_rw_back = int((out["edges"]["rw"][2]).sum())
    profile(4, "stale-read sweep", "chip_smoke_profile_stale_sweep.txt",
            lambda: device_core._verdict(out, 128, 64))
    del out
    log(f"[4] stale reads: bits {b}, overflow {int(over)}; core_check_exact "
        f"{t_cyc:.4f} s; infer {t_infer * 1e3:.2f} ms, sweep "
        f"{t_sweep * 1e3:.2f} ms; launches in core_check_exact {exact}; "
        f"{n_rw_back} rw edges; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    log(f"[4] launches on the main path, phases 3-4: {launches}")
    assert launches["locf"] > 0 and launches["seg_or"] > 0, launches
    del h, hs
    torch.cuda.empty_cache()

    # ---- 5. card == CPU ---------------------------------------------------
    ps = stale_reads(packed_la_history(N_SMALL, n_keys=N_SMALL // 8, seed=1))
    hc = device_infer.pad_packed(ps, device="cpu")
    hg = device_infer.pad_packed(ps, device=dev)
    want, got = device_infer.infer(hc, ps.n_keys), \
        device_infer.infer(hg, ps.n_keys)
    n_arrays = 0
    for path, a, g in walk(want, got):
        assert torch.equal(a, g.cpu()), path
        n_arrays += 1
    bc, oc = device_core.core_check_exact(hc, ps.n_keys, device="cpu")
    bg, og = device_core.core_check_exact(hg, ps.n_keys, device=dev)
    assert torch.equal(bc, bg.cpu()) and int(oc) == int(og), (bc, bg)
    log(f"[5] {N_SMALL} txns: {n_arrays} infer arrays and core_check_exact "
        f"bits {bg.cpu().tolist()} equal on card and CPU")
    del hc, hg, want, got
    torch.cuda.empty_cache()

    # ---- 6. the checker API on the card -----------------------------------
    check_api(p, best, launches)

    # ---- 7. the rw-register checker and HistoryIR on the card -------------
    t7c = check_rw(p, best, launches, dev)
    del p
    torch.cuda.empty_cache()

    # ---- 8. Knossos linearizability on the card ---------------------------
    check_knossos(dev, t7c)

    # ---- 9. the invariants and the closed predicate on the card -----------
    check_invariants(dev, launches)

    # ---- 10. the queue/kafka checker family on the card -------------------
    check_queue(dev)

    # ---- 11. the 10M-txn rung (BASELINE config 4) on the card -------------
    check_10m(dev, launches)

    # ---- 12. batched checking (BASELINE config 5) on the card -------------
    check_config5(dev, launches)

    # ---- 13. stored runs streamed to the card -----------------------------
    check_stream(dev, launches)

    kernels_line = {"kernels": [
        dict(name="locf", route="cuda",
             source="jepsen_tpu_torch/csrc/locf.cu",
             replaces="jepsen_tpu/ops/pallas_fill.py:105",
             launches=launches["locf"], max_abs_err=errs["locf"],
             **locf_t),
        dict(name="seg_or", route="cuda",
             source="jepsen_tpu_torch/csrc/seg_or.cu",
             replaces="jepsen_tpu/ops/pallas_scan.py:76",
             launches=launches["seg_or"], max_abs_err=errs["seg_or"],
             **seg_t),
    ]}
    log(f"[end] chip_smoke.py took {time.perf_counter() - T_START:.1f} s")
    log(smi)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def check_api(p, best: float, launches: dict) -> None:
    """Phase 6: `list_append.check` on the card (see the module
    docstring).  `p` is phase 3's history, `best` its best `core_check`
    time; the launches of each counted check are added to `launches`."""
    from jepsen_tpu_torch.checkers.elle import list_append
    from jepsen_tpu_torch.ops import fill, scan
    from jepsen_tpu_torch.workloads.synth import packed_la_history

    split = la_split()

    def counted_check(history, models):
        """One `check` on the card with the counters set to 0 just before
        it and read just after; adds them to the main path's launches."""
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        with split:
            r, t = wall_s(lambda: list_append.check(
                history, models, _force_no_fallback=True))
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        assert "degraded" not in r, r
        return r, t, n

    checks6 = []
    for _ in range(4):
        r, t, n = counted_check(p, ["strict-serializable"])
        assert r["valid?"] is True and r["anomaly-types"] == [], r
        assert n == {"locf": LOCF_PER_CHECK, "seg_or": 0}, n
        checks6.append(t)
    best6 = min(checks6[1:])
    log(f"[6a] list_append.check, {N_TXNS} txns valid, strict-serializable: "
        f"warm-up {checks6[0]:.4f} s, timed "
        f"{', '.join(f'{t:.4f}' for t in checks6[1:])} s; "
        f"{split.calls['sweeps']} projections; last call {split}; "
        f"{N_TXNS / best6:.1f} ops/s; core_check (phase 3) best {best:.4f} "
        f"s, so the checker adds {best6 - best:.4f} s")

    ps6 = stale_reads(packed_la_history(N_SMALL, n_keys=N_SMALL // 8, seed=0))
    r, t, n = counted_check(ps6, STALE_MODELS)
    assert r["valid?"] is False, r["anomaly-types"]
    family = sorted(set(r["anomaly-types"]) & G_SINGLE_FAMILY)
    assert family, r["anomaly-types"]
    n_cycles = explained_cycles(r)
    assert n["locf"] == LOCF_PER_CHECK and n["seg_or"] > 0, n
    log(f"[6b] stale reads, {N_SMALL} txns, {'+'.join(STALE_MODELS)}: "
        f"check {t:.4f} s ({split}); {split.calls['sweeps']} "
        f"projections; {family}; {n_cycles} cycles, every edge "
        f"explained; launches {n}")

    # 6c: 6b's check (on the card) against the same check on the CPU
    want, t_cpu = wall_s(lambda: list_append.check(
        ps6, STALE_MODELS, _force_no_fallback=True, device="cpu"))
    assert r == want, (r, want)
    log(f"[6c] {N_SMALL} txns with stale reads: the result dicts are "
        f"equal on card and CPU ({r['anomaly-types']}, "
        f"{explained_cycles(r)} rendered cycles, not {r['not']}, "
        f"also-not {r['also-not']}); the CPU check took {t_cpu:.4f} s")
    del ps6

    for hname, h, expect in op_histories():
        got = list_append.check(h, ["strict-serializable"],
                                _force_no_fallback=True)
        assert got["valid?"] is False, (hname, got)
        assert expect <= set(got["anomaly-types"]), (hname, got)
        assert "degraded" not in got, got
        assert got == list_append.check(h, ["strict-serializable"],
                                        _force_no_fallback=True,
                                        device="cpu"), hname
        log(f"[6d] {hname}: {got['anomaly-types']}, equal on card and CPU")
    log(f"[6] launches on the main path, phases 3-4 and 6: {launches}")


def check_rw(p_la, best: float, launches: dict, dev: torch.device) -> None:
    """Phase 7: the rw-register checker and `HistoryIR` on the card `dev`
    (see the module docstring).  `p_la` is phase 3's list-append history
    and `best` its best `core_check` time; the launches of each counted
    call are added to `launches`."""
    from jepsen_tpu_torch.checkers.elle import (
        device_infer,
        device_rw,
        list_append,
        rw_register,
        txn_cycles,
    )
    from jepsen_tpu_torch.history import HistoryIR
    from jepsen_tpu_torch.ops import cycle_sweep, fill, scan
    from jepsen_tpu_torch.workloads.synth import (
        RW_KW,
        packed_rw_history,
        rw_keys_for,
    )

    def counted(fn):
        """`fn()` on the card with the counters set to 0 just before it
        and read just after; adds them to the main path's launches."""
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        out, t = wall_s(fn)
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        return out, t, n

    # ---- 7a. config 3, valid ----------------------------------------------
    n_keys = rw_keys_for(N_TXNS)
    t0 = time.perf_counter()
    p = packed_rw_history(N_TXNS, n_keys=n_keys, **RW_KW)
    log(f"[7a] config 3: {N_TXNS} txns, {n_keys} keys, {RW_KW}: generated "
        f"in {time.perf_counter() - t0:.2f} s")
    split = Split((("pad_packed", device_rw, "pad_packed"),
                   ("infer_rw", device_rw, "infer_rw"),
                   ("projection sweep", device_rw, "projection_scan"),
                   ("version sweep", device_rw, "_sweep_arrays")))
    torch.cuda.reset_peak_memory_stats()
    checks = []
    for _ in range(4):
        with split:
            r, t, n = counted(lambda: rw_register.check(
                p, ["snapshot-isolation"]))
        assert r["valid?"] is True and r.get("fused-device") is True, r
        assert "degraded" not in r and r["anomaly-types"] == [], r
        # no fill on the rw path; a valid serial history has no backward
        # edge, so no sweep propagates and seg-OR never launches
        assert n == {"locf": 0, "seg_or": 0}, n
        checks.append(t)
    best7 = min(checks[1:])
    log(f"[7a] rw_register.check, snapshot-isolation: warm-up "
        f"{checks[0]:.4f} s, timed {', '.join(f'{t:.4f}' for t in checks[1:])}"
        f" s; best {best7:.4f} s, {N_TXNS / best7:.1f} txns/s; last call "
        f"{split}; seg-OR launches per call {n['seg_or']}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    h = device_infer.pad_packed(p, device=dev)
    m_cap = h.mop_txn.shape[0]
    cores = []
    for _ in range(4):
        (bits, over, rw_over), t, n = counted(lambda: device_rw.rw_core_check(
            h, p.n_keys, rw_cap=m_cap, device=dev))
        cores.append(t)
    b = bits.cpu().tolist()
    assert b == [0] * 11 + [1] and int(over) == 0 and int(rw_over) == 0, b
    log(f"[7a] rw_core_check alone (T={h.txn_type.shape[0]}, M={m_cap}, "
        f"R={h.rd_elems.shape[0]}, rw_cap={m_cap}): bits {b}; warm-up "
        f"{cores[0]:.4f} s, best {min(cores[1:]):.4f} s; list-append "
        f"core_check (phase 3) best {best:.4f} s; launches per call {n}")
    del h

    # ---- 7b. config 3 with stale reads --------------------------------------
    ps = stale_reads_rw(p, N_STALE, seed=0)
    del p
    with split:
        r, t, n = counted(lambda: device_rw.check(ps))
    assert r["valid?"] is False and r["exact"] is True, r
    assert r["cycles"]["G2-family-realtime"], r
    assert n["seg_or"] > 0 and n["locf"] == 0, n
    log(f"[7b] {N_STALE} stale reads in {N_TXNS} txns: device_rw.check "
        f"{t:.4f} s ({split}), valid? {r['valid?']}, exact {r['exact']}, "
        f"counts {r['counts']}, cycle bits {r['cycles']}; launches {n}")
    del ps

    # ---- 7c. the full report ----------------------------------------------
    def report(n_txns):
        q = stale_reads_rw(packed_rw_history(
            n_txns, n_keys=rw_keys_for(n_txns), **RW_KW), N_STALE, seed=0)
        stages = Split((("fused path", device_rw, "check"),
                        ("sweeps", cycle_sweep, "detect_cycles"),
                        ("bfs", list_append, "_witness_regions"),
                        ("find_cycle", txn_cycles, "find_cycle"),
                        ("render", txn_cycles, "_render_cycle")))
        with stages:
            r, t, n = counted(lambda: rw_register.check(q, STALE_MODELS))
        return q, r, t, n, stages

    n_report = N_REPORT
    q, r, t, n, split = report(n_report)
    if t > REPORT_LIMIT_S:
        log(f"[7c] {n_report} txns took {t:.4f} s: checking "
            f"{N_REPORT_SMALL} txns")
        n_report = N_REPORT_SMALL
        saved, rw_register.FUSED_MIN_TXNS = rw_register.FUSED_MIN_TXNS, \
            n_report
        try:
            q, r, t, n, split = report(n_report)
        finally:
            rw_register.FUSED_MIN_TXNS = saved
    assert r["valid?"] is False and "degraded" not in r, r
    family = sorted(set(r["anomaly-types"]) & G_SINGLE_FAMILY)
    assert family, r["anomaly-types"]
    n_cycles = explained_cycles(r)
    assert n["seg_or"] > 0, n
    t7c = t
    rest = t - sum(split.s.values())
    log(f"[7c] rw_register.check, {n_report} txns with {N_STALE} stale "
        f"reads, {'+'.join(STALE_MODELS)}: {t:.4f} s ({split}; host "
        f"inference and the rest {rest:.4f} s); {family}; {n_cycles} "
        f"cycles, every edge explained; launches {n}")
    del q

    # ---- 7d. card == CPU ----------------------------------------------------
    q = stale_reads_rw(packed_rw_history(
        N_CMP, n_keys=rw_keys_for(N_CMP), **RW_KW), N_STALE, seed=0)
    saved, rw_register.FUSED_MIN_TXNS = rw_register.FUSED_MIN_TXNS, N_CMP
    try:
        got = rw_register.check(q, STALE_MODELS)
        want, t_cpu = wall_s(lambda: rw_register.check(q, STALE_MODELS,
                                                       device="cpu"))
    finally:
        rw_register.FUSED_MIN_TXNS = saved
    assert got == want, (got, want)
    assert got["valid?"] is False and explained_cycles(got) > 0, got
    log(f"[7d] rw_register.check, {N_CMP} txns with stale reads, fused path "
        f"first: the result dicts are equal on card and CPU "
        f"({got['anomaly-types']}); the CPU check took {t_cpu:.4f} s")
    q = stale_reads_rw(packed_rw_history(
        N_SMALL, n_keys=rw_keys_for(N_SMALL), **RW_KW), N_STALE, seed=0)
    hc = device_infer.pad_packed(q, device="cpu")
    hg = device_infer.pad_packed(q, device=dev)
    n_arrays = 0
    for path, a, g in walk(device_rw.infer_rw(hc, q.n_keys),
                           device_rw.infer_rw(hg, q.n_keys)):
        assert torch.equal(a, g.cpu()), path
        n_arrays += 1
    bc = device_rw.rw_core_check(hc, q.n_keys, device="cpu")
    bg = device_rw.rw_core_check(hg, q.n_keys, device=dev)
    assert all(torch.equal(x, y.cpu()) for x, y in zip(bc, bg)), (bc, bg)
    log(f"[7d] {N_SMALL} txns with stale reads: {n_arrays} infer_rw arrays "
        f"and rw_core_check {[x.cpu().tolist() for x in bg]} equal on card "
        f"and CPU")
    for hname, hist in rw_op_histories():
        qc = device_infer.pad_packed(hist, device="cpu")
        bc = device_rw.rw_core_check(qc, hist.n_keys, device="cpu")
        bg = device_rw.rw_core_check(qc, hist.n_keys, device=dev)
        assert all(torch.equal(x, y.cpu()) for x, y in zip(bc, bg)), hname
        log(f"[7d] {hname}: rw_core_check {bg[0].cpu().tolist()} equal on "
            f"card and CPU")
    del q, hc, hg

    # ---- 7e. HistoryIR on the card ------------------------------------------
    ir = HistoryIR.of(p_la)
    pads = Split((("pad", device_infer, "pad_packed"),
                  ("pad", list_append, "pad_packed")))
    times = []
    for _ in range(2):
        with pads:
            r, t, n = counted(lambda: list_append.check(
                ir, ["strict-serializable"], _force_no_fallback=True))
        assert r["valid?"] is True and "degraded" not in r, r
        assert n == {"locf": LOCF_PER_CHECK, "seg_or": 0}, n
        times.append((t, pads.calls["pad"]))
    assert [c for _, c in times] == [1, 0], times
    log(f"[7e] list_append.check twice on one HistoryIR of phase 3's "
        f"history: {times[0][0]:.4f} s with the pad, {times[1][0]:.4f} s "
        f"without (pad_packed calls {[c for _, c in times]}); build_s "
        f"{ir.build_s}")
    log(f"[7] launches on the main path, phases 3-4, 6 and 7: {launches}")
    return t7c


def check_knossos(dev: torch.device, t7c: float) -> None:
    """Phase 8: Knossos linearizability on the card (see the module
    docstring).  Neither kernel runs here: `device_wgl` is plain torch.
    `t7c` is 7c's time, whose host inference runs the native Tarjan."""
    from jepsen_tpu_torch import native
    from jepsen_tpu_torch.checkers import api, check_safe, compose
    from jepsen_tpu_torch.checkers.knossos import analysis, device_wgl, wgl
    from jepsen_tpu_torch.checkers.knossos.memo import memoize
    from jepsen_tpu_torch.checkers.knossos.prep import prepare
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.ops import fill, scan
    from jepsen_tpu_torch.workloads.synth import lin_register_history

    t8 = time.perf_counter()
    fill.LAUNCHES = 0
    scan.LAUNCHES = 0

    # ---- 8a. config 1 through the checker API ------------------------------
    h = lin_register_history(**LIN_KW)
    ops = prepare(h)
    n_info = sum(o.is_info for o in ops)
    native.CALLS = 0
    r, t = wall_s(lambda: check_safe(api.Linearizable(cas_register()), {}, h,
                                     {}))
    assert r["valid?"] is True, r
    assert native.CALLS > 0, "the race ran no native search"
    log(f"[8a] config 1, lin_register_history({LIN_KW}): {len(ops)} ops, "
        f"{n_info} crashed; check_safe(Linearizable) valid in {t:.4f} s, "
        f"won by {r.get('algorithm')}; native calls {native.CALLS}")
    r_nat, t_nat = wall_s(lambda: wgl.check(ops, cas_register()))
    os.environ["JT_NO_NATIVE"] = "1"
    try:
        r_py, t_py = wall_s(lambda: wgl.check(ops, cas_register()))
    finally:
        del os.environ["JT_NO_NATIVE"]
    assert r_nat == r_py and r_nat["valid?"] is True, (r_nat, r_py)
    log(f"[8a] wgl.check alone: native {t_nat:.4f} s, Python search "
        f"(JT_NO_NATIVE=1) {t_py:.4f} s, the same verdict; 7c's rw report, "
        f"whose host inference runs the native Tarjan, took {t7c:.4f} s")
    r, t = wall_s(lambda: check_safe(compose({
        "linear": api.Linearizable(cas_register()), "stats": api.Stats()}),
        {}, h, {}))
    assert r["valid?"] is True and r["linear"]["valid?"] is True, r
    log(f"[8a] compose(linear, stats) valid in {t:.4f} s, linear won by "
        f"{r['linear'].get('algorithm')}, stats count {r['stats']['count']}")

    # ---- 8b. config 1 on the card's single path -----------------------------
    h0 = lin_register_history(**dict(LIN_KW, info_prob=0.0))
    n0 = len(prepare(h0))
    search = (("search", device_wgl, "_frontier_search"),)
    with Split(search, keep=True) as spy:
        torch.cuda.reset_peak_memory_stats()
        r, t_warm = wall_s(lambda: analysis(h0, cas_register(),
                                            algorithm="device"))
        times = []
        for _ in range(1 if t_warm > ONE_CALL_S else 3):
            r, t = wall_s(lambda: analysis(h0, cas_register(),
                                           algorithm="device"))
            times.append(t)
    assert r == {"valid?": True, "op-count": n0, "hash_dedup": True}, r
    lin, _, over, waves = spy.kept["search"][-1][1]
    assert lin and not over and spy.calls["search"] == 1 + len(times), \
        spy.kept
    best = min(times)
    log(f"[8b] info_prob=0: {n0} ops, analysis(algorithm='device'), single "
        f"path: valid, {waves} waves; warm-up {t_warm:.4f} s, timed "
        f"{', '.join(f'{t:.4f}' for t in times)} s; "
        f"{best / waves * 1e3:.4f} ms per wave; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")

    hs = lin_register_history(**dict(LIN_KW, info_prob=0.0,
                                     stale_read_prob=LIN_STALE))
    ops_s = prepare(hs)
    host, t_host = wall_s(lambda: wgl.check(ops_s, cas_register()))
    assert host["valid?"] is False, host
    with Split(search, keep=True) as spy:
        r, t = wall_s(lambda: analysis(hs, cas_register(),
                                       algorithm="device"))
    assert r["valid?"] == host["valid?"] and "blocked" not in r, (r, host)
    _, exhausted, over, waves_s = spy.kept["search"][-1][1]
    assert exhausted and not over, spy.kept
    log(f"[8b] stale_read_prob={LIN_STALE}: {len(ops_s)} ops, device "
        f"{r['valid?']} in {t:.4f} s ({waves_s} waves, the frontier "
        f"emptied) == host wgl.check {host['valid?']} in {t_host:.4f} s "
        f"(max-linearized {host['final-info']['max-linearized']})")
    compaction(device_wgl, lambda: analysis(hs, cas_register(),
                                            algorithm="device"))
    profile(8, "the stale single-path search",
            "chip_smoke_profile_knossos.txt",
            lambda: analysis(hs, cas_register(), algorithm="device"))

    # 8a's history with its crashed ops: the single path overflows (check
    # would go on to the blocked search, which has no deadline here)
    memo = memoize(cas_register(), ops)
    n_pad, W, *arrays = device_wgl._setup(ops, memo)
    args = [device_wgl._i32(a, dev) for a in arrays[:4]] + \
        [device_wgl._i32(memo.table, dev)] + \
        [device_wgl._i32(a, dev) for a in arrays[4:]]
    (lin, _, over, waves_o), t = wall_s(
        lambda: device_wgl._frontier_search(n_pad, W, FRONTIER, len(ops) + 1,
                                            *args, memo.init_state))
    assert over and not lin, (lin, over)
    log(f"[8b] 8a's history ({n_info} crashed ops): _frontier_search "
        f"overflowed its {FRONTIER}-row frontier at wave {waves_o} in "
        f"{t:.4f} s ({t / waves_o * 1e3:.4f} ms per wave)")

    # ---- 8c. the blocked search expanding on the card -----------------------
    hw = lin_register_history(**LIN_WIDE)
    ops_w = prepare(hw)
    host, t_host = wall_s(lambda: wgl.check(ops_w, cas_register()))
    device_wgl.EXPAND_CALLS = device_wgl.SPLITS = device_wgl.HOST_WAVES = 0
    with Split((("expand", device_wgl, "_expand_block"),), keep=True) as spy:
        r, t = wall_s(lambda: device_wgl._blocked_and_check(
            ops_w, cas_register()))
    calls = (device_wgl.EXPAND_CALLS, device_wgl.SPLITS,
             device_wgl.HOST_WAVES)
    assert calls[0] > 0, calls
    assert r["valid?"] == host["valid?"] and r["blocked"], (r, host)
    rows = max(args[2] for (args, _), _ in spy.kept["expand"])
    log(f"[8c] lin_register_history({LIN_WIDE}): {len(ops_w)} ops, "
        f"_blocked_and_check {r['valid?']} in {t:.4f} s == host wgl.check "
        f"in {t_host:.4f} s; _expand_block calls {calls[0]} (blocks of up "
        f"to {rows} rows), splits {calls[1]}, waves expanded on the host "
        f"{calls[2]}")

    # ---- 8d. card == CPU ----------------------------------------------------
    hc = lin_register_history(**LIN_CMP)
    ops_c = prepare(hc)
    want, t_cpu = wall_s(lambda: device_wgl.check(
        ops_c, cas_register(), max_frontier=CMP_FRONTIER, device="cpu"))
    got, t_card = wall_s(lambda: device_wgl.check(
        ops_c, cas_register(), max_frontier=CMP_FRONTIER, device=dev))
    assert got == want, (got, want)
    log(f"[8d] lin_register_history({LIN_CMP}): device_wgl.check, "
        f"max_frontier {CMP_FRONTIER}: {got} on the card ({t_card:.4f} s) "
        f"and the CPU ({t_cpu:.4f} s)")
    (a, kw), out = max(spy.kept["expand"], key=lambda c: c[0][0][2])
    out_cpu = device_wgl._expand_block(
        *(x.cpu() if torch.is_tensor(x) else x for x in a), **kw)
    for name, g, c in zip(("states", "bits", "h1", "h2", "valid",
                           "n_unique"), out, out_cpu):
        assert g.dtype == c.dtype and torch.equal(g.cpu(), c), name
    log(f"[8d] one _expand_block call of 8c (A={a[0]}, W={a[1]}, F={a[2]}, "
        f"C={a[3]}, {int(out[5])} unique children): all 6 outputs equal bit "
        f"for bit on the card and the CPU")
    n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
    assert n == {"locf": 0, "seg_or": 0}, n
    log(f"[8] launches of either kernel in phase 8: {n}; phase 8 took "
        f"{time.perf_counter() - t8:.1f} s")


def check_invariants(dev: torch.device, launches: dict) -> None:
    """Phase 9: the invariants checkers and the closed predicate on the
    card (see the module docstring).  The counters are set to 0 just
    before each check on the card and read just after; the sums go into
    the main path's `launches`."""
    from jepsen_tpu_torch import resilience
    from jepsen_tpu_torch.checkers.elle import closed_predicate, txn_cycles
    from jepsen_tpu_torch.checkers.invariants import (
        bank,
        packed,
        predicate,
        session,
    )
    from jepsen_tpu_torch.history.ir import HistoryIR
    from jepsen_tpu_torch.ops import fill, scan

    t9 = time.perf_counter()
    n9 = {"locf": 0, "seg_or": 0}
    rw_sections = ["packed:rw-register", "rw_inference"]

    def counted(fn):
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        out, t = wall_s(fn)
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in n9:
            n9[kname] += n[kname]
        return out, t, n

    def cell(tag, what, check, ir, sections):
        """One warm-up and three timed calls of `check(ir, device=dev)`
        (one timed call when the warm-up takes over INV_ONE_CALL_S) on one
        IR, so that the timed calls pack and infer nothing; logs the times,
        the IR's section builds, the device part and the sweeps per timed
        call, the launches per call and peak device memory."""
        split = Split((("device part", resilience, "with_fallback"),
                       ("sweeps", txn_cycles, "_cycle_regions")))
        torch.cuda.reset_peak_memory_stats()
        r, t_warm, n = counted(lambda: check(ir, device=dev))
        times = []
        with split:
            for _ in range(1 if t_warm > INV_ONE_CALL_S else 3):
                r2, t, n2 = counted(lambda: check(ir, device=dev))
                assert r2 == r and n2 == n, (r2, r, n2, n)
                times.append(t)
        builds = ", ".join(f"{k} {ir.build_s[k]:.4f} s" for k in sections)
        per = ", ".join(f"{k} {v / len(times):.4f} s"
                        for k, v in split.s.items())
        log(f"[9{tag}] {what}: valid? {r['valid?']} {r['anomaly-types']}; "
            f"warm-up {t_warm:.4f} s, timed "
            f"{', '.join(f'{x:.4f}' for x in times)} s; built once: "
            f"{builds or 'nothing'}; per timed call: {per}; launches per "
            f"call {n}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B")
        return r, n

    def once(tag, what, check, ir, want_types):
        """One check on the card, held to the host twin's verdict and
        anomaly types (the twin may render other witness cycles)."""
        r, t, n = counted(lambda: check(ir, device=dev))
        host, t_host = wall_s(lambda: check(ir, use_device=False))
        assert r["valid?"] is False and want_types <= set(
            r["anomaly-types"]), r["anomaly-types"]
        assert (host["valid?"], host["anomaly-types"]) == \
            (r["valid?"], r["anomaly-types"]), (host, r)
        log(f"[9{tag}] {what}: valid? {r['valid?']} {r['anomaly-types']} in "
            f"{t:.4f} s (launches {n}) == host twin in {t_host:.4f} s")
        return r, n

    def twin(tag, what, check, ir, r):
        host, t_host = wall_s(lambda: check(ir, use_device=False))
        assert (host["valid?"], host["anomaly-types"]) == \
            (r["valid?"], r["anomaly-types"]), (host, r)
        log(f"[9{tag}] {what}: the host twin (use_device=False) agrees in "
            f"{t_host:.4f} s")

    def card_cpu(what, check, ir, got=None):
        """The whole dict of `check` on the card (`got`, or one call now)
        against the same check on the CPU."""
        card = "above"
        if got is None:
            got, t_card, _ = counted(lambda: check(ir, device=dev))
            card = f"{t_card:.4f} s"
        want, t_cpu = wall_s(lambda: check(ir, device="cpu"))
        assert got == want, (got, want)
        log(f"[9f] {what}: the whole dict equal on the card ({card}) and "
            f"the CPU ({t_cpu:.4f} s)")

    # ---- 9a. bank -----------------------------------------------------------
    def bcheck(h, **kw):
        return bank.check(h, BANK_TEST, **kw)

    t0 = time.perf_counter()
    hb = bank_history(**BANK_KW)
    log(f"[9a] bank_history({BANK_KW}): {len(hb.ops)} ops in "
        f"{time.perf_counter() - t0:.2f} s")
    ir = HistoryIR(hb)
    r, _ = cell("a", "bank, valid", bcheck, ir, ["bank"])
    assert r["valid?"] is True and \
        r["read-count"] > 0.45 * BANK_KW["n_ops"], r
    assert bcheck(ir, use_device=False) == r
    card_cpu("9a bank, valid", bcheck, ir, r)
    saved = [(op, dict(op.value)) for op in hb.ops
             if op.f == "read" and isinstance(op.value, dict)]
    for inject, anomaly in ((inject_bank_wrong_total, bank.WRONG_TOTAL),
                            (inject_bank_negative, bank.NEGATIVE)):
        inject(hb, 0)
        ir = HistoryIR(hb)
        r, _ = once("a", f"bank, {inject.__name__}", bcheck, ir, {anomaly})
        assert r["anomaly-types"] == [anomaly] and \
            bcheck(ir, use_device=False) == r, r
        card_cpu(f"9a bank, {inject.__name__}", bcheck, ir, r)
        for op, v in saved:
            op.value.clear()
            op.value.update(v)
    # the reduction at scale: 1M reads x 8 accounts, int64 (64 MB)
    rng = np.random.default_rng(0)
    bal = rng.multinomial(100, [1 / 8] * 8, size=N_BANK_READS)
    bal = bal.astype(np.int64)
    idx = np.arange(N_BANK_READS, dtype=np.int64)
    none = np.zeros(0, np.int64)
    pb = packed.PackedBank(
        accounts=list(range(8)), balances=bal, read_op_index=idx,
        read_process=idx % 10, tr_type=np.zeros(0, np.int8), tr_from=none,
        tr_to=none, tr_amount=none, tr_op_index=none)
    r, _ = cell("a", f"PackedBank of {N_BANK_READS} reads x 8 accounts "
                f"({bal.nbytes} B), valid", bcheck, pb, [])
    assert r["valid?"] is True and bcheck(pb, use_device=False) == r, r
    wrong, neg = N_BANK_READS // 8, N_BANK_READS * 5 // 8
    bal[wrong, 0] += 3
    shift = bal[neg, 0] + 5
    bal[neg, 0] -= shift
    bal[neg, 1] += shift
    r, _ = once("a", "the PackedBank with a wrong total and a negative "
                "balance", bcheck, pb, {bank.WRONG_TOTAL, bank.NEGATIVE})
    assert bcheck(pb, use_device=False) == r == bcheck(pb, device="cpu"), r
    log(f"[9f] the PackedBank's whole dict equal on the card, the CPU and "
        f"the host twin")
    del hb, ir, saved, bal, pb

    # ---- 9b. long fork ------------------------------------------------------
    t0 = time.perf_counter()
    h = lf_history(**LF_KW)
    ir = HistoryIR(h)
    log(f"[9b] lf_history({LF_KW}): {len(h.ops)} ops in "
        f"{time.perf_counter() - t0:.2f} s")
    r, _ = cell("b", "long fork, valid", predicate.check, ir, rw_sections)
    assert r["valid?"] is True and r["read-count"] == LF_KW["n_reads"], r
    twin("b", "long fork, valid", predicate.check, ir, r)
    card_cpu("9b long fork, valid", predicate.check, ir, r)
    inject_long_fork(h)
    ir = HistoryIR(h)
    r, _ = once("b", "long fork, inject_long_fork", predicate.check, ir,
                {predicate.LONG_FORK})
    card_cpu("9b long fork, inject_long_fork", predicate.check, ir, r)
    del h, ir

    # ---- 9c. write skew -----------------------------------------------------
    t0 = time.perf_counter()
    h = ws_history(**WS_KW)
    ir = HistoryIR(h)
    log(f"[9c] ws_history({WS_KW}): {len(h.ops)} ops in "
        f"{time.perf_counter() - t0:.2f} s")
    r, _ = cell("c", "write skew, valid", predicate.check, ir, rw_sections)
    assert r["valid?"] is True, r
    twin("c", "write skew, valid", predicate.check, ir, r)
    card_cpu("9c write skew, valid", predicate.check, ir, r)
    inject_write_skew(h)
    r, _ = once("c", "write skew, inject_write_skew", predicate.check,
                HistoryIR(h), {predicate.WRITE_SKEW})
    assert any("why" in e for name in r["anomaly-types"]
               for rep in r["anomalies"][name] for e in rep.get("cycle", ())
               ), r
    hc = inject_write_skew(ws_history(**dict(WS_KW, n_txns=N_INV_CMP)))
    card_cpu(f"9c write skew at {N_INV_CMP} txns, inject_write_skew",
             predicate.check, HistoryIR(hc))
    del h, ir, hc

    # ---- 9d. session --------------------------------------------------------
    locf0 = n9["locf"]
    for pin in (True, False):
        what = f"session, {'pinned keys, ' if pin else ''}"
        t0 = time.perf_counter()
        h = sess_history(**SESS_KW, pin_keys=pin)
        ir = HistoryIR(h)
        log(f"[9d] sess_history({SESS_KW}, pin_keys={pin}): {len(h.ops)} "
            f"ops in {time.perf_counter() - t0:.2f} s")
        with Split((("infer_rw", packed, "infer_rw"),)) as builds:
            r, n = cell("d", what + "valid", session.check, ir, rw_sections)
            assert r["valid?"] is True and "fallback" not in r, r
            assert n == {"locf": 2, "seg_or": 0}, n
            if not pin:
                rp, t, _ = counted(lambda: predicate.check(ir, device=dev))
                assert rp["valid?"] is True, rp
        assert builds.calls["infer_rw"] == 1, builds.calls
        if not pin:
            log(f"[9d] predicate.check on the same HistoryIR: valid in "
                f"{t:.4f} s; infer_rw ran {builds.calls['infer_rw']} time "
                f"for both checkers ({r['events']} session events)")
        twin("d", what + "valid", session.check, ir, r)
        if pin:
            card_cpu("9d " + what + "valid", session.check, ir, r)
            # the kernel against its plain version on the inputs the
            # masks give it (launches outside `counted` are not counted)
            ev = session._session_events(ir.packed("rw-register"),
                                         ir.rw_inference())
            w = torch.from_numpy(ev[2]).to(dev)
            pos1 = torch.arange(1, len(w) + 1, dtype=torch.int32,
                                device=dev)
            for match in (~w, w):
                x = torch.where(match, pos1, 0) - 1
                assert torch.equal(fill.locf_cuda(x), fill.locf_plain(x))
            log(f"[9d] LOCF on the session masks' inputs ({len(w)} int32 "
                f"events, reads and writes): kernel == plain version, bit "
                f"for bit, on the card")
        inject_session_break(h)
        r, n = once("d", what + "inject_session_break", session.check,
                    HistoryIR(h), {"monotonic-reads-violation"})
        assert n == {"locf": 2, "seg_or": 0}, n
        del h, ir
    hc = sess_history(**dict(SESS_KW, n_txns=N_INV_CMP))
    card_cpu(f"9d session at {N_INV_CMP} txns, valid", session.check,
             HistoryIR(hc))
    card_cpu(f"9d session at {N_INV_CMP} txns, inject_session_break",
             session.check, HistoryIR(inject_session_break(hc)))
    locf_d = n9["locf"] - locf0
    assert locf_d > 0, n9
    log(f"[9d] LOCF launches in 9d: {locf_d}, two per session check on "
        f"the card")

    # ---- 9e. the closed predicate -------------------------------------------
    verdicts = []
    for name, h, models, valid in closed_predicate_histories():
        r, _, n = counted(lambda: closed_predicate.check(h, models,
                                                        device=dev))
        assert r["valid?"] is valid, (name, r)
        assert closed_predicate.check(h, models, device="cpu") == r, name
        host = closed_predicate.check(h, models, use_device=False)
        assert (host["valid?"], host["anomaly-types"]) == \
            (r["valid?"], r["anomaly-types"]), (name, host, r)
        verdicts.append(f"{name}: {r['valid?']} {r['anomaly-types']}")
    log(f"[9e] closed predicate, the seven histories of "
        f"tests/test_closed_predicate.py: {'; '.join(verdicts)}")
    log("[9f] closed predicate: the whole dicts equal on the card and the "
        "CPU, the verdicts and anomaly types the host twin's")

    for kname in launches:
        launches[kname] += n9[kname]
    log(f"[9] launches in phase 9: {n9}; phase 9 took "
        f"{time.perf_counter() - t9:.1f} s")


def check_queue(dev: torch.device) -> None:
    """Phase 10: the queue/kafka checker family on the card (see the module
    docstring).  The family is plain torch ops and launches neither
    kernel."""
    from jepsen_tpu_torch import resilience
    from jepsen_tpu_torch.checkers.queue import fifo, kafka, packed
    from jepsen_tpu_torch.history.ir import HistoryIR
    from jepsen_tpu_torch.ops import fill, scan
    from jepsen_tpu_torch.workloads.kafka import KafkaChecker

    t10 = time.perf_counter()
    fill.LAUNCHES = 0
    scan.LAUNCHES = 0
    part = Split((("device part", resilience, "with_fallback"),))

    def on_card(check, h, **kw):
        """One check on the card: its result, wall time and device part
        (`with_fallback`'s call), which must have run once."""
        with part:
            r, t = wall_s(lambda: check(h, device=dev, **kw))
        assert part.calls["device part"] == 1, part.calls
        assert "degraded" not in r, r
        return r, t, part.s["device part"]

    # ---- 10a. kafka at full size ------------------------------------------
    h, t_sim = wall_s(lambda: sim_kafka(0, **KAFKA_FULL))
    ir = HistoryIR(h)
    torch.cuda.reset_peak_memory_stats()
    r, t_warm, _ = on_card(kafka.check, ir)
    pk = ir.queue("kafka")
    timed = [on_card(kafka.check, ir) for _ in range(3)]
    assert all(x[0] == r for x in timed)
    assert r["valid?"] is True, r["anomaly-types"]
    host, t_host = wall_s(lambda: kafka.check(ir, use_device=False))
    assert host == r, (host, r)
    log(f"[10a] kafka, sim_kafka(0, {KAFKA_FULL}): {len(h.ops)} ops "
        f"simulated in {t_sim:.2f} s; {pk.n_sends} sends, {pk.n_polls} "
        f"polls, {len(pk.m_key)} polled messages; build_s['queue:kafka'] "
        f"{ir.build_s['queue:kafka']:.4f} s; valid? {r['valid?']}; warm-up "
        f"{t_warm:.4f} s, timed "
        f"{', '.join(f'{t:.4f}' for _, t, _ in timed)} s, device part "
        f"{', '.join(f'{d:.4f}' for _, _, d in timed)} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
        f"b_ep max {int(pk.b_ep.max())}: JAX's device_safe is "
        f"{pk.device_safe}, so the JAX package would check it "
        f"{'on its device' if pk.device_safe else 'on the host'}; == "
        f"use_device=False ({t_host:.4f} s)")
    del h, ir, pk, timed

    # ---- 10b. injected kafka ----------------------------------------------
    knobs = dict.fromkeys(KAFKA_KNOBS, KAFKA_INJECT_P)
    frozen = dict(n_clients=2, freeze=True,
                  gen_kw=dict(key_count=2, subscribe_frac=0.2))
    h = sim_kafka(0, ops=KAFKA_INJECT_OPS, n_clients=10, **knobs)
    r, t, d = on_card(kafka.check, h)
    assert r == kafka.check(h, use_device=False), "10b injected"
    assert set(KAFKA_INJECTED) <= set(r["anomaly-types"]), r["anomaly-types"]
    log(f"[10b] kafka, {KAFKA_INJECT_OPS} ops, each of {KAFKA_KNOBS} at "
        f"{KAFKA_INJECT_P}: {r['anomaly-types']} in {t:.4f} s (device part "
        f"{d:.4f} s), == the host twin")
    for seed in range(8):
        h = sim_kafka(seed, ops=KAFKA_INJECT_OPS, **frozen)
        r, t, d = on_card(kafka.check, h)
        assert r == kafka.check(h, use_device=False), ("10b frozen", seed)
        if "stale-consumer-group" in r["anomaly-types"]:
            break
    assert "stale-consumer-group" in r["anomaly-types"], r["anomaly-types"]
    log(f"[10b] kafka, {KAFKA_INJECT_OPS} ops, frozen commits ({frozen}), "
        f"seed {seed}: {r['anomaly-types']} in {t:.4f} s (device part "
        f"{d:.4f} s), == the host twin")
    for what, kw in (("injected", dict(n_clients=10, **knobs)),
                     ("frozen commits", frozen)):
        h = sim_kafka(0, ops=KAFKA_TWIN_OPS, **kw)
        r, t, _ = on_card(kafka.check, h)
        twin, t_twin = wall_s(lambda: KafkaChecker().check(None, h, {}))
        assert r == twin, (what, r, twin)
        log(f"[10b] kafka, {KAFKA_TWIN_OPS} ops, {what}: the card "
            f"({t:.4f} s) == the scan twin KafkaChecker ({t_twin:.4f} s): "
            f"{r['anomaly-types']}")

    # ---- 10c. the total queue ---------------------------------------------
    for what, kw, want in (
            ("drained", {}, ([], [])),
            ("lose_enqueue_p", dict(lose_enqueue_p=QUEUE_INJECT_P),
             ([fifo.LOST], [fifo.LOST])),
            ("dup_enqueue_p", dict(dup_enqueue_p=QUEUE_INJECT_P),
             ([fifo.PHANTOM], [fifo.PHANTOM])),
            ("reorder_dequeue_p", dict(reorder_dequeue_p=QUEUE_INJECT_P),
             ([], [fifo.FIFO]))):
        h, t_sim = wall_s(lambda: sim_mem_queue(0, ops=QUEUE_OPS, **kw))
        ir = HistoryIR(h)
        got = []
        for strict in (False, True):
            r, t, d = on_card(fifo.check, ir, fifo=strict)
            assert r == fifo.check(ir, fifo=strict, use_device=False), \
                (what, strict)
            got.append((r["anomaly-types"], t, d))
        assert tuple(g[0] for g in got) == want, (what, got)
        log(f"[10c] total queue, sim_mem_queue(0, ops={QUEUE_OPS}"
            f"{''.join(f', {k}={v}' for k, v in kw.items())}): "
            f"{len(h.ops)} ops in {t_sim:.2f} s, build_s['queue:fifo'] "
            f"{ir.build_s['queue:fifo']:.4f} s; fifo=False {got[0][0]} in "
            f"{got[0][1]:.4f} s (device part {got[0][2]:.4f} s), fifo=True "
            f"{got[1][0]} in {got[1][1]:.4f} s (device part "
            f"{got[1][2]:.4f} s); == the host twin")
    del h, ir

    # ---- 10d. the int64 route ---------------------------------------------
    h = sim_kafka(0, ops=INT64_OPS)
    pk = packed.pack_kafka(h)
    assert not pk.device_safe and int(pk.b_ep.max()) >= int(packed.SENTINEL)
    r, t, d = on_card(kafka.check, pk)
    assert d > 0 and r == kafka.host_verdict(pk), r
    log(f"[10d] kafka, sim_kafka(0, ops={INT64_OPS}): b_ep max "
        f"{int(pk.b_ep.max())} >= 2^30, device_safe False: on the card in "
        f"{t:.4f} s (device part {d:.4f} s), == host_verdict")
    n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
    assert n == {"locf": 0, "seg_or": 0}, n
    log(f"[10] launches of either kernel in phase 10: {n}; phase 10 took "
        f"{time.perf_counter() - t10:.1f} s")


def check_10m(dev: torch.device, launches: dict) -> None:
    """Phase 11: the list-append main path at BASELINE config 4's size on
    the card (see the module docstring).  The counters are set to 0 just
    before each counted check and read just after; the sums go into the
    main path's `launches`."""
    from jepsen_tpu_torch.checkers.elle import (
        device_core,
        device_infer,
        list_append,
    )
    from jepsen_tpu_torch.history.ir import HistoryIR
    from jepsen_tpu_torch.ops import fill, scan
    from jepsen_tpu_torch.workloads.synth import packed_la_history

    t11 = time.perf_counter()

    def counted(fn):
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        out, t = wall_s(fn)
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        return out, t, n

    # ---- 11a. valid 10M ---------------------------------------------------
    t0 = time.perf_counter()
    p = packed_la_history(N_10M, n_keys=N_KEYS_10M, seed=0)
    t_gen = time.perf_counter() - t0
    ir = HistoryIR(p)
    torch.cuda.reset_peak_memory_stats()
    h, t_pad = wall_s(lambda: ir.padded(device=dev))
    shapes = (h.txn_type.shape[0], h.mop_txn.shape[0], h.rd_elems.shape[0])
    log(f"[11a] {N_10M} txns, {N_KEYS_10M} keys: generated in {t_gen:.2f} "
        f"s, padded + staged in {t_pad:.2f} s (T={shapes[0]}, M={shapes[1]}, "
        f"R={shapes[2]}, V={h.v_cap}, O={h.o_cap}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    assert shapes == SHAPES_10M, shapes

    # the warm-up keeps the largest input any fill is given (for 11b)
    biggest = []
    locf = device_infer.locf

    def keep_biggest(x):
        if not biggest or x.numel() > biggest[0].numel():
            biggest[:] = [x.clone()]
        return locf(x)

    torch.cuda.reset_peak_memory_stats()
    device_infer.locf = keep_biggest
    try:
        (bits, over), t_warm, n = counted(lambda: device_core.core_check(
            h, p.n_keys, device=dev))
    finally:
        device_infer.locf = locf
    checks = [t_warm]
    for _ in range(3):
        (bits, over), t, n = counted(lambda: device_core.core_check(
            h, p.n_keys, device=dev))
        checks.append(t)
        b = bits.cpu().tolist()
        assert b[:12] == [0] * 12 and b[12] == 1, b
        assert int(over) == 0
        assert n == {"locf": LOCF_PER_CHECK, "seg_or": 0}, n
    best = min(checks[1:])
    log(f"[11a] core_check: bits {b}; warm-up {t_warm:.4f} s, timed "
        f"{', '.join(f'{t:.4f}' for t in checks[1:])} s; "
        f"{N_10M / best:.1f} txns/s; launches per check {n}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")

    # ---- 11b. each kernel at the 10M shapes -------------------------------
    # once each, bit for bit against the plain version; times from CUDA
    # events around single calls (at these sizes the launch gap is noise)
    rate = mem_rate(torch.cuda.get_device_name(0))
    x = biggest.pop()
    assert x.numel() == SHAPES_10M[2], x.shape
    assert torch.equal(fill.locf_cuda(x), fill.locf_plain(x)), "locf 10M"
    log(f"[11b] locf on 11a's largest fill input (n = {x.numel()} int32): "
        f"kernel == plain version, bit for bit; kernel "
        f"{call_ms(lambda: fill.locf_cuda(x), reps=5):.4f} ms, bound "
        f"{bound(8 * x.numel(), x.numel(), rate)[0]:.4f} ms")
    del x
    torch.cuda.empty_cache()
    n_rows, k = 2 * SHAPES_10M[0], 128    # the label plane at 10M
    gen = torch.Generator(device=dev).manual_seed(11)
    v = torch.empty((n_rows, k), dtype=torch.int8, device=dev)
    step = 1 << 22                        # rows per slice of random draws
    for i in range(0, n_rows, step):
        v[i:i + step] = (torch.rand(min(step, n_rows - i), k, device=dev,
                                    generator=gen) < 0.05).to(torch.int8)
    s = torch.rand(n_rows, device=dev, generator=gen) < 0.01
    s[0] = True
    seg_b, _ = bound(2 * v.numel() + n_rows, v.numel(), rate)
    for excl in (False, True):
        assert torch.equal(scan.seg_or_cuda(v, s, exclusive=excl),
                           scan.seg_or_plain(v, s, exclusive=excl)), \
            ("seg_or 10M", excl)
        torch.cuda.empty_cache()
        t = call_ms(lambda: scan.seg_or_cuda(v, s, exclusive=excl), reps=5)
        log(f"[11b] seg_or on a ({n_rows}, {k}) int8 plane ({v.numel()} "
            f"elements), {'exclusive' if excl else 'inclusive'}: kernel == "
            f"plain version, bit for bit; kernel {t:.4f} ms, bound "
            f"{seg_b:.4f} ms")
    del v, s
    torch.cuda.empty_cache()

    # ---- 11d. the checker API at 10M, on 11a's IR -------------------------
    pads = Split((("pad", device_infer, "pad_packed"),
                  ("pad", list_append, "pad_packed")))
    torch.cuda.reset_peak_memory_stats()
    with pads:
        r, t, n = counted(lambda: list_append.check(
            ir, ["strict-serializable"], _force_no_fallback=True,
            device=dev))
    assert r["valid?"] is True and r["anomaly-types"] == [], r
    assert "degraded" not in r, r
    assert pads.calls["pad"] == 0, pads.calls
    log(f"[11d] list_append.check on 11a's HistoryIR, strict-serializable: "
        f"valid in {t:.4f} s, pad_packed calls {pads.calls['pad']}, "
        f"launches {n}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    del ir, h
    torch.cuda.empty_cache()

    # ---- 11c. stale 10M ---------------------------------------------------
    t0 = time.perf_counter()
    ps = stale_reads(p)
    t_stale = time.perf_counter() - t0
    del p
    hs, t_pad = wall_s(lambda: device_infer.pad_packed(ps, device=dev))
    torch.cuda.reset_peak_memory_stats()
    ks = []                      # the budget of each sweep the check ran
    verdict = device_core._verdict
    device_core._verdict = lambda out, k, r: ks.append(k) or \
        verdict(out, k, r)
    try:
        (bits, over), t_cyc, n = counted(
            lambda: device_core.core_check_exact(
                hs, ps.n_keys, max_k=MAX_K_10M, device=dev))
    finally:
        device_core._verdict = verdict
    b = bits.cpu().tolist()
    assert b[0:9] == [0] * 9 and b[9:12] == [1, 1, 1] and b[12] == 1, b
    assert int(over) == 0
    assert n["locf"] == LOCF_PER_CHECK and n["seg_or"] > 0, n
    log(f"[11c] {N_STALE} stale reads at {N_10M} txns (made in {t_stale:.2f} "
        f"s, padded in {t_pad:.2f} s): core_check_exact from max_k "
        f"{MAX_K_10M}, sweeps at max_k {ks}: bits {b}, overflow "
        f"{int(over)}, {t_cyc:.4f} s; launches {n}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    del hs, ps
    torch.cuda.empty_cache()
    log(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s")


def check_config5(dev: torch.device, launches: dict) -> None:
    """Phase 12: BASELINE config 5 on one card (see the module
    docstring).  The counters are set to 0 just before the first
    `check_batch_checkpointed` call and read just after the resumed one;
    the sums go into the main path's `launches`."""
    import shutil
    import tempfile

    from jepsen_tpu_torch.checkers.elle import device_core, device_infer
    from jepsen_tpu_torch.ops import fill, scan
    from jepsen_tpu_torch.parallel import batch

    t12 = time.perf_counter()
    t0 = time.perf_counter()
    ps = [config5_history(i, N_TXNS) for i in range(N_C5)]
    t_gen = time.perf_counter() - t0
    invalid = [i for i in range(N_C5)
               if i % C5_INVALID_EVERY == C5_INVALID_EVERY - 1]
    log(f"[12a] {N_C5} histories of {N_TXNS} txns, {max(64, N_TXNS // 8)} "
        f"keys, {C5_KW}: generated in {t_gen:.2f} s; a failed writer in "
        f"{invalid}, {N_STALE} stale reads in {C5_STALE_AT}")

    class Crash(Exception):
        """This script's simulated crash of the checking process."""

    split = Split((("pad", batch, "pad_batch"),
                   ("card", batch, "_batched_core"),
                   ("rerun", batch, "core_check_exact")))
    groups = []

    def record(info):
        # each group's info with the stage times so far; the first call
        # crashes as soon as its first group is durable
        groups.append(dict(info, **split.s))
        if len(groups) == 1:
            raise Crash(info)

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_c5_")
    ckpt = os.path.join(ckdir, "config5.ckpt")
    try:
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        with split:
            t0 = time.perf_counter()
            try:
                batch.check_batch_checkpointed(ps, ckpt, group_size=C5_GROUP,
                                               on_group=record, device=dev)
                raise AssertionError("the simulated crash did not happen")
            except Crash:
                pass
            t_crashed = time.perf_counter() - t0
            with open(ckpt) as f:
                durable = sum(1 for line in f if line.strip())
            t0 = time.perf_counter()
            out = batch.check_batch_checkpointed(
                ps, ckpt, group_size=C5_GROUP, on_group=record, device=dev)
            t_resumed = time.perf_counter() - t0
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    for kname in launches:
        launches[kname] += n[kname]
    assert durable == C5_GROUP, durable
    assert [g["group"] for g in groups] == [0, 1], groups
    assert groups[1]["indices"] == list(range(C5_GROUP, N_C5)), groups
    reruns = split.calls["rerun"]
    assert n["locf"] == LOCF_PER_CHECK * (N_C5 + reruns) and \
        n["seg_or"] > 0, n
    for i, r in enumerate(out):
        assert r["exact"] is True, (i, r)
        if i in invalid:
            assert r["valid?"] is False and r["counts"]["G1a"] > 0, (i, r)
        elif i == C5_STALE_AT:
            assert r["valid?"] is False and not any(r["counts"].values()) \
                and any(r["cycles"].values()), (i, r)
        else:
            assert r["valid?"] is True, (i, r)
    log(f"[12a] check_batch_checkpointed, groups of {C5_GROUP}: crashed "
        f"after group 0 ({durable} records durable) in {t_crashed:.4f} s; "
        f"the resumed call computed group 1 only (histories "
        f"{groups[1]['indices'][0]}-{groups[1]['indices'][-1]}) in "
        f"{t_resumed:.4f} s; verdicts {[r['valid?'] for r in out]}, all "
        f"exact; exact reruns {reruns}")
    t0 = time.perf_counter()
    for i, p in enumerate(ps):
        h = device_infer.pad_packed(p, device=dev)
        b, o = device_core.core_check_exact(h, p.n_keys, device=dev)
        alone = batch.summarize_batch_bits(b[None], o[None], None,
                                           p.n_keys, 1)[0]
        assert alone == out[i], (i, alone, out[i])
        del h
    log(f"[12a] each row's dict == the same history alone through "
        f"pad_packed + core_check_exact ({time.perf_counter() - t0:.1f} s)")
    # ---- 12b. where the time went -----------------------------------------
    prev = dict.fromkeys(split.s, 0.0)
    for g in groups:
        d = {k: g[k] - prev[k] for k in split.s}
        prev = {k: g[k] for k in split.s}
        log(f"[12b] group {g['group']}: {len(g['indices'])} histories, "
            f"wall {g['wall_s']} s: pad (host, with the copy of the stack) "
            f"{d['pad']:.4f} s, card {d['card']:.4f} s, exact reruns "
            f"{d['rerun']:.4f} s")
    t_groups = sum(g["wall_s"] for g in groups)
    log(f"[12b] {N_C5 * N_TXNS} txns: {N_C5 * N_TXNS / t_groups:.1f} txns/s "
        f"over the groups' wall time ({t_groups:.2f} s), "
        f"{N_C5 * N_TXNS / (t_crashed + t_resumed):.1f} txns/s over both "
        f"calls ({t_crashed + t_resumed:.4f} s, digests and caps included); "
        f"card only {split.s['card']:.4f} s, "
        f"{N_C5 * N_TXNS / split.s['card']:.1f} txns/s; "
        f"max_memory_allocated {peak} B; launches {n}")
    del ps, out
    torch.cuda.empty_cache()
    # ---- 12c. card == CPU on a mixed batch -------------------------------
    small = [config5_history(i, n_txns=N_C5_CMP) for i in range(4)]
    (got, t_card) = wall_s(lambda: batch.check_batch(small, device=dev))
    t0 = time.perf_counter()
    want = batch.check_batch(small, device="cpu")
    t_cpu = time.perf_counter() - t0
    assert got == want, (got, want)
    assert [r["valid?"] for r in got] == [True, True, False, False], got
    log(f"[12c] check_batch of 4 x {N_C5_CMP} txns (verdicts "
        f"{[r['valid?'] for r in got]}): card == CPU; card {t_card:.4f} s, "
        f"CPU {t_cpu:.4f} s")
    log(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s")


def check_stream(dev: torch.device, launches: dict) -> None:
    """Phase 13: stored runs streamed to the card (see the module
    docstring).  The counters are set to 0 just before each
    `check_stored` of 13a-13c and read just after; the sums go into the
    main path's `launches`."""
    import shutil
    import tempfile

    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checkers.elle import (
        device_core,
        device_infer,
        device_rw,
        stream,
    )
    from jepsen_tpu_torch.history.soa import TxnPacker, pack_txns
    from jepsen_tpu_torch.ops import fill, scan
    from jepsen_tpu_torch.parallel import batch
    from jepsen_tpu_torch.workloads import synth

    t13 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="chip_smoke_store_")
    # check_stored's time: the staging (decode, pack and the copies to the
    # card, which overlap the host work) and the check on the card
    split = Split((("staging", stream, "stage_chunks"),
                   ("check", stream, "core_check_exact"),
                   ("check", device_rw, "check")))

    def counted(fn):
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        out, t = wall_s(fn)
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        return out, t, n, torch.cuda.max_memory_allocated()

    def save(name, h):
        t = {"name": name, "store-dir": base, "history": h}
        t0 = time.perf_counter()
        store.save_0(t)
        return store.test_dir(t), time.perf_counter() - t0

    def alone(h, device=dev):
        """`check_stored`'s dict for `h` from `pack_txns`, `pad_packed`
        and `core_check_exact`."""
        p = pack_txns(h)
        b, o = device_core.core_check_exact(
            device_infer.pad_packed(p, device=device), p.n_keys,
            device=device)
        row = batch.summarize_batch_bits(b[None], o[None], None, p.n_keys,
                                         1)[0]
        assert row["exact"], row
        return dict(row, **{"n-txns": p.n_txns})

    try:
        # ---- 13a. a valid stored run -------------------------------------
        t0 = time.perf_counter()
        h = synth.la_history(**STREAM_KW)
        t_gen = time.perf_counter() - t0
        d, t_save = save("stream", h)
        n_chunks = len(store.load(d)["history"]._chunks)
        t0 = time.perf_counter()
        pk = TxnPacker()
        for ops in store.load(d)["history"].iter_chunks():
            pk.feed(ops)
        t_pack = time.perf_counter() - t0
        with split:
            r, t_check, n, peak = counted(
                lambda: stream.check_stored(d, device=dev))
        assert r == alone(h) and r["valid?"] is True, r
        assert n["locf"] > 0, n
        log(f"[13a] la_history({STREAM_KW}): {len(h)} ops generated in "
            f"{t_gen:.2f} s; save_0 {t_save:.2f} s, {n_chunks} chunks of "
            f"{store.format.CHUNK_SIZE} ops; decode and pack alone "
            f"{t_pack:.4f} s; check_stored valid in {t_check:.4f} s: "
            f"{split}, == pad_packed + core_check_exact; launches {n}; "
            f"max_memory_allocated {peak} B")
        # ---- 13b. an injected wr cycle -----------------------------------
        t0 = time.perf_counter()
        assert synth.inject_wr_cycle(h)
        t_inject = time.perf_counter() - t0
        d, t_save = save("stream-wr", h)
        with split:
            r, t_check, n, peak = counted(
                lambda: stream.check_stored(d, device=dev))
        assert r["valid?"] is False and r["cycles"]["G1c"], r
        assert r == alone(h), r
        del h
        log(f"[13b] the same with inject_wr_cycle ({t_inject:.2f} s): "
            f"save_0 {t_save:.2f} s; check_stored {t_check:.4f} s: "
            f"{split}; valid? False, cycles {r['cycles']}; launches {n}; "
            f"max_memory_allocated {peak} B")
        # ---- 13c. rw-register --------------------------------------------
        t0 = time.perf_counter()
        rw = synth.rw_history(**STREAM_RW_KW)
        t_gen = time.perf_counter() - t0
        d, t_save = save("stream-rw", rw)
        with split:
            r, t_check, n, peak = counted(lambda: stream.check_stored(
                d, workload="rw-register", device=dev))
        want = device_rw.check(pack_txns(rw, "rw-register"), device=dev)
        assert r == dict(want, **{"n-txns": r["n-txns"]}), (r, want)
        assert r["valid?"] is True, r
        log(f"[13c] rw_history({STREAM_RW_KW}): generated in {t_gen:.2f} s, "
            f"save_0 {t_save:.2f} s; check_stored(workload='rw-register') "
            f"valid in {t_check:.4f} s: {split}, == device_rw.check of "
            f"pack_txns; "
            f"launches {n}; max_memory_allocated {peak} B")
        del rw
        # ---- 13d. card == CPU --------------------------------------------
        kw = dict(n_txns=N_STREAM_CMP, n_keys=N_STREAM_CMP // 8,
                  concurrency=10, seed=1)
        h = synth.la_history(**kw)
        assert synth.inject_wr_cycle(h)
        d, _ = save("stream-cmp", h)
        staged = [stream.stage_chunks(store.load(d)["history"].iter_chunks(),
                                      device=x)[0] for x in (dev, "cpu")]
        fields = [device_infer.padded_to_numpy(x) for x in staged]
        assert fields[0][1] == fields[1][1], fields
        for f in device_infer.DATA_FIELDS:
            a, b = fields[0][0][f], fields[1][0][f]
            assert (a is None and b is None) or np.array_equal(a, b), f
        got = stream.check_stored(d, device=dev)
        assert got == stream.check_stored(d, device="cpu") == alone(
            h, "cpu") and got["valid?"] is False, got
        rw = synth.rw_history(**dict(STREAM_RW_KW, n_txns=N_STREAM_CMP))
        d, _ = save("stream-rw-cmp", rw)
        got = stream.check_stored(d, workload="rw-register", device=dev)
        assert got == stream.check_stored(d, workload="rw-register",
                                          device="cpu"), got
        log(f"[13d] {N_STREAM_CMP} txns: every staged array and the "
            f"check_stored dicts (list-append with a wr cycle, rw-register) "
            f"equal on card and CPU")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s")


def compaction(device_wgl, search) -> None:
    """JAX's compaction as written, `.at[tgt].max(arange)` as one
    `scatter_reduce_` onto F + 1 rows with every dropped child aimed at
    the last, against the port's `searchsorted` read (`_compact`), on the
    inputs of wave `COMPACT_WAVE` of `search()`: the same rows, and the
    time of each."""
    compact, seen = device_wgl._compact, []

    def grab(order, keep, cap):
        seen.append((order, keep, cap) if len(seen) == COMPACT_WAVE else None)
        return compact(order, keep, cap)

    device_wgl._compact = grab
    try:
        search()
    finally:
        device_wgl._compact = compact
    order, keep, cap = seen[COMPACT_WAVE]
    N = keep.numel()

    def scatter():
        kidx = torch.cumsum(keep, 0) - 1
        tgt = torch.where(keep & (kidx < cap), kidx, cap)
        take = torch.full((cap + 1,), -1, dtype=torch.int64,
                          device=keep.device)
        take.scatter_reduce_(0, tgt, torch.arange(N, device=keep.device),
                             "amax", include_self=True)
        take = take[:cap]
        valid = take >= 0
        return valid, order[take.clamp(0, N - 1)]

    for a, b in zip(scatter(), compact(order, keep, cap)):
        assert torch.equal(a, b)
    t_scatter = call_ms(scatter, reps=3)
    t_sorted = call_ms(lambda: compact(order, keep, cap))
    log(f"[8b] compaction of wave {COMPACT_WAVE} ({N} children, "
        f"{int(keep.sum())} kept, {cap} rows), same rows both ways: JAX's "
        f".at[tgt].max(arange) as scatter_reduce_ {t_scatter:.4f} ms, "
        f"searchsorted (_compact) {t_sorted:.4f} ms")


class Split:
    """Wall time of a call by stage.  `stages` is a sequence of (stage,
    module, function name); while active, each named function is replaced
    by a timer around it that synchronizes the card before each clock
    read.  With `keep`, each call's arguments and result are kept in
    `kept[stage]` as ((args, kwargs), out).  The host classification is
    the sum of the stages "bfs", "find_cycle" and "render" where they are
    timed."""

    HOST = ("bfs", "find_cycle", "render")

    def __init__(self, stages, keep: bool = False):
        self.stages = stages
        self.keep = keep
        self.s = {}
        self.calls = {}
        self.kept = {}

    def __enter__(self):
        self.s = dict.fromkeys((stage for stage, _, _ in self.stages), 0.0)
        self.calls = dict.fromkeys(self.s, 0)
        self.kept = {stage: [] for stage in self.s}
        self.saved = []
        for stage, module, fname in self.stages:
            fn = getattr(module, fname)
            self.saved.append((module, fname, fn))
            setattr(module, fname, self._timed(stage, fn))
        return self

    def _timed(self, stage, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.s[stage] += time.perf_counter() - t0
            self.calls[stage] += 1
            if self.keep:
                self.kept[stage].append(((args, kw), out))
            return out
        return run

    def __exit__(self, *exc):
        for module, fname, fn in reversed(self.saved):
            setattr(module, fname, fn)
        return False

    def __str__(self):
        out = ", ".join(f"{k} {v:.4f} s" for k, v in self.s.items())
        if any(k in self.s for k in self.HOST):
            host = sum(self.s.get(k, 0.0) for k in self.HOST)
            out += f"; host classification {host:.4f} s"
        return out


def la_split():
    """`Split` of one `list_append.check`: pad (`pad_packed`), infer,
    sweeps (one `detect_cycles` per projection), and the three parts of
    host classification: the witness BFS (`_materialize_host_edges`,
    `_witness_regions`), the cycle search (`find_cycle`) and the rendering
    (`_render`)."""
    from jepsen_tpu_torch.checkers.elle import list_append as la

    return Split((("pad", la, "pad_packed"), ("infer", la, "infer"),
                  ("sweeps", la, "detect_cycles"),
                  ("bfs", la, "_materialize_host_edges"),
                  ("bfs", la, "_witness_regions"),
                  ("find_cycle", la, "find_cycle"),
                  ("render", la, "_render")))


def explained_cycles(result) -> int:
    """Number of rendered cycles in a `check` result; asserts that every
    edge of each carries the explainer's justification."""
    n = 0
    for reports in result["anomalies"].values():
        for rep in reports:
            if "cycle" in rep:
                assert rep["cycle"], rep
                assert all(e.get("why") for e in rep["cycle"]), rep
                n += 1
    assert n > 0, result["anomaly-types"]
    return n


def op_histories():
    """(name, op history, anomaly types it must show): the G1c pair and
    the G1a / G1b / internal history of tests/test_device_la.py, built
    with the port's own `history` module."""
    from jepsen_tpu_torch.history import fail, history, invoke, ok

    def concurrent(*txns):
        inv, comp = [], []
        for i, (mops_inv, mops_ok) in enumerate(txns):
            inv.append(invoke(i, "txn", mops_inv))
            comp.append(fail(i, "txn", mops_inv) if mops_ok == "fail"
                        else ok(i, "txn", mops_ok))
        return history(inv + comp)

    yield "G1c pair", concurrent(
        ([["append", "x", 1], ["r", "y", None]],
         [["append", "x", 1], ["r", "y", [9]]]),
        ([["append", "y", 9], ["r", "x", None]],
         [["append", "y", 9], ["r", "x", [1]]])), {"G1c"}
    yield "G1a / G1b / internal", concurrent(
        ([["append", "x", 1], ["append", "x", 2]],
         [["append", "x", 1], ["append", "x", 2]]),
        ([["r", "x", None]], [["r", "x", [1]]]),
        ([["append", "y", 7]], "fail"),
        ([["r", "y", None]], [["r", "y", [7]]]),
        ([["append", "z", 5], ["r", "z", None]],
         [["append", "z", 5], ["r", "z", [5, 9]]])), \
        {"G1a", "G1b", "internal"}


def rw_op_histories():
    """(name, rw-register PackedTxns): a G1c pair, write skew and a cyclic
    version order, built with the port's own `history` module; the last
    gives the version sweep a backward edge."""
    from jepsen_tpu_torch.history import history, invoke, ok, pack_txns

    def concurrent(*txns):
        return pack_txns(history(
            [invoke(i, "txn", inv) for i, (inv, _) in enumerate(txns)]
            + [ok(i, "txn", done) for i, (_, done) in enumerate(txns)]),
            "rw-register")

    yield "G1c pair", concurrent(
        ([["w", "x", 1], ["r", "y", None]], [["w", "x", 1], ["r", "y", 9]]),
        ([["w", "y", 9], ["r", "x", None]], [["w", "y", 9], ["r", "x", 1]]))
    yield "write skew", concurrent(
        ([["r", "x", None], ["w", "y", 10]],
         [["r", "x", None], ["w", "y", 10]]),
        ([["r", "y", None], ["w", "x", 1]],
         [["r", "y", None], ["w", "x", 1]]))
    yield "cyclic versions", concurrent(
        ([["r", "x", None], ["w", "x", 2]], [["r", "x", 1], ["w", "x", 2]]),
        ([["r", "x", None], ["w", "x", 1]], [["r", "x", 2], ["w", "x", 1]]))


# ---- phase 9 corpora: the generators of tests/test_invariants.py, copied
# (with the port's `Op`/`History`; `bank_history` also takes per-account
# balances and the largest transfer, whose defaults give the original)


def bank_history(n_ops=60, n_accounts=4, balance=10, seed=0,
                 max_transfer=4):
    """Serial bank history: transfers conserve, reads snapshot.
    `balance` is every account's opening balance, or one per account."""
    import random

    from jepsen_tpu_torch.history.ops import History, Op

    rng = random.Random(seed)
    opening = (balance if isinstance(balance, (list, tuple))
               else [balance] * n_accounts)
    accounts = {i: opening[i] for i in range(n_accounts)}
    ops = []
    for i in range(n_ops):
        p = rng.randrange(3)
        if rng.random() < 0.5:
            ops.append(Op(type="invoke", process=p, f="read", value=None))
            ops.append(Op(type="ok", process=p, f="read",
                          value=dict(accounts)))
        else:
            frm, to = rng.sample(range(n_accounts), 2)
            amt = 1 + rng.randrange(max_transfer)
            v = {"from": frm, "to": to, "amount": amt}
            ops.append(Op(type="invoke", process=p, f="transfer", value=v))
            if accounts[frm] >= amt:
                accounts[frm] -= amt
                accounts[to] += amt
                ops.append(Op(type="ok", process=p, f="transfer", value=v))
            else:
                ops.append(Op(type="fail", process=p, f="transfer",
                              value=v, error="insufficient"))
    return History(ops)


def inject_bank_wrong_total(h, seed=0):
    import random

    rng = random.Random(seed)
    reads = [op for op in h.ops if op.type == "ok" and op.f == "read"]
    op = reads[rng.randrange(len(reads))]
    a = sorted(op.value)[0]
    op.value[a] += 3  # breaks conservation, stays non-negative
    return h


def inject_bank_negative(h, seed=0):
    import random

    rng = random.Random(seed)
    reads = [op for op in h.ops if op.type == "ok" and op.f == "read"]
    op = reads[rng.randrange(len(reads))]
    a, b = sorted(op.value)[:2]
    shift = op.value[a] + 5
    op.value[a] -= shift  # negative, but the TOTAL is conserved
    op.value[b] += shift
    return h


def lf_history(groups=3, group_size=3, n_reads=12, seed=0):
    """Serial long-fork history: each key written once, group reads
    observe the committed prefix."""
    import random

    from jepsen_tpu_torch.history.ops import History, Op

    rng = random.Random(seed)
    ops = []
    written = {}
    keys = list(range(groups * group_size))
    to_write = list(keys)
    rng.shuffle(to_write)
    p = 0

    def group_read():
        g = rng.randrange(groups)
        ks = range(g * group_size, (g + 1) * group_size)
        mops = [["r", k, written.get(k)] for k in ks]
        inv = [["r", k, None] for k in ks]
        return inv, mops

    reads_done = 0
    while to_write or reads_done < n_reads:
        p = (p + 1) % 4
        if to_write and (reads_done >= n_reads or rng.random() < 0.5):
            k = to_write.pop()
            ops.append(Op(type="invoke", process=p, f="txn",
                          value=[["w", k, k]]))
            ops.append(Op(type="ok", process=p, f="txn",
                          value=[["w", k, k]]))
            written[k] = k
        else:
            inv, mops = group_read()
            ops.append(Op(type="invoke", process=p, f="txn", value=inv))
            ops.append(Op(type="ok", process=p, f="txn", value=mops))
            reads_done += 1
    return History(ops)


def inject_long_fork(h):
    """Split two reads of one group: read A forgets k2, read B forgets
    k1 — the two now order the writes oppositely."""
    reads = [op for op in h.ops
             if op.type == "ok" and op.f == "txn"
             and all(m[0] == "r" for m in (op.value or []))]
    for ia in range(len(reads)):
        for ib in range(ia + 1, len(reads)):
            a, b = reads[ia], reads[ib]
            ka = {m[1] for m in a.value}
            if ka != {m[1] for m in b.value}:
                continue
            obs_a = {m[1] for m in a.value if m[2] is not None}
            obs_b = {m[1] for m in b.value if m[2] is not None}
            both = sorted(obs_a & obs_b)
            if len(both) < 2:
                continue
            k1, k2 = both[:2]
            for m in a.value:
                if m[1] == k2:
                    m[2] = None
            for m in b.value:
                if m[1] == k1:
                    m[2] = None
            return h
    raise AssertionError("corpus has no injectable read pair")


def ws_history(pairs=2, n_txns=20, seed=0):
    """Serial write-skew-workload history (valid): read the pair,
    write one key."""
    import random

    from jepsen_tpu_torch.history.ops import History, Op

    rng = random.Random(seed)
    kv = {}
    ops = []
    val = 0
    for i in range(n_txns):
        p = rng.randrange(3)
        g = rng.randrange(pairs)
        k1, k2 = 2 * g, 2 * g + 1
        inv = [["r", k1, None], ["r", k2, None]]
        mops = [["r", k1, kv.get(k1)], ["r", k2, kv.get(k2)]]
        if rng.random() < 0.8:
            w = rng.choice((k1, k2))
            inv.append(["w", w, val])
            mops.append(["w", w, val])
            kv[w] = val
            val += 1
        ops.append(Op(type="invoke", process=p, f="txn", value=inv))
        ops.append(Op(type="ok", process=p, f="txn", value=mops))
    return History(ops)


def inject_write_skew(h):
    """Rewrite two updating txns of one pair into the classic skew:
    both read the same pre-state, each writes a different key."""
    upd = [op for op in h.ops if op.type == "ok" and op.f == "txn"
           and any(m[0] == "w" for m in op.value)]
    for ia in range(len(upd)):
        for ib in range(ia + 1, len(upd)):
            a, b = upd[ia], upd[ib]
            ga = {m[1] // 2 for m in a.value}
            gb = {m[1] // 2 for m in b.value}
            if len(ga) == 1 and ga == gb:
                g = next(iter(ga))
                k1, k2 = 2 * g, 2 * g + 1
                # pre-state: what the FIRST txn read
                pre = {m[1]: m[2] for m in a.value if m[0] == "r"}
                wa = next(m for m in a.value if m[0] == "w")
                wb = next(m for m in b.value if m[0] == "w")
                if wa[1] == wb[1]:
                    wb[1] = k2 if wa[1] == k1 else k1
                # both read the identical pre-state (so each misses
                # the other's write), write different keys
                for m in b.value:
                    if m[0] == "r":
                        m[2] = pre[m[1]]
                # later reads must not re-anchor b's write after a's:
                # drop b's written value from any later read
                for op in h.ops:
                    if op is a or op is b or op.type != "ok" \
                            or op.f != "txn":
                        continue
                    for m in op.value:
                        if m[0] == "r" and m[1] == wb[1] \
                                and m[2] == wb[2]:
                            m[2] = pre.get(m[1])
                return h
    raise AssertionError("corpus has no injectable txn pair")


def sess_history(n_keys=3, n_txns=30, seed=0, pin_keys=False):
    """Serial session history: rmw chains + reads (valid).
    ``pin_keys=True`` gives every process its own key."""
    import random

    from jepsen_tpu_torch.history.ops import History, Op

    rng = random.Random(seed)
    kv = {}
    ops = []
    val = 0
    for i in range(n_txns):
        p = rng.randrange(3)
        k = p % n_keys if pin_keys else rng.randrange(n_keys)
        if rng.random() < 0.6:
            mops = [["r", k, kv.get(k)], ["w", k, val]]
            inv = [["r", k, None], ["w", k, val]]
            kv[k] = val
            val += 1
        else:
            mops = [["r", k, kv.get(k)]]
            inv = [["r", k, None]]
        ops.append(Op(type="invoke", process=p, f="txn", value=inv))
        ops.append(Op(type="ok", process=p, f="txn", value=mops))
    return History(ops)


def inject_session_break(h):
    """Make one process's LATER read of a key observe an EARLIER
    version it had already read past (monotonic-reads break)."""
    per_proc = {}
    for op in h.ops:
        if op.type == "ok" and op.f == "txn":
            for m in op.value:
                if m[0] == "r" and m[2] is not None:
                    per_proc.setdefault((op.process, m[1]),
                                        []).append((op, m))
    for (p, k), evs in sorted(per_proc.items(), key=repr):
        if len(evs) >= 2:
            prior_val = evs[-2][1][2]
            last_op, last_m = evs[-1]
            # rewind the session's LAST read to the initial state —
            # strictly earlier than the prior read's version — inside
            # a pure-read txn (so no other chain is disturbed)
            if prior_val is not None and len(last_op.value) == 1:
                last_m[2] = None
                return h
    raise AssertionError("corpus has no injectable session pair")


def closed_predicate_histories():
    """(name, history, models, valid?): the seven micro-histories of
    tests/test_closed_predicate.py, built with the port's `history`."""
    from jepsen_tpu_torch.history import fail, history, invoke, ok

    def serial(*events):
        return history([{"invoke": invoke, "ok": ok}[t](p, "txn", v)
                        for t, p, v in events])

    def concurrent(*txns):
        inv, comp = [], []
        for i, (mops_inv, mops_ok) in enumerate(txns):
            inv.append(invoke(i, "txn", mops_inv))
            comp.append(fail(i, "txn", mops_inv) if mops_ok == "fail"
                        else ok(i, "txn", mops_ok))
        return history(inv + comp)

    ins_a, ins_b = [("insert", "a", 1)], [("insert", "b", 2)]
    rp_all = [("rp", "all", None)]
    yield "valid serial inserts", serial(
        ("invoke", 0, ins_a), ("ok", 0, ins_a), ("invoke", 0, ins_b),
        ("ok", 0, ins_b), ("invoke", 1, rp_all),
        ("ok", 1, [("rp", "all", {"a": 1, "b": 2})])), \
        ["serializable"], True
    yield "phantom write skew", concurrent(
        (rp_all + ins_a, [("rp", "all", {})] + ins_a),
        (rp_all + ins_b, [("rp", "all", {})] + ins_b)), \
        ["serializable"], False
    yield "read-all misses an insert", serial(
        ("invoke", 0, ins_a), ("ok", 0, ins_a), ("invoke", 1, rp_all),
        ("ok", 1, [("rp", "all", {})])), ["strict-serializable"], False
    yield "equality predicate", serial(
        ("invoke", 0, ins_a), ("ok", 0, ins_a), ("invoke", 0, ins_b),
        ("ok", 0, ins_b), ("invoke", 1, [("rp", ("=", 1), None)]),
        ("ok", 1, [("rp", ("=", 1), {"a": 1})])), ["serializable"], True
    yield "delete then read-all", serial(
        ("invoke", 0, ins_a), ("ok", 0, ins_a),
        ("invoke", 0, [("delete", "a")]), ("ok", 0, [("delete", "a")]),
        ("invoke", 1, rp_all), ("ok", 1, [("rp", "all", {})])), \
        ["strict-serializable"], True
    yield "structural", serial(
        ("invoke", 0, ins_a), ("ok", 0, ins_a),
        ("invoke", 0, [("insert", "a", 9)]), ("ok", 0, [("insert", "a", 9)]),
        ("invoke", 1, rp_all), ("ok", 1, [("rp", "all", {"a": 7})])), \
        ["serializable"], False
    yield "G1c predicate wr cycle", concurrent(
        (ins_a + rp_all, ins_a + [("rp", "all", {"a": 1, "b": 2})]),
        (ins_b + rp_all, ins_b + [("rp", "all", {"a": 1, "b": 2})])), \
        ["read-committed"], False


# ---- phase 10 corpora: the builders of tests/test_queue_checkers.py,
# copied onto the port's workloads (this script may not import the JAX
# package); tests/test_torch_queue_workloads.py pins them equal


def sim_kafka(seed, *, ops=80, n_clients=3, freeze=False, gen_kw=None,
              **knobs):
    """A deterministic single-threaded kafka sim: seeded generator,
    seeded per-client adversary rngs, no scheduler noise — the corpus IS
    a function of (seed, knobs)."""
    import random

    from jepsen_tpu_torch.history.ops import history
    from jepsen_tpu_torch.workloads import kafka

    rng = random.Random(seed)
    st = kafka.KafkaStore()
    st.freeze_commits = freeze
    clients = [kafka.KafkaClient(st, rng=random.Random(seed * 100 + i),
                                 **knobs)
               for i in range(n_clients)]
    for c in clients:
        c.member = st.new_member()
    g = kafka.gen(rng=rng, **(gen_kw or KAFKA_GEN))
    raw, idx = [], 0
    for i in range(ops):
        c = clients[i % n_clients]
        op = dict(g(None, None), process=i % n_clients, index=idx,
                  type="invoke")
        idx += 1
        raw.append(op)
        done = dict(c.invoke(None, dict(op)), index=idx)
        idx += 1
        raw.append(done)
    return history(raw, reindex=False)


def sim_mem_queue(seed, *, ops=60, drain=True, **knobs):
    """Enqueues of fresh values and dequeues, half and half, from three
    processes on one `MemClient`; with `drain`, a fourth process then
    dequeues until the queue is empty."""
    import random

    from jepsen_tpu_torch.history.ops import history
    from jepsen_tpu_torch.workloads.mem import MemClient, MemStore

    rng = random.Random(seed)
    mc = MemClient(MemStore(), rng=random.Random(seed + 1),
                   **knobs).open(None, "n1")
    raw, idx, counter = [], 0, 0
    for i in range(ops):
        if rng.random() < 0.5:
            op = {"f": "enqueue", "value": counter}
            counter += 1
        else:
            op = {"f": "dequeue", "value": None}
        op = dict(op, process=i % 3, index=idx, type="invoke")
        idx += 1
        raw.append(op)
        out = dict(mc.invoke(None, dict(op)), index=idx)
        idx += 1
        raw.append(out)
    while drain:
        op = {"f": "dequeue", "value": None, "process": 3,
              "index": idx, "type": "invoke"}
        idx += 1
        raw.append(op)
        out = dict(mc.invoke(None, dict(op)), index=idx)
        idx += 1
        raw.append(out)
        if out["type"] == "fail":
            break
    return history(raw, reindex=False)


# ---- phase 12 corpus: BASELINE config 5's histories, with copies of
# scripts/config5_batch.py's generator arguments and `seed_invalid` (this
# script may not import the JAX package); tests/test_torch_batch.py pins
# them equal


def seed_invalid(p):
    """Flip one observed append's writer txn to FAIL: an aborted read
    (G1a) every reader of that value exposes.  Invalid AND convergent: a
    failed writer only flips counts, so the batched verdict stays exact
    with no rerun.  Mutates `p` and returns it."""
    from jepsen_tpu_torch.history.soa import MOP_READ, TXN_FAIL, TXN_OK

    kinds = np.asarray(p.mop_kind)
    keys = np.asarray(p.mop_key)
    vals = np.asarray(p.mop_val)
    txns = np.asarray(p.mop_txn)
    app = np.flatnonzero(kinds != MOP_READ)
    reads = np.flatnonzero((kinds == MOP_READ) & (p.mop_rd_len > 0))
    for r in reads[:500]:
        start, ln = int(p.mop_rd_start[r]), int(p.mop_rd_len[r])
        for off in range(ln):
            vid = p.rd_elems[start + off]
            for wi in app[(vals[app] == vid) & (keys[app] == keys[r])]:
                wt = int(txns[wi])
                if wt != int(txns[r]) and p.txn_type[wt] == TXN_OK \
                        and p.txn_type[int(txns[r])] == TXN_OK:
                    p.txn_type[wt] = TXN_FAIL
                    return p
    raise AssertionError("no seedable observed append found")


def config5_history(i: int, n_txns: int):
    """History `i` of phase 12's batch: `scripts/config5_batch.py`'s
    generator and key rule; every `C5_INVALID_EVERY`-th seeded invalid
    (`seed_invalid`), history `C5_STALE_AT` with `N_STALE` stale reads."""
    from jepsen_tpu_torch.workloads.synth import packed_la_history

    p = packed_la_history(n_txns, n_keys=max(64, n_txns // 8), seed=i,
                          **C5_KW)
    if i % C5_INVALID_EVERY == C5_INVALID_EVERY - 1:
        return seed_invalid(p)
    if i == C5_STALE_AT:
        return stale_reads(p)
    return p


def walk(a, b, path=""):
    """Pairs of leaf tensors of two `infer` outputs."""
    if isinstance(a, dict):
        for key in a:
            yield from walk(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from walk(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


def profile(phase: int, what: str, fname: str, fn) -> dict[str, int]:
    """One run of `fn` under torch.profiler: device time by operator and
    kernel, the top of the table printed, the whole table written to
    chiprun_out/.  Returns the call count of each operator."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from torch.autograd import DeviceType

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write(table)
    # the table's "Self CUDA time total": kernel time, summed
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user", False)) / 1e6
    log(f"[{phase}] profiled {what}, top device time:")
    log("\n".join(table.splitlines()[:18]))
    log(f"[{phase}] device time {busy:.4f} s of {wall:.4f} s wall under the "
        f"profiler: the card idles {100 * (1 - busy / wall):.1f}% of it")
    return {e.key: e.count for e in events}


if __name__ == "__main__":
    sys.exit(main())
