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
        at 8,192 txns: a G-single-family anomaly with explained cycles,
        segmented-OR launches, and the check's time split into pad, infer,
        sweeps and host classification (witness BFS, cycle search,
        rendering);
     c. card == CPU: the whole result dict of 6b's check against the same
        check on the CPU, run in a worker process (`Twins`) beside the
        card's phases;
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
        16,384-txn stale-read history (fused path first; the CPU's in a
        worker process, `Twins`), every `infer_rw`
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
     that script's) and history 2 with 64 stale reads, made in worker
     processes (`Twins`) from the script's start:
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
        valid, a failed writer, stale reads; the CPU's in a worker);
 13. a stored run streamed to the card through `store` and
     `checkers.elle.stream`:
     a. `synth.la_history(n_txns=50,000, n_keys=6,250, concurrency=10)`
        (100,000 ops) saved with `store.save_0` into a temporary store and
        checked by `stream.check_stored`: valid, equal to `core_check_exact`
        on `pad_packed(pack_txns(h))`; the save, the staging (decode,
        pack and copies) against the decode and pack alone, the check,
        the chunks, peak device memory and launches;
     b. the same history with `inject_wr_cycle`: invalid, G1c;
     c. `rw_history(n_txns=50,000)` through
        `check_stored(workload="rw-register")`, equal to `device_rw.check`;
     d. card == CPU at 16,384 txns: every staged array and the dicts of
        both routes;
 14. a Jepsen test run on the card, through `python -m jepsen_tpu_torch`'s
     suite (`cli.run(__main__.suite(), argv)`, in process) on
     the in-process sim cluster, with a store under `build/`:
     a. `test-all --only append -n n1 ... -n n5 -c 10n --ops 50000
        --time-limit 120` (50 workers, 100,000 ops): exit 0, valid, no
        error, LOCF launches; the workload's time and rate, `save_0`, the
        check and its part on the card (infer and sweeps), the history's
        size, launches and peak device memory; the backward edges of each
        projection and of the largest component of their rank intervals;
     b. `analyze DIR` on 14a's run: the same dict, and the same stored
        history through `AppendChecker(device="cpu")` gives it too;
     c. 14a's history, as 14b decoded it, with one G1c injected by
        `synth.inject_wr_cycle` (among its first txns), saved with
        `store.save_0`, then `analyze`: invalid, G1c, seg-OR launches,
        SVGs under the run's `elle/`; card == CPU, the dicts and the SVG
        bytes;
     d. `test-all --only wr ... --ops 50000`: valid or unknown (as
        `tests/test_workloads.py` allows), card == CPU on its history;
     e. one child process, `python -X importtime -m jepsen_tpu_torch
        test-all --only append --ops 2000` with no `--cpu`: exit 0,
        `results.json` valid, and neither `jax` nor `jepsen_tpu` among
        its imports;
 15. the JAX package's other nine demos as Jepsen tests on the card,
     through the same suite, each at its `_wl` defaults, into a store
     under `build/`:
     a. `test-all --only <demo> -n n1 ... -n n5 --ops 20000 -c 10n`
        (50 workers) for bank, long-fork, set, queue, causal, write-skew
        and session, `-c 2n` (10 workers) for kafka, and `-c 2n --ops
        1000` for lin-register (BASELINE config 1's size): exit 0 and
        valid? true, the rule of each demo's tests in the JAX package;
        each run's workload time and rate, `save_0`, the check and its
        parts on the card (each family's `with_fallback` call, the
        `detect_cycles` sweeps, Knossos's device leg, which races the
        host legs), LOCF and seg-OR launches (session: at least 2) and
        peak device memory; `analyze` of the bank run, the same dict;
     b. `inject_long_fork` in 15a's long-fork run, saved with
        `store.save_0`, then `analyze`: exit 1, valid? false, a long
        fork whose cycle the sweep on the card found; a queue run
        with `queue-adversary` `{"lose-enqueue-p": 0.001}` and a kafka
        run whose test map's `"faults"` plan names `client.dup-send`:
        exit 1, valid? false, `queue-lost` and `duplicate`;
     c. card == CPU: every run of 15a-15b decoded from the store and
        checked by `__main__.demo_checker(name, cpu=True)` in a worker
        (`Twins`), the same dict (lin-register's without `algorithm`,
        the race's winner).
 16. one component past MAX_K_CAP backward edges on the card, then the
     first suites against real processes, each through its command line
     in process (`cli.run(suite(), argv)`), into a store under `build/`:
     a. `jitter_history(8,000)` (50 workers whose completions come back
        out of apply order) through `list_append.check` under strict
        serializability, valid and with `synth.inject_wr_cycle`: the
        largest component past 8,192 edges, valid and then G1c; the
        groups of components and their column batches, the check split
        into pad, infer, sweeps, the groups' sweeps and their meta
        closures, the launches and peak device memory; every
        projection's witnesses against the backward edges whose ends
        share a strongly connected component on the host (scipy);
        `_closure_diagonal` of a random 4,096-node matrix against the
        host's strongly connected components, and one closure step at
        the component cap (98,304 edges) with its time and memory;
        card == CPU at 1,000 txns with MAX_K_CAP lowered to 256 on both
        sides (the CPU's in a worker), each equal to the card's dict at
        the full cap;
     b. (after 16c, whose CPU twins then run beside it) `python -m
        jepsen_tpu_torch.dbs.sqlite test-all --only append` and `--only
        wr`, `-c 10 --ops 20000`: exit 0 and valid; each
        run's workload rate, `save_0`, the check and its part on the
        card, launches (LOCF in the append check), the backward edges
        and largest component of each projection, peak device memory;
     c. the regd suite on three daemons over TCP, each run on ports
        the OS reports free (`--base-port`): stale reads on
        blocked backups under strict serializability, 120 ops, first
        (its CPU twin is the phase's longest): exit 1, valid? false;
        `python -m jepsen_tpu_torch.dbs.regd_suite test-all --only
        append -n n1 -n n2 -n n3 --time-limit 30`: valid; the same run
        with the primary killed and restarted between three phases of
        3,300 ops: valid, with ok txns on both sides of the restart;
        each line as 16b's, with the fail and info completions;
     d. `perf()`, `html_timeline()` and `Stats` composed on 16c's
        stored run: the size of `timeline.html` in the store and
        whether the plots were made or skipped (no matplotlib);
     and card == CPU: each stored run of 16b-16c checked by its
     workload's checker on the CPU in a worker, the same dict.
 17. Jepsen tests under the fault packages of `nemesis.combined`, each
     through `core.run` into a store under `build/`, the package on the
     test map (`"nemesis-packages"`, which shades the perf plots' fault
     windows), its generator on the nemesis thread beside the clients
     under a time limit, then its final heal ops (17b and 17c run
     first, so that their CPU twins run beside 17a):
     a. the toy raft (`dbs/toyraft.append_test`, n1-n5, 10 workers
        staggered 3 ms apart, as regd's are, strict serializability)
        under the partition, kill and membership packages
        (`ToyRaftMembers`), a fault every second for 15 s: valid, with
        partitions, kills and an ok membership change completed; then
        `tests/test_toyraft.py`'s stale-read run (n5 isolated, its
        local reads served without a quorum, about 110 ops) under
        strong snapshot isolation: invalid;
     b. the `append` demo on `MemClient` (10 workers) under the skew and
        membership packages (`SimClockSkewNemesis` serves reads from a
        snapshot; `SimMembershipState`), 1,000 txns paced over 5 s:
        invalid, its cycles found by the sweeps on the card (seg-OR
        launches);
     c. the regd suite on three daemons on free ports under the kill
        package (`RegDB.kill`, a kill or a restart every 4 s) for 20 s:
        valid, with a kill and a restart completed;
     each run's workload rate, its ok, fail and info txns, its fault ops
     by `f` with their completion types, `save_0`, the check and its
     part on the card, the backward edges and largest component of
     each projection, launches and peak device memory; and card == CPU:
     each stored run checked by its workload's checker on the CPU in a
     worker, the same dict.
 18. telemetry and live checking on the card, through `core.run` into a
     store under `build/` (`check_live`):
     a. the `append` demo on the sim cluster, n1-n5 and 50 workers,
        20,000 txns, with telemetry on, `"profile-dir"` under
        `chiprun_out/` (a `torch.profiler` trace) and `"live-check":
        {"inproc": true}` (an in-process verifier session fed by the
        interpreter while the workload runs, sealed at the end): valid;
        the sealed session's verdict, its incremental verdict and the
        results agree; `telemetry.json` and `trace.json` written, the
        span tree holding `run`, `workload`, `store.save_0`, `check:*`,
        `live-check.open` and `live-check.finish`; every span with a
        `device_time_ns` (CUDA events) has it above 0 and at most its
        wall time; the profiler's device events name the LOCF kernel;
        LOCF launches; the workload, check and seal times and the count
        of `verifier.sweep` spans;
     b. 18a's history with one G1c (`synth.inject_wr_cycle`) fed in
        segments of 256 ops to a fresh session through
        `VerifierService.ingest`, a rolling verdict after each: invalid
        from the segment that closes the cycle; the seal gives G1c,
        equal to the batch check (`list_append.check` on the card, with
        seg-OR launches);
     c. `verifier.sweep.batched_sweep` over 64 sessions of 2,000 txns,
        every 8th with a G1c: one `detect_cycles` dispatch on the card;
        each session's verdict digest equal to its own per-session
        sweep's on the CPU in a worker; the dispatch's time, nodes and
        edges;
     d. 18b's service closed and reopened over its store: the journal
        replays to the identical `verdict_digest`;
     e. `trace DIR --top 10` and `tail DIR` of 18a's run through
        `cli.run`, in process: both exit 0;
     f. card == CPU: 18a's and 18b's stored histories fed to sessions on
        the CPU in a worker, sealed: the same digests and verdicts.
The launch counters are set to 0 just before the checks of phase 3, just
before `core_check_exact` in phase 4, just before each `check` of phase
6a and 6b, each counted call of phase 7, each check on the card of phase
9, each counted check of phase 11, the first `check_batch_checkpointed`
call of phase 12, each `check_stored` of 13a-13c, each `cli.run` of
14a-14d, 15a-15b and 16b-16c, each full-size check of 16a and each
`core.run` of 17a-17c, 18a's `core.run` and 18b's seal, and read just
after each (phase 12: after the resumed call); the kernels' `launches` are their sum (phases 8 and 10
assert that they launch neither).  The command's total time,
the card's name and power limit, and a JSON object with one entry per
kernel come before the last line, `{"ok": true, "device": {...}}`.
Longer output (the profiler's tables) goes to `chiprun_out/`.  Three
spawned worker processes (`Twins`) run the CPU twins of 6c, 7d, 12c,
14b, 14c, 15c, 16 and 17 and, from the end of phase 6 on, make the seeded
histories of phases 9-13, which those phases read back from files; the
comparisons of 6c, 7d, 12c, 14b, 14c and 16a, and their lines, come
after phase 18, and the workers are stopped before the script exits.

Process and thread hygiene (`guarded`): the script marks its environment
with `JT_SMOKE_TAG=<pid>.<start time>`, which every process it starts
inherits (daemons started under `setsid` too), and turns SIGTERM and
SIGHUP into `SystemExit`, so that every `finally` runs.  After the
phases, whether they passed or failed, it closes the services it opened
(`opened`), stops the workers and `multiprocessing`'s resource tracker,
kills and logs every process still carrying the mark, and lists the
threads left; then `[end] processes left: N, threads left: M`.  Any left
behind fails the run: exit 1 and no `ok` line.

Imports `torch`, `numpy`, scipy (16a's host reference) and the port; never
`jax` or `jepsen_tpu`.
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
#: 6b-6c: the stale-read check through the API, cut from 65,536 txns to
#: keep the script inside its time limit with phases 15-17 (at 65,536
#: the host's `find_cycle` took 80 of 6b's 86 s, at 16,384 29 of 31 s)
N_API_STALE = 8_192
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
#: 13a: 50,000 txns, a quarter of the size first planned: at 200,000 the
#: whole script took 876.5 s of its 1,200 s on one NVIDIA H100 80GB HBM3
#: host, phase 13 187.5 s of it, most of that the Python decode and pack
#: of the stored ops; at 100,000, with phase 17, 1,044.1 s, phase 13
#: 108.2 s (PERF.md)
STREAM_KW = dict(n_txns=50_000, n_keys=6_250, concurrency=10, seed=0)
STREAM_RW_KW = dict(n_txns=50_000, n_keys=6_250, concurrency=10, seed=0)
N_STREAM_CMP = 16_384        # 13d: card == CPU
#: 14: a Jepsen test run through `python -m jepsen_tpu_torch`'s suite, the
#: flags of the JAX package's demo (`-n n1 ... -n n5 -c 10n`: 50 workers)
RUN_NODES = ("n1", "n2", "n3", "n4", "n5")
#: 14a: append txns (100,000 history ops); 100,000 until phase 18 needed
#: its room (the workload, `save_0` and 14b's decode about 25 s of it)
RUN_OPS = 50_000
RUN_WR_OPS = 50_000          # 14d
RUN_TIME_LIMIT = 120
RUN_CHILD_OPS = 2_000        # 14e

#: 15a: the JAX package's other nine demos through the same suite, each
#: at its `_wl` defaults: (demo, -c, --ops).  lin-register at BASELINE
#: config 1's 1,000 ops from 10 workers, kafka at 10a's 10 clients.
#: causal first: its check, and its CPU twin in a worker, are the
#: longest (the host session walker), so the twin runs beside the rest
DEMO_RUNS = (
    ("causal", "10n", 20_000), ("lin-register", "2n", 1_000),
    ("bank", "10n", 20_000), ("long-fork", "10n", 20_000),
    ("set", "10n", 20_000), ("queue", "10n", 20_000),
    ("kafka", "2n", 20_000), ("write-skew", "10n", 20_000),
    ("session", "10n", 20_000),
)
#: 15b: (demo, -c, --ops, test-map keys the run adds, the anomaly they
#: must show)
DEMO_INJECTED = (
    ("queue", "10n", 20_000,
     {"queue-adversary": {"lose-enqueue-p": 0.001}}, "queue-lost"),
    ("kafka", "2n", 20_000,
     {"faults": {"seed": 0, "p": 0.002, "sites": ["client.dup-send"]}},
     "duplicate"),
)

#: 16a: the reproducer of one component past MAX_K_CAP backward edges
#: (`jitter_history`), at the full cap (8,000 txns: components of about
#: 11,000 edges; at 20,000 each check took 40 s on an H100, more than
#: half of it on the host), and its card == CPU
#: comparison: on the CPU a check at the full cap takes tens of minutes
#: (its 8,192-column planes and closures), so both sides run a smaller
#: one with MAX_K_CAP lowered, which takes the same column-batch path
C1_TXNS = 8_000
C1_MODELS = ["strict-serializable"]
C1_CMP_TXNS = 1_000
C1_CMP_CAP = 256
CLOSURE_CHECK = 4_096        # 16a: the closure against the host's SCCs
#: 16b: the sqlite suite, 10 workers and 20,000 ops a workload
DB_OPS = 20_000
DB_CONC = "10"
#: 16c: the regd suite on three daemons: a 30 s run under the suite's
#: stagger(0.003), the primary crashed and restarted between three
#: phases of as many ops, and `test_regd_stale_reads_caught`'s stale
#: reads run at 120 ops (at its 250 the host classification of the
#: invalid check took 40 s)
REGD_NODES = ("n1", "n2", "n3")
REGD_TIME_LIMIT = 30
REGD_PHASE_OPS = 3_300
REGD_STALE_OPS = 120
#: 17a: the toy raft (`dbs/toyraft.append_test`) from 10 workers under
#: the partition, kill and membership packages, each fault cycle
#: `FAULT_INTERVAL` s, for `RAFT_TIME_LIMIT` s; then
#: `test_toyraft_stale_reads_caught`'s run under strong snapshot
#: isolation (under strict serializability the host's budgeted
#: G-nonadjacent search takes 0.5 s or, on an interleaving without such
#: a cycle, the whole budget: 34 s on one CPU core)
RAFT_CONC = 10
#: 17a's workload seconds: 30 until phase 18 needed the room
RAFT_TIME_LIMIT = 15
#: 17a's clients are staggered as regd's are: unpaced, a lost quorum
#: fails each txn at once, and 30 s made 37,141 txns (25,065 of them
#: fails) whose session check took 13.8 s on the host CPU of an H100
#: machine
RAFT_STAGGER = 0.003
FAULT_INTERVAL = 1.0
RAFT_STALE_MODELS = ("strong-snapshot-isolation",)
#: 17b: the `append` demo on `MemClient` from 10 workers under the skew
#: and membership packages (every `SKEW_INTERVAL` s), `SKEW_TXNS` txns
#: paced by a client latency of `SKEW_LATENCY` s over `SKEW_TIME_LIMIT`
#: s: 1,000 txns, not 5,000, since each skew window's stale reads give
#: the serializable check's host search more cycles to classify (a
#: check of 5,000 took 96 s on one CPU core; of 1,000, 13.2 s beside
#: an H100, 0.1 s of it on the card)
SKEW_TXNS = 1_000
SKEW_LATENCY = 0.04
SKEW_TIME_LIMIT = 5.0
SKEW_INTERVAL = 0.5
#: 17c: the regd suite on three daemons under the kill package, a kill
#: or a restart every `REGD_KILL_INTERVAL` s, for `REGD_KILL_TIME_LIMIT` s
REGD_KILL_INTERVAL = 4.0
REGD_KILL_TIME_LIMIT = 20

#: 18: telemetry and live checking on the card.  18a: the append demo on
#: the sim cluster, 50 workers (`-n n1 ... -n n5 -c 10n`), `LIVE_TXNS` txns,
#: telemetric, profiled, live-checked in process; 18b: its history with one
#: G1c, fed in segments of `LIVE_SEG` ops; 18c: `BATCH_SESSIONS` sessions of
#: `BATCH_TXNS` txns each, every `BATCH_EVERY`-th with a G1c, in one
#: batched sweep
LIVE_TXNS = 20_000
LIVE_SEG = 256
LIVE_MODELS = ("serializable",)   # the verifier service's default
BATCH_SESSIONS = 64
BATCH_TXNS = 2_000
BATCH_EVERY = 8
#: keep 18a's torch.profiler trace in chiprun_out/ up to this size
PROFILE_KEEP_BYTES = 16 << 20

#: worker processes for the work that needs no card (`Twins`), and the
#: torch threads of 14b's and 14c's twins there
TWIN_WORKERS = 3
APPEND_TWIN_THREADS = 4

T_START = time.perf_counter()
TWINS = None

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


def jitter_history(n_txns: int, n_keys: int = 10, concurrency: int = 50,
                   max_mops: int = 4, read_prob: float = 0.5,
                   max_delay: float = 100.0, max_writes_per_key: int = 32,
                   kind: str = "list-append", seed: int = 0):
    """A valid history whose completions come back out of apply order,
    as a real database's do: `concurrency` processes each invoke a txn
    when their last one completes (after a gap drawn from [0, 1)), the
    store applies it at once, in invoke order, and its completion returns
    after a seeded delay drawn from [0, `max_delay`).  Each txn's apply
    point lies between its invoke and its completion, so the history is
    strict serializable; but the sweep ranks txns by completion, so many
    of its ww and wr edges run backward, and their rank intervals overlap
    into components of thousands of edges.  As in the `append` workload,
    `n_keys` keys are active at a time, and a key written
    `max_writes_per_key` times is retired for a fresh one, so that reads
    stay short.  `kind` is "list-append" (`append` and `r` of lists) or
    "rw-register" (`w` of unique values and `r`).  A port `History`, the
    same for the same arguments."""
    import heapq

    from jepsen_tpu_torch.history.ops import INVOKE, OK, History, Op

    append = kind == "list-append"
    rng = np.random.default_rng(seed)
    active = list(range(n_keys))
    db = {k: ([] if append else None) for k in active}
    writes = dict.fromkeys(active, 0)
    ops, events, started, next_val = [], [], 0, 1
    for p in range(concurrency):
        heapq.heappush(events, (float(rng.random()), p, None))
    while events:
        t, p, done = heapq.heappop(events)
        if done is not None:
            ops.append(Op(type=OK, process=p, f="txn", value=done,
                          time=len(ops)))
            heapq.heappush(events, (t + float(rng.random()), p, None))
            continue
        if started == n_txns:
            continue
        started += 1
        mops = []
        for _ in range(int(rng.integers(1, max_mops + 1))):
            slot = int(rng.integers(0, n_keys))
            k = active[slot]
            if rng.random() < read_prob:
                mops.append(["r", k, None])
                continue
            mops.append(["append" if append else "w", k, next_val])
            next_val += 1
            writes[k] += 1
            if writes[k] == max_writes_per_key:
                fresh = max(db) + 1
                active[slot] = fresh
                db[fresh] = [] if append else None
                writes[fresh] = 0
        ops.append(Op(type=INVOKE, process=p, f="txn",
                      value=[list(m) for m in mops], time=len(ops)))
        done = []
        for f, k, v in mops:
            if f == "r":
                v = list(db[k]) if append else db[k]
            elif append:
                db[k].append(v)
            else:
                db[k] = v
            done.append([f, k, v])
        heapq.heappush(events, (t + float(rng.uniform(0, max_delay)), p,
                                done))
    return History(ops)


def component_sizes(g) -> list[int]:
    """The backward edges of sweep graph `g` in each component of their
    rank intervals (`cycle_sweep._interval_components`), in rank order;
    [] with none."""
    from jepsen_tpu_torch.ops import cycle_sweep

    n = g.n_nodes
    back = g.nc_mask & cycle_sweep.backward_test(g.rank, g.nc_src, g.nc_dst,
                                                 n)
    pos = torch.nonzero(back).flatten()
    if len(pos) == 0:
        return []
    rs = g.rank[g.nc_src[pos].clamp(0, n - 1).long()].to(torch.int64)
    rd = g.rank[g.nc_dst[pos].clamp(0, n - 1).long()].to(torch.int64)
    _, comp = cycle_sweep._interval_components(
        rd, rs, torch.ones_like(pos, dtype=torch.bool))
    return torch.bincount(comp).tolist()


def on_a_cycle(g) -> np.ndarray:
    """The plain reference of `detect_cycles`' witnesses on sweep graph
    `g`, on the host: the positions of the backward edges whose ends
    share a strongly connected component of the whole graph, chain edges
    included (scipy's `connected_components`)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = g.n_nodes
    mask = g.nc_mask.cpu().numpy()
    src = np.clip(g.nc_src.cpu().numpy(), 0, n - 1).astype(np.int64)
    dst = np.clip(g.nc_dst.cpu().numpy(), 0, n - 1).astype(np.int64)
    cn = g.chain_nodes.cpu().numpy().astype(np.int64)
    seg = np.cumsum(g.chain_starts.cpu().numpy()) - 1
    live = np.nonzero(g.chain_mask.cpu().numpy())[0]
    # a chain segment runs from one start to the next; its masked-out
    # entries drop out of it
    a, b = live[:-1], live[1:]
    link = seg[a] == seg[b]
    s_all = np.concatenate([src[mask], cn[a[link]]])
    d_all = np.concatenate([dst[mask], cn[b[link]]])
    adj = coo_matrix((np.ones(len(s_all)), (s_all, d_all)), shape=(n, n))
    _, label = connected_components(adj, directed=True, connection="strong")
    rank = g.rank.cpu().numpy()
    pos = np.nonzero(mask & (rank[src] >= rank[dst]))[0]
    return pos[label[src[pos]] == label[dst[pos]]]


class Components:
    """Inside it, each `detect_cycles` call of the Elle checkers records
    its backward edges and those of the largest component of their rank
    intervals (`component_sizes`), as (n_backward, largest) in `seen`,
    one pair a projection.  With `keep`, it also keeps each call's graph
    and result for `check_witnesses`."""

    def __init__(self, keep: bool = False):
        self.seen = []
        self.keep = keep
        self.kept = []

    def __enter__(self):
        from jepsen_tpu_torch.checkers.elle import list_append
        from jepsen_tpu_torch.ops import cycle_sweep

        self.mods = (list_append, cycle_sweep)
        self.orig = cycle_sweep.detect_cycles

        def recorded(g, *args, **kw):
            res = self.orig(g, *args, **kw)
            self.seen.append(
                (res.n_backward,
                 max(component_sizes(g), default=0)))
            if self.keep:
                self.kept.append((g, res))
            return res

        for mod in self.mods:
            mod.detect_cycles = recorded
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.detect_cycles = self.orig

    def largest(self) -> int:
        return max((c for _, c in self.seen), default=0)

    def check_witnesses(self) -> int:
        """Assert that each kept call converged with the witnesses of
        `on_a_cycle`; returns the witnesses checked."""
        n = 0
        for g, res in self.kept:
            want = on_a_cycle(g)
            assert res.converged, res
            assert list(res.witness_edge_ids) == list(want), (
                len(res.witness_edge_ids), len(want))
            n += len(want)
        return n


def free_base(n: int = 3) -> int:
    """A base port whose n consecutive ports the OS reports free, for a
    run's daemons: a fixed port would meet another run's on the same
    machine."""
    import contextlib
    import socket

    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        try:
            with contextlib.ExitStack() as stack:
                for i in range(n):
                    s = stack.enter_context(socket.socket())
                    s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
    raise RuntimeError(f"no {n} consecutive free ports")


def log(*args):
    print(*args, flush=True)


# ---- process and thread hygiene ---------------------------------------------
#
# Every process the run starts carries TAG_VAR in its environment: children
# inherit `os.environ`, and so do daemons started under `setsid` through
# `control/util.start_daemon` (`LoopbackSession.execute` passes the
# environment on, and `env` adds to it).  `guarded` scans for the marker
# after the phases and fails the run on any survivor or leftover thread.

TAG_VAR = "JT_SMOKE_TAG"
#: threads that must never outlive the run, whatever their daemon flag
RUN_THREADS = ("telemetry-sampler", "verifier-maintenance", "live-check-")
#: services, sessions, samplers and streams the phases opened and have not
#: closed; `guarded` closes what is left, last opened first
OPEN: list = []


def opened(obj):
    """Register `obj` (it has `close()`) for `guarded`'s cleanup; returns
    it."""
    OPEN.append(obj)
    return obj


def closed(obj) -> None:
    """Close `obj` now and drop it from `OPEN`."""
    if obj in OPEN:
        OPEN.remove(obj)
    obj.close()


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(
                "utf-8", "replace").strip()
    except OSError:
        return ""


def is_resource_tracker(pid: int) -> bool:
    """`multiprocessing`'s resource tracker: it ends by itself on EOF
    when the process that started it ends."""
    return "multiprocessing.resource_tracker" in _cmdline(pid)


def marked_pids(tag: str, skip=()) -> list[int]:
    """Live processes of this uid whose environment carries
    ``TAG_VAR=tag``, but those in `skip`."""
    needle = f"{TAG_VAR}={tag}".encode()
    uid = os.getuid()
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) in skip:
            continue
        try:
            if os.stat(f"/proc/{name}").st_uid != uid:
                continue
            with open(f"/proc/{name}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue  # gone, or not ours to read
        if needle in env:
            out.append(int(name))
    return out


def _reap_zombies(pids) -> None:
    """Collect the exit status of each of `pids` that is a finished child
    of this process, so that none lingers as a zombie."""
    for pid in pids:
        try:
            os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            pass  # not our child: its own parent (or init) collects it


def reap(tag: str) -> list[tuple[int, str]]:
    """Find every process the run left behind (marked with `tag`; this
    process and the resource tracker aside), log each with its command
    line, send it SIGTERM, wait up to 2 s, then SIGKILL what is left.
    Returns the survivors found, as (pid, cmdline)."""
    import signal

    me = os.getpid()
    found = [(p, _cmdline(p)) for p in marked_pids(tag, skip={me})
             if not is_resource_tracker(p)]
    for pid, cmd in found:
        log(f"[end] left running: pid {pid}: {cmd}")
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    t_end = time.monotonic() + 2.0
    pids = {p for p, _ in found}
    while pids and time.monotonic() < t_end:
        _reap_zombies(pids)
        pids &= set(marked_pids(tag, skip={me}))
        if pids:
            time.sleep(0.05)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    _reap_zombies(p for p, _ in found)
    return found


def leftover_threads() -> list[str]:
    """Every live non-daemon thread but the main one, and every thread
    of a kind that must never outlive a run (`RUN_THREADS`)."""
    import threading

    main = threading.main_thread()
    return [t.name for t in threading.enumerate()
            if t is not main and t.is_alive()
            and (not t.daemon or t.name.startswith(RUN_THREADS))]


def guarded(body) -> int:
    """Run `body()` under the hygiene contract and print its last lines.

    Marks the environment with a fresh ``TAG_VAR`` (every process the body
    starts inherits it) and turns SIGTERM and SIGHUP into `SystemExit`, so
    that every `finally` on the way out runs.  `body` returns the lines
    to print last (the card's line, the kernels line, the `ok` line).
    After it, whether it returned or raised: close what `OPEN` holds,
    stop the CPU twins' pool, stop `multiprocessing`'s resource tracker,
    kill every marked process still alive and list the threads left.  A
    process or thread left behind fails the run: exit 1, and the lines
    are not printed."""
    import gc
    import signal

    global TWINS
    tag = f"{os.getpid()}.{time.time_ns()}"
    prev_tag = os.environ.get(TAG_VAR)
    os.environ[TAG_VAR] = tag

    def stop(signum, _frame):
        raise SystemExit(128 + signum)

    prev_handlers = {sig: signal.signal(sig, stop)
                     for sig in (signal.SIGTERM, signal.SIGHUP)}
    lines = None
    try:
        lines = body()
    finally:
        while OPEN:
            obj = OPEN.pop()
            try:
                obj.close()
            except Exception as e:  # noqa: BLE001 — close the others too
                log(f"[end] closing {type(obj).__name__} failed: {e!r}")
        if TWINS is not None:
            TWINS.close()
            TWINS = None
        gc.collect()
        from multiprocessing import resource_tracker

        stop_tracker = getattr(resource_tracker._resource_tracker,
                               "_stop", None)
        if stop_tracker is not None:
            stop_tracker()
        procs = reap(tag)
        threads = leftover_threads()
        for name in threads:
            log(f"[end] thread left: {name}")
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        if prev_tag is None:
            os.environ.pop(TAG_VAR, None)
        else:
            os.environ[TAG_VAR] = prev_tag
    log(f"[end] processes left: {len(procs)}, threads left: "
        f"{len(threads)}")
    if procs or threads:
        log("chip_smoke: the run left processes or threads behind")
        return 1
    for line in lines:
        log(line)
    return 0


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


QUEUE_KNOBS = ("drained", "lose_enqueue_p", "dup_enqueue_p",
               "reorder_dequeue_p")   # 10c: each mem-store knob alone


def queue_kw(what: str) -> dict:
    return {} if what == "drained" else {what: QUEUE_INJECT_P}


def stale_history(n_txns: int, n_keys: int, seed: int):
    """11c's history: `packed_la_history` with `N_STALE` stale reads."""
    from jepsen_tpu_torch.workloads.synth import packed_la_history

    return stale_reads(packed_la_history(n_txns, n_keys=n_keys, seed=seed))


def prefetch(twins) -> None:
    """Submit the seeded histories of phases 9-13 to `twins`, in the
    order the phases ask for them; each phase `get`s its own."""
    from jepsen_tpu_torch.workloads import synth

    twins.submit("9a", bank_history, **BANK_KW)
    twins.submit("9b", lf_history, **LF_KW)
    twins.submit("9c", ws_history, **WS_KW)
    for pin in (True, False):
        twins.submit(("9d", pin), sess_history, **SESS_KW, pin_keys=pin)
    twins.submit("10a", sim_kafka, 0, **KAFKA_FULL)
    for what in QUEUE_KNOBS:
        twins.submit(("10c", what), sim_mem_queue, 0, ops=QUEUE_OPS,
                     **queue_kw(what))
    twins.submit("11a", synth.packed_la_history, N_10M, n_keys=N_KEYS_10M,
                 seed=0)
    twins.submit("11c", stale_history, N_10M, N_KEYS_10M, 0)
    for i in range(N_C5):
        twins.submit(("c5", i), config5_history, i, N_TXNS)
    twins.submit("13a", synth.la_history, **STREAM_KW)
    twins.submit("13c", synth.rw_history, **STREAM_RW_KW)


def made(twins, key):
    """`twins.get(key)` and its line's words: (history, "made in ... s in
    a worker, read in ... s")."""
    h, t, w = twins.get(key)
    return h, f"made in {t:.2f} s in a worker, read in {w:.2f} s"


class Twins:
    """Work that needs no card, run in a pool of spawned worker processes
    beside the card's phases: the seeded histories of phases 9-13, made
    while phases 7-8 run, and the CPU twins of 6c, 7d, 12c, 14b, 14c and
    15c.
    A job's inputs go to the worker pickled, or it makes them from their
    seeds with this script's own generators.  Its result comes back
    through a file under `build/`, read where `get` asks for it, so that
    no result is unpickled in this process while a phase is timed.
    `later` keeps a comparison whose twin is still running, `finish`
    makes every kept comparison (their lines are logged there, after
    phase 18) and `close` stops the workers and removes the files."""

    def __init__(self, n: int):
        import multiprocessing as mp
        import tempfile

        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_twins_",
                                    dir=os.path.join(HERE, "build"))
        self.pool = mp.get_context("spawn").Pool(n, initializer=_twin_init)
        self.jobs = {}
        self.pending = []
        self.n = 0

    def submit(self, key, fn, *args, **kw):
        path = os.path.join(self.dir, f"{self.n}.pkl")
        self.n += 1
        self.jobs[key] = (path, self.pool.apply_async(
            _run_to_file, (path, fn) + args, kw))

    def get(self, key):
        """(result, the worker's seconds, the seconds waited and read
        here)."""
        import pickle

        t0 = time.perf_counter()
        path, job = self.jobs.pop(key)
        t = job.get()
        with open(path, "rb") as f:
            out = pickle.load(f)
        os.remove(path)
        return out, t, time.perf_counter() - t0

    def later(self, key, compare):
        """Call `compare(result, worker's seconds)` in `finish`."""
        self.pending.append((key, compare))

    def finish(self):
        t0 = time.perf_counter()
        for key, compare in self.pending:
            out, t, _ = self.get(key)
            compare(out, t)
        self.pending = []
        log(f"[end] the twins' comparisons waited "
            f"{time.perf_counter() - t0:.1f} s for their workers")

    def close(self):
        import shutil

        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None
        shutil.rmtree(self.dir, ignore_errors=True)


def _twin_init():
    # leave the cores to the main process and the other workers
    torch.set_num_threads(2)


def _run_to_file(path, fn, *args, **kw):
    """A worker's job: `fn(*args, **kw)` pickled to `path`; returns the
    seconds it took."""
    import pickle

    t0 = time.perf_counter()
    out = fn(*args, **kw)
    t = time.perf_counter() - t0
    with open(path, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    return t


def la_cpu(p, models):
    """6c's twin: `list_append.check` of `p` on the CPU."""
    from jepsen_tpu_torch.checkers.elle import list_append

    return list_append.check(p, models, _force_no_fallback=True,
                             device="cpu")


def rw_cpu(q, models, fused_min_txns):
    """7d's twin: `rw_register.check` of `q` on the CPU, with the card's
    `FUSED_MIN_TXNS`."""
    from jepsen_tpu_torch.checkers.elle import rw_register

    rw_register.FUSED_MIN_TXNS = fused_min_txns
    return rw_register.check(q, models, device="cpu")


def append_cpu(run_dir: str, viz: dict | None = None):
    """14b's and 14c's twin: the stored run at `run_dir`, decoded here,
    through `AppendChecker(device="cpu")`.  With `viz` (a test map's
    name, store-dir and start-time) the check writes its SVGs into a run
    of its own there; they come back as (file name, bytes)."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.workloads import append

    # the workers are otherwise idle by phase 14: a check with backward
    # edges sweeps (n, k) planes on the CPU, which one thread takes
    # minutes over
    torch.set_num_threads(APPEND_TWIN_THREADS)
    test = store.load(run_dir)
    history = test["history"].materialize()
    r = append.AppendChecker(device="cpu").check(
        test if viz is None else dict(viz), history)
    svgs = []
    for f in r.pop("viz-files", []):
        with open(f, "rb") as fh:
            svgs.append((os.path.basename(f), fh.read()))
    return r, svgs


def demo_cpu(run_dir: str):
    """15c's twin: the stored demo run at `run_dir`, decoded here as
    `analyze` decodes it, through `check_safe` of the demo's checker on
    the CPU (`__main__.demo_checker(name, cpu=True)`)."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.__main__ import demo_checker
    from jepsen_tpu_torch.checkers import api as checker_api

    test = store.load(run_dir)
    h = test["history"] = test["history"].materialize()
    return checker_api.check_safe(demo_checker(test["name"], cpu=True),
                                  test, h)


def k_cap(cap: int):
    """A context in which MAX_K_CAP is `cap` in every module that reads
    it (`cycle_sweep`, `device_core`, `device_rw`)."""
    import contextlib

    from jepsen_tpu_torch.checkers.elle import device_core, device_rw
    from jepsen_tpu_torch.ops import cycle_sweep

    @contextlib.contextmanager
    def lowered():
        mods = (cycle_sweep, device_core, device_rw)
        old = [m.MAX_K_CAP for m in mods]
        for m in mods:
            m.MAX_K_CAP = cap
        try:
            yield
        finally:
            for m, v in zip(mods, old):
                m.MAX_K_CAP = v

    return lowered()


def c1_history(n_txns: int, inject: bool):
    """16a's history: `jitter_history` from seed 0, with one G1c
    (`synth.inject_wr_cycle`) if `inject`."""
    from jepsen_tpu_torch.workloads import synth

    h = jitter_history(n_txns, seed=0)
    if inject:
        assert synth.inject_wr_cycle(h)
    return h


def c1_cpu(n_txns: int, cap: int, inject: bool):
    """16a's twin: `c1_history` through `list_append.check` on the CPU,
    with MAX_K_CAP lowered to `cap`."""
    from jepsen_tpu_torch.checkers.elle import list_append

    torch.set_num_threads(APPEND_TWIN_THREADS)
    with k_cap(cap):
        return list_append.check(c1_history(n_txns, inject), C1_MODELS,
                                 device="cpu")


def suite_cpu(run_dir: str, workload: str, models, fused_min_txns: int):
    """16b's and 16c's twin: the stored run at `run_dir`, decoded here,
    through its workload's checker (`append` or `wr`, under `models`)
    on the CPU, as `check_safe` runs it in a test, with the card's
    `rw_register.FUSED_MIN_TXNS` (7d's twin sets another in its
    worker)."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checkers import api as checker_api
    from jepsen_tpu_torch.checkers.elle import rw_register
    from jepsen_tpu_torch.workloads import append, wr

    torch.set_num_threads(APPEND_TWIN_THREADS)
    rw_register.FUSED_MIN_TXNS = fused_min_txns
    test = store.load(run_dir)
    h = test["history"] = test["history"].materialize()
    mod = append if workload == "append" else wr
    checker = mod.workload(consistency_models=models,
                           device="cpu")["checker"]
    return checker_api.check_safe(checker, test, h)


def batch_history(i: int):
    """18c's history `i`: `BATCH_TXNS` txns from `synth.la_history`,
    with a G1c (`inject_wr_cycle`) in every `BATCH_EVERY`-th."""
    from jepsen_tpu_torch.workloads import synth

    h = synth.la_history(n_txns=BATCH_TXNS, n_keys=50, concurrency=10,
                         seed=100 + i)
    if i % BATCH_EVERY == 0:
        assert synth.inject_wr_cycle(h)
    return h


def sweep_cpu(i: int) -> str:
    """18c's twin: `batch_history(i)` through a session of its own on the
    CPU, swept alone; its verdict digest."""
    from jepsen_tpu_torch.verifier import VerifierSession, verdict_digest

    s = VerifierSession(f"solo{i}", LIVE_MODELS, device="cpu")
    s.append_ops(list(batch_history(i)))
    return verdict_digest(s.verdict())


def live_cpu(run_dir: str) -> dict:
    """18f's twin: the stored run at `run_dir` fed to a session on the
    CPU in segments of `LIVE_SEG` ops, then sealed: its verdict, digest
    and whether the seal's batch check agreed."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.verifier import VerifierSession

    torch.set_num_threads(APPEND_TWIN_THREADS)
    ops = [op.to_dict()
           for op in store.load(run_dir)["history"].materialize()]
    s = VerifierSession("twin", LIVE_MODELS, device="cpu")
    for i in range(0, len(ops), LIVE_SEG):
        s.append_ops(ops[i:i + LIVE_SEG])
    sealed = s.seal()
    v = sealed["verdict"]
    return {"digest": sealed["digest"], "equal": sealed["equal"],
            "valid?": v["valid?"], "anomaly-types": v["anomaly-types"]}


def race_free(demo: str, r: dict) -> dict:
    """A lin-register dict without ``algorithm``, the Knossos race's
    winner, which is whichever leg answered first; any other dict as it
    is."""
    if demo != "lin-register":
        return r
    return {k: v for k, v in r.items() if k != "algorithm"}


def batch_cpu(ps):
    """12c's twin: `check_batch` of `ps` on the CPU."""
    from jepsen_tpu_torch.parallel import batch

    return batch.check_batch(ps, device="cpu")


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
    return guarded(lambda: phases(opts))


def phases(opts) -> list[str]:
    """Phases 0-18 (see the module docstring); returns the lines to print
    last."""
    sys.path.insert(0, HERE)
    from jepsen_tpu_torch.checkers.elle import device_core, device_infer
    from jepsen_tpu_torch.ops import fill, kernels, scan
    from jepsen_tpu_torch.workloads.synth import packed_la_history

    global TWINS
    TWINS = twins = Twins(TWIN_WORKERS)

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
    check_api(p, best, launches, twins)

    # the histories of phases 9-13, made in the workers from here on
    prefetch(twins)

    # ---- 7. the rw-register checker and HistoryIR on the card -------------
    t7c = check_rw(p, best, launches, dev, twins)
    del p
    torch.cuda.empty_cache()

    # ---- 8. Knossos linearizability on the card ---------------------------
    check_knossos(dev, t7c)

    # ---- 9. the invariants and the closed predicate on the card -----------
    check_invariants(dev, launches, twins)

    # ---- 10. the queue/kafka checker family on the card -------------------
    check_queue(dev, twins)

    # ---- 11. the 10M-txn rung (BASELINE config 4) on the card -------------
    check_10m(dev, launches, twins)

    # ---- 12. batched checking (BASELINE config 5) on the card -------------
    check_config5(dev, launches, twins)

    # ---- 13. stored runs streamed to the card -----------------------------
    check_stream(dev, launches, twins)

    # ---- 14. a Jepsen test run on the card --------------------------------
    check_run(dev, launches, twins)

    # ---- 15. the other nine demos as Jepsen tests on the card -------------
    check_demos(dev, launches, twins)

    # ---- 16. C1 on the card, then the first real-process suites ---------
    t16 = check_c1(dev, launches, twins)
    t16 += check_dbs(dev, launches, twins)
    log(f"[16] phase 16 took {t16:.1f} s")

    # ---- 17. Jepsen tests under fault packages ------------------------------
    t17 = check_faults(dev, launches, twins)
    log(f"[17] phase 17 took {t17:.1f} s")

    # ---- 18. telemetry and live checking on the card ----------------------
    t18 = check_live(dev, launches, twins)
    log(f"[18] phase 18 took {t18:.1f} s")

    # ---- the CPU twins' comparisons ----------------------------------------
    twins.finish()

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
    return [smi, json.dumps(kernels_line), json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}})]


def check_api(p, best: float, launches: dict, twins: Twins) -> None:
    """Phase 6: `list_append.check` on the card (see the module
    docstring).  `p` is phase 3's history, `best` its best `core_check`
    time; the launches of each counted check are added to `launches`.
    6c's CPU twin runs in `twins`."""
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

    ps6 = stale_reads(packed_la_history(N_API_STALE,
                                        n_keys=N_API_STALE // 8, seed=0))
    twins.submit("6c", la_cpu, ps6, STALE_MODELS)
    r, t, n = counted_check(ps6, STALE_MODELS)
    assert r["valid?"] is False, r["anomaly-types"]
    family = sorted(set(r["anomaly-types"]) & G_SINGLE_FAMILY)
    assert family, r["anomaly-types"]
    n_cycles = explained_cycles(r)
    assert n["locf"] == LOCF_PER_CHECK and n["seg_or"] > 0, n
    log(f"[6b] stale reads, {N_API_STALE} txns, {'+'.join(STALE_MODELS)}: "
        f"check {t:.4f} s ({split}); {split.calls['sweeps']} "
        f"projections; {family}; {n_cycles} cycles, every edge "
        f"explained; launches {n}")

    del ps6

    def compare_6c(want, t_cpu, r=r):
        # 6c: 6b's check on the card against the same check on the CPU
        assert r == want, (r, want)
        log(f"[6c] {N_API_STALE} txns with stale reads: the result dicts are "
            f"equal on card and CPU ({r['anomaly-types']}, "
            f"{explained_cycles(r)} rendered cycles, not {r['not']}, "
            f"also-not {r['also-not']}); the CPU check took {t_cpu:.4f} s "
            f"in a worker")

    twins.later("6c", compare_6c)

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


def check_rw(p_la, best: float, launches: dict, dev: torch.device,
             twins: Twins) -> None:
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
                   ("version sweep", device_rw, "_sweep_window")))
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
    twins.submit("7d", rw_cpu, q, STALE_MODELS, N_CMP)
    saved, rw_register.FUSED_MIN_TXNS = rw_register.FUSED_MIN_TXNS, N_CMP
    try:
        got = rw_register.check(q, STALE_MODELS)
    finally:
        rw_register.FUSED_MIN_TXNS = saved
    assert got["valid?"] is False and explained_cycles(got) > 0, got

    def compare_7d(want, t_cpu, got=got):
        assert got == want, (got, want)
        log(f"[7d] rw_register.check, {N_CMP} txns with stale reads, fused "
            f"path first: the result dicts are equal on card and CPU "
            f"({got['anomaly-types']}); the CPU check took {t_cpu:.4f} s "
            f"in a worker")

    twins.later("7d", compare_7d)
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


def check_invariants(dev: torch.device, launches: dict,
                     twins: Twins) -> None:
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

    hb, how = made(twins, "9a")
    log(f"[9a] bank_history({BANK_KW}): {len(hb.ops)} ops {how}")
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
    h, how = made(twins, "9b")
    ir = HistoryIR(h)
    log(f"[9b] lf_history({LF_KW}): {len(h.ops)} ops {how}")
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
    h, how = made(twins, "9c")
    ir = HistoryIR(h)
    log(f"[9c] ws_history({WS_KW}): {len(h.ops)} ops {how}")
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
        h, how = made(twins, ("9d", pin))
        ir = HistoryIR(h)
        log(f"[9d] sess_history({SESS_KW}, pin_keys={pin}): {len(h.ops)} "
            f"ops {how}")
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


def check_queue(dev: torch.device, twins: Twins) -> None:
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
    h, t_sim, t_read = twins.get("10a")
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
        f"simulated in {t_sim:.2f} s in a worker, read in {t_read:.2f} s; "
        f"{pk.n_sends} sends, {pk.n_polls} "
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
    for what, want in zip(QUEUE_KNOBS, (
            ([], []), ([fifo.LOST], [fifo.LOST]),
            ([fifo.PHANTOM], [fifo.PHANTOM]), ([], [fifo.FIFO]))):
        kw = queue_kw(what)
        h, how = made(twins, ("10c", what))
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
            f"{len(h.ops)} ops {how}, build_s['queue:fifo'] "
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


def check_10m(dev: torch.device, launches: dict, twins: Twins) -> None:
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
    p, how = made(twins, "11a")
    ir = HistoryIR(p)
    torch.cuda.reset_peak_memory_stats()
    h, t_pad = wall_s(lambda: ir.padded(device=dev))
    shapes = (h.txn_type.shape[0], h.mop_txn.shape[0], h.rd_elems.shape[0])
    log(f"[11a] {N_10M} txns, {N_KEYS_10M} keys: {how}, padded + staged "
        f"in {t_pad:.2f} s (T={shapes[0]}, M={shapes[1]}, "
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
    del p
    ps, how = made(twins, "11c")
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
    log(f"[11c] {N_STALE} stale reads at {N_10M} txns ({how}, padded in "
        f"{t_pad:.2f} s): core_check_exact from max_k "
        f"{MAX_K_10M}, sweeps at max_k {ks}: bits {b}, overflow "
        f"{int(over)}, {t_cyc:.4f} s; launches {n}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    del hs, ps
    torch.cuda.empty_cache()
    log(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s")


def check_config5(dev: torch.device, launches: dict, twins: Twins) -> None:
    """Phase 12: BASELINE config 5 on one card (see the module
    docstring).  The counters are set to 0 just before the first
    `check_batch_checkpointed` call and read just after the resumed one;
    the sums go into the main path's `launches`.  The histories come from
    `twins`, which made them from their seeds while the earlier phases
    ran (`prefetch`), and 12c's CPU twin runs there."""
    import shutil
    import tempfile

    from jepsen_tpu_torch.checkers.elle import device_core, device_infer
    from jepsen_tpu_torch.ops import fill, scan
    from jepsen_tpu_torch.parallel import batch

    t12 = time.perf_counter()
    got = [twins.get(("c5", i)) for i in range(N_C5)]
    ps = [p for p, _, _ in got]
    t_gen = sum(t for _, t, _ in got)
    t_wait = sum(w for _, _, w in got)
    invalid = [i for i in range(N_C5)
               if i % C5_INVALID_EVERY == C5_INVALID_EVERY - 1]
    log(f"[12a] {N_C5} histories of {N_TXNS} txns, {max(64, N_TXNS // 8)} "
        f"keys, {C5_KW}: made in {t_gen:.2f} s in {TWIN_WORKERS} "
        f"workers, waited for and read in {t_wait:.2f} s here; a failed "
        f"writer in "
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
    twins.submit("12c", batch_cpu, small)
    (got, t_card) = wall_s(lambda: batch.check_batch(small, device=dev))
    assert [r["valid?"] for r in got] == [True, True, False, False], got

    def compare_12c(want, t_cpu, got=got, t_card=t_card):
        assert got == want, (got, want)
        log(f"[12c] check_batch of 4 x {N_C5_CMP} txns (verdicts "
            f"{[r['valid?'] for r in got]}): card == CPU; card "
            f"{t_card:.4f} s, CPU {t_cpu:.4f} s in a worker")

    twins.later("12c", compare_12c)
    log(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s")


def check_stream(dev: torch.device, launches: dict, twins: Twins) -> None:
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
        h, how = made(twins, "13a")
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
        log(f"[13a] la_history({STREAM_KW}): {len(h)} ops {how}; save_0 "
            f"{t_save:.2f} s, {n_chunks} chunks of "
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
        rw, how = made(twins, "13c")
        d, t_save = save("stream-rw", rw)
        with split:
            r, t_check, n, peak = counted(lambda: stream.check_stored(
                d, workload="rw-register", device=dev))
        want = device_rw.check(pack_txns(rw, "rw-register"), device=dev)
        assert r == dict(want, **{"n-txns": r["n-txns"]}), (r, want)
        assert r["valid?"] is True, r
        log(f"[13c] rw_history({STREAM_RW_KW}): {how}, save_0 "
            f"{t_save:.2f} s; check_stored(workload='rw-register') "
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


def check_run(dev: torch.device, launches: dict, twins: Twins) -> None:
    """Phase 14: a Jepsen test run on the card (see the module docstring),
    driven in process through `python -m jepsen_tpu_torch`'s suite
    (`cli.run(__main__.suite(), argv)`).  The counters are
    set to 0 just before each `cli.run` of 14a-14d and read just after;
    the sums go into the main path's `launches`.  The CPU twins of 14b
    and 14c decode the stored runs and check them in `twins`, beside
    14c-16; their comparisons come in `twins.finish`, which then removes
    the runs."""
    import shutil

    from jepsen_tpu_torch import cli, store
    from jepsen_tpu_torch.__main__ import suite as demo_suite
    from jepsen_tpu_torch.checkers import api as checker_api
    from jepsen_tpu_torch.checkers.elle import list_append
    from jepsen_tpu_torch.generator import interpreter
    from jepsen_tpu_torch.ops import cycle_sweep, fill, scan
    from jepsen_tpu_torch.store.format import LazyHistory
    from jepsen_tpu_torch.workloads import synth, wr

    t14 = time.perf_counter()
    base = os.path.join(HERE, "build", "chip_smoke_runs")
    shutil.rmtree(base, ignore_errors=True)
    suite = demo_suite()
    nodes = [a for n in RUN_NODES for a in ("-n", n)]
    la = list_append
    # a run's stages: the workload (the interpreter), the two saves, the
    # stored history's decode (analyze), and the check split as in 6b;
    # the card's share of the check is infer + sweeps
    stages = (("workload", interpreter, "run"), ("save_0", store, "save_0"),
              ("decode", LazyHistory, "materialize"),
              ("check", checker_api, "check_safe"),
              ("save_1", store, "save_1"),
              ("pad", la, "pad_packed"), ("infer", la, "infer"),
              ("sweeps", la, "detect_cycles"),
              ("bfs", la, "_materialize_host_edges"),
              ("bfs", la, "_witness_regions"),
              ("find_cycle", la, "find_cycle"), ("render", la, "_render"))

    comps = Components()

    def counted(argv):
        """`cli.run(suite, argv)` with the counters set to 0 just before
        it and read just after; returns (exit code, Split, launches,
        peak device memory, the history the run made or decoded).  The
        backward edges of each projection's sweep and of its largest
        component go into `comps.seen`."""
        comps.seen.clear()
        split = Split(stages)
        keep = Split((("history", interpreter, "run"),
                      ("history", LazyHistory, "materialize")), keep=True)
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        with comps, split, keep:
            rc = cli.run(suite, ["--store-dir", base, *argv])
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        return (rc, split, n, torch.cuda.max_memory_allocated(),
                keep.kept["history"][-1][1])

    def on_card(split):
        return split.s["infer"] + split.s["sweeps"]

    def host_s(split):
        return sum(split.s[k] for k in Split.HOST)

    def results(d):
        return store.load(d)["results"]

    try:
        # ---- 14a. test-all --only append, 50 workers -----------------------
        rc, sp, n, peak, h = counted([
            "test-all", "--only", "append", *nodes, "-c", "10n",
            "--ops", str(RUN_OPS), "--time-limit", str(RUN_TIME_LIMIT)])
        d = store.latest("demo-append", base=base)
        r14a = results(d)
        n_txns = sum(op.type == "invoke" for op in h)
        # the completions' order against the apply order: the backward
        # edges of each projection and the largest component of their
        # rank intervals, which the sweep closes up to its cap
        log(f"[14a] backward edges and largest component per projection "
            f"{comps.seen}, the cap "
            f"{cycle_sweep.MAX_COMPONENT_BATCHES * cycle_sweep.MAX_K_CAP}")
        assert rc == 0 and r14a["valid?"] is True, (rc, r14a)
        assert "error" not in r14a, r14a
        assert n["locf"] > 0, n
        log(f"[14a] test-all --only append, {len(RUN_NODES)} nodes, "
            f"10n = 50 workers, --ops {RUN_OPS}: {len(h)} ops ({n_txns} "
            f"txns, {sum(op.type == 'info' for op in h)} info) in "
            f"{sp.s['workload']:.2f} s ({n_txns / sp.s['workload']:.1f} "
            f"txns/s); save_0 {sp.s['save_0']:.2f} s; check "
            f"{sp.s['check']:.4f} s, on the card {on_card(sp):.4f} s "
            f"(pad {sp.s['pad']:.4f}, infer {sp.s['infer']:.4f}, sweeps "
            f"{sp.s['sweeps']:.4f} s); save_1 {sp.s['save_1']:.2f} s; "
            f"valid? {r14a['valid?']}; launches {n}; max_memory_allocated "
            f"{peak} B")
        # ---- 14b. analyze DIR, and the CPU ---------------------------------
        twins.submit("14b", append_cpu, d)
        rc, sp, n, peak, stored = counted(["analyze", d])
        assert rc == 0, rc
        assert results(d) == r14a
        log(f"[14b] analyze {os.path.basename(d)}: decode "
            f"{sp.s['decode']:.2f} s, check {sp.s['check']:.4f} s (on the "
            f"card {on_card(sp):.4f} s), the dict equal to 14a's; launches "
            f"{n}")
        # ---- 14c. one G1c in the stored history, saved, analyze ----------
        # 14b is done with the decoded history: inject into it in place
        t0 = time.perf_counter()
        assert synth.inject_wr_cycle(stored)
        t_inject = time.perf_counter() - t0
        tc = {"name": "demo-append", "store-dir": base,
              "start-time": time.time(), "history": stored}
        (_, t_save) = wall_s(lambda: store.save_0(tc))
        dc = store.test_dir(tc)
        # card == CPU: the CPU check writes its SVGs into a run of its own
        twins.submit("14c", append_cpu, dc, {
            "name": "demo-append-cpu", "start-time": tc["start-time"],
            "store-dir": os.path.join(twins.dir, "runs")})
        rc, sp, n, peak, _ = counted(["analyze", dc])
        r14c = results(dc)
        assert rc == 1 and r14c["valid?"] is False, (rc, r14c)
        assert "G1c" in r14c["anomaly-types"], r14c
        assert n["seg_or"] > 0, n
        svgs = r14c.get("viz-files") or []
        assert svgs and all(os.path.dirname(f) == os.path.join(dc, "elle")
                            and os.path.getsize(f) > 0 for f in svgs), svgs
        svg_bytes = []
        for f in svgs:
            with open(f, "rb") as fh:
                svg_bytes.append((os.path.basename(f), fh.read()))
        log(f"[14c] inject_wr_cycle ({t_inject:.2f} s), save_0 "
            f"{t_save:.2f} s; analyze: valid? False, "
            f"{r14c['anomaly-types']}, {len(svgs)} SVGs under elle/; decode "
            f"{sp.s['decode']:.2f} s, check {sp.s['check']:.4f} s (on the "
            f"card {on_card(sp):.4f} s: pad {sp.s['pad']:.4f}, infer "
            f"{sp.s['infer']:.4f}, sweeps {sp.s['sweeps']:.4f} s; host "
            f"classification {host_s(sp):.4f} s); launches {n}; "
            f"max_memory_allocated {peak} B")
        del stored, h
        # ---- 14d. test-all --only wr -----------------------------------
        rc, sp, n, peak, hw = counted([
            "test-all", "--only", "wr", *nodes, "-c", "10n",
            "--ops", str(RUN_WR_OPS), "--time-limit", str(RUN_TIME_LIMIT)])
        dw = store.latest("demo-wr", base=base)
        rw = results(dw)
        assert rw["valid?"] in (True, "unknown"), rw
        assert rc == (0 if rw["valid?"] is True else 1), (rc, rw)
        r_cpu, t_cpu = wall_s(lambda: wr.WrChecker(device="cpu").check(
            store.load(dw), hw))
        assert r_cpu == rw, (r_cpu, rw)
        log(f"[14d] test-all --only wr, 50 workers, --ops {RUN_WR_OPS}: "
            f"{len(hw)} ops in {sp.s['workload']:.2f} s; save_0 "
            f"{sp.s['save_0']:.2f} s; check {sp.s['check']:.4f} s; valid? "
            f"{rw['valid?']}; launches {n}; max_memory_allocated {peak} B; "
            f"WrChecker(device='cpu') {t_cpu:.4f} s, equal")
        del hw
        # ---- 14e. python -m jepsen_tpu_torch, no --cpu -----------------
        child = os.path.join(base, "child")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "jepsen_tpu_torch",
             "--store-dir", child, "test-all", "--only", "append", "--ops",
             str(RUN_CHILD_OPS)], cwd=HERE, capture_output=True, text=True,
            timeout=600)
        t_child = time.perf_counter() - t0
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
        imported = {line.rsplit("|", 1)[-1].strip()
                    for line in res.stderr.splitlines()
                    if line.startswith("import time:")}
        bad = sorted(m for m in imported
                     if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
        assert "jepsen_tpu_torch.core" in imported and not bad, bad
        dchild = store.latest("demo-append", base=child)
        with open(os.path.join(dchild, "results.json")) as f:
            rchild = json.load(f)
        assert rchild["valid?"] is True, rchild
        log(f"[14e] python -m jepsen_tpu_torch test-all --only append --ops "
            f"{RUN_CHILD_OPS} (no --cpu): exit 0 in {t_child:.2f} s, "
            f"results.json valid? true, {len(imported)} modules imported, "
            f"none of jax or jepsen_tpu")
    except BaseException:
        shutil.rmtree(base, ignore_errors=True)
        raise
    log(f"[14] phase 14 took {time.perf_counter() - t14:.1f} s")

    # ---- 14b-14c's CPU twins: compared in `twins.finish`, which runs
    # after the workers have read the stored runs; then the runs go
    def compare_14b(out, t_cpu):
        assert out[0] == r14a, (out[0], r14a)
        log(f"[14b] AppendChecker(device='cpu') on the stored history in a "
            f"worker, decode included: {t_cpu:.4f} s, the dict equal")

    def compare_14c(out, t_cpu):
        r_cpu, svgs_cpu = out
        shutil.rmtree(base, ignore_errors=True)
        assert r_cpu == {k: v for k, v in r14c.items() if k != "viz-files"}
        assert svgs_cpu == svg_bytes, [f for f, _ in svgs_cpu]
        log(f"[14c] AppendChecker(device='cpu') on the stored history in a "
            f"worker, decode included: {t_cpu:.4f} s, the same dict and "
            f"SVG bytes")

    twins.later("14b", compare_14b)
    twins.later("14c", compare_14c)


def check_demos(dev: torch.device, launches: dict, twins: Twins) -> None:
    """Phase 15: the JAX package's other nine demos run as Jepsen tests on
    the card (see the module docstring), through `python -m
    jepsen_tpu_torch`'s suite in process, as phase 14 runs `append`.  The
    counters are set to 0 just before each `cli.run` of 15a-15b and read
    just after; the sums go into the main path's `launches`.  The CPU
    twins of 15c decode each stored run and check it in `twins`."""
    import shutil
    import threading

    from jepsen_tpu_torch import cli, resilience, store
    from jepsen_tpu_torch.__main__ import DEMOS
    from jepsen_tpu_torch.__main__ import suite as demo_suite
    from jepsen_tpu_torch.checkers import api as checker_api
    from jepsen_tpu_torch.checkers.knossos import device_wgl
    from jepsen_tpu_torch.generator import interpreter
    from jepsen_tpu_torch.history.ops import History
    from jepsen_tpu_torch.ops import cycle_sweep, fill, scan
    from jepsen_tpu_torch.store.format import LazyHistory

    t15 = time.perf_counter()
    base = os.path.join(HERE, "build", "chip_smoke_demos")
    shutil.rmtree(base, ignore_errors=True)
    nodes = [a for n in RUN_NODES for a in ("-n", n)]
    # a run's stages, and the check's parts on the card: each family's
    # guarded device call (`with_fallback`: bank, the fork products,
    # the session masks, the queue and kafka passes), the cycle sweeps
    # (`detect_cycles`: predicate, causal) and Knossos's device leg,
    # which races the host legs on a thread of its own
    stages = (("workload", interpreter, "run"), ("save_0", store, "save_0"),
              ("check", checker_api, "check_safe"),
              ("save_1", store, "save_1"),
              ("decode", LazyHistory, "materialize"),
              ("device part", resilience, "with_fallback"),
              ("sweeps", cycle_sweep, "detect_cycles"),
              ("device leg", device_wgl, "check"))

    def counted(parser_dispatch, store_dir, argv):
        """`cli.run(parser_dispatch, argv)` with the counters set to 0
        just before it and read just after; returns (exit code, Split,
        launches, peak device memory, the history the run made, if it
        made one)."""
        split = Split(stages)
        keep = Split((("history", interpreter, "run"),), keep=True)
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        with split, keep:
            rc = cli.run(parser_dispatch, ["--store-dir", store_dir, *argv])
            # a race's losers unwind on their threads after the verdict
            for t in threading.enumerate():
                if t.name.startswith("knossos-race-"):
                    t.join(timeout=60)
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        return (rc, split, n, torch.cuda.max_memory_allocated(),
                keep.kept["history"][-1][1] if keep.kept["history"] else None)

    def run_line(tag, name, conc, ops, rc, sp, n, peak, h, r):
        n_txns = sum(op.type == "invoke" for op in h)
        card = ", ".join(f"{k} {sp.s[k]:.4f} s ({sp.calls[k]} calls)"
                         for k in ("device part", "sweeps", "device leg")
                         if sp.calls[k])
        anomalies = f" {r['anomaly-types']}" if r.get("anomaly-types") \
            else ""
        won = f", won by {r['algorithm']}" if "algorithm" in r else ""
        log(f"[{tag}] test-all --only {name} -c {conc} --ops {ops}: "
            f"{len(h)} ops ({n_txns} invoked, "
            f"{sum(op.type == 'info' for op in h)} info) in "
            f"{sp.s['workload']:.2f} s ({n_txns / sp.s['workload']:.1f} "
            f"ops/s); save_0 {sp.s['save_0']:.2f} s; check "
            f"{sp.s['check']:.4f} s, on the card: {card or 'nothing'}; "
            f"save_1 {sp.s['save_1']:.2f} s; exit {rc}, valid? "
            f"{r['valid?']}{anomalies}{won}; launches {n}; "
            f"max_memory_allocated {peak} B")

    runs = []
    try:
        # ---- 15a. each demo, valid ----------------------------------------
        suite = demo_suite()
        for name, conc, ops in DEMO_RUNS:
            rc, sp, n, peak, h = counted(suite, base, [
                "test-all", "--only", name, *nodes, "-c", conc,
                "--ops", str(ops), "--time-limit", str(RUN_TIME_LIMIT)])
            d = store.latest(f"demo-{name}", base=base)
            r = store.load(d)["results"]
            twins.submit(("15", d), demo_cpu, d)
            runs.append((name, d, r))
            run_line("15a", name, conc, ops, rc, sp, n, peak, h, r)
            # every demo's rule in the JAX package's tests is valid? true
            # for a clean run (tests/test_workloads.py, test_kafka.py,
            # test_cli_web.py, test_invariants.py)
            assert rc == 0 and r["valid?"] is True, (name, rc, r)
            if name == "session":
                assert n["locf"] >= 2, n
            if name == "long-fork":
                d_lf = d
            if name == "bank":
                # analyze on the card reads the stored accounts and total
                rc2, sp2, n2, _, _ = counted(suite, base, ["analyze", d])
                assert rc2 == 0 and store.load(d)["results"] == r
                log(f"[15a] analyze {os.path.basename(d)} (bank): decode "
                    f"{sp2.s['decode']:.2f} s, check {sp2.s['check']:.4f} s, "
                    f"the dict equal; launches {n2}")
        # ---- 15b. injected --------------------------------------------------
        # a long fork in 15a's long-fork run, saved and analysed: the
        # sweep on the card finds its cycle.  The predicate's sweeps are
        # over host-built edges with no chain rows, so they launch no
        # seg-OR: its chain pass is empty
        inj = os.path.join(base, "injected")
        t0 = time.perf_counter()
        h = store.load(d_lf)["history"].materialize()
        h = inject_long_fork(History(
            [op.with_(value=[list(m) for m in op.value])
             if op.f == "txn" and op.value else op for op in h.ops],
            reindex=False))
        tc = {"name": "demo-long-fork", "store-dir": inj,
              "start-time": time.time(), "history": h}
        store.save_0(tc)
        dc = store.test_dir(tc)
        t_inject = time.perf_counter() - t0
        rc, sp, n, peak, _ = counted(demo_suite(), inj, ["analyze", dc])
        r = store.load(dc)["results"]
        twins.submit(("15", dc), demo_cpu, dc)
        runs.append(("long-fork", dc, r))
        log(f"[15b] inject_long_fork into {os.path.basename(d_lf)}, saved "
            f"({t_inject:.2f} s), analyze: decode {sp.s['decode']:.2f} s, "
            f"check {sp.s['check']:.4f} s, on the card: device part "
            f"{sp.s['device part']:.4f} s, sweeps {sp.s['sweeps']:.4f} s "
            f"({sp.calls['sweeps']} calls); exit {rc}, valid? "
            f"{r['valid?']} {r['anomaly-types']}, {r.get('fork-count')} "
            f"forks; launches {n}; max_memory_allocated {peak} B")
        assert rc == 1 and r["valid?"] is False, (rc, r)
        assert r["long-forks"] and sp.calls["sweeps"] > 0, (sp.calls, r)
        for name, conc, ops, extra, anomaly in DEMO_INJECTED:
            def test_fn(opts, name=name, extra=extra):
                return DEMOS[name]({**opts, **extra})

            rc, sp, n, peak, h = counted(
                cli.test_all_cmd({name: test_fn}), inj, [
                    "test-all", "--only", name, *nodes, "-c", conc,
                    "--ops", str(ops), "--time-limit", str(RUN_TIME_LIMIT)])
            d = store.latest(f"demo-{name}", base=inj)
            r = store.load(d)["results"]
            twins.submit(("15", d), demo_cpu, d)
            runs.append((name, d, r))
            log(f"[15b] {json.dumps(extra)}:")
            run_line("15b", name, conc, ops, rc, sp, n, peak, h, r)
            assert rc == 1 and r["valid?"] is False, (name, rc, r)
            assert anomaly in r["anomaly-types"], (anomaly, r)
        # ---- 15c. card == CPU ----------------------------------------------
        for name, d, r in runs:
            r_cpu, t_cpu, t_wait = twins.get(("15", d))
            assert race_free(name, r_cpu) == race_free(name, r), \
                (name, r_cpu, r)
            but = " but for the race's winner" \
                if name == "lin-register" else ""
            log(f"[15c] {name} ({os.path.basename(d)}): demo_checker(cpu="
                f"True) on the stored run in a worker, decode included: "
                f"{t_cpu:.4f} s, the dict equal{but} (waited "
                f"{t_wait:.2f} s)")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"[15] phase 15 took {time.perf_counter() - t15:.1f} s")


def check_c1(dev: torch.device, launches: dict, twins: Twins) -> float:
    """Phase 16a: one component past MAX_K_CAP backward edges, checked on
    the card (see the module docstring).  The counters are set to 0 just
    before each check of the full-size history and read just after; the
    sums go into the main path's `launches`.  Returns the seconds it
    took."""
    import math

    from jepsen_tpu_torch.checkers.elle import list_append as la
    from jepsen_tpu_torch.ops import cycle_sweep, fill, scan

    t0 = time.perf_counter()
    for inject in (False, True):
        twins.submit(("16a", inject), c1_cpu, C1_CMP_TXNS, C1_CMP_CAP,
                     inject)
    cap = cycle_sweep.MAX_K_CAP
    h, t_make = wall_s(lambda: c1_history(C1_TXNS, False))
    close = cycle_sweep._close_group
    groups = []

    def sized(n_nodes, arrays, forward, batch, k, *args, **kw):
        groups.append((len(batch), k))
        return close(n_nodes, arrays, forward, batch, k, *args, **kw)

    for inject in (False, True):
        if inject:
            h = c1_history(C1_TXNS, True)
        groups.clear()
        split = Split((("check", la, "check"), ("pad", la, "pad_packed"),
                       ("infer", la, "infer"),
                       ("sweeps", la, "detect_cycles"),
                       ("groups", cycle_sweep, "_close_group"),
                       ("closure", cycle_sweep, "_closure_diagonal")))
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        cycle_sweep._close_group = sized
        try:
            with Components(keep=True) as comps, split:
                r = la.check(h, C1_MODELS, device=dev)
        finally:
            cycle_sweep._close_group = close
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        peak = torch.cuda.max_memory_allocated()
        large = [m for m, _ in groups if m > cap]
        batches = sum(math.ceil(m / k) for m, k in groups)
        (n_wit, t_wit) = wall_s(comps.check_witnesses)
        tag = "injected G1c" if inject else "valid"
        log(f"[16a] {tag}: {C1_TXNS} txns from 50 workers, completions out "
            f"of apply order (made in {t_make:.2f} s); largest component "
            f"{comps.largest()} backward edges (MAX_K_CAP {cap}); backward "
            f"edges and largest component per projection {comps.seen}; "
            f"{len(groups)} groups of components, {batches} column "
            f"batches, the groups past MAX_K_CAP {large}; check "
            f"{split.s['check']:.4f} s (pad {split.s['pad']:.4f}, infer "
            f"{split.s['infer']:.4f}, sweeps {split.s['sweeps']:.4f} s, of "
            f"which the groups {split.s['groups']:.4f} s and the meta "
            f"closures {split.s['closure']:.4f} s); valid? {r['valid?']} "
            f"{r.get('anomaly-types', [])}; launches {n}; "
            f"max_memory_allocated {peak} B; every projection's witnesses "
            f"({n_wit}) equal the backward edges whose ends share a "
            f"strongly connected component on the host ({t_wit:.2f} s)")
        assert comps.largest() > cap and large, (comps.seen, groups)
        assert n["locf"] > 0 and n["seg_or"] > 0, n
        if inject:
            assert r["valid?"] is False and "G1c" in r["anomaly-types"], r
            assert n_wit > 0, n_wit
        else:
            assert r["valid?"] is True, r
    del h, comps
    torch.cuda.empty_cache()
    check_closure(dev)
    # card == CPU, both with MAX_K_CAP lowered; the CPU's come in
    # `twins.finish`
    for inject in (False, True):
        hs = c1_history(C1_CMP_TXNS, inject)
        with k_cap(C1_CMP_CAP), Components() as comps:
            got = la.check(hs, C1_MODELS, device=dev)
        at_cap = la.check(hs, C1_MODELS, device=dev)
        assert got == at_cap, (got, at_cap)
        assert comps.largest() > C1_CMP_CAP, comps.seen

        def compare(want, t_cpu, got=got, inject=inject,
                    largest=comps.largest()):
            assert got == want, (got, want)
            log(f"[16a] card == CPU: {C1_CMP_TXNS} txns"
                f"{' with a G1c' if inject else ''}, MAX_K_CAP lowered to "
                f"{C1_CMP_CAP} on both (largest component {largest}): the "
                f"dicts equal, and equal to the card's at the full cap; "
                f"the CPU's {t_cpu:.2f} s in a worker")

        twins.later(("16a", inject), compare)
    return time.perf_counter() - t0


def check_closure(dev: torch.device) -> None:
    """16a's meta closure alone: `_closure_diagonal` of a random sparse
    0/1 matrix on the card against the strongly connected components on
    the host, then at the component cap, MAX_COMPONENT_BATCHES x
    MAX_K_CAP edges, on a matrix already transitive (the strict upper
    triangle, so one squaring step closes it and no edge is on a
    cycle), with its time and peak device memory."""
    import math

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from jepsen_tpu_torch.ops import cycle_sweep

    dtype = cycle_sweep._closure_dtype(dev)
    rng = np.random.default_rng(0)
    m = CLOSURE_CHECK
    src, dst = rng.integers(0, m, (2, int(1.2 * m)))
    adj = np.zeros((m, m), np.float32)
    adj[src, dst] = 1
    got = cycle_sweep._closure_diagonal(
        torch.from_numpy(adj).to(dev, dtype)).cpu().numpy()
    n_comp, label = connected_components(
        coo_matrix(adj), directed=True, connection="strong")
    cyclic = np.bincount(label, minlength=n_comp)[label] > 1
    want = cyclic | (np.diagonal(adj) > 0)
    assert (got == want).all(), (int(got.sum()), int(want.sum()))
    log(f"[16a] _closure_diagonal of a random ({m}, {m}) {dtype} matrix, "
        f"{len(src)} edges: the diagonal equals the host's strongly "
        f"connected components ({int(want.sum())} nodes on a cycle)")
    m = cycle_sweep.MAX_COMPONENT_BATCHES * cycle_sweep.MAX_K_CAP
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    meta = torch.ones((m, m), dtype=dtype, device=dev).triu_(1)
    t0 = time.perf_counter()
    diag = cycle_sweep._closure_diagonal(meta)
    on_cycle = int(diag.sum())
    t_step = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    del meta, diag
    torch.cuda.empty_cache()
    log(f"[16a] the cap, MAX_COMPONENT_BATCHES "
        f"{cycle_sweep.MAX_COMPONENT_BATCHES} x MAX_K_CAP = {m} edges: "
        f"_closure_diagonal of a transitive ({m}, {m}) {dtype} matrix, one "
        f"squaring step, {t_step * 1e3:.2f} ms (at most "
        f"{math.ceil(math.log2(m))} steps: "
        f"{t_step * math.ceil(math.log2(m)):.2f} s), {on_cycle} nodes on a "
        f"cycle; peak device memory {peak} B above what the phase held, "
        f"{peak / (m * m * 2):.3f} matrices")
    assert on_cycle == 0, on_cycle
    assert peak < 2 * m * m * 2 + (1 << 30), peak


def check_dbs(dev: torch.device, launches: dict, twins: Twins) -> float:
    """Phases 16b-16d: the sqlite and regd suites against real processes,
    checked on the card (see the module docstring), through each suite's
    command line in process (`cli.run(suite(), argv)`).  The counters
    are set to 0 just before each `cli.run` and read just after; the
    sums go into the main path's `launches`.  The CPU twins decode each
    stored run and check it in `twins`.  Returns the seconds it took."""
    import shutil

    from jepsen_tpu_torch import cli, store
    from jepsen_tpu_torch.checkers import api as checker_api
    from jepsen_tpu_torch.checkers import perf, timeline
    from jepsen_tpu_torch.checkers.elle import rw_register
    from jepsen_tpu_torch.dbs import regd_suite, sqlite
    from jepsen_tpu_torch.generator import core as g
    from jepsen_tpu_torch.generator import interpreter
    from jepsen_tpu_torch.nemesis import core as nem
    from jepsen_tpu_torch.ops import fill, scan

    t0 = time.perf_counter()
    base = os.path.join(HERE, "build", "chip_smoke_dbs")
    shutil.rmtree(base, ignore_errors=True)
    stages = suite_stages()
    runs = []

    def counted(parser_dispatch, argv):
        """`cli.run(parser_dispatch, argv)` with the counters set to 0
        just before it and read just after; returns (exit code, Split,
        launches, peak device memory, the history, Components)."""
        split = Split(stages)
        keep = Split((("history", interpreter, "run"),), keep=True)
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        with Components() as comps, split, keep:
            rc = cli.run(parser_dispatch, ["--store-dir", base, *argv])
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        return (rc, split, n, torch.cuda.max_memory_allocated(),
                keep.kept["history"][-1][1], comps)

    def run_line(tag, what, rc, sp, n, peak, h, comps, r):
        n_txns = sum(op.type == "invoke" and op.f == "txn" for op in h)
        bad = {t: sum(op.type == t and op.f == "txn" for op in h)
               for t in ("fail", "info")}
        on_card = sp.s["infer"] + sp.s["sweeps"] + sp.s["rw sweeps"]
        log(f"[{tag}] {what}: {len(h)} ops ({n_txns} txns invoked, "
            f"{bad['fail']} fail, {bad['info']} info) in "
            f"{sp.s['workload']:.2f} s ({n_txns / sp.s['workload']:.1f} "
            f"txns/s); save_0 {sp.s['save_0']:.2f} s; check "
            f"{sp.s['check']:.4f} s, on the card {on_card:.4f} s (infer "
            f"{sp.s['infer']:.4f}, sweeps "
            f"{sp.s['sweeps'] + sp.s['rw sweeps']:.4f} s); exit "
            f"{rc}, valid? {r['valid?']} {r.get('anomaly-types', [])}; "
            f"backward edges and largest component per projection "
            f"{comps.seen}; launches {n}; max_memory_allocated {peak} B")

    def stored(name, models, workload="append"):
        d = store.latest(name, base=base)
        twins.submit(("16", d), suite_cpu, d, workload, models,
                     rw_register.FUSED_MIN_TXNS)
        r = store.load(d)["results"]
        runs.append((name, d, r))
        return d, r

    try:
        # ---- 16c. regd: stale reads, plain, the primary crashed ---------
        # before 16b, so that the regd runs' CPU twins (their host checks
        # take 15-30 s on the CPU) run beside the sqlite runs
        nodes = [a for nd in REGD_NODES for a in ("-n", nd)]
        regd = ("strict-serializable",)

        rc, sp, n, peak, h, comps = counted(
            cli.test_all_cmd({"append": lambda opts: regd_stale_test(
                dict(opts, **{"base-port": free_base()}),
                REGD_STALE_OPS)}),
            ["test-all", "--only", "append", *nodes, "--time-limit",
             str(RUN_TIME_LIMIT)])
        _, r = stored("regd-append", regd)
        run_line("16c", f"regd with stale reads on the backups, blocked "
                 f"from the primary, {REGD_STALE_OPS} ops", rc, sp, n,
                 peak, h, comps, r)
        assert rc == 1 and r["valid?"] is False, (rc, r)
        rc, sp, n, peak, h, comps = counted(regd_suite.suite(), [
            "test-all", "--only", "append", *nodes, "--time-limit",
            str(REGD_TIME_LIMIT), "--base-port", str(free_base())])
        d_regd, r = stored("regd-append", regd)
        run_line("16c", f"regd test-all --only append, 3 daemons, "
                 f"--time-limit {REGD_TIME_LIMIT}", rc, sp, n, peak, h,
                 comps, r)
        assert rc == 0 and r["valid?"] is True, (rc, r)
        assert n["locf"] > 0, n

        def crashed(opts):
            t = regd_suite.append_test(dict(opts,
                                            **{"base-port": free_base()}))
            db, wl = t["db"], t["generator"]
            t["nemesis"] = nem.node_start_stopper(
                lambda test, nodes: [nodes[0]],
                lambda test, node: db.kill(test, node),
                lambda test, node: db.start_and_await(test, node),
                start_f="kill-primary", stop_f="restart-primary")
            t["generator"] = g.then(
                g.clients(g.limit(REGD_PHASE_OPS, wl)),
                g.then(
                    g.synchronize(g.nemesis(
                        [{"type": "invoke", "f": "kill-primary"}])),
                    g.then(
                        g.clients(g.limit(REGD_PHASE_OPS, wl)),
                        g.then(
                            g.synchronize(g.nemesis(
                                [{"type": "invoke",
                                  "f": "restart-primary"}])),
                            g.synchronize(g.clients(
                                g.limit(REGD_PHASE_OPS, wl)))))))
            return t

        rc, sp, n, peak, h, comps = counted(
            cli.test_all_cmd({"append": crashed}),
            ["test-all", "--only", "append", *nodes, "--time-limit",
             str(RUN_TIME_LIMIT)])
        _, r = stored("regd-append", regd)
        run_line("16c", f"regd, the primary killed and restarted between "
                 f"three phases of {REGD_PHASE_OPS} ops", rc, sp, n, peak,
                 h, comps, r)
        restart = next(op.index for op in h if op.f == "restart-primary")
        oks = [op.index for op in h if op.type == "ok" and op.f == "txn"]
        assert rc == 0 and r["valid?"] is True, (rc, r)
        assert min(oks) < restart < max(oks), restart

        # ---- 16b. sqlite, append and wr ------------------------------------
        for name, models in (("append", ("serializable",)),
                             ("wr", ("snapshot-isolation",))):
            rc, sp, n, peak, h, comps = counted(sqlite.suite(), [
                "test-all", "--only", name, "-c", DB_CONC, "--ops",
                str(DB_OPS), "--time-limit", str(RUN_TIME_LIMIT)])
            d, r = stored(f"sqlite-{name}", models, name)
            run_line("16b", f"sqlite test-all --only {name} -c {DB_CONC} "
                     f"--ops {DB_OPS}", rc, sp, n, peak, h, comps, r)
            assert rc == 0 and r["valid?"] is True, (name, rc, r)
            if name == "append":
                assert n["locf"] > 0, n
        # ---- 16d. the post-run artifacts on 16c's plain run ---------------
        test = store.load(d_regd)
        h = test["history"].materialize()
        arts = checker_api.compose({"perf": perf.perf(),
                                    "timeline": timeline.html_timeline(),
                                    "stats": checker_api.Stats()})
        res, t_arts = wall_s(lambda: arts.check(test, h))
        html = os.path.join(store.test_dir(test), "timeline.html")
        plots = res["perf"]["latency-graph"].get("plot", "written")
        assert res["valid?"] is True and os.path.getsize(html) > 0, res
        log(f"[16d] perf(), html_timeline() and Stats composed on 16c's "
            f"run ({len(h)} ops) in {t_arts:.2f} s: valid? "
            f"{res['valid?']}; timeline.html {os.path.getsize(html)} B in "
            f"the store; plots {plots}; stats count "
            f"{res['stats']['count']}, ok {res['stats']['ok-count']}")
        # ---- card == CPU ---------------------------------------------------
        for name, d, r in runs:
            r_cpu, t_cpu, t_wait = twins.get(("16", d))
            assert r_cpu == r, (name, r_cpu, r)
            log(f"[16] {name} ({os.path.basename(d)}): its checker on the "
                f"CPU on the stored run in a worker, decode included: "
                f"{t_cpu:.4f} s, the dict equal (waited {t_wait:.2f} s)")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return time.perf_counter() - t0


def check_faults(dev: torch.device, launches: dict, twins: Twins) -> float:
    """Phase 17: Jepsen tests under the fault packages of
    `nemesis.combined`, each through `core.run` (the interpreter, then
    `store.save_0`, the workload's checker on the card through
    `check_safe`, and `save_1`), with the package on the test map as
    `"nemesis-packages"` (see the module docstring).  The counters are
    set to 0 just before each `core.run` and read just after; the sums
    go into the main path's `launches`.  The CPU twins decode each
    stored run and check it in `twins`.  Returns the seconds it took."""
    import collections
    import random
    import shutil

    from jepsen_tpu_torch import core, store
    from jepsen_tpu_torch.__main__ import DEMOS
    from jepsen_tpu_torch.checkers.elle import rw_register
    from jepsen_tpu_torch.dbs import regd_suite, toyraft
    from jepsen_tpu_torch.generator import core as g
    from jepsen_tpu_torch.nemesis import combined
    from jepsen_tpu_torch.ops import fill, scan

    t0 = time.perf_counter()
    base = os.path.join(HERE, "build", "chip_smoke_faults")
    shutil.rmtree(base, ignore_errors=True)
    stages = suite_stages()
    runs = []

    def under(test, pkg, clients, seconds):
        return with_package(dict(test, **{"store-dir": base}), pkg,
                            clients, seconds)

    def counted(test, twin, *args):
        """`core.run(test)` with the counters set to 0 just before it and
        read just after, and its stored run's CPU twin, `twin(dir,
        *args)`, submitted; returns (the run, Split, launches, peak
        device memory, Components)."""
        split = Split(stages)
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        with Components() as comps, split:
            done = core.run(test)
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        d = store.test_dir(done)
        twins.submit(("17", d), twin, d, *args)
        runs.append((done["name"], d))
        return done, split, n, torch.cuda.max_memory_allocated(), comps

    def run_line(tag, what, done, sp, n, peak, comps):
        """Logs the run; returns the completions of its fault ops as
        {f: {type: count}}."""
        h, r = done["history"], done["results"]
        n_txns = sum(op.type == "invoke" and op.f == "txn" for op in h)
        done_txns = collections.Counter(
            op.type for op in h if op.f == "txn" and op.type != "invoke")
        faults = collections.defaultdict(collections.Counter)
        for op in h:
            if op.process == "nemesis" and op.type != "invoke":
                faults[op.f][op.type] += 1
        faults = {f: dict(c) for f, c in sorted(faults.items())}
        on_card = sp.s["infer"] + sp.s["sweeps"] + sp.s["rw sweeps"]
        log(f"[{tag}] {what}: {len(h)} ops ({n_txns} txns invoked, "
            f"{done_txns['ok']} ok, {done_txns['fail']} fail, "
            f"{done_txns['info']} info) in {sp.s['workload']:.2f} s "
            f"({n_txns / sp.s['workload']:.1f} txns/s); faults "
            f"{faults}; save_0 {sp.s['save_0']:.2f} s; check "
            f"{sp.s['check']:.4f} s, on the card {on_card:.4f} s (infer "
            f"{sp.s['infer']:.4f}, sweeps "
            f"{sp.s['sweeps'] + sp.s['rw sweeps']:.4f} s); valid? "
            f"{r['valid?']} {r.get('anomaly-types', [])}; backward edges "
            f"and largest component per projection {comps.seen}; "
            f"launches {n}; max_memory_allocated {peak} B")
        return faults

    fused = rw_register.FUSED_MIN_TXNS
    try:
        # ---- 17b. the sim cluster: clock skew and membership changes ------
        # first, and 17c second, so that their CPU twins (host checks of
        # 15-20 s on the CPU) run beside 17a
        nodes = list(RUN_NODES)
        t = DEMOS["append"]({"nodes": nodes, "concurrency": RAFT_CONC,
                             "seed": 0, "client-latency": SKEW_LATENCY})
        pkg = combined.nemesis_package({
            "faults": {"skew", "membership"}, "nodes": nodes,
            "interval": SKEW_INTERVAL, "rng": random.Random(0)})
        done, sp, n, peak, comps = counted(
            under(t, pkg, g.limit(SKEW_TXNS, t["generator"]),
                  SKEW_TIME_LIMIT), demo_cpu)
        faults = run_line("17b", f"the append demo on MemClient, "
                          f"{RAFT_CONC} workers, clock skew and membership "
                          f"changes every {SKEW_INTERVAL} s", done, sp, n,
                          peak, comps)
        assert done["results"]["valid?"] is False, done["results"]
        assert "start-skew" in faults, faults
        assert n["seg_or"] > 0, n

        # ---- 17c. regd: the kill package on real processes -----------------
        regd = ("strict-serializable",)
        t = regd_suite.append_test({"nodes": list(REGD_NODES),
                                    "concurrency": len(REGD_NODES),
                                    "base-port": free_base(),
                                    "store-dir": base})
        pkg = combined.nemesis_package({
            "faults": {"kill"}, "db": t["db"],
            "interval": REGD_KILL_INTERVAL, "rng": random.Random(0)})
        done, sp, n, peak, comps = counted(
            under(t, pkg, t["generator"], REGD_KILL_TIME_LIMIT), suite_cpu,
            "append", regd, fused)
        faults = run_line("17c", f"regd, 3 daemons, a kill or a restart "
                          f"every {REGD_KILL_INTERVAL} s for "
                          f"{REGD_KILL_TIME_LIMIT} s", done, sp, n, peak,
                          comps)
        assert done["results"]["valid?"] is True, done["results"]
        assert faults.get("kill") and faults.get("start"), faults

        # ---- 17a. the toy raft: partitions, kills, membership changes -----
        raft = ("strict-serializable",)
        t = toyraft.append_test({"nodes": nodes, "concurrency": RAFT_CONC})
        db = t["db"]
        pkg = combined.nemesis_package({
            "faults": {"partition", "kill", "membership"}, "db": db,
            "membership_state": toyraft.ToyRaftMembers(db),
            "interval": FAULT_INTERVAL, "rng": random.Random(0)})
        done, sp, n, peak, comps = counted(
            under(t, pkg, g.stagger(RAFT_STAGGER, t["generator"]),
                  RAFT_TIME_LIMIT), suite_cpu, "append", raft, fused)
        faults = run_line("17a", f"toyraft, {len(nodes)} nodes, "
                          f"{RAFT_CONC} workers staggered {RAFT_STAGGER} s, "
                          f"partitions, kills and membership changes every "
                          f"{FAULT_INTERVAL} s for {RAFT_TIME_LIMIT} s",
                          done, sp, n, peak, comps)
        assert done["results"]["valid?"] is True, done["results"]
        assert "start-partition" in faults and "kill" in faults, faults
        assert any(faults.get(f, {}).get("ok")
                   for f in ("leave-node", "join-node")), faults
        assert n["locf"] > 0, n
        done, sp, n, peak, comps = counted(
            raft_stale_test({"nodes": nodes, "store-dir": base,
                             "concurrency": 5,
                             "consistency-models": RAFT_STALE_MODELS}),
            suite_cpu, "append", RAFT_STALE_MODELS, fused)
        run_line("17a", "toyraft with stale reads on n5, isolated", done,
                 sp, n, peak, comps)
        assert done["results"]["valid?"] is False, done["results"]

        # ---- card == CPU ---------------------------------------------------
        for name, d in runs:
            r = store.load(d)["results"]
            r_cpu, t_cpu, t_wait = twins.get(("17", d))
            assert r_cpu == r, (name, r_cpu, r)
            log(f"[17] {name} ({os.path.basename(d)}): its checker on the "
                f"CPU on the stored run in a worker, decode included: "
                f"{t_cpu:.4f} s, the dict equal (waited {t_wait:.2f} s)")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return time.perf_counter() - t0


def walk_spans(sp):
    """`sp` (a span of a ``telemetry.json``) and every span below it."""
    yield sp
    for c in sp.get("children") or []:
        yield from walk_spans(c)


def check_live(dev: torch.device, launches: dict, twins: Twins) -> float:
    """Phase 18: telemetry and live checking on the card (see the module
    docstring).  The counters are set to 0 just before 18a's `core.run`
    and 18b's seal and read just after each; the sums go into the main
    path's `launches`.  18c's per-session twins and 18f's run in
    `twins`.  Returns the seconds it took."""
    import contextlib
    import io
    import shutil

    from jepsen_tpu_torch import cli, core, store, telemetry
    from jepsen_tpu_torch.__main__ import DEMOS
    from jepsen_tpu_torch.__main__ import suite as demo_suite
    from jepsen_tpu_torch.generator import core as g
    from jepsen_tpu_torch.ops import cycle_sweep, fill, scan
    from jepsen_tpu_torch.utils import profiling
    from jepsen_tpu_torch.verifier import (VerifierService, VerifierSession,
                                           scan_sessions, sweep,
                                           verdict_digest)
    from jepsen_tpu_torch.workloads import synth

    t0 = time.perf_counter()
    base = os.path.join(HERE, "build", "chip_smoke_live")
    shutil.rmtree(base, ignore_errors=True)
    prof_dir = os.path.join(OUT_DIR, "profile_18a")
    shutil.rmtree(prof_dir, ignore_errors=True)
    # 18c's histories are made in the workers while 18a-18b run, and
    # then each one's twin: its own per-session sweep on the CPU
    for i in range(BATCH_SESSIONS):
        twins.submit(("18c-h", i), batch_history, i)
    for i in range(BATCH_SESSIONS):
        twins.submit(("18c", i), sweep_cpu, i)

    def zero():
        fill.LAUNCHES = 0
        scan.LAUNCHES = 0

    def count():
        n = {"locf": fill.LAUNCHES, "seg_or": scan.LAUNCHES}
        for kname in launches:
            launches[kname] += n[kname]
        return n

    try:
        # ---- 18a. a telemetric, profiled, live-checked run -----------------
        t = DEMOS["append"]({"nodes": list(RUN_NODES),
                             "concurrency": 10 * len(RUN_NODES), "seed": 0})
        t["generator"] = g.limit(LIVE_TXNS, t["generator"])
        t.update({"store-dir": base, "telemetry": True,
                  "profile-dir": prof_dir,
                  "live-check": {"inproc": True}})
        zero()
        ta = time.perf_counter()
        done = core.run(t)
        ta = time.perf_counter() - ta
        n = count()
        res = done["results"]
        lc = res["live-check"]
        da = store.test_dir(done)
        assert res["valid?"] is True and "error" not in res, res
        assert lc["state"] == "ok", lc
        assert lc["ops"] == len(done["history"]) == 2 * LIVE_TXNS, lc
        assert (lc["valid?"], lc["anomaly-types"]) == \
            (res["valid?"], res["anomaly-types"]), (lc, res)
        assert lc["seal"] == {"equal": True, "digest": lc["digest"]}, lc
        meta = dict(scan_sessions(base))[lc["session"]]
        assert meta["state"] == "sealed" and meta["seal"]["equal"], meta
        assert (meta["seal"]["valid?"], meta["seal"]["anomaly-types"]) == \
            (res["valid?"], res["anomaly-types"]), meta
        assert n["locf"] > 0, n
        with open(os.path.join(da, "telemetry.json")) as f:
            doc = json.load(f)
        with open(os.path.join(da, "trace.json")) as f:
            n_trace = len(json.load(f)["traceEvents"])
        spans = [sp for r in doc["spans"] for sp in walk_spans(r)]
        names = {sp["name"] for sp in spans}
        (run,) = [r for r in doc["spans"] if r["name"] == "run"]
        top = {c["name"]: c for c in run["children"]}
        for want in ("workload", "store.save_0", "live-check.open",
                     "live-check.finish"):
            assert want in top, (want, sorted(top))
        checks = [c for c in run["children"] if c["name"].startswith(
            "check:")]
        assert checks, sorted(top)
        timed = 0
        for chk in checks + [top["live-check.finish"]]:
            for sp in walk_spans(chk):
                dt = sp["attrs"].get("device_time_ns")
                if dt is not None:
                    assert 0 < dt <= sp["dur_ns"], sp
                    timed += 1
        assert any("device_time_ns" in sp["attrs"]
                   for c in checks for sp in walk_spans(c)), checks
        seals = [sp for sp in walk_spans(top["live-check.finish"])
                 if sp["name"] == "verifier.seal-batch-check"]
        assert len(seals) == 1, seals
        n_sweeps = sum(sp["name"] == "verifier.sweep" for sp in spans)
        ppath = os.path.join(prof_dir, profiling.TRACE_FILE)
        p_bytes = os.path.getsize(ppath)
        with open(ppath) as f:
            kernels = {e["name"] for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"}
        locf_syms = sorted(k for k in kernels if "locf_lookback" in k)
        assert locf_syms, sorted(kernels)[:40]
        if p_bytes > PROFILE_KEEP_BYTES:
            os.remove(ppath)
        wl = top["workload"]["dur_ns"] / 1e9
        log(f"[18a] the append demo on the sim cluster, "
            f"{len(RUN_NODES)} nodes, {10 * len(RUN_NODES)} workers, "
            f"{LIVE_TXNS} txns, telemetry on, torch.profiler on, live "
            f"check in process: {ta:.2f} s; workload {wl:.2f} s "
            f"({LIVE_TXNS / wl:.1f} txns/s), save_0 "
            f"{top['store.save_0']['dur_ns'] / 1e9:.2f} s, check "
            f"{checks[0]['dur_ns'] / 1e9:.4f} s, live-check.finish "
            f"{top['live-check.finish']['dur_ns'] / 1e9:.4f} s (seal "
            f"{seals[0]['dur_ns'] / 1e9:.4f} s); valid? {res['valid?']}; "
            f"the live session {lc['ops']} ops, sealed equal, digest "
            f"{lc['digest']}; {len(spans)} spans, {n_sweeps} "
            f"verifier.sweep spans, {timed} spans with device_time_ns, "
            f"{n_trace} trace.json events; profiler trace {p_bytes} B "
            f"({'kept' if p_bytes <= PROFILE_KEEP_BYTES else 'removed'}), "
            f"{len(kernels)} kernel names, LOCF as {locf_syms[0]!r}; "
            f"launches {n}")
        twins.submit("18f-a", live_cpu, da)

        # ---- 18b. one G1c, fed in segments through the service API -------
        h = done["history"]
        lens = [len(op.value) if isinstance(op.value, list) else 0
                for op in h]
        assert synth.inject_wr_cycle(h)
        changed = [i for i, op in enumerate(h) if isinstance(op.value, list)
                   and len(op.value) != lens[i]]
        assert len(changed) == 2, changed
        closing = max(changed) // LIVE_SEG
        tb = {"name": "live-g1c", "store-dir": base,
              "start-time": time.time(), "history": h}
        store.save_0(tb)
        db_ = store.test_dir(tb)
        twins.submit("18f-b", live_cpu, db_)
        lines = [json.dumps(op.to_dict()).encode() + b"\n" for op in h]
        svc = opened(VerifierService(base, device=dev))
        tg = time.perf_counter()
        cur, first_bad = 0, None
        for k in range(0, len(lines), LIVE_SEG):
            seg = b"".join(lines[k:k + LIVE_SEG])
            code, r = svc.ingest("g1c", seg, cursor=cur)
            assert code == 200 and r["cursor"] == cur + len(seg), (code, r)
            cur = r["cursor"]
            code, v = svc.verdict("g1c")
            assert code == 200, v
            if v["valid?"] is False and first_bad is None:
                first_bad = (k // LIVE_SEG, v["anomaly-types"], v["new"])
        tg = time.perf_counter() - tg
        assert first_bad is not None and first_bad[0] == closing, \
            (first_bad, closing)
        assert "G1c" in first_bad[1] and "G1c" in first_bad[2], first_bad
        zero()
        ts = time.perf_counter()
        code, sealed = svc.seal("g1c")
        ts = time.perf_counter() - ts
        n = count()
        assert code == 200 and sealed["equal"] is True, sealed
        assert "G1c" in sealed["verdict"]["anomaly-types"], sealed
        assert sealed["verdict"]["anomaly-types"] == \
            sealed["incremental"]["anomaly-types"], sealed
        assert n["seg_or"] > 0, n
        digest_b = sealed["digest"]
        log(f"[18b] 18a's history with one G1c (ops {changed}), "
            f"{len(lines)} ops in {len(range(0, len(lines), LIVE_SEG))} "
            f"segments of {LIVE_SEG} through VerifierService.ingest and "
            f"a rolling verdict after each: {tg:.2f} s; invalid from "
            f"segment {first_bad[0]} (the one with op {max(changed)}), "
            f"{first_bad[1]}; seal {ts:.4f} s: "
            f"{sealed['verdict']['anomaly-types']}, equal to the batch "
            f"check (list_append.check on the card); launches {n}")

        # ---- 18c. many sessions, one batched dispatch ----------------------
        class Live:
            def __init__(self, session):
                import threading

                self.lock = threading.RLock()
                self.dead = False
                self.state = "open"
                self.session = session

        tc = time.perf_counter()
        lives = []
        for i in range(BATCH_SESSIONS):
            s = VerifierSession(f"b{i}", LIVE_MODELS, device=dev)
            s.append_ops(list(twins.get(("18c-h", i))[0]))
            lives.append(Live(s))
        t_ingest = time.perf_counter() - tc
        dispatches = []
        real = cycle_sweep.detect_cycles

        def counted_sweep(*a, **kw):
            dispatches.append(1)
            return real(*a, **kw)

        coll = telemetry.activate()
        cycle_sweep.detect_cycles = counted_sweep
        try:
            tc = time.perf_counter()
            stats = sweep.batched_sweep(lives, device=dev)
            tc = time.perf_counter() - tc
        finally:
            cycle_sweep.detect_cycles = real
            telemetry.deactivate(coll)
        (bspan,) = [r for r in coll.roots if r.name == "verifier.sweep"
                    and r.attrs.get("batched")]
        assert stats["dispatched"] == 1 and len(dispatches) == 1, \
            (stats, dispatches)
        assert stats["dirty"] == BATCH_SESSIONS, stats
        got = [verdict_digest(x.session.verdict()) for x in lives]
        want = [twins.get(("18c", i))[0] for i in range(BATCH_SESSIONS)]
        assert got == want, [i for i, (a, b) in enumerate(zip(got, want))
                             if a != b]
        bad = [i for i, x in enumerate(lives)
               if x.session.verdict(sweep=False)["valid?"] is False]
        assert bad == list(range(0, BATCH_SESSIONS, BATCH_EVERY)), bad
        a_ = bspan.attrs
        log(f"[18c] batched_sweep over {BATCH_SESSIONS} sessions of "
            f"{BATCH_TXNS} txns ({len(bad)} with a G1c; read from the "
            f"workers and ingested in {t_ingest:.2f} s): one detect_cycles dispatch on the card "
            f"over {a_['regions']} regions, {a_['nodes']} nodes, "
            f"{a_['edges']} edges: {bspan.duration_ns / 1e9:.4f} s, "
            f"device_time_ns {a_.get('device_time_ns')}; the whole pass "
            f"{tc:.4f} s, stats {stats}; every verdict's digest equal to "
            f"its session's own sweep on the CPU in a worker")

        # ---- 18d. reopen 18b's service, replay to the same digest ---------
        closed(svc)
        td = time.perf_counter()
        svc = opened(VerifierService(base, device=dev))
        code, v = svc.verdict("g1c")
        td = time.perf_counter() - td
        assert code == 200 and v["digest"] == digest_b, (v, digest_b)
        assert {x["session"]: x["state"] for x in svc.sessions()}[
            "g1c"] == "sealed", svc.sessions()
        closed(svc)
        log(f"[18d] 18b's service closed and reopened over its store: "
            f"journal replayed, digest {v['digest']} identical, in "
            f"{td:.2f} s")

        # ---- 18e. trace and tail of 18a's run through the CLI -------------
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_trace = cli.run(demo_suite(), ["trace", da, "--top", "10"])
            rc_tail = cli.run(demo_suite(), ["tail", da])
        text = out.getvalue()
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "18e_trace_tail.txt"), "w") as f:
            f.write(text)
        assert rc_trace == 0 and rc_tail == 0, (rc_trace, rc_tail)
        assert "top 10 spans by self time" in text and \
            "run ended cleanly" in text, text[-2000:]
        log(f"[18e] trace DIR --top 10 and tail DIR of 18a's run through "
            f"cli.run: exit 0 and 0, {len(text.splitlines())} lines "
            f"(chiprun_out/18e_trace_tail.txt)")

        # ---- 18f. card == CPU ----------------------------------------------
        for key, d, want_d in (("18f-a", da, lc["digest"]),
                               ("18f-b", db_, digest_b)):
            got, t_cpu, t_wait = twins.get(key)
            assert got["digest"] == want_d and got["equal"], (key, got)
            log(f"[18f] {os.path.basename(d)}: the stored history through "
                f"a session on the CPU in a worker, segments of "
                f"{LIVE_SEG}, sealed: digest {got['digest']} and "
                f"{got['anomaly-types']} equal to the card's, in "
                f"{t_cpu:.2f} s (waited {t_wait:.2f} s)")
        assert got["anomaly-types"] == sealed["verdict"]["anomaly-types"]
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return time.perf_counter() - t0


def suite_stages():
    """The `Split` stages of a suite's run (16b-16c, 17): the
    workload, `save_0`, the check and `save_1`, and the check's parts on
    the card, `infer` and the sweeps of the append and wr checkers."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checkers import api as checker_api
    from jepsen_tpu_torch.checkers.elle import list_append as la
    from jepsen_tpu_torch.generator import interpreter
    from jepsen_tpu_torch.ops import cycle_sweep

    return (("workload", interpreter, "run"), ("save_0", store, "save_0"),
            ("check", checker_api, "check_safe"),
            ("save_1", store, "save_1"),
            ("infer", la, "infer"), ("sweeps", la, "detect_cycles"),
            ("rw sweeps", cycle_sweep, "detect_cycles"))


def with_package(test: dict, pkg: dict, clients, seconds: float) -> dict:
    """`test` under the fault package `pkg` (`nemesis.combined`): its
    nemesis, its generator on the nemesis thread beside `clients` (on the
    client threads only: regd's generator would hand the nemesis thread
    txns too) for `seconds`, then its final heal ops, and the package on
    the test map as `"nemesis-packages"` (the perf plots' fault
    windows), as the JAX package's campaigns wire a package into a
    test."""
    from jepsen_tpu_torch.generator import core as g

    test["nemesis"] = pkg["nemesis"]
    test["nemesis-packages"] = [pkg]
    test["generator"] = g.phases(
        g.time_limit(seconds, g.any_gen(g.clients(clients),
                                        g.nemesis(pkg["generator"]))),
        g.nemesis(pkg["final_generator"]))
    return test


def raft_stale_test(opts: dict) -> dict:
    """17a's stale run (`tests/test_toyraft.py`'s
    `test_toyraft_stale_reads_caught`): the toy raft with
    `stale_reads=True`; after 40 txns n5 is cut off and thread 4, bound
    to it, reads its frozen state without a quorum while the majority
    commits 60 more."""
    from jepsen_tpu_torch.dbs import toyraft
    from jepsen_tpu_torch.generator import core as g
    from jepsen_tpu_torch.nemesis import core as nem
    from jepsen_tpu_torch.workloads import append

    t = toyraft.append_test(opts, stale_reads=True)
    db, nodes = t["db"], t["nodes"]

    class IsolateN5(nem.Nemesis):
        def invoke(self, test, op):
            for b in nodes[:-1]:
                db.cluster.block(nodes[-1], b)
                db.cluster.block(b, nodes[-1])
            return dict(op, type="info", value="n5 isolated")

    t["nemesis"] = IsolateN5()
    # one generator across the phases keeps the appended values unique;
    # reads on the majority side pin the version order past the stale
    # prefix, which gives each stale read its rw successor
    writes = append.gen(read_frac=0.3, key_count=3,
                        max_writes_per_key=100_000)
    reads = g.stagger(0.02, g.limit(10, lambda test, ctx: {
        "f": "txn", "value": [("r", k, None) for k in range(3)]}))
    t["generator"] = g.phases(
        g.limit(40, g.clients(writes)),
        g.nemesis([{"type": "invoke", "f": "isolate"}]),
        g.any_gen(g.limit(60, g.clients(writes)),
                  g.on_threads(lambda th: th == 4, reads)))
    return t


def regd_stale_test(opts: dict, n_ops: int) -> dict:
    """16c's stale run (`tests/test_regd_suite.py`'s
    `test_regd_stale_reads_caught`): regd under strict serializability
    with local reads on the backups, which `BlockBackups` cuts off from
    the primary for the whole workload.  `n_ops` txns over 3 keys run
    first; once all have completed, every client thread reads every
    key.  The primary's reads order each key's appends, and each
    backup's frozen read starts after the primary acknowledged them, so
    every run holds a read that is stale in real time, however loaded
    the host."""
    from jepsen_tpu_torch.dbs import regd_suite
    from jepsen_tpu_torch.generator import core as g
    from jepsen_tpu_torch.workloads import append

    t = regd_suite.append_test(
        dict(opts, **{"consistency-models": ("strict-serializable",)}),
        stale_reads=True)
    t["nemesis"] = BlockBackups(t["db"])
    writes = g.stagger(0.003, append.gen(key_count=3,
                                         max_writes_per_key=100_000))
    reads = {"f": "txn", "value": [("r", k, None) for k in range(3)]}
    t["generator"] = g.then(
        g.synchronize(g.nemesis([{"type": "invoke", "f": "block"}])),
        g.then(g.phases(g.clients(g.limit(n_ops, writes)),
                        g.clients(g.each_thread(reads))),
               g.nemesis([{"type": "invoke", "f": "heal"}])))
    return t


class BlockBackups:
    """16c's nemesis (`test_regd_stale_reads_caught`'s): the backups
    drop replication from the primary on `block` until `heal`, so their
    local reads freeze while the primary commits."""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        return self

    def invoke(self, test, op):
        from jepsen_tpu_torch.dbs import regd_suite

        for node in test["nodes"][1:]:
            req = {"op": "block", "peers": [test["nodes"][0]]} \
                if op["f"] == "block" else {"op": "heal"}
            regd_suite.request(self.db.port(test, node), req)
        return dict(op, type="info")

    def teardown(self, test):
        pass


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
        import functools

        # wraps: a caller that reads the timed function's signature
        # (the Knossos race filters each leg's keywords by it) sees fn's
        @functools.wraps(fn)
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
