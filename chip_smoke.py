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
     b. the stale-read corpus of phase 4 under strong snapshot isolation,
        from 65,536 txns, doubling while one check stays under 60 s (and
        the next is not predicted past 180 s), up to 1M: a G-single-family
        anomaly with explained cycles, segmented-OR launches, and each
        check's time split into pad, infer, sweeps and host
        classification (witness BFS, cycle search, rendering);
     c. card == CPU: the whole result dict of 6b's first, 65,536-txn
        check against the same check on the CPU;
     d. two op histories built with the port's `history` module (a G1c
        pair; G1a, G1b and internal) with their anomaly types, card ==
        CPU.
The launch counters are set to 0 just before the checks of phase 3, just
before `core_check_exact` in phase 4 and just before each `check` of phase
6a and 6b, and read just after each; the kernels' `launches` are their
sum.  The second-to-last line is a JSON object with one entry per kernel;
the last line is `{"ok": true, "device": {...}}`.  Longer output (the
profiler's tables) goes to `chiprun_out/`.

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
STALE_LIMIT_S = 60.0         # 6b doubles while one check stays under this
STALE_NEXT_S = 180.0         # ... and the next is not predicted past this
G_SINGLE_FAMILY = {"G-single", "G-single-process", "G-single-realtime"}
#: the stale-read checks' model: it proscribes the G-single family and not
#: G-nonadjacent, whose budgeted simple-cycle search on the host holds a
#: check for minutes (PERF.md)
STALE_MODELS = ["strong-snapshot-isolation"]
LOCF_PER_CHECK = 14          # forward fills in `infer` when n_keys > 1 and
                             # both monotone layout facts hold
MOP_APPEND, MOP_READ = 0, 1  # jepsen_tpu_torch.history.soa's

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
    del p

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

    split = Split(list_append)

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

    n_txns, t_prev, first = N_SMALL, None, None
    while True:
        ps6 = stale_reads(packed_la_history(n_txns, n_keys=n_txns // 8,
                                            seed=0))
        r, t, n = counted_check(ps6, STALE_MODELS)
        assert r["valid?"] is False, r["anomaly-types"]
        family = sorted(set(r["anomaly-types"]) & G_SINGLE_FAMILY)
        assert family, r["anomaly-types"]
        n_cycles = explained_cycles(r)
        assert n["locf"] == LOCF_PER_CHECK and n["seg_or"] > 0, n
        log(f"[6b] stale reads, {n_txns} txns, {'+'.join(STALE_MODELS)}: "
            f"check {t:.4f} s ({split}); {split.calls['sweeps']} "
            f"projections; {family}; {n_cycles} cycles, every edge "
            f"explained; launches {n}")
        if first is None:
            first = (ps6, r)
        if t >= STALE_LIMIT_S or n_txns >= N_TXNS:
            break
        if t_prev is not None and t * t / t_prev > STALE_NEXT_S:
            log(f"[6b] next size {min(2 * n_txns, N_TXNS)} predicted at "
                f"{t * t / t_prev:.1f} s: stopping")
            break
        t_prev, n_txns = t, min(2 * n_txns, N_TXNS)
    log(f"[6b] largest size reached: {n_txns} txns in {t:.4f} s")
    del ps6

    # 6c: 6b's first check (on the card) against the same check on the CPU
    pc, got = first
    first = None
    want, t_cpu = wall_s(lambda: list_append.check(
        pc, STALE_MODELS, _force_no_fallback=True, device="cpu"))
    assert got == want, (got, want)
    log(f"[6c] {pc.n_txns} txns with stale reads: the result dicts are "
        f"equal on card and CPU ({got['anomaly-types']}, "
        f"{explained_cycles(got)} rendered cycles, not {got['not']}, "
        f"also-not {got['also-not']}); the CPU check took {t_cpu:.4f} s")
    del pc

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


class Split:
    """Wall time of one `list_append.check` by stage.  While active, the
    module's stage functions are wrapped in timers that synchronize the
    card before each clock read: pad (`pad_packed`), infer, sweeps (one
    `detect_cycles` per projection), and the three parts of host
    classification: the witness BFS (`_materialize_host_edges`,
    `_witness_regions`), the cycle search (`find_cycle`) and the
    rendering (`_render`)."""

    STAGES = (("pad", "pad_packed"), ("infer", "infer"),
              ("sweeps", "detect_cycles"),
              ("bfs", "_materialize_host_edges"),
              ("bfs", "_witness_regions"), ("find_cycle", "find_cycle"),
              ("render", "_render"))

    def __init__(self, module):
        self.module = module
        self.s = {}
        self.calls = {}

    def __enter__(self):
        self.s = dict.fromkeys(
            ("pad", "infer", "sweeps", "bfs", "find_cycle", "render"), 0.0)
        self.calls = dict.fromkeys(self.s, 0)
        self.saved = {}
        for stage, fname in self.STAGES:
            fn = getattr(self.module, fname)
            self.saved[fname] = fn
            setattr(self.module, fname, self._timed(stage, fn))
        return self

    def _timed(self, stage, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.s[stage] += time.perf_counter() - t0
            self.calls[stage] += 1
            return out
        return run

    def __exit__(self, *exc):
        for fname, fn in self.saved.items():
            setattr(self.module, fname, fn)
        return False

    def __str__(self):
        host = self.s["bfs"] + self.s["find_cycle"] + self.s["render"]
        return (", ".join(f"{k} {v:.4f} s" for k, v in self.s.items())
                + f"; host classification {host:.4f} s")


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

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write(table)
    log(f"[{phase}] profiled {what}, top device time:")
    log("\n".join(table.splitlines()[:18]))
    return {e.key: e.count for e in prof.key_averages()}


if __name__ == "__main__":
    sys.exit(main())
