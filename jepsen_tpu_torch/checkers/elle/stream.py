"""Stream a stored history to the card chunk-by-chunk and check it (the
port's copy of `jepsen_tpu/checkers/elle/stream.py`).

The path is

  .jepsen file -> LazyHistory.iter_chunks() (LRU-bounded decode)
    -> TxnPacker.feed (per-chunk SoA columns, global ids)
    -> a pinned host copy and an asynchronous copy to the card per chunk
       (the copy of chunk i runs while the host decodes and packs chunk
       i+1, which is what `jax.device_put` gives the JAX package)
    -> one `torch.cat` per column on the card, padded to pow2 capacities
    -> `core_check_exact` (list-append) or `device_rw.check`
       (rw-register)

so peak host memory holds the pending-invoke table, the interner maps,
and a bounded window of decoded chunks, never the whole op-object list.

Each pinned source buffer is a fresh tensor from torch's caching host
allocator, which records the copy's event and hands the buffer out again
only after the copy has finished; no buffer is reused by this module.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from jepsen_tpu_torch import backend, store
from jepsen_tpu_torch.checkers.elle import device_rw
from jepsen_tpu_torch.checkers.elle.device_core import (
    COUNT_NAMES,
    core_check_exact,
)
from jepsen_tpu_torch.checkers.elle.device_infer import (
    PaddedLA,
    pow2_at_least,
    run_cap_of,
)
from jepsen_tpu_torch.history.soa import TxnPacker
from jepsen_tpu_torch.resilience import Deadline

_FILLS = {
    "txn_type": 0, "txn_process": 0, "txn_invoke_pos": 0,
    "txn_complete_pos": 0, "mop_txn": 0, "mop_kind": -1, "mop_key": 0,
    "mop_val": -1, "mop_rd_start": -1, "mop_rd_len": -1, "rd_elems": -1,
}


def _to_device(col: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One packed column on `dev`: through pinned memory and an
    asynchronous copy on a CUDA device, a plain tensor on the CPU."""
    t = torch.from_numpy(col)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def stage_chunks(chunks: Iterable, workload: str = "list-append",
                 device: backend.DeviceLike = None
                 ) -> tuple[PaddedLA, TxnPacker]:
    """Pack + transfer history chunks to `device` (the CUDA card unless
    the caller names the CPU) as they stream by.

    `chunks` yields lists of Ops in history order (e.g.
    `LazyHistory.iter_chunks()`).  Each packed chunk's columns are copied
    to the card as soon as `feed` returns them, asynchronously, so the
    copy of chunk i runs while the host decodes and packs chunk i+1.
    Returns the padded history on the card (the JAX package's dtypes:
    int8 `txn_type` and `mop_kind`, int32 the rest, bool masks) plus the
    packer (for key/value maps).
    """
    dev = backend.resolve(device)
    pk = TxnPacker(workload)
    dev_chunks: List[dict] = []
    # verify the sort-free layout facts on the actual host columns as
    # they stream by (cheap numpy diffs per chunk) instead of asserting
    # them: a packer-order regression then takes the in-program sort
    # rather than corrupting the fast path's permutation scatter
    layout_ok = True
    prev_mop_txn = 0  # also rejects negative sentinels in chunk 0
    prev_cpos = -1
    for ops in chunks:
        cols = pk.feed(ops)
        mt, cp = cols["mop_txn"], cols["txn_complete_pos"]
        if len(mt):
            layout_ok = bool(layout_ok and np.all(np.diff(mt) >= 0)
                             and mt[0] >= prev_mop_txn)
            prev_mop_txn = int(mt[-1])
        if len(cp):
            layout_ok = bool(layout_ok and np.all(np.diff(cp) > 0)
                             and cp[0] > prev_cpos)
            prev_cpos = int(cp[-1])
        dev_chunks.append({k: _to_device(v, dev) for k, v in cols.items()
                           if k != "txn_orig_index"})

    # final range bound: every mop_txn must name a real txn
    layout_ok = bool(layout_ok and prev_mop_txn < max(pk.n_txns, 1))

    T = pow2_at_least(max(pk.n_txns, 1))
    M = pow2_at_least(max(pk.n_mops, 1))
    R = pow2_at_least(max(pk.n_rd_elems, len(pk.val_names),
                          len(pk.key_names) + 1))

    def cat(name: str, n: int, total: int, dtype) -> torch.Tensor:
        tail = torch.full((n - total,), _FILLS[name], dtype=dtype,
                          device=dev)
        return torch.cat([c[name].to(dtype) for c in dev_chunks] + [tail])

    def mask(n: int, total: int) -> torch.Tensor:
        return torch.arange(n, device=dev) < total

    i8, i32 = torch.int8, torch.int32
    h = PaddedLA(
        txn_type=cat("txn_type", T, pk.n_txns, i8),
        txn_process=cat("txn_process", T, pk.n_txns, i32),
        txn_invoke_pos=cat("txn_invoke_pos", T, pk.n_txns, i32),
        txn_complete_pos=cat("txn_complete_pos", T, pk.n_txns, i32),
        txn_mask=mask(T, pk.n_txns),
        mop_txn=cat("mop_txn", M, pk.n_mops, i32),
        mop_kind=cat("mop_kind", M, pk.n_mops, i8),
        mop_key=cat("mop_key", M, pk.n_mops, i32),
        mop_val=cat("mop_val", M, pk.n_mops, i32),
        mop_rd_start=cat("mop_rd_start", M, pk.n_mops, i32),
        mop_rd_len=cat("mop_rd_len", M, pk.n_mops, i32),
        mop_mask=mask(M, pk.n_mops),
        rd_elems=cat("rd_elems", R, pk.n_rd_elems, i32),
        rd_elem_mask=mask(R, pk.n_rd_elems),
        n_keys=len(pk.key_names),
        n_vals=len(pk.val_names),
        # layout facts verified on the streamed host columns above
        txn_major=layout_ok,
        run_cap=run_cap_of(pk.max_mops_txn) if layout_ok else 0,
        complete_monotone=layout_ok,
    )
    return h, pk


def check_stored(test_or_dir, workload: str = "list-append",
                 max_k: int = 128, max_rounds: int = 64, deadline=None,
                 device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Check a STORED list-append or rw-register run end to end on
    `device` (the CUDA card unless the caller names the CPU) without
    materializing its op list: lazy chunks -> streamed staging ->
    `core_check_exact` (list-append) or `device_rw.check` (rw-register).
    Accepts a store dir path or a loaded test map whose history is a
    LazyHistory.  Returns the JAX package's summary dict.

    `deadline` (or the test map's ``"checker-time-limit"``) bounds the
    check's grow loop: expiry raises `DeadlineExceeded`.
    """
    dev = backend.resolve(device)
    test = store.load(test_or_dir) if isinstance(test_or_dir, str) \
        else test_or_dir
    if deadline is None:
        deadline = Deadline.resolve(None, test)
    hist = test.get("history")
    if hist is None:
        return {"valid?": "unknown", "counts": {}, "cycles": {},
                "exact": False}
    chunks = hist.iter_chunks() if hasattr(hist, "iter_chunks") \
        else _one_chunk(hist)
    h, pk = stage_chunks(chunks, workload, device=dev)
    if pk.n_txns == 0:
        return {"valid?": "unknown", "counts": {}, "cycles": {},
                "exact": False}

    if workload == "rw-register":
        # rw-packed columns mean something different to list-append
        # inference: route to the fused rw checker (same staged arrays)
        res = device_rw.check(h, max_k=max_k, max_rounds=max_rounds,
                              deadline=deadline, device=dev)
        res["n-txns"] = pk.n_txns
        return res

    bits, over = core_check_exact(h, h.n_keys, max_k=max_k,
                                  max_rounds=max_rounds, deadline=deadline,
                                  device=dev)
    row = bits.cpu().numpy()
    over_i = int(over)
    counts = {n: int(row[j]) for j, n in enumerate(COUNT_NAMES)}
    cycles = [bool(x) for x in row[len(COUNT_NAMES):-1]]
    converged = bool(row[-1]) and over_i == 0
    invalid = any(v > 0 for v in counts.values()) or any(cycles)
    return {
        "valid?": (not invalid) if converged else "unknown",
        "counts": counts,
        "cycles": {
            "G0": cycles[0], "G1c": cycles[1], "G2-family": cycles[2],
            "G2-family-process": cycles[3],
            "G2-family-realtime": cycles[4],
        },
        "exact": converged,
        "n-txns": pk.n_txns,
    }


def _one_chunk(hist):
    yield list(hist)
