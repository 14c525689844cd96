"""Batched multi-history checking on one card (the port's copy of
`jepsen_tpu/parallel/batch.py` without its mesh branch): BASELINE config
5, a batch of 1M-op histories checked with one verdict per history.

Histories in a batch share padded capacities (pad to the max), and
`stack_padded` stacks a group's padded columns with a leading batch
dimension, landing on the card once per group.  The JAX package then runs
`jit(vmap(core_check))` over the stack; here `_batched_core` runs the
port's `core_check` on each row (a view of the stack, no copy) in a plain
loop and stacks the (B, 13) bits and (B,) overflows.  A loop is the
design and not a stand-in for vmap: at 1M txns one history already fills
the card (`infer` is 2^24-element passes), the sweep's fixpoint is a host
loop with one scalar read a round, and vmap cannot batch the kernels'
`ctypes` calls.  So the JAX `custom_vmap` rules that keep the Pallas
kernels' carries from leaking between rows
(`pallas_scan.flatten_batch`, the batching rule of `pallas_fill`) have no
counterpart: each row's kernels run on that row alone.

Each row runs with the batch's shared static facts (`n_keys` the largest,
the layout flags ANDed, the IR order columns only when every member has
them at one shape), as a vmapped row does in the JAX package, so a row may
take an `infer` branch its history would not take when checked alone;
the verdicts are the same.

Not carried over: the mesh branch (`make_mesh`, the `mesh`/`axis`
arguments, and with them `op_shard`, `hybrid` and `slots`) and the
compile-cache wrapper (the port compiles nothing per shape).  Telemetric
runs get the ``parallel.batch`` span and the ``device-bytes-staged``
counter.  Each batched dispatch runs under
`resilience.device_call("parallel.batch", ...)` as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import List, Sequence

import numpy as np
import torch

from jepsen_tpu_torch import backend, resilience, telemetry
from jepsen_tpu_torch.checkers.elle.device_core import (
    COUNT_NAMES,
    core_check,
    core_check_exact,
)
from jepsen_tpu_torch.checkers.elle.device_infer import (
    DATA_FIELDS,
    PaddedLA,
    _ir_facts,
    pad_packed,
    pow2_at_least,
    to_device,
)
from jepsen_tpu_torch.history.soa import PackedTxns

#: the columns every padded history has, stacked for every batch
_BASE_FIELDS = ("txn_type", "txn_process", "txn_invoke_pos",
                "txn_complete_pos", "txn_mask", "mop_txn", "mop_kind",
                "mop_key", "mop_val", "mop_rd_start", "mop_rd_len",
                "mop_mask", "rd_elems", "rd_elem_mask")
#: the IR derived-order columns, stacked only when every member has them
#: at one shape (else `infer` derives the orders in-program)
_IR_FIELDS = ("run_sort", "inv_run", "key_ord_len", "key_ord_read",
              "proc_order", "barrier_order", "barrier_bi")


def stack_padded(hs: Sequence[PaddedLA]) -> PaddedLA:
    """Stack equal-shaped padded histories along a leading batch axis, on
    the device the members are on."""
    first = hs[0]
    out = {f: torch.stack([getattr(h, f) for h in hs])
           for f in _BASE_FIELDS}
    for f in _IR_FIELDS:
        vals = [getattr(h, f) for h in hs]
        if all(v is not None for v in vals) and \
                len({tuple(v.shape) for v in vals}) == 1:
            out[f] = torch.stack(vals)
    # the static layout facts must hold for EVERY stacked history (each
    # row runs with the batch's facts): AND the flags, take the widest
    # run bucket/capacity
    return PaddedLA(
        n_keys=first.n_keys, n_vals=first.n_vals,
        txn_major=all(h.txn_major for h in hs),
        run_cap=(max(h.run_cap for h in hs)
                 if all(h.run_cap for h in hs) else 0),
        complete_monotone=all(h.complete_monotone for h in hs),
        v_cap=(max(h.v_cap for h in hs)
               if all(h.v_cap for h in hs) else 0),
        o_cap=(max(h.o_cap for h in hs)
               if all(h.o_cap for h in hs) else 0),
        app_val_mono=all(h.app_val_mono for h in hs),
        rd_start_mono=all(h.rd_start_mono for h in hs),
        proc_seq=all(h.proc_seq for h in hs),
        **out)


def batch_caps(ps: Sequence[PackedTxns]) -> tuple:
    """The shared padded capacities (T, M, R, n_keys, V, O) for a batch.
    V/O are the IR value-table / order-table capacities, maxed over the
    batch as in the JAX package (whose batch shares one executable)."""
    T = pow2_at_least(max(p.n_txns for p in ps))
    M = pow2_at_least(max(p.n_mops for p in ps))
    R = pow2_at_least(max(max(len(p.rd_elems), p.n_vals, p.n_keys + 1)
                          for p in ps))
    nk = max(p.n_keys for p in ps)
    facts = {id(p): _ir_facts(p) for p in ps}
    vs = [f["v_cap"] for f in facts.values()]
    os_ = [f["o_cap"] for f in facts.values()]
    V = max(vs) if all(vs) else 0
    O = max(os_) if all(os_) else 0
    caps = (T, M, R, nk, min(V, R), min(O, R))
    return _BatchCaps(caps, facts)


class _BatchCaps(tuple):
    """The (T, M, R, nk, V, O) capacity tuple, carrying the per-history
    `_ir_facts` so `pad_batch` doesn't re-derive them (they are full
    O(n_mops) host scans).  A plain 6-tuple is accepted too; the facts
    are then derived per history."""

    def __new__(cls, caps, facts):
        self = super().__new__(cls, caps)
        self.facts = facts
        return self


def pad_batch(ps: Sequence[PackedTxns], caps: tuple = None,
              device: backend.DeviceLike = None) -> PaddedLA:
    """Pad a list of PackedTxns to shared capacities and stack them on
    `device` (the CUDA card unless the caller names the CPU).

    Each history is padded on the host and the stack is copied to the
    card once, so the card holds one stacked group and not its members
    besides.  `caps` (from `batch_caps`) overrides the per-call maxima so
    several groups of one larger batch share capacities."""
    dev = backend.resolve(device)
    if caps is None:
        caps = batch_caps(ps)
    facts = getattr(caps, "facts", {})
    T, M, R, nk, V, O = caps
    padded = []
    for p in ps:
        h = pad_packed(p, t_pad=T, m_pad=M, r_pad=R, v_pad=V, o_pad=O,
                       ir_facts=facts.get(id(p)), device="cpu")
        h.n_keys = nk
        padded.append(h)
    return to_device(stack_padded(padded), dev)


def _row(batch: PaddedLA, i: int) -> PaddedLA:
    """Row `i` of a stacked batch with the batch's static facts: a view
    of every column, no copy."""
    return dataclasses.replace(batch, **{
        f: getattr(batch, f)[i] for f in DATA_FIELDS
        if getattr(batch, f) is not None})


def _batched_core(batch: PaddedLA, n_keys: int):
    """`core_check` on each row of `batch`: (B, 13) bits, (B,) overflows
    on the batch's device."""
    dev = batch.txn_type.device
    rows = [core_check(_row(batch, i), n_keys, device=dev)
            for i in range(batch.txn_type.shape[0])]
    return (torch.stack([b for b, _ in rows]),
            torch.stack([o for _, o in rows]))


def check_batch(ps: Sequence[PackedTxns], caps: tuple = None,
                deadline=None, plan=None, policy=None,
                device: backend.DeviceLike = None) -> List[dict]:
    """Check a batch of histories on `device` (the CUDA card unless the
    caller names the CPU).

    Returns one summary dict per history: {"valid?", "counts", "cycles",
    "exact"}.  Histories whose sweep overflowed the default
    backward-edge budget are re-run alone with a grown budget, so
    verdicts are definitive whenever the caps allow.  `caps` pins the
    padded capacities (see `batch_caps`).

    The batched dispatch runs under the resilience guard: `deadline` is
    polled before it, transient failures retry per `policy`, and `plan`
    (or the installed plan) fires its synthetic faults at the
    ``parallel.batch`` site.  There is no fallback: an error that
    outlives its retries is raised.
    """
    with telemetry.span("parallel.batch", histories=len(ps),
                        shards=0) as sp:
        batch = pad_batch(ps, caps, device=device)
        n_keys = batch.n_keys
        _stage_bytes(sp, batch)
        bits, over = resilience.device_call(
            "parallel.batch", lambda: _batched_core(batch, n_keys),
            deadline=deadline, plan=plan, policy=policy)
        return summarize_batch_bits(bits, over, batch, n_keys, len(ps))


def _stage_bytes(sp, batch) -> None:
    """Bytes of the padded batch's tensors, on the span and the
    ``device-bytes-staged`` counter (telemetric runs only)."""
    if not telemetry.enabled():
        return
    n = sum(v.numel() * v.element_size() for v in vars(batch).values()
            if isinstance(v, torch.Tensor))
    sp.set_attr(bytes_staged=n)
    telemetry.registry().counter("device-bytes-staged").inc(n)


def summarize_batch_bits(bits, over, batch, n_keys: int, n_real: int,
                         k_floor: int = 128) -> List[dict]:
    """Per-history summary rows from batched (bits, over) outputs, with
    the exact-rerun fallback: any inexact verdict (backward-edge
    overflow or fixpoint truncation) re-runs that history alone through
    `core_check_exact`, seeding the budget past the observed overflow so
    the failed config isn't repeated."""
    bits = bits.cpu().numpy().copy()
    over = over.cpu().numpy().copy()
    out: List[dict] = []
    for i in range(n_real):
        row = bits[i]
        counts = {n: int(row[j]) for j, n in enumerate(COUNT_NAMES)}
        # a positive count is computed BEFORE the cycle sweep and is
        # exact regardless of sweep convergence: the history is
        # definitively invalid, so skip the exact rerun, which could
        # only refine the cycle list
        invalid_by_counts = any(v > 0 for v in counts.values())
        if (int(over[i]) > 0 or int(row[-1]) != 1) \
                and not invalid_by_counts:
            k0 = pow2_at_least(k_floor + int(over[i]), floor=k_floor)
            h_i = _row(batch, i)
            b2, o2 = core_check_exact(h_i, n_keys, max_k=k0,
                                      device=h_i.txn_type.device)
            row = b2.cpu().numpy()
            over[i] = max(0, int(o2))
            counts = {n: int(row[j]) for j, n in enumerate(COUNT_NAMES)}
        cycles = [bool(x) for x in row[len(COUNT_NAMES):-1]]
        converged = bool(row[-1]) and int(over[i]) == 0
        invalid = any(v > 0 for v in counts.values()) or any(cycles)
        out.append({
            "valid?": False if invalid else
                      (True if converged else "unknown"),
            "counts": counts,
            "cycles": {
                "G0": cycles[0], "G1c": cycles[1], "G2-family": cycles[2],
                "G2-family-process": cycles[3],
                "G2-family-realtime": cycles[4],
            },
            # the VERDICT is exact when the sweep converged or when the
            # invalidity stands on counts alone (the cycle dict may
            # then be under-reported: counts already decide validity)
            "exact": bool(converged or invalid),
        })
    return out


def check_batch_checkpointed(ps: Sequence[PackedTxns], ckpt_path: str,
                             group_size: int = 8, on_group=None,
                             device: backend.DeviceLike = None
                             ) -> List[dict]:
    """`check_batch` with chunk-level progress markers.

    The batch is processed in groups of `group_size` histories; after
    each group its verdicts are appended to `ckpt_path` as JSON lines
    {"i": …, "digest": …, "result": …} and fsync'd.  A rerun with the
    same path skips every history already judged, so a crashed control
    process resumes mid-batch.  Grouping also bounds device memory: one
    group's padded arrays are on the card at a time, not the whole batch.
    The file is the JAX package's, so a checkpoint written by either
    package resumes in the other.

    The checkpoint records per-history content digests; a resume against
    different histories at the same path raises instead of mixing runs.

    `on_group(info)` (optional) is called after each group's checkpoint
    record is durable, with {"group", "indices", "wall_s", "done"}.

    The JAX package fills a partial or resumed group with copies of its
    first member, so that its compiled batch shape does not change; the
    port compiles nothing per shape, so such a group is checked as it
    is.  The verdicts are the same.
    """
    def digest(p: PackedTxns) -> str:
        # every packed column that inference reads: two runs with the
        # same op content but a different interleaving (process
        # assignment, invoke/complete order, read segments) must NOT
        # share a digest, since process/realtime cycle bits depend on
        # them.  The bytes are those of the JAX package's columns (the
        # same dtypes), so the digests agree between the packages.
        h = hashlib.sha256()
        # declared metadata first: n_keys/n_vals feed padding caps and
        # inference sentinels, so identical arrays under different
        # declared spaces must not share a digest
        h.update(np.int64([p.n_keys, p.n_vals, p.n_txns,
                           p.n_mops]).tobytes())
        for a in (p.txn_type, p.txn_process, p.txn_invoke_pos,
                  p.txn_complete_pos, p.mop_txn, p.mop_kind, p.mop_key,
                  p.mop_val, p.mop_rd_start, p.mop_rd_len, p.rd_elems):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]

    done: dict = {}
    if os.path.exists(ckpt_path):
        good_bytes = 0
        with open(ckpt_path, "rb") as f:
            for line in f:
                if not line.strip():
                    good_bytes += len(line)
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # torn trailing record from a crash mid-append, the
                    # exact scenario checkpoints exist for: drop it and
                    # resume from the last durable record
                    break
                if not line.endswith(b"\n"):
                    # parseable but unterminated: a later append would
                    # fuse with it, so treat it as torn too
                    break
                done[rec["i"]] = rec
                good_bytes += len(line)
        with open(ckpt_path, "r+b") as f:
            f.truncate(good_bytes)
    out: List[dict] = [None] * len(ps)
    digests = [digest(p) for p in ps]
    for i, rec in done.items():
        if i >= len(ps) or rec["digest"] != digests[i]:
            raise ValueError(
                f"checkpoint {ckpt_path} is from a different batch "
                f"(history {i} digest mismatch); refusing to mix runs")
        out[i] = rec["result"]

    # one set of padded capacities across groups, as in the JAX package
    # (whose groups share one executable): a row then runs the same infer
    # branch whichever group it lands in
    caps = batch_caps(ps)
    with open(ckpt_path, "a") as f:
        for g0 in range(0, len(ps), group_size):
            idx = [i for i in range(g0, min(g0 + group_size, len(ps)))
                   if out[i] is None]
            if not idx:
                continue
            t_g = time.monotonic()
            results = check_batch([ps[i] for i in idx], caps=caps,
                                  device=device)
            for i, r in zip(idx, results):
                out[i] = r
                f.write(json.dumps(
                    {"i": i, "digest": digests[i], "result": r}) + "\n")
            f.flush()
            os.fsync(f.fileno())
            if on_group is not None:
                on_group({"group": g0 // group_size, "indices": idx,
                          "wall_s": round(time.monotonic() - t_g, 2),
                          "done": sum(r is not None for r in out)})
    return out
