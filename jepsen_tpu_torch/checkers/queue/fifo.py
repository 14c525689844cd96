"""Total-queue + FIFO passes as vectorized reductions (the port's copy
of `jepsen_tpu/checkers/queue/fifo.py`).

The `checker_api.TotalQueueChecker` counting model over the
:class:`~jepsen_tpu.checkers.queue.packed.PackedFifo` columns:

- **queue-lost** — per-value ``enq_ok > deq`` (definitely enqueued
  more times than ever dequeued);
- **queue-phantom** — per-value ``deq > enq_ok + enq_maybe``
  (dequeued more than it could possibly have been enqueued; the
  twin's "unexpected");
- **queue-fifo-violation** (additive, ``fifo=True``) — one consumer
  dequeues *b* then *a* although *a*'s enqueue OK-completed before
  *b*'s enqueue was even invoked: a sound single-consumer FIFO
  violation no interleaving explains.  Runs as a segmented running
  max of enqueue-invoke indices over the per-process dequeue order
  (``idx + seg*BIG`` cummax — no segment primitives needed), so the
  whole pass is one scan.  It is OFF by default: the canonical
  total-queue verdict stays verdict-for-verdict with the host scan
  twin, and FIFO attribution is an opt-in stricter mode (mem-store
  queues are FIFO, so the reorder adversarial knob is what trips it).

Device path behind ``resilience.with_fallback(site="queue.check")``:
`_math` as torch ops on the entry point's device (the CUDA card unless
the caller names the CPU), through `kafka._TorchXP`, with the running
max as `torch.cummax` on int64 (JAX's `lax.cummax`, a plain XLA op: no
Pallas kernel); host path the same text of the arithmetic in numpy.
There is no bucket padding (the port has no compile cache); the phase
spans and the anomaly counter are the JAX package's.  JAX sends a history to the host when the segment offsets
``seg * big`` could pass int32 (``_big(pf) * (len(q_val) + 2) < 2 ** 31``);
the port's bound is int64's, ``< 2 ** 62``.  Result keeps every legacy
`TotalQueueChecker` key (lost / lost-count / unexpected /
unexpected-count / enqueue-count / dequeue-count) and adds the
elle-style ``anomaly-types`` / ``anomalies`` the witness pages render.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import backend, telemetry
from jepsen_tpu_torch.checkers import api as checker_api
from jepsen_tpu_torch.checkers.queue import packed as packed_mod
from jepsen_tpu_torch.checkers.queue.kafka import _i64, _TorchXP
from jepsen_tpu_torch.checkers.queue.packed import PackedFifo, _pow2

SITE = "queue.check"

LOST = "queue-lost"
PHANTOM = "queue-phantom"
FIFO = "queue-fifo-violation"


#: the port's bound on ``_big(pf) * (len(q_val) + 2)``: the segment
#: offsets of the running max stay exact in int64
DEVICE_BOUND = 2 ** 62


def _cummax(xp, x):
    if xp is np:
        return np.maximum.accumulate(x)
    return torch.cummax(x, 0).values


def _math(xp, big: int, e_ok, e_maybe, d_cnt, v_inv, v_done,
          q_val, q_proc, q_by_proc):
    """(lost mask [V], phantom mask [V], fifo mask [Q], prior-invoke
    index per dequeue row [Q] in q_by_proc coords, -1 none)."""
    lost = (d_cnt < e_ok)
    phantom = d_cnt > e_ok + e_maybe
    Q = q_val.shape[0]
    if Q == 0:
        z = xp.zeros(0, bool)
        return lost, phantom, z, xp.zeros(0, xp.int64)
    o = q_by_proc
    p = q_proc[o]
    valid = q_val[o] >= 0
    vs = xp.where(valid, q_val[o], 0)
    inv = xp.where(valid, v_inv[vs], -1)
    done = xp.where(valid, v_done[vs], -1)
    seg = xp.concatenate(
        [xp.zeros(1, bool), (p[1:] != p[:-1]) | ~valid[1:]])
    seg_id = xp.cumsum(_i64(xp, seg))
    run = _cummax(xp, xp.where(inv >= 0, inv, -1) + seg_id * big)
    prev = xp.concatenate([xp.full(1, -1, xp.int64), run[:-1]])
    in_seg = prev >= seg_id * big
    prev_inv = xp.where(in_seg, prev - seg_id * big, -1)
    fifo = valid & (done >= 0) & (prev_inv >= 0) & (done < prev_inv)
    return lost, phantom, fifo, prev_inv


def _big(pf: PackedFifo) -> int:
    """The segment stride: a power of two (at least 8, the JAX bucket
    floor) above every op index."""
    top = int(max(pf.v_inv.max() if len(pf.v_inv) else 0,
                  pf.q_op.max() if len(pf.q_op) else 0, 0))
    return _pow2(top + 2, 8)


def _cols(pf: PackedFifo) -> Tuple[np.ndarray, ...]:
    return (pf.e_ok, pf.e_maybe, pf.d_cnt, pf.v_inv, pf.v_done,
            pf.q_val, pf.q_proc, pf.q_by_proc)


def _reduce_host(pf: PackedFifo):
    return _math(np, _big(pf), *_cols(pf))


def _reduce_device(pf: PackedFifo, dev: torch.device):
    """`_reduce_host` on `dev`: the columns go over as int64 at their own
    lengths and the four outputs come back as numpy arrays."""
    cols = [torch.from_numpy(np.ascontiguousarray(c, np.int64)).to(dev)
            for c in _cols(pf)]
    out = _math(_TorchXP(dev), _big(pf), *cols)
    return tuple(x.cpu().numpy() for x in out)


def host_verdict(pf: PackedFifo, fifo: bool = False,
                 max_reported: int = 32) -> Dict[str, Any]:
    """The exact host oracle twin — numpy only, no tensors."""
    return _render(pf, _reduce_host(pf), fifo, max_reported)


def _render(pf: PackedFifo, reduced, fifo: bool,
            max_reported: int) -> Dict[str, Any]:
    lost_m, phantom_m, fifo_m, prev_inv = reduced
    V = pf.values
    lost = {V[i]: int(pf.e_ok[i] - pf.d_cnt[i])
            for i in np.nonzero(lost_m)[0]}
    unexpected = {V[i]: int(pf.d_cnt[i] - pf.e_ok[i] - pf.e_maybe[i])
                  for i in np.nonzero(phantom_m)[0]}
    found: Dict[str, list] = {}
    if lost:
        found[LOST] = [
            {"value": v, "times": n,
             "why": f"value {v!r} was enqueued {n} more time(s) than "
                    f"it was ever dequeued"}
            for v, n in list(lost.items())[:max_reported]]
    if unexpected:
        found[PHANTOM] = [
            {"value": v, "times": n,
             "why": f"value {v!r} was dequeued {n} more time(s) than "
                    f"it could possibly have been enqueued"}
            for v, n in list(unexpected.items())[:max_reported]]
    if fifo:
        ent = []
        for j in np.nonzero(fifo_m)[0]:
            row = int(pf.q_by_proc[j])
            v = V[pf.q_val[row]]
            ent.append({
                "process": pf.procs[pf.q_proc[row]],
                "value": v, "op-index": int(pf.q_op[row]),
                "enq-completed": int(pf.v_done[pf.q_val[row]]),
                "prior-enq-invoked": int(prev_inv[j]),
                "why": f"value {v!r} (enqueue completed at op "
                       f"{int(pf.v_done[pf.q_val[row]])}) was dequeued "
                       f"after a value whose enqueue was only invoked "
                       f"at op {int(prev_inv[j])}"})
        if ent:
            found[FIFO] = sorted(ent, key=lambda e: e["op-index"]
                                 )[:max_reported]
    out = {
        "valid?": not found,
        "anomaly-types": sorted(found),
        "anomalies": found,
        # the TotalQueueChecker legacy keys, bit-for-bit
        "lost": dict(list(lost.items())[:32]),
        "lost-count": len(lost),
        "unexpected": dict(list(unexpected.items())[:32]),
        "unexpected-count": len(unexpected),
        "enqueue-count": pf.enqueue_count,
        "dequeue-count": pf.dequeue_count,
    }
    for name, entries in found.items():
        telemetry.registry().counter(
            "queue-anomalies-found", anomaly=name).inc(len(entries))
    return out


def check(history, test: Optional[dict] = None, *,
          fifo: bool = False, use_device: bool = True,
          max_reported: int = 32,
          deadline=None, plan=None, policy=None,
          device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Check an enqueue/dequeue history.  Accepts a History / op list
    / PackedFifo / HistoryIR.  ``fifo=True`` additionally runs the
    per-consumer FIFO pass (stricter than the host scan twin — leave off
    for twin-parity contexts).

    The device path runs on `device` (the CUDA card unless the caller
    names the CPU; no card raises `backend.NoDeviceError`), guarded,
    retried and deadline-polled; only a synthetic fault of `plan`
    degrades to the host twin, with the standard stamp.
    ``use_device=False`` IS the host twin.  `test` is accepted for the
    JAX signature and not read."""
    from jepsen_tpu_torch import resilience
    from jepsen_tpu_torch.history.ir import HistoryIR

    dev = backend.resolve(device) if use_device else None
    ph = telemetry.phases()
    pf = history if isinstance(history, PackedFifo) else None
    if pf is None:
        ph.start("queue.pack", device=False)
        pf = (history.queue("fifo")
              if isinstance(history, HistoryIR)
              else packed_mod.pack_fifo(history))
    if pf.empty:
        ph.end()
        return {"valid?": "unknown"}
    if deadline is not None:
        deadline.check(SITE)
    # exactness bound for the segmented cummax (seg*big offsets)
    use_device = use_device and \
        _big(pf) * (len(pf.q_val) + 2) < DEVICE_BOUND
    if not use_device:
        ph.start("queue.check", device=False,
                 values=len(pf.values), dequeues=pf.dequeue_count)
        res = host_verdict(pf, fifo, max_reported)
        ph.end()
        return res
    ph.start("queue.check", device=True,
             values=len(pf.values), dequeues=pf.dequeue_count)
    try:
        reduced, degraded = resilience.with_fallback(
            SITE,
            lambda: _reduce_device(pf, dev),
            lambda: _reduce_host(pf),
            deadline=deadline, plan=plan, policy=policy)
    except resilience.DeadlineExceeded:
        ph.end()
        return resilience.deadline_result(checker="total-queue")
    res = _render(pf, reduced, fifo, max_reported)
    if degraded:
        res["degraded"] = degraded
    ph.end()
    return res


class PackedQueueChecker(checker_api.Checker):
    """The canonical total-queue checker: packed counting passes,
    device path + host twin, `TotalQueueChecker` scan parity pinned
    differentially.  ``fifo=True`` opts into the per-consumer FIFO
    pass on top."""

    def __init__(self, *, fifo: bool = False,
                 device: backend.DeviceLike = None):
        self.fifo = fifo
        self.device = device

    def name(self) -> str:
        return "total-queue"

    def check(self, test, history, opts=None):
        return check(history, test, fifo=self.fifo,
                     deadline=(opts or {}).get("deadline"),
                     device=self.device)
