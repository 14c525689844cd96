"""One packed-history IR that packs and pads a history once (the port's
copy of `jepsen_tpu/history/ir.py`).

:class:`HistoryIR` is a :class:`~jepsen_tpu_torch.history.ops.History`
that also memoizes

- the SoA transactional packing per workload kind (``PackedTxns``:
  txn/mop/read-element columns), and
- the padded device layout (``PaddedLA``), with its static capacity
  facts and pad-time derived-order columns, per (workload, device): a
  padded layout on the card and one on the CPU are different objects;
- the rw dependency inference (`rw_inference`, the ``RwInference`` of
  `checkers.invariants.packed.infer_rw`) shared by the predicate and
  session invariants checkers;
- the bank balance matrix (`bank`, a ``PackedBank``) per account set;
- the queue-family packing (`queue`: ``"kafka"`` -> ``PackedKafka``,
  ``"fifo"`` -> ``PackedFifo``);
- the Knossos entry table (`lin_ops`, `knossos.prep.prepare`'s LinOp
  rows), which `knossos.analysis` takes from an IR it is handed.

A checker that is handed an IR (`list_append.check`, `rw_register.check`,
`device_rw.check`) takes both from it, so repeat checks of one history pay
the pack and the pad once.  The IR *shares* the source history's op list
and pair index, so every consumer that only needs a History keeps working.

The JAX package books each section's build time into its telemetry spans;
the port has no telemetry module, so the build times stay on the IR as a
plain dict, :attr:`HistoryIR.build_s`.  The JAX sections whose consumers
are not ported yet (`bucket_class`) are left out.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import backend
from jepsen_tpu_torch.history.ops import History
from jepsen_tpu_torch.history.soa import PackedTxns, pack_txns

__all__ = ["IR_VERSION", "HistoryIR"]

#: layout contract version: v1 = the implicit per-family packings,
#: v2 = this module (capacity facts + pad-time derived-order columns)
IR_VERSION = 2


def _device_key(device: backend.DeviceLike) -> torch.device:
    """The device a padded section lives on, with a CUDA index always
    given, so that ``"cuda"`` and ``None`` name the same card."""
    dev = backend.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class HistoryIR(History):
    """A History that memoizes its packed and padded views."""

    def __init__(self, source):
        self._packed: Dict[str, PackedTxns] = {}
        self._padded: Dict[Tuple[str, torch.device], Any] = {}
        self._packed_source = None
        self._lin_ops: Optional[List[Any]] = None
        self._rw_inf = None
        self._bank: Dict[Optional[Tuple[str, ...]], Any] = {}
        self._queue: Dict[str, Any] = {}
        #: seconds each section's build took, by section name (memoized
        #: hits add nothing)
        self.build_s: Dict[str, float] = {}
        if isinstance(source, PackedTxns):
            # packed-only IR: no op-level view (checkers that need ops
            # degrade exactly as they do for a bare PackedTxns)
            self.ops = []
            self._pair = np.zeros(0, np.int64)
            self._packed_source = source
        elif isinstance(source, History):
            # share, don't rebuild: the op list and pair index are the
            # source's own objects
            self.ops = source.ops
            self._pair = source._pair
        else:
            ops = list(source)
            super().__init__(
                ops, reindex=any(op.index < 0 for op in ops))

    def _booked(self, section: str, build):
        """Run one cache-miss section build and add its wall time to
        `build_s[section]`."""
        t0 = time.perf_counter()
        out = build()
        self.build_s[section] = self.build_s.get(section, 0.0) + \
            time.perf_counter() - t0
        return out

    @property
    def packed_only(self) -> bool:
        """True when built from a bare PackedTxns — no op-level view;
        checkers needing ops must degrade exactly as for PackedTxns."""
        return self._packed_source is not None

    @classmethod
    def of(cls, history) -> "HistoryIR":
        """Idempotent constructor: an IR passes through unchanged."""
        if isinstance(history, HistoryIR):
            return history
        return cls(history)

    # -- memoized sections --------------------------------------------------

    def packed(self, workload: str = "list-append") -> PackedTxns:
        """The SoA transactional packing for `workload`
        ("list-append" / "rw-register")."""
        if self._packed_source is not None:
            return self._packed_source
        p = self._packed.get(workload)
        if p is None:
            p = self._packed[workload] = self._booked(
                f"packed:{workload}", lambda: pack_txns(self, workload))
        return p

    def padded(self, workload: str = "list-append",
               device: backend.DeviceLike = None):
        """The padded device layout (`PaddedLA`) of `workload` on `device`
        (the CUDA card unless the caller names the CPU), with its capacity
        facts and derived-order columns: the pad is paid once per
        (workload, device)."""
        dev = _device_key(device)
        h = self._padded.get((workload, dev))
        if h is None:
            from jepsen_tpu_torch.checkers.elle import device_infer

            packed = self.packed(workload)
            h = self._padded[(workload, dev)] = self._booked(
                f"padded:{workload}:{dev}",
                lambda: device_infer.pad_packed(packed, device=dev))
        return h

    def rw_inference(self):
        """The shared rw dependency inference (RwInference) the
        predicate and session invariants checkers both consume."""
        if self._rw_inf is None:
            from jepsen_tpu_torch.checkers.invariants import packed as inv

            packed = self.packed("rw-register")
            self._rw_inf = self._booked(
                "rw_inference", lambda: inv.infer_rw(packed))
        return self._rw_inf

    def bank(self, accounts=None):
        """The bank balance-matrix packing (PackedBank)."""
        key = tuple(sorted(map(repr, accounts))) if accounts else None
        pb = self._bank.get(key)
        if pb is None:
            from jepsen_tpu_torch.checkers.invariants.packed import pack_bank

            pb = self._bank[key] = self._booked(
                "bank", lambda: pack_bank(self, accounts))
        return pb

    def queue(self, kind: str = "kafka"):
        """The queue-family packing: ``"kafka"`` -> PackedKafka
        (send/poll/epoch columns + derived orders), ``"fifo"`` ->
        PackedFifo (enqueue/dequeue counting columns + the
        per-consumer dequeue order)."""
        pq = self._queue.get(kind)
        if pq is None:
            from jepsen_tpu_torch.checkers.queue import packed as q_packed

            build = (q_packed.pack_kafka if kind == "kafka"
                     else q_packed.pack_fifo)
            pq = self._queue[kind] = self._booked(
                f"queue:{kind}", lambda: build(self))
        return pq

    def lin_ops(self) -> List[Any]:
        """The knossos linearizability entry table (LinOp rows)."""
        if self._lin_ops is None:
            from jepsen_tpu_torch.checkers.knossos.prep import prepare

            self._lin_ops = self._booked("lin_ops", lambda: prepare(self))
        return self._lin_ops

    def layout(self, device: backend.DeviceLike = None) -> Dict[str, Any]:
        """The versioned layout summary of the padded list-append view on
        `device`: capacities + which facts/columns are active."""
        h = self.padded("list-append", device)
        return {
            "version": IR_VERSION,
            "T": int(h.txn_type.shape[0]),
            "M": int(h.mop_txn.shape[0]),
            "R": int(h.rd_elems.shape[0]),
            "v_cap": h.v_cap, "o_cap": h.o_cap,
            "txn_major": h.txn_major, "run_cap": h.run_cap,
            "complete_monotone": h.complete_monotone,
            "app_val_mono": h.app_val_mono,
            "rd_start_mono": h.rd_start_mono,
            "proc_seq": h.proc_seq,
            "derived_columns": h.run_sort is not None,
        }
