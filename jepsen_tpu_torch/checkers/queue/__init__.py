"""Packed queue/kafka checker family (the port's copy of
`jepsen_tpu/checkers/queue/__init__.py`).

Queue and kafka semantics — previously host-only scans
(`workloads/kafka.py`'s `KafkaChecker`, `checker_api.TotalQueueChecker`)
— as whole-history
vectorized reductions over SoA columns on the HistoryIR, with a device
path (torch ops on the CUDA card) behind
``resilience.with_fallback(site="queue.check")``, and the original
scans pinned as differential twins (verdict-for-verdict on seeded
corpora; tests/test_torch_queue.py).

- :mod:`.packed` — pack send/poll/assign/offset-commit histories into
  per-key offset ladders, per-consumer observation rows, and pack-time
  derived orders (``HistoryIR.queue(kind)`` memoizes both views);
- :mod:`.kafka` — the kafka anomaly taxonomy (lost-write, duplicate,
  inconsistent-offsets, poll/send order, precommitted-read,
  stale-consumer-group) as one fused mask pass;
- :mod:`.fifo` — the total-queue counting model + the opt-in
  per-consumer FIFO pass.

Registry: :data:`MODELS` follows `checkers.invariants.MODELS` — model
name -> flywheel metadata (workload, device classification, anomaly
vocabulary) so campaign specs, shrink probe twins, and witness
renderers agree on one table.
"""

from __future__ import annotations

from jepsen_tpu_torch.checkers.queue import fifo, kafka, packed

__all__ = ["packed", "kafka", "fifo", "MODELS"]

#: model name -> flywheel metadata (same shape as invariants.MODELS)
MODELS = {
    "kafka": {
        "workload": "kafka",
        "device": True,
        "anomalies": kafka.ANOMALIES,
    },
    "total-queue": {
        "workload": "queue",
        "device": True,
        "anomalies": (fifo.LOST, fifo.PHANTOM, fifo.FIFO),
    },
}
