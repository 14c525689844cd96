"""jepsen_tpu_torch — the PyTorch + CUDA port of `jepsen_tpu`'s device layer.

A package beside `jepsen_tpu` with the same module paths.  It imports
`torch`, `numpy` and the standard library only — never `jax` and nothing
of `jepsen_tpu`.  Its entry points (`pad_packed`, `core_check`,
`core_check_exact`, `detect_cycles`, `list_append.check`,
`rw_core_check`, `rw_register.check`, `HistoryIR.padded`, the Knossos
`device_wgl.check` and `analysis`, the checker API's `Linearizable`
and `QueueChecker`, the batched `parallel.batch.check_batch` and the
stored-run `checkers.elle.stream.check_stored`) run on the CUDA card
unless the caller passes `device="cpu"`.  The two TPU kernels of the Elle checks are hand-written
CUDA C++ for Hopper (`csrc/`), built at first use; the Knossos search on
the card is plain torch (the JAX package has no Pallas kernel there).
"""
