"""jepsen_tpu_torch — the PyTorch + CUDA port of `jepsen_tpu`'s device layer.

A package beside `jepsen_tpu` with the same module paths.  It imports
`torch`, `numpy` and the standard library only — never `jax` and nothing
of `jepsen_tpu`.  Its entry points (`pad_packed`, `core_check`,
`core_check_exact`, `detect_cycles`) run on the CUDA card unless the
caller passes `device="cpu"`.  The two TPU kernels of the list-append
check are hand-written CUDA C++ for Hopper (`csrc/`), built at first use.
"""
