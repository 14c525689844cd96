"""Batched checking of many histories (the port's copy of the one-card
part of `jepsen_tpu/parallel`: `batch.py` without its mesh branch)."""
