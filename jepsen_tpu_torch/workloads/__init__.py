"""Synthetic workloads (the port's copy of the packed generator)."""
