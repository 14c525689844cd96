"""Synthetic workloads (the port's copy of the packed list-append and
rw-register generators and the op-level rw-register simulator)."""
