"""Fault injection (the port's copy of `jepsen_tpu/nemesis/__init__.py`
and `nemesis/core.py`; reference: `jepsen/nemesis*.clj`, SURVEY.md §1
L4b).

The nemesis is a special single-threaded client driven by the generator's
nemesis thread: `invoke` receives fault ops (`start-partition`, `kill`,
`bump-clock`, ...) and performs them against the cluster via the control
plane.  Host-side only.  The sim, membership, clock, combined and
faketime nemeses of the JAX package are not ported yet.
"""

from jepsen_tpu_torch.nemesis.core import (Nemesis, Noop, bridge,
                                           complete_grudge, compose,
                                           hammer_time, invert_grudge,
                                           majorities_ring,
                                           node_start_stopper,
                                           partition_halves,
                                           partition_majorities_ring,
                                           partition_random_halves,
                                           partition_random_node,
                                           partitioner, split_one)

__all__ = [
    "Nemesis", "Noop", "bridge", "complete_grudge", "compose",
    "hammer_time", "invert_grudge", "majorities_ring", "node_start_stopper",
    "partition_halves", "partition_majorities_ring",
    "partition_random_halves", "partition_random_node", "partitioner",
    "split_one",
]
