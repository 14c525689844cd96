"""A mesh of torch devices driven from one process (the port's
counterpart of `jax.sharding.Mesh`).

The JAX package has a single controller: one process drives every device
of its mesh, and its tests run every mesh on 8 virtual host devices.  The
port does the same over a list of `torch.device`s.  Devices may repeat: a
mesh of 4 shards on ``cuda:0``, or on ``cpu``, is a valid mesh, and it is
how one card and the CPU tests run the sharded paths (every window, every
gather and every combined flag; only the copies between cards need more
than one card).

Two helpers stand in for the collectives the JAX paths use inside
`shard_map`: `all_gather_rows` (``jax.lax.all_gather(..., tiled=True)``
along axis 0) and the host `psum` / `pmax` of per-shard scalars.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "all_gather_rows", "psum", "pmax"]


class Mesh:
    """`devices`, an array of `torch.device` (anything `torch.device`
    takes) with one dimension per name of `axis_names`.

    ``.devices`` is that numpy object array, ``.shape`` maps each axis
    name to its size, ``.axis_names`` is the tuple of names.  Devices may
    repeat; a mesh that mixes device types (``cpu`` with ``cuda``) raises
    `ValueError`."""

    def __init__(self, devices, axis_names: Sequence[str]):
        names = (axis_names,) if isinstance(axis_names, str) \
            else tuple(axis_names)
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for ix in np.ndindex(src.shape):
            arr[ix] = torch.device(src[ix])
        if arr.ndim != len(names):
            raise ValueError(f"a mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in arr.flat}
        if len(types) > 1:
            raise ValueError(f"a mesh holds one device type, got "
                             f"{sorted(types)}")
        self.devices = arr
        self.axis_names: Tuple[str, ...] = names
        self.shape: Dict[str, int] = dict(zip(names, arr.shape))

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.shape})")


def all_gather_rows(parts: Iterable[torch.Tensor],
                    device: torch.device) -> torch.Tensor:
    """Each part copied to `device`, then concatenated along axis 0 in
    order: the tiled all_gather of the JAX paths, landing on one
    device."""
    return torch.cat([p.to(device) for p in parts], dim=0)


def psum(values: Iterable) -> int:
    """The sum over shards of per-shard integer scalars."""
    return sum(int(v) for v in values)


def pmax(values: Iterable) -> int:
    """The maximum over shards of per-shard integer scalars (the OR of
    0/1 flags)."""
    return max(int(v) for v in values)
