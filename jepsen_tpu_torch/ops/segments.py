"""Segment primitives for device-side history analysis (PyTorch).

Counterpart of `jepsen_tpu/ops/segments.py`: segmented prefix-OR scans
(chains), masked scatter-combine (relaxation steps), run-boundary
detection over sorted keys, segmented cumsum and cummax.  Every function
is bit-equal to its JAX counterpart on the same inputs.

The segmented prefix-OR goes to `ops.scan.seg_or`, which launches the
CUDA kernel for a CUDA tensor at every n, the exclusive shift fused into
it, and runs the plain version for a CPU tensor (the JAX package's
2^17-row switch only bounded XLA compile time, which eager PyTorch does
not have).
"""

from __future__ import annotations

import torch

from jepsen_tpu_torch.ops import scan


def segment_starts_from_sorted(keys: torch.Tensor) -> torch.Tensor:
    """Boolean 'segment starts here' flags for a sorted key array."""
    if keys.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=keys.device)
    first = torch.ones(1, dtype=torch.bool, device=keys.device)
    return torch.cat([first, keys[1:] != keys[:-1]])


def _bcast(flags: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return flags.reshape(flags.shape + (1,) * (like.dim() - 1))


def segmented_prefix_or(values: torch.Tensor, starts: torch.Tensor,
                        exclusive: bool = False) -> torch.Tensor:
    """Segmented prefix-OR along axis 0.

    values: (n, ...) integer lanes; starts: (n,) bool, True at the first
    element of each segment.  Returns, for each position, the OR of all
    values from its segment start through itself (or strictly before, if
    exclusive)."""
    if values.shape[0] == 0:
        return values
    return scan.seg_or(values.contiguous(), starts, exclusive)


def scatter_or(target: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """target[idx] |= values where mask, for 0/1 int8 label planes.

    OR == max on 0/1 lanes, so this is a scatter-max.  Masked rows are
    dropped, and so are indices outside [0, n] after negative ones wrap
    once (JAX's sink row n included), as a JAX scatter drops them: they
    land in sink rows cut off afterwards."""
    n = target.shape[0]
    i = torch.where(mask, idx.to(torch.int64), n)
    i = torch.where(i < 0, i + n + 1, i)
    i = torch.where((i < 0) | (i >= n), sink_rows(n, i.shape[0], i.device),
                    i)
    padded = torch.cat([target, target.new_zeros((SINKS,) + target.shape[1:])])
    padded.scatter_reduce_(0, _bcast(i, values).expand_as(values),
                           values.to(target.dtype), "amax",
                           include_self=True)
    return padded[:n]


#: dropped rows are spread over this many sink rows: a CUDA scatter-max
#: serializes its atomics per address, and millions of masked rows on one
#: sink row would queue behind each other
SINKS = 1024


def sink_rows(n: int, count: int, device) -> torch.Tensor:
    """Sink row per position for `count` scatter rows over an n-row
    target: n + (position mod SINKS)."""
    return n + torch.arange(count, device=device) % SINKS


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """src[idx] with masked rows zeroed (out-of-range indices clamp, as a
    JAX gather clamps them)."""
    n = src.shape[0]
    safe = torch.where(mask, idx.to(torch.int64), 0)
    safe = torch.where(safe < 0, safe + n, safe).clamp(0, n - 1)
    rows = src[safe]
    return torch.where(_bcast(mask, rows), rows, torch.zeros_like(rows))


def segment_ids_from_starts(starts: torch.Tensor) -> torch.Tensor:
    """0-based segment id per position from start flags."""
    return torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32) - 1


def segmented_cumsum(values: torch.Tensor, starts: torch.Tensor,
                     exclusive: bool = False) -> torch.Tensor:
    """Per-segment running sum via global cumsum minus segment base."""
    g = torch.cumsum(values, 0, dtype=values.dtype)
    seg = segment_ids_from_starts(starts).to(torch.int64)
    n = starts.shape[0]
    # nonzero(size=n, fill_value=0): start positions padded with 0
    start_pos = torch.zeros(n, dtype=torch.int64, device=starts.device)
    nz = torch.nonzero(starts).reshape(-1)
    start_pos[:nz.shape[0]] = nz
    base_incl = g[start_pos]          # inclusive cumsum AT each segment start
    start_vals = values[start_pos]
    base = (base_incl - start_vals)[seg]   # cumsum strictly before segment
    incl = g - base
    return incl - values if exclusive else incl


def segmented_cummax(values: torch.Tensor, starts: torch.Tensor,
                     exclusive: bool = False,
                     neutral: int = -(2 ** 31) + 1) -> torch.Tensor:
    """Per-segment running max of int32 values.

    One global int64 cummax of (segment id, value) packed as
    seg * 2^33 + (value + 2^32): segment ids never decrease along the
    axis, so each segment's first element outranks everything before it
    and the max restarts there — exact for any int32 values."""
    vals = values
    if exclusive:
        vals = torch.cat([torch.full((1,), neutral, dtype=values.dtype,
                                     device=values.device), values[:-1]])
        vals = torch.where(starts, torch.full_like(vals, neutral), vals)
    if vals.shape[0] == 0:
        return vals
    seg = torch.cumsum(starts.to(torch.int64), 0)
    packed = seg * (1 << 33) + (vals.to(torch.int64) + (1 << 32))
    top = torch.cummax(packed, 0).values
    return (top - seg * (1 << 33) - (1 << 32)).to(values.dtype)
