"""Segmented prefix-OR over an (n, K) int8 plane, inclusive or exclusive:
kernel 2 of the port.

Counterpart of `jepsen_tpu/ops/pallas_scan.py`.  The cycle sweep's chain
pass (`ops/cycle_sweep.py`) propagates reachability labels along chains
with the exclusive scan.

- `seg_or_plain`: the plain PyTorch version of the function (segmented
  Hillis-Steele doubling, as `jepsen_tpu/ops/segments.py::_seg_scan_loop`;
  the exclusive scan shifts the plane down one row and zeroes the start
  rows first, as `jepsen_tpu/ops/segments.py::segmented_prefix_or` does).
- `seg_or_cuda`: the hand-written CUDA kernel (`csrc/seg_or.cu`, one pass
  with decoupled look-back, the exclusive shift fused), for CUDA tensors
  only; counts its launches in `LAUNCHES`.
- `seg_or`: dispatch on the tensor's device.  A CUDA tensor goes to the
  kernel (which raises on a dtype or shape it does not take), a CPU tensor
  to the plain version.  Nothing falls back.
"""

from __future__ import annotations

import dataclasses

import torch

from jepsen_tpu_torch.ops import kernels

#: launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0

#: `csrc/seg_or.cu`'s threads per block and rows per thread run
THREADS = 256
ITEMS = 8


def seg_or_plain(values: torch.Tensor, starts: torch.Tensor,
                 exclusive: bool = False) -> torch.Tensor:
    """out[i] = OR of values[j] for j from the last start <= i (or row 0)
    through i (exclusive: strictly before i, so a start row gets 0).
    State (v, blocked): blocked[i] = a start lies in (i - dist, i], so row
    i may not absorb the row `dist` back."""
    n = values.shape[0]
    if n == 0:
        return values.clone()
    bshape = (n,) + (1,) * (values.dim() - 1)
    blocked = starts.to(torch.bool)
    v = values
    if exclusive:
        # inclusive scan over the values shifted down one row, with the
        # start rows zeroed (they must not see the previous segment's last
        # value)
        shifted = torch.cat([torch.zeros_like(values[:1]), values[:-1]])
        v = torch.where(blocked.reshape(bshape), torch.zeros_like(shifted),
                        shifted)
    dist = 1
    while dist < n:
        take = torch.zeros(n, dtype=torch.bool, device=values.device)
        take[dist:] = ~blocked[dist:]
        prev = torch.zeros_like(v)
        prev[dist:] = v[:-dist]
        v = v | torch.where(take.reshape(bshape), prev, torch.zeros_like(v))
        prev_blocked = torch.ones_like(blocked)
        prev_blocked[dist:] = blocked[:-dist]
        blocked = blocked | prev_blocked
        dist *= 2
    return v


@dataclasses.dataclass(frozen=True)
class SegOrGeometry:
    """How `csrc/seg_or.cu` cuts an (n, K) plane into tiles."""
    word: int          # bytes per column word: 16, 4 or 1
    nw: int            # column words per row
    cbw: int           # column words per column block (one thread each;
                       # a power of two, so a warp holds whole runs)
    runs: int          # row runs of ITEMS rows per tile
    tile_rows: int     # runs * ITEMS
    row_tiles: int
    col_blocks: int
    tiles: int         # row_tiles * col_blocks, one block each
    state_words: int   # uint32: the tile counter, then one state per tile
    value_bytes: int   # each tile's aggregate and inclusive prefix


def seg_or_geometry(n: int, k: int, addresses: tuple[int, ...] = ()
                    ) -> SegOrGeometry:
    """The kernel's tiling of an (n, K) plane whose values and output lie
    at `addresses`: the widest word that divides K and every address, a
    tile of a power-of-two block of at most 256 column words by
    `THREADS // cbw` runs of ITEMS rows (256 x 128 bytes at K = 128), and
    the scratch sizes."""
    word = next((w for w in (16, 4)
                 if k % w == 0 and all(a % w == 0 for a in addresses)), 1)
    nw = k // word
    cbw = min(1 << (nw - 1).bit_length(), THREADS)
    runs = THREADS // cbw
    tile_rows = runs * ITEMS
    row_tiles = -(-n // tile_rows)
    col_blocks = -(-nw // cbw)
    tiles = row_tiles * col_blocks
    return SegOrGeometry(word, nw, cbw, runs, tile_rows, row_tiles,
                         col_blocks, tiles, 1 + tiles, 2 * tiles * cbw * word)


def seg_or_cuda(values: torch.Tensor, starts: torch.Tensor,
                exclusive: bool = False) -> torch.Tensor:
    """`seg_or_plain` by the CUDA kernel: one memset of the tile states
    and one launch, on the current stream."""
    global LAUNCHES
    if values.device.type != "cuda" or starts.device != values.device:
        raise ValueError("seg_or_cuda takes CUDA tensors on one device, got "
                         f"{values.device} and {starts.device}")
    if values.dtype != torch.int8 or values.dim() != 2 \
            or not values.is_contiguous():
        raise ValueError("seg_or_cuda takes a contiguous 2-D int8 plane, "
                         f"got {values.dtype} {tuple(values.shape)}")
    n, k = values.shape
    if starts.shape != (n,) or starts.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"seg_or_cuda takes ({n},) bool start flags, got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    out = torch.empty_like(values)
    if n == 0 or k == 0:
        return out
    st = starts.contiguous().view(torch.uint8)
    g = seg_or_geometry(n, k, (values.data_ptr(), out.data_ptr()))
    states = torch.empty(g.state_words, dtype=torch.int32,
                         device=values.device)
    tile_values = torch.empty(g.value_bytes, dtype=torch.int8,
                              device=values.device)
    lib = kernels.lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_seg_or_int8(
            values.data_ptr(), st.data_ptr(), out.data_ptr(),
            states.data_ptr(), tile_values.data_ptr(), n, k, g.word, g.cbw,
            g.runs, g.tiles, g.col_blocks, int(exclusive), stream)
    kernels.check("seg_or", err)
    LAUNCHES += 1
    return out


def seg_or(values: torch.Tensor, starts: torch.Tensor,
           exclusive: bool = False) -> torch.Tensor:
    """Segmented prefix-OR of an (n, K) int8 plane (any shape on the
    CPU), inclusive or exclusive."""
    if values.device.type == "cuda":
        return seg_or_cuda(values, starts, exclusive)
    if values.device.type == "cpu":
        return seg_or_plain(values, starts, exclusive)
    raise ValueError(f"seg_or: no implementation for device {values.device}")
