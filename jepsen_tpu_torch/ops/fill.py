"""Flat forward-fill (LOCF) of int32 with holes == -1: kernel 1 of the port.

Counterpart of `jepsen_tpu/ops/pallas_fill.py`.  Edge inference
(`checkers/elle/device_infer.py`) seeds per-segment values at segment
starts and fills the holes forward; `locf` does that fill.

- `locf_plain`: the plain PyTorch version of the function (a cummax of
  the non-hole positions, then one gather).
- `locf_cuda`: the hand-written CUDA kernel (`csrc/locf.cu`, one pass
  with decoupled look-back), for CUDA tensors only; counts its launches
  in `LAUNCHES`.
- `locf`: dispatch on the tensor's device.  A CUDA tensor goes to the
  kernel (which raises on a dtype or shape it does not take), a CPU tensor
  to the plain version.  Nothing falls back.
"""

from __future__ import annotations

import torch

from jepsen_tpu_torch.ops import kernels

HOLE = -1

#: launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0

#: elements per tile of `csrc/locf.cu` (its TILE)
TILE = 4096


def locf_geometry(n: int) -> tuple[int, int]:
    """(tiles, scratch words) of the kernel for n elements: one uint64
    status word per tile, after one that holds the tile counter."""
    tiles = -(-n // TILE)
    return tiles, 1 + tiles


def locf_plain(x: torch.Tensor) -> torch.Tensor:
    """out[i] = x[j] for the largest j <= i with x[j] != -1, else -1.
    On seeds whose non-hole values are nondecreasing this equals
    `torch.cummax(x)`."""
    if x.numel() == 0:
        return x.clone()
    pos = torch.arange(x.shape[0], device=x.device)
    last = torch.cummax(torch.where(x != HOLE, pos, -1), 0).values
    return torch.where(last >= 0, x[last.clamp(min=0)],
                       torch.full_like(x, HOLE))


def locf_cuda(x: torch.Tensor) -> torch.Tensor:
    """`locf_plain` by the CUDA kernel: one memset of the tile status and
    one launch, on the current stream."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"locf_cuda takes a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("locf_cuda takes a contiguous 1-D int32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    lib = kernels.lib()
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    _, words = locf_geometry(n)
    scratch = torch.empty(words, dtype=torch.int64, device=x.device)
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_locf_int32(x.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), n, int(aligned), stream)
    kernels.check("locf", err)
    LAUNCHES += 1
    return out


def locf(x: torch.Tensor) -> torch.Tensor:
    """Forward-fill holes (== -1) from the left; leading holes stay -1."""
    if x.device.type == "cuda":
        return locf_cuda(x)
    if x.device.type == "cpu":
        return locf_plain(x)
    raise ValueError(f"locf: no implementation for device {x.device}")
