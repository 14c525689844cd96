"""Inclusive segmented prefix-OR over an (n, K) int8 plane: kernel 2 of
the port.

Counterpart of `jepsen_tpu/ops/pallas_scan.py`.  The cycle sweep's chain
pass (`ops/cycle_sweep.py`) propagates reachability labels along chains
with this scan.

- `seg_or_plain`: the plain PyTorch version of the function (segmented
  Hillis-Steele doubling, as `jepsen_tpu/ops/segments.py::_seg_scan_loop`).
- `seg_or_cuda`: the hand-written CUDA kernel (`csrc/seg_or.cu`), for CUDA
  tensors only; counts its launches in `LAUNCHES`.
- `seg_or`: dispatch on the tensor's device.  A CUDA tensor goes to the
  kernel (which raises on a dtype or shape it does not take), a CPU tensor
  to the plain version.  Nothing falls back.
"""

from __future__ import annotations

import torch

from jepsen_tpu_torch.ops import kernels

#: launches of the CUDA kernel since the count was last set to 0
LAUNCHES = 0

#: aim for about this many threads per pass (one per chunk x column word)
_TARGET_THREADS = 1 << 18


def seg_or_plain(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """out[i] = OR of values[j] for j from the last start <= i (or row 0)
    through i.  State (v, blocked): blocked[i] = a start lies in
    (i - dist, i], so row i may not absorb the row `dist` back."""
    n = values.shape[0]
    if n == 0:
        return values.clone()
    v = values
    blocked = starts.to(torch.bool)
    bshape = (n,) + (1,) * (values.dim() - 1)
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


def _word(k: int, *tensors: torch.Tensor) -> int:
    for word in (16, 4):
        if k % word == 0 and all(t.data_ptr() % word == 0 for t in tensors):
            return word
    return 1


def seg_or_cuda(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """`seg_or_plain` by the CUDA kernel: three launches (chunk aggregates,
    chunk carries, apply) on the current stream."""
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
    word = _word(k, values, out)
    nw = k // word
    chunk_rows = min(4096, max(16, -(-n * nw // _TARGET_THREADS)))
    n_chunks = -(-n // chunk_rows)
    agg = torch.empty((2, n_chunks, k), dtype=torch.int8,
                      device=values.device)
    seen = torch.empty(n_chunks, dtype=torch.uint8, device=values.device)
    lib = kernels.lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_seg_or_int8(values.data_ptr(), st.data_ptr(),
                                 out.data_ptr(), agg[0].data_ptr(),
                                 agg[1].data_ptr(), seen.data_ptr(), n, k,
                                 word, chunk_rows, stream)
    kernels.check("seg_or", err)
    LAUNCHES += 1
    return out


def seg_or(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented prefix-OR of an (n, K) int8 plane."""
    if values.device.type == "cuda":
        return seg_or_cuda(values, starts)
    if values.device.type == "cpu":
        return seg_or_plain(values, starts)
    raise ValueError(f"seg_or: no implementation for device {values.device}")
