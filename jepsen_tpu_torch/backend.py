"""Device choice for the port (counterpart of `jepsen_tpu/utils/backend.py`).

The port runs on a CUDA card unless the caller names the CPU.  There is
no silent fallback: asking for the default device on a machine without a
visible GPU raises, so a run that was meant for the card cannot quietly
measure the CPU instead.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The first CUDA device; raises when none is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "jepsen_tpu_torch: no CUDA device is visible; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device: DeviceLike) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    if device is None:
        return default_device()
    return torch.device(device)
