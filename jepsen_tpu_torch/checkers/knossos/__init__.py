"""Knossos-style linearizability checking (the port of
`jepsen_tpu/checkers/knossos`): host WGL (`wgl.check`), JIT-linear
(`linear.check`), the batched frontier search on the card
(`device_wgl.check`), and `analysis`, which races them."""

from jepsen_tpu_torch.checkers.knossos.wgl import check as check_wgl
from jepsen_tpu_torch.checkers.knossos.competition import analysis

__all__ = ["check_wgl", "analysis"]
