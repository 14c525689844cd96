"""Checkers (the port of `jepsen_tpu/checkers`): the checker API
(`api`: `Checker`, `check_safe`, `compose`, the built-in history checkers,
`Linearizable` and `QueueChecker`), the Elle checks on the card
(`elle.list_append.check`, `elle.rw_register.check`), Knossos
linearizability (`knossos.analysis`, with its device leg
`knossos.device_wgl.check`), the invariants family (`invariants`) and the
queue/kafka family (`queue.kafka.check`, `queue.fifo.check`)."""

from jepsen_tpu_torch.checkers.api import Checker, check_safe, compose

__all__ = ["Checker", "check_safe", "compose"]
