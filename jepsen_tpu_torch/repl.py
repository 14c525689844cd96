"""REPL conveniences (the port's copy of `jepsen_tpu/repl.py`).

Equivalent of the reference's `jepsen/src/jepsen/repl.clj` (SURVEY.md
§2.1): one-liners for poking at stored runs from an interactive session::

    >>> from jepsen_tpu_torch import repl
    >>> t = repl.latest("demo-append")
    >>> repl.summary(t)
    >>> h = repl.history(t)
    >>> repl.recheck(t, AppendChecker())

`recheck` runs the checker where it is built to run: the port's checkers
use the CUDA card unless they were made for the CPU.
"""

from __future__ import annotations

from typing import Any, Optional

from . import core, report, store
from .history.ops import History


def latest(name: Optional[str] = None, *, base: Optional[str] = None) -> dict:
    """Load the most recent run (of a name, or overall)."""
    d = store.latest(name, base=base)
    if d is None:
        raise FileNotFoundError(f"no stored runs for {name!r}")
    return store.load(d)


def history(test: dict) -> History:
    """The (materialized) history of a loaded test."""
    h = test.get("history")
    if h is None:
        raise ValueError("test has no history")
    return h if isinstance(h, History) else h.materialize()


def summary(test: dict) -> None:
    report.print_report(test)


def recheck(test: dict, checker) -> dict:
    """Re-run a checker and re-save results (reference: REPL re-analysis
    path)."""
    return core.analyze(test, checker=checker)


def runs(name: Optional[str] = None, *, base: Optional[str] = None):
    """List stored run directories, newest first."""
    return store.tests(name, base=base)
