"""``torch.profiler`` integration (the port's copy of
`jepsen_tpu/utils/profiling.py`, which drives the JAX profiler).

The reference's post-hoc story is perf plots from history folds
(`checker/perf.clj`); the port adds kernel-level tracing: wrap any
checking call in :func:`trace` to capture the host's torch operators and
the card's CUDA kernels as one Chrome trace (``torch_trace.json``),
viewable in Perfetto, e.g.

    with profiling.trace("build/profile"):
        core_check(h, n_keys)

Unlike the JAX module, a profiler that cannot start raises: a run that
asked for a trace must not go on untraced.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

logger = logging.getLogger("jepsen.profiling")

#: the Chrome trace :func:`trace` writes into its directory
TRACE_FILE = "torch_trace.json"


def _activities() -> list:
    """CPU always; CUDA when this torch build sees a card."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(out_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the body into
    ``<out_dir>/torch_trace.json`` (no-op when `out_dir` is None).  A
    profiler that fails to start, or whose trace cannot be written after
    a body that succeeded, raises.  Body exceptions propagate untouched:
    a teardown failure after one is logged, never raised over it."""
    if not out_dir:
        yield
        return
    from torch.profiler import profile

    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=_activities())
    prof.__enter__()
    ok = False
    try:
        yield
        ok = True
    finally:
        path = os.path.join(out_dir, TRACE_FILE)
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)
            logger.info("torch profiler trace written to %s", path)
        except Exception:
            if ok:
                raise
            logger.warning("torch profiler teardown failed",
                           exc_info=True)


def annotate(name: str):
    """Named range inside a trace (``torch.profiler.record_function``);
    it records nothing while no profiler is running."""
    from torch.profiler import record_function

    return record_function(name)
