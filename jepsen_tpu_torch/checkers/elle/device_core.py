"""Core verdict function for list-append histories (PyTorch).

Counterpart of `jepsen_tpu/checkers/elle/device_core.py`: `core_check` =
`device_infer.infer` + cycle sweeps over a fixed projection set, returning
the same compact anomaly bitmap.

Projection set (covers strict-serializable checking):
  0: ww                       (G0)
  1: ww+wr                    (G1c)
  2: ww+wr+rw                 (G-single / G2-item family)
  3: ww+wr+rw+process         (strong-session variants)
  4: ww+wr+rw+realtime        (strict/strong variants)

Bit layout of the result:  [duplicate-appends, duplicate-elements,
incompatible-order, G1a, G1b, dirty-update, internal,
cycle-proj0..cycle-proj4, converged]

Inference and sweep are separate eager stages here, so the JAX package's
fused/staged split has no counterpart: `core_check_auto` and
`core_check_staged` are names for `core_check`.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from jepsen_tpu_torch import backend, resilience
from jepsen_tpu_torch.checkers.elle.device_infer import (
    PaddedLA,
    infer,
    to_device,
)
# budget caps live with the sweep; re-exported for callers
from jepsen_tpu_torch.ops.cycle_sweep import (  # noqa: F401
    MAX_K_CAP,
    MAX_ROUNDS_CAP,
    projection_scan,
)

N_COUNT_BITS = 7
PROJECTIONS = (
    ("ww",),
    ("ww", "wr"),
    ("ww", "wr", "rw"),
    ("ww", "wr", "rw", "process"),
    ("ww", "wr", "rw", "realtime"),
)
COUNT_NAMES = ("duplicate-appends", "duplicate-elements",
               "incompatible-order", "G1a", "G1b", "dirty-update",
               "internal")
EDGE_FAMILIES = ("ww", "wr", "rw", "tb", "bt")


def proj_include_stack(projections=PROJECTIONS) -> torch.Tensor:
    """(P, 5) family-include flags for the ww/wr/rw/tb/bt edge families
    (tb/bt are the realtime-barrier families)."""
    return torch.tensor([
        [int("ww" in p), int("wr" in p), int("rw" in p),
         int("realtime" in p), int("realtime" in p)]
        for p in projections], dtype=torch.int32)


def chain_include_stack(projections=PROJECTIONS) -> torch.Tensor:
    """(P, 2) chain-group include flags for [process, barrier] chains."""
    return torch.tensor([
        [int("process" in p), int("realtime" in p)]
        for p in projections], dtype=torch.int32)


def _verdict(out, max_k: int, max_rounds: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sweep half of the core check: infer output -> (bits, overflowed)."""
    T = out["ranks"]["txn"].shape[0]
    edges = out["edges"]
    dev = out["ranks"]["txn"].device
    rank = torch.cat([out["ranks"]["txn"], out["ranks"]["barrier"]])
    e_src = torch.cat([edges[k][0] for k in EDGE_FAMILIES])
    e_dst = torch.cat([edges[k][1] for k in EDGE_FAMILIES])
    pc_nodes, pc_starts, pc_mask = out["chains"]["process"]
    bc_nodes, bc_starts, bc_mask = out["chains"]["barrier"]
    conv_all, overflow, cyc_bits = projection_scan(
        2 * T, max_k, max_rounds, rank, e_src, e_dst,
        [edges[k][2] for k in EDGE_FAMILIES],
        proj_include_stack(PROJECTIONS).tolist(),
        torch.cat([pc_nodes, bc_nodes]), torch.cat([pc_starts, bc_starts]),
        [pc_mask, bc_mask], chain_include_stack(PROJECTIONS).tolist())
    counts = torch.stack([out["counts"][n].to(torch.int32)
                          for n in COUNT_NAMES])
    tail = torch.tensor(cyc_bits + [int(conv_all)], dtype=torch.int32,
                        device=dev)
    return (torch.cat([counts, tail]),
            torch.tensor(overflow, dtype=torch.int32, device=dev))


def core_check(h: PaddedLA, n_keys: int, max_k: int = 128,
               max_rounds: int = 64, device: backend.DeviceLike = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (bits, overflowed) on `device` (the CUDA card unless the
    caller names the CPU):
    bits: (13,) int32 — counts/flags per the module docstring, last slot is
    converged (1 = trustworthy).
    overflowed: int32 — max backward edges seen beyond max_k (0 = exact).
    """
    h = to_device(h, backend.resolve(device))
    return _verdict(infer(h, n_keys), max_k, max_rounds)


core_check_auto = core_check
core_check_staged = core_check


def grow_until_exact(run: Callable[[int, int], tuple], max_k: int = 128,
                     max_rounds: int = 64, round_to: int = 1, deadline=None,
                     site: str = "elle.core-check", plan=None, policy=None):
    """Host-side rebatch policy.  `run(max_k, max_rounds)` -> (bits,
    overflowed).  If the sweep overflows its backward-edge budget, retry
    with the budget grown past the observed count (rounded up to a
    multiple of `round_to`); if the fixpoint hits max_rounds, retry with
    doubled rounds.  Gives up (returning the last, inexact result) only at
    the caps.

    `deadline` (a `resilience.Deadline`) is polled before each try: the
    grow loop is the unbounded part of the check, and expiry raises
    `DeadlineExceeded`.  Each try runs `run` through the resilience guard
    at `site` with `plan` and `policy`, so transient device failures
    retry and a fault plan fires there.  Callers must not wrap `run` in a
    second `device_call`: nested guards multiply retries and advance the
    plan's call counter twice, which breaks its deterministic replay."""
    while True:
        if deadline is not None:
            deadline.check("elle.grow-until-exact")
        bits, over = resilience.device_call(
            site, run, max_k, max_rounds, deadline=deadline, plan=plan,
            policy=policy)
        over_i = int(over)
        conv = int(bits[-1]) == 1
        if over_i > 0 and max_k < MAX_K_CAP:
            need = max_k + over_i
            while max_k < need:
                max_k *= 2
            max_k = min(max_k, MAX_K_CAP)
            if max_k % round_to:
                max_k = ((max_k // round_to) + 1) * round_to
            continue
        if not conv and over_i == 0 and max_rounds < MAX_ROUNDS_CAP:
            max_rounds = min(max_rounds * 2, MAX_ROUNDS_CAP)
            continue
        return bits, over


def core_check_exact(h: PaddedLA, n_keys: int, max_k: int = 128,
                     max_rounds: int = 64, deadline=None,
                     device: backend.DeviceLike = None):
    """core_check with host-side rebatching until exact.  Returns
    (bits, overflowed) like core_check; exact iff bits[-1] == 1 and
    overflowed == 0.  `deadline` bounds the grow loop (see
    `grow_until_exact`).  Inference does not depend on the budget, so it
    runs once and only the sweep is retried; each try runs under the
    site ``elle.core-check``, the JAX package's site for its fused check,
    so a fault plan fires at the same call in both packages."""
    out = infer(to_device(h, backend.resolve(device)), n_keys)
    return grow_until_exact(lambda k, r: _verdict(out, k, r), max_k,
                            max_rounds, deadline=deadline)
