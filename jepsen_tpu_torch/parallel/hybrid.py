"""Hybrid 2D checking: batch data parallelism x K-axis sweep sharding
(the port's copy of `jepsen_tpu/parallel/hybrid.py`).

The mesh has two axes:

  dcn — one block of the batch per row (across hosts in the JAX
        package's pod layout: the only traffic between rows is the
        final per-history bits)
  k   — the backward-edge windows of `parallel/op_shard.py` within a
        row (the meta rows gathered and the convergence flags combined
        within the row)

Each (dcn row, history) pair runs `infer` on the row's first device and
sweeps its label planes in the row's `k` windows, so a batch divides
both ways: histories across rows, label-plane memory across `k`.
`make_hybrid_mesh` reshapes a device list, as the JAX function reshapes
the local devices; devices may repeat (a (2, 2) mesh on one card).  The
verdicts are those of `batch.check_batch` without a mesh.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from jepsen_tpu_torch import resilience
from jepsen_tpu_torch.checkers.elle.device_core import _verdict
from jepsen_tpu_torch.checkers.elle.device_infer import infer, to_device
from jepsen_tpu_torch.history.soa import PackedTxns
from jepsen_tpu_torch.ops.cycle_sweep import replica_placer, shard_budget
from jepsen_tpu_torch.parallel import slots
from jepsen_tpu_torch.parallel.batch import (
    _row,
    batch_caps,
    pad_batch,
    summarize_batch_bits,
)
from jepsen_tpu_torch.parallel.mesh import Mesh, all_gather_rows


def make_hybrid_mesh(n_dcn: int, n_k: int, devices=None) -> Mesh:
    """A ("dcn", "k") mesh of the first n_dcn * n_k of `devices` (the
    card's visible devices when None), row-major."""
    if devices is None:
        devices = slots.all_devices(None)
    devs = np.empty(len(devices), dtype=object)
    devs[:] = [torch.device(d) for d in devices]
    assert devs.size >= n_dcn * n_k, (devs.size, n_dcn, n_k)
    return Mesh(devs[:n_dcn * n_k].reshape(n_dcn, n_k), ("dcn", "k"))


def _hybrid_core(batch, n_keys: int, mesh: Mesh, max_k: int = 128,
                 max_rounds: int = 64):
    """(bits (B, 13), overflows (B,)) of a stacked batch whose size the
    dcn axis divides: dcn row r takes the contiguous block r of B / n_dcn
    histories, each inferred on the row's first device and swept in the
    row's k windows; the rows' results are gathered on the mesh's first
    device in input order."""
    n_dcn = mesh.shape["dcn"]
    n_rows = batch.txn_type.shape[0]
    assert n_rows % n_dcn == 0, (n_rows, n_dcn)
    per = n_rows // n_dcn
    bits, over = [], []
    for r in range(n_dcn):
        row_devs = [torch.device(d) for d in mesh.devices[r]]
        place = replica_placer()
        for i in range(r * per, (r + 1) * per):
            out = infer(to_device(_row(batch, i), row_devs[0]), n_keys)
            b, o = _verdict(out, max_k, max_rounds, devices=row_devs,
                            place=place)
            bits.append(b[None])
            over.append(o[None])
    first = torch.device(mesh.devices.flat[0])
    return all_gather_rows(bits, first), all_gather_rows(over, first)


def check_batch_hybrid(ps: Sequence[PackedTxns], mesh: Mesh,
                       max_k: int = 128, max_rounds: int = 64,
                       deadline=None, plan=None, policy=None
                       ) -> List[dict]:
    """Check a batch of histories over a 2D ("dcn", "k") mesh; one
    summary dict per history (the `check_batch` row shape).

    The batch is padded to a multiple of the dcn axis with copies of the
    first history (dropped from the results), as in the JAX package.
    Inexact verdicts (overflow / non-convergence) are re-run alone
    through the exact single-device path rather than approximated.  The
    2D dispatch runs under ONE guard at the site ``parallel.hybrid``."""
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.parallel.batch import _stage_bytes

    n_dcn = mesh.shape["dcn"]
    n_k = mesh.shape["k"]
    max_k = shard_budget(max_k, n_k)

    caps = batch_caps(ps)
    n_real = len(ps)
    fill = (-n_real) % n_dcn
    with telemetry.span("parallel.hybrid", histories=n_real,
                        dcn=n_dcn, k=n_k, max_k=max_k) as sp:
        # padded on the host: each history goes straight to its row
        batch = pad_batch(list(ps) + [ps[0]] * fill, caps, device="cpu")
        _stage_bytes(sp, batch)
        bits, over = resilience.device_call(
            "parallel.hybrid",
            lambda: _hybrid_core(batch, batch.n_keys, mesh, max_k=max_k,
                                 max_rounds=max_rounds),
            deadline=deadline, plan=plan, policy=policy)
        return summarize_batch_bits(bits, over, batch, batch.n_keys,
                                    n_real, k_floor=max_k,
                                    device=mesh.devices.flat[0])
