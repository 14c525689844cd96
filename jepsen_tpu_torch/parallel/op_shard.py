"""One history checked with its sweep sharded over a mesh (the port's
copy of `jepsen_tpu/parallel/op_shard.py`, BASELINE config 4).

The cycle sweep is split over the *backward-edge axis* K: each shard of
the mesh owns K / n of the backward edges and propagates only their
(N, K / n) label planes, on its own device.  Columns are independent, so
the only coupling between shards is the (K, K) meta graph: the shards'
meta rows are gathered on the mesh's first device
(`mesh.all_gather_rows`, the JAX ``all_gather``), closed there once, and
the convergence flags combined (`mesh.psum`, the JAX ``psum``).  The bits
are those of the single-device `core_check`.

One thing differs from the JAX module.  It hands `infer` its inputs
sharded along the op/mop axes, and GSPMD partitions inference; the port
runs `infer` once, on the mesh's first device, and copies its rank, edge
and chain tensors to each distinct device of the mesh, once per device.
So a row's ``"inference-sharded"`` is always False here, where the JAX
row says True wherever a leading dimension divides the mesh.

The JAX module's `projection_sweep_bits` (the projection scan with a
sweep callable) is `device_core._verdict(out, ..., devices=)` here: the
scan hands its device list to every projection's `_sweep_window`.
`device_core.core_check_auto`, `core_check_exact` and
`list_append.check` take this path when `parallel.slots.default_mesh`
resolves a mesh; `check_sharded` is the explicit entry point.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from jepsen_tpu_torch.checkers.elle.device_core import (
    COUNT_NAMES,
    _verdict,
    grow_until_exact,
)
from jepsen_tpu_torch.checkers.elle.device_infer import (
    PaddedLA,
    infer,
    pad_packed,
    to_device,
)
from jepsen_tpu_torch.history.soa import PackedTxns
from jepsen_tpu_torch.ops.cycle_sweep import replica_placer, shard_budget
from jepsen_tpu_torch.parallel.mesh import Mesh


def _axis_devices(mesh: Mesh, axis: str):
    """The devices of a 1-D mesh along `axis`, in order."""
    assert mesh.axis_names == (axis,), (mesh.axis_names, axis)
    return list(mesh.devices)


def _core_check_sharded(h: PaddedLA, n_keys: int, mesh: Mesh, axis: str,
                        max_k: int = 128, max_rounds: int = 64):
    """core_check with the sweep's backward-edge axis sharded over the
    mesh: `infer` on the mesh's first device, then each shard sweeps its
    window of every projection (`device_core._verdict`).  Same bit
    layout, and the same bits, as `device_core.core_check`."""
    devices = _axis_devices(mesh, axis)
    out = infer(to_device(h, devices[0]), n_keys)
    return _verdict(out, max_k, max_rounds, devices=devices)


def exact_sharded(h: PaddedLA, n_keys: int, mesh: Mesh, axis: str,
                  max_k: int = 128, max_rounds: int = 64, deadline=None,
                  site: str = "elle.core-check", plan=None, policy=None):
    """`_core_check_sharded` grown until exact (`grow_until_exact` at
    `site`, the budget rounded up to, and grown in, multiples of the
    mesh's size).  Inference runs once; the tries share one
    `replica_placer`, so its tensors reach each device of the mesh
    once.  `check_sharded` and `core_check_exact`'s mesh branch."""
    devices = _axis_devices(mesh, axis)
    out = infer(to_device(h, devices[0]), n_keys)
    place = replica_placer()
    return grow_until_exact(
        lambda k, r: _verdict(out, k, r, devices=devices, place=place),
        shard_budget(max_k, len(devices)), max_rounds,
        round_to=len(devices), deadline=deadline, site=site, plan=plan,
        policy=policy)


def shard_padded(h: PaddedLA, mesh: Mesh, axis: str = "dp"
                 ) -> Tuple[PaddedLA, bool]:
    """(the padded history on the mesh's first device, False): the port
    runs inference on one device, so nothing is partitioned along the op
    axes (the JAX function places each divisible array sharded and
    returns whether any was)."""
    first = torch.device(mesh.devices.flat[0])
    return to_device(h, first), False


def check_sharded(p: PackedTxns | PaddedLA, mesh: Optional[Mesh] = None,
                  axis: str = "dp", max_k: int = 128,
                  max_rounds: int = 64, deadline=None, plan=None,
                  policy=None) -> dict:
    """Check ONE history sharded across the mesh (every visible card when
    `mesh` is None: `batch.make_mesh`); a summary dict like a
    `check_batch` row.  Grows the budget (like `core_check_exact`) when
    the sweep overflows, in multiples of the mesh's size.  `deadline`
    bounds the grow loop (expiry raises `DeadlineExceeded`); each sharded
    dispatch runs under ONE guard at the site ``parallel.op-shard``, so a
    fault plan reaches the K-axis sharded sweep too.

    ``"inference-sharded"`` is False: see the module docstring."""
    from jepsen_tpu_torch import telemetry
    from jepsen_tpu_torch.parallel.batch import _stage_bytes, make_mesh

    if mesh is None:
        mesh = make_mesh(axis=axis)
    n_shards = mesh.shape[axis]
    with telemetry.span("parallel.op-shard", shards=n_shards,
                        max_k=max_k) as sp:
        h = p if isinstance(p, PaddedLA) else pad_packed(p, device="cpu")
        n_keys = h.n_keys
        h, infer_sharded = shard_padded(h, mesh, axis)
        _stage_bytes(sp, h)
        sp.set_attr(inference_sharded=infer_sharded)
        bits, over = exact_sharded(
            h, n_keys, mesh, axis, max_k, max_rounds, deadline=deadline,
            site="parallel.op-shard", plan=plan, policy=policy)
        over_i = int(over)

    row = bits.cpu().tolist()
    counts = {n: int(row[j]) for j, n in enumerate(COUNT_NAMES)}
    cycles = [bool(x) for x in row[len(COUNT_NAMES):-1]]
    converged = bool(row[-1]) and over_i == 0
    invalid = any(v > 0 for v in counts.values()) or any(cycles)
    return {
        "valid?": (not invalid) if converged else "unknown",
        "counts": counts,
        "cycles": {
            "G0": cycles[0], "G1c": cycles[1], "G2-family": cycles[2],
            "G2-family-process": cycles[3],
            "G2-family-realtime": cycles[4],
        },
        "exact": converged,
        # always False in the port: inference runs on the first device
        "inference-sharded": infer_sharded,
    }
