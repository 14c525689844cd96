"""Kafka anomaly taxonomy as whole-history vectorized reductions (the
port's copy of `jepsen_tpu/checkers/queue/kafka.py`).

Every pass `workloads.kafka.KafkaChecker` runs as a python scan over
(send, poll) tuples becomes an array reduction over the
:class:`~jepsen_tpu.checkers.queue.packed.PackedKafka` columns —
adjacency compares over pack-time sorted orders, searchsorted
membership against the per-key offset ladder, and one segment
reduction (the stale-group run lengths):

- **lost-write** — send rows below their key's max polled offset whose
  ``key*off_base+off`` code is absent from the unique polled table;
- **duplicate** — adjacent same-``(key, value)`` rows in the unique
  polled ``(key, value, offset)`` table (two offsets for one value);
- **inconsistent-offsets** — adjacent same-``(key, offset)`` rows in
  the unique observed ``(key, offset, value)`` table;
- **nonmonotonic-poll / poll-skip** — adjacent batch rows in
  ``(process, key, seq)`` order, gated on equal assignment epochs (the
  pack-time ``(reassign-bisect, rebalance-generation)`` code), with
  the skip's "an offset in between was actually polled" test a
  searchsorted interval count;
- **int-nonmonotonic-poll / int-poll-skip** — the same on adjacent
  message rows within one batch;
- **nonmonotonic-send / int-send-skip** — adjacent send rows in
  ``(process, key, seq)`` / ``(op, key, seq)`` order;
- **precommitted-read** — message rows observed at an op index before
  their value's send was invoked;
- **stale-consumer-group** — ≥3 subscribe-mode batches of one
  ``(key, generation)`` re-reading the same start offset while the
  key's log extends past them: the group's committed offset stopped
  advancing (run detection over the ``(key, gen, start)`` sort, run
  lengths via one bincount);
- **unseen** — informational, as in the host scan.

The device path runs the one reduction, :func:`_math`, as torch ops on
the entry point's device (the CUDA card unless the caller names the CPU)
behind ``resilience.with_fallback(site="queue.check")``; the host path is
the SAME text of the arithmetic over numpy (:func:`host_verdict` — the
oracle twin the device path is differentially pinned against, while
`KafkaChecker` itself stays the independent scan twin).  `_math` takes
its array namespace as `xp`: ``np`` on the host, a small adapter
(:class:`_TorchXP`) holding only the torch calls it uses on the device.
Verdict-for-verdict parity with the scan and dict-for-dict parity with
the JAX package are pinned by tests/test_torch_queue.py.

Not ported, on purpose:

- the jit kernel (`_kernel`): JAX runs `_math` under `jax.jit` as plain
  XLA ops, with no Pallas kernel, so the port runs it as plain torch ops;
- the bucket padding (`_pad_to`, `_pad_perm`, `_padded_cols`): the JAX
  package pads every column to a power of two only so that
  `compilecache.bucket` can share one executable between nearby history
  sizes.  The port has no compile cache, so each column goes to the card
  at its own length.

Changed on purpose: the JAX package runs without x64 and sends a history
whose codes reach `packed.SENTINEL` (2^30) to the host
(`PackedKafka.device_safe`).  The port runs every non-empty history on
the card in int64; with no padding no sentinel row enters `u_comp`, so
no code can collide with one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import backend, telemetry
from jepsen_tpu_torch.checkers import api as checker_api
from jepsen_tpu_torch.checkers.queue import packed as packed_mod
from jepsen_tpu_torch.checkers.queue.packed import PackedKafka

SITE = "queue.check"

#: anomaly keys, the host scan's names (KafkaChecker) + stale-group
ANOMALIES = ("lost-write", "duplicate", "inconsistent-offsets",
             "nonmonotonic-poll", "poll-skip", "int-nonmonotonic-poll",
             "int-poll-skip", "nonmonotonic-send", "int-send-skip",
             "precommitted-read", "stale-consumer-group")

#: minimum same-start batches before a frozen committed offset counts
#: as a stale consumer group (1–2 re-reads happen benignly around
#: rebalances; 3 with the log moving on do not)
STALE_MIN_POLLS = 3


class _TorchXP:
    """The array namespace `_math` reads, over torch tensors on `device`:
    only the calls `_math` and `fifo._math` make, with numpy's names and
    argument shapes."""

    int64 = torch.int64

    def __init__(self, device: torch.device):
        self.device = device

    def _dtype(self, dtype):
        return torch.bool if dtype is bool else dtype

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=self._dtype(dtype),
                           device=self.device)

    def ones(self, shape, dtype):
        return torch.ones(shape, dtype=self._dtype(dtype),
                          device=self.device)

    def full(self, shape, value, dtype):
        return torch.full((shape,) if isinstance(shape, int) else shape,
                          value, dtype=self._dtype(dtype),
                          device=self.device)

    concatenate = staticmethod(torch.cat)
    searchsorted = staticmethod(torch.searchsorted)
    clip = staticmethod(torch.clamp)
    where = staticmethod(torch.where)

    @staticmethod
    def cumsum(x):
        return torch.cumsum(x, 0)


def _i64(xp, x):
    """`x` as int64 (numpy's ``astype``, torch's ``to``)."""
    return x.astype(np.int64) if xp is np else x.to(torch.int64)


def _bincount(xp, x, n: int, weights=None):
    """numpy's ``bincount(minlength=n)``: float64 counts with int64
    weights on both paths, where the JAX call keeps the weights' int32.
    Only ``> 0`` of a weighted count is read, so the three agree."""
    if xp is np:
        return np.bincount(x, weights=weights, minlength=n)
    return torch.bincount(x, weights=weights, minlength=n)


def _later(xp, pair, n: int):
    """Lift a length-``n-1`` adjacent-pair mask to length ``n``,
    marking the LATER row of each flagged pair."""
    if n == 0:
        return xp.zeros(0, bool)
    return xp.concatenate([xp.zeros(1, bool), pair])


def _both(xp, pair, n: int):
    """Lift a pair mask to length ``n`` marking BOTH rows (group
    membership: every row adjacent to a same-group neighbour)."""
    if n == 0:
        return xp.zeros(0, bool)
    z = xp.zeros(1, bool)
    return xp.concatenate([pair, z]) | xp.concatenate([z, pair])


def _math(xp, off_base: int,
          s_key, s_off, s_op, s_proc,
          b_key, b_proc, b_start, b_last, b_ep, b_gen,
          m_batch, m_key, m_off, m_op, m_sendinv,
          u_comp, polled_max, key_max,
          dv_key, dv_val, av_key, av_off,
          s_by_pk, s_by_ok, b_by_pk, b_by_kg):
    """The one reduction both paths implement.  Returns the 13 masks of
    :data:`MASKS` (rows with ``key == -1`` never flag; the port pads no
    column, but the arithmetic keeps the JAX validity tests).  `xp` is
    ``np`` or a :class:`_TorchXP`."""
    S, B, M = s_key.shape[0], b_key.shape[0], m_key.shape[0]

    def member(codes):
        if u_comp.shape[0] == 0:
            return xp.zeros(codes.shape, bool)
        idx = xp.clip(xp.searchsorted(u_comp, codes),
                      0, u_comp.shape[0] - 1)
        return u_comp[idx] == codes

    def polled_between(keys, lo, hi):
        """Any polled offset o of `keys` with lo < o < hi?"""
        if u_comp.shape[0] == 0:
            return xp.zeros(keys.shape, bool)
        base = keys * off_base
        return (xp.searchsorted(u_comp, base + hi)
                > xp.searchsorted(u_comp, base + lo + 1))

    # ---- send rows: lost / unseen -----------------------------------
    s_ok = s_key >= 0
    ks = xp.where(s_ok, s_key, 0)
    seen = member(xp.where(s_ok, s_key * off_base + s_off, -1))
    pm = polled_max[ks]
    lost = s_ok & (pm >= 0) & (s_off < pm) & ~seen
    unseen = s_ok & ~seen

    # ---- sends by (proc, key): nonmonotonic-send --------------------
    k = s_key[s_by_pk]
    p = s_proc[s_by_pk]
    o = s_off[s_by_pk]
    pair = (k[1:] == k[:-1]) & (p[1:] == p[:-1]) & (k[1:] >= 0) \
        & (k[:-1] >= 0)
    nm_send = _later(xp, pair & (o[1:] <= o[:-1]), S)

    # ---- sends by (op, key): int-send-skip --------------------------
    k = s_key[s_by_ok]
    i = s_op[s_by_ok]
    o = s_off[s_by_ok]
    pair = (k[1:] == k[:-1]) & (i[1:] == i[:-1]) & (k[1:] >= 0) \
        & (i[1:] >= 0)
    sk_send = _later(xp, pair & (o[1:] != o[:-1] + 1), S)

    # ---- batches by (proc, key): cross-poll order, epoch-gated ------
    k = b_key[b_by_pk]
    p = b_proc[b_by_pk]
    e = b_ep[b_by_pk]
    st = b_start[b_by_pk]
    la = b_last[b_by_pk]
    pair = (k[1:] == k[:-1]) & (p[1:] == p[:-1]) & (k[1:] >= 0) \
        & (k[:-1] >= 0) & (e[1:] == e[:-1])
    nm_poll = _later(xp, pair & (st[1:] <= la[:-1]), B)
    gap = pair & (st[1:] > la[:-1] + 1)
    skip_poll = _later(
        xp, gap & polled_between(k[1:], la[:-1], st[1:]), B)

    # ---- messages within one batch: int order -----------------------
    mb = (m_batch[1:] == m_batch[:-1]) & (m_key[1:] >= 0) \
        & (m_key[:-1] >= 0)
    a, b = m_off[:-1], m_off[1:]
    inm = _later(xp, mb & (b <= a), M)
    iskip = _later(xp, mb & (b > a) & (b != a + 1)
                   & polled_between(m_key[1:], a, b), M)

    # ---- precommitted-read ------------------------------------------
    precommit = (m_key >= 0) & (m_sendinv >= 0) & (m_op < m_sendinv)

    # ---- duplicate: unique polled (key, value, offset) --------------
    pair = (dv_key[1:] == dv_key[:-1]) & (dv_val[1:] == dv_val[:-1]) \
        & (dv_key[1:] >= 0)
    dup = _both(xp, pair, dv_key.shape[0])

    # ---- inconsistent-offsets: unique (key, offset, value) ----------
    pair = (av_key[1:] == av_key[:-1]) & (av_off[1:] == av_off[:-1]) \
        & (av_key[1:] >= 0)
    incon = _both(xp, pair, av_key.shape[0])

    # ---- stale-consumer-group: (key, gen, start) runs ---------------
    k = b_key[b_by_kg]
    g = b_gen[b_by_kg]
    st = b_start[b_by_kg]
    la = b_last[b_by_kg]
    ok = (k >= 0) & (g >= 0)
    if B:
        diff = (k[1:] != k[:-1]) | (g[1:] != g[:-1]) \
            | (st[1:] != st[:-1]) | ~ok[1:] | ~ok[:-1]
        new_run = xp.concatenate([xp.ones(1, bool), diff])
        run_id = xp.cumsum(_i64(xp, new_run)) - 1
        run_len = _bincount(xp, run_id, B)[run_id]
        kk = xp.where(ok, k, 0)
        evid = ok & (key_max[kk] > la)
        evid_n = _bincount(xp, run_id, B,
                           weights=_i64(xp, evid))[run_id]
        in_group = ok & (run_len >= STALE_MIN_POLLS) & (evid_n > 0)
        stale, stale_evid = in_group, in_group & evid
    else:
        stale = stale_evid = xp.zeros(0, bool)

    return (lost, unseen, nm_send, sk_send, nm_poll, skip_poll,
            inm, iskip, precommit, dup, incon, stale, stale_evid)


#: kernel output order; pair masks are in their sort-order coordinates
MASKS = ("lost", "unseen", "nm_send", "sk_send", "nm_poll",
         "skip_poll", "inm", "iskip", "precommit", "dup", "incon",
         "stale", "stale_evid")

def _cols(pk: PackedKafka) -> Tuple[np.ndarray, ...]:
    return (pk.s_key, pk.s_off, pk.s_op, pk.s_proc,
            pk.b_key, pk.b_proc, pk.b_start, pk.b_last, pk.b_ep,
            pk.b_gen,
            pk.m_batch, pk.m_key, pk.m_off, pk.m_op, pk.m_sendinv,
            pk.u_comp, pk.polled_max, pk.key_max,
            pk.dv_key, pk.dv_val, pk.av_key, pk.av_off,
            pk.s_by_pk, pk.s_by_ok, pk.b_by_pk, pk.b_by_kg)


def _reduce_host(pk: PackedKafka):
    return _math(np, pk.off_base, *_cols(pk))


def _reduce_device(pk: PackedKafka, dev: torch.device):
    """`_reduce_host` on `dev`: the 26 columns go over as int64 at their
    own lengths, `_math` runs as torch ops there, and the 13 masks come
    back as numpy bool arrays."""
    cols = [torch.from_numpy(np.ascontiguousarray(c, np.int64)).to(dev)
            for c in _cols(pk)]
    out = _math(_TorchXP(dev), pk.off_base, *cols)
    return tuple(m.cpu().numpy() for m in out)


def host_verdict(pk: PackedKafka,
                 max_reported: int = 16) -> Dict[str, Any]:
    """The exact host oracle twin — numpy only, no tensors."""
    return _render(pk, _reduce_host(pk), max_reported)


def _render(pk: PackedKafka, masks, max_reported: int) -> Dict[str, Any]:
    """Map mask indices back through the id tables into the host
    scan's exact entry shapes and iteration order (KafkaChecker —
    entry-for-entry equality is what the differential tests pin)."""
    m = dict(zip(MASKS, masks))
    K, V, P = pk.keys, pk.values, pk.procs

    lost = sorted({(K[pk.s_key[i]], int(pk.s_off[i]), V[pk.s_val[i]])
                   for i in np.nonzero(m["lost"])[0]})

    unseen: Dict[Any, int] = {}
    for i in np.nonzero(m["unseen"])[0]:
        kk = K[pk.s_key[i]]
        unseen[kk] = unseen.get(kk, 0) + 1

    by_kv: Dict[Tuple[Any, Any], List[int]] = {}
    for j in np.nonzero(m["dup"])[0]:
        by_kv.setdefault((K[pk.dv_key[j]], V[pk.dv_val[j]]),
                         []).append(int(pk.dv_off[j]))
    duplicates = sorted((k, v, sorted(offs))
                        for (k, v), offs in by_kv.items())

    by_ko: Dict[Tuple[Any, int], List[Any]] = {}
    for j in np.nonzero(m["incon"])[0]:
        by_ko.setdefault((K[pk.av_key[j]], int(pk.av_off[j])),
                         []).append(V[pk.av_val[j]])
    inconsistent = sorted((k, off, sorted(vs, key=repr))
                          for (k, off), vs in by_ko.items())

    def batch_pairs(mask, perm, shape):
        out = []
        for j in np.nonzero(mask)[0]:
            cur, prv = int(perm[j]), int(perm[j - 1])
            out.append((cur, shape(cur, prv)))
        return [e for _, e in sorted(out, key=lambda t: t[0])]

    nonmonotonic = batch_pairs(
        m["nm_poll"], pk.b_by_pk,
        lambda cur, prv: {"process": P[pk.b_proc[cur]],
                          "key": K[pk.b_key[cur]],
                          "prev": int(pk.b_last[prv]),
                          "next": int(pk.b_start[cur]),
                          "op-index": int(pk.b_op[cur])})
    skipped = batch_pairs(
        m["skip_poll"], pk.b_by_pk,
        lambda cur, prv: {"key": K[pk.b_key[cur]],
                          "from": int(pk.b_last[prv]),
                          "to": int(pk.b_start[cur]),
                          "process": P[pk.b_proc[cur]],
                          "op-index": int(pk.b_op[cur])})
    int_nonmono = [{"key": K[pk.m_key[j]],
                    "prev": int(pk.m_off[j - 1]),
                    "next": int(pk.m_off[j]),
                    "op-index": int(pk.m_op[j])}
                   for j in np.nonzero(m["inm"])[0]]
    int_skipped = [{"key": K[pk.m_key[j]],
                    "from": int(pk.m_off[j - 1]),
                    "to": int(pk.m_off[j]),
                    "op-index": int(pk.m_op[j])}
                   for j in np.nonzero(m["iskip"])[0]]
    nonmono_send = batch_pairs(
        m["nm_send"], pk.s_by_pk,
        lambda cur, prv: {"process": P[pk.s_proc[cur]],
                          "key": K[pk.s_key[cur]],
                          "prev": int(pk.s_off[prv]),
                          "next": int(pk.s_off[cur]),
                          "op-index": int(pk.s_op[cur])})
    int_send_skip = batch_pairs(
        m["sk_send"], pk.s_by_ok,
        lambda cur, prv: {"key": K[pk.s_key[cur]],
                          "from": int(pk.s_off[prv]),
                          "to": int(pk.s_off[cur]),
                          "op-index": int(pk.s_op[cur])})
    precommitted = [{"key": K[pk.m_key[j]], "value": V[pk.m_val[j]],
                     "poll-op": int(pk.m_op[j]),
                     "send-op": int(pk.m_sendinv[j])}
                    for j in np.nonzero(m["precommit"])[0]]

    groups: Dict[Tuple[Any, int, int], List[bool]] = {}
    for j in np.nonzero(m["stale"])[0]:
        row = int(pk.b_by_kg[j])
        g = (K[pk.b_key[row]], int(pk.b_gen[row]),
             int(pk.b_start[row]))
        groups.setdefault(g, []).append(bool(m["stale_evid"][j]))
    stale = [{"key": k, "generation": gen, "start": start,
              "polls": len(evs), "behind": sum(evs)}
             for (k, gen, start), evs in groups.items()]
    stale.sort(key=lambda e: (repr(e["key"]), e["generation"],
                              e["start"]))

    anomalies = {
        "lost-write": lost[:max_reported],
        "duplicate": duplicates[:max_reported],
        "inconsistent-offsets": inconsistent[:max_reported],
        "nonmonotonic-poll": nonmonotonic[:max_reported],
        "poll-skip": skipped[:max_reported],
        "int-nonmonotonic-poll": int_nonmono[:max_reported],
        "int-poll-skip": int_skipped[:max_reported],
        "nonmonotonic-send": nonmono_send[:max_reported],
        "int-send-skip": int_send_skip[:max_reported],
        "precommitted-read": precommitted[:max_reported],
        "stale-consumer-group": stale[:max_reported],
    }
    found = {k: v for k, v in anomalies.items() if v}
    out = {
        "valid?": not found,
        "anomaly-types": sorted(found),
        "anomalies": found,
        "send-count": pk.n_sends,
        "poll-count": pk.n_polls,
    }
    if unseen:
        out["unseen"] = dict(
            sorted(unseen.items(), key=repr)[:max_reported])
    for name, entries in found.items():
        telemetry.registry().counter(
            "queue-anomalies-found", anomaly=name).inc(len(entries))
    return out


def check(history, test: Optional[dict] = None, *,
          use_device: bool = True, max_reported: int = 16,
          deadline=None, plan=None, policy=None,
          device: backend.DeviceLike = None) -> Dict[str, Any]:
    """Check a kafka history.  Accepts a History / op list / PackedKafka
    / HistoryIR.

    The device path runs on `device` (the CUDA card unless the caller
    names the CPU; no card raises `backend.NoDeviceError`), guarded,
    retried and deadline-polled, for every non-empty history: the port
    does not read `device_safe` (module docstring).  Only a synthetic
    fault of `plan` degrades to the host twin, with the standard stamp;
    every other device error is raised.  ``use_device=False`` IS the
    host twin.  `test` is accepted for the JAX signature and not read
    (the JAX package resolves a fault plan from it)."""
    from jepsen_tpu_torch import resilience
    from jepsen_tpu_torch.history.ir import HistoryIR

    dev = backend.resolve(device) if use_device else None
    ph = telemetry.phases()
    pk = history if isinstance(history, PackedKafka) else None
    if pk is None:
        ph.start("queue.pack", device=False)
        pk = (history.queue("kafka")
              if isinstance(history, HistoryIR)
              else packed_mod.pack_kafka(history))
    if pk.empty:
        ph.end()
        return {"valid?": "unknown"}
    if deadline is not None:
        deadline.check(SITE)
    if not use_device:
        ph.start("queue.check", device=False,
                 sends=pk.n_sends, polls=pk.n_polls)
        res = host_verdict(pk, max_reported)
        ph.end()
        return res
    ph.start("queue.check", device=True,
             sends=pk.n_sends, polls=pk.n_polls)
    try:
        masks, degraded = resilience.with_fallback(
            SITE,
            lambda: _reduce_device(pk, dev),
            lambda: _reduce_host(pk),
            deadline=deadline, plan=plan, policy=policy)
    except resilience.DeadlineExceeded:
        ph.end()
        return resilience.deadline_result(checker="kafka")
    res = _render(pk, masks, max_reported)
    if degraded:
        res["degraded"] = degraded
    ph.end()
    return res


class PackedKafkaChecker(checker_api.Checker):
    """The canonical kafka checker: packed anomaly passes on the
    HistoryIR, device path + host twin, `KafkaChecker` scan parity
    pinned differentially."""

    def name(self) -> str:
        return "kafka"

    def __init__(self, *, device: backend.DeviceLike = None):
        self.device = device

    def check(self, test, history, opts=None):
        return check(history, test,
                     deadline=(opts or {}).get("deadline"),
                     device=self.device)
