"""`shrink(run_dir)` — automated anomaly triage for invalid runs (the
port's copy of `jepsen_tpu/minimize/core.py`).

The orchestrator: load a stored run whose checker said ``valid?
false``, establish the target anomaly signature with one baseline
re-check, delta-debug the history down through the three structural
phases (:mod:`~.reduce`), re-checking candidates in parallel through
the campaign scheduler (:mod:`~.probe`), and persist the minimal
failing witness plus its explained cycle (:mod:`~.witness`).

Telemetry: one ``shrink`` root span, one ``shrink.round`` child per
probe round carrying phase, candidates tried, ops remaining after the
round, and probe p50/p95 — a telemetric shrink's full reduction history
reads straight out of ``telemetry-shrink.json`` / Perfetto.

Determinism: candidate generation, canonical-order selection among
failing candidates, and the checkers themselves are all deterministic,
so the same stored run shrinks to the identical witness on every
machine — and the witness's *source digest* makes the second shrink of
an unchanged run a pure cache hit (0 probes).

Devices: the checker runs on the card unless `device` (or the stored
test map's ``"cpu"``) names the CPU.  A baseline, probe or confirm
whose error names `KernelError` or `NoDeviceError` raises out of
`shrink` (`probe.raise_device_error`): with no card and no CPU asked
for, a shrink fails loudly instead of ending unshrunk.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional, Union

from jepsen_tpu_torch import store, telemetry
from jepsen_tpu_torch.backend import DeviceLike
from jepsen_tpu_torch.history.ops import History

from jepsen_tpu_torch.minimize import probe as probe_mod
from jepsen_tpu_torch.minimize import reduce as reduce_mod
from jepsen_tpu_torch.minimize import witness as witness_mod

logger = logging.getLogger("jepsen.minimize")

__all__ = ["shrink"]


def _load(run_or_dir: Union[str, dict]) -> tuple:
    """(test map, materialized History, run dir)."""
    if isinstance(run_or_dir, str):
        test = store.load(run_or_dir)
        run_dir = os.path.realpath(run_or_dir)
    else:
        test = run_or_dir
        run_dir = store.test_dir(test)
    hist = test.get("history")
    if hist is None:
        raise ValueError(f"run {run_dir} has no stored history")
    if not isinstance(hist, History):
        hist = hist.materialize()
        test["history"] = hist
    return test, hist, run_dir


def shrink(run_or_dir: Union[str, dict], *,
           checker=None,
           rounds: Optional[int] = None,
           probe_deadline_s: Optional[float] = None,
           workers: int = 2,
           device_slots: int = 1,
           host_oracle: bool = False,
           anomalies: Optional[Any] = None,
           force: bool = False,
           device: DeviceLike = None) -> Dict[str, Any]:
    """Shrink a stored invalid run to a minimal failing witness.

    Accepts a store run directory or a loaded test map (with a live
    ``"checker"``).  Knobs: `rounds` caps the total probe rounds
    (None = run to 1-minimality), `probe_deadline_s` bounds each
    candidate re-check, `workers`/`device_slots` size the probe pool
    (device-pipeline probes serialize through the slots),
    `host_oracle` probes through the exact host reference checker
    where one exists (shrink candidates are many and small — the
    anti-amortization shape for the device path's per-call padding and
    launches), `anomalies`
    pins the target to a subset of the baseline's anomaly types (by
    default ANY of them keeps a candidate, so ddmin gravitates to the
    cheapest-to-witness class).  `force` ignores a cached witness.
    `device` is where a resolved checker runs
    (`probe.resolve_checker`: the card unless it, or the test map's
    ``"cpu"``, names the CPU); a `checker` passed in carries its own.

    Returns the summary dict (also the shape of ``witness.json``):
    ``{"valid?", "ops", "source-ops", "digest", "source-digest",
    "anomaly-types", "anomalies", "rounds", "probes", "cached",
    "paths", ...}``.  A run that is not invalid returns
    ``{"error": "not-invalid", ...}`` without probing further.
    """
    test, hist, run_dir = _load(run_or_dir)
    source_digest = witness_mod.history_digest(hist)
    wanted = {str(a) for a in ([anomalies] if isinstance(anomalies, str)
                               else anomalies or ())}

    if not force:
        cached = witness_mod.load_witness(run_dir)
        if cached is not None and cached.get("source-digest") == \
                source_digest and cached.get("valid?") is False and (
                    not wanted or wanted & set(
                        cached.get("anomaly-types") or ())):
            # a cache hit requires a witness that (a) matches the
            # current history, (b) actually REPRODUCES (a confirm pass
            # that expired/flaked must not be pinned forever), and
            # (c) exhibits one of the requested --anomaly types;
            # anything else falls through and re-shrinks
            logger.info("shrink %s: witness cached (digest %s), no-op",
                        run_dir, cached.get("digest"))
            cached.update({"cached": True, "probes": 0, "rounds": 0,
                           "paths": witness_mod.witness_paths(run_dir)})
            return cached

    chk = checker if checker is not None \
        else probe_mod.resolve_checker(test, hist, device)
    # the probe checker may be the cheap host twin, but the final
    # confirmation re-check always runs the ORIGINAL checker: only the
    # device pipeline attaches the Explainer's per-edge justifications
    # (explain.py), and the persisted witness must carry them
    confirm_chk = chk
    device = None
    if host_oracle:
        host = probe_mod.host_equivalent(chk)
        if host is not None:
            chk, device = host, False

    own_tel = None
    recorder = None
    tel = telemetry.active()
    if not tel.enabled and telemetry.wanted_for(test):
        own_tel = tel = telemetry.activate()
        # flight-record the shrink session itself (events-shrink.jsonl
        # so the original run's stream is never appended to): round /
        # probe progress is followable live via `cli tail`
        try:
            recorder = telemetry.attach_stream(
                own_tel, run_dir, meta={"name": test.get("name"),
                                        "shrink": True},
                filename=telemetry.stream.SHRINK_EVENTS_FILE)
        except Exception as e:  # noqa: BLE001 — never fail a shrink
            logger.warning("shrink flight recorder unavailable: %s", e)
    try:
        summary = _shrink_run(test, hist, run_dir, chk, confirm_chk,
                              tel, source_digest, rounds,
                              probe_deadline_s, workers, device_slots,
                              device, anomalies)
    finally:
        if recorder is not None:
            recorder.close()
        if own_tel is not None:
            telemetry.deactivate(own_tel)
            try:
                telemetry.write_run(run_dir, own_tel,
                                    meta={"name": test.get("name"),
                                          "shrink": True},
                                    suffix="-shrink")
            except Exception as e:  # noqa: BLE001 — never fail a shrink
                logger.warning("shrink telemetry export failed: %s", e)
    return summary


def _shrink_run(test, hist, run_dir, chk, confirm_chk, tel,
                source_digest, rounds, probe_deadline_s, workers,
                device_slots, device=None, anomalies=None
                ) -> Dict[str, Any]:
    t0 = time.monotonic()
    with tel.span("shrink", ops=len(hist), dir=run_dir) as root:
        pool = probe_mod.ProbePool(
            test, chk, probe_deadline_s=probe_deadline_s,
            workers=workers, device_slots=device_slots, device=device)

        # baseline: confirm the full history reproduces and pin the
        # target anomaly signature (also builds the kernels, so the
        # candidate probes find them loaded).
        # UNBOUNDED: the per-probe deadline is sized for small ddmin
        # candidates; the full-history re-check needs the original
        # run's budget or every big invalid run would be refused
        with tel.span("shrink.baseline") as bsp:
            base = pool.check_history(hist, bounded=False)
            bsp.set_attr(valid=base.get("valid?"))
        if base.get("valid?") is not False:
            root.set_attr(outcome="not-invalid")
            logger.warning("shrink %s: baseline re-check is %r, nothing "
                           "to shrink", run_dir, base.get("valid?"))
            return {"valid?": base.get("valid?"), "error": "not-invalid",
                    "checker": probe_mod._name(chk),
                    "source-digest": source_digest, "probes": 1}
        target = sorted(base.get("anomaly-types") or ())
        if anomalies:
            wanted = {str(a) for a in ([anomalies] if isinstance(
                anomalies, str) else anomalies)}
            hit = sorted(set(target) & wanted)
            if not hit:
                root.set_attr(outcome="target-absent")
                return {"valid?": False, "error": "target-absent",
                        "anomaly-types": target, "requested": sorted(
                            wanted), "source-digest": source_digest,
                        "probes": 1}
            target = hit
        pool.target = frozenset(target)
        root.set_attr(target=target)

        # the reduction: per-round spans carry phase/candidates, and
        # the _note callback back-fills ops-remaining + improvement
        # (span attrs stay writable until export)
        last_span = {}

        def probe_batch(phase: str, cands) -> list:
            with tel.span("shrink.round", phase=phase,
                          candidates=len(cands)) as sp:
                before = len(pool.durations_s)
                res = pool.probe_batch(phase, cands)
                lat = sorted(pool.durations_s[before:])
                if lat:
                    sp.set_attr(
                        probe_p50_s=probe_mod.quantile(lat, 0.50),
                        probe_p95_s=probe_mod.quantile(lat, 0.95))
                last_span["sp"] = sp
                return res

        def on_round(st: reduce_mod.RoundStats) -> None:
            sp = last_span.get("sp")
            if sp is not None:
                sp.set_attr(ops_remaining=st.ops_remaining,
                            improved=st.improved)
            # the span-close event has already streamed by the time
            # these attrs land, so round progress gets its own event
            telemetry.stream_event(
                "shrink-round", phase=st.phase, candidates=st.candidates,
                ops_remaining=st.ops_remaining, improved=st.improved)

        units = reduce_mod.units_of(hist)
        reducer = reduce_mod.Reducer(probe_batch=probe_batch,
                                     max_rounds=rounds,
                                     on_round=on_round)
        minimal = reducer.run(units)
        wit = reduce_mod.build_history(minimal)

        # final confirmation re-check through the ORIGINAL checker: the
        # full result — explained cycles included — goes into
        # witness.json verbatim (the witness is tiny, so one device
        # check is cheap even when probing ran on the host twin)
        confirm_pool = pool if confirm_chk is chk else \
            probe_mod.ProbePool(test, confirm_chk,
                                probe_deadline_s=probe_deadline_s)
        with tel.span("shrink.confirm", ops=len(wit),
                      checker=probe_mod._name(confirm_chk)):
            final = confirm_pool.check_history(wit, bounded=False)

        meta = {
            "source-digest": source_digest,
            "source-ops": len(hist),
            # the surviving fault-window set (nemesis-schedule ddmin):
            # every window still in the witness, with its op indices —
            # digest-stable at any worker count like the ops themselves
            "fault-windows": getattr(reducer, "windows_meta", []),
            "valid?": final.get("valid?"),
            "anomaly-types": sorted(final.get("anomaly-types") or ()),
            "target": target,
            "anomalies": final.get("anomalies") or {},
            "checker": probe_mod._name(confirm_chk),
            "probe-checker": probe_mod._name(chk),
            "rounds": reducer.rounds,
            "probes": pool.n_probes + 2,  # + baseline + confirm
            "phases": [{"phase": s.phase, "candidates": s.candidates,
                        "ops-remaining": s.ops_remaining,
                        "improved": s.improved}
                       for s in reducer.history],
            "wall_s": round(time.monotonic() - t0, 3),
            **pool.latency_quantiles(),
        }
        paths = witness_mod.save_witness(run_dir, wit, meta)
        root.set_attr(witness_ops=len(wit), rounds=reducer.rounds,
                      probes=meta["probes"])
        logger.info("shrink %s: %d ops -> %d ops in %d rounds "
                    "(%d probes, %.1fs); anomalies %s", run_dir,
                    len(hist), len(wit), reducer.rounds, meta["probes"],
                    meta["wall_s"], meta["anomaly-types"])
        return {**meta, "digest": witness_mod.history_digest(wit),
                "ops": len(wit), "cached": False, "paths": paths,
                "witness-history": wit}
