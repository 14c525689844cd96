"""Store federation: run-dir artifact uploads (the port's copy of
`jepsen_tpu/fleet/artifacts.py`; the tar bytes of a run dir are the
JAX module's).

Fleet workers no longer need a shared store filesystem.  After
executing a cell a worker tars its run dir and streams it to the
coordinator's ``POST /fleet/artifact/<run-id>`` endpoint in
digest-verified, byte-offset-addressed chunks; the coordinator lands
the unpacked dir at the ordinary store location, so every downstream
surface (web run pages, warehouse ingest, `cli shrink`, witness diff)
works on a distributed campaign exactly as on a local one.

Crash discipline, mirroring the journal/ledger conventions:

- the staged upload lives under ``<store>/fleet/staging/`` (a subtree
  `store.tests` already skips) as ``<run-id>.tar`` + a sidecar meta
  json; the part file's SIZE is the resume cursor — a ``kill -9`` on
  either side mid-upload leaves a resumable partial, and the client
  probes (empty POST) for ``received`` and resends from there;
- chunks are idempotent: a resend below the received cursor is
  overlap-skipped, a gap is a 409 carrying the cursor (exactly the
  verifier journal's contract);
- landing is atomic: the tar is sha256-verified against the digest
  the client declared, unpacked into a dot-prefixed staging dir
  NEXT TO the final location (same filesystem), then ``os.replace``\\ d
  into place — a crash anywhere leaves either no run dir or a whole
  one, never a torn one (`store.tests` / the warehouse skip the
  dot-prefixed intermediates);
- re-uploading a landed run id acks ``{"landed": true, "already":
  true}`` — at-most-once landing keyed on the run dir path, so a
  zombie worker's late upload is harmless.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import tarfile
import threading
import time
from typing import Any, BinaryIO, Dict, Optional, Tuple

from jepsen_tpu_torch import store

logger = logging.getLogger("jepsen.fleet")

__all__ = ["ArtifactStore", "pack_run_dir", "pack_run_dir_file",
           "STAGING_DIR"]

STAGING_DIR = os.path.join("fleet", "staging")

#: refuse absurd uploads (a run dir is logs + json + telemetry)
MAX_ARTIFACT_BYTES = 512 * 1024 * 1024


def _registry():
    from jepsen_tpu_torch import telemetry

    return telemetry.registry()


def _count(state: str) -> None:
    try:
        _registry().counter("fleet-artifact-uploads", state=state).inc()
    except Exception:  # noqa: BLE001 — observability only
        pass


def pack_run_dir_file(d: str, fileobj: BinaryIO) -> Tuple[int, str]:
    """Tar a run dir (uncompressed — run artifacts are mostly jsonl
    that travels fine; keeps the chunk cursor simple) into a seekable
    ``fileobj`` and return ``(size, sha256 hex)``.  Both the tar and
    the digest stream, so an upload spooled through a temp file never
    holds the whole artifact in worker memory."""
    with tarfile.open(fileobj=fileobj, mode="w") as tf:
        for root, _dirs, files in os.walk(d):
            for fn in sorted(files):
                full = os.path.join(root, fn)
                tf.add(full, arcname=os.path.relpath(full, d))
    size = fileobj.tell()
    fileobj.seek(0)
    h = hashlib.sha256()
    for chunk in iter(lambda: fileobj.read(1 << 20), b""):
        h.update(chunk)
    return size, h.hexdigest()


def pack_run_dir(d: str) -> Tuple[bytes, str]:
    """In-memory `pack_run_dir_file`: ``(bytes, sha256 hex)``."""
    buf = io.BytesIO()
    _size, digest = pack_run_dir_file(d, buf)
    return buf.getvalue(), digest


def _safe_rel(rel: str) -> Optional[Tuple[str, str]]:
    """Validate a run-dir-relative path ``<name>/<timestamp>``: both
    components must survive `store.sanitize` unchanged and must not be
    dot-prefixed (dot-prefixed dirs are the atomic-landing staging
    convention the store scans skip)."""
    parts = [p for p in str(rel).replace("\\", "/").split("/") if p]
    if len(parts) != 2:
        return None
    name, ts = parts
    for p in (name, ts):
        if store.sanitize(p) != p or p.startswith(".") or p in (".", ".."):
            return None
    if name in ("campaigns", "verifier", "fleet"):
        return None
    return name, ts


class ArtifactStore:
    """Server half of the upload protocol; owned by the coordinator.
    Thread-safe: requests for the same run id serialize on a per-run
    lock (the threaded HTTP server would otherwise let a zombie
    worker's duplicate upload interleave bytes with the live one);
    landing is an atomic rename, so a racing duplicate of an already
    landed run just sees ``already``."""

    def __init__(self, base: str):
        self.base = base
        self.staging = os.path.join(base, STAGING_DIR)
        self._locks_guard = threading.Lock()
        self._run_locks: Dict[str, threading.Lock] = {}

    def _run_lock(self, run_id: str) -> threading.Lock:
        with self._locks_guard:
            return self._run_locks.setdefault(run_id, threading.Lock())

    def _paths(self, run_id: str) -> Tuple[str, str]:
        return (os.path.join(self.staging, run_id + ".tar"),
                os.path.join(self.staging, run_id + ".json"))

    def _meta(self, meta_path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(meta_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def handle(self, run_id: str, params: Dict[str, Any],
               body: bytes) -> Tuple[int, Dict[str, Any]]:
        """One upload request.  Params (query string): ``offset``,
        ``total``, ``digest``, ``rel`` — all required on chunk
        requests; an empty body with no ``offset`` is a resume probe
        answering ``{"received": N, "landed": bool}``."""
        if store.sanitize(run_id) != run_id or not run_id:
            _count("rejected")
            return 400, {"error": f"bad run id {run_id!r}"}
        with self._run_lock(run_id):
            code, doc = self._handle(run_id, params, body)
        if doc.get("landed"):
            # the staged partial is gone — drop the per-run lock entry
            # so a long-lived coordinator's lock table stays bounded
            # (a late duplicate just mints a fresh lock; its paths are
            # read-only probes and atomic-rename already-acks)
            with self._locks_guard:
                self._run_locks.pop(run_id, None)
        return code, doc

    def _handle(self, run_id: str, params: Dict[str, Any],
                body: bytes) -> Tuple[int, Dict[str, Any]]:
        part, meta_path = self._paths(run_id)
        meta = self._meta(meta_path)
        landed = bool(meta and meta.get("landed"))
        received = 0
        try:
            received = os.path.getsize(part)
        except OSError:
            pass
        if params.get("offset") is None and not body:
            if received and not landed:
                _count("resumed")
            doc = {"received": received, "landed": landed}
            if meta and meta.get("rel"):
                doc["rel"] = meta["rel"]
            return 200, doc
        try:
            offset = int(params["offset"])
            total = int(params["total"])
            digest = str(params["digest"])
            rel = str(params["rel"])
        except (KeyError, TypeError, ValueError):
            _count("rejected")
            return 400, {"error": "chunk needs offset, total, digest, "
                                  "rel"}
        safe = _safe_rel(rel)
        if safe is None:
            _count("rejected")
            return 400, {"error": f"bad run dir rel {rel!r}"}
        if landed:
            if meta.get("rel") == rel:
                return 200, {"landed": True, "already": True,
                             "received": received}
            # same run id, DIFFERENT run dir: a lease-lapse
            # re-execution minted a new wall-clock timestamp.  The
            # landed marker covers the old dir only — this dir must
            # land too or the re-executor's verdict record points at
            # a path that never arrives
            self._discard(run_id)
            received = 0
            meta = None
        if total <= 0 or total > MAX_ARTIFACT_BYTES or offset < 0 \
                or offset + len(body) > total:
            _count("rejected")
            return 400, {"error": "bad chunk window",
                         "received": received}
        if meta is not None and not meta.get("landed") and (
                meta.get("total") != total
                or meta.get("digest") != digest
                or meta.get("rel") != rel):
            # a NEW upload of the same run id (e.g. after a digest
            # mismatch restart): drop the stale partial
            self._discard(run_id)
            received = 0
            meta = None
        if meta is None:
            os.makedirs(self.staging, exist_ok=True)
            doc = {"run": run_id, "total": total,
                   "digest": digest, "rel": rel,
                   "started": round(time.time(), 3)}
            try:
                # trace stitching: the upload rides the
                # run's trace — the web layer installed the incoming
                # Jepsen-Trace header on this handler thread
                from jepsen_tpu_torch.telemetry import spans as spans_mod

                ctx = spans_mod.current_trace()
                if ctx is not None:
                    doc["trace"] = ctx.trace_id
            except Exception:  # noqa: BLE001 — observability only
                pass
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, meta_path)
            _count("started")
        if offset > received:
            return 409, {"error": "chunk gap", "received": received}
        skip = received - offset
        if skip < len(body):
            with open(part, "ab") as f:
                f.write(body[skip:])
                f.flush()
                os.fsync(f.fileno())
            received += len(body) - skip
        _count("chunk")
        if received < total:
            return 200, {"received": received}
        return self._land(run_id, part, meta_path, digest, rel,
                          received)

    def _discard(self, run_id: str) -> None:
        part, meta_path = self._paths(run_id)
        for p in (part, meta_path):
            try:
                os.remove(p)
            except OSError:
                pass

    def _land(self, run_id: str, part: str, meta_path: str,
              digest: str, rel: str, received: int
              ) -> Tuple[int, Dict[str, Any]]:
        """Verify + unpack + atomically rename into the ordinary store.
        A digest mismatch discards the partial (the client restarts
        from 0); landing into an already-existing run dir is
        ``already`` (a duplicate upload raced us)."""
        h = hashlib.sha256()
        with open(part, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != digest:
            self._discard(run_id)
            _count("rejected")
            return 409, {"error": "digest mismatch; upload discarded",
                         "received": 0}
        name, ts = _safe_rel(rel)  # validated at chunk time
        final = os.path.join(self.base, name, ts)
        if os.path.isdir(final):
            self._mark_landed(meta_path)
            self._cleanup(part)
            return 200, {"landed": True, "already": True,
                         "received": received}
        # dot-prefixed sibling staging dir: same fs as the final
        # location, skipped by store.tests/warehouse until the rename
        incoming = os.path.join(self.base, name, f".incoming-{ts}")
        try:
            os.makedirs(incoming, exist_ok=True)
            with tarfile.open(part, mode="r") as tf:
                for m in tf.getmembers():
                    mn = m.name.replace("\\", "/")
                    if m.isdev() or m.issym() or m.islnk() \
                            or mn.startswith(("/", "..")) \
                            or "/../" in mn:
                        raise ValueError(
                            f"refusing tar member {m.name!r}")
                tf.extractall(incoming)
            os.replace(incoming, final)
        except Exception as e:  # noqa: BLE001 — a bad tar must not
            import shutil  # wedge the slot; client restarts

            shutil.rmtree(incoming, ignore_errors=True)
            self._discard(run_id)
            _count("rejected")
            return 409, {"error": f"unpack failed: {e}", "received": 0}
        self._mark_landed(meta_path)
        self._cleanup(part)
        _count("landed")
        logger.info("fleet: artifact %s landed at %s/%s (%d bytes)",
                    run_id, name, ts, received)
        return 200, {"landed": True, "received": received,
                     "dir": f"{name}/{ts}"}

    def _mark_landed(self, meta_path: str) -> None:
        meta = self._meta(meta_path) or {}
        meta["landed"] = True
        meta["landed-at"] = round(time.time(), 3)
        tmp = meta_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, meta_path)
        except OSError:
            pass

    def _cleanup(self, part: str) -> None:
        try:
            os.remove(part)
        except OSError:
            pass

    # -- staging retention ------------------------------

    def staging_bytes(self) -> int:
        """Total bytes currently under ``<store>/fleet/staging/`` —
        the leak a GC-less coordinator accumulates forever."""
        total = 0
        try:
            for fn in os.listdir(self.staging):
                try:
                    total += os.path.getsize(
                        os.path.join(self.staging, fn))
                except OSError:
                    pass
        except OSError:
            pass
        return total

    def gc(self, retention_s: float,
           now: Optional[float] = None) -> Dict[str, int]:
        """Expire permanently abandoned staged uploads: partials (and
        landed markers) whose last activity — meta ``started`` /
        ``landed-at``, or the part file's mtime, whichever is newest —
        is older than `retention_s`.  A kill -9'd worker that never
        comes back otherwise leaks its partial forever.  Refreshes the
        ``fleet-artifact-staging-bytes`` gauge either way, so the leak
        is visible on /metrics before it is collected."""
        now = time.time() if now is None else now
        removed = 0
        try:
            names = os.listdir(self.staging)
        except OSError:
            names = []
        for fn in names:
            if not fn.endswith(".json") or fn.endswith(".tmp"):
                continue
            run_id = fn[:-len(".json")]
            part, meta_path = self._paths(run_id)
            meta = self._meta(meta_path) or {}
            latest = max(
                [t for t in (meta.get("started"), meta.get("landed-at"))
                 if isinstance(t, (int, float))] or [0.0])
            try:
                latest = max(latest, os.path.getmtime(part))
            except OSError:
                pass
            if latest and now - latest > float(retention_s):
                with self._run_lock(run_id):
                    self._discard(run_id)
                with self._locks_guard:
                    self._run_locks.pop(run_id, None)
                removed += 1
                _count("expired")
        # orphan part files whose sidecar meta never landed on disk
        # (a crash between the two writes) age out on mtime alone
        for fn in names:
            if not fn.endswith(".tar"):
                continue
            p = os.path.join(self.staging, fn)
            meta_p = p[:-len(".tar")] + ".json"
            try:
                if not os.path.exists(meta_p) and \
                        now - os.path.getmtime(p) > float(retention_s):
                    os.remove(p)
                    removed += 1
                    _count("expired")
            except OSError:
                pass
        remaining = self.staging_bytes()
        try:
            _registry().gauge("fleet-artifact-staging-bytes").set(
                remaining)
        except Exception:  # noqa: BLE001 — observability only
            pass
        return {"removed": removed, "staging-bytes": remaining}
