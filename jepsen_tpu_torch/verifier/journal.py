"""Per-session ingest journals: accept → fsync → ack (the port's copy of
`jepsen_tpu/verifier/journal.py`; the files are the JAX package's, byte
for byte).

The durability half of the verifier service: every segment a client
streams is validated line by line, appended to the session's
``journal.jsonl``, and **fsync'd before the acknowledgment leaves the
server** — so an acked op can never be lost to a crash.  The journal
byte size *is* the ack cursor: a client resumes by resending from the
last cursor it saw acked, and the server drops the already-journaled
overlap (idempotent re-append).

Crash discipline mirrors the flight recorder / campaign ledger: a
``kill -9`` mid-append leaves at most one torn trailing line.  On
recovery the journal is opened with :meth:`SessionJournal.recover`,
which truncates crash debris back to the last complete line — the
replayed session then reaches the identical verdict digest, because
the incremental state is a pure function of the accepted op sequence.

Compaction: a month-long session must not keep an unbounded
jsonl replay prefix.  :meth:`SessionJournal.compact` rewrites the file
as ``header + suffix`` where the header line ``{"_journal": 1,
"base": C}`` records that the first ``C`` logical bytes of the stream
now live in the session's checkpoint (``checkpoint.npz``, written by
the service BEFORE the journal truncates).  The ack cursor is the
LOGICAL stream offset (``base + payload bytes``), so clients never see
compaction: resend-from-cursor semantics are unchanged.  Both rewrites
are single ``os.replace``\\ s, so any crash leaves either the old or
the new file — and a crash between checkpoint write and journal
truncate is healed on recovery by replaying only the journal suffix
past the checkpoint's cursor (:meth:`read_ops` ``from_cursor``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple


def _fsync_booked(fd: int) -> None:
    """fsync, booking the wall as ``journal_fsync_s`` phase self-time
    on the enclosing telemetry span — the durability tax
    becomes attributable instead of vanishing into span totals."""
    t0 = time.perf_counter()
    os.fsync(fd)
    from jepsen_tpu_torch.telemetry import spans as _spans

    _spans.add_phase("journal_fsync_s", time.perf_counter() - t0)

__all__ = ["SessionJournal", "split_segment", "op_feedable", "read_meta",
           "write_checkpoint", "read_checkpoint",
           "JOURNAL_FILE", "META_FILE", "CHECKPOINT_FILE"]

JOURNAL_FILE = "journal.jsonl"
META_FILE = "session.json"
CHECKPOINT_FILE = "checkpoint.npz"


def read_meta(dirpath: str) -> Optional[Dict[str, Any]]:
    """A session dir's ``session.json`` snapshot, or None.  Module-level
    so read-only surfaces (web listings, warehouse ingest) never
    construct a :class:`SessionJournal` — whose recovery would
    *truncate* another process's torn tail out from under it."""
    try:
        with open(os.path.join(dirpath, META_FILE)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


_OP_TYPES = frozenset({"invoke", "ok", "fail", "info"})
_SCALAR = (str, int, float, bool, type(None))


def _mop_ok(m: Any) -> bool:
    if not isinstance(m, (list, tuple)) or len(m) < 2 \
            or not isinstance(m[1], _SCALAR):
        return False
    kind = m[0]
    if kind in ("append", "w"):
        return len(m) >= 3 and isinstance(m[2], _SCALAR)
    if kind == "r":
        if len(m) < 3 or m[2] is None:
            return True
        return isinstance(m[2], list) and \
            all(isinstance(v, _SCALAR) for v in m[2])
    return False


def op_feedable(rec: Dict[str, Any]) -> bool:
    """Can the packer/session actually consume this op dict?  The
    journal's acceptance predicate: a line that parses as JSON but
    would blow up `Op.from_dict`/`TxnPacker.feed` (missing/unknown
    ``type``, a non-list client value, malformed or unhashable mops)
    must be REFUSED before it is fsync'd — a journaled-but-unfeedable
    op would brick the session on every replay."""
    if rec.get("type") not in _OP_TYPES:
        return False
    p = rec.get("process")
    if not (isinstance(p, int) and p >= 0):
        return True  # non-client op: the packer skips it entirely
    v = rec.get("value")
    if v is None:
        return True
    if not isinstance(v, list):
        return False
    return all(_mop_ok(m) for m in v)


def split_segment(body: bytes) -> Tuple[bytes, int, List[Dict[str, Any]]]:
    """Validate one streamed segment: returns ``(accepted_bytes,
    n_lines, ops)`` where ``accepted_bytes`` is the longest prefix of
    complete, parseable, FEEDABLE op-dict lines (:func:`op_feedable`).
    A torn trailing line (no newline) is left for the client's next
    send; a complete-but-corrupt/unfeedable line stops acceptance at
    its start (the client gets the cursor before it and must fix its
    stream)."""
    ops: List[Dict[str, Any]] = []
    accepted = 0
    n = 0
    start = 0
    while True:
        nl = body.find(b"\n", start)
        if nl < 0:
            break
        line = body[start:nl]
        if line.strip():
            try:
                rec = json.loads(line)
            except ValueError:
                break
            if not isinstance(rec, dict) or not op_feedable(rec):
                break
            ops.append(rec)
            n += 1
        start = nl + 1
        accepted = start
    return body[:accepted], n, ops


def _header_line(base: int) -> bytes:
    return json.dumps({"_journal": 1, "base": int(base)}).encode() + b"\n"


def _parse_header(line: bytes) -> Optional[int]:
    """The compaction header's base cursor, or None when `line` is an
    ordinary (pre-compaction) payload line."""
    if not line.startswith(b'{"_journal"'):
        return None
    try:
        doc = json.loads(line)
    except ValueError:
        return None
    if isinstance(doc, dict) and doc.get("_journal") == 1:
        try:
            return max(0, int(doc.get("base", 0)))
        except (TypeError, ValueError):
            return None
    return None


class SessionJournal:
    """Append-only fsync'd op journal for one verifier session.

    ``cursor`` is the LOGICAL stream offset (``base`` + on-disk payload
    bytes); ``base > 0`` after a :meth:`compact` — the truncated prefix
    lives in the session checkpoint."""

    def __init__(self, dirpath: str):
        self.dir = dirpath
        self.path = os.path.join(dirpath, JOURNAL_FILE)
        os.makedirs(dirpath, exist_ok=True)
        self._f = None
        self.base = 0
        self._header_len = 0
        self.cursor = self.recover()

    def recover(self) -> int:
        """Scan the journal, truncating a torn/corrupt/unfeedable tail
        back to the last complete replayable line; returns the durable
        cursor — exactly the prefix :meth:`read_ops` will replay, so
        the ack cursor and the replayed state can't diverge."""
        self.base = 0
        self._header_len = 0
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return 0
        good = 0
        first = True
        with open(self.path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break
                if first:
                    first = False
                    base = _parse_header(line)
                    if base is not None:
                        self.base = base
                        self._header_len = len(line)
                        good += len(line)
                        continue
                if line.strip():
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        break
                    if not isinstance(rec, dict) or not op_feedable(rec):
                        break
                good += len(line)
        if good < size:
            with open(self.path, "rb+") as f:
                f.truncate(good)
        return self.base + (good - self._header_len)

    def disk_bytes(self) -> int:
        """On-disk journal size — the quantity compaction bounds (the
        ``verifier-journal-bytes`` gauge)."""
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def compact(self, upto: int) -> None:
        """Truncate the replayed prefix: rewrite the journal as a
        ``base=upto`` header plus the payload past ``upto``.  The
        caller (the service) has already checkpointed the session state
        at cursor ``upto``; the rewrite is one atomic ``os.replace``,
        and the logical cursor is unchanged."""
        upto = int(upto)
        if upto < self.base or upto > self.cursor:
            raise ValueError(
                f"compact cursor {upto} outside journal window "
                f"[{self.base}, {self.cursor}]")
        suffix = b""
        try:
            with open(self.path, "rb") as f:
                f.seek(self._header_len + (upto - self.base))
                suffix = f.read()
        except FileNotFoundError:
            if upto < self.cursor:
                # acked payload past `upto` must exist on disk —
                # rewriting header-only here would silently drop it
                # and break resend-from-cursor.  (A read failure on a
                # present file propagates for the same reason: the
                # caller treats a failed compact as a no-op that
                # leaves the journal whole.)
                raise
        self.close()  # the append handle points at the old inode
        header = _header_line(upto)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(header + suffix)
            f.flush()
            _fsync_booked(f.fileno())
        os.replace(tmp, self.path)
        self.base = upto
        self._header_len = len(header)

    def _file(self):
        if self._f is None:
            self._f = open(self.path, "ab", buffering=0)
        return self._f

    def append(self, data: bytes) -> int:
        """Append pre-validated journal bytes; fsync; return the new
        cursor.  The caller (the service) acks only after this
        returns — accepted segments land durably before the ack."""
        if not data:
            return self.cursor
        f = self._file()
        f.write(data)
        _fsync_booked(f.fileno())
        self.cursor += len(data)
        return self.cursor

    def read_ops(self, chunk_lines: int = 4096,
                 from_cursor: Optional[int] = None
                 ) -> Iterator[List[Dict[str, Any]]]:
        """Replay the journal as op-dict chunks (history order).  A
        torn tail (only possible before :meth:`recover` ran) is
        dropped, and replay STOPS at an unfeedable line (impossible
        through `split_segment`; external corruption otherwise) — the
        same discipline as every jsonl reader in the repo.

        ``from_cursor`` (a logical stream offset, e.g. a checkpoint's
        cursor) skips the already-checkpointed prefix — it is always a
        line boundary because cursors only ever advance by accepted
        complete lines."""
        out: List[Dict[str, Any]] = []
        try:
            f = open(self.path, "rb")
        except OSError:
            return
        with f:
            if self._header_len:
                f.seek(self._header_len)
            if from_cursor is not None and from_cursor > self.base:
                f.seek(self._header_len + (from_cursor - self.base))
            for line in f:
                if not line.endswith(b"\n"):
                    break
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break
                if not isinstance(rec, dict) or not op_feedable(rec):
                    break
                out.append(rec)
                if len(out) >= chunk_lines:
                    yield out
                    out = []
        if out:
            yield out

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    # -- checkpoint (the compacted prefix's state snapshot) --------------

    def write_checkpoint(self, cols: Dict[str, Any],
                         meta: Dict[str, Any]) -> None:
        write_checkpoint(self.dir, cols, meta)

    def read_checkpoint(self):
        return read_checkpoint(self.dir)

    # -- session meta (atomic state snapshot for read-only surfaces) -----

    def write_meta(self, state: Dict[str, Any]) -> None:
        """Atomically replace ``session.json`` — the state snapshot the
        web pages and the warehouse ingest read without the service."""
        tmp = os.path.join(self.dir, META_FILE + ".tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(state, f, indent=1, sort_keys=True)
            os.replace(tmp, os.path.join(self.dir, META_FILE))
        except OSError:
            pass

    def read_meta(self) -> Optional[Dict[str, Any]]:
        return read_meta(self.dir)


def write_checkpoint(dirpath: str, cols: Dict[str, Any],
                     meta: Dict[str, Any]) -> None:
    """Persist a session checkpoint: the packed SoA prefix (binary
    columns — ~10x smaller than the jsonl they replace) plus a JSON
    meta blob (packer interners, counters, the checkpoint cursor)
    embedded as a uint8 array so the whole checkpoint is ONE file and
    one atomic ``os.replace``."""
    import numpy as np

    blob = np.frombuffer(json.dumps(meta, sort_keys=True).encode(),
                         dtype=np.uint8)
    tmp = os.path.join(dirpath, CHECKPOINT_FILE + ".tmp.npz")
    # np.savez appends .npz when missing — name the tmp with the suffix
    # so the path we fsync/replace is the one actually written
    np.savez(tmp[:-len(".npz")], _meta_json=blob,
             **{k: np.asarray(v) for k, v in cols.items()})
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dirpath, CHECKPOINT_FILE))


def read_checkpoint(dirpath: str):
    """Load a session checkpoint → ``(cols, meta)`` or None (absent or
    unreadable — the caller then replays the whole journal, which is
    only possible when no compaction ever truncated it)."""
    import zipfile

    import numpy as np

    path = os.path.join(dirpath, CHECKPOINT_FILE)
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["_meta_json"]).decode())
            cols = {k: z[k] for k in z.files if k != "_meta_json"}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None
    if not isinstance(meta, dict) or "cursor" not in meta:
        return None
    return cols, meta
