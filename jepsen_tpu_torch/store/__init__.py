"""Persistent test store (the port's copy of `jepsen_tpu/store`).

Equivalent of `jepsen/src/jepsen/store.clj` (SURVEY.md §2.1): each run gets a
directory ``store/<test-name>/<timestamp>/`` containing

- ``test.jepsen``  — the block-structured binary file (test + chunked
  history + results; see :mod:`jepsen_tpu.store.format`),
- ``history.json`` / ``results.json`` — human-readable mirrors,
- ``jepsen.log``   — the run log (wired by `core.run`),
- downloaded node logs under ``<node>/``.

Two-phase writes, exactly as the reference: :func:`save_0` persists the test
and history *before* analysis (so a crashed checker loses nothing), and
:func:`save_1` appends results afterwards without rewriting history blocks.
A ``latest`` symlink per test name and a global ``current`` symlink track the
most recent run.

The files are the JAX package's, byte for byte for plain data, so each
package loads the other's runs.  The JAX package's telemetry export at
:func:`save_1` (``telemetry.json`` and ``trace.json``) is not carried
over: the port has no telemetry module yet.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import List, Optional

from jepsen_tpu_torch.history.ops import History, Op
from jepsen_tpu_torch.store import codec
from jepsen_tpu_torch.store.format import JepsenFile, LazyHistory  # noqa: F401

BASE = "store"
TEST_FILE = "test.jepsen"


def _base(test_or_opts: Optional[dict] = None) -> str:
    if test_or_opts and test_or_opts.get("store-dir"):
        return test_or_opts["store-dir"]
    return BASE


def sanitize(name: str) -> str:
    s = "".join(c if c.isalnum() or c in "-_. " else "_" for c in name)
    if not s or set(s) <= {"."}:  # "." / ".." would escape the store root
        return "test"
    return s


def timestamp(t: Optional[float] = None) -> str:
    # UTC so directory names sort chronologically even across DST shifts.
    t = time.time() if t is None else t
    return time.strftime("%Y%m%dT%H%M%S", time.gmtime(t)) + f".{int(t * 1000) % 1000:03d}Z"


def test_dir(test: dict) -> str:
    """The run directory for a test, creating it (and the timestamp) on
    first use; cached in the test map under "start-time-str"."""
    name = sanitize(test.get("name", "test"))
    ts = test.get("start-time-str")
    if ts is None:
        ts = timestamp(test.get("start-time"))
        test["start-time-str"] = ts
    d = os.path.join(_base(test), name, ts)
    os.makedirs(d, exist_ok=True)
    return d


def path(test: dict, *components: str) -> str:
    return os.path.join(test_dir(test), *components)


def _relink(link: str, target: str) -> None:
    tmp = link + ".tmp"
    try:
        if os.path.lexists(tmp):
            os.remove(tmp)
        os.symlink(target, tmp)
        os.replace(tmp, link)
    except OSError:
        pass  # symlinks unsupported (exotic fs); non-fatal


def update_symlinks(test: dict) -> None:
    d = test_dir(test)
    name = sanitize(test.get("name", "test"))
    _relink(os.path.join(_base(test), name, "latest"), os.path.basename(d))
    _relink(os.path.join(_base(test), "current"), os.path.join(name, os.path.basename(d)))


def _normalized_history(test: dict) -> Optional[History]:
    hist = test.get("history")
    if hist is not None and not isinstance(hist, History):
        hist = History([op if hasattr(op, "to_dict") else _op_from(op) for op in hist],
                       reindex=False)
    return hist


def _op_from(d: dict):
    return Op.from_dict(d)


def save_0(test: dict) -> dict:
    """Phase 0: persist test map + history before analysis."""
    d = test_dir(test)
    hist = _normalized_history(test)
    JepsenFile(os.path.join(d, TEST_FILE)).write_test(test, hist)
    if hist is not None:
        with open(os.path.join(d, "history.json"), "w") as f:
            for op in hist:
                f.write(codec.dumps(op.to_dict()).decode() + "\n")
    update_symlinks(test)
    return test


def save_1(test: dict) -> dict:
    """Phase 1: append results after analysis; history blocks untouched."""
    d = test_dir(test)
    results = test.get("results", {})
    jf = JepsenFile(os.path.join(d, TEST_FILE))
    if not os.path.exists(jf.path):
        jf.write_test(test, _normalized_history(test))
    jf.append_results(results)
    with open(os.path.join(d, "results.json"), "w") as f:
        f.write(codec.dumps(results).decode())
    update_symlinks(test)
    return test


def load(name_or_dir: str, ts: Optional[str] = None, *, base: Optional[str] = None) -> dict:
    """Load a stored test.  `load(dir)` or `load(name, timestamp)`;
    timestamp defaults to "latest".  History comes back lazy."""
    if ts is None and os.path.isdir(name_or_dir):
        d = name_or_dir
    else:
        d = os.path.join(base or BASE, sanitize(name_or_dir), ts or "latest")
        if (ts is None or ts == "latest") and not os.path.isdir(d):
            # symlinks unavailable on this fs — fall back to the dir scan
            found = latest(name_or_dir, base=base)
            if found is None:
                raise FileNotFoundError(f"no stored runs for {name_or_dir!r}")
            d = found
    d = os.path.realpath(d)
    return JepsenFile(os.path.join(d, TEST_FILE)).read()


def load_results(name: str, ts: Optional[str] = None, *, base: Optional[str] = None) -> Optional[dict]:
    t = load(name, ts, base=base)
    return t.get("results")


def tests(name: Optional[str] = None, *, base: Optional[str] = None) -> List[str]:
    """List run directories, newest first (lazy dir scan, as jepsen.web)."""
    b = base or BASE
    out: List[str] = []
    if not os.path.isdir(b):
        return out
    names = [sanitize(name)] if name else sorted(os.listdir(b))
    for n in names:
        nd = os.path.join(b, n)
        # skip the base-level "current" symlink (and anything like it):
        # only real per-name directories hold runs — and the campaigns/
        # + verifier/ + fleet/ subtrees (ledgers and verifier session
        # dirs, not run dirs), _archive/ (runs retired by `gc_runs`
        # retention: archived, out of every live scan), and
        # compilecache/ (AOT entries + in-flight fleet push batches)
        if os.path.islink(nd) or not os.path.isdir(nd) \
                or n in ("campaigns", "verifier", "fleet", "_archive",
                         "compilecache"):
            continue
        for ts in os.listdir(nd):
            d = os.path.join(nd, ts)
            # dot-prefixed dirs are in-flight artifact-upload staging
            # (fleet store federation unpacks there, then atomically
            # renames into place) — not run dirs, for this scan OR the
            # warehouse ingest riding on it
            if ts != "latest" and not ts.startswith(".") \
                    and os.path.isdir(d) and not os.path.islink(d):
                out.append(d)
    # newest run first regardless of test name: order by the timestamp
    # basename, not the full path (sorting full paths would rank runs by
    # lexicographically-greatest *name* first)
    return sorted(out, key=lambda d: os.path.basename(d), reverse=True)


def latest(name: Optional[str] = None, *, base: Optional[str] = None) -> Optional[str]:
    ds = tests(name, base=base)
    return ds[0] if ds else None


def delete(name: str, ts: Optional[str] = None, *, base: Optional[str] = None) -> None:
    """Delete one run, or all runs of a test name."""
    b = base or BASE
    d = os.path.join(b, sanitize(name)) if ts is None else os.path.join(b, sanitize(name), ts)
    if os.path.isdir(d):
        shutil.rmtree(d)


def archive_dir(base: Optional[str] = None) -> str:
    """Where `gc_runs` retires run dirs: ``<base>/_archive/<name>/<ts>``
    — inside the store (same filesystem, atomic ``os.replace``) but
    outside every live scan (`tests` skips ``_archive``, and the
    warehouse ingest rides `tests`)."""
    return os.path.join(base or BASE, "_archive")


def _run_dir_age_s(d: str, now: float) -> float:
    """A run dir's age from its UTC timestamp basename
    (``YYYYmmddTHHMMSS.mmmZ``), falling back to mtime for
    foreign-named dirs."""
    ts = os.path.basename(d)
    try:
        import calendar

        t = calendar.timegm(time.strptime(ts[:15], "%Y%m%dT%H%M%S"))
        return now - t
    except (ValueError, OverflowError):
        try:
            return now - os.path.getmtime(d)
        except OSError:
            return 0.0


def gc_runs(base: Optional[str] = None, *, retention_s: float,
            now: Optional[float] = None) -> dict:
    """Retention for run dirs (``cli obs gc --retention <s>``, ISSUE 17
    satellite / ROADMAP 5c): archive **landed** runs older than
    `retention_s` to ``_archive/`` — the verifier's session-archival
    discipline (atomic ``os.replace``, millisecond suffix on
    collision) applied to the store itself, so months of autopilot
    don't grow the live store monotonically.  Unlanded dirs (no
    ``results.json`` yet: still executing, or crashed mid-run — the
    warehouse's ``status='running'`` rule) are never archived
    regardless of age; a post-mortem owns them.  Returns
    ``{"archived", "kept", "skipped"}`` counts."""
    b = base or BASE
    t = time.time() if now is None else now
    stats = {"archived": 0, "kept": 0, "skipped": 0}
    for d in tests(base=b):
        if _run_dir_age_s(d, t) < retention_s:
            stats["kept"] += 1
            continue
        if not os.path.exists(os.path.join(d, "results.json")):
            stats["skipped"] += 1
            continue
        name = os.path.basename(os.path.dirname(d))
        dst_dir = os.path.join(archive_dir(b), name)
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, os.path.basename(d))
        if os.path.exists(dst):
            dst = f"{dst}.{int(t * 1000)}"
        os.replace(d, dst)
        stats["archived"] += 1
        # tidy the per-name dir: drop a now-dangling "latest" symlink
        # and the dir itself if nothing is left
        nd = os.path.dirname(d)
        link = os.path.join(nd, "latest")
        if os.path.islink(link) and not os.path.exists(link):
            try:
                os.unlink(link)
            except OSError:
                pass
        try:
            os.rmdir(nd)
        except OSError:
            pass  # still holds runs (or the refreshed symlink)
    return stats
