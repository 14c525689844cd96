"""Control-host file cache + node deploy (the port's copy of
`jepsen_tpu/fs_cache.py`).

Equivalent of the reference's `jepsen/src/jepsen/fs_cache.clj` (SURVEY.md
§2.1): a local cache directory on the control host for downloaded
artifacts (db tarballs, binaries), with `deploy_remote` to push a cached
file to the current node — so N nodes don't each re-download a release.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import urllib.request
from typing import Optional

from . import control

CACHE_DIR = os.path.expanduser("~/.cache/jepsen-tpu")


def _key_path(key: str) -> str:
    h = hashlib.sha256(key.encode()).hexdigest()[:24]
    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in os.path.basename(key))[:64]
    return os.path.join(CACHE_DIR, f"{h}-{safe}")


def cached(key: str) -> Optional[str]:
    """The cached local path for key, or None (reference `cache/file`)."""
    p = _key_path(key)
    return p if os.path.exists(p) else None


def save(key: str, src_path: str) -> str:
    """Copy a local file into the cache under key."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    p = _key_path(key)
    shutil.copyfile(src_path, p + ".tmp")
    os.replace(p + ".tmp", p)
    return p


def fetch(url: str, *, force: bool = False) -> str:
    """Download url into the cache (once) and return the local path
    (reference `cache/locking-fetch!`-style).  Concurrent fetchers each
    write a private temp file and publish atomically, so parallel node
    setups can never observe a torn artifact."""
    import tempfile

    p = _key_path(url)
    if not force and os.path.exists(p):
        return p
    os.makedirs(CACHE_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=CACHE_DIR, suffix=".tmp")
    try:
        with urllib.request.urlopen(url) as r, os.fdopen(fd, "wb") as f:
            shutil.copyfileobj(r, f)
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return p


def deploy_remote(key_or_url: str, remote_path: str, *,
                  mode: Optional[str] = None) -> None:
    """Upload the cached artifact to the current node (reference
    `cache/deploy-remote!`); fetches first if it's a URL and uncached."""
    local = cached(key_or_url)
    if local is None:
        if "://" in key_or_url:
            local = fetch(key_or_url)
        else:
            raise FileNotFoundError(f"not cached: {key_or_url}")
    parent = os.path.dirname(remote_path)
    if parent:
        control.exec_("mkdir", "-p", parent)
    control.upload(local, remote_path)
    if mode:
        control.exec_("chmod", mode, remote_path)
