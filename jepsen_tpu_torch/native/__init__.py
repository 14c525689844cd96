"""Native C++ host searches, loaded with ctypes (the port's counterpart of
`jepsen_tpu/native/__init__.py`).

`src/jepsen_native.cpp` is a byte-for-byte copy of the JAX package's
source: an iterative Tarjan SCC over CSR (`scc`, the host Tarjan of
`checkers.elle.graph.tarjan_scc`), a shortest cycle through one node
(`bfs_cycle`), and the memoized Wing-Gong-Lowe search with a polled abort
flag (`wgl`, the host leg of `checkers.knossos.wgl.check`).  Plain C ABI,
no pybind11.

Build rule: at first use the source is compiled with
``g++ -O2 -shared -fPIC -std=c++17`` into
``build/jepsen_tpu_torch/libjt_native_<digest>.so`` (the checkout's
`build/`, which `.gitignore` lists).  The digest covers the source, the
flags and the compiler's ``--version`` text, so an edited source or
another compiler builds anew.  The port never loads the JAX package's
prebuilt library.

Where the JAX loader returns None when the build fails and its callers
quietly run the Python searches, here a missing compiler, a failed build
or a library that will not load raises `NativeError`: a silent fallback
would hide a slowdown of about 70x on Knossos config 1.  Running the Python
searches is the caller's explicit choice: `JT_NO_NATIVE` set in the
environment, read by `tarjan_scc` and `wgl.check` exactly as in the JAX
package.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "jepsen_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jepsen_tpu_torch"
CXX = "g++"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

#: calls into the native library (`scc`, `bfs_cycle`, `wgl`) since the
#: count was last set to 0
CALLS = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeError(RuntimeError):
    """The native library could not be built or loaded: the compiler is
    missing, the compile failed, or the built library does not load."""


@functools.cache
def compiler_version(cxx: str) -> str:
    """`cxx --version`'s text; raises `NativeError` when `cxx` does not
    run."""
    try:
        res = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeError(
            f"{cxx} not usable: jepsen_tpu_torch builds its native host "
            f"library from {SRC.name} at first use and needs a C++17 "
            f"compiler ({e})") from e
    return res.stdout + res.stderr


def _digest(cxx: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(compiler_version(cxx).encode())
    h.update(SRC.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if the one for the current source, flags and
    compiler is not built yet; returns its path."""
    so = BUILD_DIR / f"libjt_native_{_digest(CXX)}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a name of this process's own, then rename: another
    # process never loads a half-written library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeError(f"{CXX} failed to run on {SRC}: {e}") from e
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise NativeError(f"building {SRC} failed ({CXX}, rc "
                          f"{res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = build()
        try:
            L = ctypes.CDLL(str(so))
        except OSError as e:
            raise NativeError(f"loading {so} failed: {e}") from e
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        L.jt_scc.restype = ctypes.c_int64
        L.jt_scc.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
        L.jt_bfs_cycle.restype = ctypes.c_int64
        L.jt_bfs_cycle.argtypes = [ctypes.c_int64, i64p, i64p, u8p,
                                   ctypes.c_int64, i64p, ctypes.c_int64]
        L.jt_wgl.restype = ctypes.c_int32
        L.jt_wgl.argtypes = [ctypes.c_int64, i32p, i64p, i64p,
                             ctypes.c_int64, i32p, ctypes.c_int64,
                             ctypes.c_int64, ctypes.c_int32,
                             ctypes.c_int64, i64p, i32p]
        _lib = L
        return _lib


def _count() -> None:
    # the race runs the WGL leg in a thread of its own
    global CALLS
    with _lock:
        CALLS += 1


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _as(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _csr(n: int, src: np.ndarray, dst: np.ndarray
         ) -> Tuple[np.ndarray, np.ndarray]:
    src = _i64(src)
    dst = _i64(dst)
    order = np.argsort(src, kind="stable")
    indices = dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, indices


def scc(n: int, src, dst) -> np.ndarray:
    """Component label per node by the C++ Tarjan.  Same contract as
    `checkers.elle.graph.tarjan_scc`: arbitrary ids."""
    L = lib()
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    indptr, indices = _csr(n, src, dst)
    comp = np.empty(n, dtype=np.int64)
    _count()
    L.jt_scc(n, _as(indptr, ctypes.c_int64), _as(indices, ctypes.c_int64),
             _as(comp, ctypes.c_int64))
    return comp


def bfs_cycle(n: int, src, dst, start: int,
              mask: Optional[np.ndarray] = None,
              max_len: int = 4096) -> Optional[np.ndarray]:
    """Shortest cycle through `start` (node list, closed: path[0] ==
    path[-1] == start), or None if there is none."""
    L = lib()
    if n == 0:
        return None
    indptr, indices = _csr(n, src, dst)
    m = (np.ascontiguousarray(mask, dtype=np.uint8)
         if mask is not None else None)
    _count()
    while True:
        out = np.empty(max_len, dtype=np.int64)
        ln = L.jt_bfs_cycle(
            n, _as(indptr, ctypes.c_int64), _as(indices, ctypes.c_int64),
            _as(m, ctypes.c_uint8) if m is not None else None,
            start, _as(out, ctypes.c_int64), max_len)
        if ln == -1:  # buffer too small; a cycle is at most n+1 nodes
            if max_len > n:
                return None  # can't happen, but never loop forever
            max_len = n + 1
            continue
        if ln <= 0:
            return None
        return out[:ln].copy()


def wgl(op_sym, invokes, returns, never: int, table: np.ndarray,
        init_state: int, max_configs: int = 5_000_000,
        abort_flag: Optional[np.ndarray] = None
        ) -> Tuple[Optional[bool], int, bool]:
    """Memoized WGL search.  Returns (verdict, explored, aborted) where
    verdict is True/False/None (budget exhausted or aborted).
    `abort_flag` is a shared (1,) int32 array the C++ polls every 1,024
    configs (ctypes releases the GIL, so another thread can set it: the
    competition's loser-abort path)."""
    if abort_flag is not None and (abort_flag.dtype != np.int32
                                   or abort_flag.size < 1
                                   or not abort_flag.flags["C_CONTIGUOUS"]):
        raise TypeError("abort_flag must be a contiguous int32 array "
                        f"of size >= 1, got {abort_flag.dtype} "
                        f"size {abort_flag.size}")
    L = lib()
    op_sym = np.ascontiguousarray(op_sym, dtype=np.int32)
    invokes = _i64(invokes)
    returns = _i64(returns)
    table = np.ascontiguousarray(table, dtype=np.int32)
    n_states, n_syms = table.shape
    explored = np.zeros(1, dtype=np.int64)
    _count()
    rc = L.jt_wgl(len(op_sym), _as(op_sym, ctypes.c_int32),
                  _as(invokes, ctypes.c_int64),
                  _as(returns, ctypes.c_int64), never,
                  _as(table, ctypes.c_int32), n_states, n_syms,
                  init_state, max_configs,
                  _as(explored, ctypes.c_int64),
                  _as(abort_flag, ctypes.c_int32)
                  if abort_flag is not None else None)
    verdict = {1: True, 0: False, -1: None, -2: None}[int(rc)]
    return verdict, int(explored[0]), int(rc) == -2
