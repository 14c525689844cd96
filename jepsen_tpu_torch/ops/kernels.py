"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled by its own `nvcc` process, all started together,
into an object for `sm_90a`; one link step joins the objects into a shared
library with a plain C interface, which is loaded with `ctypes`.  The
library's file name carries a digest of the sources, the flags and
`nvcc --version`'s text, so an edited source or another toolkit builds
anew and an unchanged one is loaded from the build directory (`build/` at
the checkout root, listed in `.gitignore`).

A missing `nvcc`, a failed build or a failed launch raises `KernelError`:
nothing falls back to the plain PyTorch versions, and the checkers'
host-oracle fallback lets this error through.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jepsen_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched: `nvcc` missing, a
    compile or link step failed, or a launch left a CUDA error behind."""


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


@functools.cache
def _nvcc_version(nvcc: str) -> str:
    res = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True)
    return res.stdout + res.stderr


def _digest(nvcc: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version(nvcc).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelError(
        "nvcc not found: jepsen_tpu_torch builds its CUDA kernels from "
        "csrc/ at first use and needs the CUDA toolkit (put nvcc on PATH "
        "or set CUDA_HOME)")


def build() -> Path:
    """Compile and link the kernels if the library for the current
    sources is not built yet; returns the library's path."""
    nvcc = _nvcc()
    digest = _digest(nvcc)
    so = BUILD_DIR / f"libjt_kernels_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise KernelError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(logs))
    tmp = BUILD_DIR / f"libjt_kernels.{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise KernelError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, so)
    return so


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    so = build()
    try:
        L = ctypes.CDLL(str(so))
    except OSError as e:
        raise KernelError(f"loading {so} failed: {e}") from e
    L.jt_locf_int32.argtypes = [_P, _P, _P, _I64, _I32, _P]
    L.jt_locf_int32.restype = _I32
    L.jt_seg_or_int8.argtypes = [_P, _P, _P, _P, _P, _I64, _I32, _I32,
                                 _I32, _I32, _I64, _I32, _I32, _P]
    L.jt_seg_or_int8.restype = _I32
    L.jt_error_string.argtypes = [_I32]
    L.jt_error_string.restype = ctypes.c_char_p
    return L


def check(name: str, err: int) -> None:
    """Raise if a launch (or an earlier asynchronous fault) left a CUDA
    error behind."""
    if err:
        msg = lib().jt_error_string(err).decode()
        raise KernelError(f"CUDA kernel {name} failed: {msg} ({err})")
