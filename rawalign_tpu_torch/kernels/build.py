"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
one nvcc call per source takes seconds. The shared library lands in
``build/kernels/<name>-<hash>.so`` beside the package, where ``hash``
covers the source text and the compiler flags: an edited source builds
anew, an unchanged one is reused. A missing ``nvcc`` or a failed build
raises; nothing here substitutes another implementation.

Every entry point takes its pointers and the CUDA stream as
``ctypes.c_void_p`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
KERNELS = ("sketch_scan", "dtw_banded", "event_detect", "chain_dp")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: seconds each kernel's nvcc build took in this process (0.0 when a
#: library built by an earlier process was reused)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location; raises if none exists."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc")
    if os.path.isfile(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of rawalign_tpu_torch are built from source at first use"
    )


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(SRC_DIR, f"{name}.cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    src, so = _target(name)
    if os.path.exists(so):
        build_seconds.setdefault(name, 0.0)
        return so
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True,
    )
    build_seconds[name] = time.perf_counter() - t0
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return so


def build_all(names=KERNELS) -> None:
    """Build ``names`` at once: one nvcc process per source, all started
    together (a process that loads them later finds them built)."""
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        list(pool.map(_build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_build(name))
        return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for the
    current build of ``name``; empty if it was not built here."""
    _src, so = _target(name)
    try:
        with open(so[:-3] + ".log") as f:
            return f.read()
    except OSError:
        return ""


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
