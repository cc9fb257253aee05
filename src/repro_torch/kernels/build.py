"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``kernels/<name>/csrc/`` with a plain
C entry point. It is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/repro_torch/`` at the repository root, and
loaded with :mod:`ctypes`. Nothing is compiled when a module is imported:
the first launch of a kernel builds it, and :func:`build_all` builds every
kernel at once, one ``nvcc`` per source, all started together.

A library's file name carries a hash of its source, of every header the
source includes by a quoted ``#include`` (``kernels/common/hopper.cuh``),
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "library", "build_all"]

_PKG = pathlib.Path(__file__).resolve().parent
# kernel name -> its source, relative to the kernels package
SOURCES: dict[str, str] = {
    "rmsnorm": "rmsnorm/csrc/rmsnorm.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "moe_gmm": "moe_gmm/csrc/moe_gmm.cu",
    "ssd_scan": "ssd_scan/csrc/ssd_scan.cu",
    "wkv6": "rwkv6/csrc/wkv6.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# kernel name -> (seconds nvcc took, what it printed); empty when loaded
# from an earlier build
build_log: dict[str, tuple[float, str]] = {}


def build_dir() -> pathlib.Path:
    """``build/repro_torch/`` at the root of the checkout."""
    return _PKG.parents[2] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the card")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _included(src: pathlib.Path) -> list[pathlib.Path]:
    """``src`` and every file it includes by a quoted ``#include``, found
    relative to the including file, recursively, each once, in order."""
    seen: list[pathlib.Path] = []
    todo = [src.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [(path.parent / m.decode()).resolve()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = _PKG / SOURCES[name]
    h = hashlib.sha256()
    for path in _included(src):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    process (or None), the output path and the start time."""
    src, lib = _target(name)
    if lib.exists():
        return None, lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib, time.perf_counter()


def _finish(name: str, proc, lib: pathlib.Path, t0: float) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for kernel {name!r} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)       # atomic: a concurrent build sees all or none
    build_log[name] = (time.perf_counter() - t0, out)


def build_all(names=None) -> dict[str, ctypes.CDLL]:
    """Build every kernel in ``names`` (default: all), one nvcc per source
    started together, and load them. Returns name -> library."""
    names = list(SOURCES if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = [(n, *_start(n)) for n in todo]
        try:
            for n, proc, lib, t0 in started:
                _finish(n, proc, lib, t0)
        finally:
            for _, proc, _, _ in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_target(n)[1]))
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib
