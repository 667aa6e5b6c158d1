"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
beside the package (a directory git ignores), keyed by a hash of the source
and the flags, then loaded with :mod:`ctypes`.  Nothing here runs at import
time: this module is imported on machines without a GPU or a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# sources a .cu includes from csrc/, which its build key hashes too
INCLUDES = {"jpeg_decode": ("jpeg_huffman.cpp",)}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# compiler output (ptxas register / shared-memory / spill report) of the
# builds this process ran, by source name
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    sources = (f"{name}.cu", *INCLUDES.get(name, ()))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in sources:
        digest.update((CSRC / source).read_bytes())
    key = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source not built yet, one ``nvcc`` per source,
    all started together.  Returns the wall seconds each build took."""
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in started.items():
        build_log[name] = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}.cu ---\n{build_log[n]}" for n in failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
