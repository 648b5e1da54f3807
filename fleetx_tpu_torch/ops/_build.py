"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/`` beside this file
(listed in ``.gitignore``), named by the hash of the source and of every
shared header ``csrc/*.cuh``, so an edited source or header rebuilds and
an unchanged one is reused. Libraries are loaded with ``ctypes``.
Nothing is built at import: the first launch of a kernel builds it, and
:func:`build` builds several at once (one ``nvcc`` each, run in parallel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "build", "load", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels need the CUDA toolkit to build")
    return str(path)


def _lib_path(name: str) -> Path:
    """The library of kernel ``name``, keyed by its source, the shared
    headers (a source may include any of them) and the flags."""
    sha = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.name.encode() + header.read_bytes())
    sha.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{sha.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, float]:
    """Compile the named kernels whose library is missing, one ``nvcc``
    process each, all started together. Returns seconds per name (0.0 for
    a library that was already built). Raises with the compiler's output
    when any build fails. The ``-Xptxas -v`` report (registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {name: 0.0 for name in names}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        lib.with_name(lib.name + ".log").write_text(out)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build(name)
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of kernel ``name``'s last build ("" when
    the library was built by another process or not at all)."""
    log = _lib_path(name).with_name(_lib_path(name).name + ".log")
    return log.read_text() if log.exists() else ""
