"""Build the port's CUDA sources at first use and load them with ctypes.

Every kernel source lives under ``kernels/csrc/`` and exposes a plain C
interface; :func:`load_library` compiles one source with ``nvcc`` for
Hopper (``sm_90a``) into ``kernels/build/`` — a directory the repository
ignores — and loads the shared library; :func:`build_libraries` starts one
``nvcc`` per source, all at once, and loads them all.  The library's file name carries a
digest of the source and the flags, so an edited source is rebuilt and a
stale build is never loaded.  Nothing is built when a module is imported:
the CPU tests import every module on a machine without ``nvcc``.

A missing ``nvcc`` or a failed build raises :class:`KernelBuildError`;
nothing falls back.  Builds and loads hold one process-wide lock, so
threads that need one library together run one ``nvcc``; each library is
written under a temporary name and renamed into place, so another process
never loads a torn file.
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
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

#: ``--fmad=false`` keeps every multiply and add separately rounded, so the
#: kernels can be held bitwise against their plain PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
#: held across each check-build-load, by every thread of the process
_BUILD_LOCK = threading.RLock()
#: seconds from the start of a build to each library's nvcc finishing in
#: this process (0.0 when loaded from an existing build), and nvcc's report
#: (registers, spills)
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels are built from source at first use")


def library_path(stem: str) -> Path:
    src = CSRC / f"{stem}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def _build(stems: Sequence[str]) -> None:
    """Build every missing library of ``stems``: one ``nvcc`` per source,
    all started together, then wait for each.  Raises
    :class:`KernelBuildError` naming every source that failed."""
    with _BUILD_LOCK:
        missing = [s for s in dict.fromkeys(stems)
                   if s not in _LIBS and not library_path(s).exists()]
        if not missing:
            return
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for stem in missing:
            so = library_path(stem)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, so)
        errors = []
        for stem, (proc, tmp, so) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed to build {stem}.cu (exit "
                              f"{proc.returncode}):\n{err}{out}")
                continue
            build_log[stem] = err + out
            os.replace(tmp, so)  # atomic: a concurrent build never sees a torn file
            build_seconds[stem] = time.perf_counter() - t0
        if errors:
            raise KernelBuildError("\n".join(errors))


def load_library(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<stem>.cu``; cached per process."""
    with _BUILD_LOCK:
        lib = _LIBS.get(stem)
        if lib is not None:
            return lib
        _build([stem])
        build_seconds.setdefault(stem, 0.0)
        lib = ctypes.CDLL(str(library_path(stem)))
        _LIBS[stem] = lib
        return lib


def build_libraries(stems: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build the missing libraries of ``stems`` in parallel and load all."""
    _build(stems)
    return {stem: load_library(stem) for stem in stems}
