"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``_build/<name>-<hash>.so`` (the hash covers the source, the shared
``csrc/*.cuh`` headers and the flags), then loaded with ``ctypes``.  Nothing is built at import time: the
first launch builds what it needs, and :func:`build_all` builds every
source at once (one ``nvcc`` per source, all started together).  Triton
kernels keep their cache under the same ignored directory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# No --use_fast_math and no FMA contraction: the kernels must round every
# operation the way the plain PyTorch versions do.  -Xptxas=-v reports each
# kernel's registers, shared memory and spills (kept in BUILD_LOGS).
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas=-v"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOGS: dict = {}    # source name -> nvcc's output of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    # the hash covers the shared headers too: a header edit rebuilds
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(out: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    BUILD_LOGS[out.name.rsplit("-", 1)[0]] = log
    os.replace(tmp, out)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(while_building=None) -> list[Path]:
    """Compile every CUDA source in parallel; returns the library paths.
    ``while_building()`` (e.g. the Triton compiles) runs while nvcc does."""
    jobs = [_start(n) for n in sources()]
    try:
        if while_building is not None:
            while_building()
    finally:
        for out, job in jobs:
            _finish(out, job)
    return [out for out, _ in jobs]


def cuda_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out, job = _start(name)
            _finish(out, job)
            lib = ctypes.CDLL(str(out))
            _LIBS[name] = lib
        return lib


def triton_cache() -> None:
    """Keep Triton's compile cache under the package's build directory
    (set before ``triton`` is first imported)."""
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")


def ptxas_report(name: str, kernel: str) -> list[str]:
    """ptxas's lines (registers, stack, spills) for the kernels of
    ``csrc/<name>.cu`` whose mangled name holds ``kernel``, from this
    process's build (empty if the library was already built)."""
    out, keep = [], False
    for line in BUILD_LOGS.get(name, "").splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = kernel in line
        if keep:
            out.append(line.strip())
    return out


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
