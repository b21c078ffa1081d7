"""The port's native host runtime: ``ghicp_native.cpp`` through ctypes.

The library is built at first use with ``g++`` into the package's ignored
``_build/`` directory, under a name keyed by a hash of the source, the
flags and what ``-march=native`` means on this host, and loaded from
there.  A failed build raises with the compiler's output: nothing falls
back quietly.  Each entry has its plain numpy version beside it (the
reference of the tests).

Pure host code: no entry touches a device.
"""
from __future__ import annotations

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ghicp_native.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17",
             "-Wall", "-shared"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native runtime needs it")
    return found


def library_path() -> Path:
    """Where this host's build of the source lives (built or not)."""
    cxx = _cxx()
    # -march=native differs between hosts: a library built for another
    # CPU must not be loaded here
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, timeout=60)
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    h.update(target.stdout.encode())
    h.update(SOURCE.read_bytes())
    return BUILD / f"ghicp_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the source unless this host's library exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            lib.ghicp_las_decode.argtypes = [p, i64, i32, p, p, p]
            lib.ghicp_las_decode.restype = None
            lib.ghicp_las_encode.argtypes = [p, i64, i32, p, p, p]
            lib.ghicp_las_encode.restype = None
            lib.ghicp_voxel_mark.argtypes = [p, i64, ctypes.c_float, p]
            lib.ghicp_voxel_mark.restype = i64
            lib.ghicp_transform_points.argtypes = [p, i64, p]
            lib.ghicp_transform_points.restype = None
            lib.ghicp_txt_parse.argtypes = [p, i64, p, i64]
            lib.ghicp_txt_parse.restype = i64
            _LIB = lib
        return _LIB


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when this host cannot build it (no
    g++, or a failed compile).  The readers and writers call
    :func:`library`, which raises instead."""
    try:
        return library()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None


def available() -> bool:
    """Whether the library builds and loads on this host."""
    return get_lib() is not None


# --------------------------------------------------------------- LAS ----
def _check_records(raw: np.ndarray, n: int, record_len: int) -> np.ndarray:
    raw = np.ascontiguousarray(raw, np.uint8).reshape(-1)
    if record_len < 12 or raw.size < n * record_len:
        raise ValueError(f"{raw.size} bytes hold no {n} records of "
                         f"{record_len} bytes")
    return raw


def las_decode(raw: np.ndarray, n: int, record_len: int, scale: np.ndarray,
               offset: np.ndarray) -> np.ndarray:
    """LAS point records (int32 x, y, z at the start of each) -> [n, 3]
    float64 coordinates ``v * scale + offset``."""
    raw = _check_records(raw, n, record_len)
    out = np.empty((n, 3), np.float64)
    sc = np.ascontiguousarray(scale, np.float64).reshape(3)
    of = np.ascontiguousarray(offset, np.float64).reshape(3)
    library().ghicp_las_decode(raw.ctypes.data, n, record_len,
                               sc.ctypes.data, of.ctypes.data,
                               out.ctypes.data)
    return out


def las_decode_plain(raw, n: int, record_len: int, scale, offset):
    rec = _check_records(raw, n, record_len)[:n * record_len]
    xyz_i = rec.reshape(n, record_len)[:, :12].copy().view("<i4")
    return (xyz_i.astype(np.float64) * np.asarray(scale, np.float64)
            + np.asarray(offset, np.float64))


def las_encode(xyz: np.ndarray, record_len: int, scale: np.ndarray,
               offset: np.ndarray) -> np.ndarray:
    """[n, 3] float64 coordinates -> n zeroed LAS records of
    ``record_len`` bytes holding ``llround((v - offset) / scale)`` as
    int32 x, y, z."""
    xyz = np.ascontiguousarray(xyz, np.float64).reshape(-1, 3)
    if record_len < 12:
        raise ValueError(f"a record of {record_len} bytes holds no xyz")
    n = len(xyz)
    out = np.zeros(n * record_len, np.uint8)
    sc = np.ascontiguousarray(scale, np.float64).reshape(3)
    of = np.ascontiguousarray(offset, np.float64).reshape(3)
    library().ghicp_las_encode(xyz.ctypes.data, n, record_len,
                               sc.ctypes.data, of.ctypes.data,
                               out.ctypes.data)
    return out


def las_encode_plain(xyz, record_len: int, scale, offset) -> np.ndarray:
    v = ((np.asarray(xyz, np.float64).reshape(-1, 3)
          - np.asarray(offset, np.float64))
         / np.asarray(scale, np.float64))
    t = np.trunc(v)
    # llround: halves away from zero (v - trunc(v) is exact)
    r = np.where(np.abs(v - t) >= 0.5, t + np.sign(v), t)
    rec = np.zeros((len(v), record_len), np.uint8)
    rec[:, :12] = r.astype("<i4").view(np.uint8).reshape(len(v), 12)
    return rec.reshape(-1)


# ------------------------------------------------------------- voxels ----
def voxel_mark(xyz: np.ndarray, voxel: float) -> np.ndarray:
    """[n] bool keeping the first point of each occupied voxel."""
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    keep = np.empty(len(xyz), np.uint8)
    library().ghicp_voxel_mark(xyz.ctypes.data, len(xyz),
                               ctypes.c_float(voxel), keep.ctypes.data)
    return keep.astype(bool)


def voxel_mark_plain(xyz, voxel: float) -> np.ndarray:
    """The C++ arithmetic in numpy: a float32 difference from the minimum
    times the double reciprocal, truncated, hashed in uint64."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    keep = np.zeros(len(xyz), bool)
    if not len(xyz):
        return keep
    d = (xyz - xyz.min(axis=0)).astype(np.float64) * (1.0 / np.float32(
        voxel).astype(np.float64))
    v = d.astype(np.uint64)
    key = ((v[:, 0] * np.uint64(73856093)) ^ (v[:, 1] * np.uint64(19349663))
           ^ (v[:, 2] * np.uint64(83492791)))
    keep[np.unique(key, return_index=True)[1]] = True
    return keep


# ---------------------------------------------------------------- txt ----
def txt_parse(data: bytes) -> np.ndarray:
    """Whitespace-separated ``x y z [extras]`` lines -> [n, 3] float64
    (lines that do not start with a number are skipped; OpenMP over
    newline-aligned chunks)."""
    buf = np.frombuffer(data, np.uint8)
    max_pts = data.count(b"\n") + 1
    out = np.empty((max_pts, 3), np.float64)
    n = library().ghicp_txt_parse(buf.ctypes.data, len(data),
                                  out.ctypes.data, max_pts)
    return out[:n]


def txt_parse_plain(data: bytes) -> np.ndarray:
    if not data.strip():
        return np.empty((0, 3), np.float64)
    return np.loadtxt(io.BytesIO(data), dtype=np.float64, ndmin=2)[:, :3]


# ---------------------------------------------------------- transform ----
def transform_points(xyz: np.ndarray, T: np.ndarray) -> np.ndarray:
    """[n, 3] float32 points under the rigid [4, 4] ``T`` (a new array)."""
    out = np.array(xyz, np.float32, copy=True, order="C").reshape(-1, 3)
    Tc = np.ascontiguousarray(T, np.float32).reshape(4, 4)
    library().ghicp_transform_points(out.ctypes.data, len(out),
                                     Tc.ctypes.data)
    return out


def transform_points_plain(xyz, T) -> np.ndarray:
    xyz = np.asarray(xyz, np.float32)
    T = np.asarray(T, np.float32)
    return xyz @ T[:3, :3].T + T[:3, 3]
