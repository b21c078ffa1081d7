"""Point-cloud file IO: .pcd / .ply / .las / .txt readers and writers.

Pure host code (numpy and the native runtime, no device).  A
re-implementation of ``DataIo`` (reference
``include/dataio.hpp:26-119``) without PCL/libLAS:

* ``read_cloud`` / ``write_cloud`` dispatch on extension like
  ``readCloudFile``/``writeCloudFile`` (dataio.hpp:26-119);
* LAS 1.x point formats 0-5 are parsed directly from the binary header
  (scales/offsets applied), with the reference's *global shift* convention:
  large UTM coordinates are re-centered and the shift persisted to
  ``GlobalShift.txt`` so multiple clouds share one local frame
  (dataio.hpp:268-361);
* PCD supports ascii and binary, PLY supports ascii and
  binary_little_endian, TXT is whitespace-separated x y z per line
  (dataio.hpp:121-162, 490-560).
"""
from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

from ghicp_tpu_torch import native

GLOBAL_SHIFT_FILE = "GlobalShift.txt"


# ----------------------------------------------------------------- txt ----
def read_txt(path: str) -> np.ndarray:
    """x y z [extras] per line (reference readTxtFile, dataio.hpp:508-560),
    through the native parser."""
    with open(path, "rb") as f:
        raw = f.read()
    return native.txt_parse(raw).astype(np.float32)


def write_txt(path: str, pts: np.ndarray) -> None:
    np.savetxt(path, np.asarray(pts, np.float32), fmt="%.6f")


# ----------------------------------------------------------------- pcd ----
_PCD_TYPE = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 1): "<i1",
             ("I", 2): "<i2", ("I", 4): "<i4", ("U", 1): "<u1",
             ("U", 2): "<u2", ("U", 4): "<u4"}


def _lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """LibLZF decompression (the PCD ``binary_compressed`` codec; PCL reads
    this transparently via ``pcd_io``, reference path dataio.hpp:121-162).

    Control byte < 32: literal run of ctrl+1 bytes.  Otherwise a back
    reference: top 3 bits = length-2 (7 => one extension byte follows),
    low 5 bits + next byte = 13-bit backward offset - 1.
    """
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            cnt = ctrl + 1
            out += data[i:i + cnt]
            i += cnt
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("corrupt LZF stream: reference before start")
            for _ in range(length + 2):     # overlapping copies are legal
                out.append(out[ref])
                ref += 1
    if len(out) != expected_size:
        raise ValueError(f"LZF size mismatch: got {len(out)}, "
                         f"expected {expected_size}")
    return bytes(out)


def _lzf_compress(data: bytes) -> bytes:
    """Greedy libLZF-compatible compressor (3-byte hash chain), used by
    ``write_pcd(compressed=True)`` and the round-trip tests."""
    n = len(data)
    out = bytearray()
    htab = {}
    i = lit_start = 0

    def flush_literals(end):
        j = lit_start
        while j < end:
            cnt = min(32, end - j)
            out.append(cnt - 1)
            out.extend(data[j:j + cnt])
            j += cnt

    while i < n - 2:
        key = data[i:i + 3]
        ref = htab.get(key, -1)
        htab[key] = i
        off = i - ref - 1
        if 0 <= ref and off < 8192:
            max_len = min(n - i, 264)       # 7 + 255 + 2
            length = 3
            while length < max_len and data[ref + length] == data[i + length]:
                length += 1
            flush_literals(i)
            enc = length - 2
            if enc < 7:
                out.append((enc << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(enc - 7)
            out.append(off & 0xFF)
            i += length
            lit_start = i
        else:
            i += 1
    flush_literals(n)
    return bytes(out)


def read_pcd(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header.get("POINTS", header.get("WIDTH", "0")))
        mode = header["DATA"]
        dt = []
        for name, s, t, c in zip(fields, sizes, types, counts):
            base = _PCD_TYPE[(t, s)]
            dt.append((name, base, (c,)) if c > 1 else (name, base))
        dtype = np.dtype(dt)
        if mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, ndmin=2)
            idx = [fields.index(k) for k in ("x", "y", "z")]
            return raw[:, idx].astype(np.float32)
        if mode == "binary":
            buf = f.read(n * dtype.itemsize)
            arr = np.frombuffer(buf, dtype=dtype, count=n)
            return np.stack([arr["x"], arr["y"], arr["z"]],
                            axis=1).astype(np.float32)
        if mode == "binary_compressed":
            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            raw = _lzf_decompress(f.read(comp_size), uncomp_size)
            # Compressed PCD stores a structure-of-arrays: each field's
            # values for ALL points are contiguous (PCL pcd_io convention).
            out = {}
            off = 0
            for name, s, t, c in zip(fields, sizes, types, counts):
                if name in ("x", "y", "z"):
                    a = np.frombuffer(raw, dtype=_PCD_TYPE[(t, s)],
                                      count=n * c, offset=off)
                    out[name] = a.reshape(n, c)[:, 0] if c > 1 else a
                off += n * s * c
            return np.stack([out["x"], out["y"], out["z"]],
                            axis=1).astype(np.float32)
        raise ValueError(f"unknown PCD DATA mode {mode!r}")


def write_pcd(path: str, pts: np.ndarray, binary: bool = True,
              compressed: bool = False) -> None:
    pts = np.asarray(pts, np.float32)
    n = len(pts)
    mode = ("binary_compressed" if compressed
            else "binary" if binary else "ascii")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {mode}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if compressed:
            # Structure-of-arrays field blocks, LZF-compressed.
            soa = np.concatenate([np.ascontiguousarray(pts[:, i], "<f4")
                                  for i in range(3)]).tobytes()
            comp = _lzf_compress(soa)
            f.write(struct.pack("<II", len(comp), len(soa)))
            f.write(comp)
        elif binary:
            f.write(np.ascontiguousarray(pts, "<f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")


# ----------------------------------------------------------------- ply ----
_PLY_TYPE = {"float": "<f4", "float32": "<f4", "double": "<f8",
             "float64": "<f8", "uchar": "<u1", "uint8": "<u1",
             "char": "<i1", "int8": "<i1", "short": "<i2", "ushort": "<u2",
             "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4"}


def read_ply(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("comment") or line.startswith("obj_info"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append((parts[-1], "LIST", parts[2], parts[3]))
                else:
                    cur[2].append((parts[2], _PLY_TYPE[parts[1]]))
            elif line == "end_header":
                break
        for name, cnt, props in elements:
            if name != "vertex":
                # Skip non-vertex elements only if they come *after* vertex;
                # PLY mandates order, vertex is conventionally first.
                continue
            if any(p[1] == "LIST" for p in props):
                raise NotImplementedError("list properties in vertex element")
            dtype = np.dtype([(p[0], p[1]) for p in props])
            if fmt == "ascii":
                rows = []
                for _ in range(cnt):
                    rows.append(tuple(f.readline().split()[:len(props)]))
                arr = np.array([tuple(map(float, r)) for r in rows],
                               dtype=[(p[0], "<f8") for p in props])
            elif fmt == "binary_little_endian":
                arr = np.frombuffer(f.read(cnt * dtype.itemsize),
                                    dtype=dtype, count=cnt)
            else:
                raise NotImplementedError(f"PLY format {fmt}")
            return np.stack([arr["x"].astype(np.float32),
                             arr["y"].astype(np.float32),
                             arr["z"].astype(np.float32)], axis=1)
    raise ValueError("no vertex element found")


def write_ply(path: str, pts: np.ndarray, binary: bool = True) -> None:
    pts = np.asarray(pts, np.float32)
    n = len(pts)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(pts, "<f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.6f")


# ----------------------------------------------------------------- las ----
def read_las(path: str) -> np.ndarray:
    """Minimal LAS 1.0-1.4 reader: xyz from point formats 0-10."""
    with open(path, "rb") as f:
        head = f.read(375)
        if head[:4] != b"LASF":
            raise ValueError("not a LAS file")
        offset_to_points = struct.unpack_from("<I", head, 96)[0]
        fmt_id = struct.unpack_from("<B", head, 104)[0] & 0x3F
        rec_len = struct.unpack_from("<H", head, 105)[0]
        n = struct.unpack_from("<I", head, 107)[0]
        if n == 0 and len(head) >= 247 + 8:
            n = struct.unpack_from("<Q", head, 247)[0]  # LAS 1.4
        sx, sy, sz = struct.unpack_from("<3d", head, 131)
        ox, oy, oz = struct.unpack_from("<3d", head, 155)
        f.seek(offset_to_points)
        buf = f.read(n * rec_len)
    raw = np.frombuffer(buf, dtype=np.uint8, count=n * rec_len)
    # multithreaded native decode (native/ghicp_native.cpp)
    xyz = native.las_decode(raw, n, rec_len, np.array([sx, sy, sz]),
                            np.array([ox, oy, oz]))
    return xyz  # float64: caller applies global shift before float32 cast


def write_las(path: str, pts: np.ndarray, scale: float = 0.001,
              offset: Optional[np.ndarray] = None) -> None:
    """LAS 1.2, point format 0."""
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    if offset is None:
        offset = pts.min(axis=0) if n else np.zeros(3)
    header = bytearray(227)
    header[0:4] = b"LASF"
    struct.pack_into("<B", header, 24, 1)   # version major
    struct.pack_into("<B", header, 25, 2)   # version minor
    struct.pack_into("<H", header, 94, 227)  # header size
    struct.pack_into("<I", header, 96, 227)  # offset to points
    struct.pack_into("<B", header, 104, 0)  # point format 0
    struct.pack_into("<H", header, 105, 20)  # record length
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<3d", header, 131, scale, scale, scale)
    struct.pack_into("<3d", header, 155, *offset)
    mn, mx = (pts.min(0), pts.max(0)) if n else (offset, offset)
    struct.pack_into("<6d", header, 179, mx[0], mn[0], mx[1], mn[1],
                     mx[2], mn[2])
    ixyz = np.round((pts - offset) / scale).astype("<i4")
    rec = np.zeros((n, 20), np.uint8)
    rec[:, :12] = ixyz.view(np.uint8).reshape(n, 12)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


# ------------------------------------------------------- global shift ----
def load_global_shift(directory: str) -> Optional[np.ndarray]:
    """Read the persisted shift (dataio.hpp:304-311)."""
    p = os.path.join(directory, GLOBAL_SHIFT_FILE)
    if os.path.exists(p):
        return np.loadtxt(p, dtype=np.float64).reshape(3)
    return None


def save_global_shift(directory: str, shift: np.ndarray) -> None:
    np.savetxt(os.path.join(directory, GLOBAL_SHIFT_FILE),
               np.asarray(shift, np.float64).reshape(1, 3), fmt="%.8f")


# --------------------------------------------------------- dispatchers ----
def read_cloud(path: str, use_global_shift: bool = True
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Read any supported cloud; returns (pts float32 [n,3], shift [3]).

    LAS files with large (UTM) coordinates are re-centered by a shared
    per-directory global shift (created on first read), mirroring
    dataio.hpp:268-361; other formats return shift = 0.
    """
    ext = os.path.splitext(path)[1].lower()
    shift = np.zeros(3)
    if ext == ".las":
        xyz = read_las(path)
        if use_global_shift and len(xyz):
            d = os.path.dirname(os.path.abspath(path))
            existing = load_global_shift(d)
            if existing is None:
                center = xyz.mean(axis=0)
                if np.abs(center).max() > 1e4:
                    existing = -center
                    save_global_shift(d, existing)
                else:
                    existing = np.zeros(3)
            shift = existing
            xyz = xyz + shift
        return xyz.astype(np.float32), shift
    if ext == ".pcd":
        return read_pcd(path), shift
    if ext == ".ply":
        return read_ply(path), shift
    if ext == ".txt":
        return read_txt(path), shift
    raise ValueError(f"unsupported cloud format: {ext}")


def write_cloud(path: str, pts: np.ndarray,
                global_shift: Optional[np.ndarray] = None) -> None:
    """Write any supported cloud format; LAS undoes the global shift."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".las":
        p = np.asarray(pts, np.float64)
        if global_shift is not None:
            p = p - np.asarray(global_shift, np.float64)
        write_las(path, p)
    elif ext == ".pcd":
        write_pcd(path, pts)
    elif ext == ".ply":
        write_ply(path, pts)
    elif ext == ".txt":
        write_txt(path, pts)
    else:
        raise ValueError(f"unsupported cloud format: {ext}")
