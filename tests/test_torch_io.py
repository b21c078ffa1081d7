"""The port's cloud files against the JAX package's: every format's round
trip, files written by either package read by the other (and written
byte for byte alike), the LZF codec byte-equal to the JAX codec, and the
LAS global shift shared by a directory."""
import os

import numpy as np
import pytest

from ghicp_tpu.io import files as jfiles
from ghicp_tpu_torch.io import files as tfiles
from ghicp_tpu_torch.io import read_cloud, write_cloud

# (extension, writer keyword arguments): every mode each format has
FORMATS = [(".txt", {}), (".pcd", {"binary": False}), (".pcd", {}),
           (".pcd", {"compressed": True}), (".ply", {"binary": False}),
           (".ply", {}), (".las", {})]
IDS = ["txt", "pcd-ascii", "pcd-binary", "pcd-lzf", "ply-ascii",
       "ply-binary", "las"]
WRITERS = {".txt": "write_txt", ".pcd": "write_pcd", ".ply": "write_ply",
           ".las": "write_las"}
READERS = {".txt": "read_txt", ".pcd": "read_pcd", ".ply": "read_ply",
           ".las": "read_las"}


@pytest.fixture
def pts():
    rng = np.random.default_rng(0)
    return rng.uniform(-50, 50, (500, 3)).astype(np.float32)


def _tol(ext, kw, pts):
    """What a format keeps: binary float32 every bit, ascii its printed
    6 decimals, LAS half its 1 mm scale; plus the float32 rounding of the
    value read back."""
    if ext in (".pcd", ".ply") and kw.get("binary", True):
        return 0.0
    ulp = np.spacing(np.abs(pts).max().astype(np.float32))
    return (0.5e-3 if ext == ".las" else 0.5e-6) + ulp


@pytest.mark.parametrize("ext,kw", FORMATS, ids=IDS)
def test_roundtrip(tmp_path, pts, ext, kw):
    p = str(tmp_path / f"cloud{ext}")
    getattr(tfiles, WRITERS[ext])(p, pts, **kw)
    back = np.asarray(getattr(tfiles, READERS[ext])(p), np.float32)
    assert back.shape == pts.shape
    assert np.abs(back - pts).max() <= _tol(ext, kw, pts)


@pytest.mark.parametrize("ext,kw", FORMATS, ids=IDS)
def test_files_cross_packages(tmp_path, pts, ext, kw):
    pj, pt = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    getattr(jfiles, WRITERS[ext])(pj, pts, **kw)
    getattr(tfiles, WRITERS[ext])(pt, pts, **kw)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(getattr(tfiles, READERS[ext])(pj),
                                  getattr(jfiles, READERS[ext])(pj))
    np.testing.assert_array_equal(getattr(jfiles, READERS[ext])(pt),
                                  getattr(tfiles, READERS[ext])(pt))


@pytest.mark.parametrize("ext", [".pcd", ".ply", ".txt", ".las"])
def test_read_cloud_cross_packages(tmp_path, pts, ext):
    p = str(tmp_path / f"c{ext}")
    jfiles.write_cloud(p, pts)
    got, shift = read_cloud(p)
    want, wshift = jfiles.read_cloud(p)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(shift, wshift)


def test_unknown_extension_raises(tmp_path, pts):
    with pytest.raises(ValueError):
        write_cloud(str(tmp_path / "c.xyz"), pts)
    with pytest.raises(ValueError):
        read_cloud(str(tmp_path / "c.xyz"))


LZF_CASES = [
    b"",
    b"a",
    b"a" * 1000,                        # overlapping back reference
    bytes(range(256)) * 8,              # long matches
    np.random.default_rng(3).integers(0, 256, 5000,
                                      dtype=np.uint8).tobytes(),
    b"abcabcabcabc" + b"x" * 40 + b"abcabcabc",
    b"xy" * 5000,                       # matches past the 264-byte cap
    bytes(9000) + b"q" + bytes(9000),   # references near the 8 KiB window
]


@pytest.mark.parametrize("i", range(len(LZF_CASES)))
def test_lzf_codec_byte_equal_to_jax(i):
    raw = LZF_CASES[i]
    comp = tfiles._lzf_compress(raw)
    assert comp == jfiles._lzf_compress(raw)
    assert tfiles._lzf_decompress(comp, len(raw)) == raw
    assert jfiles._lzf_decompress(comp, len(raw)) == raw


def test_lzf_refuses_corrupt_streams():
    with pytest.raises(ValueError):
        tfiles._lzf_decompress(bytes([0x20, 0x05]), 3)   # ref before start
    with pytest.raises(ValueError):
        tfiles._lzf_decompress(tfiles._lzf_compress(b"abc"), 4)


def test_las_global_shift_shared_by_a_directory(tmp_path):
    """UTM-scale LAS clouds are re-centered by one persisted shift a
    directory (dataio.hpp:268-361), whichever package wrote it."""
    rng = np.random.default_rng(1)
    utm = rng.uniform(0, 100, (300, 3)) + np.array([500000.0, 4000000.0,
                                                    300.0])
    d = tmp_path / "scans"
    d.mkdir()
    p1, p2 = str(d / "s1.las"), str(d / "s2.las")
    tfiles.write_las(p1, utm)
    tfiles.write_las(p2, utm + 25.0)
    a, shift_a = read_cloud(p1)
    b, shift_b = read_cloud(p2)
    # the first read keeps the shift it computed, the file holds it to
    # 8 decimals, as in the JAX package
    np.testing.assert_allclose(shift_a, shift_b, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tfiles.load_global_shift(str(d)), shift_b)
    assert np.abs(a).max() < 1e4
    np.testing.assert_allclose(b.mean(0) - a.mean(0), [25.0] * 3, atol=1e-2)
    # the JAX package reads the same directory with the same shift
    jb, jshift = jfiles.read_cloud(p2)
    np.testing.assert_array_equal(jshift, shift_b)
    np.testing.assert_array_equal(jb, b)
    # writing back undoes the shift
    p3 = str(d / "out.las")
    write_cloud(p3, a, global_shift=shift_a)
    np.testing.assert_allclose(tfiles.read_las(p3), utm, atol=5e-3)
    # a directory whose shift the JAX package wrote
    e = tmp_path / "jax_scans"
    e.mkdir()
    jfiles.write_las(str(e / "s1.las"), utm)
    jfiles.read_cloud(str(e / "s1.las"))
    tfiles.write_las(str(e / "s2.las"), utm + 25.0)
    _, shift_e = read_cloud(str(e / "s2.las"))
    np.testing.assert_array_equal(shift_e, jfiles.load_global_shift(str(e)))
    assert os.path.exists(e / tfiles.GLOBAL_SHIFT_FILE)


def test_small_las_keeps_no_shift(tmp_path, pts):
    p = str(tmp_path / "local.las")
    tfiles.write_las(p, pts)
    got, shift = read_cloud(p)
    assert not shift.any() and tfiles.load_global_shift(str(tmp_path)) is None
    assert np.abs(got - pts).max() <= _tol(".las", {}, pts)
