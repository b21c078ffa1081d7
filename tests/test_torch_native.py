"""The port's native host runtime: built from its own copy of the source
into ``ghicp_tpu_torch/_build/``, each entry against its plain numpy
version and against the JAX package's function on the same inputs."""
import pathlib

import numpy as np
import pytest

from ghicp_tpu import native as jnative
from ghicp_tpu_torch import native

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_builds_from_the_ports_source_into_build():
    lib = native.library()
    path = pathlib.Path(lib._name).resolve()
    assert path.parent == ROOT / "ghicp_tpu_torch" / "_build"
    assert path.name.startswith("ghicp_native-") and path.exists()
    assert native.SOURCE == ROOT / "ghicp_tpu_torch" / "native" / (
        "ghicp_native.cpp")
    # the C++ body is the JAX package's, below its own header comment
    body = lambda p: p.read_text().split("#include <cstdint>", 1)[1]
    assert body(native.SOURCE) == body(ROOT / "ghicp_tpu" / "native" /
                                       "ghicp_native.cpp")


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error:"):
        native.build()


def test_las_decode():
    rng = np.random.default_rng(1)
    n, rl = 5000, 20
    raw = rng.integers(0, 256, n * rl, dtype=np.uint8)
    scale = np.array([0.001, 0.001, 0.001])
    offset = np.array([100.0, 200.0, 300.0])
    got = native.las_decode(raw, n, rl, scale, offset)
    # the C++ may contract v * scale + offset into one fused operation
    np.testing.assert_allclose(
        got, native.las_decode_plain(raw, n, rl, scale, offset),
        rtol=1e-15, atol=1e-12)
    np.testing.assert_array_equal(
        got, jnative.las_decode(raw, n, rl, scale, offset))


def test_las_decode_refuses_short_buffers():
    with pytest.raises(ValueError):
        native.las_decode(np.zeros(39, np.uint8), 2, 20, [1.0] * 3,
                          [0.0] * 3)


def test_las_encode_rounds_halves_away_from_zero():
    rng = np.random.default_rng(2)
    xyz = rng.normal(0, 100, (4000, 3))
    xyz[:4] = [[0.0005, -0.0005, 0.0015], [-0.0025, 0.0035, 0.0],
               [1.2345, -1.2345, 2.5e-3], [1e6, -1e6, 0.5e-3]]
    scale, offset = [1e-3] * 3, [0.0, 0.0, 0.0]
    got = native.las_encode(xyz, 20, scale, offset)
    np.testing.assert_array_equal(
        got, native.las_encode_plain(xyz, 20, scale, offset))
    back = native.las_decode(got, len(xyz), 20, scale, offset)
    assert np.abs(back - xyz).max() <= 0.5e-3 + 1e-9


def test_voxel_mark():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 10, (20000, 3)).astype(np.float32)
    got = native.voxel_mark(pts, 0.5)
    np.testing.assert_array_equal(got, native.voxel_mark_plain(pts, 0.5))
    np.testing.assert_array_equal(got, jnative.voxel_mark(pts, 0.5))
    mn = pts.min(0)
    keys = set(map(tuple, np.floor((pts - mn) / 0.5).astype(int)))
    assert got.sum() == len(keys)


def test_transform_points():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    th = 0.3
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                 [0, 0, 1]]
    T[:3, 3] = [1, 2, 3]
    got = native.transform_points(pts, T)
    np.testing.assert_allclose(got, native.transform_points_plain(pts, T),
                               atol=1e-5)
    np.testing.assert_array_equal(got, jnative.transform_points(pts, T))
    assert got is not pts and np.abs(pts - got).max() > 0.5


@pytest.mark.parametrize("tail", [b"", b"\n", b"\n# end\n\n"])
def test_txt_parse(tail):
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 50, (5000, 3))
    lines = ["# comment line", ""] + [
        f"{a:.6f}\t{b:.6f} {c:.6f} 42" for a, b, c in pts]
    data = "\n".join(lines).encode() + tail
    got = native.txt_parse(data)
    np.testing.assert_array_equal(got, native.txt_parse_plain(data))
    np.testing.assert_array_equal(got, jnative.txt_parse(data))
    np.testing.assert_allclose(got, pts, atol=5e-7)
