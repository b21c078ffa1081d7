"""The port's own copies of the JAX package's host code (configuration,
synthetic data) and its core tensor helpers (transforms, padded clouds)
against the JAX package on the same inputs."""
import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import bench
import ghicp_tpu.core.config as jcfg
import ghicp_tpu.core.transform as jtf
import ghicp_tpu.core.types as jty
import ghicp_tpu.io.synthetic as jsyn
import ghicp_tpu_torch.core.config as tcfg
import ghicp_tpu_torch.core.transform as ttf
import ghicp_tpu_torch.core.types as tty
import ghicp_tpu_torch.io.synthetic as tsyn

torch.set_num_threads(1)


def _plain(v):
    return v.value if isinstance(v, enum.Enum) else v


def test_config_copy_has_the_same_fields_and_defaults():
    want = {f.name: _plain(getattr(jcfg.GHICPConfig(), f.name))
            for f in dataclasses.fields(jcfg.GHICPConfig)}
    got = {f.name: _plain(getattr(tcfg.GHICPConfig(), f.name))
           for f in dataclasses.fields(tcfg.GHICPConfig)}
    assert got == want
    assert ([e.value for e in tcfg.FeatureType]
            == [e.value for e in jcfg.FeatureType])
    assert ([e.value for e in tcfg.CorrespondenceType]
            == [e.value for e in jcfg.CorrespondenceType])


@pytest.mark.parametrize("which", ["structured_scene", "make_pair",
                                   "bench_pair", "registration_problem"])
def test_synthetic_copies_are_bit_equal(which):
    if which == "structured_scene":
        got = tsyn.structured_scene(np.random.default_rng(3), 5000, 12.0)
        want = jsyn.structured_scene(np.random.default_rng(3), 5000, 12.0)
    elif which == "make_pair":
        kw = dict(seed=4, n_points=3000, rotation_deg=25.0, overlap=0.7)
        got, want = tsyn.make_pair(**kw), jsyn.make_pair(**kw)
    elif which == "bench_pair":
        got = tsyn.bench_pair(n_points=5000, seed=7)
        want = bench.make_bench_pair(n_points=5000, seed=7)
    else:
        got = tsyn.registration_problem(128, 256, seed=3)
        want = ge._registration_problem(128, 256, seed=3)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_transforms_match():
    rng = np.random.default_rng(5)
    A = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    A *= np.sign(np.linalg.det(A))
    t = rng.normal(size=3).astype(np.float32)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    Tj = jtf.from_rt(jnp.asarray(A), jnp.asarray(t))
    Tt = ttf.from_rt(torch.from_numpy(A), torch.from_numpy(t))
    np.testing.assert_array_equal(Tt.numpy(), np.asarray(Tj))
    np.testing.assert_allclose(ttf.apply(Tt, torch.from_numpy(pts)).numpy(),
                               np.asarray(jtf.apply(Tj, jnp.asarray(pts))),
                               atol=1e-6)
    np.testing.assert_allclose(ttf.compose(Tt, Tt).numpy(),
                               np.asarray(jtf.compose(Tj, Tj)), atol=1e-6)
    np.testing.assert_allclose(
        ttf.euler_deg_zyx(ttf.rotation(Tt)).numpy(),
        np.asarray(jtf.euler_deg_zyx(jtf.rotation(Tj))), atol=1e-4)
    th = np.float32(0.7)
    np.testing.assert_allclose(ttf.rotz(torch.tensor(th)).numpy(),
                               np.asarray(jtf.rotz(jnp.asarray(th))),
                               atol=1e-7)


def test_padded_cloud_helpers_match():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-3, 9, (700, 3)).astype(np.float32)
    keep = rng.random(1024) < 0.4
    for n in (0, 1, 255, 256, 257, 5000):
        assert tty.bucket_size(n) == jty.bucket_size(n)
    cj = jty.PointCloud.from_points(pts, capacity=1024)
    ct = tty.PointCloud.from_points(pts, capacity=1024)
    np.testing.assert_array_equal(ct.xyz.numpy(), np.asarray(cj.xyz))
    cj = jty.PointCloud(xyz=cj.xyz, mask=cj.mask & jnp.asarray(keep))
    ct = tty.PointCloud(xyz=ct.xyz, mask=ct.mask & torch.from_numpy(keep))
    dj, dt = jty.compact_device(cj), tty.compact_device(ct)
    np.testing.assert_array_equal(dt.mask.numpy(), np.asarray(dj.mask))
    np.testing.assert_allclose(dt.xyz.numpy(), np.asarray(dj.xyz),
                               rtol=1e-6)
    bj, bt = jty.cloud_bounds(dj), tty.cloud_bounds(dt)
    np.testing.assert_array_equal(bt.min_xyz.numpy(), np.asarray(bj.min_xyz))
    np.testing.assert_array_equal(bt.max_xyz.numpy(), np.asarray(bj.max_xyz))
    np.testing.assert_allclose(
        float(tty.masked_mean(dt.xyz, dt.mask[:, None], dim=0).sum()),
        float(jty.masked_mean(dj.xyz, dj.mask[:, None], axis=0).sum()),
        rtol=1e-6)
