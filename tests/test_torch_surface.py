"""The rest of the JAX package's public surface in the port, each held to
its JAX counterpart on the same inputs: transforms, ``round_up``, voxel
keys and centroids, per-query PCA, the two Hamming paths, ``bsc_frames``,
the Jacobi ladder's ``eps_scaling``, descriptor factors, the native
runtime's probe, the engine's ``chunk`` and ``overhead_out``, and the
subpackages' exports."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ghicp_tpu.matching.auction as jau
import ghicp_tpu.registration.ghicp as jgh
from ghicp_tpu.core import transform as jtf
from ghicp_tpu.core.config import CorrespondenceType, FeatureType
from ghicp_tpu.core.config import GHICPConfig as JConfig
from ghicp_tpu.core.types import PointCloud as JCloud
from ghicp_tpu.core.types import compact_device as j_compact
from ghicp_tpu.core.types import round_up as j_round_up
from ghicp_tpu.features import bsc as jbsc
from ghicp_tpu.features import hamming as jham
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu.ops.stream_kernel import make_stream_features as j_stream
from ghicp_tpu.preprocess import pca as jpca
from ghicp_tpu.preprocess import voxel as jvox
from ghicp_tpu_torch import native
from ghicp_tpu_torch.core import transform as tf
from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.core.types import PointCloud, round_up
from ghicp_tpu_torch.features import bsc, hamming
from ghicp_tpu_torch.interop import config_from_dict
from ghicp_tpu_torch.io.synthetic import registration_problem
from ghicp_tpu_torch.matching import auction as tau
from ghicp_tpu_torch.ops.stream_kernel import (make_desc_features,
                                               make_stream_features)
from ghicp_tpu_torch.preprocess import pca, voxel
from ghicp_tpu_torch.registration.ghicp import ghicp_register_chunked

torch.set_num_threads(1)
CFG = dict(voxel_size=0.15, neighborhood_radius=0.5, non_max_radius=1.0,
           min_neighbors=8)
# names of the JAX package's subpackages with no counterpart in the port:
# a rank is a process there, so there is no device mesh or axis name
NOT_PORTED = {"shard": {"AXIS", "make_mesh"}}


@pytest.fixture(scope="module")
def scene():
    """A structured scene and its downsampled cloud (the JAX package's
    first-point voxel filter, compacted), in both packages."""
    pts = structured_scene(np.random.default_rng(0), 8000, extent=10.0)
    jd = j_compact(jvox.voxel_downsample(JCloud.from_points(pts),
                                         CFG["voxel_size"]))
    td = PointCloud(xyz=torch.tensor(np.asarray(jd.xyz)),
                    mask=torch.tensor(np.asarray(jd.mask)))
    return pts, jd, td


def _poses(n=16, seed=5):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        a = rng.normal(size=3)
        th = rng.uniform(-np.pi, np.pi)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        K /= np.linalg.norm(a)
        out[i, :3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        out[i, :3, 3] = rng.uniform(-30, 30, 3)
        out[i, 3, 3] = 1.0
    return out


def test_invert_equals_jax():
    Ts = _poses()
    got = tf.invert(torch.from_numpy(Ts)).numpy()
    for T, g in zip(Ts, got):
        np.testing.assert_allclose(g, np.asarray(jtf.invert(jnp.asarray(T))),
                                   atol=1e-6)


@pytest.mark.parametrize("yaw_only", [False, True])
def test_random_rigid_distribution(yaw_only):
    """No JAX key maps onto a torch generator, so the draws are held to the
    JAX package's distribution: rotations orthonormal with det +1 by at
    most the maximum angle (about +z with ``yaw_only``), shifts within
    the maximum; one seed, one pose."""
    max_deg, max_t = 25.0, 0.7
    g = torch.Generator().manual_seed(11)
    Ts = [tf.random_rigid(g, max_deg, max_t, yaw_only, device="cpu")
          for _ in range(32)]
    for T in Ts:
        assert T.dtype == torch.float32 and T.shape == (4, 4)
        R, t = T[:3, :3].double(), T[:3, 3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert abs(float(torch.det(R)) - 1.0) < 1e-5
        angle = np.degrees(np.arccos(np.clip(
            (float(torch.trace(R)) - 1.0) / 2.0, -1.0, 1.0)))
        assert angle <= max_deg + 1e-3
        assert float(t.abs().max()) <= max_t
        assert torch.equal(T[3], torch.tensor([0.0, 0.0, 0.0, 1.0]))
        if yaw_only:
            assert torch.equal(T[2, :3], torch.tensor([0.0, 0.0, 1.0]))
    assert len({tuple(T.flatten().tolist()) for T in Ts}) == len(Ts)
    again = tf.random_rigid(torch.Generator().manual_seed(11), max_deg, max_t,
                            yaw_only, device="cpu")
    assert torch.equal(again, Ts[0])


def test_round_up_and_voxel_keys_equal_jax(scene):
    for n, m in ((0, 8), (1, 8), (8, 8), (9, 8), (1000, 128), (4097, 4096)):
        assert round_up(n, m) == j_round_up(n, m)
    pts, _, _ = scene
    lo = pts.min(axis=0)
    for size in (0.15, 0.4):
        want = np.asarray(jvox.voxel_keys(jnp.asarray(pts), jnp.asarray(lo),
                                          size))
        got = voxel.voxel_keys(torch.from_numpy(pts), torch.from_numpy(lo),
                               size)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["centroid", "first"])
def test_voxel_downsample_modes_equal_jax(scene, mode):
    pts, _, _ = scene
    jc = JCloud.from_points(pts)
    want = jvox.voxel_downsample(jc, CFG["voxel_size"], mode=mode)
    got = voxel.voxel_downsample(PointCloud.from_points(pts),
                                 CFG["voxel_size"], mode=mode)
    m = np.asarray(want.mask)
    assert np.array_equal(got.mask.numpy(), m)
    np.testing.assert_allclose(got.xyz.numpy()[m], np.asarray(want.xyz)[m],
                               rtol=1e-6)
    if mode == "first":
        assert np.array_equal(got.xyz.numpy(), np.asarray(want.xyz))


def test_pca_per_query_path_equals_jax(scene):
    """``cell_pair=False`` against the JAX package's per-query path, at
    test_torch_preprocess.py's eigenvalue tolerance, with a cell cap that
    thins the fuller cells."""
    _, jd, td = scene
    kw = dict(radius=CFG["neighborhood_radius"], cell_cap=32, chunk=1000)
    jf = jpca.pca_features(jd, cell_pair=False, **kw)
    tf_ = pca.pca_features(td, cell_pair=False, **kw)
    jv, tv = np.asarray(jf.valid), tf_.valid.numpy()
    assert np.array_equal(jv, tv) and tv.sum() > 1000
    assert np.array_equal(np.asarray(jf.n_neighbors), tf_.n_neighbors.numpy())
    np.testing.assert_allclose(tf_.eigvals.numpy()[tv],
                               np.asarray(jf.eigvals)[jv], rtol=1e-4,
                               atol=1e-7)


def test_pca_default_path_ignores_the_new_arguments(scene):
    _, _, td = scene
    r = CFG["neighborhood_radius"]
    a = pca.pca_features(td, r, cell_cap=32)
    b = pca.pca_features(td, r, k=7, cell_cap=32, chunk=100)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def packed():
    """Random packed bits (the last word partly filled), JAX's uint32
    words and the port's int64 ones."""
    rng = np.random.default_rng(9)
    bits_s = (rng.random((3, 200, 441)) < 0.3).astype(np.float32)
    bits_t = (rng.random((1, 150, 441)) < 0.4).astype(np.float32)
    js, jt = jbsc.pack_bits(jnp.asarray(bits_s)), jbsc.pack_bits(
        jnp.asarray(bits_t))
    ts = torch.from_numpy(np.asarray(js).astype(np.int64))
    tt = torch.from_numpy(np.asarray(jt).astype(np.int64))
    return js, jt, ts, tt


def test_hamming_paths_equal_jax_and_each_other(packed):
    js, jt, ts, tt = packed
    pop = hamming.hamming_matrix_popcount(ts[0], tt[0], block=64)
    assert pop.dtype == torch.int32
    assert np.array_equal(pop.numpy(), np.asarray(
        jham.hamming_matrix_popcount(js[0], jt[0], block=64)))
    mxu = hamming.hamming_matrix_mxu(ts[0], tt[0], 441)
    assert mxu.dtype == torch.float32
    assert np.array_equal(mxu.numpy(), np.asarray(
        jham.hamming_matrix_mxu(js[0], jt[0], 441)))
    assert torch.equal(mxu, pop.to(torch.float32))
    fds = []
    for use_mxu in (True, False):
        got = hamming.min_hamming_fd(ts, tt, 441, use_mxu=use_mxu)
        want = np.asarray(jham.min_hamming_fd(js, jt, 441, use_mxu=use_mxu))
        assert np.array_equal(got.numpy(), want)
        fds.append(got)
    assert torch.equal(*fds)


def test_bsc_frames_equal_jax_and_extract_bsc(scene):
    _, jd, td = scene
    cfg = JConfig(**CFG)
    # every 17th live point of the cloud as a keypoint
    idx = np.nonzero(np.asarray(jd.mask))[0][::17][:192]
    kp = np.zeros((256, 3), np.float32)
    kp[:len(idx)] = np.asarray(jd.xyz)[idx]
    kmask = np.zeros(256, bool)
    kmask[:len(idx)] = True
    radius = float(cfg.bsc_radius or cfg.non_max_radius)
    got = bsc.bsc_frames(td, torch.from_numpy(kp), torch.from_numpy(kmask),
                         radius, neighbor_k=cfg.bsc_neighbor_k)
    ref = bsc.extract_bsc(td, torch.from_numpy(kp), torch.from_numpy(kmask),
                          GHICPConfig(**CFG), num_variants=1).frames
    assert torch.equal(got, ref)
    want = np.asarray(jbsc.bsc_frames(jd, jnp.asarray(kp),
                                      jnp.asarray(kmask), radius,
                                      neighbor_k=cfg.bsc_neighbor_k))
    # test_torch_features.py holds the frames' axes to 1e-4
    np.testing.assert_allclose(got.numpy()[kmask], want[kmask], atol=1e-4)


def _eps_cs(b, sink, acol, p, eps):
    """Each row's surplus at its choice (a column or the sink) within
    ``eps`` of its best."""
    C = b.shape[1]
    surplus = b - p[None, :]
    best = np.maximum(surplus.max(axis=1), sink)
    real = (acol >= 0) & (acol < C)
    mine = np.where(real, surplus[np.arange(len(acol)), np.where(real, acol,
                                                                  0)], sink)
    assert np.all(acol >= 0), "a row left open"
    return bool(np.all(mine >= best - eps * (1 + 1e-5)))


@pytest.mark.parametrize("eps_scaling", [5.0, 8.0])
def test_auction_eps_scaling_equals_jax(eps_scaling):
    """The Jacobi ladder with each scaling: energies within
    test_torch_matching.py's n * eps of the JAX package's, each package's
    assignment eps-CS at its terminal epsilon."""
    rng = np.random.default_rng(21)
    S, C = 96, 128
    b = -rng.uniform(0.0, 30.0, (S, C)).astype(np.float32)
    b[np.arange(S), np.arange(S)] = -rng.uniform(0.0, 2.0, S)
    sink, eps = -12.0, 0.05
    J = jau.auction_assign(jnp.asarray(b), sink, eps, 4000,
                           eps_scaling=eps_scaling)
    M = tau.auction_assign(torch.from_numpy(b), sink, eps, 4000,
                           eps_scaling=eps_scaling)
    energies = []
    for acol, p, e in ((np.asarray(J[0]), np.asarray(J[1]), float(J[3])),
                       (M[0].numpy(), M[1].numpy(), float(M[3]))):
        assert _eps_cs(b, sink, acol, p, e)
        real = acol < C
        energies.append((b[np.arange(S)[real], acol[real]].sum()
                         + sink * (~real).sum(), e))
    (ej, eps_j), (em, eps_m) = energies
    assert abs(ej - em) <= max(S, C) * max(eps_j, eps_m)


def test_auction_default_scaling_is_five():
    rng = np.random.default_rng(2)
    b = torch.from_numpy(-rng.uniform(0.0, 10.0, (64, 64)).astype(np.float32))
    a = tau.auction_assign(b, -6.0, 0.02, 2000)
    c = tau.auction_assign(b, -6.0, 0.02, 2000, eps_scaling=5.0)
    for x, y in zip(a, c):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


@pytest.mark.parametrize("standardize", ["rows", "dims"])
def test_stream_features_from_descriptors(standardize):
    rng = np.random.default_rng(4)
    ds = torch.from_numpy(rng.random((40, 33)).astype(np.float32))
    dt = torch.from_numpy(rng.random((50, 33)).astype(np.float32))
    got = make_stream_features(desc_s=ds, desc_t=dt,
                               standardize=standardize)
    want = make_desc_features(ds, dt, standardize)
    assert got.dim == want.dim
    assert torch.equal(got.fs, want.fs) and torch.equal(got.ft, want.ft)
    with pytest.raises(ValueError, match="descriptor"):
        make_stream_features(desc_s=ds)


def test_stream_features_read_n_bits(packed):
    """Bits past ``n_bits`` (here bits 400-440) are not the descriptor's:
    the popcounts are JAX's over the first ``n_bits``."""
    js, jt, ts, tt = packed
    want = j_stream(packed_s=js, packed_t=jt, n_bits=400)
    got = make_stream_features(ts, tt, n_bits=400)
    np.testing.assert_array_equal(got.na.numpy(), np.asarray(want.na))
    np.testing.assert_array_equal(got.nb.numpy(), np.asarray(want.nb))
    bits = got.bits_s.numpy()
    assert not bits[..., 400:].any()
    np.testing.assert_array_equal(bits[..., :400],
                                  np.asarray(want.fs)[..., :400])


def test_native_runtime_is_available():
    lib = native.get_lib()
    assert lib is not None and lib is native.library()
    assert native.available()


def test_engine_chunk_and_overhead_equal_jax():
    """``chunk=2``: the callback's iterations are the JAX package's, and
    ``overhead_out`` gets a positive float."""
    src, tgt, fd, _, _, _ = registration_problem(256, 256, seed=13,
                                                 rot_deg=15.0)
    ms, mt = np.ones(256, bool), np.ones(256, bool)
    cfg = JConfig(feature=FeatureType.NONE,
                  correspondence=CorrespondenceType.NN, max_iterations=9,
                  converge_translation=0.0, converge_rotation=0.0,
                  engine_chunk=64)
    fd = np.zeros_like(fd)
    jcalls, tcalls, over = [], [], {}
    jgh.ghicp_register_chunked(
        jnp.asarray(src), jnp.asarray(ms), jnp.asarray(tgt), jnp.asarray(mt),
        jnp.asarray(fd), jnp.float32(40.0), cfg, chunk=2,
        iteration_callback=lambda it, *_: jcalls.append(it))
    out = ghicp_register_chunked(
        src, ms, tgt, mt, fd, 40.0, config_from_dict(dataclasses.asdict(cfg)),
        2, iteration_callback=lambda it, *_: tcalls.append(it),
        overhead_out=over, device="cpu")
    assert out.iterations == 9
    assert tcalls == jcalls == [2, 4, 6, 8, 9]
    assert isinstance(over["dispatch_overhead"], float)
    assert over["dispatch_overhead"] > 0.0


@pytest.mark.parametrize("sub", ["features", "matching", "preprocess",
                                 "registration", "io", "shard"])
def test_subpackages_export_the_jax_names(sub):
    want = set(importlib.import_module(f"ghicp_tpu.{sub}").__all__)
    port = importlib.import_module(f"ghicp_tpu_torch.{sub}")
    missing = NOT_PORTED.get(sub, set())
    assert missing <= want
    for name in sorted(want - missing):
        assert name in port.__all__, name
        assert getattr(port, name) is not None, name
    ns = {}
    exec(f"from ghicp_tpu_torch.{sub} import *", ns)
    assert set(port.__all__) <= set(ns)
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")
