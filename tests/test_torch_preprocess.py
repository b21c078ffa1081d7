"""Preprocessing of both packages on one structured scene: voxel filter,
neighborhood PCA and curvature keypoints."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ghicp_tpu.core.config import GHICPConfig as JConfig
from ghicp_tpu.core.types import PointCloud as JCloud
from ghicp_tpu.core.types import compact_device as j_compact
from ghicp_tpu.io.synthetic import structured_scene
from ghicp_tpu.preprocess import detect_keypoints as j_detect
from ghicp_tpu.preprocess import voxel_downsample as j_voxel
from ghicp_tpu.preprocess.pca import pca_features_pair as j_pca_pair
from ghicp_tpu_torch.core.config import GHICPConfig
from ghicp_tpu_torch.core.types import PointCloud, compact_device
from ghicp_tpu_torch.preprocess.keypoints import detect_keypoints
from ghicp_tpu_torch.preprocess.pca import pca_features_pair
from ghicp_tpu_torch.preprocess.voxel import voxel_downsample

torch.set_num_threads(1)
CFG = dict(voxel_size=0.15, neighborhood_radius=0.5, non_max_radius=1.0,
           min_neighbors=8)


@pytest.fixture(scope="module")
def clouds():
    """The scene through both packages' voxel filter and compaction."""
    pts = structured_scene(np.random.default_rng(0), 8000, extent=10.0)
    jd = j_compact(j_voxel(JCloud.from_points(pts), CFG["voxel_size"]))
    td = compact_device(voxel_downsample(PointCloud.from_points(pts),
                                         CFG["voxel_size"]))
    return pts, jd, td


def test_voxel_counts_and_centroids(clouds):
    pts, jd, td = clouds
    jm, tm = np.asarray(jd.mask), td.mask.numpy()
    assert jm.sum() == tm.sum() and 0 < tm.sum() < len(pts)
    jx, tx = np.asarray(jd.xyz)[jm], td.xyz.numpy()[tm]
    np.testing.assert_allclose(tx.mean(0), jx.mean(0), rtol=1e-6)
    # the same representative points, in the same order
    assert np.array_equal(jx, tx)


@pytest.fixture(scope="module")
def pca_both(clouds):
    _, jd, td = clouds
    jf, _ = j_pca_pair(jd, jd, radius=CFG["neighborhood_radius"],
                       cell_cap=64, max_cells=0)
    tf, _ = pca_features_pair(td, td, radius=CFG["neighborhood_radius"],
                              cell_cap=64, max_cells=0)
    return jf, tf


def test_pca_eigenvalues(pca_both):
    jf, tf = pca_both
    jv, tv = np.asarray(jf.valid), tf.valid.numpy()
    assert np.array_equal(jv, tv)
    assert np.array_equal(np.asarray(jf.n_neighbors), tf.n_neighbors.numpy())
    # atol: float32 moment sums carry ~1e-8 m^2 of rounding into the
    # smallest eigenvalue of flat patches
    np.testing.assert_allclose(tf.eigvals.numpy()[tv],
                               np.asarray(jf.eigvals)[jv], rtol=1e-4,
                               atol=1e-7)
    # descending order, as the keypoint stage reads it
    ev = tf.eigvals.numpy()[tv]
    assert np.all(ev[:, 0] >= ev[:, 1]) and np.all(ev[:, 1] >= ev[:, 2])


def test_keypoint_sets(clouds, pca_both):
    _, jd, td = clouds
    jf, tf = pca_both
    jk = np.asarray(j_detect(jd, JConfig(**CFG), jf).mask)
    tk = detect_keypoints(td, GHICPConfig(**CFG), tf).mask.numpy()
    a, b = set(np.nonzero(jk)[0]), set(np.nonzero(tk)[0])
    assert len(a) > 20
    assert len(a & b) >= 0.99 * len(a | b)


def _nms_both(n: int):
    """Both packages' ``non_max_suppression`` on one random set of ``n``
    slots with the same neighbour cap (k) and cell cap."""
    from ghicp_tpu.preprocess.keypoints import non_max_suppression as j_nms
    from ghicp_tpu_torch.preprocess.keypoints import non_max_suppression
    rng = np.random.default_rng(4)
    xyz = rng.uniform(0, 12, (n, 3)).astype(np.float32)
    curv = rng.random(n).astype(np.float32)
    cand = rng.random(n) < 0.7
    js, jr = j_nms(JCloud(xyz=jnp.asarray(xyz), mask=jnp.ones(n, bool)),
                   jnp.asarray(curv), jnp.asarray(cand), radius=0.6, k=64,
                   cell_cap=32, chunk=4096)
    ts, tr = non_max_suppression(
        PointCloud(xyz=torch.from_numpy(xyz), mask=torch.ones(n, dtype=bool)),
        torch.from_numpy(curv), torch.from_numpy(cand), radius=0.6, k=64,
        cell_cap=32, chunk=4096)
    return np.asarray(js), int(jr), ts.numpy(), tr, cand


def test_nms_gather_path_above_the_brute_band():
    """Above 8192 slots, off the kernel's 256-slot tiling, both packages
    take the K-capped neighbor-list fixed point; the selections must be
    identical."""
    from ghicp_tpu_torch.preprocess.keypoints import nms_path
    n = 16400
    assert nms_path(n) == "gather"
    js, jr, ts, tr, cand = _nms_both(n)
    assert np.array_equal(js, ts)
    assert jr == tr and 0 < ts.sum() < cand.sum()


def test_nms_kernel_band_matches_the_jax_gather_path():
    """In (8192, 131072] on 256-slot tiles the port takes the exact-radius
    fixed point of K4 (its plain version here) and the JAX package on the
    CPU the K-capped gather path; where the cap does not bind, the
    selections and the rounds must be identical."""
    from ghicp_tpu_torch.preprocess.keypoints import nms_path
    n = 16384
    assert nms_path(n) == "kernel"
    js, jr, ts, tr, cand = _nms_both(n)
    assert np.array_equal(js, ts)
    assert jr == tr and 0 < ts.sum() < cand.sum()
